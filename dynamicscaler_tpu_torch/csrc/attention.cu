// Attention cores of the UNet transformer sub-blocks, head dim 64, bf16 in
// and out, fp32 softmax.
//
// ds_temporal_attention replaces the attention half of
//   dynamicscaler_tpu/ops/fused_temporal.py::_kernel (K1).
// 16 frame tokens per (row, head). The TPU kernel packed 8 rows into one
// 128x128 block-diagonal MXU product; on Hopper a 16x16x64 attention is too
// small for the tensor cores to matter (it is ~1% of the sub-block's FLOPs),
// so one warp owns one (row, head) pair, keeps q, k, v in shared memory in
// fp32 and computes logits, softmax and PV with CUDA cores. The op is bound by
// reading q, k, v once and writing o once. Probabilities are normalised and
// rounded to bf16 BEFORE the PV product, as the TPU kernel does.
//
// ds_flash_attention replaces the attention halves of
//   dynamicscaler_tpu/ops/fused_spatial.py::_kernel       (K2, N up to 2560)
//   dynamicscaler_tpu/ops/fused_spatial.py::_cross_kernel (K3, 77 text + 16 image keys)
// The TPU kernel held the [N, N] fp32 logits in VMEM; at 64 query rows x
// 2560 keys that is 640 KB, beyond a Hopper block's 227 KB of shared memory.
// So this is a flash-style pass: a block owns 64 query rows of one
// (batch, head), walks the keys in tiles of 64 with an online softmax, and
// never writes logits to device memory. QK^T and PV run on the tensor cores
// (WMMA bf16 fragments, fp32 accumulation); each warp owns 16 query rows, so
// the softmax needs only warp-level synchronisation. The exponentials are
// rounded to bf16 for the PV product and the sum is divided out AFTER PV
// (fused_spatial.py:120-126). Keys come in up to two segments with separate
// softmaxes whose normalised outputs are summed (the i2v dual text/image
// cross-attention, fused_spatial.py:269-276); ragged segment ends are masked
// by length, so nothing is padded in device memory. Compute-bound at N=2560
// (QK^T and PV are 4*N*N*64 FLOP per head); no cp.async/TMA pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;   // head dim
constexpr int TF = 16;  // temporal tokens (frames)

// ---------------------------------------------------------------------------
// temporal: one warp per (row, head)
// ---------------------------------------------------------------------------

constexpr int T_WARPS = 2;

__global__ void __launch_bounds__(T_WARPS * 32)
temporal_attn_kernel(const bf16* __restrict__ qkv, int R, int C, int heads, float scale,
                     bf16* __restrict__ out) {
  __shared__ float qs[T_WARPS][TF][D];
  __shared__ float ks[T_WARPS][TF][D + 1];
  __shared__ float vs[T_WARPS][TF][D];
  __shared__ float ps[T_WARPS][TF][TF];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * T_WARPS + warp;
  if (pair >= R * heads) return;
  const int r = pair / heads;
  const int h = pair - r * heads;
  const size_t ld = (size_t)3 * C;
  const bf16* base = qkv + (size_t)r * TF * ld + h * D;

  // 16 rows x 32 bf16 pairs per matrix, 16 pairs per lane
  for (int i = lane; i < TF * (D / 2); i += 32) {
    const int f = i / (D / 2);
    const int c = (i % (D / 2)) * 2;
    const bf16* row = base + f * ld + c;
    const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row));
    const float2 k = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + C));
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + 2 * C));
    qs[warp][f][c] = q.x; qs[warp][f][c + 1] = q.y;
    ks[warp][f][c] = k.x; ks[warp][f][c + 1] = k.y;
    vs[warp][f][c] = v.x; vs[warp][f][c + 1] = v.y;
  }
  __syncwarp();

  // logits: 256 entries, 8 per lane; entry e = lane + 32 i -> (e / 16, e % 16)
#pragma unroll
  for (int i = 0; i < (TF * TF) / 32; ++i) {
    const int e = lane + 32 * i;
    const int fi = e / TF;
    const int gi = e % TF;
    float acc = 0.f;
#pragma unroll 16
    for (int c = 0; c < D; ++c) acc += qs[warp][fi][c] * ks[warp][gi][c];
    ps[warp][fi][gi] = acc * scale;
  }
  __syncwarp();

  if (lane < TF) {
    float m = -INFINITY;
#pragma unroll
    for (int g = 0; g < TF; ++g) m = fmaxf(m, ps[warp][lane][g]);
    float e[TF];
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < TF; ++g) {
      e[g] = expf(ps[warp][lane][g] - m);
      s += e[g];
    }
#pragma unroll
    for (int g = 0; g < TF; ++g)
      ps[warp][lane][g] = __bfloat162float(__float2bfloat16(e[g] / s));
  }
  __syncwarp();

  // out: 16 x 64 entries, 32 per lane; entry e = lane + 32 i -> (e / 64, e % 64)
  bf16* obase = out + (size_t)r * TF * C + h * D;
#pragma unroll 4
  for (int i = 0; i < (TF * D) / 32; ++i) {
    const int e = lane + 32 * i;
    const int fi = e / D;
    const int c = e % D;
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < TF; ++g) acc += ps[warp][fi][g] * vs[warp][g][c];
    obase[(size_t)fi * C + c] = __float2bfloat16(acc);
  }
}

// ---------------------------------------------------------------------------
// flash: 64 query rows x one (batch, head) per block, 4 warps x 16 rows
// ---------------------------------------------------------------------------

constexpr int FQ = 64;        // query rows per block
constexpr int FK = 64;        // keys per tile
constexpr int F_THREADS = 128;
constexpr int LDB = D + 8;    // bf16 pitch (144 bytes)
constexpr int LDF = FK + 4;   // fp32 pitch (272 bytes)

constexpr int SZ_Q = FQ * LDB * 2;
constexpr int SZ_K = FK * LDB * 2;
constexpr int SZ_S = FQ * LDF * 4;
constexpr int SZ_P = FQ * LDB * 2;
constexpr int OFF_K = SZ_Q;
constexpr int OFF_V = OFF_K + SZ_K;
constexpr int OFF_S = OFF_V + SZ_K;
constexpr int OFF_P = OFF_S + SZ_S;
constexpr int OFF_STAT = OFF_P + SZ_P;
constexpr int FLASH_SMEM = OFF_STAT + 3 * FQ * 4;

struct Seg {
  const bf16* k;  // row b * len + j, column h * 64
  const bf16* v;
  int ld;         // row pitch in elements
  int len;        // keys per batch item
};

__global__ void __launch_bounds__(F_THREADS)
flash_attn_kernel(const bf16* __restrict__ q, int ldq, int Nq, Seg s0, Seg s1, int nseg,
                  float scale, bf16* __restrict__ out, int ldo) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + OFF_V);
  float* Ss = reinterpret_cast<float*>(smem + OFF_S);
  bf16* Ps = reinterpret_cast<bf16*>(smem + OFF_P);
  float* m_s = reinterpret_cast<float*>(smem + OFF_STAT);
  float* l_s = m_s + FQ;
  float* a_s = l_s + FQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * FQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wr = warp * 16;  // this warp's first query row in the tile

  // Q tile: 64 rows x 8 chunks of 16 bytes
  for (int idx = tid; idx < FQ * (D / 8); idx += F_THREADS) {
    const int row = idx >> 3;
    const int col = (idx & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + row < Nq)
      val = *reinterpret_cast<const uint4*>(q + ((size_t)b * Nq + q0 + row) * ldq + h * D + col);
    *reinterpret_cast<uint4*>(Qs + row * LDB + col) = val;
  }

  // lane owns entries (row wr + (i >> 1), col lane + 32 * (i & 1)), i < 32
  float o[32];
  float fin[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) fin[i] = 0.f;

  for (int sg = 0; sg < nseg; ++sg) {
    const Seg seg = sg == 0 ? s0 : s1;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    if (lane < 16) {
      m_s[wr + lane] = -INFINITY;
      l_s[wr + lane] = 0.f;
    }

    for (int k0 = 0; k0 < seg.len; k0 += FK) {
      __syncthreads();
      for (int idx = tid; idx < FK * (D / 8); idx += F_THREADS) {
        const int row = idx >> 3;
        const int col = (idx & 7) * 8;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (k0 + row < seg.len) {
          const size_t off = ((size_t)b * seg.len + k0 + row) * seg.ld + h * D + col;
          kv = *reinterpret_cast<const uint4*>(seg.k + off);
          vv = *reinterpret_cast<const uint4*>(seg.v + off);
        }
        *reinterpret_cast<uint4*>(Ks + row * LDB + col) = kv;
        *reinterpret_cast<uint4*>(Vs + row * LDB + col) = vv;
      }
      __syncthreads();

      // S[wr:wr+16, 0:64] = Q K^T
      {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, Qs + wr * LDB + kk, LDB);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, Ks + (j * 16) * LDB + kk, LDB);
            wmma::mma_sync(sacc[j], fa, fb, sacc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::store_matrix_sync(Ss + wr * LDF + j * 16, sacc[j], LDF, wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax, one lane per query row
      const int valid = min(FK, seg.len - k0);
      if (lane < 16) {
        const int row = wr + lane;
        float* srow = Ss + row * LDF;
        float mx = m_s[row];
        for (int j = 0; j < valid; ++j) mx = fmaxf(mx, srow[j] * scale);
        const float alpha = expf(m_s[row] - mx);  // 0 on the first tile
        float sum = 0.f;
        bf16* prow = Ps + row * LDB;
        for (int j = 0; j < FK; ++j) {
          float p = 0.f;
          if (j < valid) {
            p = expf(srow[j] * scale - mx);
            sum += p;
          }
          prow[j] = __float2bfloat16(p);
        }
        m_s[row] = mx;
        l_s[row] = l_s[row] * alpha + sum;
        a_s[row] = alpha;
      }
      __syncwarp();

      // T = P V into the S buffer, then o = o * alpha + T
      {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(oacc[j], 0.f);
#pragma unroll
        for (int kk = 0; kk < FK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, Ps + wr * LDB + kk, LDB);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, Vs + kk * LDB + j * 16, LDB);
            wmma::mma_sync(oacc[j], fa, fb, oacc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::store_matrix_sync(Ss + wr * LDF + j * 16, oacc[j], LDF, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = wr + (i >> 1);
        const int col = lane + 32 * (i & 1);
        o[i] = o[i] * a_s[row] + Ss[row * LDF + col];
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) fin[i] += o[i] / l_s[wr + (i >> 1)];
    __syncwarp();  // l_s is reset for the next segment
  }

#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = q0 + wr + (i >> 1);
    const int col = lane + 32 * (i & 1);
    if (row < Nq) out[((size_t)b * Nq + row) * ldo + h * D + col] = __float2bfloat16(fin[i]);
  }
}

}  // namespace

// qkv: [R * 16, 3C] bf16 (q | k | v columns), out: [R * 16, C] bf16, C = heads * 64.
extern "C" int ds_temporal_attention(const void* qkv, int R, int C, int heads, float scale,
                                     void* out, void* stream) {
  const int pairs = R * heads;
  const int blocks = (pairs + T_WARPS - 1) / T_WARPS;
  temporal_attn_kernel<<<blocks, T_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), R, C, heads, scale, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

// q: rows b * Nq + i with pitch ldq; segment s keys/values: rows b * len_s + j
// with pitch ld_s; head h at column h * 64 of every operand. nseg is 1 or 2.
extern "C" int ds_flash_attention(const void* q, int ldq, int B, int Nq, int heads,
                                  const void* k0, const void* v0, int ld0, int len0,
                                  const void* k1, const void* v1, int ld1, int len1,
                                  int nseg, float scale, void* out, int ldo, void* stream) {
  // Set on every launch: the attribute is per device, and the call is cheap.
  cudaError_t e = cudaFuncSetAttribute(flash_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, FLASH_SMEM);
  if (e != cudaSuccess) return (int)e;
  Seg s0{static_cast<const bf16*>(k0), static_cast<const bf16*>(v0), ld0, len0};
  Seg s1{static_cast<const bf16*>(k1), static_cast<const bf16*>(v1), ld1, len1};
  dim3 grid((Nq + FQ - 1) / FQ, heads, B);
  flash_attn_kernel<<<grid, F_THREADS, FLASH_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), ldq, Nq, s0, s1, nseg, scale,
      static_cast<bf16*>(out), ldo);
  return (int)cudaGetLastError();
}
