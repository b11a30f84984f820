// bf16 tiled GEMM with an optional LayerNorm or GroupNorm prologue, an
// optional row map and three epilogues, for every projection of the UNet
// transformers.
//
// Replaces the projection halves of the TPU kernels
//   dynamicscaler_tpu/ops/fused_temporal.py::_kernel     (K1: LN -> QKV, out-proj + residual)
//   dynamicscaler_tpu/ops/fused_temporal.py::_ff_kernel  (K4: LN -> GEGLU, FF2 + residual)
//   dynamicscaler_tpu/ops/fused_spatial.py::_kernel      (K2: LN -> QKV, out-proj + residual)
//   dynamicscaler_tpu/ops/fused_spatial.py::_cross_kernel(K3: LN -> Q, context KV, out-proj)
// and the whole of the transformer-wrapper kernels
//   dynamicscaler_tpu/ops/fused_twrap.py::_head_kernel   (5 _head_temporal, 7 _head_spatial:
//                                                          GN apply [-> frame permute] -> proj_in)
//   dynamicscaler_tpu/ops/fused_twrap.py::_tail_kernel   (6 _tail_temporal, 8 _tail_spatial:
//                                                          proj_out [-> permute back] + residual)
//
// Y[M, N_out] = epilogue( A[M, K] @ W[N, K]^T ),  W in torch Linear layout.
//   prologue (applied while the A tile is staged in shared memory, so the
//   normalised activation never goes to device memory):
//     PRO_LN: A = LN(X) (flax fast-variance statistics in fp32:
//             var = max(0, E[x^2] - mu^2); h = (x - mu) * (rsqrt(var + eps) * s) + b,
//             rounded to bf16 before the product, as the TPU kernels do).
//     PRO_GN: A = bf16(x * mul[s] + add[s]) with the folded GroupNorm vectors
//             mul/add [S, K] fp32 of sample s = r / rows_per_sample, applied
//             PER ROW (a 64-row tile straddles samples at N = 40); the product
//             and the sum are rounded separately (__fmul_rn, __fadd_rn), as the
//             plain version computes them.
//   row map (the frame permute of the temporal wrappers, done in the address
//   arithmetic: logical row r = (b*HW + hw)*F + f <-> stored row
//   (b*F + f)*HW + hw of a [B, F, H, W, C] tensor; each row stays K or N
//   contiguous bf16, so the 16-byte loads and stores stay coalesced):
//     MAP_A:   A row r is read from X's stored row map(r)   (temporal head)
//     MAP_OUT: output row r is written to, and its residual read from,
//              stored row map(r)                           (temporal tail)
//   mode 0: y = bf16(acc [+ bias])
//   mode 1: y = bf16(bf16(acc + bias) + R)                (out-proj / FF2 / wrapper tail + residual)
//   mode 2: GEGLU. Each block loads 32 value rows j.. and the 32 gate rows
//           N/2 + j.. of W into one 64-row tile, so value and gate of one
//           output column sit in the same accumulator tile:
//           a = bf16(acc + bias); y = bf16(f32(a_val) * gelu_erf(f32(a_gate))),
//           N_out = N / 2.
//
// What bounds it on the H100: these products are compute-bound at the UNet
// shapes (M up to 8*16*2560 = 327680 tokens, K and N 320..5120), so the work
// is the tensor cores'. This first version uses WMMA bf16 fragments with
// fp32 accumulation (mma.sync underneath), 64x64x32 block tiles, 4 warps of
// 32x32. The LayerNorm row statistics are computed by each block from its 64
// rows (L2 hits for all but the first block of a row); the GroupNorm vectors
// are per sample and read as float4 from L1/L2. The wrapper products have
// K, N = 320..1280 and are the smallest of the UNet's GEMMs; fusing the
// GroupNorm apply and the permutes into them saves the fp32 normalised copy,
// the permuted copy and the separate residual pass of the plain path. No
// cp.async pipelining, no wgmma and no TMA yet: those are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int LDS = BK + 8;   // bf16 row pitch of the staged tiles (80 bytes)
constexpr int LDC = BN + 4;   // fp32 row pitch of the epilogue tile

enum { PRO_NONE = 0, PRO_LN = 1, PRO_GN = 2 };
enum { MAP_NONE = 0, MAP_A = 1, MAP_OUT = 2 };

__device__ __forceinline__ float gelu_erf(float g) {
  return g * 0.5f * (1.0f + erff(g * 0.70710678118654752f));
}

// Stored row of logical row r = (b*HW + hw)*F + f in a [B, F, H, W, .] tensor.
__device__ __forceinline__ size_t frame_major_row(int r, int F, int HW) {
  const int f = r % F;
  const int bhw = r / F;
  const int b = bhw / HW;
  return ((size_t)b * F + f) * HW + (bhw - b * HW);
}

template <int MODE, int PRO, int MAP>
__global__ void __launch_bounds__(THREADS)
ln_gemm_kernel(const bf16* __restrict__ X, int M, int K,
               const float* __restrict__ ln_w, const float* __restrict__ ln_b, float eps,
               const float* __restrict__ gn_mul, const float* __restrict__ gn_add,
               int rows_per_sample, int map_F, int map_HW,
               const bf16* __restrict__ W, int N,
               const float* __restrict__ bias,
               const bf16* __restrict__ R,
               bf16* __restrict__ Y) {
  __shared__ __align__(128) bf16 As[BM * LDS];
  __shared__ __align__(128) bf16 Bs[BN * LDS];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ float s_mu[BM];
  __shared__ float s_rstd[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * BM;
  // output columns covered by this block
  const int n_out_tile = (MODE == 2) ? BN / 2 : BN;
  const int n0 = blockIdx.x * n_out_tile;
  const int n_out = (MODE == 2) ? N / 2 : N;

  if (PRO == PRO_LN) {
    // 4 warps x 16 rows: fp32 sum and sum of squares per row
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int m = m0 + r;
      float s = 0.f, ss = 0.f;
      if (m < M) {
        const bf16* xr = X + (size_t)m * K;
        for (int k = lane * 2; k < K; k += 64) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + k));
          s += v.x + v.y;
          ss += v.x * v.x + v.y * v.y;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      if (lane == 0) {
        const float mu = s / (float)K;
        const float var = fmaxf(0.f, ss / (float)K - mu * mu);
        s_mu[r] = mu;
        s_rstd[r] = (m < M) ? rsqrtf(var + eps) : 0.f;
      }
    }
    __syncthreads();
  }

  const int wm = (warp >> 1) * 32;  // warp's row offset in the tile
  const int wn = (warp & 1) * 32;   // warp's column offset in the tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    // stage A and B: 64 rows x 32 bf16 each = 256 16-byte chunks, 2 per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * THREADS;
      const int row = idx >> 2;
      const int col = (idx & 3) * 8;
      const int m = m0 + row;
      uint4 a = make_uint4(0, 0, 0, 0);
      if (m < M) {
        const size_t arow = (MAP == MAP_A) ? frame_major_row(m, map_F, map_HW) : (size_t)m;
        a = *reinterpret_cast<const uint4*>(X + arow * K + k0 + col);
        bf16* e = reinterpret_cast<bf16*>(&a);
        if (PRO == PRO_LN) {
          const float mu = s_mu[row];
          const float rstd = s_rstd[row];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int k = k0 + col + q;
            const float h = (__bfloat162float(e[q]) - mu) * (rstd * ln_w[k]) + ln_b[k];
            e[q] = __float2bfloat16(h);
          }
        } else if (PRO == PRO_GN) {
          const size_t v = (size_t)(m / rows_per_sample) * K + k0 + col;
          const float4 mu0 = *reinterpret_cast<const float4*>(gn_mul + v);
          const float4 mu1 = *reinterpret_cast<const float4*>(gn_mul + v + 4);
          const float4 ad0 = *reinterpret_cast<const float4*>(gn_add + v);
          const float4 ad1 = *reinterpret_cast<const float4*>(gn_add + v + 4);
          const float mul8[8] = {mu0.x, mu0.y, mu0.z, mu0.w, mu1.x, mu1.y, mu1.z, mu1.w};
          const float add8[8] = {ad0.x, ad0.y, ad0.z, ad0.w, ad1.x, ad1.y, ad1.z, ad1.w};
#pragma unroll
          for (int q = 0; q < 8; ++q)
            e[q] = __float2bfloat16(__fadd_rn(__fmul_rn(__bfloat162float(e[q]), mul8[q]), add8[q]));
        }
      }
      *reinterpret_cast<uint4*>(As + row * LDS + col) = a;

      int wrow;
      if (MODE == 2) {
        wrow = (row < BN / 2) ? (n0 + row) : (N / 2 + n0 + row - BN / 2);
      } else {
        wrow = n0 + row;
      }
      *reinterpret_cast<uint4*>(Bs + row * LDS + col) =
          *reinterpret_cast<const uint4*>(W + (size_t)wrow * K + k0 + col);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * n_out_tile; idx += THREADS) {
    const int r = idx / n_out_tile;
    const int c = idx - r * n_out_tile;
    const int m = m0 + r;
    if (m >= M) continue;
    const size_t orow = (MAP == MAP_OUT) ? frame_major_row(m, map_F, map_HW) : (size_t)m;
    const int n = n0 + c;
    float y;
    if (MODE == 2) {
      const float av = __bfloat162float(__float2bfloat16(Cs[r * LDC + c] + bias[n]));
      const float ag = __bfloat162float(__float2bfloat16(Cs[r * LDC + c + BN / 2] + bias[N / 2 + n]));
      y = av * gelu_erf(ag);
    } else if (MODE == 1) {
      const float o = __bfloat162float(__float2bfloat16(Cs[r * LDC + c] + bias[n]));
      y = o + __bfloat162float(R[orow * n_out + n]);
    } else {
      y = Cs[r * LDC + c] + (bias ? bias[n] : 0.f);
    }
    Y[orow * n_out + n] = __float2bfloat16(y);
  }
}

struct GemmArgs {
  const bf16* X; int M; int K;
  const float* ln_w; const float* ln_b; float eps;
  const float* gn_mul; const float* gn_add; int rows_per_sample; int map_F; int map_HW;
  const bf16* W; int N; const float* bias; const bf16* R; bf16* Y;
};

template <int MODE, int PRO, int MAP>
void launch(const GemmArgs& a, cudaStream_t stream) {
  const int n_out_tile = (MODE == 2) ? BN / 2 : BN;
  const int n_out = (MODE == 2) ? a.N / 2 : a.N;
  dim3 grid(n_out / n_out_tile, (a.M + BM - 1) / BM);
  ln_gemm_kernel<MODE, PRO, MAP><<<grid, THREADS, 0, stream>>>(
      a.X, a.M, a.K, a.ln_w, a.ln_b, a.eps, a.gn_mul, a.gn_add, a.rows_per_sample, a.map_F,
      a.map_HW, a.W, a.N, a.bias, a.R, a.Y);
}

}  // namespace

// Shapes the caller guarantees (checked in Python before the call):
// K % 32 == 0; N % 64 == 0; all pointers 16-byte aligned and row-contiguous;
// with gn_mul, M % rows_per_sample == 0 and mul/add are [M / rows_per_sample, K];
// with map_F > 0 (frame permute), M % (map_F * map_HW) == 0.
// Combinations: LN prologue with mode 0, 1 or 2; GN prologue with mode 0
// (wrapper head, frame permute of A optional); no prologue with mode 0, 1 or
// 2 (frame permute of the output optional in mode 1: wrapper tail).
extern "C" int ds_ln_gemm(const void* X, int M, int K, const void* ln_w, const void* ln_b,
                          float eps, const void* gn_mul, const void* gn_add, int rows_per_sample,
                          int map_F, int map_HW, const void* W, int N, const void* bias,
                          const void* R, void* Y, int mode, void* stream) {
  GemmArgs a{static_cast<const bf16*>(X), M, K,
             static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), eps,
             static_cast<const float*>(gn_mul), static_cast<const float*>(gn_add),
             rows_per_sample, map_F, map_HW,
             static_cast<const bf16*>(W), N, static_cast<const float*>(bias),
             static_cast<const bf16*>(R), static_cast<bf16*>(Y)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool map = map_F > 0;
  if (a.gn_mul != nullptr) {
    if (mode != 0 || a.ln_w != nullptr) return (int)cudaErrorInvalidValue;
    if (map) launch<0, PRO_GN, MAP_A>(a, s);
    else launch<0, PRO_GN, MAP_NONE>(a, s);
  } else if (a.ln_w != nullptr) {
    if (map) return (int)cudaErrorInvalidValue;
    if (mode == 0) launch<0, PRO_LN, MAP_NONE>(a, s);
    else if (mode == 1) launch<1, PRO_LN, MAP_NONE>(a, s);
    else if (mode == 2) launch<2, PRO_LN, MAP_NONE>(a, s);
    else return (int)cudaErrorInvalidValue;
  } else if (map) {
    if (mode != 1) return (int)cudaErrorInvalidValue;
    launch<1, PRO_NONE, MAP_OUT>(a, s);
  } else {
    if (mode == 0) launch<0, PRO_NONE, MAP_NONE>(a, s);
    else if (mode == 1) launch<1, PRO_NONE, MAP_NONE>(a, s);
    else if (mode == 2) launch<2, PRO_NONE, MAP_NONE>(a, s);
    else return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
