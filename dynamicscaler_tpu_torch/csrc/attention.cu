// Attention cores of the UNet transformer sub-blocks, head dim 64, bf16 in
// and out, fp32 softmax.
//
// ds_temporal_attention replaces the attention half of
//   dynamicscaler_tpu/ops/fused_temporal.py::_kernel (K1).
// F frame tokens per (row, head), any F with 2 <= F <= 128 and 128 % F == 0
// (the JAX gate `fusable`). The TPU kernel packed 128 / F rows into one
// 128x128 block-diagonal MXU product; here a block stages 128 tokens (128 /
// F whole rows) of one head's q, k and v in shared memory (pitch 72 bf16:
// ldmatrix reads hit distinct banks) and each warp owns 16 query tokens:
// S = Q K^T over its row's F keys (F >= 16) or over its own 16 tokens with a
// block-diagonal mask (F < 16: 16 / F rows a warp), then O = P V, both on
// mma.sync m16n8k16 (bf16 in, fp32 accumulation; V's fragments loaded
// transposed with ldmatrix.trans). The softmax runs on the accumulator
// registers, the four threads of a quad owning a row. At F = 16 that is 8 +
// 8 tensor-core instructions a warp, so the op is bound by reading q, k, v
// once and writing o once (0.25 ms at the batch-8 level-1 shape, 20480 rows
// of 16 frames at C 320 with its 5 heads). Probabilities are normalised and
// rounded to bf16 BEFORE the PV product, as the TPU kernel does.
//
// ds_flash_attention replaces the attention halves of
//   dynamicscaler_tpu/ops/fused_spatial.py::_kernel       (K2, N up to 2560)
//   dynamicscaler_tpu/ops/fused_spatial.py::_cross_kernel (K3, 77 text + 16 image keys)
// The TPU kernel held the [N, N] fp32 logits in VMEM; at 128 query rows x
// 2560 keys that is 1.3 MB, beyond a Hopper block's 227 KB of shared memory,
// so this is a flash-attention forward, built as csrc/gemm.cu is:
//   * a persistent grid (one block per SM) walks the tiles of 128 query rows
//     of one (sample, head), query tiles fastest (the blocks in flight share
//     their K and V in L2); a block is two consumer warpgroups of 64 rows
//     each and a producer warpgroup (384 threads; setmaxnreg moves the
//     producer's registers to the consumers);
//   * one producer thread loads each tile's Q into one of two buffers (the
//     next tile's while this one computes) and streams the K and V tiles of
//     every key segment by TMA into a ring of 4 stages on mbarriers, running
//     on across tiles; every operand has a 3-D tensor map (64 columns of one
//     head, row within the sample, sample), so a box never crosses into the
//     next sample's rows and a ragged tile arrives zero-filled;
//   * (the steps below live in flash.cuh, which mega.cu shares)
//     S = Q K^T runs on wgmma m64nBNk16 with both operands in shared memory
//     (128-byte swizzle, K-major); the online softmax runs on the
//     accumulator registers (the four threads of a quad own a row: two
//     shuffles for its max), logits past the segment's length masked to
//     -inf;
//   * P is rounded to bf16 in registers, where the accumulator layout of S is
//     already the A-fragment layout of the next product, and O += P V runs on
//     wgmma m64n64k16 with A from registers and V read MN-major (transposed
//     through the descriptor) from the same shared-memory tile TMA wrote;
//   * within a warpgroup, tile j's S product is issued together with tile
//     j-1's P V product and tile j's softmax runs while P V is in flight; the
//     two consumer warpgroups run independently on the same K/V stages, so
//     one's softmax also overlaps the other's products (a ping-pong that
//     ordered their issues with named barriers measured no faster); each
//     releases a stage after its P V product;
//   * the output goes through the warpgroup's own Q rows in shared memory (a
//     swizzled staging tile) and out in 16-byte row pieces.
// Numerics (fused_spatial.py:113-126, 262-276): fp32 logits times the scale
// (computed in the base-2 domain: exp(x) = exp2(x log2 e)); the
// exponentials rounded to bf16 for P V; the fp32 sum of the unrounded
// exponentials divided out after P V. Keys come in one or two segments with
// separate softmaxes whose normalised outputs are summed (the i2v dual
// text/image cross-attention). Self-attention (K2) streams key tiles of 128;
// the cross-attention variant (K3) takes each segment in tiles of 80 and 16
// keys (77 text keys and 16 image keys: one tile each), so it does 96 keys of
// work a query instead of 256 and is bound by reading Q and writing O.
// What bounds them on the H100: K2 at N = 2560 does 4 N^2 64 operations a
// (sample, head), 1.07 TFLOP a call at batch 8 (1.09 ms at 989 TFLOP/s),
// beside 4.2e9 exponentials (about 1.1 ms on the special-function units);
// K2 at N <= 640 and K3 everywhere are bound by the bytes of q, k, v and o.

#include <math.h>

#include "flash.cuh"
#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;
using namespace flash;

constexpr int D = 64;  // head dim

// ---------------------------------------------------------------------------
// temporal: 128 tokens (128 / F rows) of one head a block, a warp per 16 queries
// ---------------------------------------------------------------------------

constexpr int T_TOKENS = 128;
constexpr int T_THREADS = 256;             // 8 warps x 16 query tokens
constexpr int T_LD = D + 8;                // bf16 pitch of the staged rows (144 B: ldmatrix conflict-free)
constexpr int T_SMEM = 3 * T_TOKENS * T_LD * 2;  // q, k, v: 55,296 bytes

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p, bool trans) {
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c[4] += a[4] (16x16 bf16, row) b[2] (16x8 bf16, col), fp32. Thread (g =
// lane / 4, t = lane % 4) holds c at rows g, g + 8 and columns 2t, 2t + 1.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
               "{%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// NK keys a query tile: its row's F keys (F >= 16), or the tile's own 16
// tokens with a block-diagonal mask (F < 16: 16 / F rows in the tile)
template <int NK>
__global__ void __launch_bounds__(T_THREADS)
temporal_attn_kernel(const bf16* __restrict__ qkv, long long T, int F, int C, float scale,
                     bf16* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t t_smem[];
  bf16* qs = reinterpret_cast<bf16*>(t_smem);
  bf16* ks = qs + T_TOKENS * T_LD;
  bf16* vs = ks + T_TOKENS * T_LD;
  const int h = blockIdx.y;
  const long long tok0 = (long long)blockIdx.x * T_TOKENS;
  const size_t ld = 3 * (size_t)C;
  for (int i = threadIdx.x; i < 3 * T_TOKENS * (D / 8); i += T_THREADS) {
    const int which = i / (T_TOKENS * (D / 8));
    const int r = (i / (D / 8)) % T_TOKENS, c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (tok0 + r < T) v = *reinterpret_cast<const uint4*>(qkv + (size_t)(tok0 + r) * ld + which * C + h * D + c);
    *reinterpret_cast<uint4*>(qs + (which * T_TOKENS + r) * T_LD + c) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = 16 * warp;                      // the warp's first query token
  const int kb = F >= 16 ? (q0 / F) * F : q0;    // its first key token
  // S = Q K^T, 16 x NK
  float sacc[NK / 8][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, qs + (q0 + (lane & 15)) * T_LD + kk + (lane >> 4) * 8, false);
#pragma unroll
    for (int nb = 0; nb < NK / 16; ++nb) {
      uint32_t b[4];
      ldsm_x4(b, ks + (kb + nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * T_LD + kk + ((lane >> 3) & 1) * 8, false);
      mma16816(sacc[2 * nb], a, b);
      mma16816(sacc[2 * nb + 1], a, b + 2);
    }
  }
  // softmax over each row (a quad's four threads own it), probabilities
  // normalised and rounded to bf16; the P fragments of keys 16kk.. are A
  uint32_t pa[NK / 16][4];
  {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const bool ok = F >= 16 || (q0 + g + 8 * hh) / F == (q0 + 8 * j + 2 * t4 + (e & 1)) / F;
        const float v = ok ? sacc[j][e] * scale : -INFINITY;
        sacc[j][e] = v;
        m[hh] = fmaxf(m[hh], v);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
    }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[j][e] - m[e >> 1]);
        sacc[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      pa[kk][0] = pack2(sacc[2 * kk][0] / l[0], sacc[2 * kk][1] / l[0]);
      pa[kk][1] = pack2(sacc[2 * kk][2] / l[1], sacc[2 * kk][3] / l[1]);
      pa[kk][2] = pack2(sacc[2 * kk + 1][0] / l[0], sacc[2 * kk + 1][1] / l[0]);
      pa[kk][3] = pack2(sacc[2 * kk + 1][2] / l[1], sacc[2 * kk + 1][3] / l[1]);
    }
  }
  // O = P V, 16 x 64: V rows are keys, so its B fragments load transposed
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t b[4];
      ldsm_x4(b, vs + (kb + kk * 16 + (mi & 1) * 8 + (lane & 7)) * T_LD + nb * 16 + (mi >> 1) * 8, true);
      mma16816(o[2 * nb], pa[kk], b);
      mma16816(o[2 * nb + 1], pa[kk], b + 2);
    }
  // out through the warp's own q rows, then 16-byte row pieces
  bf16* st = qs + q0 * T_LD;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(st + (g + 8 * hh) * T_LD + 8 * j + 2 * t4) = pack2(o[j][2 * hh], o[j][2 * hh + 1]);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i >> 3, u = i & 7;
    if (tok0 + q0 + r < T)
      *reinterpret_cast<uint4*>(out + (size_t)(tok0 + q0 + r) * C + h * D + u * 8) =
          *reinterpret_cast<const uint4*>(st + r * T_LD + u * 8);
  }
}

template <int NK>
cudaError_t launch_temporal(const bf16* qkv, long long T, int F, int C, int heads, float scale, bf16* out,
                            cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(temporal_attn_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  dim3 grid((unsigned)((T + T_TOKENS - 1) / T_TOKENS), heads);
  temporal_attn_kernel<NK><<<grid, T_THREADS, T_SMEM, stream>>>(qkv, T, F, C, scale, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash: persistent blocks over (query tile, head, sample), TMA ring + wgmma
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 128;               // query rows a tile: two consumer warpgroups of 64
constexpr int FA_THREADS = 384;          // warpgroups 0, 1 consume; thread 0 of warpgroup 2 produces
constexpr int FA_STAGES = 4;             // K/V ring depth
constexpr int FA_CONSUMER_REGS = 232;
constexpr int FA_PRODUCER_REGS = 40;     // 2 * 128 * 232 + 128 * 40 = 64512 of the 65536
constexpr int ROW = D * 2;               // bytes of one head's row (one 128-byte swizzle row)
constexpr int Q_BYTES = FA_BQ * ROW;     // 16 KB a Q buffer; two of them
constexpr int SMEM_ALIGN = 1024;
constexpr float LOG2E = 1.4426950408889634f;

struct FlashParams {
  int Nq, len0, len1, nseg, heads, q_tiles, tiles;
  float scale_log2;  // softmax scale x log2(e)
  bf16* out;
  int ldo;
};

__host__ __device__ constexpr int flash_max(int a, int b) { return a > b ? a : b; }

template <int BN0, int BN1>
__host__ __device__ constexpr int flash_stage_bytes() { return 2 * flash_max(BN0, BN1) * ROW; }

template <int BN0, int BN1>
__host__ __device__ constexpr int flash_smem() {
  return SMEM_ALIGN + 2 * Q_BYTES + FA_STAGES * flash_stage_bytes<BN0, BN1>() + 8 * (4 + 2 * FA_STAGES);
}

// One key segment for this warpgroup's 64 query rows: the online softmax
// over its tiles of BN keys (ring position `it`, advanced per tile), O
// unnormalised in o, each row's sum of exponentials in l (reduced over the
// row's quad on return). Thread (warp w, lane x) owns rows 16w + x/4 (+8).
// Software pipeline: tile j's S = Q K^T is issued together with tile j-1's
// O += P V, and tile j's softmax runs while that P V product is in flight
// (the first tile is peeled, so every wait is unconditional).
template <int BN>
__device__ __forceinline__ void attend_segment(float (&o)[32], float (&l)[2], const uint8_t* ring, int stage_bytes,
                                               uint64_t* full, uint64_t* empty, int& it, int len, uint64_t qdesc,
                                               float sl) {
  const int lane = threadIdx.x & 31;
  float m[2] = {-INFINITY, -INFINITY};  // running row max of the raw logits
  float alpha[2];
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float sacc[BN / 2];
  uint32_t pa[BN / 16][4];

  int prev = it % FA_STAGES;
  mbar_wait(&full[prev], (it / FA_STAGES) & 1);
  wgmma_fence();
  issue_s<BN>(sacc, qdesc, ring + prev * stage_bytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sacc);
  softmax_tile<BN>(sacc, m, l, alpha, len, sl);
  pack_p<BN>(pa, sacc);
  ++it;
  for (int k0 = BN; k0 < len; k0 += BN, ++it) {
    const int s = it % FA_STAGES;
    mbar_wait(&full[s], (it / FA_STAGES) & 1);
    wgmma_fence();
    issue_s<BN>(sacc, qdesc, ring + s * stage_bytes);
    wgmma_commit();
    issue_pv<BN>(o, pa, ring + prev * stage_bytes + stage_bytes / 2);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sacc);
    softmax_tile<BN>(sacc, m, l, alpha, len - k0, sl);
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p<BN>(pa, sacc);
    prev = s;
  }
  wgmma_fence();
  issue_pv<BN>(o, pa, ring + prev * stage_bytes + stage_bytes / 2);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
  fence_regs(pa);
  if (lane == 0) mbar_arrive(&empty[prev]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
}

// tile -> (query tile, head, sample), query tiles fastest: the blocks in
// flight share their K and V in L2
__device__ __forceinline__ void flash_tile(const FlashParams& p, int tile, int& q0, int& h, int& b) {
  q0 = (tile % p.q_tiles) * FA_BQ;
  const int bh = tile / p.q_tiles;
  h = bh % p.heads;
  b = bh / p.heads;
}

template <int BN0, int BN1>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_attn_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk0,
                  const __grid_constant__ CUtensorMap tv0, const __grid_constant__ CUtensorMap tk1,
                  const __grid_constant__ CUtensorMap tv1, const FlashParams p) {
  constexpr int STAGE = flash_stage_bytes<BN0, BN1>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
                                             ~uintptr_t(SMEM_ALIGN - 1));
  uint8_t* qs = smem;  // two Q buffers
  uint8_t* ring = smem + 2 * Q_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ring + FA_STAGES * STAGE);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + FA_STAGES;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FA_PRODUCER_REGS));
    if (tid == 0) {
      int it = 0, n = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++n) {
        int q0, h, b;
        flash_tile(p, tile, q0, h, b);
        const int qb = n & 1;
        mbar_wait(&qempty[qb], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull[qb], Q_BYTES);
        tma_load_3d(qs + qb * Q_BYTES, &tq, &qfull[qb], h * D, q0, b);
        for (int sg = 0; sg < p.nseg; ++sg) {
          const int bn = sg ? BN1 : BN0;
          const int len = sg ? p.len1 : p.len0;
          const CUtensorMap* mk = sg ? &tk1 : &tk0;
          const CUtensorMap* mv = sg ? &tv1 : &tv0;
          for (int k0 = 0; k0 < len; k0 += bn, ++it) {
            const int s = it % FA_STAGES;
            mbar_wait(&empty[s], ((it / FA_STAGES) & 1) ^ 1);
            uint8_t* kt = ring + s * STAGE;
            mbar_expect_tx(&full[s], 2 * bn * ROW);
            tma_load_3d(kt, mk, &full[s], h * D, k0, b);
            tma_load_3d(kt + STAGE / 2, mv, &full[s], h * D, k0, b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FA_CONSUMER_REGS));
    const int warp = tid >> 5, lane = tid & 31;
    int it = 0, n = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++n) {
      int q0, h, b;
      flash_tile(p, tile, q0, h, b);
      const int qb = n & 1;
      uint8_t* qrows = qs + qb * Q_BYTES + wg * 64 * ROW;
      const uint64_t qdesc = smem_desc(qrows);
      mbar_wait(&qfull[qb], (n >> 1) & 1);
      float o[32], l[2], fin[32];
      attend_segment<BN0>(o, l, ring, STAGE, full, empty, it, p.len0, qdesc, p.scale_log2);
#pragma unroll
      for (int i = 0; i < 32; ++i) fin[i] = o[i] / l[(i >> 1) & 1];
      if (p.nseg == 2) {
        attend_segment<BN1>(o, l, ring, STAGE, full, empty, it, p.len1, qdesc, p.scale_log2);
#pragma unroll
        for (int i = 0; i < 32; ++i) fin[i] += o[i] / l[(i >> 1) & 1];
      }

      // out through this warpgroup's Q rows (no longer read): row r's 16-byte
      // chunk u at chunk u ^ (r % 8), so the stores and the row reads hit
      // distinct banks; then 16-byte row pieces to device memory, and the Q
      // buffer back to the producer
      bf16* st = reinterpret_cast<bf16*>(qrows);
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * warp + (lane >> 2) + 8 * hh;
          const int c = 2 * (lane & 3);
          *reinterpret_cast<uint32_t*>(st + r * D + ((g ^ (r & 7)) << 3) + c) =
              pack2(fin[4 * g + 2 * hh], fin[4 * g + 2 * hh + 1]);
        }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int i = tid; i < 64 * 8; i += 128) {
        const int r = i >> 3, u = i & 7;
        const int row = q0 + wg * 64 + r;
        const uint4 v = *reinterpret_cast<const uint4*>(st + r * D + ((u ^ (r & 7)) << 3));
        if (row < p.Nq) *reinterpret_cast<uint4*>(p.out + ((size_t)b * p.Nq + row) * p.ldo + h * D + u * 8) = v;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&qempty[qb]);
    }
  }
}

// one operand's map: [B, len, ld] rows, the 64 columns of a head, box-row boxes
bool seg_map(CUtensorMap* map, const void* base, int B, int len, int ld, int width, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)len, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)len * ld * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1};
  return make_map(map, base, 3, dims, strides, box);
}

template <int BN0, int BN1>
cudaError_t launch_flash(const void* q, int ldq, int B, int Nq, int heads, const void* k0, const void* v0, int ld0,
                         int len0, const void* k1, const void* v1, int ld1, int len1, int nseg, float scale,
                         void* out, int ldo, cudaStream_t stream) {
  constexpr int smem = flash_smem<BN0, BN1>();
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(flash_attn_kernel<BN0, BN1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const int width = heads * D;
  CUtensorMap tq, tk0, tv0, tk1, tv1;
  bool ok = seg_map(&tq, q, B, Nq, ldq, width, FA_BQ) && seg_map(&tk0, k0, B, len0, ld0, width, BN0) &&
            seg_map(&tv0, v0, B, len0, ld0, width, BN0);
  if (nseg == 2) {
    ok = ok && seg_map(&tk1, k1, B, len1, ld1, width, BN1) && seg_map(&tv1, v1, B, len1, ld1, width, BN1);
  } else {
    tk1 = tk0;
    tv1 = tv0;
  }
  if (!ok) return cudaErrorInvalidValue;
  const int q_tiles = (Nq + FA_BQ - 1) / FA_BQ;
  const long long tiles = (long long)q_tiles * heads * B;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  FlashParams p{Nq, len0, nseg == 2 ? len1 : 0, nseg, heads, q_tiles, (int)tiles, scale * LOG2E,
                static_cast<bf16*>(out), ldo};
  const int grid = tiles < sm_count() ? (int)tiles : sm_count();
  flash_attn_kernel<BN0, BN1><<<grid, FA_THREADS, smem, stream>>>(tq, tk0, tv0, tk1, tv1, p);
  return cudaGetLastError();
}

}  // namespace

// qkv: [R * F, 3C] bf16 (q | k | v columns, each head's 64 together), out:
// [R * F, C] bf16, C = heads * 64; 2 <= F <= 128, 128 % F == 0.
extern "C" int ds_temporal_attention(const void* qkv, int R, int F, int C, int heads, float scale, void* out,
                                     void* stream) {
  if (R <= 0 || F < 2 || F > 128 || 128 % F || C != heads * D) return (int)cudaErrorInvalidValue;
  const long long T = (long long)R * F;
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* y = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (F <= 16) e = launch_temporal<16>(x, T, F, C, heads, scale, y, s);
  else if (F == 32) e = launch_temporal<32>(x, T, F, C, heads, scale, y, s);
  else if (F == 64) e = launch_temporal<64>(x, T, F, C, heads, scale, y, s);
  else e = launch_temporal<128>(x, T, F, C, heads, scale, y, s);
  return (int)e;
}

// q: rows b * Nq + i with pitch ldq; segment s keys/values: rows b * len_s + j
// with pitch ld_s; head h at column h * 64 of every operand; out rows b * Nq
// + i with pitch ldo. nseg is 1 or 2; every length >= 1; pitches multiples of
// 8 and every pointer 16-byte aligned. One segment of more than 80 keys (the
// self-attention) runs in key tiles of 128; otherwise (the cross-attention,
// a short self-attention) the first segment in tiles of 80 and the second
// in tiles of 16.
extern "C" int ds_flash_attention(const void* q, int ldq, int B, int Nq, int heads,
                                  const void* k0, const void* v0, int ld0, int len0,
                                  const void* k1, const void* v1, int ld1, int len1,
                                  int nseg, float scale, void* out, int ldo, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (B <= 0 || Nq <= 0 || heads <= 0 || len0 <= 0 || (nseg != 1 && nseg != 2)) return (int)bad;
  if (nseg == 2 && (len1 <= 0 || k1 == nullptr || v1 == nullptr || ld1 % 8)) return (int)bad;
  if (ldq % 8 || ld0 % 8 || ldo % 8 || heads * D > ldq || heads * D > ld0 || heads * D > ldo) return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      nseg == 1 && len0 > 80
          ? launch_flash<128, 128>(q, ldq, B, Nq, heads, k0, v0, ld0, len0, k1, v1, ld1, len1, nseg, scale, out,
                                   ldo, s)
          : launch_flash<80, 16>(q, ldq, B, Nq, heads, k0, v0, ld0, len0, k1, v1, ld1, len1, nseg, scale, out, ldo,
                                 s);
  return (int)e;
}
