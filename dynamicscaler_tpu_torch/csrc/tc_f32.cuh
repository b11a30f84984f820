// The fp32 whole-block kernels' shared parts on the tensor cores (kernels
// 10 and 12 in temporal_f32.cu, kernels 11 and 13 in spatial_f32.cu): the
// token tile, the products on wgmma .tf32 through the three-product split
// (hopper.cuh), fed by a TMA ring of 32-deep k stages, and the LayerNorm
// pass. See temporal_f32.cu for the design and what was measured.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace tc_f32 {

using namespace hopper;

constexpr int BN = 128;                 // weight rows a column tile
constexpr int BK = 32;                  // k a stage: one 128-byte swizzle row of fp32
constexpr int ROW = BK * 4;             // bytes of a tile row
constexpr int STAGES = 4;               // ring slots
constexpr int D = 64;                   // head dim
constexpr int CONSUMERS = 256;          // warpgroups 0 and 1
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;  // 2 * 128 * 232 + 128 * 40 = 64512 of the 65536
constexpr int SMEM_MAX = 232448;   // the H100's per-block limit
constexpr int SMEM_ALIGN = 1024;   // the 128-byte swizzle repeats every 8 rows of 128 bytes

// The split of a tile of TM tokens between the two consumer warpgroups.
template <int TM>
struct Tile {
  static_assert(TM == 64 || TM == 128, "tiles of 64 or 128 tokens");
  static constexpr int MW = TM / 64;        // warpgroups along the tile's rows
  static constexpr int NW = 2 / MW;         // and along a column tile's columns
  static constexpr int WN = BN / NW;        // columns a warpgroup multiplies
  static constexpr int ACC = WN / 2;        // fp32 accumulators a thread
  static constexpr int HB = BN / (2 * NW);  // weight rows a TMA box: a warpgroup's value or gate rows in GEGLU
  static constexpr int A_BYTES = TM * ROW;  // a stage's token rows
  static constexpr int STAGE = A_BYTES + 2 * BN * ROW;
  static constexpr int RING = STAGES * STAGE;
};

__device__ __forceinline__ float gelu_erf(float g) {
  return g * 0.5f * (1.0f + erff(g * 0.70710678118654752f));
}

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Order this thread's generic-proxy writes (global and shared) before later
// async-proxy accesses: the TMA reads of the scratch rows, its writes to the
// ring's shared memory that the attention borrowed.
__device__ __forceinline__ void fence_proxy_async_all() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// ---- the consumers' passes ------------------------------------------------------

// Dst row r = LN(src row r) for the tile's rows (a warp eight rows at a time;
// fp32 sum and sum of squares, var = max(0, E[x^2] - mu^2)); rows >= rows
// are zeros.
template <int TM, class Src>
__device__ void layer_norm(Src src, int rows, int C, const float* __restrict__ w, const float* __restrict__ b,
                           float eps, float* dst) {
  constexpr int LR = 8;  // rows of a warp at a time, their loads in flight together
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = warp * LR; r0 < TM; r0 += LR * (CONSUMERS / 32)) {
    const float* x[LR];
    float s[LR], ss[LR], mu[LR], rstd[LR];
#pragma unroll
    for (int i = 0; i < LR; ++i) {
      x[i] = r0 + i < rows ? src(r0 + i) : nullptr;
      s[i] = ss[i] = 0.f;
    }
    for (int k = lane * 4; k < C; k += 128) {
      float4 v[LR];
#pragma unroll
      for (int i = 0; i < LR; ++i) v[i] = x[i] ? *reinterpret_cast<const float4*>(x[i] + k) : zero4();
#pragma unroll
      for (int i = 0; i < LR; ++i) {
        s[i] += v[i].x + v[i].y + v[i].z + v[i].w;
        ss[i] += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z + v[i].w * v[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < LR; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
        ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], o);
      }
      mu[i] = s[i] / (float)C;
      rstd[i] = rsqrtf(fast_variance(ss[i] / (float)C, mu[i]) + eps);
    }
    for (int k = lane * 4; k < C; k += 128) {
      const float4 g = __ldg(reinterpret_cast<const float4*>(w + k));
      const float4 c = __ldg(reinterpret_cast<const float4*>(b + k));
#pragma unroll
      for (int i = 0; i < LR; ++i) {
        float4 o = zero4();  // rows >= rows are zeros
        if (x[i]) {
          const float4 v = *reinterpret_cast<const float4*>(x[i] + k);
          o.x = __fadd_rn(__fmul_rn(__fsub_rn(v.x, mu[i]), __fmul_rn(rstd[i], g.x)), c.x);
          o.y = __fadd_rn(__fmul_rn(__fsub_rn(v.y, mu[i]), __fmul_rn(rstd[i], g.y)), c.y);
          o.z = __fadd_rn(__fmul_rn(__fsub_rn(v.z, mu[i]), __fmul_rn(rstd[i], g.z)), c.z);
          o.w = __fadd_rn(__fmul_rn(__fsub_rn(v.w, mu[i]), __fmul_rn(rstd[i], g.w)), c.w);
        }
        *reinterpret_cast<float4*>(dst + (size_t)(r0 + i) * C + k) = o;
      }
    }
  }
}

// ---- the products (gemm_f32.cu's stage, fragments and issue) --------------------

__device__ __forceinline__ void stage_wait(uint64_t* full, int it) {
  mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
}

// The A fragments of a stage's four k8 steps, split: f[0] hi, f[1] lo. Rows
// r0 (+8), columns 8j + t (+4) of the tile at `stage`, in the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8); r0 % 8 == g).
__device__ __forceinline__ void load_frags(const uint8_t* stage, int r0, int g, int t, uint32_t (&f)[2][4][4]) {
  const uint8_t* arow = stage + r0 * ROW + t * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_tf32(*reinterpret_cast<const float*>(arow + h * 8 * ROW + (((2 * j + c) ^ g) << 4)),
                   f[0][j][h + 2 * c], f[1][j][h + 2 * c]);
}

// A stage's 12 products into `part` (started at zero unless `cont`): per
// k8 step a_lo.b_hi, a_hi.b_lo, a_hi.b_hi, B (rounded, then its remainders
// BN rows further) at `b`.
template <int WN>
__device__ __forceinline__ void issue_stage(float (&part)[WN / 2], const uint32_t (&f)[2][4][4], const uint8_t* b,
                                            bool cont) {
  const uint64_t bh = smem_desc(b), bl = smem_desc(b + BN * ROW);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    WgmmaTf32RegA<WN>::mma(part, f[1][j], bh + 2 * j, j || cont);
    WgmmaTf32RegA<WN>::mma(part, f[0][j], bl + 2 * j, 1);
    WgmmaTf32RegA<WN>::mma(part, f[0][j], bh + 2 * j, 1);
  }
  wgmma_commit();
}

// Hand ring slot s back to the producer: one arrival a consumer warp (its
// wgmma reads of the slot are complete once its wait returned).
__device__ __forceinline__ void release(uint64_t* empty, int s, int lane) {
  if (lane == 0) mbar_arrive(&empty[s]);
}

// acc = the products of one column tile over its KT stages (KT even), ring
// position `it` on: two stages an iteration, their fragments in f0 and f1,
// the next stage's loaded and split while the products run; the second
// stage's products issued behind the first's into the same accumulator
// `part`, which is folded into acc in fp32 once the two are done (64 k: the
// tensor cores wait for the fold once in two stages). The warpgroup
// multiplies the WN weight rows at `wrow` bytes into each stage's W_hi.
template <int TM>
__device__ __forceinline__ void column_tile(float (&acc)[Tile<TM>::ACC], uint8_t* smem, uint64_t* full,
                                            uint64_t* empty, int& it, int KT, int wrow, int r0, int g8, int t4,
                                            int lane) {
  using T = Tile<TM>;
  float part[T::ACC];  // two stages' products (issue_stage overwrites it at the first stage's first k8 step)
#pragma unroll
  for (int i = 0; i < T::ACC; ++i) part[i] = 0.f;
  uint32_t f0[2][4][4], f1[2][4][4];
  stage_wait(full, it);
  load_frags(smem + (it % STAGES) * T::STAGE, r0, g8, t4, f0);
#pragma unroll 1
  for (int kt = 0; kt < KT; kt += 2, it += 2) {
    const int s0 = it % STAGES, s1 = (it + 1) % STAGES;
    issue_stage<T::WN>(part, f0, smem + s0 * T::STAGE + T::A_BYTES + wrow, false);
    stage_wait(full, it + 1);
    load_frags(smem + s1 * T::STAGE, r0, g8, t4, f1);
    issue_stage<T::WN>(part, f1, smem + s1 * T::STAGE + T::A_BYTES + wrow, true);
    wgmma_wait<1>();  // the first stage's products are done: its slot and f0 are free
    release(empty, s0, lane);
    if (kt + 2 < KT) {
      stage_wait(full, it + 2);
      load_frags(smem + ((it + 2) % STAGES) * T::STAGE, r0, g8, t4, f0);
    }
    wgmma_wait<0>();
    fence_acc(part);
    release(empty, s1, lane);
#pragma unroll
    for (int i = 0; i < T::ACC; ++i) acc[i] += part[i];
  }
}

// The weight rows of box b (of 2 NW) of column tile j of product g: in GEGLU
// the boxes alternate value rows n0.. and the matching gate rows N / 2 +
// n0.. (so a warpgroup's columns hold both), else they follow each other
// from n0; -1 for a box past N.
template <int TM>
__device__ __forceinline__ int box_row(int b, int j, int N, bool geglu) {
  using T = Tile<TM>;
  if (geglu) return (b & 1 ? N / 2 : 0) + j * (BN / 2) + (b >> 1) * T::HB;
  const int n = j * BN + b * T::HB;
  return n < N ? n : -1;
}

}  // namespace tc_f32
