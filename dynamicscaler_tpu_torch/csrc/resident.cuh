// The resident-token machinery shared by block.cu (kernels 10 and 12) and
// mega.cu (kernels 11 and 13): a block keeps TM tokens in shared memory, in
// the 128-byte-swizzled K-major layout wgmma reads (tok_off), and 384
// threads: two consumer warpgroups and a producer warpgroup, one thread of
// which streams 128-row x 64-k weight tiles (16 KB) by TMA through a ring of
// mbarrier-guarded slots. The consumers run the projections on wgmma with
// the operands swapped (64 weight rows of a ring tile as M, one warpgroup
// each; the resident token tile as N = TM), one k step in flight, and the
// LayerNorm between them on the swizzled tiles.

#pragma once

#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace resident {

using namespace hopper;

constexpr int D = 64;                        // head dim
constexpr int WROWS = 128;                   // weight rows a ring tile: 64 per consumer warpgroup
constexpr int BK = 64;                       // k a ring tile: one 128-byte swizzle row of bf16
constexpr int TILE_BYTES = WROWS * BK * 2;   // 16 KB
constexpr int CONSUMERS = 256;               // warpgroups 0 and 1
constexpr int THREADS = CONSUMERS + 128;     // and the producer warpgroup (one thread issues)
// ptxas compiles the block at the launch bound's 168 registers a thread;
// setmaxnreg moves the producer warpgroup's share to the consumers, whose
// feed-forward holds up to 3 x 32 + 2 x 32 accumulators at TM 64
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;  // 2 * 128 * 232 + 128 * 40 = 64512 of the 65536
constexpr int SMEM_MAX = 232448;             // the H100's per-block limit
constexpr int SMEM_ALIGN = 1024;             // the 128-byte swizzle repeats every 8 rows of 128 bytes

// the most output tiles of 128 columns the feed-forward's second product
// keeps in registers at each TM (C <= 384, 640, 1280)
__host__ __device__ constexpr int ff_tiles(int tm) { return tm == 64 ? 3 : tm == 32 ? 5 : 10; }

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float round_bf(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float gelu_erf(float g) { return g * 0.5f * (1.0f + erff(g * 0.70710678118654752f)); }

// Byte offset of (token, column) in a swizzled token tile of TM rows: k
// blocks of 64 columns (TM rows of 128 bytes each), the 16-byte chunks of a
// row permuted by the row's index mod 8, as TMA writes and wgmma reads them.
template <int TM>
__device__ __forceinline__ int tok_off(int row, int col) {
  return (col >> 6) * (TM * 128) + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// ---- the weight ring, consumer side ---------------------------------------------

struct Ring {
  uint8_t* base;
  uint64_t* full;   // the tile landed (the whole 16 KB, from every block's slice)
  uint64_t* empty;  // every consumer warp of the cluster is done with it
  int S, cl;        // stages, blocks a cluster
  int s;            // the next tile's slot
  uint32_t phase;   // and the parity of its fill
  __device__ __forceinline__ void advance() {
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
};

// Hand slot s back to every producer of the cluster: one arrival a
// warpgroup and block (its wgmma reads of the slot are complete once the
// warpgroup's wait returns), from the warpgroup's first cl threads.
__device__ __forceinline__ void release(const Ring& rg, int s) {
  const int t = threadIdx.x & 127;
  if (t < rg.cl) mbar_arrive_cluster(&rg.empty[s], t);
}

// Hand back slot s, which this warpgroup alone read (an attention tile of
// mega.cu, cluster size 1): thread 0 arrives for both warpgroups.
__device__ __forceinline__ void release_alone(const Ring& rg, int s) {
  if ((threadIdx.x & 127) == 0) mbar_arrive_count(&rg.empty[s], 2);
}

// acc += W[this warpgroup's 64 rows of the next nk ring tiles] . B^T: B the
// swizzled token tile from k block 0 (TM rows, nk x 64 k). One k step stays
// in flight; the first is peeled, so no wgmma wait is conditional.
template <int TM>
__device__ __forceinline__ void mma_tile(float (&acc)[TM / 2], Ring& rg, const uint8_t* B, int nk) {
  const int wg = threadIdx.x >> 7;
  int s = rg.s;
  mbar_wait(&rg.full[s], rg.phase);
  wgmma_fence();
  {
    const uint64_t da = smem_desc(rg.base + s * TILE_BYTES + wg * 64 * 128);
    const uint64_t db = smem_desc(B);
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) Wgmma<TM>::mma(acc, da + 2 * k, db + 2 * k, 1);
  }
  wgmma_commit();
  int prev = s;
  for (int ks = 1; ks < nk; ++ks) {
    rg.advance();
    s = rg.s;
    mbar_wait(&rg.full[s], rg.phase);
    wgmma_fence();
    const uint64_t da = smem_desc(rg.base + s * TILE_BYTES + wg * 64 * 128);
    const uint64_t db = smem_desc(B + ks * TM * 128);
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) Wgmma<TM>::mma(acc, da + 2 * k, db + 2 * k, 1);
    wgmma_commit();
    wgmma_wait<1>();
    release(rg, prev);
    prev = s;
  }
  wgmma_wait<0>();
  release(rg, prev);
  rg.advance();
  fence_acc(acc);
}

// epi(token, column, off, value + bias[column], i) for every accumulator
// element acc[i] of the output tile whose weight rows start at row0 and
// whose column is below rows (bias may be null); off is the element's byte
// offset in a swizzled token tile. Thread (warp w of warpgroup wg, lane l) holds
// columns row0 + 64 wg + 16 w + l/4 (+8) and tokens 8 g + 2 (l%4) + {0, 1}:
// one bias load a column, and one swizzle a (column, token mod 8), since
// token 8 g + t sits g x 1024 bytes after token t.
template <int TM, class Epi>
__device__ __forceinline__ void epilogue(const float (&acc)[TM / 2], int row0, int rows, const float* bias, Epi epi) {
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = row0 + 64 * wg + 16 * w + (lane >> 2) + 8 * h;
    if (c >= rows) continue;
    const float b = bias ? __ldg(bias + c) : 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * (lane & 3) + e;
      const int off = tok_off<TM>(t, c);
#pragma unroll
      for (int g = 0; g < TM / 8; ++g) epi(8 * g + t, c, off + g * 1024, acc[4 * g + 2 * h + e] + b, 4 * g + 2 * h + e);
    }
  }
}

// Y[TM, 0:rows] = B[TM, 0:64 nk] @ W[row0.., :]^T + bias tile by tile (the
// weight rows as the producer issues them), through epi as epilogue() calls it.
template <int TM, class Epi>
__device__ __forceinline__ void gemm_rows(Ring& rg, const uint8_t* B, int nk, int rows, const float* bias, Epi epi) {
  for (int p = 0; p < rows; p += WROWS) {
    float acc[TM / 2];
#pragma unroll
    for (int i = 0; i < TM / 2; ++i) acc[i] = 0.f;
    mma_tile<TM>(acc, rg, B, nk);
    epilogue<TM>(acc, p, rows, bias, epi);
  }
}

// Dst = LN(Src) row by row over the swizzled [TM, C] tiles (flax numerics:
// fp32 fast-variance statistics, var = max(0, E[x^2] - mu^2), y = (x - mu) *
// (rsqrt(var + eps) * s) + b rounded to bf16): warp w owns rows w + 8 i, a
// lane 16 bytes of a row at a time; the statistics of the warp's rows
// first, then each 8 columns' scale and bias loaded once for all of them.
// Both ends synchronise the consumers; Dst is then ready for wgmma.
template <int TM>
__device__ void layer_norm(const uint8_t* Src, uint8_t* Dst, int C, const float* __restrict__ s,
                           const float* __restrict__ b, float eps) {
  constexpr int RPW = TM / (CONSUMERS / 32);  // rows a warp
  consumer_sync();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float mu[RPW], rstd[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + 8 * i;
    float sum = 0.f, ss = 0.f;
    for (int k = lane * 8; k < C; k += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(Src + tok_off<TM>(r, k));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(h[q]);
        sum += f.x + f.y;
        ss += f.x * f.x + f.y * f.y;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    mu[i] = sum / (float)C;
    rstd[i] = rsqrtf(fast_variance(ss / (float)C, mu[i]) + eps);
  }
  for (int k = lane * 8; k < C; k += 256) {
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(s + k));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(s + k + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + k));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + k + 4));
    const float w8[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int off = tok_off<TM>(warp + 8 * i, k);
      uint4 v = *reinterpret_cast<const uint4*>(Src + off);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(h[q]);
        h[q] = __floats2bfloat162_rn((f.x - mu[i]) * (rstd[i] * w8[2 * q]) + b8[2 * q],
                                     (f.y - mu[i]) * (rstd[i] * w8[2 * q + 1]) + b8[2 * q + 1]);
      }
      *reinterpret_cast<uint4*>(Dst + off) = v;
    }
  }
  fence_proxy_async();
  consumer_sync();
}

// The GEGLU feed-forward, X += GEGLU(LN(X) @ W1 + b1) @ W2 + b2, over hidden
// chunks of hc columns: each 128 value rows and then the matching 128 gate
// rows, one epilogue from both accumulators (the same thread holds a
// column's value and gate) into the swizzled chunk Hid, then the chunk's
// share of the second product, accumulated in registers (C / 128 output
// tiles) over the chunks. H takes LN(X). Both ends synchronise the
// consumers; X is then ready for wgmma.
template <int TM>
__device__ void feed_forward(Ring& rg, uint8_t* Xs, uint8_t* Hs, uint8_t* Hid, int C, int hc, const float* ln_w,
                             const float* ln_b, const float* b1, const float* b2, float eps) {
  const int nk = C / BK;
  layer_norm<TM>(Xs, Hs, C, ln_w, ln_b, eps);
  constexpr int NT = ff_tiles(TM);
  float acc[NT][TM / 2];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < TM / 2; ++i) acc[t][i] = 0.f;
  const int H4 = 4 * C;
  for (int j0 = 0; j0 < H4; j0 += hc) {
    for (int p = 0; p < hc; p += WROWS) {
      float av[TM / 2], ag[TM / 2];
#pragma unroll
      for (int i = 0; i < TM / 2; ++i) av[i] = ag[i] = 0.f;
      mma_tile<TM>(av, rg, Hs, nk);
      mma_tile<TM>(ag, rg, Hs, nk);
      const float* bg = b1 + H4 + j0;
      epilogue<TM>(av, p, hc, b1 + j0, [&](int, int c, int off, float v, int i) {
        *reinterpret_cast<bf16*>(Hid + off) = f2bf(round_bf(v) * gelu_erf(round_bf(ag[i] + bg[c])));
      });
    }
    fence_proxy_async();
    consumer_sync();
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (t * WROWS < C) mma_tile<TM>(acc[t], rg, Hid, hc / BK);
    consumer_sync();  // both warpgroups are done reading the chunk
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
    if (t * WROWS < C)
      epilogue<TM>(acc[t], t * WROWS, C, b2, [&](int, int, int off, float v, int) {
        bf16* d = reinterpret_cast<bf16*>(Xs + off);
        *d = f2bf(bf2f(*d) + round_bf(v));
      });
  fence_proxy_async();
  consumer_sync();
}

// The producer's side of feed_forward: load(map, row0, k0) for each tile in
// the order the consumers take them (w1's value and gate rows a chunk, then
// w2's C / 128 output tiles of hc / 64 k steps).
template <class Load>
__device__ __forceinline__ void produce_ff(Load& load, int w1, int w2, int C, int hc) {
  const int nk = C / BK;
  for (int j0 = 0; j0 < 4 * C; j0 += hc) {
    for (int p = 0; p < hc; p += WROWS)
      for (int half = 0; half < 2; ++half)
        for (int ks = 0; ks < nk; ++ks) load(w1, half * 4 * C + j0 + p, ks * BK);
    for (int p = 0; p < C; p += WROWS)
      for (int ks = 0; ks < hc / BK; ++ks) load(w2, p, j0 + ks * BK);
  }
}

}  // namespace resident
