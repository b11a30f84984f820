// Device routines of the whole-spatial kernels (mega.cu: kernels 11 and
// 13, and only those: kernels 10 and 12 in block.cu run on hopper.cuh's TMA
// and wgmma, and this header goes when kernels 11 and 13 follow them):
// an 8-warp block keeps a tile of TM tokens in shared memory and runs every
// projection of the block on it as a sequence of column chunks.
//
// gemm_cols: Y[TM, n] = A[TM, K] @ W[n, K]^T in column chunks of 128 (TM =
// 64) or 256 (TM = 32, 16) output columns; each of the 8 warps owns 32 rows
// (16 at TM = 16) x 32 columns of a chunk. A is resident in shared memory
// (bf16, any pitch that is a multiple of 8); the weight rows stream from
// device memory (L2 after the first blocks) through a cp.async ring of
// NCOL x BK bf16 tiles that runs across the chunks, so the next chunk's
// weights load while this one computes. The ring is two stages of BK = 64
// (TM = 64 and the narrower tiles up to C = 512) or of BK = 32 (the wide
// tiles, C > 512, whose activation tiles leave less room; 40 KB instead of
// 72 KB). The products are mma.sync m16n8k16 (bf16 in, fp32 accumulation)
// on fragments loaded with ldmatrix; each thread hands its accumulator
// elements straight to an epilogue functor epi(row, col, value), so the
// callers fuse bias, rounding, residual adds and GEGLU into it.
//
// layer_norm_rows: flax LayerNorm numerics (fp32 fast-variance statistics,
// var = max(0, E[x^2] - mu^2); y = (x - mu) * (rsqrt(var + eps) * s) + b,
// rounded to bf16), one warp per row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace dstile {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps

// the chunk shape of a TM-row tile: 8 warps of MF 16-row fragments x 32
// columns, and the weight ring of k depth BK (two stages: the next tile
// loads while this one computes; deeper rings measured no faster, these
// products are bound by issuing the fragment loads and MMAs, not by the
// weight stream's latency)
template <int TM, int BK_ = 64>
struct Tile {
  static_assert(TM == 16 || TM == 32 || TM == 64, "TM is 16, 32 or 64");
  static_assert(BK_ == 32 || BK_ == 64, "BK is 32 or 64");
  static constexpr int MF = TM < 32 ? 1 : 2;     // 16-row fragments per warp
  static constexpr int WR = TM / (16 * MF);      // warps along the rows; warp w -> rows 16 MF (w % WR)
  static constexpr int NCOL = 8 / WR * 32;       // output columns per chunk: 128 (TM = 64), else 256
  static constexpr int BK = BK_;                 // k per pipeline stage
  static constexpr int LDB = BK + 8;             // bf16 pitch of a staged weight tile (144 or 80 bytes)
  static constexpr int STAGE = NCOL * LDB;       // bf16 elements per weight stage
  static constexpr int STAGES = 2;
  static constexpr int RING = STAGES * STAGE * 2;  // bytes
};

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float round_bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

__device__ __forceinline__ float gelu_erf(float g) {
  return g * 0.5f * (1.0f + erff(g * 0.70710678118654752f));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
// 16 bytes global -> shared, zero-filled when !ok (the source is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// four 8x8 bf16 matrices from shared memory (rows addressed per lane), plain or transposed
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c[4] += a[4] (16x16 bf16, row) @ b[2] (16x8 bf16, col), fp32. Thread
// (g = lane / 4, t = lane % 4) holds c at rows g, g + 8 and columns 2t, 2t + 1.
__device__ __forceinline__ void mma16816(float* c, const unsigned* a, const unsigned* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
               "{%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows [0, n) of a NCOL x BK weight stage (BK / 8 chunks of 16 bytes per row)
template <class G>
__device__ __forceinline__ void load_b(bf16* Bs, const bf16* W, int ldw, int k0, int n) {
  constexpr int CPR = G::BK / 8;
  for (int i = threadIdx.x; i < G::NCOL * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    if (r < n) cp_async16(Bs + r * G::LDB + c, W + (size_t)r * ldw + k0 + c);
  }
}

// Y[TM, 0:n] = A[TM, 0:K] @ W[0:n, 0:K]^T, then epi(r, c, y) for every
// element, as column chunks of G::NCOL (G a Tile). The weight tiles of all
// the chunks form one stream through the ring (the next chunk's tiles load
// while this one computes); each warp's (16 MF) x 32 accumulator goes to the
// epilogue straight from its registers when its chunk's last k stage is
// done. A must not be a destination of epi. K % G::BK == 0, n % 32 == 0; W
// rows 16-byte aligned (ldw % 8 == 0); A rows 16-byte aligned. Ends
// synchronised.
template <class G, class Epi>
__device__ void gemm_cols(const bf16* A, int lda, int K, const bf16* W, int ldw, int n, unsigned char* ring,
                          Epi epi) {
  constexpr int MF = G::MF, BK = G::BK, LDB = G::LDB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = (warp % G::WR) * 16 * MF;
  const int wc = (warp / G::WR) * 32;
  const int nk = K / BK;
  const int total = (n + G::NCOL - 1) / G::NCOL * nk;
  bf16* Bs = reinterpret_cast<bf16*>(ring);
  auto issue = [&](int i) {  // tile i: chunk i / nk, k stage i % nk, into slot i % STAGES
    if (i < total) {
      const int c0 = i / nk * G::NCOL;
      load_b<G>(Bs + (i % G::STAGES) * G::STAGE, W + (size_t)c0 * ldw, ldw, (i % nk) * BK,
                min(G::NCOL, n - c0));
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) issue(s);

  float acc[MF][4][4];  // MF row fragments x 4 column fragments of 16 x 8
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  for (int i = 0; i < total; ++i) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1, whose slot the next issue refills
    issue(i + G::STAGES - 1);
    const int ks = i % nk;
    const int c0 = i / nk * G::NCOL;
    const bf16* cur = Bs + (i % G::STAGES) * G::STAGE;
    if (c0 + wc < n) {  // this warp's 32 columns are in the chunk (n % 32 == 0)
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned a[MF][4];
#pragma unroll
        for (int m = 0; m < MF; ++m)
          ldsm_x4(a[m], A + (wr + m * 16 + (lane & 15)) * lda + ks * BK + kk + (lane >> 4) * 8);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          unsigned b[4];
          ldsm_x4(b, cur + (wc + nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDB + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int m = 0; m < MF; ++m) {
            mma16816(acc[m][2 * nb], a[m], b);
            mma16816(acc[m][2 * nb + 1], a[m], b + 2);
          }
        }
      }
      if (ks == nk - 1) {
#pragma unroll
        for (int m = 0; m < MF; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              epi(wr + m * 16 + (lane >> 2) + (e >> 1) * 8, c0 + wc + j * 8 + 2 * (lane & 3) + (e & 1),
                  acc[m][j][e]);
              acc[m][j][e] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Dst[r, :C] = LN(Src[r, :C]) for r < TM (bf16 in shared memory). Ends synchronised.
template <int TM>
__device__ void layer_norm_rows(const bf16* Src, int lds, bf16* Dst, int ldd, int C,
                                const float* __restrict__ s, const float* __restrict__ b, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < TM; r += THREADS / 32) {
    const bf16* xr = Src + r * lds;
    float sum = 0.f, ss = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float v = bf2f(xr[k]);
      sum += v;
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float mu = sum / (float)C;
    const float rstd = rsqrtf(fmaxf(0.f, ss / (float)C - mu * mu) + eps);
    for (int k = lane; k < C; k += 32) Dst[r * ldd + k] = f2bf((bf2f(xr[k]) - mu) * (rstd * s[k]) + b[k]);
  }
  __syncthreads();
}

}  // namespace dstile
