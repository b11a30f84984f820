// bf16 tiled GEMM with an optional LayerNorm prologue and three epilogues,
// for the projections of the UNet transformer sub-blocks.
//
// Replaces the projection halves of the TPU kernels
//   dynamicscaler_tpu/ops/fused_temporal.py::_kernel     (K1: LN -> QKV, out-proj + residual)
//   dynamicscaler_tpu/ops/fused_temporal.py::_ff_kernel  (K4: LN -> GEGLU, FF2 + residual)
//   dynamicscaler_tpu/ops/fused_spatial.py::_kernel      (K2: LN -> QKV, out-proj + residual)
//   dynamicscaler_tpu/ops/fused_spatial.py::_cross_kernel(K3: LN -> Q, context KV, out-proj)
//
// Y[M, N_out] = epilogue( A[M, K] @ W[N, K]^T ),  W in torch Linear layout.
//   A = LN(X) when ln_w is given (flax fast-variance statistics in fp32:
//       var = max(0, E[x^2] - mu^2); h = (x - mu) * (rsqrt(var + eps) * s) + b,
//       rounded to bf16 before the product, as the TPU kernels do).
//   mode 0: y = bf16(acc [+ bias])
//   mode 1: y = bf16(bf16(acc + bias) + R)                (out-proj / FF2 + residual)
//   mode 2: GEGLU. Each block loads 32 value rows j.. and the 32 gate rows
//           N/2 + j.. of W into one 64-row tile, so value and gate of one
//           output column sit in the same accumulator tile:
//           a = bf16(acc + bias); y = bf16(f32(a_val) * gelu_erf(f32(a_gate))),
//           N_out = N / 2.
//
// What bounds it on the H100: these products are compute-bound at the UNet
// shapes (M up to 2*16*2560 = 81920 tokens, K and N 320..5120), so the work
// is the tensor cores'. This first version uses WMMA bf16 fragments with
// fp32 accumulation (mma.sync underneath), 64x64x32 block tiles, 4 warps of
// 32x32. The LayerNorm is applied while the A tile is staged in shared
// memory, so the normalised activation never goes to device memory; the row
// statistics are computed by each block from its 64 rows (they are L2 hits
// for all but the first block of a row). No cp.async pipelining, no wgmma
// and no TMA yet: those are the next steps for speed.

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

__device__ __forceinline__ float gelu_erf(float g) {
  return g * 0.5f * (1.0f + erff(g * 0.70710678118654752f));
}

template <int MODE, bool LN>
__global__ void __launch_bounds__(THREADS)
ln_gemm_kernel(const bf16* __restrict__ X, int M, int K,
               const float* __restrict__ ln_w, const float* __restrict__ ln_b, float eps,
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

  if (LN) {
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
        a = *reinterpret_cast<const uint4*>(X + (size_t)m * K + k0 + col);
        if (LN) {
          bf16* e = reinterpret_cast<bf16*>(&a);
          const float mu = s_mu[row];
          const float rstd = s_rstd[row];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int k = k0 + col + q;
            const float h = (__bfloat162float(e[q]) - mu) * (rstd * ln_w[k]) + ln_b[k];
            e[q] = __float2bfloat16(h);
          }
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
    const int n = n0 + c;
    float y;
    if (MODE == 2) {
      const float av = __bfloat162float(__float2bfloat16(Cs[r * LDC + c] + bias[n]));
      const float ag = __bfloat162float(__float2bfloat16(Cs[r * LDC + c + BN / 2] + bias[N / 2 + n]));
      y = av * gelu_erf(ag);
    } else if (MODE == 1) {
      const float o = __bfloat162float(__float2bfloat16(Cs[r * LDC + c] + bias[n]));
      y = o + __bfloat162float(R[(size_t)m * n_out + n]);
    } else {
      y = Cs[r * LDC + c] + (bias ? bias[n] : 0.f);
    }
    Y[(size_t)m * n_out + n] = __float2bfloat16(y);
  }
}

template <int MODE, bool LN>
void launch(const bf16* X, int M, int K, const float* lw, const float* lb, float eps,
            const bf16* W, int N, const float* bias, const bf16* R, bf16* Y,
            cudaStream_t stream) {
  const int n_out_tile = (MODE == 2) ? BN / 2 : BN;
  const int n_out = (MODE == 2) ? N / 2 : N;
  dim3 grid(n_out / n_out_tile, (M + BM - 1) / BM);
  ln_gemm_kernel<MODE, LN><<<grid, THREADS, 0, stream>>>(X, M, K, lw, lb, eps, W, N, bias, R, Y);
}

}  // namespace

// Shapes the caller guarantees (checked in Python before the call):
// K % 32 == 0; N % 64 == 0; all pointers 16-byte aligned and row-contiguous.
extern "C" int ds_ln_gemm(const void* X, int M, int K, const void* ln_w, const void* ln_b,
                          float eps, const void* W, int N, const void* bias,
                          const void* R, void* Y, int mode, void* stream) {
  const bf16* x = static_cast<const bf16*>(X);
  const bf16* w = static_cast<const bf16*>(W);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  const float* b = static_cast<const float*>(bias);
  const bf16* r = static_cast<const bf16*>(R);
  bf16* y = static_cast<bf16*>(Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = lw != nullptr;
  if (mode == 0) {
    if (ln) launch<0, true>(x, M, K, lw, lb, eps, w, N, b, r, y, s);
    else launch<0, false>(x, M, K, lw, lb, eps, w, N, b, r, y, s);
  } else if (mode == 1) {
    if (ln) launch<1, true>(x, M, K, lw, lb, eps, w, N, b, r, y, s);
    else launch<1, false>(x, M, K, lw, lb, eps, w, N, b, r, y, s);
  } else if (mode == 2) {
    if (ln) launch<2, true>(x, M, K, lw, lb, eps, w, N, b, r, y, s);
    else launch<2, false>(x, M, K, lw, lb, eps, w, N, b, r, y, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
