// fp32 GEMM with an optional LayerNorm or GroupNorm prologue, an optional
// row map and three epilogues: the fp32 twin of gemm.cu::ds_ln_gemm (same C
// interface), for every projection of the UNet transformers when the model
// runs in float32.
//
// Replaces, at fp32 activations, the projection halves of the TPU kernels
//   dynamicscaler_tpu/ops/fused_temporal.py::_kernel      (K1), ::_ff_kernel (K4)
//   dynamicscaler_tpu/ops/fused_spatial.py::_kernel       (K2), ::_cross_kernel (K3)
// and the whole of the transformer-wrapper kernels
//   dynamicscaler_tpu/ops/fused_twrap.py::_head_kernel    (5 _head_temporal, 7 _head_spatial)
//   dynamicscaler_tpu/ops/fused_twrap.py::_tail_kernel    (6 _tail_temporal, 8 _tail_spatial)
// which compute in x.dtype, so at float32 with no rounding point anywhere.
//
// Y[M, N_out] = epilogue( prologue(X)[M, K] @ W[N, K]^T ), everything fp32,
// computed as cuda_lib.ln_gemm_plain computes it at fp32:
//   prologue (applied as each A tile is staged, so no normalised copy of X):
//     LN: a = (x - mu) * (rstd * s) + b, with mu and rstd of the row (flax
//         fast variance, var = max(0, E[x^2] - mu^2)) from a statistics pass
//         (ln_stats_f32_kernel, a warp a row) into scratch [M, 2];
//     GN: a = x * mul[s] + add[s], sample s = r / rows_per_sample;
//     each product and sum rounded on its own (__fmul_rn, __fadd_rn), as
//     PyTorch's separate operations round them.
//   row map (the frame permute of the temporal wrappers, logical row
//   r = (b*HW + hw)*F + f <-> stored row (b*F + f)*HW + hw of [B, F, H, W, C]):
//     MAP_A: A row r is read from X's stored row map(r)     (temporal head)
//     MAP_OUT: output row r is written to, and its residual read from,
//              stored row map(r)                             (temporal tail)
//   mode 0: y = acc [+ bias]
//   mode 1: y = (acc [+ bias]) + R
//   mode 2: GEGLU: a tile holds BN/2 value rows n0.. and the BN/2 gate rows
//           N/2 + n0.. of W, so value column c and gate column c + BN/2 lie in
//           the same thread's registers: y = (acc_v + b_v) * gelu_erf(acc_g + b_g),
//           N_out = N / 2 (exact erf GELU, erff).
//
// What bounds it on the H100: operations. Every UNet projection does 2MNK
// fp32 operations against 4(MK + NK + MN) bytes, 25-400 operations a byte,
// above the card's 67 TFLOP/s / 3.35 TB/s = 20 for the CUDA cores; fp32 has
// no tensor-core route (TF32 is not fp32), so the products are FFMA on the
// CUDA cores. The design is the classic register-blocked SIMT GEMM, simple
// and right first: a block of 256 threads computes a 128 x 128 tile, a thread
// an 8 x 8 register block (two 4-row groups 64 rows apart, two 4-column
// groups 64 apart);
// K in steps of 16 through two shared-memory buffers (A and B stored
// k-major, so a thread reads its 4 rows or columns as one 16-byte load), the
// next step's global loads held in registers while this step computes. The
// grid is one block a tile, column tiles fastest, so the blocks in flight
// share their A rows in L2.
// Not done yet: tensor cores (a 3xTF32 split holds fp32 accuracy), a deeper
// pipeline (cp.async or TMA), a persistent grid.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // rows a tile
constexpr int BN = 128;      // columns a tile (in GEGLU 64 value and their 64 gate columns)
constexpr int BK = 16;       // K a step
constexpr int THREADS = 256; // 16 x 16 threads
constexpr int PAD = 4;       // floats of row padding in the k-major tiles (keeps 16-byte alignment)

enum { MAP_NONE = 0, MAP_A = 1, MAP_OUT = 2 };

struct Params {
  const float* X;
  const float* W;
  const float* bias;    // [N] or null
  const float* R;       // mode 1: [M, N]
  float* Y;
  const float* stats;   // LN: [M, 2] mean, rstd
  const float* ln_w;
  const float* ln_b;
  const float* gn_mul;  // GN: [M / rows_per_sample, K]
  const float* gn_add;
  int rows_per_sample;
  int M, K, N, mode, map, map_F, map_HW;
  int n_tiles;
};

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

// LayerNorm statistics, a warp a row: (mean, rsqrt(max(0, E[x^2] - mean^2) + eps)).
__global__ void __launch_bounds__(256) ln_stats_f32_kernel(const float* __restrict__ X, int M, int K, float eps,
                                                           float* __restrict__ stats) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const float* x = X + (size_t)row * K;
  float s = 0.f, ss = 0.f;
  for (int k = lane * 4; k < K; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(x + k);
    s += v.x + v.y + v.z + v.w;
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (lane == 0) {
    const float mu = s / (float)K;
    stats[2 * (size_t)row] = mu;
    stats[2 * (size_t)row + 1] = rsqrtf(fmaxf(0.f, ss / (float)K - mu * mu) + eps);
  }
}

// The 4 values of x at columns k.. of a row after the prologue.
__device__ __forceinline__ float4 prologue4(const Params& p, float4 x, int k, float mu, float rstd, int s) {
  if (p.ln_w != nullptr) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p.ln_w + k));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p.ln_b + k));
    x.x = __fadd_rn(__fmul_rn(__fsub_rn(x.x, mu), __fmul_rn(rstd, w.x)), b.x);
    x.y = __fadd_rn(__fmul_rn(__fsub_rn(x.y, mu), __fmul_rn(rstd, w.y)), b.y);
    x.z = __fadd_rn(__fmul_rn(__fsub_rn(x.z, mu), __fmul_rn(rstd, w.z)), b.z);
    x.w = __fadd_rn(__fmul_rn(__fsub_rn(x.w, mu), __fmul_rn(rstd, w.w)), b.w);
  } else if (p.gn_mul != nullptr) {
    const size_t v0 = (size_t)s * p.K + k;
    const float4 m = __ldg(reinterpret_cast<const float4*>(p.gn_mul + v0));
    const float4 a = __ldg(reinterpret_cast<const float4*>(p.gn_add + v0));
    x.x = __fadd_rn(__fmul_rn(x.x, m.x), a.x);
    x.y = __fadd_rn(__fmul_rn(x.y, m.y), a.y);
    x.z = __fadd_rn(__fmul_rn(x.z, m.z), a.z);
    x.w = __fadd_rn(__fmul_rn(x.w, m.w), a.w);
  }
  return x;
}

__global__ void __launch_bounds__(THREADS, 2) gemm_f32_kernel(const Params p) {
  constexpr int TN = 8;       // columns a thread
  constexpr int HN = TN / 2;  // in each half of the tile
  constexpr int B_LOADS = 2;  // 16-byte loads a thread a B step
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const bool geglu = p.mode == 2;
  const int m0 = (blockIdx.x / p.n_tiles) * BM;
  const int n0 = (blockIdx.x % p.n_tiles) * (geglu ? BN / 2 : BN);  // first output column

  // the rows and columns this thread stages: row (tid / 4) + 64 i, k (tid % 4) * 4
  const int lr = tid >> 2, kc = (tid & 3) * 4;
  const float* arow[2];
  float mu[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
  int samp[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + lr + 64 * i;
    arow[i] = nullptr;
    if (m < p.M) {
      const size_t src = p.map == MAP_A ? frame_major_row(m, p.map_F, p.map_HW) : (size_t)m;
      arow[i] = p.X + src * p.K + kc;
      if (p.stats != nullptr) {
        mu[i] = p.stats[2 * (size_t)m];
        rstd[i] = p.stats[2 * (size_t)m + 1];
      }
      if (p.gn_mul != nullptr) samp[i] = m / p.rows_per_sample;
    }
  }
  const float* brow[B_LOADS];
#pragma unroll
  for (int i = 0; i < B_LOADS; ++i) {
    const int r = lr + 64 * i;  // row of the B tile
    int n;
    bool ok;
    if (geglu) {
      const int j = r % (BN / 2);
      n = (r / (BN / 2)) * (p.N / 2) + n0 + j;
      ok = n0 + j < p.N / 2;
    } else {
      n = n0 + r;
      ok = n < p.N;
    }
    brow[i] = ok ? p.W + (size_t)n * p.K + kc : nullptr;
  }

  float4 ra[2], rb[B_LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ra[i] = arow[i] ? prologue4(p, *reinterpret_cast<const float4*>(arow[i] + k0), k0 + kc, mu[i], rstd[i], samp[i])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i)
      rb[i] = brow[i] ? __ldg(reinterpret_cast<const float4*>(brow[i] + k0)) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      As[buf][kc + 0][lr + 64 * i] = ra[i].x;
      As[buf][kc + 1][lr + 64 * i] = ra[i].y;
      As[buf][kc + 2][lr + 64 * i] = ra[i].z;
      As[buf][kc + 3][lr + 64 * i] = ra[i].w;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      Bs[buf][kc + 0][lr + 64 * i] = rb[i].x;
      Bs[buf][kc + 1][lr + 64 * i] = rb[i].y;
      Bs[buf][kc + 2][lr + 64 * i] = rb[i].z;
      Bs[buf][kc + 3][lr + 64 * i] = rb[i].w;
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int steps = p.K / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    if (st + 1 < steps) load((st + 1) * BK);  // in flight while this step computes
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][BN / 2 + tx * 4]);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[HN] = b1.x; b[HN + 1] = b1.y; b[HN + 2] = b1.z; b[HN + 3] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (st + 1 < steps) {
      store(buf ^ 1);  // the other buffer: its readers finished before the last barrier
      __syncthreads();
    }
  }

  // ---- epilogue: rows ty*4 + i and 64 + ty*4 + i; column halves h ----
  const int n_out = geglu ? p.N / 2 : p.N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= p.M) continue;
    const size_t row = p.map == MAP_OUT ? frame_major_row(m, p.map_F, p.map_HW) : (size_t)m;
    float* y = p.Y + row * n_out;
    if (geglu) {
      const int c = n0 + tx * HN;
      if (c >= n_out) continue;
      float v[HN];
#pragma unroll
      for (int j = 0; j < HN; ++j) {
        float val = acc[i][j], gate = acc[i][HN + j];
        if (p.bias) {
          val += __ldg(p.bias + c + j);
          gate += __ldg(p.bias + p.N / 2 + c + j);
        }
        v[j] = val * gelu_erf(gate);
      }
      *reinterpret_cast<float4*>(y + c) = make_float4(v[0], v[1], v[2], v[3]);
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + h * (BN / 2) + tx * HN;
      if (c >= n_out) continue;
      float v[HN];
#pragma unroll
      for (int j = 0; j < HN; ++j) {
        v[j] = acc[i][h * HN + j];
        if (p.bias) v[j] += __ldg(p.bias + c + j);
        if (p.mode == 1) v[j] += __ldg(p.R + row * n_out + c + j);
      }
      *reinterpret_cast<float4*>(y + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

cudaError_t launch(Params p, cudaStream_t stream) {
  const int n_out = p.mode == 2 ? p.N / 2 : p.N;
  const int cols = p.mode == 2 ? BN / 2 : BN;
  p.n_tiles = (n_out + cols - 1) / cols;
  const long long tiles = (long long)p.n_tiles * ((p.M + BM - 1) / BM);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  gemm_f32_kernel<<<(unsigned)tiles, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ds_ln_gemm's interface and combinations (see gemm.cu), at fp32: X, W, R, Y
// fp32; every pointer 16-byte aligned and row-contiguous; K % 16 == 0, N % 8
// == 0. block_n 128 and stages 2 (cuda_lib.GEMM_F32_TILE). scratch:
// fp32 [M, 2] for the LN statistics (LN prologue only; null otherwise).
extern "C" int ds_ln_gemm_f32(const void* X, int M, int K, const void* ln_w, const void* ln_b, float eps,
                              const void* gn_mul, const void* gn_add, int rows_per_sample, int map_F, int map_HW,
                              const void* W, int N, const void* bias, const void* R, void* Y, int mode,
                              void* scratch, int block_n, int stages, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  const bool ln = ln_w != nullptr, gn = gn_mul != nullptr, map = map_F > 0;
  const int map_kind = !map ? MAP_NONE : gn ? MAP_A : MAP_OUT;
  if (M <= 0 || K <= 0 || K % BK || N <= 0 || N % 8 || mode < 0 || mode > 2) return (int)bad;
  if (block_n != BN || stages != 2) return (int)bad;
  if (ln && (scratch == nullptr || ln_b == nullptr)) return (int)bad;
  if (ln && (gn || map)) return (int)bad;
  if (gn && (gn_add == nullptr || mode != 0 || rows_per_sample <= 0 || M % rows_per_sample)) return (int)bad;
  if (map && (map_HW <= 0 || M % (map_F * map_HW))) return (int)bad;
  if (map_kind == MAP_A && rows_per_sample % (map_F * map_HW)) return (int)bad;
  if (map_kind == MAP_OUT && mode != 1) return (int)bad;
  if (mode == 1 && R == nullptr) return (int)bad;
  if (mode == 2 && (N / 2) % 8) return (int)bad;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{};
  p.X = static_cast<const float*>(X);
  p.W = static_cast<const float*>(W);
  p.bias = static_cast<const float*>(bias);
  p.R = static_cast<const float*>(R);
  p.Y = static_cast<float*>(Y);
  p.M = M; p.K = K; p.N = N; p.mode = mode; p.map = map_kind; p.map_F = map_F; p.map_HW = map_HW;
  if (ln) {
    float* stats = static_cast<float*>(scratch);
    ln_stats_f32_kernel<<<(M + 7) / 8, 256, 0, s>>>(p.X, M, K, eps, stats);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    p.stats = stats;
    p.ln_w = static_cast<const float*>(ln_w);
    p.ln_b = static_cast<const float*>(ln_b);
  }
  if (gn) {
    p.gn_mul = static_cast<const float*>(gn_mul);
    p.gn_add = static_cast<const float*>(gn_add);
    p.rows_per_sample = rows_per_sample;
  }
  return (int)launch(p, s);
}
