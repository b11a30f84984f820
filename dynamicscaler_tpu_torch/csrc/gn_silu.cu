// GroupNorm apply [-> SiLU] with folded per-sample statistics, bf16 in and
// out (ds_gn_silu), and the statistics themselves (ds_gn_stats).
//
// ds_gn_silu replaces dynamicscaler_tpu/ops/fused_twrap.py::_gn_silu_kernel
// (kernel 9, launched by _gn_silu_call): y = bf16(silu(fp32(x) * mul[b] +
// add[b])), or without the SiLU for the VAE attention norm (act = 0). x is
// [B, M, C] with the channel last; mul/add are the fp32 [B, C] vectors that
// ds_gn_stats folds. The product and the sum are rounded separately
// (__fmul_rn, __fadd_rn) and the SiLU is h * (1 / (1 + exp(-h))) with the
// precise expf, as the plain version computes them, so the two differ by at
// most one bf16 rounding.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (4 bytes) against ~5 fp32 operations, far below the card's ~295
// operations per byte, so the bound is 2 * numel * 2 bytes / 3.35 TB/s (about
// 0.03 ms for the 52 MB level-1 ResBlock input at batch 2; 0.09 ms for a 151 MB
// VAE-decode tensor of one 512x1152 frame at C = 128). The design serves the
// memory system and nothing else: every thread moves 8 bf16 (16 bytes) per
// load and store, neighbouring threads on neighbouring addresses, in a
// grid-stride loop; gridDim.y is the sample, so a block's mul/add vectors are
// one sample's and are staged once in shared memory. Offsets are 64-bit.
//
// ds_gn_stats is the statistics pass that the JAX package leaves to XLA
// (dynamicscaler_tpu/ops/fused_twrap.py::group_norm_fold), the reduction
// under kernels 5, 7, 9, 12 and 13: for x [B, M, C] (bf16 or fp32; M every
// axis between the first and the last), per (sample, group of C / G
// contiguous channels) the fp32 sums of x and x^2, folded into (mul, add)
// [B, C] fp32 by the JAX formula: mean, the fast variance clamped at 0,
// rsqrt(var + eps), mul = rstd * scale, add = bias - mean * mul. Bound by
// reading x once (13 MB a sample at the batch-8 level-1 ResBlocks: about 0.06
// ms for the batch at 3.35 TB/s). B is as small as 8 there, and at the deep
// levels C is wide and M short, so M is split over blocks of 32 rows a
// thread: a block of lanes x (C / 8) threads gives each thread one fixed
// 8-channel chunk (one 16-byte load a row in bf16) and every lanes-th row
// of its split, so its fp32 sums stay in 16 registers and its loads are
// few enough that latency does not bound it; the block adds its row lanes in a fixed
// order into per-channel partials [splits, B, 2, C], and a second small
// launch (a block a (group, sample)) adds the splits and the group's
// channels, again in a fixed order, and folds. No float atomics anywhere:
// two runs agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int TARGET_BLOCKS = 132 * 8;  // ~8 blocks per SM across all samples
constexpr int STATS_THREADS = 256;      // threads a statistics block aims at (lanes x C / 8)
constexpr int FOLD_THREADS = 128;       // threads of a fold block (one a (group, sample))

template <bool ACT>
__global__ void __launch_bounds__(THREADS)
gn_silu_kernel(const bf16* __restrict__ X, long long per_sample, int C,
               const float* __restrict__ mul, const float* __restrict__ add,
               bf16* __restrict__ Y) {
  extern __shared__ float s_vec[];  // mul [C] then add [C] of this block's sample
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < C; i += THREADS) {
    s_vec[i] = mul[(size_t)b * C + i];
    s_vec[C + i] = add[(size_t)b * C + i];
  }
  __syncthreads();

  const uint4* xb = reinterpret_cast<const uint4*>(X + (size_t)b * per_sample);
  uint4* yb = reinterpret_cast<uint4*>(Y + (size_t)b * per_sample);
  const long long chunks = per_sample / 8;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < chunks;
       i += (long long)gridDim.x * THREADS) {
    uint4 v = xb[i];
    bf16* e = reinterpret_cast<bf16*>(&v);
    const int c0 = (int)((i * 8) % C);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float h = __fadd_rn(__fmul_rn(__bfloat162float(e[q]), s_vec[c0 + q]), s_vec[C + c0 + q]);
      if (ACT) h = __fmul_rn(h, 1.0f / (1.0f + expf(-h)));
      e[q] = __float2bfloat16(h);
    }
    yb[i] = v;
  }
}


__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// 8 consecutive values of x as fp32
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 t = __bfloat1622float2(h[q]);
    f[2 * q] = t.x;
    f[2 * q + 1] = t.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Stage 1: block (split, b) sums rows [split * rows, (split + 1) * rows) of
// sample b into part[split, b, 0 | 1, :] (sum | sum of squares per channel).
// blockDim.x = lanes * (C / 8); thread t owns channels 8 (t % (C / 8)) .. + 7
// and rows t / (C / 8), + lanes, ...
template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ X, long long M, int C, long long rows,
                                  float* __restrict__ part) {
  extern __shared__ float red[];  // [2][lanes][C]
  const int per_row = C / 8;
  const int lanes = blockDim.x / per_row;
  const int u = threadIdx.x % per_row, rl = threadIdx.x / per_row;
  const int b = blockIdx.y;
  const long long r0 = blockIdx.x * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  const T* xb = X + (size_t)b * M * C + 8 * u;
  float s[8], ss[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = ss[e] = 0.f;
#pragma unroll 4
  for (long long r = r0 + rl; r < r1; r += lanes) {
    float v[8];
    load8(xb + (size_t)r * C, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] += v[e];
      ss[e] += v[e] * v[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[rl * C + 8 * u + e] = s[e];
    red[(lanes + rl) * C + 8 * u + e] = ss[e];
  }
  __syncthreads();
  float* out = part + ((size_t)blockIdx.x * gridDim.y + b) * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    const int which = c / C, ch = c - which * C;
    float acc = 0.f;
    for (int i = 0; i < lanes; ++i) acc += red[(which * lanes + i) * C + ch];
    out[c] = acc;
  }
}

// Stage 2: block (g, b): the group's sums over the splits and its channels
// in a fixed order (a strided sum per thread, then a fixed shuffle tree and
// the warps in order), then (mul, add) of its channels.
template <typename V>
__global__ void __launch_bounds__(FOLD_THREADS)
gn_fold_kernel(const float* __restrict__ part, int splits, int C, int G, long long M,
               const V* __restrict__ scale, const V* __restrict__ bias, float eps,
               float* __restrict__ mul, float* __restrict__ add) {
  __shared__ float red[2][FOLD_THREADS / 32];
  __shared__ float stat[2];
  const int g = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const int cg = C / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < splits * cg; i += FOLD_THREADS) {
    const int sp = i / cg;
    const float* p = part + ((size_t)sp * B + b) * 2 * C + g * cg + (i - sp * cg);
    s += p[0];
    ss += p[C];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float S = 0.f, SS = 0.f;
    for (int w = 0; w < FOLD_THREADS / 32; ++w) {
      S += red[0][w];
      SS += red[1][w];
    }
    const float n = (float)(M * cg);
    const float mean = S / n;
    stat[0] = mean;
    stat[1] = rsqrtf(fmaxf(0.f, SS / n - mean * mean) + eps);
  }
  __syncthreads();
  for (int c = g * cg + threadIdx.x; c < (g + 1) * cg; c += FOLD_THREADS) {
    const float m = stat[1] * to_f32(scale[c]);
    mul[(size_t)b * C + c] = m;
    add[(size_t)b * C + c] = to_f32(bias[c]) - stat[0] * m;
  }
}

}  // namespace

// x, y: [B, per_sample] bf16, 16-byte aligned, per_sample = M * C; C % 8 == 0;
// mul, add: [B, C] fp32 (checked in Python before the call).
extern "C" int ds_gn_silu(const void* X, int B, long long per_sample, int C, const void* mul,
                          const void* add, int act, void* Y, void* stream) {
  if (B <= 0 || C <= 0 || C % 8 || per_sample % C) return (int)cudaErrorInvalidValue;
  const long long chunks = per_sample / 8;
  long long gx = (chunks + THREADS - 1) / THREADS;
  const long long cap = TARGET_BLOCKS / B > 0 ? TARGET_BLOCKS / B : 1;
  if (gx > cap) gx = cap;
  dim3 grid((unsigned)gx, (unsigned)B);
  const size_t smem = 2 * (size_t)C * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(X);
  const float* m = static_cast<const float*>(mul);
  const float* a = static_cast<const float*>(add);
  bf16* y = static_cast<bf16*>(Y);
  if (act) gn_silu_kernel<true><<<grid, THREADS, smem, s>>>(x, per_sample, C, m, a, y);
  else gn_silu_kernel<false><<<grid, THREADS, smem, s>>>(x, per_sample, C, m, a, y);
  return (int)cudaGetLastError();
}

// x: [B, M, C] bf16 (is_f32 = 0) or fp32 (is_f32 = 1), 16-byte aligned;
// C % 8 == 0, C % G == 0, C <= 6144; scale, bias: [C] bf16 (vec_f32 = 0) or
// fp32 (vec_f32 = 1); part: fp32 [splits, B, 2, C] scratch (the wrapper
// reckons splits: fused_twrap.gn_stats_splits); mul, add: [B, C] fp32 out.
extern "C" int ds_gn_stats(const void* X, int is_f32, int B, long long M, int C, int G, int splits,
                           const void* scale, const void* bias, int vec_f32, float eps, void* part, void* mul,
                           void* add, void* stream) {
  if (B <= 0 || M <= 0 || C <= 0 || C % 8 || C > 6144 || G <= 0 || C % G || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int per_row = C / 8;
  const int lanes = per_row < STATS_THREADS ? STATS_THREADS / per_row : 1;
  const long long rows = (M + splits - 1) / splits;
  dim3 grid((unsigned)splits, (unsigned)B);
  const size_t smem = 2 * (size_t)lanes * C * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (is_f32)
    gn_partial_kernel<float><<<grid, lanes * per_row, smem, s>>>(static_cast<const float*>(X), M, C, rows, p);
  else
    gn_partial_kernel<bf16><<<grid, lanes * per_row, smem, s>>>(static_cast<const bf16*>(X), M, C, rows, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  float* mu = static_cast<float*>(mul);
  float* ad = static_cast<float*>(add);
  if (vec_f32)
    gn_fold_kernel<float><<<dim3(G, B), FOLD_THREADS, 0, s>>>(p, splits, C, G, M, static_cast<const float*>(scale),
                                                              static_cast<const float*>(bias), eps, mu, ad);
  else
    gn_fold_kernel<bf16><<<dim3(G, B), FOLD_THREADS, 0, s>>>(p, splits, C, G, M, static_cast<const bf16*>(scale),
                                                             static_cast<const bf16*>(bias), eps, mu, ad);
  return (int)cudaGetLastError();
}
