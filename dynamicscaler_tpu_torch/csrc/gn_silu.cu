// GroupNorm apply [-> SiLU] with folded per-sample statistics, bf16 in and out.
//
// Replaces dynamicscaler_tpu/ops/fused_twrap.py::_gn_silu_kernel (kernel 9,
// launched by _gn_silu_call): y = bf16(silu(fp32(x) * mul[b] + add[b])), or
// without the SiLU for the VAE attention norm (act = 0). x is [B, M, C] with
// the channel last; mul/add are the fp32 [B, C] vectors of
// ops/fused_twrap.py::group_norm_fold (the reduction stays a plain PyTorch
// pass, as the JAX package leaves it to XLA). The product and the sum are
// rounded separately (__fmul_rn, __fadd_rn) and the SiLU is h * (1 / (1 +
// exp(-h))) with the precise expf, as the plain version computes them, so the
// two differ by at most one bf16 rounding.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int TARGET_BLOCKS = 132 * 8;  // ~8 blocks per SM across all samples

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
