// Attention cores of the UNet transformer sub-blocks at fp32, head dim 64:
// the fp32 twins of attention.cu's ds_temporal_attention and
// ds_flash_attention (same C interfaces), for a model run in float32.
//
// The TPU kernels they replace compute in x.dtype, so at float32 nothing is
// rounded between the logits and the output:
//   dynamicscaler_tpu/ops/fused_temporal.py::_kernel       (K1, its attention)
//   dynamicscaler_tpu/ops/fused_spatial.py::_kernel        (K2, N up to 2560)
//   dynamicscaler_tpu/ops/fused_spatial.py::_cross_kernel  (K3, 77 text + 16 image keys)
// Both kernels multiply and accumulate in fp32 on the CUDA cores (FFMA; TF32
// is not fp32) and take the exponentials with expf.
//
// ds_temporal_attention_f32: F frame tokens per (row, head), 2 <= F <= 128,
// 128 % F == 0. A block takes 128 tokens (128 / F whole rows) of one head:
// their keys and values staged in shared memory (2 x 128 x 68 floats), a
// thread a query token with its q in registers, two passes over its row's
// keys (the largest logit, then the exponentials, their sum and the
// weighted values), the sum divided out at the end. What bounds it: bytes.
// At F = 16 a token does 16 x 64 x 6 operations against 4 x 64 x 4 bytes
// read and written, about 6 operations a byte, far below the card's 20 for
// fp32; a quarter-warp's 8 threads read one key at a time (one row), so the
// shared-memory reads are broadcasts where F >= 8. (Kernels 10 and 12 run
// their own F-frame attention, block_f32.cu, two threads a query, within
// the register budget of their GEMM phases.)
//
// ds_flash_attention_f32: q rows with a pitch, up to two key segments each
// with its own softmax, the normalised outputs summed (the i2v dual
// text/image cross-attention). A block of 256 threads takes 64 query rows of
// one (sample, head) (attention_f32.cuh::tile_flash: q stored k-major in
// shared memory, the segment's keys streamed in tiles of 64 and an online
// softmax). What bounds it: operations at the self-attention's N = 2560 (4
// N^2 64 a (sample, head): 1.07 TFLOP a batch-8 call, 16 ms at 67 TFLOP/s),
// bytes at N <= 640 and in the cross-attention.
// Not done yet (later work): a deeper K/V pipeline, tensor cores through a
// 3xTF32 split, a persistent grid.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"

namespace {

using namespace attn_f32;

// ---------------------------------------------------------------------------
// temporal: 128 tokens of one head a block, a thread a query token
// ---------------------------------------------------------------------------

constexpr int T_TOKENS = 128;
constexpr int T_PITCH = D + 4;  // floats of a staged row
constexpr int T_SMEM = 2 * T_TOKENS * T_PITCH * 4;

__device__ __forceinline__ float dot64(const float (&q)[D], const float* k) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(k + d);
    s = fmaf(q[d], v.x, s);
    s = fmaf(q[d + 1], v.y, s);
    s = fmaf(q[d + 2], v.z, s);
    s = fmaf(q[d + 3], v.w, s);
  }
  return s;
}

__global__ void __launch_bounds__(T_TOKENS)
temporal_attn_f32_kernel(const float* __restrict__ qkv, long long T, int F, int C, float scale,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) float t_smem[];
  float* ks = t_smem;
  float* vs = t_smem + T_TOKENS * T_PITCH;
  const int h = blockIdx.y;
  const long long tok0 = (long long)blockIdx.x * T_TOKENS;
  const size_t ld = 3 * (size_t)C;
  for (int i = threadIdx.x; i < 2 * T_TOKENS * (D / 4); i += T_TOKENS) {
    const int which = i / (T_TOKENS * (D / 4));  // 0 keys, 1 values
    const int r = (i / (D / 4)) % T_TOKENS, c = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tok0 + r < T) v = *reinterpret_cast<const float4*>(qkv + (size_t)(tok0 + r) * ld + (1 + which) * C + h * D + c);
    *reinterpret_cast<float4*>(t_smem + (which * T_TOKENS + r) * T_PITCH + c) = v;
  }
  const int r = threadIdx.x;
  const long long tok = tok0 + r;
  float q[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tok < T) v = *reinterpret_cast<const float4*>(qkv + (size_t)tok * ld + h * D + d);
    q[d] = v.x; q[d + 1] = v.y; q[d + 2] = v.z; q[d + 3] = v.w;
  }
  __syncthreads();
  if (tok >= T) return;
  const int kb = (r / F) * F;  // the row's first token in the block
  float m = -INFINITY;
  for (int j = 0; j < F; ++j) m = fmaxf(m, dot64(q, ks + (kb + j) * T_PITCH) * scale);
  float o[D], l = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
  for (int j = 0; j < F; ++j) {
    const float p = expf(dot64(q, ks + (kb + j) * T_PITCH) * scale - m);
    l += p;
    const float* v = vs + (kb + j) * T_PITCH;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 w = *reinterpret_cast<const float4*>(v + d);
      o[d] = fmaf(p, w.x, o[d]);
      o[d + 1] = fmaf(p, w.y, o[d + 1]);
      o[d + 2] = fmaf(p, w.z, o[d + 2]);
      o[d + 3] = fmaf(p, w.w, o[d + 3]);
    }
  }
  float* y = out + (size_t)tok * C + h * D;
#pragma unroll
  for (int d = 0; d < D; d += 4)
    *reinterpret_cast<float4*>(y + d) = make_float4(o[d] / l, o[d + 1] / l, o[d + 2] / l, o[d + 3] / l);
}

// ---------------------------------------------------------------------------
// flash: 64 query rows of one (sample, head) a block (attention_f32.cuh)
// ---------------------------------------------------------------------------

constexpr int FQ = 64;  // query rows a block

struct FlashParams {
  const float* q;
  const float* k[2];
  const float* v[2];
  int ldq, ld[2], len[2];
  int B, Nq, heads, nseg, q_tiles;
  float scale;
  float* out;
  int ldo;
};

__global__ void __launch_bounds__(NT)
flash_attn_f32_kernel(const FlashParams p) {
  extern __shared__ __align__(16) float f_smem[];
  const int tile = blockIdx.x;
  const int q0 = (tile % p.q_tiles) * FQ;
  const int bh = tile / p.q_tiles;
  const int h = bh % p.heads, b = bh / p.heads;
  const size_t b0 = (size_t)b * p.len[0] * p.ld[0] + h * D, b1 = (size_t)b * p.len[1] * p.ld[1] + h * D;
  const size_t row0 = (size_t)b * p.Nq + q0;
  tile_flash(f_smem, p.q + row0 * p.ldq + h * D, p.ldq, min(FQ, p.Nq - q0),
             Seg{p.k[0] + b0, p.v[0] + b0, p.ld[0], p.len[0]}, Seg{p.k[1] + b1, p.v[1] + b1, p.ld[1], p.len[1]},
             p.nseg, p.scale, p.out + row0 * p.ldo + h * D, p.ldo);
}

template <typename K>
cudaError_t size_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// qkv: [R * F, 3C] fp32 (q | k | v columns, each head's 64 together), out:
// [R * F, C] fp32, C = heads * 64; 2 <= F <= 128, 128 % F == 0.
extern "C" int ds_temporal_attention_f32(const void* qkv, int R, int F, int C, int heads, float scale, void* out,
                                         void* stream) {
  if (R <= 0 || F < 2 || F > 128 || 128 % F || C != heads * D) return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = size_smem(temporal_attn_f32_kernel, T_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const long long T = (long long)R * F;
  dim3 grid((unsigned)((T + T_TOKENS - 1) / T_TOKENS), heads);
  temporal_attn_f32_kernel<<<grid, T_TOKENS, T_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), T, F, C, scale, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// ds_flash_attention's interface at fp32: q rows b * Nq + i with pitch ldq;
// segment s keys/values rows b * len_s + j with pitch ld_s; head h at column
// h * 64 of every operand; out rows b * Nq + i with pitch ldo. nseg 1 or 2;
// every length >= 1; pitches multiples of 4 floats; pointers 16-byte aligned.
extern "C" int ds_flash_attention_f32(const void* q, int ldq, int B, int Nq, int heads,
                                      const void* k0, const void* v0, int ld0, int len0,
                                      const void* k1, const void* v1, int ld1, int len1,
                                      int nseg, float scale, void* out, int ldo, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (B <= 0 || Nq <= 0 || heads <= 0 || len0 <= 0 || (nseg != 1 && nseg != 2)) return (int)bad;
  if (nseg == 2 && (len1 <= 0 || k1 == nullptr || v1 == nullptr || ld1 % 4 || heads * D > ld1)) return (int)bad;
  if (ldq % 4 || ld0 % 4 || ldo % 4 || heads * D > ldq || heads * D > ld0 || heads * D > ldo) return (int)bad;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = size_smem(flash_attn_f32_kernel, FLASH_FLOATS * 4);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  FlashParams p{};
  p.q = static_cast<const float*>(q);
  p.k[0] = static_cast<const float*>(k0);
  p.v[0] = static_cast<const float*>(v0);
  p.k[1] = static_cast<const float*>(nseg == 2 ? k1 : k0);
  p.v[1] = static_cast<const float*>(nseg == 2 ? v1 : v0);
  p.ldq = ldq; p.ld[0] = ld0; p.ld[1] = nseg == 2 ? ld1 : ld0;
  p.len[0] = len0; p.len[1] = nseg == 2 ? len1 : 0;
  p.B = B; p.Nq = Nq; p.heads = heads; p.nseg = nseg;
  p.q_tiles = (Nq + FQ - 1) / FQ;
  p.scale = scale;
  p.out = static_cast<float*>(out);
  p.ldo = ldo;
  const long long tiles = (long long)p.q_tiles * heads * B;
  if (tiles > 0x7fffffff) return (int)bad;
  flash_attn_f32_kernel<<<(unsigned)tiles, NT, FLASH_FLOATS * 4, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
