// The fp32 flash-attention tile of head dim 64 inside kernels 11 and 13
// (block_f32.cu): it multiplies and accumulates in fp32 on the CUDA cores
// (FFMA) and takes the exponentials with expf; one block's work, its phases
// separated by barriers.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace attn_f32 {

constexpr int D = 64;    // head dim
constexpr int NT = 256;  // threads a block
constexpr int FP = 64 + 4;  // floats of a row of the flash tile's staged [.][64] tiles
constexpr int FLASH_FLOATS = 4 * D * FP;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// ---------------------------------------------------------------------------
// flash attention of 64 query rows (rows < 64 valid) of one head: q rows
// with pitch ldq; up to two key segments (keys and values with pitch ld,
// len rows), each its own softmax, the normalised outputs summed; out rows
// with pitch ldo. Head offsets are in the pointers. A block of NT threads:
// S = Q K^T as a 4 x 4 register block a thread (rows ty*4.., keys tx*4..),
// an online softmax (the row's running max and its rescale, the max reduced
// over the 16 threads of a row with shuffles), the probabilities through
// shared memory (key-major) into O += P V, a 4 x 4 block of rows x dims a
// thread; logits past the segment's length masked to -inf. Needs
// FLASH_FLOATS of shared memory.
// ---------------------------------------------------------------------------
struct Seg {
  const float* k;
  const float* v;
  int ld, len;
};

__device__ __forceinline__ void tile_flash(float* sm, const float* q, int ldq, int rows, Seg s0, Seg s1, int nseg,
                                           float scale, float* out, int ldo) {
  float* qt = sm;           // [d][row]
  float* kt = qt + D * FP;  // [d][key]
  float* vs = kt + D * FP;  // [key][d]
  float* pt = vs + D * FP;  // [key][row]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  __syncthreads();  // the shared memory's last readers are done
  {
    const int row = tid & 63;
    const bool ok = row < rows;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = (tid >> 6) * 4 + 16 * i;
      const float4 v = ok ? *reinterpret_cast<const float4*>(q + (size_t)row * ldq + d) : zero4();
      qt[(d + 0) * FP + row] = v.x;
      qt[(d + 1) * FP + row] = v.y;
      qt[(d + 2) * FP + row] = v.z;
      qt[(d + 3) * FP + row] = v.w;
    }
  }
  float fin[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) fin[i][j] = 0.f;
  for (int sg = 0; sg < nseg; ++sg) {
    const Seg s = sg == 0 ? s0 : s1;
    float m[4], l[4], o[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < s.len; k0 += 64) {
      __syncthreads();  // the previous tile's readers are done (and q^T is written)
      {
        const int key = tid & 63;
        const bool ok = k0 + key < s.len;
        const float* src = s.k + (size_t)(k0 + key) * s.ld;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = (tid >> 6) * 4 + 16 * i;
          const float4 v = ok ? *reinterpret_cast<const float4*>(src + d) : zero4();
          kt[(d + 0) * FP + key] = v.x;
          kt[(d + 1) * FP + key] = v.y;
          kt[(d + 2) * FP + key] = v.z;
          kt[(d + 3) * FP + key] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = (tid >> 4) + 16 * i, d = (tid & 15) * 4;
        const float4 v = k0 + key < s.len ? *reinterpret_cast<const float4*>(s.v + (size_t)(k0 + key) * s.ld + d)
                                          : zero4();
        *reinterpret_cast<float4*>(vs + key * FP + d) = v;
      }
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(qt + d * FP + ty * 4);
        const float4 c = *reinterpret_cast<const float4*>(kt + d * FP + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = k0 + tx * 4 + j < s.len ? sc[i][j] * scale : -INFINITY;
          mx = fmaxf(mx, sc[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - mn);
        m[i] = mn;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = expf(sc[i][j] - mn);
          ps += sc[i][j];
        }
        l[i] = l[i] * alpha + ps;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(pt + (tx * 4 + j) * FP + ty * 4) =
            make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      __syncthreads();
#pragma unroll 8
      for (int key = 0; key < 64; ++key) {
        const float4 a = *reinterpret_cast<const float4*>(pt + key * FP + ty * 4);
        const float4 c = *reinterpret_cast<const float4*>(vs + key * FP + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = fmaf(av[i], cv[j], o[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sum = l[i];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int j = 0; j < 4; ++j) fin[i][j] += o[i][j] / sum;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row < rows)
      *reinterpret_cast<float4*>(out + (size_t)row * ldo + tx * 4) =
          make_float4(fin[i][0], fin[i][1], fin[i][2], fin[i][3]);
  }
  __syncthreads();
}

}  // namespace attn_f32
