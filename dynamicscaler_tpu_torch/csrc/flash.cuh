// The flash-attention steps shared by attention.cu (ds_flash_attention, K2
// and K3) and mega.cu (the attention of kernels 11 and 13): one warpgroup's
// 64 query rows of one head (head dim 64) against a tile of BN keys whose K
// and V tiles TMA wrote in the 128-byte swizzle. S = Q K^T on wgmma with both
// operands in shared memory; the online softmax on the accumulator registers
// (base-2 exponentials, logits past the segment's length masked to -inf); P
// rounded to bf16 in registers, where S's accumulator layout is the A
// fragment of O += P V, which reads V MN-major through its descriptor.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace flash {

using namespace hopper;

constexpr int HEAD_DIM = 64;

// the transposed (MN-major) V operand: 8-row groups 1024 bytes apart along
// k; the leading offset is unused at N = 64 (one 128-byte row of N), set
// to the same 1024 bytes
__device__ __forceinline__ uint64_t v_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// O += P V for one key tile: P (bf16 A fragments) from registers, V from the stage
template <int BN>
__device__ __forceinline__ void issue_pv(float (&o)[32], uint32_t (&pa)[BN / 16][4], const uint8_t* vt) {
  const uint64_t vd = v_desc(vt);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) WgmmaRegA<64>::mma(o, pa[kk], vd + 128 * kk, 1);
}

// The online-softmax step of one S tile (BN keys, `valid` of them inside the
// segment): the rows' running max m (raw logits) and sum l, the factor alpha
// that rescales the rows' O, and P = exp2(S sl - m sl) left in s.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             int valid, float sl) {
  const int t4 = threadIdx.x & 3;
  if (valid < BN) {
#pragma unroll
    for (int g = 0; g < BN / 8; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * g + 2 * t4 + (e & 1) >= valid) s[4 * g + e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int g = 0; g < BN / 8; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * g + e]);
  float neg[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    alpha[hh] = exp2f((m[hh] - mx[hh]) * sl);  // 0 on the first tile
    m[hh] = mx[hh];
    neg[hh] = -mx[hh] * sl;
  }
#pragma unroll
  for (int g = 0; g < BN / 8; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[4 * g + e], sl, neg[e >> 1]));
      s[4 * g + e] = p;
      ps[e >> 1] += p;
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
}

// P in bf16: the S accumulator of keys 16kk..16kk+15 is the A fragment
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4], const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack2(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack2(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack2(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int BN>
__device__ __forceinline__ void issue_s(float (&s)[BN / 2], uint64_t qdesc, const uint8_t* kt) {
  const uint64_t kd = smem_desc(kt);
#pragma unroll
  for (int k = 0; k < HEAD_DIM / 16; ++k) Wgmma<BN>::mma(s, qdesc + 2 * k, kd + 2 * k, k);
}

}  // namespace flash
