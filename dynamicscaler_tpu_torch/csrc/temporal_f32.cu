// Kernels 10 and 12 at fp32 on the tensor cores: the whole temporal block
// and the whole temporal transformer, for a model run in float32, with
// every product on wgmma .tf32 through the three-product split of
// gemm_f32.cu (ds_temporal_block_f32, ds_temporal_mega_f32).
//
// Replaces, at fp32 activations, the TPU kernels
//   dynamicscaler_tpu/ops/fused_block.py::_temporal_block_call  (K10)
//   dynamicscaler_tpu/ops/fused_mega.py::_t_mega_call           (K12)
// which compute in x.dtype, so at float32 with no rounding point anywhere:
//   K10: x += out1(attnF(LN1(x) @ Wqkv1)); x += out2(attnF(LN2(x) @ Wqkv2));
//        x += GEGLU(LN3(x) @ W1 + b1) @ W2 + b2, over x [R, F, C];
//   K12: h = GN-apply(x5) permuted to F-frame rows @ W_in + b_in; h = K10(h);
//        y = x5 + (h @ W_out + b_out) permuted back, over x5 [B, F, H, W, C].
// Exponentials with expf, GELU with erff; the LayerNorm and GroupNorm
// products and sums rounded one by one, as PyTorch's separate operations
// round them.
//
// What bounds them on the H100: operations. Per token the block multiplies
// by 20 C^2 weights (kernel 12 adds 2 C^2), 2 operations each, and each
// fp32 product runs as three tf32 products (hopper.cuh: a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi), so the least time is 3 x 40 C^2 operations a
// token at the tensor cores' 494.7 TFLOP/s, against 8 C bytes of device
// memory a token: hundreds of operations a byte at every width.
//
// Design (the tile, TM, from ops/cuda_lib.py::block_f32_plan):
//   * a persistent grid of one 384-thread block per SM, each taking tiles of
//     TM tokens (128, or 64 where there are fewer tiles of 128 than SMs;
//     whole F-frame rows for every F the gate admits, so no row spans
//     blocks) in turn: two consumer warpgroups and a producer warpgroup, one
//     thread of which issues every TMA copy (setmaxnreg moves the others'
//     registers to the consumers). At TM 128 each consumer warpgroup takes
//     64 of the tile's rows and every column of a column tile; at TM 64 both
//     take the tile's 64 rows and half the columns each;
//   * every projection is gemm_f32.cu's product with the tokens as the M
//     side: per column tile of BN = 128 weight rows and 32-deep k stage, a
//     ring of STAGES = 4 slots brings the token rows (A, TM x 32) and the
//     weight tile split once, W_hi and W_lo ([2, N, K], by
//     cuda_lib.tf32_split_weights), by TMA in the 128-byte swizzle; each
//     consumer loads its A fragments from the stage, splits them in
//     registers (the next stage's while the products run) and issues wgmma
//     m64nWNk8 .tf32 with A from registers; the 24 products of each two
//     stages (64 k) go into an accumulator of their own, folded into the
//     tile's in fp32 (the tensor core rounds its additions towards zero:
//     one accumulator over K 1280 misses the 1e-5 gate); a weight box of a
//     last column tile that lies past N (N = 320 or 960 at C 320) is not
//     loaded (the product still multiplies the full width: a product of
//     half the width beside the full one made ptxas serialise the wgmmas);
//   * the producer walks the block's fixed schedule (w_in; wqkv1; wo1;
//     wqkv2; wo2; w1 with each tile's value and gate rows; w2; w_out) and
//     starts each product when the consumers have written its A rows (and
//     given back the ring's shared memory that the attention borrows): an
//     mbarrier `ready` completes once a product;
//   * the token rows between the products live in a slot of global scratch
//     a block (cuda_lib.temporal_f32_scratch: the LayerNorm, GroupNorm or
//     attention rows [TM, C], the q|k|v or GEGLU rows [TM, 4C], the residual
//     stream [TM, C]; 768 C bytes a token), which the consumers write with
//     plain stores and the TMA reads (a proxy fence between): an fp32 token
//     tile of 128 at C 320 is 160 KB, more than shared memory holds beside a
//     ring, so the tiles stay in L2 as far as L2 holds them;
//   * the LayerNorm (a warp eight rows at a time, flax's fast variance) and the
//     GroupNorm apply are passes of the consumers over the tile's rows;
//   * the F-frame attention of each head runs over shared memory that the
//     ring lends it between two products (no TMA copy is in flight then):
//     at F 8 and 16 (the UNet's) on the tensor cores, mma.sync m16n8k8 .tf32
//     with the same three-product split, a warp a row of 16 frames (or two
//     of 8), the head's q, k and v of the tile copied by cp.async, the keys
//     permuted within each 8 so that the logits' registers are P's A
//     fragment (as ds_flash_attention_f32 permutes them); at any other F on
//     the CUDA cores, two threads a query (32 dims each). Every logit is
//     computed once (scaled, the row's maximum, then expf of each against it
//     summed, as the plain version orders them). At TM 64 half the warps
//     wait out the pass;
//   * the epilogues add the bias, form GEGLU (a warpgroup's columns of a tile
//     are half w1's value rows and half the matching gate rows) and add the
//     residual from the registers, writing straight to the scratch, or to
//     the output (kernel 12's output rows and residual x5 in frame-major
//     order).
// No split-K and no atomics: two runs agree bit for bit.
// The token tile, the products and the LayerNorm pass are in tc_f32.cuh,
// shared with spatial_f32.cu (kernels 11 and 13).
//
// chip_tf32_variants.py times the alternatives to this design as variants
// of this source (PERF.md): clusters of 2 blocks sharing each weight tile by
// multicast (halving the weights' L2 reads; 1-4% slower on the plan's
// shapes: the products do not wait on L2), the token rows written already
// split (twice the rows' bytes, a ring of 3: 12-45% slower), the residual
// stream resident in shared memory at TM 64 (faster than TM 64 from scratch,
// slower than TM 128), the weights of a product's first stages issued
// before the pass ends, BN 64, 2 slots, and a fold after every stage.

#include <math.h>
#include <string.h>

#include "tc_f32.cuh"

namespace {

using namespace hopper;
using namespace tc_f32;

constexpr int KV_PITCH = D + 4;         // floats of an attention key or value row in shared memory

// the block's products in schedule order (kernel 10 runs G_QKV1..G_W2)
enum { G_IN, G_QKV1, G_WO1, G_QKV2, G_WO2, G_W1, G_W2, G_OUT, N_GEMMS };
// the scratch regions: LayerNorm / GroupNorm / attention rows [TM, C], q|k|v
// or GEGLU rows [TM, 4C], the residual stream [TM, C]
enum { R_H, R_B, R_S, N_REGIONS };

struct Maps {
  CUtensorMap w[N_GEMMS];    // W [2, N, K] split, boxes of 32 k x HB rows
  CUtensorMap a[N_REGIONS];  // the regions [slots * TM, columns], boxes of 32 k x TM rows
};

struct Args {
  const float* x;  // K10: [R*F, C]; K12: x5 [B, F, H, W, C]
  float* out;
  const float* ln_w[3];
  const float* ln_b[3];
  const float* bias[N_GEMMS];  // b_in, none, bo1, none, bo2, b1 [8C], b2, b_out
  const float* gn_mul;         // K12: [B, C] folded GroupNorm vectors
  const float* gn_add;
  float* reg[N_REGIONS];
  long long T;  // tokens
  int F, HW, C, tiles;
  float scale, eps;
};

// The block's shared memory: the alignment pad, the ring, and two mbarriers
// a slot and one more. The attention borrows the ring: at F 8 and 16 the
// tile's q, k [TM, KV_PITCH] and v [TM, D + 8] (attention_tc), else its
// keys and values [TM, KV_PITCH] and logits [TM, F + 1] (attention), at
// most [TM, 2 KV_PITCH + 129] floats at F 128.
template <int TM>
constexpr int smem_bytes() {
  static_assert(TM * (2 * KV_PITCH + 129) * 4 <= Tile<TM>::RING, "the attention fits in the ring");
  static_assert(SMEM_ALIGN + Tile<TM>::RING + (2 * STAGES + 1) * 8 <= SMEM_MAX, "the ring fits");
  return SMEM_ALIGN + Tile<TM>::RING + (2 * STAGES + 1) * 8;
}

__host__ __device__ inline int gemm_n(int g, int C) { return g == G_QKV1 || g == G_QKV2 ? 3 * C : g == G_W1 ? 8 * C : C; }
__host__ __device__ inline int gemm_k(int g, int C) { return g == G_W2 ? 4 * C : C; }
__host__ __device__ inline int gemm_a(int g) { return g == G_W2 ? R_B : g == G_OUT ? R_S : R_H; }
__host__ __device__ inline int region_cols(int r, int C) { return r == R_B ? 4 * C : C; }

// Stored row of logical row r = (b*HW + hw)*F + f of a [B, F, H, W, .] tensor.
__device__ __forceinline__ size_t frame_major_row(long long r, int F, int HW) {
  const long long f = r % F, bhw = r / F;
  const long long b = bhw / HW;
  return (size_t)((b * F + f) * HW + (bhw - b * HW));
}

// Kernel 12's head: dst row r = x5 at logical row t0 + r (frame-major
// stored row) * mul + add of its sample; rows >= rows are zeros.
template <int TM>
__device__ void gn_apply(const Args& a, long long t0, int rows, float* dst) {
  constexpr int U = 8;  // float4 of a thread in flight together
  const int C = a.C, cv = C / 4;
  const long long clip = (long long)a.F * a.HW;
  for (int i0 = threadIdx.x; i0 < TM * cv; i0 += U * CONSUMERS) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * CONSUMERS, r = i / cv, c = (i - r * cv) * 4;
      v[u] = i < TM * cv && r < rows
                 ? *reinterpret_cast<const float4*>(a.x + frame_major_row(t0 + r, a.F, a.HW) * C + c)
                 : zero4();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * CONSUMERS, r = i / cv, c = (i - r * cv) * 4;
      if (i >= TM * cv) break;
      if (r < rows) {
        const size_t s = (size_t)((t0 + r) / clip) * C + c;
        const float4 m = __ldg(reinterpret_cast<const float4*>(a.gn_mul + s));
        const float4 d = __ldg(reinterpret_cast<const float4*>(a.gn_add + s));
        v[u].x = __fadd_rn(__fmul_rn(v[u].x, m.x), d.x);
        v[u].y = __fadd_rn(__fmul_rn(v[u].y, m.y), d.y);
        v[u].z = __fadd_rn(__fmul_rn(v[u].z, m.z), d.z);
        v[u].w = __fadd_rn(__fmul_rn(v[u].w, m.w), d.w);
      }
      *reinterpret_cast<float4*>(dst + (size_t)r * C + c) = v[u];
    }
  }
}

// The F-frame attention of the tile's TM tokens (TM / F whole rows), head
// by head: qkv rows [TM, 4C] with each head's q | k | v 192 columns together
// (as kernel 10 packs them), out rows [TM, C], at any F (attention_tc takes
// F 8 and 16). The head's keys and values in shared memory (sm: the ring's,
// idle between two products), every load of a thread's share and of its
// query in flight together; two threads a token (32 dims each); each logit
// is computed once, scaled and kept in the token's row of logits in shared
// memory; then the row's maximum, expf of each logit against it, their
// sum, and the weighted values over it.
template <int TM>
__device__ void attention(const Args& a, float* sm, const float* qkv, float* out) {
  constexpr int KV4 = 2 * TM * (D / 4) / CONSUMERS;  // float4 of a head's keys and values a thread stages
  static_assert(KV4 == TM / 8 && CONSUMERS == 256, "a thread stages TM / 16 tokens' keys and values, 16 apart");
  const int C = a.C, F = a.F, heads = C / D, tid = threadIdx.x;
  float* ks = sm;
  float* vs = ks + TM * KV_PITCH;
  const size_t ld = 4 * (size_t)C;
  const int t = tid >> 1, half = tid & 1;  // at TM 64 the threads of tokens t >= TM only stage
  const int kb = (t / F) * F;
  float* row = vs + TM * KV_PITCH + t * (F + 1);  // the token's logits
  // this thread's share of a head's keys and values: tokens tok0 + 16u, columns c4..c4 + 3
  const int tok0 = tid >> 4, c4 = (tid & 15) * 4;
  for (int h = 0; h < heads; ++h) {
    const float* kvsrc = qkv + (size_t)tok0 * ld + h * 3 * D + D + c4;  // the keys; the values D further
    float4 kv[KV4];
#pragma unroll
    for (int u = 0; u < KV4 / 2; ++u) {
      kv[u] = *reinterpret_cast<const float4*>(kvsrc + (size_t)(16 * u) * ld);
      kv[KV4 / 2 + u] = *reinterpret_cast<const float4*>(kvsrc + (size_t)(16 * u) * ld + D);
    }
    float q[32];
#pragma unroll
    for (int d = 0; d < 32; d += 4) {
      const float4 v = t < TM ? *reinterpret_cast<const float4*>(qkv + t * ld + h * 3 * D + half * 32 + d) : zero4();
      q[d] = v.x; q[d + 1] = v.y; q[d + 2] = v.z; q[d + 3] = v.w;
    }
    consumer_sync();  // the last head's readers of ks, vs and the logits are done
#pragma unroll
    for (int u = 0; u < KV4 / 2; ++u) {
      *reinterpret_cast<float4*>(ks + (tok0 + 16 * u) * KV_PITCH + c4) = kv[u];
      *reinterpret_cast<float4*>(vs + (tok0 + 16 * u) * KV_PITCH + c4) = kv[KV4 / 2 + u];
    }
    consumer_sync();
    if (t >= TM) continue;  // warp-uniform
    float m = -INFINITY;
#pragma unroll 2
    for (int j = 0; j < F; ++j) {
      const float* k = ks + (kb + j) * KV_PITCH + half * 32;
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < 32; d += 4) {
        const float4 v = *reinterpret_cast<const float4*>(k + d);
        p[0] = fmaf(q[d], v.x, p[0]);
        p[1] = fmaf(q[d + 1], v.y, p[1]);
        p[2] = fmaf(q[d + 2], v.z, p[2]);
        p[3] = fmaf(q[d + 3], v.w, p[3]);
      }
      float s = (p[0] + p[1]) + (p[2] + p[3]);
      s = (s + __shfl_xor_sync(0xffffffffu, s, 1)) * a.scale;  // the same sum in both threads
      if (half == 0) row[j] = s;
      m = fmaxf(m, s);
    }
    __syncwarp();
    float o[32], l = 0.f;
#pragma unroll
    for (int d = 0; d < 32; ++d) o[d] = 0.f;
#pragma unroll 2
    for (int j = 0; j < F; ++j) {
      const float p = expf(row[j] - m);
      l += p;
      const float* v = vs + (kb + j) * KV_PITCH + half * 32;
#pragma unroll
      for (int d = 0; d < 32; d += 4) {
        const float4 w = *reinterpret_cast<const float4*>(v + d);
        o[d] = fmaf(p, w.x, o[d]);
        o[d + 1] = fmaf(p, w.y, o[d + 1]);
        o[d + 2] = fmaf(p, w.z, o[d + 2]);
        o[d + 3] = fmaf(p, w.w, o[d + 3]);
      }
    }
    float* y = out + (size_t)t * C + h * D + half * 32;
    const float il = 1.f / l;
#pragma unroll
    for (int d = 0; d < 32; d += 4)
      *reinterpret_cast<float4*>(y + d) = make_float4(o[d] * il, o[d + 1] * il, o[d + 2] * il, o[d + 3] * il);
  }
}

// The F-frame attention at F 8 and 16 (the UNet's) on the tensor cores
// (3xTF32): the head's q, k and v of the tile copied (cp.async) into shared
// memory; warp w takes the 16 tokens 16w.. (a row of 16 frames, or two of
// 8 with the other row's keys masked) as its queries and keys (at TM 64
// warps 4-7 have none). S = q k^T in steps of 8 dims over two key tiles of
// 8, each step folded in fp32, the keys permuted within each 8 (position 2t
// holds key t, 2t + 1 key t + 4) so that S's registers are P's A fragment;
// every logit computed once and scaled, the row's maximum, expf of each
// logit against it and their sum over the lane quad; then O = P V (two key
// steps, eight tiles of 8 dims) over the sum.
template <int TM, int FF>
__device__ void attention_tc(const Args& a, float* sm, const float* qkv, float* out) {
  constexpr int QP = KV_PITCH, VP = D + 8;  // pitches: q, k rows (banks 4g + t), v rows (8t + g)
  const int C = a.C, heads = C / D, tid = threadIdx.x;
  const size_t ld = 4 * (size_t)C;
  float* qs = sm;
  float* ks = qs + TM * QP;
  float* vs = ks + TM * QP;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;                         // the warp's first token: its queries and keys
  const int tok0 = tid >> 4, c4 = (tid & 15) * 4;  // this thread's copies: tokens tok0 + 16u, columns c4..
  const int kp = (g >> 1) + (g & 1) * 4;            // the key at this lane's B column g of a key tile
  for (int h = 0; h < heads; ++h) {
    consumer_sync();  // the last head's readers of q, k and v are done
    const float* src = qkv + (size_t)tok0 * ld + h * 3 * D + c4;
#pragma unroll
    for (int u = 0; u < TM / 16; ++u) {
      const float* s_ = src + (size_t)(16 * u) * ld;
      const int tok = tok0 + 16 * u;
      cp_async16(qs + tok * QP + c4, s_);
      cp_async16(ks + tok * QP + c4, s_ + D);
      cp_async16(vs + tok * VP + c4, s_ + 2 * D);
    }
    cp_async_wait_all();
    consumer_sync();
    if (r0 >= TM) continue;  // warp-uniform
    const float* qw = qs + r0 * QP;
    const float* kw = ks + r0 * QP;
    const float* vw = vs + r0 * VP;
    float sc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = 8 * kk + t;
      uint32_t ah[4], al[4];
      split_tf32(qw[g * QP + c], ah[0], al[0]);
      split_tf32(qw[(g + 8) * QP + c], ah[1], al[1]);
      split_tf32(qw[g * QP + c + 4], ah[2], al[2]);
      split_tf32(qw[(g + 8) * QP + c + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* kr = kw + (8 * n + kp) * QP;
        mma_3xtf32(sc[n], ah, al, kr[c], kr[c + 4]);
      }
    }
    // rows g (sc[n][0], [1]: keys 8n + t, 8n + t + 4) and g + 8 (sc[n][2], [3])
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;  // 0: row g, 1: row g + 8
        sc[n][e] = FF == 16 || r == n ? sc[n][e] * a.scale : -INFINITY;  // F 8: the query's own row of 8
        m[r] = fmaxf(m[r], sc[n][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - m[e >> 1]);
        l[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    float o[8][4] = {};
#pragma unroll
    for (int n = 0; n < 2; ++n) {  // keys 8n + t and 8n + t + 4: A columns t and t + 4
      uint32_t ph[4], pl[4];
      split_tf32(sc[n][0], ph[0], pl[0]);
      split_tf32(sc[n][2], ph[1], pl[1]);
      split_tf32(sc[n][1], ph[2], pl[2]);
      split_tf32(sc[n][3], ph[3], pl[3]);
      const float* v0 = vw + (8 * n + t) * VP;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) mma_3xtf32(o[dt], ph, pl, v0[8 * dt + g], v0[4 * VP + 8 * dt + g]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float il = 1.f / l[r];
      float* y = out + (size_t)(r0 + g + 8 * r) * C + h * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        *reinterpret_cast<float2*>(y + 8 * dt) = make_float2(o[dt][2 * r] * il, o[dt][2 * r + 1] * il);
    }
  }
}

// ---- the producer ---------------------------------------------------------------

template <int TM, bool MEGA>
__device__ void produce(const Maps& m, const Args& a, uint8_t* smem, uint64_t* full, uint64_t* empty,
                        uint64_t* ready) {
  using T = Tile<TM>;
  constexpr int BOX = T::HB * ROW;
  const int C = a.C;
  const int row0 = blockIdx.x * TM;  // the block's slot in the scratch regions
  int it = 0;                        // stages issued so far: the ring position
  uint32_t rp = 0;                   // the parity of the next `ready` phase
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    for (int g = MEGA ? G_IN : G_QKV1; g <= (MEGA ? G_OUT : G_W2); ++g) {
      mbar_wait(ready, rp);  // the consumers wrote this product's A rows
      rp ^= 1;
      const int N = gemm_n(g, C), KT = gemm_k(g, C) / BK;
      const bool geglu = g == G_W1;
      const int nt = geglu ? N / BN : (N + BN - 1) / BN;
      for (int j = 0; j < nt; ++j) {
        int boxes = 0;  // of the tile's 2 NW boxes, those within N
#pragma unroll
        for (int b = 0; b < 2 * T::NW; ++b) boxes += box_row<TM>(b, j, N, geglu) >= 0;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* sa = smem + s * T::STAGE;
          mbar_expect_tx(&full[s], T::A_BYTES + boxes * 2 * BOX);
          tma_load_2d(sa, &m.a[gemm_a(g)], &full[s], kt * BK, row0);
#pragma unroll
          for (int b = 0; b < 2 * T::NW; ++b) {  // W_hi, then W_lo
            const int n = box_row<TM>(b, j, N, geglu);
            if (n < 0) continue;
            for (int half = 0; half < 2; ++half)
              tma_load_3d(sa + T::A_BYTES + half * BN * ROW + b * BOX, &m.w[g], &full[s], kt * BK, n, half);
          }
        }
      }
    }
  }
}

// ---- the consumers --------------------------------------------------------------

template <int TM, bool MEGA>
__device__ void consume(const Args& a, uint8_t* smem, uint64_t* full, uint64_t* empty, uint64_t* ready) {
  using T = Tile<TM>;
  constexpr int NC = T::WN / 8;  // column pairs a thread
  const int C = a.C;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, warp = (tid & 127) >> 5;
  const int wr = wg % T::MW, wc = wg / T::MW;  // the warpgroup's rows and columns of the tile
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = wr * 64 + warp * 16 + g8;  // this thread's rows of the tile: r0, r0 + 8
  const size_t slot = (size_t)blockIdx.x * TM;
  float* hs = a.reg[R_H] + slot * C;
  float* bs = a.reg[R_B] + slot * 4 * C;
  float* ss = a.reg[R_S] + slot * C;
  int it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long t0 = (long long)tile * TM;
    const int rows = (int)min((long long)TM, a.T - t0);
    for (int g = MEGA ? G_IN : G_QKV1; g <= (MEGA ? G_OUT : G_W2); ++g) {
      // the pass that writes this product's A rows (after the last product's
      // epilogue writes, which it may read)
      consumer_sync();
      if (g == G_IN) {
        gn_apply<TM>(a, t0, rows, hs);
      } else if (g == G_QKV1 && !MEGA) {
        layer_norm<TM>([&](int r) { return a.x + (size_t)(t0 + r) * C; }, rows, C, a.ln_w[0], a.ln_b[0], a.eps,
                       hs);
      } else if (g == G_QKV1 || g == G_QKV2 || g == G_W1) {
        const int i = g == G_QKV1 ? 0 : g == G_QKV2 ? 1 : 2;
        layer_norm<TM>([&](int r) { return ss + (size_t)r * C; }, rows, C, a.ln_w[i], a.ln_b[i], a.eps, hs);
      } else if (g == G_WO1 || g == G_WO2) {
        float* sm = reinterpret_cast<float*>(smem);
        if (a.F == 16) attention_tc<TM, 16>(a, sm, bs, hs);
        else if (a.F == 8) attention_tc<TM, 8>(a, sm, bs, hs);
        else attention<TM>(a, sm, bs, hs);
      }
      fence_proxy_async_all();
      consumer_sync();
      if (tid == 0) mbar_arrive(ready);

      const int N = gemm_n(g, C), KT = gemm_k(g, C) / BK;
      const bool geglu = g == G_W1;
      const int nt = geglu ? N / BN : (N + BN - 1) / BN;
      const float* bias = a.bias[g];
      for (int j = 0; j < nt; ++j) {
        // the warpgroup's first column: of the value rows (and N / 2 further
        // of the gate rows) in GEGLU
        const int n0 = geglu ? j * (BN / 2) + wc * T::HB : j * BN + wc * T::WN;
        float acc[T::ACC];
#pragma unroll
        for (int i = 0; i < T::ACC; ++i) acc[i] = 0.f;
        column_tile<TM>(acc, smem, full, empty, it, KT, wc * T::WN * ROW, r0, g8, t4, lane);

        // ---- epilogue: thread (warp w, lane l) holds rows r0 (+8) and, for
        // each 8-column group c, columns 8c + 2(l%4) + {0, 1}:
        // acc[4c + 2h + {0, 1}] for row half h. The bias of the thread's
        // columns is loaded once for both rows, and a row's residual in full
        // before any of its outputs is stored (the stream is updated in
        // place, so loads and stores would otherwise alternate).
        float2 bv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = geglu ? n0 + 8 * (c % (NC / 2)) + 2 * t4 + (c < NC / 2 ? 0 : N / 2) : n0 + 8 * c + 2 * t4;
          bv[c] = bias && n < N ? __ldg(reinterpret_cast<const float2*>(bias + n)) : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const bool valid = r < rows;
          float* y;
          const float* res = nullptr;
          if (g == G_IN) {
            y = ss + (size_t)r * C;
          } else if (g == G_QKV1 || g == G_QKV2 || g == G_W1) {
            y = bs + (size_t)r * 4 * C;
          } else if (g == G_WO1 && !MEGA) {  // the block's first residual is x itself
            if (!valid) continue;
            y = ss + (size_t)r * C;
            res = a.x + (size_t)(t0 + r) * C;
          } else if (g == G_WO1 || g == G_WO2 || (g == G_W2 && MEGA)) {
            y = ss + (size_t)r * C;
            res = y;
          } else if (g == G_W2) {  // kernel 10's output
            if (!valid) continue;
            y = a.out + (size_t)(t0 + r) * C;
            res = ss + (size_t)r * C;
          } else {  // G_OUT: y = x5 + h @ W_out + b_out at the frame-major rows
            if (!valid) continue;
            const size_t fr = frame_major_row(t0 + r, a.F, a.HW) * C;
            y = a.out + fr;
            res = a.x + fr;
          }
          if (geglu) {
#pragma unroll
            for (int c = 0; c < NC / 2; ++c) {
              const int n = n0 + 8 * c + 2 * t4;
              float2 v = make_float2(acc[4 * c + 2 * h] + bv[c].x, acc[4 * c + 2 * h + 1] + bv[c].y);
              const float2 gt = make_float2(acc[4 * (c + NC / 2) + 2 * h] + bv[c + NC / 2].x,
                                            acc[4 * (c + NC / 2) + 2 * h + 1] + bv[c + NC / 2].y);
              *reinterpret_cast<float2*>(y + n) = make_float2(v.x * gelu_erf(gt.x), v.y * gelu_erf(gt.y));
            }
          } else {
            float2 rv[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int n = n0 + 8 * c + 2 * t4;
              rv[c] = res && n < N ? *reinterpret_cast<const float2*>(res + n) : make_float2(0.f, 0.f);
            }
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int n = n0 + 8 * c + 2 * t4;
              if (n >= N) continue;  // a ragged last column tile
              float2 v = make_float2(acc[4 * c + 2 * h] + bv[c].x, acc[4 * c + 2 * h + 1] + bv[c].y);
              if (res) {
                v.x += rv[c].x;
                v.y += rv[c].y;
              }
              *reinterpret_cast<float2*>(y + n) = v;
            }
          }
        }
      }
    }
  }
}

// MEGA = false: kernel 10 over x [R, F, C]; MEGA = true: kernel 12 over x5
template <int TM, bool MEGA>
__global__ void __launch_bounds__(THREADS, 1)
temporal_tc_f32_kernel(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
                                             ~uintptr_t(SMEM_ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile<TM>::RING);  // TMA landed
  uint64_t* empty = full + STAGES;  // the consumers are done
  uint64_t* ready = empty + STAGES;  // the consumers wrote the next product's A rows
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(ready, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) produce<TM, MEGA>(maps, a, smem, full, empty, ready);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<TM, MEGA>(a, smem, full, empty, ready);
  }
}

// ---- host side ------------------------------------------------------------------

template <int TM, bool MEGA>
cudaError_t launch(const Maps& m, const Args& a, int blocks, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(temporal_tc_f32_kernel<TM, MEGA>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  temporal_tc_f32_kernel<TM, MEGA><<<blocks, THREADS, smem_bytes<TM>(), stream>>>(m, a);
  return cudaGetLastError();
}

const float* f(const void* p) { return static_cast<const float*>(p); }

int temporal_run(const void* const* p, bool mega, long long T, int F, int HW, int C, float scale, float eps,
                 void* scratch, long long scratch_floats, int slots, int tm, void* stream) {
  if (C % 64 || C < 64 || C > (mega ? 640 : 1280) || T <= 0 || F < 2 || F > 128 || 128 % F || T % F ||
      slots <= 0 || scratch == nullptr || (tm != 128 && tm != 64) || tm % F)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (T + tm - 1) / tm;
  if (tiles > 0x7fffffff || slots > tiles || scratch_floats < (long long)slots * tm * 6 * C)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = f(p[0]);
  a.out = static_cast<float*>(const_cast<void*>(p[1]));
  const void* w[N_GEMMS] = {};
  for (int s = 0; s < 2; ++s) {
    a.ln_w[s] = f(p[2 + 5 * s]);
    a.ln_b[s] = f(p[3 + 5 * s]);
    w[s ? G_QKV2 : G_QKV1] = p[4 + 5 * s];
    w[s ? G_WO2 : G_WO1] = p[5 + 5 * s];
    a.bias[s ? G_WO2 : G_WO1] = f(p[6 + 5 * s]);
  }
  a.ln_w[2] = f(p[12]);
  a.ln_b[2] = f(p[13]);
  w[G_W1] = p[14];
  a.bias[G_W1] = f(p[15]);
  w[G_W2] = p[16];
  a.bias[G_W2] = f(p[17]);
  if (mega) {
    a.gn_mul = f(p[18]);
    a.gn_add = f(p[19]);
    w[G_IN] = p[20];
    a.bias[G_IN] = f(p[21]);
    w[G_OUT] = p[22];
    a.bias[G_OUT] = f(p[23]);
  }
  a.T = T; a.F = F; a.HW = HW; a.C = C; a.tiles = (int)tiles;
  a.scale = scale; a.eps = eps;
  const long long rows = (long long)slots * tm;
  float* base = static_cast<float*>(scratch);
  a.reg[R_H] = base;
  a.reg[R_B] = base + rows * C;
  a.reg[R_S] = base + rows * 5 * C;

  Maps m;
  memset(&m, 0, sizeof(m));
  const int hb = BN / (2 * (tm == 128 ? 1 : 2));  // Tile<tm>::HB
  for (int g = mega ? G_IN : G_QKV1; g <= (mega ? G_OUT : G_W2); ++g) {  // W [2, N, K]: hi, then lo
    const int N = gemm_n(g, C), K = gemm_k(g, C);
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 4, (cuuint64_t)N * K * 4};
    const cuuint32_t box[3] = {BK, (cuuint32_t)hb, 1};
    if (w[g] == nullptr || !make_map(&m.w[g], w[g], 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return (int)cudaErrorInvalidValue;
  }
  for (int r = 0; r < N_REGIONS; ++r) {
    const int cols = region_cols(r, C);
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
    const cuuint32_t box[2] = {BK, (cuuint32_t)tm};
    if (!make_map(&m.a[r], a.reg[r], 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (tm == 128) e = mega ? launch<128, true>(m, a, slots, s) : launch<128, false>(m, a, slots, s);
  else e = mega ? launch<64, true>(m, a, slots, s) : launch<64, false>(m, a, slots, s);
  return (int)e;
}

}  // namespace

// p: ds_temporal_block's 18 pointers (block.cu), fp32, with every weight
// split for the tensor cores, [2, N, K] (ds_tf32_split's output): 0 x [R*F,
// C], 1 out, per attention sub-block s = 1, 2: ln_w, ln_b, wqkv [2, 3C, C]
// (rows: head, then q|k|v, then 64), wo [2, C, C], bo; then 12 ln3_w, 13
// ln3_b, 14 w1 [2, 8C, C], 15 b1 [8C], 16 w2 [2, C, 4C], 17 b2. Tiles of
// tm tokens (128 or 64, cuda_lib.block_f32_plan); `slots` blocks, at most
// one a tile; scratch: fp32, at least slots * tm * 6C floats
// (cuda_lib.temporal_f32_scratch). Shapes the caller guarantees: every
// pointer 16-byte aligned and contiguous.
extern "C" int ds_temporal_block_f32(const void* const* p, int R, int F, int C, float scale, float eps, void* scratch,
                                     long long scratch_floats, int slots, int tm, void* stream) {
  return temporal_run(p, false, (long long)R * F, F, 1, C, scale, eps, scratch, scratch_floats, slots, tm, stream);
}

// p: kernel 10's 18 pointers with 0 x5 / 1 out [B, F, H, W, C], then 18 mul
// [B, C], 19 add [B, C], 20 w_in [2, C, C], 21 b_in, 22 w_out [2, C, C], 23
// b_out; C <= 640.
extern "C" int ds_temporal_mega_f32(const void* const* p, int B, int F, int HW, int C, float scale, float eps,
                                    void* scratch, long long scratch_floats, int slots, int tm, void* stream) {
  if (HW <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  return temporal_run(p, true, (long long)B * F * HW, F, HW, C, scale, eps, scratch, scratch_floats, slots, tm,
                      stream);
}
