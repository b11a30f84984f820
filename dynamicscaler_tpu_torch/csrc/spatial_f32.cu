// Kernels 11 and 13 at fp32 on the tensor cores: the bodies of the whole
// spatial block and the whole spatial transformer, for a model run in
// float32, with every product and both products of the N-token attention
// (Q K^T and P V) on wgmma .tf32 through the three-product split
// (ds_spatial_block_f32, ds_mega_spatial_f32).
//
// Replaces, at fp32 activations, the TPU kernels
//   dynamicscaler_tpu/ops/fused_block.py::_spatial_block_call   (K11)
//   dynamicscaler_tpu/ops/fused_mega.py::_s_mega_call           (K13)
// which compute in x.dtype, so at float32 with no rounding point anywhere:
//   K11 body: h = x + out1(attnN(qkv)); h += out2(cross(LN2(h) @ Wq2, ctx
//        K|V)); h += GEGLU(LN3(h) @ W1 + b1) @ W2 + b2, with qkv = LN1(x) @
//        Wqkv and the context K|V projected before the launch
//        (ds_ln_gemm_f32): every query tile needs all the keys of its frame
//        sample, so q|k|v cannot be formed inside the tile;
//   K13 body: the same from h = proj_in(GN-apply(x)) (also ds_ln_gemm_f32),
//        then y = x + h @ W_out + b_out.
// Each key segment (the sample's N tokens; the clip's text and image
// tokens) has its own softmax, the normalised outputs summed. Exponentials
// with expf, GELU with erff; the LayerNorm rounded as PyTorch's operations
// round it.
//
// What bounds them on the H100: operations. Per token the body multiplies
// by 15 C^2 weights (kernel 13's adds C^2) and attends over N keys (4 N C
// operations a token: at s320, N 2560 and C 320, 46% of the launch), each
// fp32 product as three tf32 products, against 8 C bytes in and out a token
// and the split keys and values: hundreds of operations a byte.
//
// Design (temporal_f32.cu's, whose products and LayerNorm pass are shared
// through tc_f32.cuh; the tile, TM, from ops/cuda_lib.py::spatial_f32_plan):
//   * a pass of this file (split_kv_kernel) writes the keys split once a
//     launch, K_hi | K_lo [2, samples, len, C], and the values transposed
//     and split, V^T_hi | V^T_lo [2, samples, C, lpad] (lpad: len rounded up
//     to 64 keys, zeros past len), for the sample's own tokens (from q|k|v)
//     and for each context segment (from its K|V): tf32 wgmma takes B
//     K-major only, so for O += P V the values must lie keys-contiguous, and
//     at s320 each key tile is read by 20 query tiles of 128. Within each 8
//     keys V^T holds key 2c at column c and 2c + 1 at c + 4, the order in
//     which S's accumulator registers hold a thread's keys: P goes from S's
//     registers to wgmma with no shuffle;
//   * a persistent grid of one 384-thread block per SM takes query tiles of
//     TM tokens of one sample (128, or 64 where there are fewer tiles of 128
//     than SMs), sample-major, so the tiles in flight share their sample's
//     split keys and values in L2; a ragged last tile of a sample (N 400,
//     1600) runs with its rows past N masked. Two consumer warpgroups and a
//     producer warpgroup, one thread of which issues every TMA copy into
//     temporal_f32.cu's ring of 4 stages;
//   * the producer walks the block's fixed schedule: per head the sample's
//     key tiles of 64, each on one barrier (K hi and lo in one stage's
//     weight boxes, V^T hi and lo in the next's: one wait a key tile, a
//     fifth faster than a barrier a stage); wo1; wq2; per head the clip's
//     text and image key tiles; wo2; w1 with each tile's value and gate
//     rows; w2; w_out. A product waits for the consumers' `ready` (they
//     wrote its A rows), the key tiles do not (their sources exist before
//     the launch);
//   * the attention of a warpgroup's 64 rows, head by head: Q split once a
//     head (rows past N zero), hi into registers as the A fragments, lo
//     into a tile of the warpgroup's in shared memory beside the ring (32
//     registers fewer), then per key tile S = Q K^T as 8 k8 steps x 3
//     wgmma m64n64k8 into an accumulator started at zero; the online
//     softmax on its registers (logits times the scale, the row's running
//     maximum, expf(s - max), as the plain version orders them; keys past
//     the segment masked to -inf); P split in registers and O_tile = P V as
//     8 x 3 wgmma into an accumulator of its own, folded into O in fp32 (O
//     = O alpha + O_tile: the tensor core rounds its additions towards
//     zero; one accumulator over every key tile ran no faster and drifted
//     to 2.5e-6 of max|plain| against 1.5e-6 at s320); the normalised rows
//     to the scratch. At TM 64 the second warpgroup waits out the attention;
//   * every product is temporal_f32.cu's (tc_f32.cuh: the token rows A and
//     the weights split once, W_hi and W_lo [2, N, K] by
//     cuda_lib.tf32_split_weights, A split in registers, an accumulator a
//     two stages folded in fp32); the token rows between the products live
//     in a slot of global scratch a block (the LayerNorm or attention rows
//     [TM, C], q2 or the GEGLU rows [TM, 4C], the residual stream [TM, C]);
//     the epilogues add the bias, form GEGLU and add the residual from the
//     registers.
// No split-K and no atomics: two runs agree bit for bit.
//
// chip_tf32_variants.py times the alternatives to this design as variants
// of this source (PERF.md): a barrier a stage (the first version), Q's lo
// half in registers, the attention's thread indices left for the compiler
// to hoist (it then held what it derived from them through the products,
// whose accumulators spilled), the attention not inlined, P V in one
// accumulator, and, wrong by design, the attention or its compute dropped.
// What they showed: the key tiles' handoffs, not their bytes, set the
// attention's pace, and register spills the products'.

#include <math.h>
#include <string.h>

#include "tc_f32.cuh"

namespace {

using namespace hopper;
using namespace tc_f32;

constexpr int KEYS = 64;        // keys a key tile
// bytes of a [64][32] fp32 tile: 32 columns of 64 keys (K), or 32 keys of 64 columns (V^T)
constexpr int KH = KEYS * ROW;
static_assert(4 * KH == 2 * BN * ROW, "a key tile's K (or V^T), hi and lo, fills a stage's weight boxes");

// the body's products in schedule order (kernel 11 runs G_WO1..G_W2)
enum { G_WO1, G_Q2, G_WO2, G_W1, G_W2, G_OUT, N_GEMMS };
// the scratch regions: LayerNorm / attention rows [TM, C], q2 or GEGLU rows
// [TM, 4C], the residual stream [TM, C]
enum { R_H, R_B, R_S, N_REGIONS };
// the key segments: the frame sample's own tokens; the clip's text and image tokens
enum { S_SELF, S_TEXT, S_IMAGE, N_SEGS };

struct Maps {
  CUtensorMap w[N_GEMMS];    // W [2, N, K] split, boxes of 32 k x HB rows
  CUtensorMap a[N_REGIONS];  // the regions [slots * TM, columns], boxes of 32 k x TM rows
  CUtensorMap k[N_SEGS];     // K split [2 samples, len, C], boxes of 32 columns x 64 keys
  CUtensorMap vt[N_SEGS];    // V^T split [2 samples, C, lpad], boxes of 32 keys x 64 columns
};

struct Args {
  const float* h;    // [T, C] the block's input (K11: x; K13: proj_in's output)
  const float* x;    // K13: [T, C] the outer residual
  const float* qkv;  // [T, 3C]: the self-attention's queries
  float* out;
  const float* ln_w[2];  // LN2, LN3
  const float* ln_b[2];
  const float* bias[N_GEMMS];  // bo1, none, bo2, b1 [8C], b2, b_out
  float* reg[N_REGIONS];
  int N, C, frames, q_tiles, tiles, nseg;  // nseg: the cross-attention's key segments
  int len[N_SEGS];                         // keys a sample
  int samples[N_SEGS];                     // BF; clips; clips
  float scale, eps;
};

// Bytes of the attending warpgroups' Q_lo tiles: 64 rows x 64 columns each.
template <int TM>
constexpr int QLO_BYTES = Tile<TM>::MW * 2 * KH;

// The block's shared memory: the alignment pad, the ring, the Q_lo tiles,
// two mbarriers a slot and one more.
template <int TM>
constexpr int smem_bytes() {
  static_assert(SMEM_ALIGN + Tile<TM>::RING + QLO_BYTES<TM> + (2 * STAGES + 1) * 8 <= SMEM_MAX, "the ring fits");
  return SMEM_ALIGN + Tile<TM>::RING + QLO_BYTES<TM> + (2 * STAGES + 1) * 8;
}

__host__ __device__ inline int gemm_n(int g, int C) { return g == G_W1 ? 8 * C : C; }
__host__ __device__ inline int gemm_k(int g, int C) { return g == G_W2 ? 4 * C : C; }
__host__ __device__ inline int gemm_a(int g) { return g == G_W2 ? R_B : g == G_OUT ? R_S : R_H; }
__host__ __device__ inline int region_cols(int r, int C) { return r == R_B ? 4 * C : C; }
__host__ __device__ inline int key_pad(int len) { return (len + KEYS - 1) / KEYS * KEYS; }

// ---- the keys and values split once a launch ---------------------------------

// Of `samples` samples of `len` keys (rows of src with pitch ld, K at
// column kc + c, V at vc + c), a block's 64 keys x 64 columns: ks [2,
// samples, len, C] = K's hi, then lo; vt [2, samples, C, lpad] = V^T's hi,
// then lo, the keys of each 8 permuted (key 2c at column c, 2c + 1 at c +
// 4), zeros past len.
__global__ void __launch_bounds__(256) split_kv_kernel(const float* __restrict__ src, int ld, int kc, int vc,
                                                       int samples, int len, int lpad, int C, float* __restrict__ ks,
                                                       float* __restrict__ vt) {
  __shared__ float v_s[KEYS][KEYS + 1];
  const int k0 = blockIdx.x * KEYS, c0 = blockIdx.y * KEYS, b = blockIdx.z;
  const size_t k_lo = (size_t)samples * len * C, v_lo = (size_t)samples * C * lpad;
  for (int i = threadIdx.x; i < KEYS * KEYS / 4; i += blockDim.x) {
    const int r = i / (KEYS / 4), c = (i % (KEYS / 4)) * 4, key = k0 + r;
    float4 v = zero4();
    if (key < len) {
      const float* row = src + ((size_t)b * len + key) * ld + c0 + c;
      const float4 k = *reinterpret_cast<const float4*>(row + kc);
      v = *reinterpret_cast<const float4*>(row + vc);
      uint4 hi, lo;
      split_tf32(k.x, hi.x, lo.x);
      split_tf32(k.y, hi.y, lo.y);
      split_tf32(k.z, hi.z, lo.z);
      split_tf32(k.w, hi.w, lo.w);
      const size_t o = ((size_t)b * len + key) * C + c0 + c;
      *reinterpret_cast<uint4*>(ks + o) = hi;
      *reinterpret_cast<uint4*>(ks + k_lo + o) = lo;
    }
    v_s[r][c] = v.x;
    v_s[r][c + 1] = v.y;
    v_s[r][c + 2] = v.z;
    v_s[r][c + 3] = v.w;
  }
  __syncthreads();
  // V^T row c0 + c, columns p..p + 3 of the block's keys: keys 8(p / 8) + {0, 2, 4, 6} (p % 8 == 0) or + {1, 3, 5, 7}
  for (int i = threadIdx.x; i < KEYS * KEYS / 4; i += blockDim.x) {
    const int c = i / (KEYS / 4), p = (i % (KEYS / 4)) * 4;
    const int key0 = (p & ~7) + (p & 4 ? 1 : 0);
    uint4 hi, lo;
    split_tf32(v_s[key0][c], hi.x, lo.x);
    split_tf32(v_s[key0 + 2][c], hi.y, lo.y);
    split_tf32(v_s[key0 + 4][c], hi.z, lo.z);
    split_tf32(v_s[key0 + 6][c], hi.w, lo.w);
    const size_t o = ((size_t)b * C + c0 + c) * lpad + k0 + p;
    *reinterpret_cast<uint4*>(vt + o) = hi;
    *reinterpret_cast<uint4*>(vt + v_lo + o) = lo;
  }
}

// ---- the attention on the tensor cores ------------------------------------------

// Keep the compiler from reusing fragment registers that a wgmma may still read.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A head's 64 query columns at q, split: hi as the A fragments in
// registers (rows r0, r0 + 8, zeros at rows >= rows; columns 8j + t, 8j + t
// + 4), lo into the warpgroup's K-major tile in shared memory (two halves
// of 32 columns of its 64 rows, the 128-byte swizzle; row rw is r0's within
// the warpgroup), which the products a_lo.b_hi read from there.
__device__ __forceinline__ void load_q(const float* q, size_t ld, int r0, int rw, int rows, int t,
                                       uint32_t (&qh)[8][4], uint8_t* qlo) {
  const float* row[2] = {r0 < rows ? q + (size_t)r0 * ld : nullptr,
                         r0 + 8 < rows ? q + (size_t)(r0 + 8) * ld : nullptr};
  float v[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* p = row[e & 1];
      v[j][e] = p ? p[8 * j + t + 4 * (e >> 1)] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t lo;
      split_tf32(v[j][e], qh[j][e], lo);
      const int r = rw + 8 * (e & 1), c = 8 * j + t + 4 * (e >> 1);
      *reinterpret_cast<uint32_t*>(qlo + (c >> 5) * KH + r * ROW + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4) =
          lo;
    }
}

// s = Q K^T over the head's 64 columns: 8 k8 steps x 3 products into an
// accumulator started at zero; Q_hi from registers, Q_lo at qlo, K (hi: two
// halves of 32 columns, then lo) at kb.
__device__ __forceinline__ void qk(float (&s)[32], uint32_t (&qh)[8][4], const uint8_t* qlo, const uint8_t* kb) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int half = j >> 2, step = 2 * (j & 3);
    const uint64_t kh = smem_desc(kb + half * KH) + step, kl = smem_desc(kb + (2 + half) * KH) + step;
    WgmmaTf32<64>::mma(s, smem_desc(qlo + half * KH) + step, kh, j);
    WgmmaTf32RegA<64>::mma(s, qh[j], kl, 1);
    WgmmaTf32RegA<64>::mma(s, qh[j], kh, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  fence_frags(qh);
}

// ot = P V over the key tile's 64 keys, in two halves of 4 k8 steps: P from
// S's registers (a thread's keys 2t, 2t + 1 of each 8 are A columns t, t +
// 4), split; V^T (hi: two halves of 32 keys, then lo) at vb.
__device__ __forceinline__ void pv(float (&ot)[32], const float (&p)[32], const uint8_t* vb) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = 4 * (4 * half + j);  // rows g: keys q, q + 1; rows g + 8: q + 2, q + 3
      split_tf32(p[q], ph[j][0], pl[j][0]);
      split_tf32(p[q + 2], ph[j][1], pl[j][1]);
      split_tf32(p[q + 1], ph[j][2], pl[j][2]);
      split_tf32(p[q + 3], ph[j][3], pl[j][3]);
    }
    const uint64_t vh = smem_desc(vb + half * KH), vl = smem_desc(vb + (2 + half) * KH);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      WgmmaTf32RegA<64>::mma(ot, pl[j], vh + 2 * j, half || j);
      WgmmaTf32RegA<64>::mma(ot, ph[j], vl + 2 * j, 1);
      WgmmaTf32RegA<64>::mma(ot, ph[j], vh + 2 * j, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(ot);
    fence_frags(ph);
    fence_frags(pl);
  }
}

// The attention of the tile's rows over key segments seg0 .. seg0 + nseg - 1
// of `sample`, head by head: queries at q (head h at column 64h, pitch ld),
// the normalised outputs summed into out [TM, C] at column 64h. Consumes
// the producer's key tiles in its order (a key tile's K stage and V^T
// stage on the first's barrier, both handed back after P V); a warpgroup
// that is not `active` (TM 64: the second) waits out each key tile and
// hands it back.
template <int TM>
__device__ void attention(const Args& a, uint8_t* smem, uint64_t* full, uint64_t* empty, int& it, int seg0, int nseg,
                          const float* q, size_t ld, int rows, float* out, bool active, int r0_, int t_, int lane) {
  using T = Tile<TM>;
  const int heads = a.C / D;
  for (int h = 0; h < heads; ++h) {
    // the thread's indices made opaque once a head, so that nothing derived
    // from them is hoisted out of the tile loop and held through the
    // products (where it made ptxas spill their accumulators)
    int r0 = r0_, t = t_, wg = threadIdx.x >> 7;
    asm volatile("" : "+r"(r0), "+r"(t), "+r"(wg));
    uint8_t* qlo = smem + T::RING + wg * 2 * KH;  // this warpgroup's Q_lo tile
    uint32_t qh[8][4];
    if (active) {  // (the last head's products that read Q_lo are done: qk waits for them)
      load_q(q + h * D, ld, r0, r0 & 63, rows, t, qh, qlo);
      fence_proxy_async();  // the wgmma reads Q_lo through the async proxy
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    }
    for (int sg = seg0; sg < seg0 + nseg; ++sg) {
      const int len = a.len[sg];
      float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      for (int k0 = 0; k0 < len; k0 += KEYS, it += 2) {
        const int sk = it % STAGES, sv = sk + 1;
        float s[32], alpha[2];
        stage_wait(full, it);  // the key tile's K and V^T
        if (active) qk(s, qh, qlo, smem + sk * T::STAGE + T::A_BYTES);
        if (active) {
          // thread holds rows r0 (+8), keys 8c + 2t + {0, 1}: s[4c + 2hh + e]
          const int valid = len - k0;
          float mx[2] = {m[0], m[1]}, ps[2] = {0.f, 0.f};
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = 8 * c + 2 * t + (e & 1) < valid ? s[4 * c + e] * a.scale : -INFINITY;
              s[4 * c + e] = v;
              mx[e >> 1] = fmaxf(mx[e >> 1], v);
            }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
            alpha[hh] = expf(m[hh] - mx[hh]);  // 0 at the first key tile
            m[hh] = mx[hh];
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float e = expf(s[i] - m[(i >> 1) & 1]);
            s[i] = e;
            ps[(i >> 1) & 1] += e;
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
        }
        if (active) {
          float ot[32];
          pv(ot, s, smem + sv * T::STAGE + T::A_BYTES);
#pragma unroll
          for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], ot[i]);
        }
        release(empty, sk, lane);
        release(empty, sv, lane);
      }
      if (!active) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* y = out + (size_t)(r0 + 8 * hh) * a.C + h * D + 2 * t;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float2 v = make_float2(o[4 * c + 2 * hh] / l[hh], o[4 * c + 2 * hh + 1] / l[hh]);
          if (sg > seg0) {  // the segments' normalised outputs summed
            const float2 w = *reinterpret_cast<const float2*>(y + 8 * c);
            v = make_float2(w.x + v.x, w.y + v.y);
          }
          *reinterpret_cast<float2*>(y + 8 * c) = v;
        }
      }
    }
  }
}

// ---- the producer ---------------------------------------------------------------

// The key tiles of segment `seg` of `sample` for head h, each on one
// barrier: K (hi, lo) into a stage's weight boxes and V^T (hi, lo) into the
// next stage's, both completing the first stage's `full` (the second's
// completes with an arrival, keeping its phases in step). A key tile starts
// at an even ring position: every product takes an even number of stages.
template <int TM>
__device__ __forceinline__ void produce_keys(const Maps& m, const Args& a, uint8_t* smem, uint64_t* full,
                                             uint64_t* empty, int& it, int seg, int sample, int h) {
  using T = Tile<TM>;
  static_assert(STAGES % 2 == 0, "key tiles take slot pairs");
  for (int k0 = 0; k0 < a.len[seg]; k0 += KEYS, it += 2) {
    const int s = it % STAGES;
    const uint32_t parity = ((it / STAGES) & 1) ^ 1;
    mbar_wait(&empty[s], parity);
    mbar_wait(&empty[s + 1], parity);
    mbar_expect_tx(&full[s], 8 * KH);
    mbar_arrive(&full[s + 1]);
    uint8_t* w = smem + s * T::STAGE + T::A_BYTES;
#pragma unroll
    for (int lo = 0; lo < 2; ++lo)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int z = sample + lo * a.samples[seg];
        tma_load_3d(w + (2 * lo + half) * KH, &m.k[seg], &full[s], h * D + 32 * half, k0, z);
        tma_load_3d(w + T::STAGE + (2 * lo + half) * KH, &m.vt[seg], &full[s], k0 + 32 * half, h * D, z);
      }
  }
}

template <int TM, bool MEGA>
__device__ void produce(const Maps& m, const Args& a, uint8_t* smem, uint64_t* full, uint64_t* empty,
                        uint64_t* ready) {
  using T = Tile<TM>;
  constexpr int BOX = T::HB * ROW;
  const int C = a.C, heads = C / D;
  const int row0 = blockIdx.x * TM;  // the block's slot in the scratch regions
  int it = 0;                        // stages issued so far: the ring position
  uint32_t rp = 0;                   // the parity of the next `ready` phase
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int bf = tile / a.q_tiles;
    for (int h = 0; h < heads; ++h) produce_keys<TM>(m, a, smem, full, empty, it, S_SELF, bf, h);
    for (int g = G_WO1; g <= (MEGA ? G_OUT : G_W2); ++g) {
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
      if (g == G_Q2)  // the cross-attention's key tiles, per head its segments
        for (int h = 0; h < heads; ++h)
          for (int sg = S_TEXT; sg < S_TEXT + a.nseg; ++sg)
            produce_keys<TM>(m, a, smem, full, empty, it, sg, bf / a.frames, h);
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
  const bool attends = wc == 0;             // TM 64: the first warpgroup runs the attention
  const size_t slot = (size_t)blockIdx.x * TM;
  float* hs = a.reg[R_H] + slot * C;
  float* bs = a.reg[R_B] + slot * 4 * C;
  float* ss = a.reg[R_S] + slot * C;
  int it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int bf = tile / a.q_tiles, q0 = (tile % a.q_tiles) * TM;
    const int rows = min(TM, a.N - q0);
    const size_t tok0 = (size_t)bf * a.N + q0;
    for (int g = G_WO1; g <= (MEGA ? G_OUT : G_W2); ++g) {
      // the pass that writes this product's A rows (after the last product's
      // epilogue writes, which it may read)
      consumer_sync();
      if (g == G_WO1) {
        attention<TM>(a, smem, full, empty, it, S_SELF, 1, a.qkv + tok0 * 3 * C, 3 * (size_t)C, rows, hs, attends, r0,
                      t4, lane);
      } else if (g == G_Q2 || g == G_W1) {
        const int i = g == G_Q2 ? 0 : 1;
        layer_norm<TM>([&](int r) { return ss + (size_t)r * C; }, rows, C, a.ln_w[i], a.ln_b[i], a.eps, hs);
      } else if (g == G_WO2) {
        attention<TM>(a, smem, full, empty, it, S_TEXT, a.nseg, bs, 4 * (size_t)C, rows, hs, attends, r0, t4, lane);
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

        // ---- epilogue (temporal_f32.cu's): rows r0 (+8), for each 8-column
        // group c columns 8c + 2(l%4) + {0, 1}: acc[4c + 2h + {0, 1}]
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
          if (g == G_Q2 || g == G_W1) {
            y = bs + (size_t)r * 4 * C;
          } else if (g == G_WO1) {  // the block's first residual is its input
            if (!valid) continue;
            y = ss + (size_t)r * C;
            res = a.h + (tok0 + r) * C;
          } else if (g == G_WO2 || (g == G_W2 && MEGA)) {
            y = ss + (size_t)r * C;
            res = y;
          } else if (g == G_W2) {  // kernel 11's output
            if (!valid) continue;
            y = a.out + (tok0 + r) * C;
            res = ss + (size_t)r * C;
          } else {  // G_OUT: y = x + h @ W_out + b_out
            if (!valid) continue;
            y = a.out + (tok0 + r) * C;
            res = a.x + (tok0 + r) * C;
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

// MEGA = false: kernel 11's body; MEGA = true: kernel 13's
template <int TM, bool MEGA>
__global__ void __launch_bounds__(THREADS, 1)
spatial_tc_f32_kernel(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
                                             ~uintptr_t(SMEM_ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile<TM>::RING + QLO_BYTES<TM>);  // TMA landed
  uint64_t* empty = full + STAGES;   // the consumers are done
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
        cudaFuncSetAttribute(spatial_tc_f32_kernel<TM, MEGA>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  spatial_tc_f32_kernel<TM, MEGA><<<blocks, THREADS, smem_bytes<TM>(), stream>>>(m, a);
  return cudaGetLastError();
}

const float* f(const void* p) { return static_cast<const float*>(p); }

// The floats of a segment's split keys and values: [2, samples, len, C] and [2, samples, C, lpad].
long long kv_floats(int samples, int len, int C) { return 2LL * samples * C * (len + key_pad(len)); }

int spatial_run(const void* const* p, bool mega, int BF, int N, int C, int frames, int Lt, int Li, float scale,
                float eps, void* scratch, long long scratch_floats, int slots, int tm, void* stream) {
  if (C % 64 || C < 64 || C > 640 || BF <= 0 || N <= 0 || N % 16 || frames <= 0 || BF % frames || Lt <= 0 ||
      Li < 0 || slots <= 0 || scratch == nullptr || (tm != 128 && tm != 64) || (Li > 0 && p[4] == nullptr) ||
      (mega && p[1] == nullptr))
    return (int)cudaErrorInvalidValue;
  const int q_tiles = (N + tm - 1) / tm, clips = BF / frames;
  const long long tiles = (long long)q_tiles * BF;
  Args a{};
  a.nseg = Li > 0 ? 2 : 1;
  const int len[N_SEGS] = {N, Lt, Li}, samples[N_SEGS] = {BF, clips, clips};
  const long long rows = (long long)slots * tm;
  long long need = rows * 6 * C;
  for (int s = 0; s <= a.nseg; ++s) need += kv_floats(samples[s], len[s], C);
  if (tiles > 0x7fffffff || slots > tiles || scratch_floats < need) return (int)cudaErrorInvalidValue;
  a.h = f(p[0]);
  a.x = f(p[1]);
  a.qkv = f(p[2]);
  a.bias[G_WO1] = f(p[5]);
  a.ln_w[0] = f(p[6]);
  a.ln_b[0] = f(p[7]);
  a.bias[G_WO2] = f(p[8]);
  a.ln_w[1] = f(p[9]);
  a.ln_b[1] = f(p[10]);
  a.bias[G_W1] = f(p[11]);
  a.bias[G_W2] = f(p[12]);
  a.bias[G_OUT] = f(p[13]);
  a.out = static_cast<float*>(const_cast<void*>(p[14]));
  const void* w[N_GEMMS] = {p[15], p[16], p[17], p[18], p[19], mega ? p[20] : nullptr};
  a.N = N; a.C = C; a.frames = frames; a.q_tiles = q_tiles; a.tiles = (int)tiles;
  a.scale = scale; a.eps = eps;
  float* base = static_cast<float*>(scratch);
  a.reg[R_H] = base;
  a.reg[R_B] = base + rows * C;
  a.reg[R_S] = base + rows * 5 * C;

  Maps m;
  memset(&m, 0, sizeof(m));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* kv = base + rows * 6 * C;
  const void* src[N_SEGS] = {p[2], p[3], p[4]};
  for (int s = 0; s <= a.nseg; ++s) {  // the segments' keys and values split, and their maps
    const int L = len[s], lpad = key_pad(L), B2 = 2 * samples[s];
    a.len[s] = L;
    a.samples[s] = samples[s];
    float* ks = kv;
    float* vt = ks + (long long)B2 * L * C;
    kv += kv_floats(samples[s], L, C);
    const int ld = s == S_SELF ? 3 * C : 2 * C, kc = s == S_SELF ? C : 0;
    split_kv_kernel<<<dim3(lpad / KEYS, C / KEYS, samples[s]), 256, 0, st>>>(f(src[s]), ld, kc, kc + C, samples[s], L,
                                                                             lpad, C, ks, vt);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const cuuint64_t kdims[3] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)B2};
    const cuuint64_t kstrides[2] = {(cuuint64_t)C * 4, (cuuint64_t)L * C * 4};
    const cuuint64_t vdims[3] = {(cuuint64_t)lpad, (cuuint64_t)C, (cuuint64_t)B2};
    const cuuint64_t vstrides[2] = {(cuuint64_t)lpad * 4, (cuuint64_t)C * lpad * 4};
    const cuuint32_t box[3] = {32, KEYS, 1};
    if (!make_map(&m.k[s], ks, 3, kdims, kstrides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
        !make_map(&m.vt[s], vt, 3, vdims, vstrides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return (int)cudaErrorInvalidValue;
  }
  const int hb = BN / (2 * (tm == 128 ? 1 : 2));  // Tile<tm>::HB
  for (int g = G_WO1; g <= (mega ? G_OUT : G_W2); ++g) {  // W [2, N, K]: hi, then lo
    const int Ng = gemm_n(g, C), K = gemm_k(g, C);
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)Ng, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 4, (cuuint64_t)Ng * K * 4};
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
  cudaError_t e;
  if (tm == 128) e = mega ? launch<128, true>(m, a, slots, st) : launch<128, false>(m, a, slots, st);
  else e = mega ? launch<64, true>(m, a, slots, st) : launch<64, false>(m, a, slots, st);
  return (int)e;
}

}  // namespace

// p, fp32, every weight split for the tensor cores, [2, N, K]
// (ds_tf32_split's output): 0 h [T, C] (K11: x), 1 x [T, C] (K13 only), 2
// qkv [T, 3C], 3 kv_t [clips * Lt, 2C], 4 kv_i [clips * Li, 2C] (or null,
// Li 0), 5 bo1, 6 ln2_w, 7 ln2_b, 8 bo2, 9 ln3_w, 10 ln3_b, 11 b1 [8C], 12
// b2, 13 b_out (K13), 14 out [T, C]; 15 wo1 [2, C, C], 16 wq2 [2, C, C], 17
// wo2 [2, C, C], 18 w1 [2, 8C, C], 19 w2 [2, C, 4C], 20 w_out [2, C, C]
// (K13). T = BF * N tokens, samples of N tokens (N % 16 == 0), frames
// samples a clip, C <= 640. Query tiles of tm tokens of a sample (128 or 64,
// cuda_lib.spatial_f32_plan); `slots` blocks, at most one a tile; scratch:
// fp32, at least slots * tm * 6C floats (the regions) and each key
// segment's split keys and values (cuda_lib.spatial_f32_scratch). Every
// pointer 16-byte aligned and contiguous.
extern "C" int ds_spatial_block_f32(const void* const* p, int BF, int N, int C, int frames, int Lt, int Li, float scale,
                                    float eps, void* scratch, long long scratch_floats, int slots, int tm,
                                    void* stream) {
  return spatial_run(p, false, BF, N, C, frames, Lt, Li, scale, eps, scratch, scratch_floats, slots, tm, stream);
}

extern "C" int ds_mega_spatial_f32(const void* const* p, int BF, int N, int C, int frames, int Lt, int Li, float scale,
                                   float eps, void* scratch, long long scratch_floats, int slots, int tm,
                                   void* stream) {
  return spatial_run(p, true, BF, N, C, frames, Lt, Li, scale, eps, scratch, scratch_floats, slots, tm, stream);
}
