// Attention cores of the UNet transformer sub-blocks at fp32, head dim 64:
// the fp32 twins of attention.cu's ds_temporal_attention and
// ds_flash_attention (same C interfaces), for a model run in float32.
//
// The TPU kernels they replace compute in x.dtype, so at float32 nothing is
// rounded between the logits and the output:
//   dynamicscaler_tpu/ops/fused_temporal.py::_kernel       (K1, its attention)
//   dynamicscaler_tpu/ops/fused_spatial.py::_kernel        (K2, N up to 2560)
//   dynamicscaler_tpu/ops/fused_spatial.py::_cross_kernel  (K3, 77 text + 16 image keys)
//
// ds_temporal_attention_f32: F frame tokens per (row, head), 2 <= F <= 128,
// 128 % F == 0, qkv [R * F, 3C] (q | k | v, head h at column 64h of each).
// What bounds it: bytes. A token reads its q, k and v and writes its output,
// 1 KB a (token, head) at fp32, against 16 x 64 x 4 operations at F = 16
// (12 tf32 operations a byte as three products), far below the 148 a byte
// of the tensor cores' tf32 rate, so the design keeps a tile's copies in
// flight while the last one computes:
//   * a persistent grid of one 256-thread block an SM takes the items (a
//     tile of 128 tokens, a head) in turn, heads fastest;
//   * a ring of TA_STAGES slots, each the item's q, k and v [128, 64] in
//     padded rows, fed by cp.async (16 threads a 256-byte row of one head's
//     columns, zeros past the last token), the next item's copies in flight
//     while this one computes, one block barrier an item;
//   * at F 8 and 16 (the UNet's) a warp takes 16 tokens on the tensor cores,
//     mma.sync m16n8k8 .tf32 with the three-product split of hopper.cuh, as
//     kernels 10 and 12 run the same attention (temporal_f32.cu::
//     attention_tc); at any other F two threads a token on the CUDA cores,
//     an online softmax; each logit computed once;
//   * each warp writes its 16 output rows into its own q rows, then stores
//     them with 16-byte stores, 16 lanes a 256-byte row.
// chip_tf32_variants.py ta times a ring of 3 slots against 2 (PERF.md).
//
// ds_flash_attention_f32: q rows with a pitch, up to two key segments each
// with its own softmax, the normalised outputs summed (the i2v dual
// text/image cross-attention); a flash-attention forward on the tensor cores
// through the three-product tf32 split of hopper.cuh (x = hi + lo; a.b =
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi), built as attention.cu's bf16 flash is:
//   * a persistent grid (one block per SM) walks the tiles of 128 query rows
//     of one (sample, head), query tiles fastest (the blocks in flight share
//     their K and V in L2); two consumer warpgroups of 64 rows each and a
//     producer warpgroup (384 threads; setmaxnreg moves the producer's spare
//     registers to the consumers);
//   * one producer thread loads each tile's Q and streams the K and V tiles
//     (64 keys) of every key segment by TMA into a ring of 2 slots on
//     mbarriers, running on across tiles; every operand has a 3-D tensor map
//     (32 columns of one head, row within the sample, sample; a head's 64
//     columns are two 128-byte swizzle rows), so a box never crosses into
//     the next sample's rows and a ragged tile arrives zero-filled;
//   * three splitter warps (the rest of the producer warpgroup) round each K
//     tile to tf32 in place and write its remainders beside it, and write V
//     transposed, split into hi and lo tiles: tf32 wgmma takes B K-major
//     only, and for O += P V the reduction runs over the keys, so V must lie
//     keys-contiguous (V^T), which no TMA box gives for 32-bit elements.
//     Within each group of 8 keys, key 2c sits at column c and key 2c + 1 at
//     column c + 4: the order in which S's accumulator registers hold a
//     thread's keys (2t, 2t + 1) is then the order of the m64k8 tf32 A
//     fragment (columns t, t + 4), so P goes from S's registers to wgmma with
//     no shuffle (the sum over keys does not depend on their order);
//   * each consumer warpgroup splits its 64 Q rows once a tile (hi in place,
//     lo beside it), then per key tile: S = Q K^T as 8 k8 steps x 3 wgmma
//     m64n64k8 with both operands in shared memory; the online softmax on the
//     accumulator registers (logits times the scale, then expf(s - max), as
//     the plain version computes them; logits past the segment's length
//     masked to -inf); P split in registers and O_tile = P V as 8 x 3 wgmma
//     m64n64k8 with A from registers, in two halves of 4 k8 steps (half the
//     fragment registers), into an accumulator started at zero that the
//     threads then fold into O in fp32 (O = O alpha + O_tile): the tensor
//     core rounds its additions towards zero, which over N = 2560 keys would
//     drift beyond fp32's error; the two warpgroups run independently on the
//     same slots, so one's softmax overlaps the other's products;
//   * the output goes straight from the registers to device memory (8 bytes a
//     thread, a quad's 32 bytes contiguous).
// What bounds it: operations at the self-attention's N = 2560 (4 N^2 64 a
// (sample, head): 1.07 TFLOP a batch-8 call, 6.5 ms as three tf32 products at
// 495 TFLOP/s), bytes at N <= 640 and in the cross-attention, which runs its
// 77 + 16 keys as two tiles and one of 64.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;  // head dim

// ---------------------------------------------------------------------------
// temporal: a persistent block an SM over (token tile, head), a cp.async ring
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int TA_TOK = 128;             // tokens a tile (whole F-frame rows: 128 % F == 0)
constexpr int TA_STAGES = 2;            // ring slots, each a tile's q, k and v of one head
constexpr int TA_THREADS = 2 * TA_TOK;  // a warp 16 tokens; two threads a token on the CUDA cores
constexpr int TA_QP = D + 4;            // floats of a q or k row in a slot (banks 4g + t)
constexpr int TA_VP = D + 8;            // floats of a v row (banks 8t + g)
constexpr int TA_SLOT = TA_TOK * (2 * TA_QP + TA_VP);  // floats of a slot
constexpr int TA_SMEM = TA_STAGES * TA_SLOT * 4;
static_assert(TA_SMEM <= 232448, "the ring fits the H100's shared memory");

// Ring slot `slot` <- the q, k and v of head h of tokens t0 .. t0 + TA_TOK - 1
// (zeros past T): a thread's 16-byte copies, 16 threads a 256-byte row.
__device__ __forceinline__ void ta_load(const float* __restrict__ qkv, long long T, int C, long long t0, int h,
                                        float* slot) {
  constexpr int STEP = TA_THREADS / 16;
  const int tok0 = threadIdx.x >> 4, c4 = (threadIdx.x & 15) * 4;
  float* qs = slot;
  float* ks = qs + TA_TOK * TA_QP;
  float* vs = ks + TA_TOK * TA_QP;
#pragma unroll
  for (int u = 0; u < TA_TOK / STEP; ++u) {
    const int r = tok0 + STEP * u;
    const bool in = t0 + r < T;
    const float* src = qkv + (size_t)(in ? t0 + r : 0) * 3 * C + h * D + c4;
    cp_async16_zfill(qs + r * TA_QP + c4, src, in);
    cp_async16_zfill(ks + r * TA_QP + c4, src + C, in);
    cp_async16_zfill(vs + r * TA_VP + c4, src + 2 * C, in);
  }
}

// The warp's 16 tokens at F 8 and 16 on the tensor cores (3xTF32), as
// temporal_f32.cu::attention_tc computes them: the warp's 16 tokens are its
// queries and keys (a row of 16 frames, or two of 8 with the other row's
// keys masked); S = q k^T in steps of 8 dims over two key tiles of 8, each
// step folded in fp32, the keys permuted within each 8 (position 2t holds
// key t, 2t + 1 key t + 4) so that S's registers are P's A fragment; every
// logit computed once and scaled, the row's maximum, expf against it and
// the sum over the lane quad; O = P V (two key steps, eight tiles of 8
// dims) times the sum's reciprocal, into the warp's q rows.
template <int FF>
__device__ __forceinline__ void ta_warp_tc(float* qw, const float* kw, const float* vw, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kp = (g >> 1) + (g & 1) * 4;  // the key at this lane's B column g of a key tile
  float sc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = 8 * kk + t;
    uint32_t ah[4], al[4];
    split_tf32(qw[g * TA_QP + c], ah[0], al[0]);
    split_tf32(qw[(g + 8) * TA_QP + c], ah[1], al[1]);
    split_tf32(qw[g * TA_QP + c + 4], ah[2], al[2]);
    split_tf32(qw[(g + 8) * TA_QP + c + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float* kr = kw + (8 * n + kp) * TA_QP;
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
      sc[n][e] = FF == 16 || r == n ? sc[n][e] * scale : -INFINITY;  // F 8: the query's own row of 8
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
    const float* v0 = vw + (8 * n + t) * TA_VP;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) mma_3xtf32(o[dt], ph, pl, v0[8 * dt + g], v0[4 * TA_VP + 8 * dt + g]);
  }
  __syncwarp();  // every lane's q reads are done
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float il = 1.f / l[r];
    float* y = qw + (g + 8 * r) * TA_QP + 2 * t;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<float2*>(y + 8 * dt) = make_float2(o[dt][2 * r] * il, o[dt][2 * r + 1] * il);
  }
}

// A token at any other F on the CUDA cores: two threads a token (32 dims
// each; the pair's partial logits summed by a shuffle, so both hold the
// same logit), each logit computed once and scaled, an online softmax over
// the row's F keys (the running maximum, the sum and the weighted values
// rescaled by expf(m_old - m) where the maximum grows), the output over the
// sum into the token's q row.
__device__ __forceinline__ void ta_token_cc(float* qs, const float* ks, const float* vs, int F, float scale) {
  const int tok = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int kb = (tok / F) * F;  // the row's first token in the tile
  float* qr = qs + tok * TA_QP + half * 32;
  float q[32], o[32];
#pragma unroll
  for (int d = 0; d < 32; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(qr + d);
    q[d] = v.x; q[d + 1] = v.y; q[d + 2] = v.z; q[d + 3] = v.w;
  }
#pragma unroll
  for (int d = 0; d < 32; ++d) o[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < F; ++j) {
    const float* k = ks + (kb + j) * TA_QP + half * 32;
    float p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < 32; d += 4) {
      const float4 v = *reinterpret_cast<const float4*>(k + d);
      p4[0] = fmaf(q[d], v.x, p4[0]);
      p4[1] = fmaf(q[d + 1], v.y, p4[1]);
      p4[2] = fmaf(q[d + 2], v.z, p4[2]);
      p4[3] = fmaf(q[d + 3], v.w, p4[3]);
    }
    float s = (p4[0] + p4[1]) + (p4[2] + p4[3]);
    s = (s + __shfl_xor_sync(0xffffffffu, s, 1)) * scale;
    if (s > m) {
      const float a = expf(m - s);
      l *= a;
#pragma unroll
      for (int d = 0; d < 32; ++d) o[d] *= a;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
    const float* v = vs + (kb + j) * TA_VP + half * 32;
#pragma unroll
    for (int d = 0; d < 32; d += 4) {
      const float4 w = *reinterpret_cast<const float4*>(v + d);
      o[d] = fmaf(p, w.x, o[d]);
      o[d + 1] = fmaf(p, w.y, o[d + 1]);
      o[d + 2] = fmaf(p, w.z, o[d + 2]);
      o[d + 3] = fmaf(p, w.w, o[d + 3]);
    }
  }
  const float il = 1.f / l;
#pragma unroll
  for (int d = 0; d < 32; d += 4)
    *reinterpret_cast<float4*>(qr + d) = make_float4(o[d] * il, o[d + 1] * il, o[d + 2] * il, o[d + 3] * il);
}

// FF 16 or 8: the tensor cores; 0: the CUDA cores at any F. Items (tile,
// head), heads fastest, taken by the persistent blocks in turn; the ring
// holds the next TA_STAGES - 1 items' copies in flight while one computes.
template <int FF>
__global__ void __launch_bounds__(TA_THREADS, 1)
temporal_attn_f32_kernel(const float* __restrict__ qkv, long long T, int F, int C, float scale,
                         float* __restrict__ out) {
  extern __shared__ __align__(16) float ta_smem[];
  const int heads = C / D;
  const long long items = (T + TA_TOK - 1) / TA_TOK * heads;
  const long long step = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long it = blockIdx.x;
#pragma unroll
  for (int s = 0; s < TA_STAGES - 1; ++s) {
    const long long i = it + s * step;
    if (i < items) ta_load(qkv, T, C, i / heads * TA_TOK, (int)(i % heads), ta_smem + s * TA_SLOT);
    cp_async_commit();
  }
  for (int slot = 0; it < items; it += step, slot = slot + 1 == TA_STAGES ? 0 : slot + 1) {
    const long long next = it + (TA_STAGES - 1) * step;
    const int ns = (slot + TA_STAGES - 1) % TA_STAGES;  // the slot computed an item ago
    if (next < items) ta_load(qkv, T, C, next / heads * TA_TOK, (int)(next % heads), ta_smem + ns * TA_SLOT);
    cp_async_commit();
    cp_async_wait<TA_STAGES - 1>();
    __syncthreads();  // every thread's copies of this item have landed
    float* qs = ta_smem + slot * TA_SLOT;
    const float* ks = qs + TA_TOK * TA_QP;
    const float* vs = ks + TA_TOK * TA_QP;
    const int r0 = warp * 16;  // the warp's tokens: its queries, and at F 8 and 16 its keys
    if (FF)
      ta_warp_tc<FF>(qs + r0 * TA_QP, ks + r0 * TA_QP, vs + r0 * TA_VP, scale);
    else
      ta_token_cc(qs, ks, vs, F, scale);
    __syncwarp();
    // the warp's 16 output rows from its q rows, 16 lanes a 256-byte row
    const long long t0 = it / heads * TA_TOK;
    const int h = (int)(it % heads);
#pragma unroll
    for (int i = lane; i < 16 * (D / 4); i += 32) {
      const int r = r0 + (i >> 4), c4 = (i & 15) * 4;
      if (t0 + r < T)
        *reinterpret_cast<float4*>(out + (size_t)(t0 + r) * C + h * D + c4) =
            *reinterpret_cast<const float4*>(qs + r * TA_QP + c4);
    }
    __syncthreads();  // the slot is free for the copies issued next
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// flash: persistent blocks over (query tile, head, sample), TMA ring + tf32 wgmma
// ---------------------------------------------------------------------------

constexpr int FQ = 128;               // query rows a tile: two consumer warpgroups of 64
constexpr int FK = 64;                // keys a tile
constexpr int F_SLOTS = 2;            // K/V ring depth
constexpr int F_THREADS = 384;        // warpgroups 0, 1 consume; thread 0 of warpgroup 2 produces, warps 9-11 split
constexpr int F_SPLITTERS = 96;
constexpr int F_CONSUMER_REGS = 224;
constexpr int F_PRODUCER_REGS = 56;   // 2 * 128 * 224 + 128 * 56 = 64512 of the 65536
constexpr int HALF = 32;              // floats of a 128-byte swizzle row: half a head row
constexpr int QH = FQ * 128;          // bytes of one half (32 of the 64 columns) of the Q tile
constexpr int KH = FK * 128;          // bytes of one half of a K, V or V^T tile
// a slot: K (raw, then hi; 2 halves), K lo, V raw, V^T hi, V^T lo (2 halves each, along the keys for V^T)
constexpr int SLOT_K = 0, SLOT_KLO = 2 * KH, SLOT_V = 4 * KH, SLOT_VTHI = 6 * KH, SLOT_VTLO = 8 * KH;
constexpr int F_SLOT = 10 * KH;
constexpr int F_SMEM_ALIGN = 1024;
constexpr int F_SMEM = F_SMEM_ALIGN + 4 * QH + F_SLOTS * F_SLOT + 8 * (2 + 3 * F_SLOTS);

struct FlashParams {
  int Nq, len0, len1, nseg, heads, q_tiles, tiles;
  float scale;
  float* out;
  int ldo;
};

// byte offset of (row r, column c) in a [rows][32] fp32 tile in the 128-byte swizzle
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((((c >> 2) ^ (r & 7))) << 4) + ((c & 3) << 2); }

// tile -> (query tile, head, sample), query tiles fastest
__device__ __forceinline__ void flash_tile(const FlashParams& p, int tile, int& q0, int& h, int& b) {
  q0 = (tile % p.q_tiles) * FQ;
  const int bh = tile / p.q_tiles;
  h = bh % p.heads;
  b = bh / p.heads;
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// O_tile = P V over 4 k8 steps j0 .. j0 + 3 of the tile's keys (the half j0 / 4
// of V^T): P from S's registers, split; the first product starts at zero
// where j0 == 0.
__device__ __forceinline__ void issue_pv_half(float (&ot)[32], const float (&sacc)[32], int j0, const uint8_t* slot) {
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = 4 * (j0 + j);  // S's 8 keys of k8 step j0 + j: (row g: q, q + 1; row g + 8: q + 2, q + 3)
    split_tf32(sacc[q], ph[j][0], pl[j][0]);
    split_tf32(sacc[q + 2], ph[j][1], pl[j][1]);
    split_tf32(sacc[q + 1], ph[j][2], pl[j][2]);
    split_tf32(sacc[q + 3], ph[j][3], pl[j][3]);
  }
  const uint64_t vh = smem_desc(slot + SLOT_VTHI + (j0 / 4) * KH);
  const uint64_t vl = smem_desc(slot + SLOT_VTLO + (j0 / 4) * KH);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    WgmmaTf32RegA<64>::mma(ot, pl[j], vh + 2 * j, j0 + j);
    WgmmaTf32RegA<64>::mma(ot, ph[j], vl + 2 * j, 1);
    WgmmaTf32RegA<64>::mma(ot, ph[j], vh + 2 * j, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(ot);
  fence_frags(ph);
  fence_frags(pl);
}

__global__ void __launch_bounds__(F_THREADS, 1)
flash_attn_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk0,
                      const __grid_constant__ CUtensorMap tv0, const __grid_constant__ CUtensorMap tk1,
                      const __grid_constant__ CUtensorMap tv1, const FlashParams p) {
  extern __shared__ uint8_t f_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(f_raw) + F_SMEM_ALIGN - 1) &
                                             ~uintptr_t(F_SMEM_ALIGN - 1));
  uint8_t* qs = smem;              // Q (raw, then hi): two halves of [128 rows][32]
  uint8_t* qlo = smem + 2 * QH;    // Q lo
  uint8_t* ring = smem + 4 * QH;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ring + F_SLOTS * F_SLOT);
  uint64_t* qempty = qfull + 1;
  uint64_t* full = qempty + 1;     // TMA landed
  uint64_t* ready = full + F_SLOTS;  // K split, V transposed and split
  uint64_t* empty = ready + F_SLOTS; // consumers done
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 8);  // one arrival per consumer warp
    for (int s = 0; s < F_SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], F_SPLITTERS / 32);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F_PRODUCER_REGS));
    if (tid == 0) {
      int it = 0, n = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++n) {
        int q0, h, b;
        flash_tile(p, tile, q0, h, b);
        mbar_wait(qempty, (n & 1) ^ 1);
        mbar_expect_tx(qfull, 2 * QH);
        tma_load_3d(qs, &tq, qfull, h * 64, q0, b);
        tma_load_3d(qs + QH, &tq, qfull, h * 64 + HALF, q0, b);
        for (int sg = 0; sg < p.nseg; ++sg) {
          const int len = sg ? p.len1 : p.len0;
          const CUtensorMap* mk = sg ? &tk1 : &tk0;
          const CUtensorMap* mv = sg ? &tv1 : &tv0;
          for (int k0 = 0; k0 < len; k0 += FK, ++it) {
            const int s = it % F_SLOTS;
            mbar_wait(&empty[s], ((it / F_SLOTS) & 1) ^ 1);
            uint8_t* slot = ring + s * F_SLOT;
            mbar_expect_tx(&full[s], 4 * KH);
            tma_load_3d(slot + SLOT_K, mk, &full[s], h * 64, k0, b);
            tma_load_3d(slot + SLOT_K + KH, mk, &full[s], h * 64 + HALF, k0, b);
            tma_load_3d(slot + SLOT_V, mv, &full[s], h * 64, k0, b);
            tma_load_3d(slot + SLOT_V + KH, mv, &full[s], h * 64 + HALF, k0, b);
          }
        }
      }
    } else if (tid >= 32) {
      // ---- splitters: K to tf32 in place and its remainders; V^T hi and lo ----
      const int sid = tid - 32, lane = tid & 31;
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int sg = 0; sg < p.nseg; ++sg) {
          const int len = sg ? p.len1 : p.len0;
          for (int k0 = 0; k0 < len; k0 += FK, ++it) {
            const int s = it % F_SLOTS;
            mbar_wait(&full[s], (it / F_SLOTS) & 1);
            uint8_t* slot = ring + s * F_SLOT;
            uint4* kh = reinterpret_cast<uint4*>(slot + SLOT_K);
            uint4* kl = reinterpret_cast<uint4*>(slot + SLOT_KLO);
            for (int i = sid; i < 2 * KH / 16; i += F_SPLITTERS) {
              const float4 v = *reinterpret_cast<const float4*>(kh + i);
              uint4 hi, lo;
              split_tf32(v.x, hi.x, lo.x);
              split_tf32(v.y, hi.y, lo.y);
              split_tf32(v.z, hi.z, lo.z);
              split_tf32(v.w, hi.w, lo.w);
              kh[i] = hi;
              kl[i] = lo;
            }
            // V^T: 16-byte chunk c4 of row d in key half kh2 holds the keys
            // 32 kh2 + 8 (c4 / 2) + 2e + (c4 % 2), e = 0..3
            for (int i = sid; i < 2 * KH / 16; i += F_SPLITTERS) {
              const int d = i & 63, c4 = (i >> 6) & 7, kh2 = i >> 9;
              const int key0 = kh2 * HALF + 8 * (c4 >> 1) + (c4 & 1);
              const uint8_t* vcol = slot + SLOT_V + (d >> 5) * KH;
              uint32_t hi[4], lo[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                split_tf32(*reinterpret_cast<const float*>(vcol + swz(key0 + 2 * e, d & 31)), hi[e], lo[e]);
              const int off = kh2 * KH + swz(d, 4 * c4);
              *reinterpret_cast<uint4*>(slot + SLOT_VTHI + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
              *reinterpret_cast<uint4*>(slot + SLOT_VTLO + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
            }
            fence_proxy_async();  // the wgmma reads them through the async proxy
            __syncwarp();
            if (lane == 0) mbar_arrive(&ready[s]);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F_CONSUMER_REGS));
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    float sacc[32], ot[32];  // a key tile's S, then its P V; each product chain starts at zero
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = ot[i] = 0.f;
    int it = 0, n = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++n) {
      int q0, h, b;
      flash_tile(p, tile, q0, h, b);
      mbar_wait(qfull, n & 1);
      // this warpgroup's 64 Q rows of both halves: hi in place, lo beside it
      for (int i = tid; i < 2 * 64 * 8; i += 128) {
        const int off = (i >> 9) * QH + wg * 64 * 128 + (i & 511) * 16;
        const float4 v = *reinterpret_cast<const float4*>(qs + off);
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(qs + off) = hi;
        *reinterpret_cast<uint4*>(qlo + off) = lo;
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      uint64_t qh[2], ql[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        qh[half] = smem_desc(qs + half * QH + wg * 64 * 128);
        ql[half] = smem_desc(qlo + half * QH + wg * 64 * 128);
      }
      float fin[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) fin[i] = 0.f;
      for (int sg = 0; sg < p.nseg; ++sg) {
        const int len = sg ? p.len1 : p.len0;
        float o[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] = 0.f;
        for (int k0 = 0; k0 < len; k0 += FK, ++it) {
          const int s = it % F_SLOTS;
          mbar_wait(&full[s], (it / F_SLOTS) & 1);
          mbar_wait(&ready[s], (it / F_SLOTS) & 1);
          const uint8_t* slot = ring + s * F_SLOT;
          // S = Q K^T over the 64 columns of the head, 8 k8 steps x 3 products
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int half = j >> 2, step = 2 * (j & 3);
            const uint64_t kd = smem_desc(slot + SLOT_K + half * KH) + step;
            const uint64_t kld = smem_desc(slot + SLOT_KLO + half * KH) + step;
            WgmmaTf32<64>::mma(sacc, ql[half] + step, kd, j);  // the tile's first product starts at zero
            WgmmaTf32<64>::mma(sacc, qh[half] + step, kld, 1);
            WgmmaTf32<64>::mma(sacc, qh[half] + step, kd, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(sacc);
          if (sg == p.nseg - 1 && k0 + FK >= len) {
            __syncwarp();  // the last product that reads Q is done: the producer may load the next tile's
            if (lane == 0) mbar_arrive(qempty);
          }
          // online softmax: thread holds rows g (+8), keys 8c + 2t + {0, 1}: sacc[4c + 2hh + e]
          const int valid = len - k0;
          float mx[2] = {m[0], m[1]};
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = 8 * c + 2 * t + (e & 1) < valid ? sacc[4 * c + e] * p.scale : -INFINITY;
              sacc[4 * c + e] = v;
              mx[e >> 1] = fmaxf(mx[e >> 1], v);
            }
          float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
            alpha[hh] = expf(m[hh] - mx[hh]);  // 0 on the first tile
            m[hh] = mx[hh];
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float e = expf(sacc[i] - m[(i >> 1) & 1]);
            sacc[i] = e;
            ps[(i >> 1) & 1] += e;
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
          issue_pv_half(ot, sacc, 0, slot);
          issue_pv_half(ot, sacc, 4, slot);
          if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
          for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], ot[i]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) fin[i] += o[i] / l[(i >> 1) & 1];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + wg * 64 + warp * 16 + g + 8 * hh;
        if (row >= p.Nq) continue;
        float* y = p.out + ((size_t)b * p.Nq + row) * p.ldo + h * 64 + 2 * t;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          *reinterpret_cast<float2*>(y + 8 * c) = make_float2(fin[4 * c + 2 * hh], fin[4 * c + 2 * hh + 1]);
      }
    }
  }
}

template <typename K>
cudaError_t size_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// one operand's map: [B, len, ld] fp32 rows, 32 of the columns of a head, box-row boxes
bool seg_map(CUtensorMap* map, const void* base, int B, int len, int ld, int width, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)len, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)len * ld * 4};
  const cuuint32_t box[3] = {(cuuint32_t)HALF, (cuuint32_t)box_rows, 1};
  return make_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

}  // namespace

// qkv: [R * F, 3C] fp32 (q | k | v columns, each head's 64 together), out:
// [R * F, C] fp32, C = heads * 64; 2 <= F <= 128, 128 % F == 0.
extern "C" int ds_temporal_attention_f32(const void* qkv, int R, int F, int C, int heads, float scale, void* out,
                                         void* stream) {
  if (R <= 0 || F < 2 || F > TA_TOK || TA_TOK % F || C != heads * D) return (int)cudaErrorInvalidValue;
  void (*kern)(const float*, long long, int, int, float, float*) =
      F == 16 ? temporal_attn_f32_kernel<16> : F == 8 ? temporal_attn_f32_kernel<8> : temporal_attn_f32_kernel<0>;
  static bool sized[3] = {false, false, false};
  const int which = F == 16 ? 0 : F == 8 ? 1 : 2;
  static int resident[3] = {0, 0, 0};
  if (!sized[which]) {
    cudaError_t e = size_smem(kern, TA_SMEM);
    int per = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, TA_THREADS, TA_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per < 1) return (int)cudaErrorInvalidConfiguration;
    resident[which] = per * hopper::sm_count();
    sized[which] = true;
  }
  const long long T = (long long)R * F;
  const long long items = (T + TA_TOK - 1) / TA_TOK * heads;
  const int grid = (int)(items < resident[which] ? items : resident[which]);
  kern<<<grid, TA_THREADS, TA_SMEM, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(qkv), T, F, C,
                                                                           scale, static_cast<float*>(out));
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
    const cudaError_t e = size_smem(flash_attn_f32_kernel, F_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int width = heads * D;
  CUtensorMap tq, tk0, tv0, tk1, tv1;
  bool ok = seg_map(&tq, q, B, Nq, ldq, width, FQ) && seg_map(&tk0, k0, B, len0, ld0, width, FK) &&
            seg_map(&tv0, v0, B, len0, ld0, width, FK);
  if (nseg == 2) {
    ok = ok && seg_map(&tk1, k1, B, len1, ld1, width, FK) && seg_map(&tv1, v1, B, len1, ld1, width, FK);
  } else {
    tk1 = tk0;
    tv1 = tv0;
  }
  if (!ok) return (int)bad;
  const int q_tiles = (Nq + FQ - 1) / FQ;
  const long long tiles = (long long)q_tiles * heads * B;
  if (tiles > 0x7fffffff) return (int)bad;
  FlashParams p{Nq, len0, nseg == 2 ? len1 : 0, nseg, heads, q_tiles, (int)tiles, scale, static_cast<float*>(out),
                ldo};
  const int grid = tiles < sm_count() ? (int)tiles : sm_count();
  flash_attn_f32_kernel<<<grid, F_THREADS, F_SMEM, static_cast<cudaStream_t>(stream)>>>(tq, tk0, tv0, tk1, tv1, p);
  return (int)cudaGetLastError();
}
