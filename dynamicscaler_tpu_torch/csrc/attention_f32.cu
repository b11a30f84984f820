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
// 128 % F == 0. A block takes 128 tokens (128 / F whole rows) of one head:
// their keys and values staged in shared memory (2 x 128 x 68 floats), a
// thread a query token with its q in registers, two passes over its row's
// keys (the largest logit, then the exponentials, their sum and the
// weighted values), the sum divided out at the end, FFMA and expf on the
// CUDA cores. What bounds it: bytes. At F = 16 a token does 16 x 64 x 6
// operations against 4 x 64 x 4 bytes read and written, about 6 operations a
// byte, far below the card's 20 for fp32; a quarter-warp's 8 threads read
// one key at a time (one row), so the shared-memory reads are broadcasts
// where F >= 8. (Kernels 10 and 12 run their own F-frame attention in
// temporal_f32.cu, and kernels 11 and 13 their N-token and cross-attention
// in spatial_f32.cu, inside their blocks.)
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
// flash: persistent blocks over (query tile, head, sample), TMA ring + tf32 wgmma
// ---------------------------------------------------------------------------

using namespace hopper;

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
