// Kernel 13: the whole SpatialTransformer (depth 1), and kernel 11: the
// whole spatial BasicTransformerBlock, each as two launches (after the
// context K/V projection, which the wrapper runs as csrc/gemm.cu's GEMM).
//
// Kernel 13 replaces dynamicscaler_tpu/ops/fused_mega.py::_s_mega_call
// (Pallas _s_mega_kernel):
//   h  = GN_apply(x) @ W_in + b_in                   (folded GroupNorm vectors)
//   h += out1(attn_N(LN1(h) @ [q|k|v]))              N-token self-attention
//   h += out2(attn_text(q2) + attn_image(q2))        q2 = LN2(h) @ Wq2
//   h += GEGLU(LN3(h)) @ W2 + b2
//   y  = x + (h @ W_out + b_out)
// over x [BF, N, C] bf16 (BF = clips * frames samples of N = H*W tokens,
// N % 16 == 0), head dim 64, C and Ci = 64 * heads up to 640, the context
// K/V [clips, Lt (+ Li), 2 Ci] projected once per clip.
// Kernel 11 replaces dynamicscaler_tpu/ops/fused_block.py::_spatial_block_call
// (Pallas _spatial_block_kernel): the same without the GroupNorm apply,
// proj_in and proj_out (h = x, y = h), C up to 640.
//
// What bounds them: operations. At s320, 32 samples of 2560 tokens: 268
// GFLOP of N x N attention, 346 of projections and FF (about 0.62 ms at 989
// TFLOP/s) against 105 MB of x in and out; at s640 (N = 640) the
// projections dominate (4 x 8 + 24 Ci^2 per token).
//
// Why two launches: a query tile cannot finish its self-attention before
// every token of its sample has its K and V, and a 2560 x 320 sample does
// not fit one SM. So
//   ds_mega_head (one block per TM-token row tile): [GN apply -> proj_in ->
//     h, kept for launch 2 as the residual] -> LN1 -> q|k|v, written to
//     device memory;
//   ds_mega_body (one block per TM-query tile of one sample, to the end; a
//     sample's last tile is ragged when N % TM != 0):
//     flash attention over the sample's K/V (online softmax, key tiles of 64
//     double-buffered by cp.async, exponentials rounded to bf16 for PV,
//     normalised after PV, as K2; raw mma.sync with S and P in registers,
//     each warp 16 query rows x a 64 / (8 / (TM / 16)) key share of every
//     key tile, the shares merged once per key segment) ->
//     out-proj + bias + h -> LN2 -> q2 -> cross-attention over exactly Lt
//     text keys and Li image keys (two softmaxes, summed; ragged key tiles
//     masked by length, nothing padded to 16 as the TPU operands were) ->
//     out-proj + residual -> LN3 -> the GEGLU FF in hidden chunks (value and
//     gate chunk products, GELU in the gate's epilogue, then the chunk's
//     share of the second product added into an fp32 accumulator in shared
//     memory) -> + b2 + residual -> [proj_out + b_out + x] -> the write.
// The context K/V is projected once per clip (the UNet repeats the context
// over the clip's frames; the TPU kernel projected it per frame sample) by
// the wrapper, with csrc/gemm.cu's GEMM, so any context width fits.
// A cooperative single launch with a grid barrier would save one pass of
// q|k|v through L2, but needs every tile resident at once (80 x samples
// tiles of 221 KB each, far more than 132 SMs hold); two launches need no
// such limit. The GroupNorm statistics are a pass of their own
// (gn_silu.cu::ds_gn_stats), as the JAX package leaves them to XLA outside
// its kernel. Every product is tile.cuh's 8-warp GEMM (mma.sync,
// a cp.async weight ring streaming across column chunks). No wgmma/TMA yet.
//
// Shared memory (the limit is 232,448 bytes a block; one block per SM):
//   body: Hs, Ns [TM][Ci+8] bf16 (the residual stream, the LN/attention-
//     output tile); a union of the attention area (a query tile [TM][Ci+8],
//     the double-buffered 64-key K/V tiles 36,864 B, one merge slot
//     (TM x 64 + 2 TM) fp32) and the FF area (fp32 accumulator [TM][Ci+4] +
//     hidden chunk [TM][HC+8]); the weight ring.
//     Ci <= 320: TM 64, HC 128, ring 2 x 128 x 72 (BK 64): 221,184 B at 320.
//     Ci <= 640: TM 32, HC 256, ring 2 x 256 x 40 (BK 32): 82,944 + 99,328
//     + 40,960 = 223,232 B at 640 (at TM 64 the FF accumulator alone would
//     be 165 KB).
//   head: [x tile [TM][C+8]], Hs, Ns [TM][Ci+8] + the ring: 162,816 B at C =
//     Ci = 320 (TM 64), 165,376 B at 640 (TM 32).
//
// Rounding points are the plain version's (kernel 13: kernels 7, 2, 3, 4, 8
// in sequence; kernel 11: 2, 3, 4): the GN-applied input (product and sum
// rounded separately, as fused_twrap's plain apply), every projection
// output, q/k/v, attention outputs, residual sums and GEGLU
// value/gate/product are rounded to bf16.

#include "tile.cuh"

namespace {

using namespace dstile;

constexpr int D = 64;          // head dim
constexpr int FK = 64;         // keys per flash tile
constexpr int LDH = D + 8;     // bf16 pitch of a head tile

struct HeadArgs {
  const bf16* x;        // [T, C]
  const float* mul;     // [BF, C] folded GroupNorm vectors (kernel 13)
  const float* add;
  const bf16* w_in;     // [Ci, C]
  const float* b_in;
  const float* ln1_w;
  const float* ln1_b;
  const bf16* wqkv;     // [3Ci, Ci]
  bf16* h;              // [T, Ci] (kernel 13)
  bf16* qkv;            // [T, 3Ci]
  int T, N, C, Ci;
  float eps;
  bool wrap;            // kernel 13: GN apply + proj_in; kernel 11: h = x
};

struct BodyArgs {
  const bf16* x;
  bf16* out;            // [T, C]
  const bf16* h;        // the residual stream after proj_in (x for kernel 11)
  const bf16* qkv;
  const bf16* wo1;      // [Ci, Ci]
  const float* bo1;
  const float* ln2_w;
  const float* ln2_b;
  const bf16* wq2;      // [Ci, Ci]
  const bf16* kv[2];    // text, image K|V [clips * L_s, 2Ci]
  int len[2];           // Lt, Li (0 without image keys)
  const bf16* wo2;
  const float* bo2;
  const float* ln3_w;
  const float* ln3_b;
  const bf16* w1;       // [8Ci, Ci]
  const float* b1;
  const bf16* w2;       // [Ci, 4Ci]
  const float* b2;
  const bf16* w_out;    // [C, Ci] (kernel 13)
  const float* b_out;
  int T, N, C, Ci, frames;
  float scale, eps;
  bool wrap;            // kernel 13: proj_out + x; kernel 11: y = h
};

template <int TM, int BK>
int head_smem(int C, int Ci, bool wrap) { return TM * ((wrap ? C + 8 : 0) + 2 * (Ci + 8)) * 2 + Tile<TM, BK>::RING; }

// body layout: Hs, Ns [TM][Ci+8] bf16; a union of the attention area (a query
// tile [TM][Ci+8] bf16, the double-buffered K/V tiles and the flash merge
// slot) and the FF area (fp32 accumulator [TM][Ci+4] + hidden chunk
// [TM][hc+8] bf16); then the GEMM weight ring
constexpr int KV_BYTES = 2 * 2 * FK * LDH * 2;
__host__ __device__ constexpr int hidden_chunk(int tm) { return tm == 64 ? 128 : 256; }
__host__ __device__ int attn_area(int Ci, int tm) { return tm * (Ci + 8) * 2 + KV_BYTES + (tm * D + 2 * tm) * 4; }
__host__ __device__ int ff_area(int Ci, int tm) { return tm * (Ci + 4) * 4 + tm * (hidden_chunk(tm) + 8) * 2; }
__host__ __device__ int body_union(int Ci, int tm) {
  return attn_area(Ci, tm) > ff_area(Ci, tm) ? attn_area(Ci, tm) : ff_area(Ci, tm);
}
template <int TM, int BK>
int body_smem(int Ci) { return 2 * TM * (Ci + 8) * 2 + body_union(Ci, TM) + Tile<TM, BK>::RING; }

// ---------------------------------------------------------------------------
// launch 1: [GN apply -> proj_in ->] LN1 -> q|k|v
// ---------------------------------------------------------------------------

template <int TM, int BK>
__global__ void __launch_bounds__(THREADS) mega_head_kernel(HeadArgs a) {
  using G = Tile<TM, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, Ci = a.Ci, ldh = Ci + 8;
  const int t0 = blockIdx.x * TM;
  const int T = a.T;
  bf16* Hs = reinterpret_cast<bf16*>(smem);
  bf16* Ns = Hs + TM * ldh;
  bf16* Xs = Ns + TM * ldh;  // kernel 13's GroupNorm-applied input
  unsigned char* ring = reinterpret_cast<unsigned char*>(Xs + (a.wrap ? TM * (C + 8) : 0));

  if (a.wrap) {
    // GroupNorm apply with the vectors of each row's sample (a tile may
    // straddle samples), product and sum rounded separately
    const int ldx = C + 8, cv = C / 8;
    for (int i = threadIdx.x; i < TM * cv; i += THREADS) {
      const int r = i / cv;
      const int c = (i - r * cv) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t0 + r < T) {
        v = *reinterpret_cast<const uint4*>(a.x + (size_t)(t0 + r) * C + c);
        const size_t g = (size_t)((t0 + r) / a.N) * C + c;
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q) e[q] = f2bf(__fadd_rn(__fmul_rn(bf2f(e[q]), a.mul[g + q]), a.add[g + q]));
      }
      *reinterpret_cast<uint4*>(Xs + r * ldx + c) = v;
    }
    const float* b_in = a.b_in;
    bf16* hg = a.h;
    gemm_cols<G>(Xs, ldx, C, a.w_in, C, Ci, ring, [&](int r, int c, float v) {
      const bf16 y = f2bf(v + b_in[c]);
      Hs[r * ldh + c] = y;
      if (t0 + r < T) hg[(size_t)(t0 + r) * Ci + c] = y;
    });
  } else {
    const int hv = Ci / 8;
    for (int i = threadIdx.x; i < TM * hv; i += THREADS) {
      const int r = i / hv;
      const int c = (i - r * hv) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t0 + r < T) v = *reinterpret_cast<const uint4*>(a.x + (size_t)(t0 + r) * Ci + c);
      *reinterpret_cast<uint4*>(Hs + r * ldh + c) = v;
    }
    __syncthreads();
  }
  layer_norm_rows<TM>(Hs, ldh, Ns, ldh, Ci, a.ln1_w, a.ln1_b, a.eps);
  bf16* qkv = a.qkv;
  const int n3 = 3 * Ci;
  gemm_cols<G>(Ns, ldh, Ci, a.wqkv, Ci, n3, ring, [&](int r, int c, float v) {
    if (t0 + r < T) qkv[(size_t)(t0 + r) * n3 + c] = f2bf(v);
  });
}

// ---------------------------------------------------------------------------
// launch 2: attention, cross-attention, FF, [proj_out] per query tile
// ---------------------------------------------------------------------------

struct KeySeg {
  const bf16* k;  // row j of the segment at k + j * ld (head columns)
  const bf16* v;
  int ld;
  int len;
};

__device__ __forceinline__ unsigned pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

struct Flash {
  bf16* KV;      // 2 buffers x (K [FK][LDH], V [FK][LDH])
  float* merge;  // [TM][D] partial outputs + [TM] max + [TM] sum of one key share
};

// One head over the TM query rows of Qs (pitch ldq, the head's 64 columns):
// for each key segment an online-softmax pass over key tiles of 64; the
// segments' normalised outputs are summed; bf16 result into Out's head
// columns (pitch ldo). The 8 warps are TM / 16 row groups x NP = 8 / (TM /
// 16) key shares: warp w owns query rows 16 (w % (TM / 16)) and, of every
// key tile, the KP = 64 / NP keys of share w / (TM / 16) (32 at TM = 64, 16
// at TM = 32). S, the softmax and P stay in its registers (the m16n8k16
// accumulator layout is the A layout of the P V product), so a tile costs
// one barrier for its K/V (double-buffered cp.async, ragged tails
// zero-filled) and one before its buffer is refilled. At the end of a
// segment the other shares' (max, sum, output) merge into share 0's, one at
// a time through one slot of shared memory (share 0 holds key 0, so its max
// is finite). Exponentials are rounded to bf16 for P V and the sum is taken
// before the rounding and divided out after P V, as K2 does. (Warps of 32
// rows x 16 keys, which load half the fragments per MMA, ran out of
// registers and measured slower.) Ends synchronised.
template <int TM>
__device__ void flash_head(const bf16* Qs, int ldq, const KeySeg* segs, int nseg, float scale, bf16* Out,
                           int ldo, const Flash& f) {
  constexpr int RG = TM / 16;   // row groups
  constexpr int NP = 8 / RG;    // key shares
  constexpr int KP = FK / NP;   // keys per share
  constexpr int NJ = KP / 8;    // S column fragments
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = (warp % RG) * 16;  // query rows of this warp
  const int share = warp / RG;
  const int kh = share * KP;        // its keys within a tile
  const int g = lane >> 2, t = lane & 3;
  bf16* Ks[2] = {f.KV, f.KV + 2 * FK * LDH};
  bf16* Vs[2] = {f.KV + FK * LDH, f.KV + 3 * FK * LDH};

  __syncthreads();  // the query tile is written
  unsigned qa[4][4];  // Q fragments: 16 rows x 64 dims
#pragma unroll
  for (int kd = 0; kd < 4; ++kd) ldsm_x4(qa[kd], Qs + (r0 + (lane & 15)) * ldq + kd * 16 + (lane >> 4) * 8);

  float fin[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) fin[n][e] = 0.f;

  for (int sg = 0; sg < nseg; ++sg) {
    const KeySeg seg = segs[sg];
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8

    auto load_tile = [&](int buf, int k0) {
      for (int idx = tid; idx < FK * (D / 8); idx += THREADS) {
        const int r = idx >> 3;
        const int col = (idx & 7) * 8;
        const bool ok = k0 + r < seg.len;
        const size_t off = ok ? (size_t)(k0 + r) * seg.ld + col : 0;
        cp_async16_zfill(Ks[buf] + r * LDH + col, seg.k + off, ok);
        cp_async16_zfill(Vs[buf] + r * LDH + col, seg.v + off, ok);
      }
    };
    const int ntiles = (seg.len + FK - 1) / FK;
    load_tile(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < ntiles; ++kt) {
      if (kt + 1 < ntiles) {
        load_tile((kt + 1) & 1, (kt + 1) * FK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* K = Ks[kt & 1];
      const bf16* V = Vs[kt & 1];

      float sc[NJ][4];  // S: 16 rows x this warp's KP keys
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
#pragma unroll
        for (int kb = 0; kb < KP; kb += 16) {
          unsigned b[4];
          ldsm_x4(b, K + (kh + kb + (lane & 7) + ((lane >> 4) << 3)) * LDH + kd * 16 + ((lane >> 3) & 1) * 8);
          mma16816(sc[kb / 8], qa[kd], b);
          mma16816(sc[kb / 8 + 1], qa[kd], b + 2);
        }

      const int valid = seg.len - kt * FK;  // keys of this tile in the segment (may exceed 64)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kh + j * 8 + 2 * t + (e & 1);
          sc[j][e] = key < valid ? sc[j][e] * scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = mx[h] == -INFINITY ? 1.f : expf(m[h] - mx[h]);  // 0 on the first tile
      }
      unsigned pa[NJ / 2][4];  // P as the A operand of P V, KP / 16 k16 steps
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = sc[j][e] == -INFINITY ? 0.f : expf(sc[j][e] - mx[e >> 1]);
          sum[e >> 1] += p[e];
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf2(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf2(p[2], p[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
        m[h] = mx[h];
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk)
#pragma unroll
        for (int nd = 0; nd < 4; ++nd) {
          unsigned b[4];
          ldsm_x4_t(b, V + (kh + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + nd * 16 + (lane >> 4) * 8);
          mma16816(o[2 * nd], pa[kk], b);
          mma16816(o[2 * nd + 1], pa[kk], b + 2);
        }
      __syncthreads();  // every warp is done with this buffer before it is refilled
    }

    // merge the other key shares into share 0, one at a time, then add the
    // normalised output
    float* mo = f.merge;
    float* mm = mo + TM * D;
    float* ml = mm + TM;
    const int ra = r0 + g, rb = r0 + g + 8;
    for (int sh = 1; sh < NP; ++sh) {
      if (share == sh) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = n * 8 + 2 * t;
          mo[ra * D + c] = o[n][0];
          mo[ra * D + c + 1] = o[n][1];
          mo[rb * D + c] = o[n][2];
          mo[rb * D + c + 1] = o[n][3];
        }
        if (t == 0) {
          mm[ra] = m[0];
          mm[rb] = m[1];
          ml[ra] = l[0];
          ml[rb] = l[1];
        }
      }
      __syncthreads();
      if (share == 0) {
        float wa[2], wb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? rb : ra;
          const float m2 = mm[r];
          const float mt = fmaxf(m[h], m2);
          wa[h] = expf(m[h] - mt);
          wb[h] = m2 == -INFINITY ? 0.f : expf(m2 - mt);
          l[h] = l[h] * wa[h] + ml[r] * wb[h];
          m[h] = mt;
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = n * 8 + 2 * t;
          o[n][0] = o[n][0] * wa[0] + mo[ra * D + c] * wb[0];
          o[n][1] = o[n][1] * wa[0] + mo[ra * D + c + 1] * wb[0];
          o[n][2] = o[n][2] * wa[1] + mo[rb * D + c] * wb[1];
          o[n][3] = o[n][3] * wa[1] + mo[rb * D + c + 1] * wb[1];
        }
      }
      __syncthreads();  // the slot is read before the next share writes it
    }
    if (share == 0) {
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        fin[n][0] += o[n][0] * inv[0];
        fin[n][1] += o[n][1] * inv[0];
        fin[n][2] += o[n][2] * inv[1];
        fin[n][3] += o[n][3] * inv[1];
      }
    }
  }
  if (share == 0) {
    const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(Out + ra * ldo + c) = __floats2bfloat162_rn(fin[n][0], fin[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(Out + rb * ldo + c) = __floats2bfloat162_rn(fin[n][2], fin[n][3]);
    }
  }
  __syncthreads();
}

template <int TM, int BK>
__global__ void __launch_bounds__(THREADS) mega_body_kernel(BodyArgs a) {
  using G = Tile<TM, BK>;
  constexpr int HC = hidden_chunk(TM);
  constexpr int LDI = HC + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, Ci = a.Ci, ldh = Ci + 8, heads = Ci / D;
  const int tiles = (a.N + TM - 1) / TM;    // query tiles per sample
  const int sample = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - sample * tiles) * TM;
  const int t0 = sample * a.N + q0;
  const int rows = min(TM, a.N - q0);      // queries of this tile
  const int clip = sample / a.frames;
  bf16* Hs = reinterpret_cast<bf16*>(smem);
  bf16* Ns = Hs + TM * ldh;
  unsigned char* U = reinterpret_cast<unsigned char*>(Ns + TM * ldh);
  bf16* Qa = reinterpret_cast<bf16*>(U);     // query tile: [TM][LDH] (self), [TM][ldh] (cross)
  unsigned char* ring = U + body_union(Ci, TM);
  const Flash fl{reinterpret_cast<bf16*>(U + TM * ldh * 2),
                 reinterpret_cast<float*>(U + TM * ldh * 2 + KV_BYTES)};
  float* Acc = reinterpret_cast<float*>(U);  // FF: [TM][Ci+4] fp32, then the hidden chunk
  const int lda = Ci + 4;
  bf16* Is = reinterpret_cast<bf16*>(U + TM * lda * 4);
  const int n3 = 3 * Ci, hv = Ci / 8;

  for (int i = threadIdx.x; i < TM * hv; i += THREADS) {
    const int r = i / hv;
    const int c = (i - r * hv) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const uint4*>(a.h + (size_t)(t0 + r) * Ci + c);
    *reinterpret_cast<uint4*>(Hs + r * ldh + c) = v;
  }

  // self-attention over the sample's N tokens
  const bf16* kbase = a.qkv + (size_t)sample * a.N * n3;
  for (int hh = 0; hh < heads; ++hh) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < TM * (D / 8); idx += THREADS) {
      const int r = idx >> 3;
      const int col = (idx & 7) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows) v = *reinterpret_cast<const uint4*>(a.qkv + (size_t)(t0 + r) * n3 + hh * D + col);
      *reinterpret_cast<uint4*>(Qa + r * LDH + col) = v;
    }
    const KeySeg seg{kbase + Ci + hh * D, kbase + 2 * Ci + hh * D, n3, a.N};
    flash_head<TM>(Qa, LDH, &seg, 1, a.scale, Ns + hh * D, ldh, fl);
  }
  const float* bo1 = a.bo1;
  gemm_cols<G>(Ns, ldh, Ci, a.wo1, Ci, Ci, ring, [&](int r, int c, float v) {
    bf16& d = Hs[r * ldh + c];
    d = f2bf(bf2f(d) + round_bf(v + bo1[c]));
  });

  // cross-attention: text keys, then image keys, of this sample's clip
  layer_norm_rows<TM>(Hs, ldh, Ns, ldh, Ci, a.ln2_w, a.ln2_b, a.eps);
  gemm_cols<G>(Ns, ldh, Ci, a.wq2, Ci, Ci, ring, [&](int r, int c, float v) { Qa[r * ldh + c] = f2bf(v); });
  const int n2 = 2 * Ci;
  for (int hh = 0; hh < heads; ++hh) {
    KeySeg segs[2];
    int nseg = 0;
    for (int s = 0; s < 2; ++s) {
      if (a.len[s] == 0) continue;
      const bf16* kv = a.kv[s] + (size_t)clip * a.len[s] * n2;
      segs[nseg++] = KeySeg{kv + hh * D, kv + Ci + hh * D, n2, a.len[s]};
    }
    flash_head<TM>(Qa + hh * D, ldh, segs, nseg, a.scale, Ns + hh * D, ldh, fl);
  }
  const float* bo2 = a.bo2;
  gemm_cols<G>(Ns, ldh, Ci, a.wo2, Ci, Ci, ring, [&](int r, int c, float v) {
    bf16& d = Hs[r * ldh + c];
    d = f2bf(bf2f(d) + round_bf(v + bo2[c]));
  });

  // GEGLU feed-forward in hidden chunks of HC columns
  layer_norm_rows<TM>(Hs, ldh, Ns, ldh, Ci, a.ln3_w, a.ln3_b, a.eps);
  for (int i = threadIdx.x; i < TM * lda; i += THREADS) Acc[i] = 0.f;
  const int H4 = 4 * Ci;
  const float* b1 = a.b1;
  for (int j0 = 0; j0 < H4; j0 += HC) {
    gemm_cols<G>(Ns, ldh, Ci, a.w1 + (size_t)j0 * Ci, Ci, HC, ring,
                 [&](int r, int c, float v) { Is[r * LDI + c] = f2bf(v + b1[j0 + c]); });
    gemm_cols<G>(Ns, ldh, Ci, a.w1 + (size_t)(H4 + j0) * Ci, Ci, HC, ring, [&](int r, int c, float v) {
      bf16& d = Is[r * LDI + c];
      d = f2bf(bf2f(d) * gelu_erf(round_bf(v + b1[H4 + j0 + c])));
    });
    gemm_cols<G>(Is, LDI, HC, a.w2 + j0, H4, Ci, ring, [&](int r, int c, float v) { Acc[r * lda + c] += v; });
  }
  for (int i = threadIdx.x; i < TM * Ci; i += THREADS) {
    const int r = i / Ci;
    const int c = i - r * Ci;
    bf16& d = Hs[r * ldh + c];
    d = f2bf(bf2f(d) + round_bf(Acc[r * lda + c] + a.b2[c]));
  }
  __syncthreads();

  bf16* out = a.out;
  if (a.wrap) {
    // proj_out + outer residual
    const float* b_out = a.b_out;
    const bf16* x = a.x;
    gemm_cols<G>(Hs, ldh, Ci, a.w_out, Ci, C, ring, [&](int r, int c, float v) {
      if (r < rows) {
        const size_t e = (size_t)(t0 + r) * C + c;
        out[e] = f2bf(bf2f(x[e]) + round_bf(v + b_out[c]));
      }
    });
  } else {
    for (int i = threadIdx.x; i < rows * hv; i += THREADS) {
      const int r = i / hv;
      const int c = (i - r * hv) * 8;
      *reinterpret_cast<uint4*>(out + (size_t)(t0 + r) * Ci + c) = *reinterpret_cast<const uint4*>(Hs + r * ldh + c);
    }
  }
}

template <int TM, int BK>
int launch(const HeadArgs& h, const BodyArgs& b, int BF, cudaStream_t s) {
  const int hs = head_smem<TM, BK>(h.C, h.Ci, h.wrap), bs = body_smem<TM, BK>(b.Ci);
  cudaError_t e = cudaFuncSetAttribute(mega_head_kernel<TM, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, hs);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(mega_body_kernel<TM, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bs);
  if (e != cudaSuccess) return (int)e;
  mega_head_kernel<TM, BK><<<(h.T + TM - 1) / TM, THREADS, hs, s>>>(h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mega_body_kernel<TM, BK><<<BF * ((b.N + TM - 1) / TM), THREADS, bs, s>>>(b);
  return (int)cudaGetLastError();
}

// kernels 13 (wrap) and 11: the pointer layout of ds_mega_spatial
int run(const void* const* p, bool wrap, int BF, int N, int C, int Ci, int frames, int Lt, int Li, float scale,
        float eps, void* stream) {
  if (N % 16 || N <= 0 || C % 64 || C > 640 || Ci % 64 || Ci > 640 || (!wrap && C != Ci) || frames <= 0 ||
      BF % frames || Lt <= 0 || Li < 0)
    return (int)cudaErrorInvalidValue;
  auto bf = [&](int i) { return static_cast<const bf16*>(p[i]); };
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  const int T = BF * N;
  bf16* hbuf = static_cast<bf16*>(const_cast<void*>(p[25]));

  HeadArgs h;
  h.x = bf(0); h.mul = f(1); h.add = f(2); h.w_in = bf(3); h.b_in = f(4);
  h.ln1_w = f(5); h.ln1_b = f(6); h.wqkv = bf(7);
  h.h = hbuf;
  h.qkv = static_cast<bf16*>(const_cast<void*>(p[26]));
  h.T = T; h.N = N; h.C = C; h.Ci = Ci; h.eps = eps; h.wrap = wrap;

  BodyArgs b;
  b.x = bf(0); b.out = static_cast<bf16*>(const_cast<void*>(p[27]));
  b.h = wrap ? hbuf : bf(0); b.qkv = h.qkv;
  b.wo1 = bf(8); b.bo1 = f(9); b.ln2_w = f(10); b.ln2_b = f(11); b.wq2 = bf(12);
  b.kv[0] = bf(13); b.kv[1] = bf(14); b.len[0] = Lt; b.len[1] = Li;
  b.wo2 = bf(15); b.bo2 = f(16); b.ln3_w = f(17); b.ln3_b = f(18);
  b.w1 = bf(19); b.b1 = f(20); b.w2 = bf(21); b.b2 = f(22); b.w_out = bf(23); b.b_out = f(24);
  b.T = T; b.N = N; b.C = C; b.Ci = Ci; b.frames = frames; b.scale = scale; b.eps = eps; b.wrap = wrap;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (C > 320 || Ci > 320) ? launch<32, 32>(h, b, BF, s) : launch<64, 64>(h, b, BF, s);
}

}  // namespace

// p: device pointers, in order:
//  0 x [T, C] bf16       1 mul [BF, C] f32     2 add                3 w_in [Ci, C]   4 b_in
//  5 ln1_w  6 ln1_b      7 wqkv1 [3Ci, Ci]     8 wo1 [Ci, Ci]       9 bo1
// 10 ln2_w 11 ln2_b     12 wq2 [Ci, Ci]       13 kv_t [clips*Lt, 2Ci] (context K|V, per clip)
// 14 kv_i [clips*Li, 2Ci] (or null)
// 15 wo2   16 bo2       17 ln3_w 18 ln3_b     19 w1 [8Ci, Ci]      20 b1   21 w2 [Ci, 4Ci]  22 b2
// 23 w_out [C, Ci]      24 b_out
// scratch: 25 h [T, Ci]  26 qkv [T, 3Ci]
// 27 out [T, C]
// T = BF * N tokens, samples of N tokens, frames samples per clip.
// Shapes the caller guarantees: N % 16 == 0, C and Ci multiples of 64 up to
// 640, every pointer 16-byte aligned and contiguous.
extern "C" int ds_mega_spatial(const void* const* p, int BF, int N, int C, int Ci, int frames, int Lt, int Li,
                               float scale, float eps, void* stream) {
  return run(p, true, BF, N, C, Ci, frames, Lt, Li, scale, eps, stream);
}

// Kernel 11: the same pointer layout with 1-4, 23-25 unused (null); x and
// out [T, C], C == Ci.
extern "C" int ds_spatial_block(const void* const* p, int BF, int N, int C, int frames, int Lt, int Li,
                                float scale, float eps, void* stream) {
  return run(p, false, BF, N, C, C, frames, Lt, Li, scale, eps, stream);
}
