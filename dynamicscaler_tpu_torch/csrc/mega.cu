// Kernel 13: the whole SpatialTransformer (depth 1) in two launches.
//
// Replaces dynamicscaler_tpu/ops/fused_mega.py::_s_mega_call (Pallas
// _s_mega_kernel):
//   h  = GN_apply(x) @ W_in + b_in                   (folded GroupNorm vectors)
//   h += out1(attn_N(LN1(h) @ [q|k|v]))              N-token self-attention
//   h += out2(attn_text(q2) + attn_image(q2))        q2 = LN2(h) @ Wq2
//   h += GEGLU(LN3(h)) @ W2 + b2
//   y  = x + (h @ W_out + b_out)
// over x [BF, N, C] bf16 (BF = clips * frames samples of N = H*W tokens),
// head dim 64, Ci = 64 * heads <= 320, the context [clips, Lt (+ Li), Dc].
//
// What bounds it: operations. At s320, 32 samples of 2560 tokens: 268
// GFLOP of N x N attention, 346 of projections and FF (about 0.62 ms at 989
// TFLOP/s) against 105 MB of x in and out.
//
// Why two launches: a query tile cannot finish its self-attention before
// every token of its sample has its K and V, and a 2560 x 320 sample does
// not fit one SM. So
//   ds_mega_head (one block per 64-token row tile, plus one per 64 rows of
//     each context segment): GN apply -> proj_in -> h (kept for launch 2 as
//     the residual), LN1 -> q|k|v, written to device memory; the extra blocks
//     project the context's K|V ONCE PER CLIP (the UNet repeats the context
//     over the clip's frames; the TPU kernel projected it per frame sample);
//   ds_mega_body (one block per 64-query tile of one sample, to the end):
//     flash attention over the sample's K/V (online softmax, key tiles of 64
//     double-buffered by cp.async, exponentials rounded to bf16 for PV,
//     normalised after PV, as K2; raw mma.sync with S and P in registers,
//     each warp 16 query rows x half of every key tile, the two halves
//     merged once per key segment) ->
//     out-proj + bias + h -> LN2 -> q2 -> cross-attention over exactly Lt
//     text keys and Li image keys (two softmaxes, summed; ragged key tiles
//     masked by length, nothing padded to 16 as the TPU operands were) ->
//     out-proj + residual -> LN3 -> the GEGLU FF in hidden chunks of 128
//     (value and gate chunk products, GELU in the gate's epilogue, then the
//     chunk's share of the second product added into an fp32 accumulator in
//     shared memory) -> + b2 + residual -> proj_out + b_out + x -> the write.
// A cooperative single launch with a grid barrier would save one pass of
// q|k|v through L2, but needs every tile resident at once (80 x samples
// tiles of 221 KB each, far more than 132 SMs hold); two launches need no
// such limit. The GroupNorm statistics stay the plain group_norm_fold pass,
// as in the JAX package. Every product is tile.cuh's 8-warp GEMM (mma.sync,
// a cp.async weight ring streaming across column chunks). Shared memory of
// the body block at Ci = 320: 221 KB (the residual stream, the
// LN/attention-output tile, the union of the attention scratch and the FF
// accumulator, the weight ring), one block per SM. No wgmma/TMA yet.
//
// Rounding points are the plain version's (kernels 7, 2, 3, 4, 8 in
// sequence): the GN-applied input (product and sum rounded separately, as
// fused_twrap's plain apply), every projection output, q/k/v, attention
// outputs, residual sums and GEGLU value/gate/product are rounded to bf16.

#include "tile.cuh"

namespace {

using namespace dstile;

constexpr int TM = 64;         // tokens (query rows) per block
constexpr int D = 64;          // head dim
constexpr int FK = 64;         // keys per flash tile
constexpr int LDH = D + 8;     // bf16 pitch of a head tile
constexpr int HC = 128;        // GEGLU hidden columns per chunk
constexpr int LDI = HC + 8;

struct HeadArgs {
  const bf16* x;        // [T, C]
  const float* mul;     // [BF, C] folded GroupNorm vectors
  const float* add;
  const bf16* w_in;     // [Ci, C]
  const float* b_in;
  const float* ln1_w;
  const float* ln1_b;
  const bf16* wqkv;     // [3Ci, Ci]
  bf16* h;              // [T, Ci]
  bf16* qkv;            // [T, 3Ci]
  const bf16* ctx[2];   // per clip: [clips * L_s, Dc] text, image
  const bf16* wkv[2];   // [2Ci, Dc] k rows, then v rows
  bf16* kv[2];          // [clips * L_s, 2Ci]
  int ctx_rows[2];
  int T, N, C, Ci, Dc;
  float eps;
};

struct BodyArgs {
  const bf16* x;
  bf16* out;            // [T, C]
  const bf16* h;
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
  const bf16* w_out;    // [C, Ci]
  const float* b_out;
  int T, N, C, Ci, frames;
  float scale, eps;
};

int head_smem(int C, int Ci, int Dc) {
  const int rows = TM * (C + 8 + 2 * (Ci + 8));
  const int ctx = TM * (Dc + 8);
  return (rows > ctx ? rows : ctx) * 2 + Tile<TM>::RING;
}

// body layout: Hs, Ns [TM][Ci+8] bf16; a union of the attention area (a query
// tile [TM][Ci+8] bf16, the double-buffered K/V tiles and the flash merge
// area) and the FF area (fp32 accumulator [TM][Ci+4] + hidden chunk [TM][LDI]
// bf16); then the GEMM weight ring
constexpr int KV_BYTES = 2 * 2 * FK * LDH * 2;
constexpr int MERGE_BYTES = (TM * D + 2 * TM) * 4;
__host__ __device__ int attn_area(int Ci) { return TM * (Ci + 8) * 2 + KV_BYTES + MERGE_BYTES; }
__host__ __device__ int ff_area(int Ci) { return TM * (Ci + 4) * 4 + TM * LDI * 2; }
__host__ __device__ int body_union(int Ci) { return attn_area(Ci) > ff_area(Ci) ? attn_area(Ci) : ff_area(Ci); }
int body_smem(int Ci) { return 2 * TM * (Ci + 8) * 2 + body_union(Ci) + Tile<TM>::RING; }

// ---------------------------------------------------------------------------
// launch 1: GN apply -> proj_in -> LN1 -> q|k|v; the context K|V per clip
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) mega_head_kernel(HeadArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row_tiles = (a.T + TM - 1) / TM;
  const int t_tiles = (a.ctx_rows[0] + TM - 1) / TM;
  const int bid = blockIdx.x;

  if (bid >= row_tiles) {  // context K|V: 64 rows of one segment
    const int seg = bid - row_tiles < t_tiles ? 0 : 1;
    const int r0 = (bid - row_tiles - (seg ? t_tiles : 0)) * TM;
    const int rows = a.ctx_rows[seg];
    const int Dc = a.Dc, ldc = Dc + 8, dv = Dc / 8;
    bf16* As = reinterpret_cast<bf16*>(smem);
    unsigned char* ring = smem + TM * ldc * 2;
    for (int i = threadIdx.x; i < TM * dv; i += THREADS) {
      const int r = i / dv;
      const int c = (i - r * dv) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r0 + r < rows) v = *reinterpret_cast<const uint4*>(a.ctx[seg] + (size_t)(r0 + r) * Dc + c);
      *reinterpret_cast<uint4*>(As + r * ldc + c) = v;
    }
    __syncthreads();
    const int n2 = 2 * a.Ci;
    bf16* kv = a.kv[seg];
    gemm_cols<TM>(As, ldc, Dc, a.wkv[seg], Dc, n2, ring, [&](int r, int c, float v) {
      if (r0 + r < rows) kv[(size_t)(r0 + r) * n2 + c] = f2bf(v);
    });
    return;
  }

  const int C = a.C, Ci = a.Ci, ldx = C + 8, ldh = Ci + 8, cv = C / 8;
  const int t0 = bid * TM;
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Hs = Xs + TM * ldx;
  bf16* Ns = Hs + TM * ldh;
  unsigned char* ring = reinterpret_cast<unsigned char*>(Ns + TM * ldh);

  // GroupNorm apply with the vectors of each row's sample (a tile may
  // straddle samples when N % 64 != 0), product and sum rounded separately
  for (int i = threadIdx.x; i < TM * cv; i += THREADS) {
    const int r = i / cv;
    const int c = (i - r * cv) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t0 + r < a.T) {
      v = *reinterpret_cast<const uint4*>(a.x + (size_t)(t0 + r) * C + c);
      const size_t g = (size_t)((t0 + r) / a.N) * C + c;
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) e[q] = f2bf(__fadd_rn(__fmul_rn(bf2f(e[q]), a.mul[g + q]), a.add[g + q]));
    }
    *reinterpret_cast<uint4*>(Xs + r * ldx + c) = v;
  }
  __syncthreads();

  const float* b_in = a.b_in;
  bf16* hg = a.h;
  const int T = a.T;
  gemm_cols<TM>(Xs, ldx, C, a.w_in, C, Ci, ring, [&](int r, int c, float v) {
    const bf16 y = f2bf(v + b_in[c]);
    Hs[r * ldh + c] = y;
    if (t0 + r < T) hg[(size_t)(t0 + r) * Ci + c] = y;
  });
  layer_norm_rows<TM>(Hs, ldh, Ns, ldh, Ci, a.ln1_w, a.ln1_b, a.eps);
  bf16* qkv = a.qkv;
  const int n3 = 3 * Ci;
  gemm_cols<TM>(Ns, ldh, Ci, a.wqkv, Ci, n3, ring, [&](int r, int c, float v) {
    if (t0 + r < T) qkv[(size_t)(t0 + r) * n3 + c] = f2bf(v);
  });
}

// ---------------------------------------------------------------------------
// launch 2: attention, cross-attention, FF, proj_out per 64-query tile
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
  float* merge;  // [TM][D] partial outputs + [TM] max + [TM] sum of the second key half
};

// One head over the 64 query rows of Qs (pitch ldq, the head's 64 columns):
// for each key segment an online-softmax pass over key tiles of 64; the
// segments' normalised outputs are summed; bf16 result into Out's head
// columns (pitch ldo). Warp w owns query rows 16 (w % 4) and, of every key
// tile, keys 32 (w / 4) .. + 32: S, the softmax and P stay in its registers
// (the m16n8k16 accumulator layout is the A layout of the P V product), so a
// tile costs one barrier for its K/V (double-buffered cp.async, ragged tails
// zero-filled) and one before its buffer is refilled. At the end of a
// segment the second key half's (max, sum, output) merge into the first's
// through shared memory. Exponentials are rounded to bf16 for P V and the
// sum is taken before the rounding and divided out after P V, as K2 does.
// (Warps of 32 rows x 16 keys, which load half the fragments per MMA, ran
// out of registers and measured slower.) Ends synchronised.
__device__ void flash_head(const bf16* Qs, int ldq, const KeySeg* segs, int nseg, float scale, bf16* Out,
                           int ldo, const Flash& f) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = (warp & 3) * 16;   // query rows of this warp
  const int kh = (warp >> 2) * 32;  // its keys within a tile
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

      float sc[4][4];  // S: 16 rows x this warp's 32 keys
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
#pragma unroll
        for (int kb = 0; kb < 32; kb += 16) {
          unsigned b[4];
          ldsm_x4(b, K + (kh + kb + (lane & 7) + ((lane >> 4) << 3)) * LDH + kd * 16 + ((lane >> 3) & 1) * 8);
          mma16816(sc[kb / 8], qa[kd], b);
          mma16816(sc[kb / 8 + 1], qa[kd], b + 2);
        }

      const int valid = seg.len - kt * FK;  // keys of this tile in the segment (may exceed 64)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j)
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
      unsigned pa[2][4];  // P as the A operand of P V, two k16 steps
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int nd = 0; nd < 4; ++nd) {
          unsigned b[4];
          ldsm_x4_t(b, V + (kh + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDH + nd * 16 + (lane >> 4) * 8);
          mma16816(o[2 * nd], pa[kk], b);
          mma16816(o[2 * nd + 1], pa[kk], b + 2);
        }
      __syncthreads();  // every warp is done with this buffer before it is refilled
    }

    // merge the second key half into the first, then add the normalised output
    float* mo = f.merge;
    float* mm = mo + TM * D;
    float* ml = mm + TM;
    const int ra = r0 + g, rb = r0 + g + 8;
    if (kh) {
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
    if (!kh) {
      float wa[2], wb[2], inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? rb : ra;
        const float m2 = mm[r];
        const float mt = fmaxf(m[h], m2);
        wa[h] = expf(m[h] - mt);
        wb[h] = m2 == -INFINITY ? 0.f : expf(m2 - mt);
        inv[h] = 1.f / (l[h] * wa[h] + ml[r] * wb[h]);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n * 8 + 2 * t;
        fin[n][0] += (o[n][0] * wa[0] + mo[ra * D + c] * wb[0]) * inv[0];
        fin[n][1] += (o[n][1] * wa[0] + mo[ra * D + c + 1] * wb[0]) * inv[0];
        fin[n][2] += (o[n][2] * wa[1] + mo[rb * D + c] * wb[1]) * inv[1];
        fin[n][3] += (o[n][3] * wa[1] + mo[rb * D + c + 1] * wb[1]) * inv[1];
      }
    }
    __syncthreads();  // the merge area is read before the next segment writes it
  }
  if (!kh) {
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

__global__ void __launch_bounds__(THREADS) mega_body_kernel(BodyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, Ci = a.Ci, ldh = Ci + 8, heads = Ci / D;
  const int t0 = blockIdx.x * TM;           // N % 64 == 0: one sample per tile
  const int sample = t0 / a.N;
  const int clip = sample / a.frames;
  bf16* Hs = reinterpret_cast<bf16*>(smem);
  bf16* Ns = Hs + TM * ldh;
  unsigned char* U = reinterpret_cast<unsigned char*>(Ns + TM * ldh);
  bf16* Qa = reinterpret_cast<bf16*>(U);     // query tile: [TM][LDH] (self), [TM][ldh] (cross)
  unsigned char* ring = U + body_union(Ci);
  const Flash fl{reinterpret_cast<bf16*>(U + TM * ldh * 2),
                 reinterpret_cast<float*>(U + TM * ldh * 2 + KV_BYTES)};
  float* Acc = reinterpret_cast<float*>(U);  // FF: [TM][Ci+4] fp32, then the hidden chunk
  const int lda = Ci + 4;
  bf16* Is = reinterpret_cast<bf16*>(U + TM * lda * 4);
  const int n3 = 3 * Ci, hv = Ci / 8;

  for (int i = threadIdx.x; i < TM * hv; i += THREADS) {
    const int r = i / hv;
    const int c = (i - r * hv) * 8;
    *reinterpret_cast<uint4*>(Hs + r * ldh + c) = *reinterpret_cast<const uint4*>(a.h + (size_t)(t0 + r) * Ci + c);
  }

  // self-attention over the sample's N tokens
  const bf16* kbase = a.qkv + (size_t)sample * a.N * n3;
  for (int hh = 0; hh < heads; ++hh) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < TM * (D / 8); idx += THREADS) {
      const int r = idx >> 3;
      const int col = (idx & 7) * 8;
      *reinterpret_cast<uint4*>(Qa + r * LDH + col) =
          *reinterpret_cast<const uint4*>(a.qkv + (size_t)(t0 + r) * n3 + hh * D + col);
    }
    const KeySeg seg{kbase + Ci + hh * D, kbase + 2 * Ci + hh * D, n3, a.N};
    flash_head(Qa, LDH, &seg, 1, a.scale, Ns + hh * D, ldh, fl);
  }
  const float* bo1 = a.bo1;
  gemm_cols<TM>(Ns, ldh, Ci, a.wo1, Ci, Ci, ring, [&](int r, int c, float v) {
    bf16& d = Hs[r * ldh + c];
    d = f2bf(bf2f(d) + round_bf(v + bo1[c]));
  });

  // cross-attention: text keys, then image keys, of this sample's clip
  layer_norm_rows<TM>(Hs, ldh, Ns, ldh, Ci, a.ln2_w, a.ln2_b, a.eps);
  gemm_cols<TM>(Ns, ldh, Ci, a.wq2, Ci, Ci, ring, [&](int r, int c, float v) { Qa[r * ldh + c] = f2bf(v); });
  const int n2 = 2 * Ci;
  for (int hh = 0; hh < heads; ++hh) {
    KeySeg segs[2];
    int nseg = 0;
    for (int s = 0; s < 2; ++s) {
      if (a.len[s] == 0) continue;
      const bf16* kv = a.kv[s] + (size_t)clip * a.len[s] * n2;
      segs[nseg++] = KeySeg{kv + hh * D, kv + Ci + hh * D, n2, a.len[s]};
    }
    flash_head(Qa + hh * D, ldh, segs, nseg, a.scale, Ns + hh * D, ldh, fl);
  }
  const float* bo2 = a.bo2;
  gemm_cols<TM>(Ns, ldh, Ci, a.wo2, Ci, Ci, ring, [&](int r, int c, float v) {
    bf16& d = Hs[r * ldh + c];
    d = f2bf(bf2f(d) + round_bf(v + bo2[c]));
  });

  // GEGLU feed-forward in hidden chunks of HC columns
  layer_norm_rows<TM>(Hs, ldh, Ns, ldh, Ci, a.ln3_w, a.ln3_b, a.eps);
  for (int i = threadIdx.x; i < TM * lda; i += THREADS) Acc[i] = 0.f;
  const int H4 = 4 * Ci;
  const float* b1 = a.b1;
  for (int j0 = 0; j0 < H4; j0 += HC) {
    gemm_cols<TM>(Ns, ldh, Ci, a.w1 + (size_t)j0 * Ci, Ci, HC, ring,
                  [&](int r, int c, float v) { Is[r * LDI + c] = f2bf(v + b1[j0 + c]); });
    gemm_cols<TM>(Ns, ldh, Ci, a.w1 + (size_t)(H4 + j0) * Ci, Ci, HC, ring, [&](int r, int c, float v) {
      bf16& d = Is[r * LDI + c];
      d = f2bf(bf2f(d) * gelu_erf(round_bf(v + b1[H4 + j0 + c])));
    });
    gemm_cols<TM>(Is, LDI, HC, a.w2 + j0, H4, Ci, ring, [&](int r, int c, float v) { Acc[r * lda + c] += v; });
  }
  for (int i = threadIdx.x; i < TM * Ci; i += THREADS) {
    const int r = i / Ci;
    const int c = i - r * Ci;
    bf16& d = Hs[r * ldh + c];
    d = f2bf(bf2f(d) + round_bf(Acc[r * lda + c] + a.b2[c]));
  }
  __syncthreads();

  // proj_out + outer residual
  const float* b_out = a.b_out;
  const bf16* x = a.x;
  bf16* out = a.out;
  gemm_cols<TM>(Hs, ldh, Ci, a.w_out, Ci, C, ring, [&](int r, int c, float v) {
    const size_t e = (size_t)(t0 + r) * C + c;
    out[e] = f2bf(bf2f(x[e]) + round_bf(v + b_out[c]));
  });
}

}  // namespace

// p: device pointers, in order:
//  0 x [T, C] bf16       1 mul [BF, C] f32     2 add                3 w_in [Ci, C]   4 b_in
//  5 ln1_w  6 ln1_b      7 wqkv1 [3Ci, Ci]     8 wo1 [Ci, Ci]       9 bo1
// 10 ln2_w 11 ln2_b     12 wq2 [Ci, Ci]       13 wkv_t [2Ci, Dc]   14 wkv_i (or null)
// 15 wo2   16 bo2       17 ln3_w 18 ln3_b     19 w1 [8Ci, Ci]      20 b1   21 w2 [Ci, 4Ci]  22 b2
// 23 w_out [C, Ci]      24 b_out
// 25 ctx_t [clips*Lt, Dc]  26 ctx_i [clips*Li, Dc] (or null)
// scratch: 27 h [T, Ci]  28 qkv [T, 3Ci]  29 kv_t [clips*Lt, 2Ci]  30 kv_i (or null)
// 31 out [T, C]
// T = BF * N tokens, samples of N tokens, frames samples per clip.
// Shapes the caller guarantees: N % 64 == 0, C % 64 == 0, C <= 320,
// Ci % 64 == 0, Ci <= 320, Dc % 64 == 0, Dc <= 1024, every pointer 16-byte
// aligned and contiguous.
extern "C" int ds_mega_spatial(const void* const* p, int BF, int N, int C, int Ci, int frames, int Dc, int Lt,
                               int Li, float scale, float eps, void* stream) {
  if (N % 64 || C % 64 || C > 320 || Ci % 64 || Ci > 320 || Dc % 64 || Dc > 1024 || frames <= 0 ||
      BF % frames || Lt <= 0 || Li < 0)
    return (int)cudaErrorInvalidValue;
  auto bf = [&](int i) { return static_cast<const bf16*>(p[i]); };
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  const int T = BF * N;
  const int clips = BF / frames;

  HeadArgs h;
  h.x = bf(0); h.mul = f(1); h.add = f(2); h.w_in = bf(3); h.b_in = f(4);
  h.ln1_w = f(5); h.ln1_b = f(6); h.wqkv = bf(7);
  h.h = static_cast<bf16*>(const_cast<void*>(p[27]));
  h.qkv = static_cast<bf16*>(const_cast<void*>(p[28]));
  h.ctx[0] = bf(25); h.ctx[1] = bf(26);
  h.wkv[0] = bf(13); h.wkv[1] = bf(14);
  h.kv[0] = static_cast<bf16*>(const_cast<void*>(p[29]));
  h.kv[1] = static_cast<bf16*>(const_cast<void*>(p[30]));
  h.ctx_rows[0] = clips * Lt; h.ctx_rows[1] = clips * Li;
  h.T = T; h.N = N; h.C = C; h.Ci = Ci; h.Dc = Dc; h.eps = eps;

  BodyArgs b;
  b.x = bf(0); b.out = static_cast<bf16*>(const_cast<void*>(p[31]));
  b.h = h.h; b.qkv = h.qkv;
  b.wo1 = bf(8); b.bo1 = f(9); b.ln2_w = f(10); b.ln2_b = f(11); b.wq2 = bf(12);
  b.kv[0] = h.kv[0]; b.kv[1] = h.kv[1]; b.len[0] = Lt; b.len[1] = Li;
  b.wo2 = bf(15); b.bo2 = f(16); b.ln3_w = f(17); b.ln3_b = f(18);
  b.w1 = bf(19); b.b1 = f(20); b.w2 = bf(21); b.b2 = f(22); b.w_out = bf(23); b.b_out = f(24);
  b.T = T; b.N = N; b.C = C; b.Ci = Ci; b.frames = frames; b.scale = scale; b.eps = eps;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hs = head_smem(C, Ci, Dc), bs = body_smem(Ci);
  cudaError_t e = cudaFuncSetAttribute(mega_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hs);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(mega_body_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bs);
  if (e != cudaSuccess) return (int)e;
  const int row_tiles = (T + TM - 1) / TM;
  const int ctx_tiles = (h.ctx_rows[0] + TM - 1) / TM + (h.ctx_rows[1] + TM - 1) / TM;
  mega_head_kernel<<<row_tiles + ctx_tiles, THREADS, hs, s>>>(h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mega_body_kernel<<<T / TM, THREADS, bs, s>>>(b);
  return (int)cudaGetLastError();
}
