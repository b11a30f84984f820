// Kernel 13: the whole SpatialTransformer (depth 1), and kernel 11: the
// whole spatial BasicTransformerBlock: the body of each as one launch, after
// the wrapper's csrc/gemm.cu GEMMs (the context K/V projection once per clip,
// the head).
//
// Kernel 13 replaces dynamicscaler_tpu/ops/fused_mega.py::_s_mega_call
// (Pallas _s_mega_kernel):
//   h  = GN_apply(x) @ W_in + b_in                   (folded GroupNorm vectors)
//   h += out1(attn_N(LN1(h) @ [q|k|v]))              N-token self-attention
//   h += out2(attn_text(q2) + attn_image(q2))        q2 = LN2(h) @ Wq2
//   h += GEGLU(LN3(h)) @ W2 + b2
//   y  = x + (h @ W_out + b_out)
// over x [BF, N, C] bf16 (BF = clips * frames samples of N = H*W tokens,
// 256 <= N <= 4096, N % 16 == 0, the JAX gate's), head dim 64, C = 64 *
// heads <= 640, the context K/V [clips, Lt (+ Li), 2C] projected once per
// clip. Kernel 11 replaces dynamicscaler_tpu/ops/fused_block.py::
// _spatial_block_call (Pallas _spatial_block_kernel): the same without the
// GroupNorm apply, proj_in and proj_out (h = x, y = h).
//
// What bounds them on the H100: operations. At s320 (128 samples of 2560
// tokens, C 320) a call is 2.3 TFLOP: 1.07 of N x N self-attention, 1.2 of
// projections (15 C^2 a token in the body: wo1, wq2, wo2, w1 8 C^2, w2 4 C^2;
// 3 C^2 of q|k|v and, kernel 13, 2 C^2 of proj_in / proj_out) against 0.2 GB
// of x in and out; at s640 (512 tokens, C 640) the projections are 90%.
//
// Why the head is not in the body: a query tile cannot finish its
// self-attention before every token of its sample has its K and V, and a
// 2560 x 320 sample does not fit one SM; so the wrapper runs the head as
// ds_ln_gemm calls (kernel 13: GN apply -> proj_in -> h, which the body
// reads back as its residual; then LN1 -> q|k|v for both), at that GEMM's
// rate, and the body is one launch over query tiles.
//
// The body: one block = TM query tokens of one sample (TM 64 at C <= 320, 32
// at C <= 640: three [TM, C] tiles and a ring of 16 KB slots in 227 KB), on
// block.cu's machinery (resident.cuh): 384 threads, two consumer warpgroups
// and a producer warpgroup whose one issuing thread walks the block's fixed
// schedule through one TMA/mbarrier ring, running ahead across phases:
//   self-attention K/V tiles, head pair by head pair; wo1; wq2; the
//   cross-attention K/V tiles (text, then image), head pair by head pair;
//   wo2; per hidden chunk the w1 value and gate rows and the w2 columns;
//   (kernel 13) w_out.
// A ring slot is a 128 x 64 weight tile or a 64-key K tile with its V tile
// (8 KB each), so weights and keys share the ring. The projections run on
// wgmma with the operands swapped (resident.cuh: weight rows as M, the token
// tile as N = TM), the GEGLU second product's C / 128 output tiles held in
// registers across the hidden chunks. The attention runs on wgmma as
// attention.cu's flash kernel does (flash.cuh): each consumer warpgroup takes
// one head of a pair (a lone last head: warpgroup 0), its 64 queries as M
// (at TM 32 the 32 rows past the tile ride along and are dropped), S = Q
// K^T with both operands
// in shared memory, the online softmax on the accumulators, P from registers
// as the A operand of P V, V read MN-major; S of one tile in flight with P V
// of the last. K and V arrive by TMA through 3-D tensor maps (64 columns of
// one head, row within the sample or clip, sample or clip), so a segment's
// ragged last tile lands zero-filled and is masked by length: exactly N self
// keys, and Lt text and Li image keys in two softmaxes whose normalised
// outputs are summed. A tile slot read by one warpgroup is released by it
// for both (release_alone).
//
// Shared memory (from the 1024-aligned base; ops/cuda_lib.py::spatial_smem
// reckons the same): the ring (stages x 16 KB); X [TM, C] the residual
// stream; H [TM, C]: the self-attention queries, then LN2, the cross-
// attention output, LN3, proj_out's staging; O [TM, C]: the self-attention
// output, then q2, then the GEGLU chunk [TM, hc]; past O, room for a 64-row
// operand read from O's last head at TM 32; 2 x stages mbarriers.
// Not done: K and V cross L2 once per query tile and head (3.3 MB a block at
// s320). A cluster of two query tiles of a sample sharing every ring tile by
// multicast halved those bytes but timed slower at the UNet's batch-8 shapes
// (as kernel 10's cluster did at C 320 and 640), so a cluster is one block;
// a larger query tile does not fit beside the ring.
//
// Rounding points are the plain versions' (kernel 13: kernels 7, 2, 3, 4, 8
// in sequence; kernel 11: 2, 3, 4): the GN-applied input (product and sum
// rounded separately), every projection output, q/k/v, the exponentials for
// P V, attention outputs, residual sums and GEGLU value/gate/product are
// rounded to bf16; sums accumulate in fp32; the softmax sum of the unrounded
// exponentials is divided out after P V.

#include <math.h>
#include <string.h>

#include "flash.cuh"
#include "resident.cuh"

namespace {

using namespace hopper;
using namespace resident;
using namespace flash;

constexpr int KEYS = 64;                // keys a ring slot: a K tile and its V tile
constexpr int KV_BYTES = KEYS * D * 2;  // 8 KB each
constexpr float LOG2E = 1.4426950408889634f;

enum { M_WO1, M_WQ2, M_WO2, M_W1, M_W2, M_OUT, N_MAPS };

struct SpatialMaps {
  CUtensorMap w[N_MAPS];  // the weights, boxes of 64 k x 128 rows (M_OUT: kernel 13 only)
  CUtensorMap qkv;        // [BF, N, 3C], boxes of 64 columns x 64 rows of one sample
  CUtensorMap kv[2];      // text, image K|V [clips, L_s, 2C], the same boxes (kv[1] unused without image keys)
};

struct SpatialArgs {
  const bf16* h;    // [BF N, C] the block's input: kernel 13 proj_in's output, kernel 11 x
  const bf16* x;    // kernel 13: [BF N, C] the transformer's input, the outer residual
  const bf16* qkv;  // [BF N, 3C] LN1(h) @ Wqkv: the queries read from it, K and V by TMA
  const float *bo1, *ln2_w, *ln2_b, *bo2, *ln3_w, *ln3_b, *b1, *b2, *b_out;
  bf16* out;        // [BF N, C]
  int N, C, heads, frames;
  int len[2];       // Lt, Li (0 without image keys)
  int stages, hc;
  float scale_log2, eps;
};

// Byte offsets of the shared-memory regions from the 1024-aligned base, and
// the dynamic shared memory a block asks for (the alignment pad included).
struct Layout {
  int xs, hs, os, bars, total;
};

__host__ __device__ inline Layout layout(int tm, int C, int stages, int hc) {
  Layout L;
  const int tile = tm * C * 2;
  L.xs = stages * TILE_BYTES;
  L.hs = L.xs + tile;
  L.os = L.hs + tile;
  int end = L.os + tile + (64 - tm) * 128;  // a 64-row query operand from O's last head
  if (L.os + tm * hc * 2 > end) end = L.os + tm * hc * 2;
  L.bars = end;
  L.total = SMEM_ALIGN + L.bars + 2 * stages * 8;
  return L;
}

// The ring slot of this warpgroup's next attention tile: of each `pair`
// consecutive tiles the producer issues, the `mine`-th.
__device__ __forceinline__ int take(Ring& rg, int pair, int mine, uint32_t& phase) {
  if (mine) rg.advance();
  const int s = rg.s;
  phase = rg.phase;
  rg.advance();
  if (pair - mine == 2) rg.advance();
  return s;
}

// One key segment of `len` keys for this warpgroup's 64 query rows (qdesc)
// of one head, whose tiles the producer issues interleaved with the other
// head of a pair (pair 2) or alone (pair 1): O unnormalised in o, each row's
// sum of exponentials in l (reduced over the row's quad on return). Tile
// j's S = Q K^T is issued with tile j-1's O += P V, and tile j's softmax
// runs while P V is in flight (the first tile peeled, so every wait is
// unconditional). A slot only this warpgroup reads it hands back for both.
__device__ __forceinline__ void attend_segment(float (&o)[32], float (&l)[2], Ring& rg, int pair, int mine, int len,
                                               uint64_t qdesc, float sl) {
  float m[2] = {-INFINITY, -INFINITY};
  float alpha[2];
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float sacc[KEYS / 2];
  uint32_t pa[KEYS / 16][4];
  uint32_t ph;
  int prev = take(rg, pair, mine, ph);
  mbar_wait(&rg.full[prev], ph);
  wgmma_fence();
  issue_s<KEYS>(sacc, qdesc, rg.base + prev * TILE_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sacc);
  softmax_tile<KEYS>(sacc, m, l, alpha, len, sl);
  pack_p<KEYS>(pa, sacc);
  for (int k0 = KEYS; k0 < len; k0 += KEYS) {
    const int s = take(rg, pair, mine, ph);
    mbar_wait(&rg.full[s], ph);
    wgmma_fence();
    issue_s<KEYS>(sacc, qdesc, rg.base + s * TILE_BYTES);
    wgmma_commit();
    issue_pv<KEYS>(o, pa, rg.base + prev * TILE_BYTES + KV_BYTES);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sacc);
    softmax_tile<KEYS>(sacc, m, l, alpha, len - k0, sl);
    wgmma_wait<0>();
    fence_acc(o);
    fence_regs(pa);
    release_alone(rg, prev);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_p<KEYS>(pa, sacc);
    prev = s;
  }
  wgmma_fence();
  issue_pv<KEYS>(o, pa, rg.base + prev * TILE_BYTES + KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
  fence_regs(pa);
  release_alone(rg, prev);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
}

// Heads h0 and h0 + 1 (pair 2), one a warpgroup, or h0 alone (pair 1, on
// warpgroup 0): the head's queries, the 64-column k block of the swizzled
// tile Q, against the nseg key segments of lens, each segment's normalised
// output summed and rounded to bf16 into the head's columns of Out (rows
// below TM). A warpgroup without a head steps its ring position over the
// tiles without waiting for them. A parity wait is still never fooled: the
// fill of a slot before the one a warpgroup waits for is one it waited for
// itself (with an even ring depth each head of a pair keeps to slots of its
// own), or one that completed before both warpgroups last synchronised
// (every attention section and every lone head starts with a consumer_sync).
template <int TM>
__device__ void attend_heads(Ring& rg, int pair, int h0, const int* lens, int nseg, const uint8_t* Q, uint8_t* Out,
                             float sl) {
  const int wg = threadIdx.x >> 7;
  if (pair == 1) consumer_sync();
  if (wg >= pair) {
    for (int sg = 0; sg < nseg; ++sg)
      for (int k0 = 0; k0 < lens[sg]; k0 += KEYS)
        for (int m = 0; m < pair; ++m) rg.advance();
    return;
  }
  const int h = h0 + wg;
  const uint64_t qdesc = smem_desc(Q + h * TM * 128);
  float fin[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) fin[i] = 0.f;
  for (int sg = 0; sg < nseg; ++sg) {
    float o[32], l[2];
    attend_segment(o, l, rg, pair, wg, lens[sg], qdesc, sl);
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) fin[i] += o[i] * inv[(i >> 1) & 1];
  }
  // thread (warp w, lane x) holds rows 16 w + x / 4 (+8), columns 8 g + 2 (x % 4) + {0, 1}
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * w + (lane >> 2) + 8 * hh;
    if (r >= TM) continue;
#pragma unroll
    for (int g = 0; g < 8; ++g)
      *reinterpret_cast<uint32_t*>(Out + tok_off<TM>(r, h * D + 8 * g + 2 * (lane & 3))) =
          pack2(fin[4 * g + 2 * hh], fin[4 * g + 2 * hh + 1]);
  }
}

// ---- the producer ---------------------------------------------------------------

// One thread walks the block's whole schedule through the ring, in the
// order the consumers take it.
template <bool MEGA>
__device__ void produce(const SpatialMaps& mp, const SpatialArgs& a, uint8_t* ring, uint64_t* full, uint64_t* empty,
                        int sample) {
  const int S = a.stages, C = a.C, nk = C / BK;
  int s = 0;
  uint32_t phase = 0;  // of the slot's fill; its release of the previous fill has the other parity
  auto slot = [&]() {
    mbar_wait(&empty[s], phase ^ 1);
    mbar_expect_tx(&full[s], TILE_BYTES);
    return ring + s * TILE_BYTES;
  };
  auto next = [&]() {
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  };
  auto load = [&](int m, int row0, int k0) {
    uint8_t* dst = slot();
    tma_load_2d(dst, &mp.w[m], &full[s], k0, row0);
    next();
  };
  auto gemm = [&](int m, int rows) {
    for (int p = 0; p < rows; p += WROWS)
      for (int ks = 0; ks < nk; ++ks) load(m, p, ks * BK);
  };
  // the K and V tiles of head pairs over segments: map, K column of head 0,
  // V column of head 0, length, outer coordinate
  auto keys = [&](const CUtensorMap* const* maps, const int* kcol, const int* vcol, const int* lens, int nseg,
                  int b) {
    for (int h0 = 0; h0 < a.heads; h0 += 2) {
      const int pair = min(2, a.heads - h0);
      for (int sg = 0; sg < nseg; ++sg)
        for (int k0 = 0; k0 < lens[sg]; k0 += KEYS)
          for (int m = 0; m < pair; ++m) {
            uint8_t* dst = slot();
            tma_load_3d(dst, maps[sg], &full[s], kcol[sg] + (h0 + m) * D, k0, b);
            tma_load_3d(dst + KV_BYTES, maps[sg], &full[s], vcol[sg] + (h0 + m) * D, k0, b);
            next();
          }
    }
  };
  const CUtensorMap* self_map[1] = {&mp.qkv};
  const int self_k[1] = {C}, self_v[1] = {2 * C}, self_len[1] = {a.N};
  keys(self_map, self_k, self_v, self_len, 1, sample);
  gemm(M_WO1, C);
  gemm(M_WQ2, C);
  const CUtensorMap* ctx_map[2] = {&mp.kv[0], &mp.kv[1]};
  const int ctx_k[2] = {0, 0}, ctx_v[2] = {C, C};
  keys(ctx_map, ctx_k, ctx_v, a.len, a.len[1] ? 2 : 1, sample / a.frames);
  gemm(M_WO2, C);
  produce_ff(load, M_W1, M_W2, C, a.hc);
  if (MEGA) gemm(M_OUT, C);
}

// ---- the consumers -----------------------------------------------------------------

template <int TM, bool MEGA>
__device__ void consume(const SpatialArgs& a, uint8_t* sm, const Layout& L, Ring& rg, int sample, int q0) {
  const int C = a.C, nk = C / BK, cv = C / 8;
  const int rows = min(TM, a.N - q0);  // queries of this tile (a sample's last tile may be ragged)
  const size_t t0 = (size_t)sample * a.N + q0;
  uint8_t* Xs = sm + L.xs;
  uint8_t* Hs = sm + L.hs;
  uint8_t* Os = sm + L.os;
  const int tid = threadIdx.x;

  // the residual stream into X, the tile's queries (every head) into H; the
  // rows past the sample zero
  for (int i = tid; i < TM * cv; i += CONSUMERS) {
    const int r = i / cv, c = (i - r * cv) * 8;
    uint4 hv = make_uint4(0, 0, 0, 0), qv = hv;
    if (r < rows) {
      hv = *reinterpret_cast<const uint4*>(a.h + (t0 + r) * C + c);
      qv = *reinterpret_cast<const uint4*>(a.qkv + (t0 + r) * 3 * C + c);
    }
    *reinterpret_cast<uint4*>(Xs + tok_off<TM>(r, c)) = hv;
    *reinterpret_cast<uint4*>(Hs + tok_off<TM>(r, c)) = qv;
  }
  fence_proxy_async();
  consumer_sync();

  auto add_into_x = [&](int, int, int off, float v, int) {
    bf16* d = reinterpret_cast<bf16*>(Xs + off);
    *d = f2bf(bf2f(*d) + round_bf(v));
  };
  // self-attention over the sample's N keys -> O; out-projection + bo1 + residual
  const int self_len[1] = {a.N};
  for (int h0 = 0; h0 < a.heads; h0 += 2) attend_heads<TM>(rg, min(2, a.heads - h0), h0, self_len, 1, Hs, Os, a.scale_log2);
  fence_proxy_async();
  consumer_sync();
  gemm_rows<TM>(rg, Os, nk, C, a.bo1, add_into_x);

  // cross-attention: q2 = LN2(X) @ Wq2 -> O; text (+ image) keys of this
  // sample's clip -> H; out-projection + bo2 + residual
  layer_norm<TM>(Xs, Hs, C, a.ln2_w, a.ln2_b, a.eps);
  gemm_rows<TM>(rg, Hs, nk, C, nullptr,
                [&](int, int, int off, float v, int) { *reinterpret_cast<bf16*>(Os + off) = f2bf(v); });
  fence_proxy_async();
  consumer_sync();
  const int nseg = a.len[1] ? 2 : 1;
  for (int h0 = 0; h0 < a.heads; h0 += 2) attend_heads<TM>(rg, min(2, a.heads - h0), h0, a.len, nseg, Os, Hs, a.scale_log2);
  fence_proxy_async();
  consumer_sync();
  gemm_rows<TM>(rg, Hs, nk, C, a.bo2, add_into_x);

  feed_forward<TM>(rg, Xs, Hs, Os, C, a.hc, a.ln3_w, a.ln3_b, a.b1, a.b2, a.eps);

  if (MEGA) {
    // proj_out + b_out staged in H, then + x
    gemm_rows<TM>(rg, Xs, nk, C, a.b_out,
                  [&](int, int, int off, float v, int) { *reinterpret_cast<bf16*>(Hs + off) = f2bf(v); });
    consumer_sync();
    for (int i = tid; i < rows * cv; i += CONSUMERS) {
      const int r = i / cv, c = (i - r * cv) * 8;
      const uint4 xr = *reinterpret_cast<const uint4*>(a.x + (t0 + r) * C + c);
      uint4 y = *reinterpret_cast<const uint4*>(Hs + tok_off<TM>(r, c));
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&y);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xr);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 p = __bfloat1622float2(o[q]), xf = __bfloat1622float2(x2[q]);
        o[q] = __floats2bfloat162_rn(xf.x + p.x, xf.y + p.y);
      }
      *reinterpret_cast<uint4*>(a.out + (t0 + r) * C + c) = y;
    }
  } else {
    for (int i = tid; i < rows * cv; i += CONSUMERS) {
      const int r = i / cv, c = (i - r * cv) * 8;
      *reinterpret_cast<uint4*>(a.out + (t0 + r) * C + c) = *reinterpret_cast<const uint4*>(Xs + tok_off<TM>(r, c));
    }
  }
}

// MEGA = false: kernel 11; MEGA = true: kernel 13. One block a (sample, query tile).
template <int TM, bool MEGA>
__global__ void __launch_bounds__(THREADS, 1)
spatial_body_kernel(const __grid_constant__ SpatialMaps maps, const SpatialArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
                                           ~uintptr_t(SMEM_ALIGN - 1));
  const Layout L = layout(TM, a.C, a.stages, a.hc);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + a.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // both consumer warpgroups (or one for both: release_alone)
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int tiles = (a.N + TM - 1) / TM;
  const int sample = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - sample * tiles) * TM;
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) produce<MEGA>(maps, a, sm, full, empty, sample);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    Ring rg{sm, full, empty, a.stages, 1, 0, 0};
    consume<TM, MEGA>(a, sm, L, rg, sample, q0);
  }
}

// ---- host side ---------------------------------------------------------------------

template <int TM, bool MEGA>
int launch(const SpatialMaps& maps, const SpatialArgs& a, int BF, int smem, void* stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(spatial_body_kernel<TM, MEGA>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const long long blocks = (long long)BF * ((a.N + TM - 1) / TM);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];  // a cluster of one block: the ring's release addresses its own rank
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, spatial_body_kernel<TM, MEGA>, maps, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan's checks: TM by width, the second product's tiles in registers,
// the ring, the hidden chunk, and the shared memory the plan reckoned equal
// to layout()'s.
bool plan_ok(int C, int tm, int stages, int hc, int smem) {
  if (tm != (C <= 320 ? 64 : 32) || C > WROWS * ff_tiles(tm) || stages < 4 || stages % 2) return false;
  if (hc < WROWS || hc % WROWS || (4 * C) % hc) return false;
  return smem == layout(tm, C, stages, hc).total && smem <= SMEM_MAX;
}

// an activation's map: [outer, rows, width] bf16, boxes of 64 columns x KEYS rows of one outer index
bool act_map(CUtensorMap* map, const void* base, int outer, int rows, int width) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)rows * width * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)KEYS, 1};
  return make_map(map, base, 3, dims, strides, box);
}

int run(const void* const* p, bool mega, int BF, int N, int C, int frames, int Lt, int Li, float scale, float eps,
        const void* maps, int tm, int stages, int hc, int smem, void* stream) {
  if (N % 16 || N <= 0 || C % 64 || C < 64 || C > 640 || frames <= 0 || BF <= 0 || BF % frames || Lt <= 0 ||
      Li < 0 || maps == nullptr || !plan_ok(C, tm, stages, hc, smem))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 15; ++i)
    if (p[i] == nullptr && !(i == 1 && !mega) && !(i == 4 && Li == 0) && !(i == 13 && !mega))
      return (int)cudaErrorInvalidValue;
  const int clips = BF / frames;
  SpatialMaps m;
  memset(&m, 0, sizeof(m));
  memcpy(m.w, maps, (mega ? N_MAPS : N_MAPS - 1) * sizeof(CUtensorMap));
  if (!act_map(&m.qkv, p[2], BF, N, 3 * C) || !act_map(&m.kv[0], p[3], clips, Lt, 2 * C) ||
      (Li > 0 && !act_map(&m.kv[1], p[4], clips, Li, 2 * C)))
    return (int)cudaErrorInvalidValue;
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  SpatialArgs a = {};
  a.h = static_cast<const bf16*>(p[0]);
  a.x = static_cast<const bf16*>(p[1]);
  a.qkv = static_cast<const bf16*>(p[2]);
  a.bo1 = f(5);
  a.ln2_w = f(6);
  a.ln2_b = f(7);
  a.bo2 = f(8);
  a.ln3_w = f(9);
  a.ln3_b = f(10);
  a.b1 = f(11);
  a.b2 = f(12);
  a.b_out = f(13);
  a.out = static_cast<bf16*>(const_cast<void*>(p[14]));
  a.N = N;
  a.C = C;
  a.heads = C / D;
  a.frames = frames;
  a.len[0] = Lt;
  a.len[1] = Li;
  a.stages = stages;
  a.hc = hc;
  a.scale_log2 = scale * LOG2E;
  a.eps = eps;
  if (mega) return tm == 64 ? launch<64, true>(m, a, BF, smem, stream) : launch<32, true>(m, a, BF, smem, stream);
  return tm == 64 ? launch<64, false>(m, a, BF, smem, stream) : launch<32, false>(m, a, BF, smem, stream);
}

}  // namespace

// The TMA maps of the body's weights (boxes of 64 k x 128 rows, 128-byte
// swizzle), written to out (n x 128 bytes): w holds n = 5 device pointers,
// wo1 [C, C], wq2 [C, C], wo2 [C, C], w1 [8C, C], w2 [C, 4C], or n = 6 with
// kernel 13's w_out [C, C]. A map describes only the address, the shape and
// the box, so the caller may keep it for as long as these weights live.
// stream: unused (the convention of every entry point).
extern "C" int ds_spatial_maps(const void* const* w, int n, int C, void* out, void* stream) {
  (void)stream;
  if ((n != N_MAPS - 1 && n != N_MAPS) || C % 64 || C <= 0 || out == nullptr) return (int)cudaErrorInvalidValue;
  const int rows[N_MAPS] = {C, C, C, 8 * C, C, C};
  const int cols[N_MAPS] = {C, C, C, C, 4 * C, C};
  for (int i = 0; i < n; ++i) {
    CUtensorMap m;
    const cuuint64_t dims[2] = {(cuuint64_t)cols[i], (cuuint64_t)rows[i]};
    const cuuint64_t strides[1] = {(cuuint64_t)cols[i] * 2};
    const cuuint32_t box[2] = {BK, WROWS};
    if (w[i] == nullptr || !make_map(&m, w[i], 2, dims, strides, box)) return (int)cudaErrorInvalidValue;
    memcpy(static_cast<uint8_t*>(out) + i * sizeof(CUtensorMap), &m, sizeof(CUtensorMap));
  }
  return 0;
}

// p: device pointers, in order:
//  0 h [T, C] (the block's input: proj_in's output)   1 x [T, C] (the outer residual)
//  2 qkv [T, 3C] (LN1(h) @ Wqkv: q | k | v, each head's 64 columns together)
//  3 kv_t [clips * Lt, 2C] (text K | V per clip)      4 kv_i [clips * Li, 2C] (or null)
//  5 bo1   6 ln2_w   7 ln2_b   8 bo2   9 ln3_w   10 ln3_b   11 b1 [8C]   12 b2   13 b_out
// 14 out [T, C]
// T = BF * N tokens, samples of N tokens, frames samples a clip; bf16
// activations, fp32 vectors. maps: ds_spatial_maps of the six weights. The
// plan (tm, stages, hc, smem) from cuda_lib.spatial_plan. Shapes the caller
// guarantees: N % 16 == 0, C a multiple of 64 up to 640, every pointer
// 16-byte aligned and contiguous.
extern "C" int ds_mega_spatial(const void* const* p, int BF, int N, int C, int frames, int Lt, int Li, float scale,
                               float eps, const void* maps, int tm, int stages, int hc, int smem, void* stream) {
  return run(p, true, BF, N, C, frames, Lt, Li, scale, eps, maps, tm, stages, hc, smem, stream);
}

// Kernel 11: the same pointer layout with 0 = x and 1, 13 unused (null);
// maps: ds_spatial_maps of the five block weights.
extern "C" int ds_spatial_block(const void* const* p, int BF, int N, int C, int frames, int Lt, int Li, float scale,
                                float eps, const void* maps, int tm, int stages, int hc, int smem, void* stream) {
  return run(p, false, BF, N, C, frames, Lt, Li, scale, eps, maps, tm, stages, hc, smem, stream);
}
