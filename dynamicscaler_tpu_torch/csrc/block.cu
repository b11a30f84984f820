// Kernel 10: the whole temporal BasicTransformerBlock in one launch, and
// kernel 12: the whole TemporalTransformer (depth 1) in one launch.
//
// Kernel 10 replaces dynamicscaler_tpu/ops/fused_block.py::_temporal_block_call
// (Pallas _temporal_block_kernel):
//   x += out1(attnF(LN1(x) @ [q1|k1|v1]))      F-frame self-attention
//   x += out2(attnF(LN2(x) @ [q2|k2|v2]))      F-frame self-attention
//   x += GEGLU(LN3(x)) @ W2 + b2
// over x [R, F, C] bf16 (R = B*H*W rows of F frame tokens; 2 <= F <= 128,
// 128 % F == 0, the JAX gate's frames), head dim 64, C = 64 * heads, 64 <= C
// <= 1280 (320, 512, 640 and 1280 on the UNet's path).
//
// Kernel 12 replaces dynamicscaler_tpu/ops/fused_mega.py::_t_mega_call
// (Pallas _t_mega_kernel): the same block with kernel 5's prologue and
// kernel 6's epilogue around it, over x5 [B, F, H, W, C] and the folded
// GroupNorm vectors (mul, add) [B, C]:
//   h = (x5 * mul + add) permuted to F-frame rows @ W_in + b_in
//   h = block(h)                                   (kernel 10's body)
//   y = x5 + (h @ W_out + b_out) permuted back
// with inner == C <= 640. The frame permute lives in the address arithmetic:
// token (row = b*H*W + hw, frame f) is read from and written to x5 element
// ((b*F + f)*H*W + hw)*C; nothing is copied.
//
// What bounds them on the H100. Per token the block multiplies by 20 C^2
// weights (3 C^2 of q|k|v and C^2 of out-projection, twice; 8 C^2 + 4 C^2
// of GEGLU feed-forward; kernel 12 adds 2 C^2 of proj_in and proj_out), 2
// operations each, against 4 C bytes of activation in and out: by the
// operation count the tensor cores bound them at every width, ~100x over
// device memory; the attention itself is F x F per (row, head), about 1% of
// the operations at F = 16. Every F-frame row is independent, so a block
// keeps TM tokens (TM / F whole rows) in shared memory through the whole
// block and device memory sees x once each way. What a design has to get
// right is the weights: 40 C^2 bytes (4.1 MB at C 320, 65.5 MB at C 1280)
// stream through every block, and a weight byte serves only the block's TM
// tokens, so each 16 KB weight tile is TM x 8K multiply-adds: 64 tensor
// cycles at TM 16, 256 at TM 64, against ~290-380 cycles of shared-memory
// traffic a tile at 128 bytes a cycle (the TMA write, the wgmma reads of
// the tile and of the token tile). Only TM 64 can keep the tensor cores busy, and 227 KB holds
// TM 64 only up to C 320 (three [TM, C] tiles and the ring). With one block
// alone on its weights and mma.sync (the design before this one), C 1280 read 84 GB
// from L2 per launch of 20,480 tokens and ran at 3% of the tensor peak.
//
// Design (Hopper; the tile plan (TM, CL, stages, hg, hc) comes from
// ops/cuda_lib.py::block_plan, which reckons shared memory as layout() does;
// the ring, the swizzled tiles, the products, the LayerNorm and the
// feed-forward live in resident.cuh, which mega.cu shares):
//   * one block = TM resident tokens (TM 64 at C <= 320, 32 at C <= 640, 16
//     at C <= 1280, as much as 227 KB of shared memory holds beside a
//     4-deep weight ring) and 384 threads: two consumer warpgroups and a
//     producer warpgroup, one thread of which issues the copies
//     (setmaxnreg gives the others' registers to the consumers);
//   * the blocks run as thread-block clusters of CL and every weight tile is
//     fetched from L2 once per cluster: a ring tile is 128 weight rows x 64 k
//     (16 KB, 128-byte swizzle) and each block's producer issues 1/CL of its
//     rows as one TMA copy multicast to the whole cluster (at CL 1 a plain
//     TMA copy). The ring's "full"
//     barrier of each block counts the whole tile's bytes, whoever issued
//     them; its "empty" barrier counts a release from both consumer
//     warpgroups of every block of the cluster (2 x CL arrivals with a
//     CTA-scope release: a cluster-scope one cost more than the tile's
//     products), so no
//     producer refills a slot that a peer still reads. CL is F / TM (up to
//     8, portable) where a row spans blocks; where a row lies in one block
//     it is what timed faster on the H100: 2 at C 512, 1 at C 320, 640 and
//     1280, where the multicast's halved L2 reads bought nothing and the
//     cluster-wide release tied each block to its slower peer (3-10%
//     slower); larger clusters measured slower still;
//   * the producer thread walks the block's fixed weight schedule (w_in;
//     wqkv1 by head group, wo1; wqkv2, wo2; per hidden chunk the w1 value
//     and gate rows and the w2 columns; w_out) without waiting on the
//     consumers' phases: it runs ahead across GEMM boundaries and through
//     the LayerNorm, GroupNorm and attention phases as far as the ring's
//     depth allows;
//   * the products run on wgmma with the operands swapped: 64 weight rows of
//     the ring tile are the M side (one warpgroup each), the resident token
//     tile the N side (m64nTMk16, both operands K-major in shared memory),
//     so TM may be 16 or 32. Every resident operand tile (the residual
//     stream X, the LayerNorm or GroupNorm output H, the attention output O,
//     the GEGLU hidden chunk) is kept in the 128-byte-swizzled K-major layout
//     wgmma reads (tok_off), and its writers write through that swizzle.
//     Within an output tile one k step stays in flight (wait_group 1, the
//     first step peeled so that no wait is conditional); the epilogue gets
//     (token, column, value + bias) from the accumulator registers;
//   * the q|k|v projection runs hg heads at a time (up to 8 16-query units,
//     one per consumer warp), and the attention runs on mma.sync m16n8k16
//     as attention.cu's ds_temporal_attention does: a warp owns 16 queries
//     of a head, F < 16 is a block-diagonal mask, F > 16 more key tiles.
//     Where F > TM a row spans F / TM blocks of the cluster (CL a multiple
//     of F / TM, so a cluster holds whole rows): each block copies the row's
//     keys and values from its peers' shared memory (distributed shared
//     memory) into its own, between two row barriers;
//   * the feed-forward runs over hidden chunks of hc columns: each 128
//     value rows and then the matching 128 gate rows of w1, one epilogue
//     forming GEGLU from both accumulators into the swizzled chunk; each
//     chunk's share of the second product accumulates in registers (C / 128
//     output tiles per warpgroup, up to 96 fp32 a thread) until the last
//     chunk;
//   * the grid is ceil(R F / TM) blocks rounded up to a multiple of CL; the
//     blocks past the last token run the whole schedule on zeros (they join
//     every barrier and issue their share of every multicast) and skip only
//     their loads and stores of x.
// Not done: the LayerNorm, attention and epilogue phases leave the tensor
// cores idle (the consumers do them between products; a ping-pong of the
// two warpgroups would hide them), and at TM 16 and 32 the shared-memory
// traffic a tile, not the tensor cores, sets the rate.
//
// Rounding points are those of the plain versions (kernel 10: K1, K1, K4 in
// sequence; kernel 12: kernels 5, 10, 6): the GN-applied input (product and
// sum rounded separately), LN output, q/k/v, probabilities (normalised
// before PV), attention output, projection + bias, residual sum and GEGLU
// value/gate/product are each rounded to bf16; sums accumulate in fp32.

#include <cooperative_groups.h>
#include <math.h>
#include <string.h>

#include "hopper.cuh"
#include "resident.cuh"

namespace {

using namespace hopper;
using namespace resident;
namespace cg = cooperative_groups;

constexpr int LDQ = D + 8;                   // bf16 pitch of a q, k or v row (ldmatrix hits distinct banks)
enum { M_QKV1, M_WO1, M_QKV2, M_WO2, M_W1, M_W2, M_IN, M_OUT, N_MAPS };

struct BlockMaps {
  CUtensorMap m[N_MAPS];  // TMA maps of the weights, boxes of 64 k x 128 / CL rows
};

struct BlockArgs {
  const bf16* x;
  bf16* out;
  const float* ln_w[3];
  const float* ln_b[3];
  const float* bo[2];
  const float* b1;
  const float* b2;
  // kernel 12 only: x / out are [B, F, H, W, C]
  const float* gn_mul;  // [B, C] folded GroupNorm vectors
  const float* gn_add;
  const float* b_in;
  const float* b_out;
  int HW, R, F, C, heads;
  int cl;      // blocks a cluster
  int rb;      // blocks an F-frame row: F / TM where F > TM, else 1
  int stages;  // ring tiles
  int hg;      // heads a q|k|v projection
  int hc;      // GEGLU hidden columns a chunk
  float scale, eps;
};

// Byte offsets of the shared-memory regions from the 1024-aligned base, and
// the dynamic shared memory a block asks for (the alignment pad included):
//   ring   stages x 16 KB
//   X      [TM, C] the residual stream          (swizzled, tok_off)
//   H      [TM, C] LN / GN output, proj_out staging (swizzled)
//   O      [TM, C] attention output             (swizzled)   } the
//   qkv    hg heads x q|k|v x [TM, LDQ]                      } attention
//   kv     the row's keys and values [2, F, LDQ] where F > TM }
//   hidden [TM, hc] the GEGLU chunk (swizzled), over O..
//   bars   full[stages], empty[stages], the two row barriers
struct Layout {
  int ring, xs, hs, os, qkv, kv, hid, bars, total;
};

__host__ __device__ inline Layout layout(int tm, int C, int F, int stages, int hg, int hc) {
  Layout L;
  const int tile = tm * C * 2;
  L.ring = 0;
  L.xs = stages * TILE_BYTES;
  L.hs = L.xs + tile;
  L.os = L.hs + tile;
  L.hid = L.os;
  L.qkv = L.os + tile;
  L.kv = L.qkv + hg * 3 * tm * LDQ * 2;
  int end = L.kv + (F > tm ? 2 * F * LDQ * 2 : 0);
  if (L.hid + tm * hc * 2 > end) end = L.hid + tm * hc * 2;
  L.bars = end;
  L.total = SMEM_ALIGN + L.bars + (2 * stages + 2) * 8;
  return L;
}

// ---- mma.sync for the attention -----------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// c[4] += a[4] (16x16 bf16, row) @ b[2] (16x8 bf16, col), fp32
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
               "{%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp, 16 queries (rows q0.. of qs) of one head against NK keys (rows
// 0.. of ks and vs; pitch LDQ): S = Q K^T, the softmax on the accumulator
// registers (a quad's four threads own a row; F < 16: only the keys of the
// query's own row, a block-diagonal mask), probabilities normalised and
// rounded to bf16, O = P V; the head's 64 output columns from col0 go to
// the swizzled O tile.
template <int NK, int TM>
__device__ void attend(const bf16* qs, const bf16* ks, const bf16* vs, int q0, int F, float scale, uint8_t* Os,
                       int col0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float sacc[NK / 8][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, qs + (q0 + (lane & 15)) * LDQ + kk + (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < NK / 16; ++nb) {
      uint32_t b[4];
      ldsm_x4(b, ks + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDQ + kk + ((lane >> 3) & 1) * 8);
      mma16816(sacc[2 * nb], a, b);
      mma16816(sacc[2 * nb + 1], a, b + 2);
    }
  }
  uint32_t pa[NK / 16][4];
  {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const bool ok = F >= 16 || (g + 8 * hh) / F == (8 * j + 2 * t4 + (e & 1)) / F;
        const float v = ok ? sacc[j][e] * scale : -INFINITY;
        sacc[j][e] = v;
        m[hh] = fmaxf(m[hh], v);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
      m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
    }
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[j][e] - m[e >> 1]);
        sacc[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      pa[kk][0] = pack2(sacc[2 * kk][0] / l[0], sacc[2 * kk][1] / l[0]);
      pa[kk][1] = pack2(sacc[2 * kk][2] / l[1], sacc[2 * kk][3] / l[1]);
      pa[kk][2] = pack2(sacc[2 * kk + 1][0] / l[0], sacc[2 * kk + 1][1] / l[0]);
      pa[kk][3] = pack2(sacc[2 * kk + 1][2] / l[1], sacc[2 * kk + 1][3] / l[1]);
    }
  }
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LDQ + nb * 16 + (mi >> 1) * 8);
      mma16816(o[2 * nb], pa[kk], b);
      mma16816(o[2 * nb + 1], pa[kk], b + 2);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(Os + tok_off<TM>(q0 + g + 8 * hh, col0 + 8 * j + 2 * t4)) =
          pack2(o[j][2 * hh], o[j][2 * hh + 1]);
}

// the x5 element offset of token t (F-frame row t / F = b*HW + hw, frame
// t % F) of kernel 12's [B, F, H, W, C] input
__device__ __forceinline__ size_t frame_major(int t, int F, int HW, int C) {
  const int row = t / F, f = t % F;
  const int b = row / HW, hw = row - b * HW;
  return ((size_t)(b * F + f) * HW + hw) * C;
}

// A barrier among the consumers of the F / TM blocks of this block's row
// (ranks first.. of the cluster): this block's writes before it are visible
// to those blocks' reads after it. The two barriers of a head group
// alternate, so no block arrives for a barrier's next phase before every
// block of the row has seen its last.
__device__ __forceinline__ void row_sync(uint64_t* bar, uint32_t& phase, uint32_t first, int rb) {
  consumer_sync();
  if ((int)threadIdx.x < rb) mbar_arrive_remote(bar, first + threadIdx.x);
  mbar_wait_cluster(bar, phase);
  phase ^= 1;
}

// ---- the producer ---------------------------------------------------------------

// One thread walks the block's whole weight schedule through the ring, in
// the order the consumers take it. Each block issues its 128 / CL rows of
// every tile, multicast to the cluster (all 128 as a plain copy at CL 1);
// every block's full barrier expects the whole tile.
template <bool MEGA>
__device__ void produce(const BlockMaps& maps, const BlockArgs& a, uint8_t* ring, uint64_t* full, uint64_t* empty,
                        uint32_t rank) {
  const int S = a.stages, C = a.C, nk = C / BK;
  const int slice = WROWS / a.cl;
  const uint16_t mask = (uint16_t)((1u << a.cl) - 1);
  int s = 0;
  uint32_t phase = 0;  // of the slot's fill; its release of the previous fill has the other parity
  auto load = [&](int m, int row0, int k0) {
    mbar_wait(&empty[s], phase ^ 1);
    mbar_expect_tx(&full[s], TILE_BYTES);
    uint8_t* dst = ring + s * TILE_BYTES + rank * slice * 128;
    if (a.cl > 1) tma_load_2d_multicast(dst, &maps.m[m], &full[s], k0, row0 + (int)rank * slice, mask);
    else tma_load_2d(dst, &maps.m[m], &full[s], k0, row0);
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  };
  auto gemm = [&](int m, int row0, int rows) {
    for (int p = 0; p < rows; p += WROWS)
      for (int ks = 0; ks < nk; ++ks) load(m, row0 + p, ks * BK);
  };
  if (MEGA) gemm(M_IN, 0, C);
  for (int sb = 0; sb < 2; ++sb) {
    for (int h0 = 0; h0 < a.heads; h0 += a.hg) gemm(sb ? M_QKV2 : M_QKV1, 3 * D * h0, 3 * D * min(a.hg, a.heads - h0));
    gemm(sb ? M_WO2 : M_WO1, 0, C);
  }
  produce_ff(load, M_W1, M_W2, C, a.hc);
  if (MEGA) gemm(M_OUT, 0, C);
}

// ---- the consumers -----------------------------------------------------------------

template <int TM, bool MEGA>
__device__ void consume(const BlockArgs& a, uint8_t* sm, const Layout& L, Ring& rg, uint64_t* rowbar,
                        uint32_t rank) {
  const int C = a.C, nk = C / BK, F = a.F;
  const int T = a.R * a.F;
  const int t0 = blockIdx.x * TM;
  uint8_t* Xs = sm + L.xs;
  uint8_t* Hs = sm + L.hs;
  uint8_t* Os = sm + L.os;
  uint8_t* Hid = sm + L.hid;
  bf16* Qkv = reinterpret_cast<bf16*>(sm + L.qkv);
  bf16* Kv = reinterpret_cast<bf16*>(sm + L.kv);
  const int tid = threadIdx.x;
  const int cv = C / 8;

  // the tile's input, 16 bytes a thread and LOADS pieces in flight
  constexpr int LOADS = 4;
  if (MEGA) {
    // GroupNorm apply with each row's clip vectors (product and sum rounded
    // separately) into H, then proj_in + b_in -> the residual stream
    for (int i0 = tid; i0 < TM * cv; i0 += LOADS * CONSUMERS) {
      uint4 v[LOADS];
      float4 m[LOADS][2], ad[LOADS][2];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * CONSUMERS, r = i / cv, c = (i - r * cv) * 8;
        v[u] = make_uint4(0, 0, 0, 0);
        if (i < TM * cv && t0 + r < T) {
          v[u] = *reinterpret_cast<const uint4*>(a.x + frame_major(t0 + r, F, a.HW, C) + c);
          const size_t g = (size_t)((t0 + r) / F / a.HW) * C + c;
          m[u][0] = __ldg(reinterpret_cast<const float4*>(a.gn_mul + g));
          m[u][1] = __ldg(reinterpret_cast<const float4*>(a.gn_mul + g + 4));
          ad[u][0] = __ldg(reinterpret_cast<const float4*>(a.gn_add + g));
          ad[u][1] = __ldg(reinterpret_cast<const float4*>(a.gn_add + g + 4));
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * CONSUMERS, r = i / cv, c = (i - r * cv) * 8;
        if (i >= TM * cv) break;
        if (t0 + r < T) {
          const float m8[8] = {m[u][0].x, m[u][0].y, m[u][0].z, m[u][0].w, m[u][1].x, m[u][1].y, m[u][1].z, m[u][1].w};
          const float a8[8] = {ad[u][0].x, ad[u][0].y, ad[u][0].z, ad[u][0].w,
                               ad[u][1].x, ad[u][1].y, ad[u][1].z, ad[u][1].w};
          bf16* e = reinterpret_cast<bf16*>(&v[u]);
#pragma unroll
          for (int q = 0; q < 8; ++q) e[q] = f2bf(__fadd_rn(__fmul_rn(bf2f(e[q]), m8[q]), a8[q]));
        }
        *reinterpret_cast<uint4*>(Hs + tok_off<TM>(r, c)) = v[u];
      }
    }
    fence_proxy_async();
    consumer_sync();
    gemm_rows<TM>(rg, Hs, nk, C, a.b_in,
                  [&](int, int, int off, float v, int) { *reinterpret_cast<bf16*>(Xs + off) = f2bf(v); });
  } else {
    for (int i0 = tid; i0 < TM * cv; i0 += LOADS * CONSUMERS) {
      uint4 v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * CONSUMERS, r = i / cv, c = (i - r * cv) * 8;
        v[u] = make_uint4(0, 0, 0, 0);
        if (i < TM * cv && t0 + r < T) v[u] = *reinterpret_cast<const uint4*>(a.x + (size_t)(t0 + r) * C + c);
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * CONSUMERS, r = i / cv, c = (i - r * cv) * 8;
        if (i < TM * cv) *reinterpret_cast<uint4*>(Xs + tok_off<TM>(r, c)) = v[u];
      }
    }
  }

  // two self-attention sub-blocks; the q|k|v rows of head h are rows
  // [192 h, 192 h + 192) of the packed weight
  const uint32_t first = rank - rank % a.rb;  // the cluster rank of this row's first block
  uint32_t row_phase[2] = {0, 0};
  const int slabs = TM / 16;
  for (int sb = 0; sb < 2; ++sb) {
    layer_norm<TM>(Xs, Hs, C, a.ln_w[sb], a.ln_b[sb], a.eps);
    for (int h0 = 0; h0 < a.heads; h0 += a.hg) {
      const int ng = min(a.hg, a.heads - h0);
      gemm_rows<TM>(rg, Hs, nk, 3 * D * ng, nullptr, [&](int t, int c, int, float v, int) {
        const int hh = c / (3 * D), w = (c % (3 * D)) / D;
        Qkv[((hh * 3 + w) * TM + t) * LDQ + c % D] = f2bf(v);
      });
      if (a.rb > 1) {
        // the row's keys and values (one head a group) from its blocks
        row_sync(&rowbar[0], row_phase[0], first, a.rb);
        cg::cluster_group cluster = cg::this_cluster();
        for (int i = tid; i < 2 * F * (D / 8); i += CONSUMERS) {
          const int w = i / (F * (D / 8)), key = (i / (D / 8)) % F, c = (i % (D / 8)) * 8;
          const bf16* src = cluster.map_shared_rank(Qkv + ((1 + w) * TM + key % TM) * LDQ + c, first + key / TM);
          *reinterpret_cast<uint4*>(Kv + (w * F + key) * LDQ + c) = *reinterpret_cast<const uint4*>(src);
        }
        row_sync(&rowbar[1], row_phase[1], first, a.rb);
      } else {
        consumer_sync();
      }
      for (int u = tid >> 5; u < ng * slabs; u += CONSUMERS / 32) {
        const int hh = u / slabs, q0 = (u % slabs) * 16;
        const bf16* q = Qkv + hh * 3 * TM * LDQ;
        const bf16 *k, *v;
        if (a.rb > 1) {
          k = Kv;
          v = Kv + F * LDQ;
        } else {
          const int kb = F >= 16 ? (q0 / F) * F : q0;
          k = q + (TM + kb) * LDQ;
          v = q + (2 * TM + kb) * LDQ;
        }
        const int col0 = (h0 + hh) * D;
        if (F <= 16) attend<16, TM>(q, k, v, q0, F, a.scale, Os, col0);
        else if (F == 32) attend<32, TM>(q, k, v, q0, F, a.scale, Os, col0);
        else if (F == 64) attend<64, TM>(q, k, v, q0, F, a.scale, Os, col0);
        else attend<128, TM>(q, k, v, q0, F, a.scale, Os, col0);
      }
      fence_proxy_async();
      consumer_sync();
    }
    gemm_rows<TM>(rg, Os, nk, C, a.bo[sb], [&](int, int, int off, float v, int) {
      bf16* d = reinterpret_cast<bf16*>(Xs + off);
      *d = f2bf(bf2f(*d) + round_bf(v));
    });
  }

  feed_forward<TM>(rg, Xs, Hs, Hid, C, a.hc, a.ln_w[2], a.ln_b[2], a.b1, a.b2, a.eps);

  if (MEGA) {
    // proj_out + b_out staged in H, then + x5, written back in frame-major order
    gemm_rows<TM>(rg, Xs, nk, C, a.b_out,
                  [&](int, int, int off, float v, int) { *reinterpret_cast<bf16*>(Hs + off) = f2bf(v); });
    consumer_sync();
    for (int i0 = tid; i0 < TM * cv; i0 += LOADS * CONSUMERS) {
      uint4 xr[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * CONSUMERS, r = i / cv, c = (i - r * cv) * 8;
        if (i < TM * cv && t0 + r < T) xr[u] = *reinterpret_cast<const uint4*>(a.x + frame_major(t0 + r, F, a.HW, C) + c);
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * CONSUMERS, r = i / cv, c = (i - r * cv) * 8;
        if (i >= TM * cv || t0 + r >= T) continue;
        uint4 y = *reinterpret_cast<const uint4*>(Hs + tok_off<TM>(r, c));
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&y);
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xr[u]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 p = __bfloat1622float2(o[q]), xf = __bfloat1622float2(x2[q]);
          o[q] = __floats2bfloat162_rn(xf.x + p.x, xf.y + p.y);
        }
        *reinterpret_cast<uint4*>(a.out + frame_major(t0 + r, F, a.HW, C) + c) = y;
      }
    }
  } else {
    for (int i = tid; i < TM * cv; i += CONSUMERS) {
      const int r = i / cv, c = (i - r * cv) * 8;
      if (t0 + r < T)
        *reinterpret_cast<uint4*>(a.out + (size_t)(t0 + r) * C + c) =
            *reinterpret_cast<const uint4*>(Xs + tok_off<TM>(r, c));
    }
  }
}

// MEGA = false: kernel 10 over x [R, F, C]; MEGA = true: kernel 12 over x5
template <int TM, bool MEGA>
__global__ void __launch_bounds__(THREADS, 1)
temporal_block_tma_kernel(const __grid_constant__ BlockMaps maps, const BlockArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
                                           ~uintptr_t(SMEM_ALIGN - 1));
  const Layout L = layout(TM, a.C, a.F, a.stages, a.hg, a.hc);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + a.stages;
  uint64_t* rowbar = empty + a.stages;
  const uint32_t rank = cluster_rank();
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * a.cl);  // both consumer warpgroups of every block of the cluster
    }
    mbar_init(&rowbar[0], a.rb);
    mbar_init(&rowbar[1], a.rb);
    mbar_fence_init();
  }
  cluster_sync_all();  // every block's barriers are set before any multicast or remote arrival

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) produce<MEGA>(maps, a, sm + L.ring, full, empty, rank);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    Ring rg{sm + L.ring, full, empty, a.stages, a.cl, 0, 0};
    consume<TM, MEGA>(a, sm, L, rg, rowbar, rank);
  }
  __syncwarp();
  cluster_sync_all();  // no block leaves while a peer may still signal it or read its q|k|v
}

// ---- host side ---------------------------------------------------------------------

// The kernel's dynamic shared memory limit, raised once.
template <int TM, bool MEGA>
cudaError_t prepare() {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(temporal_block_tma_kernel<TM, MEGA>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  return cudaSuccess;
}

template <int TM, bool MEGA>
int launch(const BlockMaps& maps, const BlockArgs& a, int smem, void* stream) {
  cudaError_t e = prepare<TM, MEGA>();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (a.R * a.F + TM - 1) / TM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + a.cl - 1) / a.cl * a.cl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, temporal_block_tma_kernel<TM, MEGA>, maps, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan's checks: TM by width, a cluster of whole rows, the hidden chunk,
// and the shared memory the plan reckoned equal to layout()'s.
bool plan_ok(int C, int F, bool mega, int tm, int cl, int stages, int hg, int hc, int smem) {
  if (tm != 16 && tm != 32 && tm != 64) return false;
  if (mega && tm == 16) return false;
  if (C > WROWS * ff_tiles(tm)) return false;
  if (cl != 1 && cl != 2 && cl != 4 && cl != 8) return false;
  const int rb = F > tm ? F / tm : 1;
  if (cl % rb || stages < 2 || hg < 1 || hg > C / D || (rb > 1 && hg != 1)) return false;
  if (hc < WROWS || hc % WROWS || (4 * C) % hc) return false;
  const Layout L = layout(tm, C, F, stages, hg, hc);
  return smem == L.total && smem <= SMEM_MAX;
}

BlockArgs block_args(const void* const* p, int R, int F, int C, float scale, float eps, int tm, int cl, int stages,
                     int hg, int hc) {
  BlockArgs a = {};
  a.x = static_cast<const bf16*>(p[0]);
  a.out = static_cast<bf16*>(const_cast<void*>(p[1]));
  for (int s = 0; s < 2; ++s) {
    a.ln_w[s] = static_cast<const float*>(p[2 + 5 * s]);
    a.ln_b[s] = static_cast<const float*>(p[3 + 5 * s]);
    a.bo[s] = static_cast<const float*>(p[6 + 5 * s]);
  }
  a.ln_w[2] = static_cast<const float*>(p[12]);
  a.ln_b[2] = static_cast<const float*>(p[13]);
  a.b1 = static_cast<const float*>(p[15]);
  a.b2 = static_cast<const float*>(p[17]);
  a.R = R;
  a.F = F;
  a.C = C;
  a.heads = C / D;
  a.cl = cl;
  a.rb = F > tm ? F / tm : 1;
  a.stages = stages;
  a.hg = hg;
  a.hc = hc;
  a.scale = scale;
  a.eps = eps;
  return a;
}

BlockMaps read_maps(const void* maps, int n) {
  BlockMaps m;
  memset(&m, 0, sizeof(m));
  memcpy(&m, maps, n * sizeof(CUtensorMap));
  return m;
}

}  // namespace

// The TMA maps of a block's weights, for a cluster of cl blocks (boxes of 64
// k x 128 / cl rows, 128-byte swizzle), written to out (n x 128 bytes): w
// holds n = 6 device pointers, wqkv1 [3C, C], wo1 [C, C], wqkv2, wo2, w1
// [8C, C], w2 [C, 4C], or n = 8 with kernel 12's w_in [C, C] and w_out [C,
// C]. A map describes only the address, the shape and the box, so the
// caller may keep it for as long as these weights live. stream: unused (the
// convention of every entry point).
extern "C" int ds_block_maps(const void* const* w, int n, int C, int cl, void* out, void* stream) {
  (void)stream;
  if ((n != 6 && n != 8) || C % 64 || C <= 0 || cl < 1 || cl > 8 || WROWS % cl || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const int rows[N_MAPS] = {3 * C, C, 3 * C, C, 8 * C, C, C, C};
  const int cols[N_MAPS] = {C, C, C, C, C, 4 * C, C, C};
  for (int i = 0; i < n; ++i) {
    CUtensorMap m;
    const cuuint64_t dims[2] = {(cuuint64_t)cols[i], (cuuint64_t)rows[i]};
    const cuuint64_t strides[1] = {(cuuint64_t)cols[i] * 2};
    const cuuint32_t box[2] = {BK, (cuuint32_t)(WROWS / cl)};
    if (w[i] == nullptr || !make_map(&m, w[i], 2, dims, strides, box)) return (int)cudaErrorInvalidValue;
    memcpy(static_cast<uint8_t*>(out) + i * sizeof(CUtensorMap), &m, sizeof(CUtensorMap));
  }
  return 0;
}

// How many clusters of the plan fit on the card at once
// (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int ds_block_clusters(int mega, int tm, int cl, int smem, int* out, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaErrorInvalidValue;
#define DS_CLUSTERS(TM_, MEGA_)                                                                      \
  if (tm == TM_ && (bool)mega == MEGA_) {                                                           \
    e = prepare<TM_, MEGA_>();                                                                \
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(out, temporal_block_tma_kernel<TM_, MEGA_>, &cfg); \
  }
  DS_CLUSTERS(16, false)
  DS_CLUSTERS(32, false)
  DS_CLUSTERS(64, false)
  DS_CLUSTERS(32, true)
  DS_CLUSTERS(64, true)
#undef DS_CLUSTERS
  return (int)e;
}

// p: device pointers, in order: x, out, then per attention sub-block s = 1, 2:
// ln_w, ln_b, wqkv [3C, C] (rows: head, then q|k|v, then 64), wo [C, C], bo;
// then ln3_w, ln3_b, w1 [8C, C], b1 [8C], w2 [C, 4C], b2 [C]. x/out [R, F, C]
// bf16, vectors fp32. maps: ds_block_maps of the six weights at this cl. The
// plan (tm, cl, stages, hg, hc, smem) from cuda_lib.block_plan. Shapes the
// caller guarantees: C % 64 == 0, 64 <= C <= 1280, 2 <= F <= 128 with 128 %
// F == 0, every pointer 16-byte aligned and contiguous.
extern "C" int ds_temporal_block(const void* const* p, int R, int F, int C, float scale, float eps, const void* maps,
                                 int tm, int cl, int stages, int hg, int hc, int smem, void* stream) {
  if (C % 64 || C < 64 || C > 1280 || R <= 0 || F < 2 || F > 128 || 128 % F || maps == nullptr ||
      !plan_ok(C, F, false, tm, cl, stages, hg, hc, smem))
    return (int)cudaErrorInvalidValue;
  const BlockArgs a = block_args(p, R, F, C, scale, eps, tm, cl, stages, hg, hc);
  const BlockMaps m = read_maps(maps, 6);
  if (tm == 64) return launch<64, false>(m, a, smem, stream);
  if (tm == 32) return launch<32, false>(m, a, smem, stream);
  return launch<16, false>(m, a, smem, stream);
}

// p: kernel 10's 18 pointers with x / out [B, F, H, W, C], then 18 mul
// [B, C], 19 add [B, C] (fp32), 20 w_in [C, C], 21 b_in [C], 22 w_out
// [C, C], 23 b_out [C]. maps: ds_block_maps of the eight weights. Shapes
// the caller guarantees: C % 64 == 0, 64 <= C <= 640, 2 <= F <= 128 with 128
// % F == 0, every pointer 16-byte aligned and contiguous.
extern "C" int ds_temporal_mega(const void* const* p, int B, int F, int HW, int C, float scale, float eps,
                                const void* maps, int tm, int cl, int stages, int hg, int hc, int smem, void* stream) {
  if (C % 64 || C < 64 || C > 640 || B <= 0 || HW <= 0 || F < 2 || F > 128 || 128 % F || maps == nullptr ||
      !plan_ok(C, F, true, tm, cl, stages, hg, hc, smem))
    return (int)cudaErrorInvalidValue;
  BlockArgs a = block_args(p, B * HW, F, C, scale, eps, tm, cl, stages, hg, hc);
  a.gn_mul = static_cast<const float*>(p[18]);
  a.gn_add = static_cast<const float*>(p[19]);
  a.b_in = static_cast<const float*>(p[21]);
  a.b_out = static_cast<const float*>(p[23]);
  a.HW = HW;
  const BlockMaps m = read_maps(maps, 8);
  if (tm == 64) return launch<64, true>(m, a, smem, stream);
  return launch<32, true>(m, a, smem, stream);
}
