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
// What bounds them: the projections. Per token the block does 16 C^2 + 24
// C^2 multiply-adds (4 + 4 attention projections, 8C + 4C wide FF), kernel
// 12 another 4 C^2 (proj_in, proj_out): 134 + 201 GFLOP at C = 320 and
// 81,920 tokens, against 105 MB of activation traffic, so the tensor cores,
// by ~100x over the memory. The attention itself is F x F per (row, head),
// about 1% of the operations at F = 16.
//
// Design: every F-frame row is independent, so one block owns TM tokens and
// keeps them in shared memory through all three sub-blocks (and, in kernel
// 12, proj_in and proj_out); device memory sees one read and one write of x.
// Where F <= TM the tile holds TM / F whole rows. Where F > TM (F = 128 at
// C <= 320; 64 and 128 at C <= 640; 32, 64 and 128 at C 1280) a row spans
// F / TM blocks (2 to 8) launched as one thread-block cluster: each block
// computes its own tokens' q|k|v of a head, the cluster synchronises, and
// each query reads the row's keys and values from its peers' shared memory
// (distributed shared memory), then synchronises again before the next head
// overwrites them. The TPU kernel's 128-token block-diagonal trick (128 / F
// rows per MXU product, masked) is not copied: the attention runs on CUDA
// cores, 256 / TM threads per query token, each owning 64 / (256 / TM) of
// the 64 head dims (partial dot products joined by shuffles), in two passes
// over the row's keys (max and sum of the exponentials, then the normalised,
// rounded probabilities times V), so no per-key array lives in registers at
// any F. The
// QKV projection runs one head at a time (the packed weight keeps each
// head's q, k and v rows together), so only [TM, 192] of q|k|v is ever
// resident; the head's attention output lands in its 64 columns of O, and
// the out-projection reads O whole. The FF runs over chunks of the GEGLU
// hidden (value chunk, then the gate chunk's epilogue applies GELU in
// place), each chunk's share of the second product added into an fp32
// accumulator (chunks of 128 columns at 64 tokens, 256 at 32 and 16). Every
// product is tile.cuh's 8-warp GEMM (mma.sync, a cp.async weight ring
// streaming across column chunks); the weights stream from L2, 4.1 MB per
// 64-token block at C = 320, so the tokens per block set the L2 traffic and
// the ring's depth how much of its latency hides. No wgmma/TMA yet.
//
// Shared memory, per block (one block per SM; the limit is 232,448 bytes):
// TM tokens x (x, the LN output, and the union of [O | one head's q|k|v] and
// [fp32 FF accumulator | hidden chunk]) + the weight ring:
//   C <= 320:  TM 64, ring 2 x 128 x 72 bf16 (BK 64): 221 KB at C = 320;
//   C <= 512:  TM 32, ring 2 x 256 x 72 (BK 64): 223 KB at C = 512;
//   C <= 640:  TM 32, ring 2 x 256 x 40 (BK 32): 32 x 5,696 B + 40,960 B =
//              223,232 B at C = 640 (with the BK 64 ring it would be 256 KB);
//   C <= 1280: TM 16 tokens, ring BK 32: 16 x 10,816 B + 40,960
//              B = 214,016 B at C = 1280 (32 tokens would need 346 KB of
//              tiles alone).
// Kernel 12 needs no more: its GroupNorm-applied input is staged in the LN
// tile, proj_in writes the residual stream, and proj_out reads it and adds
// x5 from device memory in its epilogue.
//
// Rounding points are those of the plain versions (kernel 10: K1, K1, K4 in
// sequence; kernel 12: kernels 5, 10, 6): the GN-applied input (product and
// sum rounded separately), LN output, q/k/v, probabilities (normalised
// before PV), attention output, projection + bias, residual sum and GEGLU
// value/gate/product are each rounded to bf16; sums accumulate in fp32.

#include <cooperative_groups.h>

#include "tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dstile;

constexpr int D = 64;           // head dim
constexpr int LDQ = 3 * D + 8;  // bf16 pitch of one head's q|k|v

struct BlockArgs {
  const bf16* x;
  bf16* out;
  const float* ln_w[3];
  const float* ln_b[3];
  const bf16* wqkv[2];  // [3C, C], rows (head, q|k|v, 64)
  const bf16* wo[2];    // [C, C]
  const float* bo[2];
  const bf16* w1;       // [8C, C]: value rows, then gate rows
  const float* b1;
  const bf16* w2;       // [C, 4C]
  const float* b2;
  // kernel 12 only: x / out are [B, F, H, W, C]
  const float* gn_mul;  // [B, C] folded GroupNorm vectors
  const float* gn_add;
  const bf16* w_in;     // [C, C]
  const float* b_in;
  const bf16* w_out;    // [C, C]
  const float* b_out;
  int HW;
  int R;
  int F;                // frames per row
  int cl;               // blocks per row: F / TM where F > TM (a cluster), else 1
  int C;
  float scale;
  float eps;
};

// GEGLU hidden columns per FF chunk: one full chunk of the tile's GEMM
__host__ __device__ int hidden_chunk(int tm) { return tm == 64 ? 128 : 256; }
__host__ __device__ int ld_x(int C) { return C + 8; }
__host__ __device__ int union_elems(int C, int tm) {  // bf16 elements per token of the union area
  const int ff = 2 * (C + 4) + hidden_chunk(tm) + 8;  // fp32 accumulator + hidden chunk
  const int attn = ld_x(C) + LDQ;
  return ff > attn ? ff : attn;
}

template <int TM, int BK>
int smem_bytes(int C) { return TM * (2 * ld_x(C) + union_elems(C, TM)) * 2 + Tile<TM, BK>::RING; }

// one head of F-frame attention for the TM tokens: Qk [TM][LDQ] holds the
// head's q | k | v; writes the head's 64 output columns of Out (pitch ldo).
// With cl > 1 the row's keys and values are in the shared memory of the
// cluster's cl blocks (block rank j / TM holds the row's tokens j), and every
// block of the cluster must arrive here: the function synchronises the
// cluster before reading them and after.
template <int TM>
__device__ void attention_rows(const bf16* Qk, bf16* Out, int ldo, float scale, int F, int cl) {
  constexpr int QD = THREADS / TM;  // threads per token
  constexpr int DPT = D / QD;       // head dims per thread
  const int i = threadIdx.x / QD;           // token
  const int qd = (threadIdx.x % QD) * DPT;  // its first head dim
  const bf16* base[8];                      // the row's key tokens 0, TM, 2TM, ... (their blocks' Qk)
  int kcount;                               // keys per base
  if (cl > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's q|k|v of this head is in place
    for (int r = 0; r < cl; ++r) base[r] = cluster.map_shared_rank(Qk, r);
    kcount = TM;
  } else {
    base[0] = Qk + (i / F) * F * LDQ;
    kcount = F;
  }
  const int nb = cl > 1 ? cl : 1;
  float q[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) q[c] = bf2f(Qk[i * LDQ + qd + c]);
  auto logit = [&](const bf16* kv_row) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) s += q[c] * bf2f(kv_row[D + qd + c]);
#pragma unroll
    for (int o = 1; o < QD; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s * scale;
  };
  float m = -INFINITY, l = 0.f;
  for (int r = 0; r < nb; ++r)
    for (int j = 0; j < kcount; ++j) {
      const float s = logit(base[r] + j * LDQ);
      const float mn = fmaxf(m, s);
      l = l * expf(m - mn) + expf(s - mn);
      m = mn;
    }
  float o[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) o[c] = 0.f;
  for (int r = 0; r < nb; ++r)
    for (int j = 0; j < kcount; ++j) {
      const bf16* kv = base[r] + j * LDQ;
      const float p = round_bf(expf(logit(kv) - m) / l);
#pragma unroll
      for (int c = 0; c < DPT; ++c) o[c] += p * bf2f(kv[2 * D + qd + c]);
    }
#pragma unroll
  for (int c = 0; c < DPT; ++c) Out[i * ldo + qd + c] = f2bf(o[c]);
  if (cl > 1) cg::this_cluster().sync();  // the peers are done reading this block's q|k|v
  else __syncthreads();
}

// the x5 element offset of token t (F-frame row t / F = b*HW + hw, frame
// t % F) of kernel 12's [B, F, H, W, C] input
__device__ __forceinline__ size_t frame_major(int t, int F, int HW, int C) {
  const int row = t / F, f = t % F;
  const int b = row / HW, hw = row - b * HW;
  return ((size_t)(b * F + f) * HW + hw) * C;
}

// MEGA = false: kernel 10 over x [R, F, C]; MEGA = true: kernel 12 over x5
template <int TM, int BK, bool MEGA>
__global__ void __launch_bounds__(THREADS) temporal_block_kernel(BlockArgs a) {
  using G = Tile<TM, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C;
  const int ldx = ld_x(C);
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Hs = Xs + TM * ldx;
  bf16* Us = Hs + TM * ldx;
  unsigned char* ring = reinterpret_cast<unsigned char*>(Us + TM * union_elems(C, TM));
  const int T = a.R * a.F;
  const int t0 = blockIdx.x * TM;
  const int cv = C / 8;

  if (MEGA) {
    // GroupNorm apply with each row's clip vectors (product and sum rounded
    // separately) into the LN tile, then proj_in + b_in -> the residual stream
    for (int i = threadIdx.x; i < TM * cv; i += THREADS) {
      const int r = i / cv;
      const int c = (i - r * cv) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t0 + r < T) {
        v = *reinterpret_cast<const uint4*>(a.x + frame_major(t0 + r, a.F, a.HW, C) + c);
        const size_t g = (size_t)((t0 + r) / a.F / a.HW) * C + c;
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          e[q] = f2bf(__fadd_rn(__fmul_rn(bf2f(e[q]), a.gn_mul[g + q]), a.gn_add[g + q]));
      }
      *reinterpret_cast<uint4*>(Hs + r * ldx + c) = v;
    }
    const float* b_in = a.b_in;
    gemm_cols<G>(Hs, ldx, C, a.w_in, C, C, ring,
                 [&](int r, int c, float v) { Xs[r * ldx + c] = f2bf(v + b_in[c]); });
  } else {
    for (int i = threadIdx.x; i < TM * cv; i += THREADS) {
      const int r = i / cv;
      const int c = (i - r * cv) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t0 + r < T) v = *reinterpret_cast<const uint4*>(a.x + (size_t)(t0 + r) * C + c);
      *reinterpret_cast<uint4*>(Xs + r * ldx + c) = v;
    }
    __syncthreads();
  }

  // two self-attention sub-blocks; the q|k|v rows of head h are rows
  // [192 h, 192 h + 192) of the packed weight
  bf16* Os = Us;
  bf16* Qk = Us + TM * ldx;
  for (int s = 0; s < 2; ++s) {
    layer_norm_rows<TM>(Xs, ldx, Hs, ldx, C, a.ln_w[s], a.ln_b[s], a.eps);
    for (int h = 0; h < C / D; ++h) {
      gemm_cols<G>(Hs, ldx, C, a.wqkv[s] + (size_t)h * 3 * D * C, C, 3 * D, ring,
                   [&](int r, int c, float v) { Qk[r * LDQ + c] = f2bf(v); });
      attention_rows<TM>(Qk, Os + h * D, ldx, a.scale, a.F, a.cl);
    }
    const float* bo = a.bo[s];
    gemm_cols<G>(Os, ldx, C, a.wo[s], C, C, ring, [&](int r, int c, float v) {
      bf16& d = Xs[r * ldx + c];
      d = f2bf(bf2f(d) + round_bf(v + bo[c]));
    });
  }

  // GEGLU feed-forward over hidden chunks of hc columns: value product, gate
  // product with GELU in its epilogue, then the chunk's share of the second
  // product added to an fp32 accumulator
  layer_norm_rows<TM>(Xs, ldx, Hs, ldx, C, a.ln_w[2], a.ln_b[2], a.eps);
  const int H4 = 4 * C;
  const int hc = hidden_chunk(TM);
  const int lda = C + 4;
  float* Acc = reinterpret_cast<float*>(Us);
  bf16* Is = reinterpret_cast<bf16*>(Acc + TM * lda);
  const int ldi = hc + 8;
  const float* b1 = a.b1;
  const float* b2 = a.b2;
  for (int i = threadIdx.x; i < TM * lda; i += THREADS) Acc[i] = 0.f;
  for (int j0 = 0; j0 < H4; j0 += hc) {
    gemm_cols<G>(Hs, ldx, C, a.w1 + (size_t)j0 * C, C, hc, ring,
                 [&](int r, int c, float v) { Is[r * ldi + c] = f2bf(v + b1[j0 + c]); });
    gemm_cols<G>(Hs, ldx, C, a.w1 + (size_t)(H4 + j0) * C, C, hc, ring, [&](int r, int c, float v) {
      bf16& d = Is[r * ldi + c];
      d = f2bf(bf2f(d) * gelu_erf(round_bf(v + b1[H4 + j0 + c])));
    });
    gemm_cols<G>(Is, ldi, hc, a.w2 + j0, H4, C, ring, [&](int r, int c, float v) { Acc[r * lda + c] += v; });
  }
  for (int i = threadIdx.x; i < TM * C; i += THREADS) {
    const int r = i / C;
    const int c = i - r * C;
    bf16& d = Xs[r * ldx + c];
    d = f2bf(bf2f(d) + round_bf(Acc[r * lda + c] + b2[c]));
  }
  __syncthreads();

  if (MEGA) {
    // proj_out + b_out, then + x5, written back in frame-major order
    const float* b_out = a.b_out;
    const bf16* x = a.x;
    bf16* out = a.out;
    const int HW = a.HW, Fn = a.F;
    gemm_cols<G>(Xs, ldx, C, a.w_out, C, C, ring, [&](int r, int c, float v) {
      if (t0 + r < T) {
        const size_t e = frame_major(t0 + r, Fn, HW, C) + c;
        out[e] = f2bf(bf2f(x[e]) + round_bf(v + b_out[c]));
      }
    });
  } else {
    for (int i = threadIdx.x; i < TM * cv; i += THREADS) {
      const int r = i / cv;
      const int c = (i - r * cv) * 8;
      if (t0 + r < T)
        *reinterpret_cast<uint4*>(a.out + (size_t)(t0 + r) * C + c) =
            *reinterpret_cast<const uint4*>(Xs + r * ldx + c);
    }
  }
}

template <int TM, int BK, bool MEGA>
int launch(BlockArgs a, void* stream) {
  const int smem = smem_bytes<TM, BK>(a.C);
  cudaError_t e = cudaFuncSetAttribute(temporal_block_kernel<TM, BK, MEGA>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  a.cl = a.F > TM ? a.F / TM : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.R * a.F + TM - 1) / TM);  // a multiple of cl: a row is F / TM whole tiles
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cl > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, temporal_block_kernel<TM, BK, MEGA>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the tile for width C (the reckoning in the note above)
template <bool MEGA>
int launch_for_width(const BlockArgs& a, void* stream) {
  if (a.C <= 320) return launch<64, 64, MEGA>(a, stream);
  if (a.C <= 512) return launch<32, 64, MEGA>(a, stream);
  if (a.C <= 640) return launch<32, 32, MEGA>(a, stream);
  return launch<16, 32, MEGA>(a, stream);
}

BlockArgs block_args(const void* const* p, int R, int F, int C, float scale, float eps) {
  BlockArgs a = {};
  a.x = static_cast<const bf16*>(p[0]);
  a.out = static_cast<bf16*>(const_cast<void*>(p[1]));
  for (int s = 0; s < 2; ++s) {
    a.ln_w[s] = static_cast<const float*>(p[2 + 5 * s]);
    a.ln_b[s] = static_cast<const float*>(p[3 + 5 * s]);
    a.wqkv[s] = static_cast<const bf16*>(p[4 + 5 * s]);
    a.wo[s] = static_cast<const bf16*>(p[5 + 5 * s]);
    a.bo[s] = static_cast<const float*>(p[6 + 5 * s]);
  }
  a.ln_w[2] = static_cast<const float*>(p[12]);
  a.ln_b[2] = static_cast<const float*>(p[13]);
  a.w1 = static_cast<const bf16*>(p[14]);
  a.b1 = static_cast<const float*>(p[15]);
  a.w2 = static_cast<const bf16*>(p[16]);
  a.b2 = static_cast<const float*>(p[17]);
  a.R = R;
  a.F = F;
  a.C = C;
  a.scale = scale;
  a.eps = eps;
  return a;
}

}  // namespace

// p: device pointers, in order: x, out, then per attention sub-block s = 1, 2:
// ln_w, ln_b, wqkv [3C, C] (rows: head, then q|k|v, then 64), wo [C, C], bo;
// then ln3_w, ln3_b, w1 [8C, C],
// b1 [8C], w2 [C, 4C], b2 [C]. x/out [R, F, C] bf16, vectors fp32.
// Shapes the caller guarantees: C % 64 == 0, 64 <= C <= 1280, 2 <= F <= 128
// with 128 % F == 0, every pointer 16-byte aligned and contiguous.
extern "C" int ds_temporal_block(const void* const* p, int R, int F, int C, float scale, float eps,
                                 void* stream) {
  if (C % 64 || C < 64 || C > 1280 || R <= 0 || F < 2 || F > 128 || 128 % F) return (int)cudaErrorInvalidValue;
  return launch_for_width<false>(block_args(p, R, F, C, scale, eps), stream);
}

// p: kernel 10's 18 pointers with x / out [B, F, H, W, C], then 18 mul
// [B, C], 19 add [B, C] (fp32), 20 w_in [C, C], 21 b_in [C], 22 w_out
// [C, C], 23 b_out [C]. Shapes the caller guarantees: C % 64 == 0, 64 <= C
// <= 640, 2 <= F <= 128 with 128 % F == 0, every pointer 16-byte aligned and
// contiguous.
extern "C" int ds_temporal_mega(const void* const* p, int B, int F, int HW, int C, float scale, float eps,
                                void* stream) {
  if (C % 64 || C < 64 || C > 640 || B <= 0 || HW <= 0 || F < 2 || F > 128 || 128 % F)
    return (int)cudaErrorInvalidValue;
  BlockArgs a = block_args(p, B * HW, F, C, scale, eps);
  a.gn_mul = static_cast<const float*>(p[18]);
  a.gn_add = static_cast<const float*>(p[19]);
  a.w_in = static_cast<const bf16*>(p[20]);
  a.b_in = static_cast<const float*>(p[21]);
  a.w_out = static_cast<const bf16*>(p[22]);
  a.b_out = static_cast<const float*>(p[23]);
  a.HW = HW;
  return launch_for_width<true>(a, stream);
}
