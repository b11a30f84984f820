// bf16 GEMM with an optional LayerNorm or GroupNorm prologue, an optional
// row map and three epilogues, for every projection of the UNet
// transformers: a Hopper kernel (TMA ring on mbarriers, wgmma, warp
// specialisation, a persistent grid).
//
// Replaces the projection halves of the TPU kernels
//   dynamicscaler_tpu/ops/fused_temporal.py::_kernel     (K1: LN -> QKV, out-proj + residual)
//   dynamicscaler_tpu/ops/fused_temporal.py::_ff_kernel  (K4: LN -> GEGLU, FF2 + residual)
//   dynamicscaler_tpu/ops/fused_spatial.py::_kernel      (K2: LN -> QKV, out-proj + residual)
//   dynamicscaler_tpu/ops/fused_spatial.py::_cross_kernel(K3: LN -> Q, context KV, out-proj)
// and the whole of the transformer-wrapper kernels
//   dynamicscaler_tpu/ops/fused_twrap.py::_head_kernel   (5 _head_temporal, 7 _head_spatial:
//                                                          GN apply [-> frame permute] -> proj_in)
//   dynamicscaler_tpu/ops/fused_twrap.py::_tail_kernel   (6 _tail_temporal, 8 _tail_spatial:
//                                                          proj_out [-> permute back] + residual)
//
// Y[M, N_out] = epilogue( prologue(X)[M, K] @ W[N, K]^T ),  W in torch Linear layout.
//   prologue:
//     LN: A = LN(X): flax fast-variance statistics in fp32,
//             var = max(0, E[x^2] - mu^2), h = (x - mu) * (rstd * s) + b, rounded
//             to bf16 before the product, as the TPU kernels do.
//     GN: A = bf16(x * mul[s] + add[s]) with the folded GroupNorm vectors
//             mul/add [S, K] fp32 of sample s = r / rows_per_sample, applied
//             per row; product and sum rounded separately (__fmul_rn,
//             __fadd_rn), as the plain version computes them.
//   row map (the frame permute of the temporal wrappers: logical row
//   r = (b*HW + hw)*F + f <-> stored row (b*F + f)*HW + hw of a [B, F, H, W, C]
//   tensor):
//     MAP_A:   A row r is read from X's stored row map(r)   (temporal head)
//     MAP_OUT: output row r is written to, and its residual read from,
//              stored row map(r)                           (temporal tail)
//   mode 0: y = bf16(acc [+ bias])
//   mode 1: y = bf16(bf16(acc [+ bias]) + R)              (out-proj / FF2 / wrapper tail + residual)
//   mode 2: GEGLU. The B tile holds BN/2 value rows n0.. and the BN/2 gate rows
//           N/2 + n0.. of W (two TMA boxes per stage), so value column c and
//           gate column c + BN/2 sit in the same thread's accumulator registers:
//           a = bf16(acc [+ bias]); y = bf16(f32(a_val) * gelu_erf(f32(a_gate))),
//           N_out = N / 2.
//
// What bounds it on the H100. The products are compute-bound at nearly every
// UNet shape (M up to 8*16*2560 = 327680 tokens, K and N 320..10240: 2MNK
// operations against 2(MK + NK + MN) bytes is 100-1700 operations a byte
// against the card's 295); the C 320 wrapper heads and tails (K = N = 320 at
// M = 327680, ~100 operations a byte) are byte-bound. So the design keeps the
// tensor cores fed and streams every operand once:
//   * a persistent grid (one block per SM) walks the 128 x BN output tiles
//     (chosen per shape on the host: cuda_lib.gemm_tile), column tiles
//     fastest, so the blocks in flight share their A rows in L2;
//   * a producer thread fills a ring of `stages` (A, B) tiles in shared
//     memory with TMA copies (cp.async.bulk.tensor, 128-byte swizzle,
//     completion on an mbarrier per stage; out-of-bounds rows of a ragged M
//     or N arrive as zeros), K in steps of 64 (one swizzle row of bf16); the
//     ring runs on across tiles, so the next tile's loads overlap this one's
//     epilogue;
//   * two consumer warpgroups issue wgmma with both operands in shared
//     memory and fp32 accumulators in registers, and release each stage on a
//     second mbarrier (setmaxnreg hands the producer warpgroup's unused
//     registers to them), on one of two schedules that cuda_lib.gemm_tile
//     picks per (M, K, N, mode) from a cost model fitted to the card's times
//     (chip_smoke.py phase 3 times every forward shape on both):
//     - cooperative (ds_ln_gemm, ds_gemm_kernel<BN>, BN 64, 128, 256 or
//       320): both warpgroups work on the same 128 x BN tile, 64 rows each
//       (wgmma m64nBNk16; at BN 320 two m64n160k16 products side by side),
//       so the two share each B tile: the fewest operand bytes a product
//       (BN 256 reads a third fewer than 128 x 128). BN 320 spans a whole
//       N-320 GEMM (the C 320 level's store and residual shapes): each A row
//       block is staged once and W exactly once, with no zero columns (BN
//       128 stages A three times and pads 320 to 384; 256 pads to 512).
//       Their epilogue runs together after the tile's last product: bias
//       (and GEGLU) from the registers into a bf16 staging tile of its own
//       (not the ring, which already loads the next tile), then each row out
//       in 16-byte pieces, the residual read the same way and the output row
//       map applied per row (one product's columns at a time, so BN 320's
//       staging is 160 wide and three ring stages still fit beside it: a
//       320-wide one would leave room for two); no product is issued
//       meanwhile. Chosen where the
//       products dwarf the epilogue (long K) or where the GEGLU epilogue,
//       heavy in erff, wants both warpgroups' warps at once (K 320-512);
//     - ping-pong (ds_ln_gemm_pingpong, ds_gemm_kernel_pingpong<BN>): each
//       warpgroup owns whole 128 x BN tiles, BN 128 or 160 (two m64nBNk16
//       products a k16 step; 160 makes an N-320 GEMM two column tiles, not
//       three, with no padding), the block's tiles alternating between
//       them; a pair of named barriers gives the tensor cores to one
//       warpgroup's mainloop at a time, and each warpgroup's epilogue runs
//       under the other's mainloop.
//       The epilogue's memory traffic leaves the instruction stream: the
//       producer loads the residual tile by TMA into the warpgroup's output
//       tile (64-column boxes in the 128-byte swizzle; at BN 160 32-column
//       boxes in the 64-byte swizzle; MAP_OUT as a 3-D box {64 or 32, hb,
//       F} over [B*F, HW, N]) ahead of the epilogue, on an mbarrier of
//       its own; the epilogue rounds in place and one thread stores the tile
//       by TMA (bulk-group commit, then wait for the read before the tile is
//       reused, on a second mbarrier). Where no box fits the clip (MAP_OUT at
//       a 10x10 or 5x5 level) the rows leave one by one as in the
//       cooperative epilogue. Chosen for the residual epilogues, where the
//       cooperative kernel waits on the residual's reads (K 320 / N 320 +
//       residual 0.547 -> 0.289 ms), and most other shapes of the forward;
//     both round and order the same: outputs are bit-identical;
//   * the frame permute of the temporal head is a 3-D TMA box: 128 logical
//     rows are hb = 128 / F hw positions x F frames of one clip, and the box
//     {64, hb, F} over [B*F, HW, K] lands them frame-major in shared memory;
//     the epilogue maps accumulator row i to logical row (i % hb) * F + i / hb,
//     so the permutation is in the addresses, not the data. Where hb
//     positions do not tile a clip's H*W (or F does not divide 128), a box
//     would run across the clip's edge, so the GroupNorm prologue pass
//     gathers the rows into logical order instead (same bytes: it reads and
//     writes M x K once either way) and the GEMM reads them unmapped;
//   * the prologue is one streaming pass before the GEMM (prologue_ln_kernel,
//     prologue_gn_kernel) that writes the normalised bf16 rows, in X's stored
//     order, to scratch the wrapper allocates; the GEMM reads them like any A.
//     Rewriting the A tile in shared memory inside the GEMM (in the consumer
//     warpgroups, or in spare warps of the producer's) repeats the prologue
//     for every column tile of the same rows (N / BN times: 20 at N = 5120)
//     and held the LN GEMMs well below the rate of the same GEMM without it;
//     the pass costs one write and one read of M x K bf16, about a tenth of
//     these GEMMs' time a forward (the pass is launched by ds_ln_gemm, so its
//     time is the GEMM's; chip_smoke.py phase 3 times it alone).
// Not done yet: clusters with multicast of the A tile, the prologue pass fused
// into the previous kernel's epilogue.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int BM = 128;                  // rows per tile (cooperative: two consumer warpgroups of 64)
constexpr int BK = 64;                   // K per stage: one 128-byte swizzle row of bf16
constexpr int A_BYTES = BM * BK * 2;     // 16 KB per stage
constexpr int SMEM_MAX = 232448;         // the H100's per-block limit
constexpr int SMEM_ALIGN = 1024;         // the 128-byte swizzle repeats every 8 rows of 128 bytes
// Warpgroups 0 and 1 consume (wgmma), the first thread of warpgroup 2
// produces. ptxas compiles the block at the launch bound's 168 registers a
// thread; setmaxnreg moves warpgroup 2's share to the consumers.
constexpr int THREADS = 384;
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;  // 2 * 128 * 232 + 128 * 40 = 64512 of the 65536

enum { MAP_NONE = 0, MAP_A = 1, MAP_OUT = 2 };


struct Params {
  int M, K, N;                 // N: rows of W (2 * N_out in mode 2)
  int mode, map;
  int map_F, map_HW, map_hb;   // frame map; map_hb = 128 / map_F (MAP_A; MAP_OUT as a TMA box)
  int k_tiles, stages, n_tiles, tiles;
  int out_tma;                 // ping-pong: the output tile leaves by TMA (and the residual arrives so)
  const float* bias;           // [N] or null
  const bf16* R;               // mode 1: [M, N]
  bf16* Y;
};

// Width of one wgmma product of a cooperative tile BN wide: the tile itself
// up to 256 (wgmma's widest), else two products of BN / 2 (BN 320: two
// m64n160 products side by side, columns 0-159 and 160-319).
__host__ __device__ constexpr int product_n(int bn) { return bn > 256 ? bn / 2 : bn; }

// bf16 staging of the output for the cooperative epilogue, one product's
// columns at a time: 128 rows of product_n(BN) values, the row pitch padded
// by 8 (the accumulator stores hit distinct banks).
__host__ __device__ constexpr int epilogue_pitch(int bn) { return product_n(bn) + 8; }
__host__ __device__ constexpr int epilogue_bytes(int bn) { return BM * epilogue_pitch(bn) * 2; }

// Accumulator i of a thread's row of a tile held as products of H values
// each (the flat layout of one wgmma as wide as the tile; i is a constant
// after unrolling, so this stays in registers).
template <int P, int H>
__device__ __forceinline__ float& acc_at(float (&acc)[P][H], int i) {
  return acc[i / H][i % H];
}

__device__ __forceinline__ float gelu_erf(float g) {
  return g * 0.5f * (1.0f + erff(g * 0.70710678118654752f));
}

// Stored row of logical row r = (b*HW + hw)*F + f in a [B, F, H, W, .] tensor.
__device__ __forceinline__ size_t frame_major_row(int r, int F, int HW) {
  const int f = r % F;
  const int bhw = r / F;
  const int b = bhw / HW;
  return ((size_t)b * F + f) * HW + (bhw - b * HW);
}

// Logical row of row i of the tile at m0 (the MAP_A box lands frame-major).
__device__ __forceinline__ int logical_row(const Params& p, int m0, int i) {
  return p.map == MAP_A ? m0 + (i % p.map_hb) * p.map_F + i / p.map_hb : m0 + i;
}

// ---- the prologue passes ----------------------------------------------------------

// A = LN(X) row by row (K % 8 == 0), one warp per row: fp32 sum and sum of
// squares over the row, then the row again (from L1) normalised to bf16.
__global__ void __launch_bounds__(256) prologue_ln_kernel(const bf16* __restrict__ X, int M, int K,
                                                          const float* __restrict__ ln_w,
                                                          const float* __restrict__ ln_b, float eps,
                                                          bf16* __restrict__ A) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const bf16* x = X + (size_t)row * K;
  float s = 0.f, ss = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + k);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      s += f.x + f.y;
      ss += f.x * f.x + f.y * f.y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / (float)K;
  const float rstd = rsqrtf(fast_variance(ss / (float)K, mu) + eps);
  bf16* a = A + (size_t)row * K;
  for (int k = lane * 8; k < K; k += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(x + k);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(ln_w + k));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(ln_w + k + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(ln_b + k));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(ln_b + k + 4));
    const float w8[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      h[q] = __floats2bfloat162_rn((f.x - mu) * (rstd * w8[2 * q]) + b8[2 * q],
                                   (f.y - mu) * (rstd * w8[2 * q + 1]) + b8[2 * q + 1]);
    }
    *reinterpret_cast<uint4*>(a + k) = v;
  }
}

// A = bf16(X * mul[s] + add[s]) for s = row / rows_per_sample, 8 values a
// thread. A's rows are X's stored rows in their stored order, or, with a
// frame map (map_F > 0: the temporal head where its 3-D TMA box does not fit
// the clip), A's row r is X's stored row frame_major_row(r), so the GEMM
// reads A in logical order with a plain 2-D box (a sample's rows are whole
// clips, so r and its stored row share the sample).
__global__ void __launch_bounds__(256) prologue_gn_kernel(const bf16* __restrict__ X, long long chunks, int K,
                                                          const float* __restrict__ mul,
                                                          const float* __restrict__ add, int rows_per_sample,
                                                          int map_F, int map_HW, bf16* __restrict__ A) {
  const int per_row = K / 8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < chunks;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / per_row;
    const int k = (int)(i - row * per_row) * 8;
    const size_t v0 = (size_t)(row / rows_per_sample) * K + k;
    const size_t src = map_F > 0 ? frame_major_row((int)row, map_F, map_HW) : (size_t)row;
    uint4 v = *reinterpret_cast<const uint4*>(X + src * K + k);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
    const float4 m0 = __ldg(reinterpret_cast<const float4*>(mul + v0));
    const float4 m1 = __ldg(reinterpret_cast<const float4*>(mul + v0 + 4));
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(add + v0));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(add + v0 + 4));
    const float m8[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
    const float a8[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      h[q] = __floats2bfloat162_rn(__fadd_rn(__fmul_rn(f.x, m8[2 * q]), a8[2 * q]),
                                   __fadd_rn(__fmul_rn(f.y, m8[2 * q + 1]), a8[2 * q + 1]));
    }
    *reinterpret_cast<uint4*>(A + row * K + k) = v;
  }
}

// ---- the GEMM -----------------------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
ds_gemm_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB, const Params p) {
  constexpr int B_BYTES = BN * BK * 2;
  constexpr int STAGE = A_BYTES + B_BYTES;
  constexpr int PN = product_n(BN);  // columns of one wgmma product
  constexpr int P = BN / PN;         // products a k16 step (2 at BN 320)
  constexpr int ACC = PN / 2;        // fp32 accumulators per consumer thread and product
  constexpr int PITCH = epilogue_pitch(BN);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
                                             ~uintptr_t(SMEM_ALIGN - 1));
  const int S = p.stages;
  bf16* staging = reinterpret_cast<bf16*>(smem + S * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * STAGE + epilogue_bytes(BN));  // TMA landed
  uint64_t* empty = full + S;                                                           // consumers done
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int KT = p.k_tiles;
  const bool geglu = p.mode == 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA copy, tile after tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      int it = 0;  // k steps issued so far, across tiles: the ring position
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.n_tiles) * BM;
        const int n0 = (tile % p.n_tiles) * (geglu ? BN / 2 : BN);
        int a1 = m0, a2 = 0;  // MAP_A: hw0 and b*F of the tile's clip
        if (p.map == MAP_A) {
          const int bhw = m0 / p.map_F;
          a2 = (bhw / p.map_HW) * p.map_F;
          a1 = bhw % p.map_HW;
        }
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* sa = smem + s * STAGE;
          uint8_t* sb = sa + A_BYTES;
          mbar_expect_tx(&full[s], STAGE);
          if (p.map == MAP_A) tma_load_3d(sa, &tmA, &full[s], kt * BK, a1, a2);
          else tma_load_2d(sa, &tmA, &full[s], kt * BK, a1);
          if (geglu || P > 1) {  // two boxes of BN / 2 rows: value and gate rows, or BN 320's halves
            tma_load_2d(sb, &tmB, &full[s], kt * BK, n0);
            tma_load_2d(sb + B_BYTES / 2, &tmB, &full[s], kt * BK, (geglu ? p.N / 2 : BN / 2) + n0);
          } else {
            tma_load_2d(sb, &tmB, &full[s], kt * BK, n0);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows wg*64 .. wg*64+63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int warp = tid >> 5, lane = tid & 31;
    const int n_out = geglu ? p.N / 2 : p.N;
    // 8-output pieces of a staged row: a product's columns, or in GEGLU the
    // BN / 2 outputs of the whole tile (value and gate paired)
    const int units = geglu ? BN / 16 : PN / 8;
    bf16* stage_rows = staging + wg * 64 * PITCH;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.n_tiles) * BM;
      const int n0 = (tile % p.n_tiles) * (geglu ? BN / 2 : BN);
      float acc[P][ACC];
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[j][i] = 0.f;
      // Per stage: wait for it, issue the products, wait for them, hand the
      // stage back; the two warpgroups take turns on the tensor cores.
      // (Keeping a group in flight, wait_group 1, makes ptxas serialize the
      // wgmmas here: C7515.)
#pragma unroll 1
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        const uint64_t da = smem_desc(smem + s * STAGE + wg * 64 * 128);
        const uint64_t db = smem_desc(smem + s * STAGE + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
#pragma unroll
          for (int j = 0; j < P; ++j) Wgmma<PN>::mma(acc[j], da + 2 * k, db + j * (PN * 128 >> 4) + 2 * k, 1);
        wgmma_commit();
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int j = 0; j < P; ++j) fence_acc(acc[j]);

      // ---- epilogue ----
      // Thread (warp w, lane l) holds rows 16w + l/4 (+8) and, for each
      // 8-column group g of the tile, columns 8g + 2(l%4) + {0, 1}:
      // acc_at(4g + 2h + {0, 1}) for row half h. Bias (and GEGLU) here, into
      // the bf16 staging rows, one product's columns a pass (GEGLU: its
      // BN / 2 outputs in one pass, value column c paired with gate column
      // c + BN / 2).
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (geglu && j > 0) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bf16* srow = stage_rows + (warp * 16 + (lane >> 2) + 8 * h) * PITCH + 2 * (lane & 3);
          if (geglu) {
#pragma unroll
            for (int g = 0; g < BN / 16; ++g) {
              const int n = n0 + 8 * g + 2 * (lane & 3);
              float2 v = make_float2(acc_at(acc, 4 * g + 2 * h), acc_at(acc, 4 * g + 2 * h + 1));
              float2 gt = make_float2(acc_at(acc, 4 * (g + BN / 16) + 2 * h),
                                      acc_at(acc, 4 * (g + BN / 16) + 2 * h + 1));
              if (p.bias) {
                const float2 bv = __ldg(reinterpret_cast<const float2*>(p.bias + n));
                const float2 bg = __ldg(reinterpret_cast<const float2*>(p.bias + p.N / 2 + n));
                v.x += bv.x; v.y += bv.y; gt.x += bg.x; gt.y += bg.y;
              }
              v = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
              gt = __bfloat1622float2(__floats2bfloat162_rn(gt.x, gt.y));
              *reinterpret_cast<__nv_bfloat162*>(srow + 8 * g) =
                  __floats2bfloat162_rn(v.x * gelu_erf(gt.x), v.y * gelu_erf(gt.y));
            }
          } else {
#pragma unroll
            for (int g = 0; g < PN / 8; ++g) {
              const int n = n0 + j * PN + 8 * g + 2 * (lane & 3);
              float2 v = make_float2(acc[j][4 * g + 2 * h], acc[j][4 * g + 2 * h + 1]);
              if (p.bias && n < p.N) {
                const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + n));
                v.x += b.x; v.y += b.y;
              }
              *reinterpret_cast<__nv_bfloat162*>(srow + 8 * g) = __floats2bfloat162_rn(v.x, v.y);
            }
          }
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        // Rows out in 16-byte pieces, the residual added in bf16 (mode 1).
#pragma unroll 4
        for (int q = tid; q < 64 * units; q += 128) {
          const int rr = q / units, u = q - rr * units;
          const int m = logical_row(p, m0, wg * 64 + rr);
          const int n = n0 + j * PN + 8 * u;
          if (m >= p.M || n >= n_out) continue;  // a ragged last row or column tile
          const size_t row = p.map == MAP_OUT ? frame_major_row(m, p.map_F, p.map_HW) : (size_t)m;
          uint4 out = *reinterpret_cast<const uint4*>(stage_rows + rr * PITCH + 8 * u);
          if (p.mode == 1) {
            const uint4 rv = __ldg(reinterpret_cast<const uint4*>(p.R + row * n_out + n));
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
            const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 a = __bfloat1622float2(o[e]), b = __bfloat1622float2(r2[e]);
              o[e] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
            }
          }
          *reinterpret_cast<uint4*>(p.Y + row * n_out + n) = out;
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // staging free again
      }
    }
  }
}

// ---- the ping-pong schedule ---------------------------------------------------------

// A ping-pong warpgroup's output tile in shared memory: 128 rows of BN bf16
// as BN / OC blocks of [128][OC], the box layout of the TMA store (and of the
// residual's TMA load into the same bytes): OC 64 columns in the 128-byte
// swizzle where 64 divides BN, else (BN 160) 32 columns in the 64-byte
// swizzle, so that no box runs into the next tile's columns.
__host__ __device__ constexpr int pp_out_bytes(int bn) { return BM * bn * 2; }
__host__ __device__ constexpr int pp_box_cols(int bn) { return bn % 64 == 0 ? 64 : 32; }

// Byte offset of (row r, column c) in that tile: in a block of OC-column
// rows (2 * OC bytes), 16-byte piece q of the 128-byte line at offset o
// lands at q ^ ((o / 128) % (2 * OC / 16)): the TMA swizzle of that width.
// So the 8 rows of an accumulator store hit 8 distinct pieces (all 32 banks).
template <int OC>
__device__ __forceinline__ int swizzled(int r, int c) {
  const int o = r * (2 * OC) + ((c % OC) << 1);
  return (c / OC) * (BM * 2 * OC) + (o ^ (((o >> 7) & (2 * OC / 16 - 1)) << 4));
}

// Row of the output tile in shared memory for accumulator row i: the
// logical row under MAP_A (the A box lands frame-major, the output is
// stored in logical order), the 3-D box's frame-major row under MAP_OUT
// (row f * hb + hw of the box holds logical row hw * F + f), else i.
__device__ __forceinline__ int out_row(const Params& p, int i) {
  if (p.map == MAP_A) return (i % p.map_hb) * p.map_F + i / p.map_hb;
  if (p.map == MAP_OUT && p.out_tma) return (i % p.map_F) * p.map_hb + i / p.map_F;
  return i;
}

// hw0 and b*F of the tile at m0 under a frame map: the coordinates of the
// 3-D boxes {64, hb, F} over [B*F, HW, .] (A under MAP_A, the output and
// residual under MAP_OUT)
__device__ __forceinline__ void clip_coords(const Params& p, int m0, int& hw0, int& bF) {
  const int bhw = m0 / p.map_F;
  bF = (bhw / p.map_HW) * p.map_F;
  hw0 = bhw % p.map_HW;
}

// Ping-pong: each consumer warpgroup owns whole 128 x BN tiles, the block's
// tiles alternating between warpgroup 0 and 1. Named barrier 3 + w is
// warpgroup w's turn on the tensor cores: a warpgroup issues its whole
// mainloop, hands the turn to the other and runs its epilogue (bias, GEGLU,
// rounding, residual, store) under the other's mainloop. The producer fills
// the ring in the tiles' order and loads each residual tile by TMA into its
// warpgroup's output tile ahead of the epilogue; the epilogue rounds in place
// and one thread stores the tile by TMA. One k step's products stay in
// flight while the next step's are issued (the cooperative schedule waits
// for each step's: there the other warpgroup fills the gap).
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
ds_gemm_kernel_pingpong(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                        const __grid_constant__ CUtensorMap tmR, const __grid_constant__ CUtensorMap tmY,
                        const Params p) {
  constexpr int B_BYTES = BN * BK * 2;
  constexpr int STAGE = A_BYTES + B_BYTES;
  constexpr int ACC = BN / 2;  // fp32 accumulators per thread for each 64-row half of the tile
  constexpr int OUT = pp_out_bytes(BN);
  constexpr int OC = pp_box_cols(BN);
  constexpr int BOX = BM * OC * 2;  // bytes of one OC-column box of the output tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
                                             ~uintptr_t(SMEM_ALIGN - 1));
  const int S = p.stages;
  uint8_t* outs = smem + S * STAGE;                                    // warpgroup w's tile at w * OUT
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * OUT);        // TMA landed
  uint64_t* empty = full + S;                                          // products done
  uint64_t* res_full = empty + S;                                      // [2] residual tile landed
  uint64_t* out_free = res_full + 2;                                   // [2] output tile read by its store
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int KT = p.k_tiles;
  const bool geglu = p.mode == 2;
  const bool res_tma = p.mode == 1 && p.out_tma;
  const int n_out = geglu ? p.N / 2 : p.N;
  const int cols = geglu ? BN / 2 : BN;  // output columns of a tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(&res_full[w], 1);
      mbar_init(&out_free[w], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool out3d = p.map == MAP_OUT && p.out_tma;  // the output (and residual) box is 3-D

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      int it = 0;
      for (int q = 0, tile = blockIdx.x; tile < p.tiles; ++q, tile += gridDim.x) {
        const int m0 = (tile / p.n_tiles) * BM;
        const int n0 = (tile % p.n_tiles) * cols;
        int a1 = m0, a2 = 0;  // MAP_A: hw0 and b*F of the tile's clip
        if (p.map == MAP_A) clip_coords(p, m0, a1, a2);
        int c1 = m0, c2 = 0;  // the residual box's
        if (out3d) clip_coords(p, m0, c1, c2);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* sa = smem + s * STAGE;
          uint8_t* sb = sa + A_BYTES;
          mbar_expect_tx(&full[s], STAGE);
          if (p.map == MAP_A) tma_load_3d(sa, &tmA, &full[s], kt * BK, a1, a2);
          else tma_load_2d(sa, &tmA, &full[s], kt * BK, a1);
          if (geglu) {
            tma_load_2d(sb, &tmB, &full[s], kt * BK, n0);
            tma_load_2d(sb + B_BYTES / 2, &tmB, &full[s], kt * BK, p.N / 2 + n0);
          } else {
            tma_load_2d(sb, &tmB, &full[s], kt * BK, n0);
          }
          if (kt == 0 && res_tma) {
            // the tile's residual into its warpgroup's output tile, once the
            // store of that warpgroup's previous tile has read it
            const int w = q & 1, j = q >> 1;
            if (j > 0) mbar_wait(&out_free[w], (j - 1) & 1);
            uint8_t* dst = outs + w * OUT;
            const int boxes = ((n_out - n0 < cols ? n_out - n0 : cols) + OC - 1) / OC;
            mbar_expect_tx(&res_full[w], boxes * BOX);
            for (int b = 0; b < boxes; ++b) {
              if (out3d) tma_load_3d(dst + b * BOX, &tmR, &res_full[w], n0 + OC * b, c1, c2);
              else tma_load_2d(dst + b * BOX, &tmR, &res_full[w], n0 + OC * b, c1);
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int w = wg;
    const int warp = tid >> 5, lane = tid & 31;
    uint8_t* out = outs + w * OUT;
    if (w == 1) bar_arrive(3, 256);  // warpgroup 0 takes the tensor cores first
    for (int q = w, j = 0, tile = blockIdx.x + w * gridDim.x; tile < p.tiles;
         q += 2, ++j, tile += 2 * gridDim.x) {
      const int m0 = (tile / p.n_tiles) * BM;
      const int n0 = (tile % p.n_tiles) * cols;
      const bool handoff = tile + (int)gridDim.x < p.tiles;  // the block's next tile, the other warpgroup's
      float acc[2][ACC];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[h][i] = 0.f;

      bar_sync(3 + w, 256);  // this warpgroup's turn
      int it = q * KT;       // the ring runs through the tiles in the block's order
#pragma unroll 1
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        const uint64_t da = smem_desc(smem + s * STAGE);
        const uint64_t db = smem_desc(smem + s * STAGE + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          Wgmma<BN>::mma(acc[0], da + 2 * k, db + 2 * k, 1);
          Wgmma<BN>::mma(acc[1], da + (64 * 128 >> 4) + 2 * k, db + 2 * k, 1);
        }
        wgmma_commit();
        if (kt == KT - 1 && handoff) bar_arrive(4 - w, 256);  // all issued: the other warpgroup's turn
        wgmma_wait<1>();  // the previous step's products are done: hand its stage back
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);
      fence_acc(acc[0]);
      fence_acc(acc[1]);

      // ---- epilogue, under the other warpgroup's mainloop ----
      if (res_tma) mbar_wait(&res_full[w], j & 1);
      else if (p.out_tma && j > 0) mbar_wait(&out_free[w], (j - 1) & 1);
      // Thread (warp v, lane l) holds, in each half mh, rows 64 mh + 16v + l/4
      // (+8) and, for each 8-column group g, columns 8g + 2(l%4) + {0, 1}:
      // acc[mh][4g + 2h + {0, 1}] for row half h.
#pragma unroll
      for (int mh = 0; mh < 2; ++mh) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = out_row(p, mh * 64 + warp * 16 + (lane >> 2) + 8 * h);
          if (geglu) {
#pragma unroll
            for (int g = 0; g < BN / 16; ++g) {
              const int c = 8 * g + 2 * (lane & 3);
              float2 v = make_float2(acc[mh][4 * g + 2 * h], acc[mh][4 * g + 2 * h + 1]);
              float2 gt = make_float2(acc[mh][4 * (g + BN / 16) + 2 * h], acc[mh][4 * (g + BN / 16) + 2 * h + 1]);
              if (p.bias) {
                const float2 bv = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + c));
                const float2 bg = __ldg(reinterpret_cast<const float2*>(p.bias + p.N / 2 + n0 + c));
                v.x += bv.x; v.y += bv.y; gt.x += bg.x; gt.y += bg.y;
              }
              v = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
              gt = __bfloat1622float2(__floats2bfloat162_rn(gt.x, gt.y));
              *reinterpret_cast<__nv_bfloat162*>(out + swizzled<OC>(r, c)) =
                  __floats2bfloat162_rn(v.x * gelu_erf(gt.x), v.y * gelu_erf(gt.y));
            }
          } else {
#pragma unroll
            for (int g = 0; g < BN / 8; ++g) {
              const int c = 8 * g + 2 * (lane & 3);
              float2 v = make_float2(acc[mh][4 * g + 2 * h], acc[mh][4 * g + 2 * h + 1]);
              if (p.bias && n0 + c < p.N) {
                const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + c));
                v.x += b.x; v.y += b.y;
              }
              __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + swizzled<OC>(r, c));
              __nv_bfloat162 y = __floats2bfloat162_rn(v.x, v.y);
              if (res_tma) {  // bf16(acc [+ bias]) + R, rounded again
                const float2 a = __bfloat1622float2(y), rv = __bfloat1622float2(*o);
                y = __floats2bfloat162_rn(a.x + rv.x, a.y + rv.y);
              }
              *o = y;
            }
          }
        }
      }
      if (p.out_tma) {
        fence_proxy_async();  // the TMA store reads the tile through the async proxy
        bar_sync(1 + w, 128);
        if (tid == 0) {
          const int boxes = ((n_out - n0 < cols ? n_out - n0 : cols) + OC - 1) / OC;
          int c1 = m0, c2 = 0;
          if (out3d) clip_coords(p, m0, c1, c2);
          for (int b = 0; b < boxes; ++b) {
            if (out3d) tma_store_3d(&tmY, out + b * BOX, n0 + OC * b, c1, c2);
            else tma_store_2d(&tmY, out + b * BOX, n0 + OC * b, c1);
          }
          bulk_commit();
          bulk_wait_read<0>();
          mbar_arrive(&out_free[w]);
        }
        __syncwarp();
      } else {
        // MAP_OUT where no box fits the clip, or GEGLU at BN 160 (80
        // output columns, no whole number of boxes): rows out in 16-byte
        // pieces, each row to its stored row, the residual added in bf16
        bar_sync(1 + w, 128);
        const int units = cols / 8;
#pragma unroll 4
        for (int u2 = tid; u2 < BM * units; u2 += 128) {
          const int rr = u2 / units, u = u2 - rr * units;
          const int m = m0 + rr, n = n0 + 8 * u;
          if (m >= p.M || n >= n_out) continue;
          const size_t row = p.map == MAP_OUT ? frame_major_row(m, p.map_F, p.map_HW) : (size_t)m;
          uint4 o4 = *reinterpret_cast<const uint4*>(out + swizzled<OC>(rr, 8 * u));
          if (p.mode == 1) {
            const uint4 rv = __ldg(reinterpret_cast<const uint4*>(p.R + row * n_out + n));
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&o4);
            const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 a = __bfloat1622float2(o[e]), b = __bfloat1622float2(r2[e]);
              o[e] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
            }
          }
          *reinterpret_cast<uint4*>(p.Y + row * n_out + n) = o4;
        }
        bar_sync(1 + w, 128);  // the tile free again
      }
    }
  }
}

// ---- host side ------------------------------------------------------------------

template <int BN>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& b, Params p, int smem, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(ds_gemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  p.n_tiles = (p.mode == 2) ? p.N / BN : (p.N + BN - 1) / BN;
  p.tiles = p.n_tiles * ((p.M + BM - 1) / BM);
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  ds_gemm_kernel<BN><<<grid, THREADS, smem, stream>>>(a, b, p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_pingpong(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& r, const CUtensorMap& y,
                            Params p, int smem, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(ds_gemm_kernel_pingpong<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  p.n_tiles = (p.mode == 2) ? p.N / BN : (p.N + BN - 1) / BN;
  p.tiles = p.n_tiles * ((p.M + BM - 1) / BM);
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  ds_gemm_kernel_pingpong<BN><<<grid, THREADS, smem, stream>>>(a, b, r, y, p);
  return cudaGetLastError();
}

// Both schedules' host side: checks, the prologue pass, the tensor maps and
// the launch.
int run(const void* X, int M, int K, const void* ln_w, const void* ln_b, float eps, const void* gn_mul,
        const void* gn_add, int rows_per_sample, int map_F, int map_HW, const void* W, int N, const void* bias,
        const void* R, void* Y, int mode, void* scratch, int block_n, int stages, bool pingpong, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  const bool ln = ln_w != nullptr, gn = gn_mul != nullptr, map = map_F > 0;
  const int map_kind = !map ? MAP_NONE : gn ? MAP_A : MAP_OUT;
  if (M <= 0 || K <= 0 || K % 8 || N % 8 || mode < 0 || mode > 2) return (int)bad;
  if (pingpong ? block_n != 128 && block_n != 160
               : block_n != 64 && block_n != 128 && block_n != 256 && block_n != 320)
    return (int)bad;
  if ((ln || gn) && scratch == nullptr) return (int)bad;
  if (ln && (gn || map)) return (int)bad;
  if (gn && (mode != 0 || rows_per_sample <= 0 || M % rows_per_sample)) return (int)bad;
  if (map && (map_HW <= 0 || M % (map_F * map_HW))) return (int)bad;
  if (map_kind == MAP_A && rows_per_sample % (map_F * map_HW)) return (int)bad;
  // a frame map as a TMA box where 128 / F positions tile the clip: the
  // head's A box, the tail's output and residual boxes (ping-pong)
  const bool box = map && BM % map_F == 0 && map_HW % (BM / map_F) == 0;
  const bool gather = map_kind == MAP_A && !box;  // else the head's permute in the prologue pass
  if (map_kind == MAP_OUT && mode != 1) return (int)bad;
  if (mode == 1 && R == nullptr) return (int)bad;
  if (mode == 2 && (N / 2) % (block_n / 2)) return (int)bad;
  const int stage_bytes = A_BYTES + block_n * BK * 2;
  const int smem = pingpong ? stages * stage_bytes + 2 * pp_out_bytes(block_n) + (2 * stages + 4) * 8 + SMEM_ALIGN
                            : stages * stage_bytes + epilogue_bytes(block_n) + 2 * stages * 8 + SMEM_ALIGN;
  if (stages < 2 || smem > SMEM_MAX) return (int)bad;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* A = X;
  if (ln) {
    prologue_ln_kernel<<<(M + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(X), M, K,
                                                   static_cast<const float*>(ln_w),
                                                   static_cast<const float*>(ln_b), eps, static_cast<bf16*>(scratch));
    A = scratch;
  } else if (gn) {
    const long long chunks = (long long)M * (K / 8);
    const long long want = (chunks + 255) / 256;
    const int blocks = (int)(want < 16 * sm_count() ? want : 16 * sm_count());
    prologue_gn_kernel<<<blocks, 256, 0, s>>>(static_cast<const bf16*>(X), chunks, K,
                                              static_cast<const float*>(gn_mul), static_cast<const float*>(gn_add),
                                              rows_per_sample, gather ? map_F : 0, map_HW,
                                              static_cast<bf16*>(scratch));
    A = scratch;
  }
  if (ln || gn) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  CUtensorMap ta, tb;
  bool ok;
  const int a_map = gather ? MAP_NONE : map_kind;  // what the GEMM itself does with the rows
  if (a_map == MAP_A) {
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)map_HW, (cuuint64_t)(M / map_HW)};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)map_HW * K * 2};
    const cuuint32_t box[3] = {BK, (cuuint32_t)(BM / map_F), (cuuint32_t)map_F};
    ok = make_map(&ta, A, 3, dims, strides, box);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {BK, BM};
    ok = make_map(&ta, A, 2, dims, strides, box);
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    // GEGLU's value and gate rows, and BN 320's two halves (a box has at
    // most 256 rows), arrive as two boxes of block_n / 2 rows
    const cuuint32_t box[2] = {BK, (cuuint32_t)(mode == 2 || block_n > 256 ? block_n / 2 : block_n)};
    ok = ok && make_map(&tb, W, 2, dims, strides, box);
  }
  if (!ok) return (int)bad;

  Params p{};
  p.M = M; p.K = K; p.N = N; p.mode = mode; p.map = a_map;
  p.map_F = map_F; p.map_HW = map_HW; p.map_hb = a_map == MAP_A ? BM / map_F : 1;
  p.k_tiles = (K + BK - 1) / BK; p.stages = stages;
  p.bias = static_cast<const float*>(bias); p.R = static_cast<const bf16*>(R); p.Y = static_cast<bf16*>(Y);
  cudaError_t e;
  if (!pingpong) {
    if (block_n == 320) e = launch<320>(ta, tb, p, smem, s);
    else if (block_n == 256) e = launch<256>(ta, tb, p, smem, s);
    else if (block_n == 128) e = launch<128>(ta, tb, p, smem, s);
    else e = launch<64>(ta, tb, p, smem, s);
    return (int)e;
  }
  // the output tile's maps (Y, and R in mode 1): boxes of pp_box_cols
  // columns and 128 rows, or under MAP_OUT the 3-D box {columns, hb, F} over
  // [B*F, HW, N_out]; where no box fits the clip, or the tile's outputs are
  // no whole number of boxes, the rows leave one by one
  const int n_out = mode == 2 ? N / 2 : N;
  const int oc = pp_box_cols(block_n);
  const CUtensorMapSwizzle oswz = oc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  p.out_tma = (map_kind != MAP_OUT || box) && (mode == 2 ? block_n / 2 : block_n) % oc == 0;
  if (map_kind == MAP_OUT && box) p.map_hb = BM / map_F;
  CUtensorMap ty{}, tr{};
  if (p.out_tma) {
    const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (map_kind == MAP_OUT) {
      const cuuint64_t dims[3] = {(cuuint64_t)n_out, (cuuint64_t)map_HW, (cuuint64_t)(M / map_HW)};
      const cuuint64_t strides[2] = {(cuuint64_t)n_out * 2, (cuuint64_t)map_HW * n_out * 2};
      const cuuint32_t obox[3] = {(cuuint32_t)oc, (cuuint32_t)(BM / map_F), (cuuint32_t)map_F};
      ok = make_map(&ty, Y, 3, dims, strides, obox, bf, oswz) && make_map(&tr, R, 3, dims, strides, obox, bf, oswz);
    } else {
      const cuuint64_t dims[2] = {(cuuint64_t)n_out, (cuuint64_t)M};
      const cuuint64_t strides[1] = {(cuuint64_t)n_out * 2};
      const cuuint32_t obox[2] = {(cuuint32_t)oc, BM};
      ok = make_map(&ty, Y, 2, dims, strides, obox, bf, oswz) &&
           (mode != 1 || make_map(&tr, R, 2, dims, strides, obox, bf, oswz));
    }
    if (!ok) return (int)bad;
  }
  if (block_n == 160) return (int)launch_pingpong<160>(ta, tb, tr, ty, p, smem, s);
  return (int)launch_pingpong<128>(ta, tb, tr, ty, p, smem, s);
}

}  // namespace

// Combinations (the others return cudaErrorInvalidValue, and cuda_lib.ln_gemm
// refuses them first): LN prologue with mode 0, 1 or 2; GN prologue with mode
// 0 (frame map of A optional); no prologue with mode 0, 1 or 2 (frame map of
// the output optional in mode 1). Shapes: K % 8 == 0, N % 8 == 0 (mode 2: N/2 a
// multiple of block_n/2); pointers 16-byte aligned and row-contiguous; with
// gn_mul, M % rows_per_sample == 0 and mul/add are [M / rows_per_sample, K];
// with a frame map (map_F > 0), M % (map_F * map_HW) == 0, and for the A map
// (the GroupNorm head) whole clips a sample (rows_per_sample % (map_F *
// map_HW) == 0). The A map reads each 128-row tile as one 3-D TMA box of 128
// / F positions x F frames where that box fits a clip (128 % F == 0 and
// map_HW % (128 / F) == 0: 40x64 and every UNet level of it); at any other F
// or H*W (a 40x40 latent's 10x10 and 5x5 levels, 384x384's 6x6) the
// prologue pass writes the normalised rows already permuted to logical
// order, and the GEMM reads them with the plain 2-D box. scratch: bf16 [M, K]
// for the prologue's output (LN or GN).
// block_n (64, 128, 256 or 320) and stages from cuda_lib.gemm_tile.
extern "C" int ds_ln_gemm(const void* X, int M, int K, const void* ln_w, const void* ln_b, float eps,
                          const void* gn_mul, const void* gn_add, int rows_per_sample, int map_F, int map_HW,
                          const void* W, int N, const void* bias, const void* R, void* Y, int mode,
                          void* scratch, int block_n, int stages, void* stream) {
  return run(X, M, K, ln_w, ln_b, eps, gn_mul, gn_add, rows_per_sample, map_F, map_HW, W, N, bias, R, Y, mode,
             scratch, block_n, stages, false, stream);
}

// The same GEMM on the ping-pong schedule: ds_ln_gemm's arguments and
// combinations; block_n 128 or 160 (a warpgroup's tile 128 x block_n).
extern "C" int ds_ln_gemm_pingpong(const void* X, int M, int K, const void* ln_w, const void* ln_b, float eps,
                                   const void* gn_mul, const void* gn_add, int rows_per_sample, int map_F,
                                   int map_HW, const void* W, int N, const void* bias, const void* R, void* Y,
                                   int mode, void* scratch, int block_n, int stages, void* stream) {
  return run(X, M, K, ln_w, ln_b, eps, gn_mul, gn_add, rows_per_sample, map_F, map_HW, W, N, bias, R, Y, mode,
             scratch, block_n, stages, true, stream);
}
