// fp32 GEMM with an optional LayerNorm or GroupNorm prologue, an optional
// row map and three epilogues: the fp32 twin of gemm.cu::ds_ln_gemm (same C
// interface), for every projection of the UNet transformers when the model
// runs in float32, on the tensor cores through a three-product tf32 split.
//
// Replaces, at fp32 activations, the projection halves of the TPU kernels
//   dynamicscaler_tpu/ops/fused_temporal.py::_kernel      (K1), ::_ff_kernel (K4)
//   dynamicscaler_tpu/ops/fused_spatial.py::_kernel       (K2), ::_cross_kernel (K3)
// and the whole of the transformer-wrapper kernels
//   dynamicscaler_tpu/ops/fused_twrap.py::_head_kernel    (5 _head_temporal, 7 _head_spatial)
//   dynamicscaler_tpu/ops/fused_twrap.py::_tail_kernel    (6 _tail_temporal, 8 _tail_spatial)
// which compute in x.dtype, so at float32 with no rounding point anywhere.
//
// Y[M, N_out] = epilogue( prologue(X)[M, K] @ W[N, K]^T ), everything fp32,
// computed as cuda_lib.ln_gemm_plain computes it at fp32:
//   prologue (one pass before the GEMM, prologue_ln_f32_kernel or
//   prologue_gn_f32_kernel, into scratch [M, K] that the GEMM reads as A):
//     LN: a = (x - mu) * (rstd * s) + b, with mu and rstd of the row (flax
//         fast variance, var = max(0, E[x^2] - mu^2));
//     GN: a = x * mul[s] + add[s], sample s = r / rows_per_sample;
//     each product and sum rounded on its own (__fmul_rn, __fadd_rn), as
//     PyTorch's separate operations round them.
//   row map (the frame permute of the temporal wrappers, logical row
//   r = (b*HW + hw)*F + f <-> stored row (b*F + f)*HW + hw of [B, F, H, W, C]):
//     with GN: A row r is read from X's stored row map(r)   (temporal head)
//     else:    output row r is written to, and its residual read from,
//              stored row map(r)                             (temporal tail)
//   mode 0: y = acc [+ bias]
//   mode 1: y = (acc [+ bias]) + R
//   mode 2: GEGLU: a tile holds BN/2 value rows n0.. and the BN/2 gate rows
//           N/2 + n0.. of W, so value column c and gate column c + BN/2 lie in
//           the same thread's registers: y = (acc_v + b_v) * gelu_erf(acc_g + b_g),
//           N_out = N / 2 (exact erf GELU, erff).
//
// What bounds it on the H100: operations. Every UNet projection does 2MNK
// fp32 operations against 4(MK + NK + MN) bytes, 25-400 operations a byte.
// One tf32 product keeps about three digits, so each product runs as three
// (hopper.cuh: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, x = hi + lo split by
// explicit rounding), and the least time is 3 x 2MNK at the tensor cores'
// 495 TFLOP/s, 2.5 times the CUDA cores' 67 TFLOP/s that bounded the FFMA
// kernel this replaces. The design is gemm.cu's:
//   * a persistent grid (one block per SM) walks the 128 x BN output tiles
//     (BN 128 or 64, chosen per shape on the host: cuda_lib.gemm_f32_tile),
//     column tiles fastest, so the blocks in flight share their A rows in L2;
//   * the weights come split: W_hi = tf32(W) and W_lo = tf32(W - W_hi),
//     [2, N, K], written once per weight by ds_tf32_split
//     (cuda_lib.tf32_split_weights keeps them while the weight lives; twice
//     the fp32 projection weights in memory). Splitting each B stage in
//     shared memory instead, by three warps of the producer warpgroup, took
//     1.15-1.7x the time at the forward's shapes (chip_tf32_variants.py);
//   * one producer thread fills a ring of `stages` (A, B_hi, B_lo) tiles
//     with TMA copies (128-byte swizzle: K in steps of 32, one swizzle row;
//     ragged rows, and a last step past K where K / 32 is odd, arrive as
//     zeros), running on across tiles;
//   * two consumer warpgroups of 64 rows each read their A values from the
//     stage (the m64k8 tf32 register fragment, 4 values a thread a k8 step),
//     split each in registers and issue, per k8 step, wgmma m64nBNk8 tf32
//     with A from registers: a_lo.b_hi, a_hi.b_lo, then a_hi.b_hi; the next
//     stage's fragments are loaded and split while these products run. The
//     tensor core adds into its accumulator rounding towards zero, a bias
//     that grows with the number of additions (1920 at K = 5120) beyond
//     fp32's error and the 1e-5 gate (tests/test_torch_tf32_split.py models
//     it), so a stage's 12 products go into an accumulator of their own,
//     started at zero, which the threads then add to the tile's accumulator
//     in fp32 (round to nearest);
//   * the LayerNorm or GroupNorm prologue is one streaming pass before the
//     GEMM that writes the normalised fp32 rows to scratch (for the
//     temporal head in logical order: the frame permute is a gather there),
//     and the GEMM reads them like any A. Applied in the consumers it would
//     be repeated for every column tile of the same rows (N / BN times: 20
//     at N = 2560); the pass reads and writes M x K once;
//   * the epilogue adds the bias (and forms GEGLU) from the registers and
//     writes each thread's column pairs straight to device memory (8 bytes,
//     a quad's 32 bytes contiguous), the residual read the same way and the
//     output row map applied per row.
// No split-K and no atomics: two runs agree bit for bit.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                    // rows a tile: two consumer warpgroups of 64
constexpr int BK = 32;                     // K a stage: one 128-byte swizzle row of fp32
constexpr int ROW = BK * 4;                // bytes of a tile row
constexpr int A_BYTES = BM * ROW;          // 16 KB a stage
constexpr int SMEM_MAX = 232448;           // the H100's per-block limit
constexpr int SMEM_ALIGN = 1024;           // the 128-byte swizzle repeats every 8 rows of 128 bytes
// Warpgroups 0 and 1 consume, the first thread of warpgroup 2 produces.
// setmaxnreg moves warpgroup 2's share to the consumers.
constexpr int THREADS = 384;
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;  // 2 * 128 * 232 + 128 * 40 = 64512 of the 65536

struct Params {
  int M, K, N;                 // N: rows of W (2 * N_out in mode 2)
  int mode, map_out;           // map_out: the output row map (temporal tail)
  int map_F, map_HW;
  int k_tiles, stages, n_tiles, tiles;
  const float* bias;           // [N] or null
  const float* R;              // mode 1: [M, N]
  float* Y;
};

// A stage: the A tile, B_hi, B_lo; then full / empty mbarriers a stage.
__host__ __device__ constexpr int stage_bytes(int bn) { return A_BYTES + 2 * bn * ROW; }
__host__ __device__ constexpr int smem_bytes(int bn, int stages) {
  return SMEM_ALIGN + stages * stage_bytes(bn) + 2 * stages * 8;
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

// ---- the prologue passes -----------------------------------------------------------

// A = LN(X) row by row (K % 4 == 0), one warp per row: fp32 sum and sum of
// squares over the row, then the row again normalised.
__global__ void __launch_bounds__(256) prologue_ln_f32_kernel(const float* __restrict__ X, int M, int K, float eps,
                                                              const float* __restrict__ ln_w,
                                                              const float* __restrict__ ln_b, float* __restrict__ A) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= M) return;
  const float* x = X + (size_t)row * K;
  float s = 0.f, ss = 0.f;
  for (int k = lane * 4; k < K; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(x + k);
    s += v.x + v.y + v.z + v.w;
    ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float mu = s / (float)K;
  const float rstd = rsqrtf(fast_variance(ss / (float)K, mu) + eps);
  float* a = A + (size_t)row * K;
  for (int k = lane * 4; k < K; k += 128) {
    float4 v = *reinterpret_cast<const float4*>(x + k);
    const float4 w = __ldg(reinterpret_cast<const float4*>(ln_w + k));
    const float4 b = __ldg(reinterpret_cast<const float4*>(ln_b + k));
    v.x = __fadd_rn(__fmul_rn(__fsub_rn(v.x, mu), __fmul_rn(rstd, w.x)), b.x);
    v.y = __fadd_rn(__fmul_rn(__fsub_rn(v.y, mu), __fmul_rn(rstd, w.y)), b.y);
    v.z = __fadd_rn(__fmul_rn(__fsub_rn(v.z, mu), __fmul_rn(rstd, w.z)), b.z);
    v.w = __fadd_rn(__fmul_rn(__fsub_rn(v.w, mu), __fmul_rn(rstd, w.w)), b.w);
    *reinterpret_cast<float4*>(a + k) = v;
  }
}

// A = X * mul[s] + add[s] for s = row / rows_per_sample, 4 values a thread.
// With a frame map (map_F > 0: the temporal head), A's row r is X's stored
// row frame_major_row(r), so the GEMM reads A in logical order (a sample's
// rows are whole clips, so r and its stored row share the sample).
__global__ void __launch_bounds__(256) prologue_gn_f32_kernel(const float* __restrict__ X, long long chunks, int K,
                                                              const float* __restrict__ mul,
                                                              const float* __restrict__ add, int rows_per_sample,
                                                              int map_F, int map_HW, float* __restrict__ A) {
  const int per_row = K / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < chunks;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / per_row;
    const int k = (int)(i - row * per_row) * 4;
    const size_t v0 = (size_t)(row / rows_per_sample) * K + k;
    const size_t src = map_F > 0 ? frame_major_row((int)row, map_F, map_HW) : (size_t)row;
    float4 x = *reinterpret_cast<const float4*>(X + src * K + k);
    const float4 m = __ldg(reinterpret_cast<const float4*>(mul + v0));
    const float4 a = __ldg(reinterpret_cast<const float4*>(add + v0));
    x.x = __fadd_rn(__fmul_rn(x.x, m.x), a.x);
    x.y = __fadd_rn(__fmul_rn(x.y, m.y), a.y);
    x.z = __fadd_rn(__fmul_rn(x.z, m.z), a.z);
    x.w = __fadd_rn(__fmul_rn(x.w, m.w), a.w);
    *reinterpret_cast<float4*>(A + row * K + k) = x;
  }
}

// ---- the GEMM -----------------------------------------------------------------------

// hi = tf32(w), lo = tf32(w - hi) of the n (% 4 == 0) weights: out[0, i], out[1, i].
__global__ void __launch_bounds__(256) tf32_split_kernel(const float* __restrict__ w, long long n,
                                                         float* __restrict__ out) {
  for (long long i = 4 * (blockIdx.x * (long long)blockDim.x + threadIdx.x); i < n;
       i += 4 * (long long)gridDim.x * blockDim.x) {
    const float4 v = *reinterpret_cast<const float4*>(w + i);
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(out + i) = h;
    *reinterpret_cast<uint4*>(out + n + i) = l;
  }
}

// Wait until stage `it` of the ring has landed.
__device__ __forceinline__ void stage_wait(uint64_t* full, int it, int S) {
  mbar_wait(&full[it % S], (it / S) & 1);
}

// The A fragments of a stage's four k8 steps, split: f[0] hi, f[1] lo. Rows
// r0 (+8), columns 8j + t (+4) of the tile at `stage`, in the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8); r0 % 8 == g for
// both rows).
__device__ __forceinline__ void load_frags(const uint8_t* stage, int r0, int g, int t, uint32_t (&f)[2][4][4]) {
  const uint8_t* arow = stage + r0 * ROW + t * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_tf32(*reinterpret_cast<const float*>(arow + h * 8 * ROW + (((2 * j + c) ^ g) << 4)),
                   f[0][j][h + 2 * c], f[1][j][h + 2 * c]);
}

// A stage's 12 products into `part` (started at zero): per k8 step
// a_lo.b_hi, a_hi.b_lo, a_hi.b_hi, B (rounded, then its remainders) at `b`.
template <int BN>
__device__ __forceinline__ void issue_stage(float (&part)[BN / 2], const uint32_t (&f)[2][4][4], const uint8_t* b) {
  const uint64_t bh = smem_desc(b), bl = smem_desc(b + BN * ROW);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    WgmmaTf32RegA<BN>::mma(part, f[1][j], bh + 2 * j, j);
    WgmmaTf32RegA<BN>::mma(part, f[0][j], bl + 2 * j, 1);
    WgmmaTf32RegA<BN>::mma(part, f[0][j], bh + 2 * j, 1);
  }
  wgmma_commit();
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_f32_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB, const Params p) {
  constexpr int STAGE = stage_bytes(BN);
  constexpr int B_BYTES = BN * ROW;
  constexpr int ACC = BN / 2;  // fp32 accumulators a consumer thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
                                             ~uintptr_t(SMEM_ALIGN - 1));
  const int S = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * STAGE);  // TMA landed
  uint64_t* empty = full + S;                                      // consumers done
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int KT = p.k_tiles;
  const bool geglu = p.mode == 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 0) {
      // ---- producer: one thread issues every TMA copy, tile after tile ----
      int it = 0;  // k steps issued so far, across tiles: the ring position
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile / p.n_tiles) * BM;
        const int n0 = (tile % p.n_tiles) * (geglu ? BN / 2 : BN);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* sa = smem + s * STAGE;
          uint8_t* sb = sa + A_BYTES;
          mbar_expect_tx(&full[s], A_BYTES + 2 * B_BYTES);
          tma_load_2d(sa, &tmA, &full[s], kt * BK, m0);
          for (int half = 0; half < 2; ++half) {  // W_hi, then W_lo
            uint8_t* d = sb + half * B_BYTES;
            if (geglu) {
              tma_load_3d(d, &tmB, &full[s], kt * BK, n0, half);
              tma_load_3d(d + B_BYTES / 2, &tmB, &full[s], kt * BK, p.N / 2 + n0, half);
            } else {
              tma_load_3d(d, &tmB, &full[s], kt * BK, n0, half);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows wg*64 .. wg*64+63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n_out = geglu ? p.N / 2 : p.N;
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows of the tile: r0, r0 + 8
    float part[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) part[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile / p.n_tiles) * BM;
      const int n0 = (tile % p.n_tiles) * (geglu ? BN / 2 : BN);
      float acc[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
      // Two stages an iteration, their fragments in f0 and f1: the next
      // stage's are loaded and split while this stage's products run (one
      // group in flight: `part` is folded before the next group starts).
      uint32_t f0[2][4][4], f1[2][4][4];
      stage_wait(full, it, S);
      load_frags(smem + (it % S) * STAGE, r0, g, t, f0);
#pragma unroll 1
      for (int kt = 0; kt < KT; kt += 2, it += 2) {
        const int s0 = it % S, s1 = (it + 1) % S;
        issue_stage<BN>(part, f0, smem + s0 * STAGE + A_BYTES);
        stage_wait(full, it + 1, S);
        load_frags(smem + s1 * STAGE, r0, g, t, f1);
        wgmma_wait<0>();
        fence_acc(part);
        if (lane == 0) mbar_arrive(&empty[s0]);
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] += part[i];
        issue_stage<BN>(part, f1, smem + s1 * STAGE + A_BYTES);
        if (kt + 2 < KT) {
          stage_wait(full, it + 2, S);
          load_frags(smem + ((it + 2) % S) * STAGE, r0, g, t, f0);
        }
        wgmma_wait<0>();
        fence_acc(part);
        if (lane == 0) mbar_arrive(&empty[s1]);
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] += part[i];
      }

      // ---- epilogue ----
      // Thread (warp w, lane l) holds rows 16w + l/4 (+8) and, for each
      // 8-column group c, columns 8c + 2(l%4) + {0, 1}: acc[4c + 2h + {0, 1}]
      // for row half h.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r0 + 8 * h;
        if (m >= p.M) continue;
        const size_t row = p.map_out ? frame_major_row(m, p.map_F, p.map_HW) : (size_t)m;
        float* y = p.Y + row * n_out;
        if (geglu) {
#pragma unroll
          for (int c = 0; c < BN / 16; ++c) {
            const int n = n0 + 8 * c + 2 * t;
            float2 v = make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
            float2 gt = make_float2(acc[4 * (c + BN / 16) + 2 * h], acc[4 * (c + BN / 16) + 2 * h + 1]);
            if (p.bias) {
              const float2 bv = __ldg(reinterpret_cast<const float2*>(p.bias + n));
              const float2 bg = __ldg(reinterpret_cast<const float2*>(p.bias + p.N / 2 + n));
              v.x += bv.x; v.y += bv.y; gt.x += bg.x; gt.y += bg.y;
            }
            *reinterpret_cast<float2*>(y + n) = make_float2(v.x * gelu_erf(gt.x), v.y * gelu_erf(gt.y));
          }
        } else {
#pragma unroll
          for (int c = 0; c < BN / 8; ++c) {
            const int n = n0 + 8 * c + 2 * t;
            if (n >= p.N) continue;  // a ragged last column tile
            float2 v = make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
            if (p.bias) {
              const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + n));
              v.x += b.x; v.y += b.y;
            }
            if (p.mode == 1) {
              const float2 r = __ldg(reinterpret_cast<const float2*>(p.R + row * n_out + n));
              v.x += r.x; v.y += r.y;
            }
            *reinterpret_cast<float2*>(y + n) = v;
          }
        }
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
        cudaFuncSetAttribute(gemm_f32_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  p.n_tiles = (p.mode == 2) ? p.N / BN : (p.N + BN - 1) / BN;
  const long long tiles = (long long)p.n_tiles * ((p.M + BM - 1) / BM);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  gemm_f32_kernel<BN><<<grid, THREADS, smem, stream>>>(a, b, p);
  return cudaGetLastError();
}

}  // namespace

// ds_ln_gemm's interface and combinations (see gemm.cu), at fp32: X, R, Y
// fp32, and W the weights split, [2, N, K] (ds_tf32_split's output); every
// pointer 16-byte aligned and row-contiguous; K % 32 == 0, N % 8 == 0 (mode
// 2: N/2 a multiple of block_n/2). block_n (128 or 64) and stages from
// cuda_lib.gemm_f32_tile. scratch: fp32 [M, K] for the prologue pass's rows
// (LN or GN), null otherwise.
extern "C" int ds_ln_gemm_f32(const void* X, int M, int K, const void* ln_w, const void* ln_b, float eps,
                              const void* gn_mul, const void* gn_add, int rows_per_sample, int map_F, int map_HW,
                              const void* W, int N, const void* bias, const void* R, void* Y, int mode,
                              void* scratch, int block_n, int stages, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  const bool ln = ln_w != nullptr, gn = gn_mul != nullptr, map = map_F > 0;
  if (M <= 0 || K <= 0 || K % BK || N <= 0 || N % 8 || mode < 0 || mode > 2) return (int)bad;
  if (block_n != 128 && block_n != 64) return (int)bad;
  if ((ln || gn) && scratch == nullptr) return (int)bad;
  if (ln && (ln_b == nullptr || gn || map)) return (int)bad;
  if (gn && (gn_add == nullptr || mode != 0 || rows_per_sample <= 0 || M % rows_per_sample)) return (int)bad;
  if (map && (map_HW <= 0 || M % (map_F * map_HW))) return (int)bad;
  if (map && gn && rows_per_sample % (map_F * map_HW)) return (int)bad;
  if (map && !gn && mode != 1) return (int)bad;  // the output map: the residual tail
  if (mode == 1 && R == nullptr) return (int)bad;
  if (mode == 2 && (N / 2) % (block_n / 2)) return (int)bad;
  const int smem = smem_bytes(block_n, stages);
  if (stages < 2 || smem > SMEM_MAX) return (int)bad;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* A = X;
  if (ln) {
    prologue_ln_f32_kernel<<<(M + 7) / 8, 256, 0, s>>>(static_cast<const float*>(X), M, K, eps,
                                                       static_cast<const float*>(ln_w),
                                                       static_cast<const float*>(ln_b), static_cast<float*>(scratch));
    A = scratch;
  } else if (gn) {
    const long long chunks = (long long)M * (K / 4);
    const long long want = (chunks + 255) / 256;
    const int blocks = (int)(want < 16 * sm_count() ? want : 16 * sm_count());
    prologue_gn_f32_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(X), chunks, K,
                                                  static_cast<const float*>(gn_mul), static_cast<const float*>(gn_add),
                                                  rows_per_sample, map ? map_F : 0, map_HW,
                                                  static_cast<float*>(scratch));
    A = scratch;
  }
  if (ln || gn) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  CUtensorMap ta, tb;
  bool ok;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 4};
    const cuuint32_t box[2] = {BK, BM};
    ok = make_map(&ta, A, 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  }
  {  // W [2, N, K]: hi, then lo
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 4, (cuuint64_t)N * K * 4};
    const cuuint32_t box[3] = {BK, (cuuint32_t)(mode == 2 ? block_n / 2 : block_n), 1};
    ok = ok && make_map(&tb, W, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  }
  if (!ok) return (int)bad;

  Params p{};
  p.M = M; p.K = K; p.N = N; p.mode = mode;
  p.map_out = map && !gn;  // the head's map is the prologue pass's gather
  p.map_F = map_F; p.map_HW = map_HW;
  p.k_tiles = (K / BK + 1) & ~1; p.stages = stages;  // even: the consumers take two stages at a time
  p.bias = static_cast<const float*>(bias);
  p.R = static_cast<const float*>(R);
  p.Y = static_cast<float*>(Y);
  const cudaError_t e = block_n == 128 ? launch<128>(ta, tb, p, smem, s) : launch<64>(ta, tb, p, smem, s);
  return (int)e;
}

// out [2, n] = (tf32(w), tf32(w - tf32(w))) of n fp32 weights (n % 4 == 0,
// pointers 16-byte aligned): the W operand of ds_ln_gemm_f32.
extern "C" int ds_tf32_split(const void* w, long long n, void* out, void* stream) {
  if (n <= 0 || n % 4) return (int)cudaErrorInvalidValue;
  const long long want = (n / 4 + 255) / 256;
  const int blocks = (int)(want < 16 * sm_count() ? want : 16 * sm_count());
  tf32_split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(w), n,
                                                                           static_cast<float*>(out));
  return (int)cudaGetLastError();
}
