// GroupNorm apply [-> SiLU] with folded per-sample statistics, bf16 in and
// out (ds_gn_silu), the statistics themselves (ds_gn_stats), and GroupNorm
// [-> SiLU] in one call with the statistics inside it (ds_group_norm_silu).
//
// ds_gn_silu replaces dynamicscaler_tpu/ops/fused_twrap.py::_gn_silu_kernel
// (kernel 9, launched by _gn_silu_call): y = bf16(silu(fp32(x) * mul[b] +
// add[b])), or without the SiLU for the VAE attention norm (act = 0). x is
// [B, M, C] with the channel last; mul/add are the fp32 [B, C] vectors that
// ds_gn_stats folds. The product and the sum are rounded separately
// (__fmul_rn, __fadd_rn), as the plain version computes them; the SiLU is
// h / (1 + exp(-h)) with the fast __expf and __fdividef (a few fp32 ulps
// from the plain h * sigmoid(h), far inside the one bf16 rounding by which
// chip_smoke.py lets the two differ, TOL_GN_ULP).
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (4 bytes) against ~8 fp32 operations, far below the card's ~295
// operations per byte, so the bound is 2 * numel * 2 bytes / 3.35 TB/s. The
// kernel is channel-stationary (gn_apply_kernel): a block of lanes x (C / 8)
// threads takes a range of rows of one sample; each thread owns one fixed
// 8-channel chunk, holds its 8 mul and 8 add values in registers, loaded
// once, and strides over the rows with
// APPLY_UNROLL 16-byte loads in flight before it uses any. Neighbouring
// threads read neighbouring 16 bytes (a block covers whole consecutive
// rows), and the loop has no shared memory and no modulo (the design before
// it staged the vectors in shared memory, where lanes 8 words apart met in
// the same bank, and took a 64-bit % per chunk). The grid holds twice as
// many blocks as the card keeps resident at the kernel's occupancy
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), split over the
// samples.
//
// ds_gn_stats is the statistics pass that the JAX package leaves to XLA
// (dynamicscaler_tpu/ops/fused_twrap.py::group_norm_fold), the reduction
// under kernels 5, 7, 12 and 13 and the split route of kernel 9: for x [B, M,
// C] (bf16 or fp32; M every axis between the first and the last), per
// (sample, group of C / G contiguous channels) the fp32 sums of x and x^2,
// folded into (mul, add) [B, C] fp32 by the JAX formula: mean, the fast
// variance clamped at 0, rsqrt(var + eps), mul = rstd * scale, add = bias -
// mean * mul. Bound by reading x once. B is as small as 8 at the clip norms,
// and at the deep levels C is wide and M short, so M is split over blocks of
// 32 rows a thread: a block of lanes x (C / 8) threads gives each thread one
// fixed 8-channel chunk (one 16-byte load a row in bf16) and every lanes-th
// row of its split, so its fp32 sums stay in 16 registers; the block adds its
// row lanes in a fixed order into per-channel partials [splits, B, 2, C], and
// a second small launch (a block a (group, sample)) adds the splits and the
// group's channels, again in a fixed order, and folds. No float atomics
// anywhere: two runs agree bit for bit.
//
// ds_group_norm_silu is GroupNorm [-> SiLU] with statistics per sample, the
// function of the JAX gn_silu (group_norm_fold, then _gn_silu_call) as one
// call, on one of three routes that cuda_lib.gn_plan picks and this file
// checks:
//  * "cluster", where a sample's slab (M * C * 2 bytes) fits the shared
//    memory of CS <= 16 blocks: x is read from device memory exactly once,
//    so the bound is the function's own (2 x bytes). One thread-block cluster
//    of CS blocks a sample (gn_cluster_kernel, about 512 threads a block,
//    one SM each); block `rank` loads rows [rank * rows, ...) into its
//    shared memory with 16-byte loads (the channel-stationary mapping of the
//    apply, CLUSTER_UNROLL loads in flight) and sums x and x^2 per channel
//    in fp32 as they pass, in a fixed order; the row lanes, then the group's
//    channels, in a fixed order, give the block's group partials; after a
//    cluster barrier every block reads all CS blocks' partials through
//    distributed shared memory at once and adds them in rank order (so all
//    blocks hold the same statistics and a rerun is bit-exact: no atomics),
//    folds them by the JAX formula, and applies (+ SiLU) from shared memory
//    to y. A block signals that it has read the others' partials, and waits
//    for all the cluster's signals only before it exits, so no block leaves
//    while another may still read its shared memory. What bounds it: a
//    block's phases run one after another on its SM (the load; the
//    reductions, the cluster barrier and the fold; the apply, whose two
//    MUFU operations an element, __expf and the reciprocal, and about ten
//    instructions an element make it instruction-bound rather than store-bound),
//    so no SM reads and writes at once. A persistent double-buffered
//    variant (the next sample's rows by bulk copy while the current one is
//    normalised) and two blocks an SM did not time faster on the H100 (see
//    PERF.md), so the route stays one block a slab; it reads x once where
//    the split route reads it twice.
//  * "split", everywhere else in bf16 (the 6-25 MB temporal-conv clips, the
//    level-0 up-block inputs, the VAE's frames): ds_gn_stats's two launches,
//    then the apply kernel, from the one call; x is read twice (3 x bytes).
//  * "grid", in fp32 wherever bf16 would split (gn_grid_kernel;
//    cuda_lib.gn_plan's rule, from chip_smoke.py phase 10's timings of
//    every fp32 shape on each route). One cooperative
//    launch of a block an SM, all resident, walks the samples in passes: a
//    pass takes as many whole samples as the card's shared memory holds
//    (about 132 x 220 KB), each spread over 132 / (samples a pass) blocks,
//    or one larger sample over every block, whose rows past the blocks'
//    slabs are read last by the statistics and first by the apply (from L2
//    as far as it keeps them). A block copies its slab in by cp.async
//    (every copy in flight at once, two halves), sums it as the cluster
//    route does, writes its group partials to a scratch in device memory,
//    and meets every block at an integer arrive counter (no float atomic);
//    then each block adds its sample's partials in one fixed order, folds
//    and applies from shared memory. x is read once where a pass holds whole
//    samples (2 x bytes), as on the cluster route, but no sample waits for
//    a second wave of clusters. What the phases of a pass cost on the H100
//    (chip_tf32_variants.py gn, PERF.md): the copies and the apply run at
//    about 70-80% of the memory's rate each, one after the other, and the
//    reductions, the barrier and the exchange of the partials, with the
//    memory idle, take about a quarter of a pass.
//
// fp32 activations (a model run in float32; the JAX kernel computes in
// x.dtype): ds_gn_silu and ds_group_norm_silu take x and y as bf16 (is_f32
// = 0) or fp32 (is_f32 = 1), on every route. The loads and stores are
// templated on the element type (a thread's 8 channels are one 16-byte
// access in bf16, two in fp32: on the cluster and grid routes channels 4u
// .. 4u + 3 and C / 2 + 4u .. + 3, Lane<float>, so that each access of a
// warp is 512 contiguous bytes) and everything inside already computes in
// fp32, so the fp32 instantiation is the same kernel at twice the bytes; the
// slabs take 4 bytes an element (cluster_smem, and cuda_lib.gn_plan's fit,
// reckon the element size). At fp32 the SiLU is __fdividef(h, 1 +
// __expf(-h)), as in bf16: within 4e-7 of max|plain| at every shape timed,
// and faster on both fp32 routes than h / (1 + expf(-h)) with a true
// division or h * __frcp_rn(1 + __expf(-h)) (chip_tf32_variants.py gn,
// PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int STATS_THREADS = 256;   // threads a statistics block aims at (lanes x C / 8)
constexpr int STATS_ROWS = 32;       // rows a thread of a statistics block sums (gn_stats_splits)
constexpr int FOLD_THREADS = 128;    // threads of a fold block (one a (group, sample))
constexpr int APPLY_THREADS = 256;   // threads an apply block aims at
constexpr int APPLY_UNROLL = 8;      // rows an apply thread loads before it uses any
constexpr int CLUSTER_THREADS = 512; // threads a cluster-route block aims at
constexpr int CLUSTER_UNROLL = 4;    // rows a cluster-route thread loads before it uses any
constexpr int CLUSTER_MAX = 16;      // blocks a cluster may hold (above 8: non-portable)
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may have on the H100
constexpr int C_MAX = 6144;
constexpr int ROW_THREADS_MAX = C_MAX / 8;  // a block holds at least one thread a chunk of a row

// The channel-stationary mapping of a [rows, C] bf16 slab onto a block: C /
// 8 16-byte chunks a row, a thread a chunk, lanes rows at a time (as many as
// `threads` allow, at least one); the block's lanes * (C / 8) threads make
// consecutive 16-byte accesses.
struct RowMap {
  int per_row, lanes;
};

__host__ __device__ __forceinline__ RowMap row_map(int C, int threads) {
  RowMap m;
  m.per_row = C / 8;
  m.lanes = m.per_row < threads ? threads / m.per_row : 1;
  return m;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float silu(float h) { return __fdividef(h, 1.0f + __expf(-h)); }
// fp32 (chip_tf32_variants.py gn times it against h / (1 + expf(-h)) and h *
// __frcp_rn(1 + __expf(-h)))
__device__ __forceinline__ float silu_f32(float h) { return __fdividef(h, 1.0f + __expf(-h)); }

// A thread's chunk: 8 consecutive channels of one row (16 bytes in bf16, 32
// in fp32), loaded and stored whole.
template <typename T>
struct Chunk;
template <>
struct Chunk<bf16> {
  uint4 u;
};
template <>
struct Chunk<float> {
  float4 lo, hi;
};

__device__ __forceinline__ Chunk<bf16> ldg_chunk(const Chunk<bf16>* p) { return {__ldg(&p->u)}; }
__device__ __forceinline__ Chunk<float> ldg_chunk(const Chunk<float>* p) { return {__ldg(&p->lo), __ldg(&p->hi)}; }

// 8 bf16 values of x -> y with the chunk's folded vectors (m, a).
template <bool ACT>
__device__ __forceinline__ Chunk<bf16> apply8(Chunk<bf16> c, const float (&m)[8], const float (&a)[8]) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&c.u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    float y0 = __fadd_rn(__fmul_rn(f.x, m[2 * q]), a[2 * q]);
    float y1 = __fadd_rn(__fmul_rn(f.y, m[2 * q + 1]), a[2 * q + 1]);
    if (ACT) {
      y0 = silu(y0);
      y1 = silu(y1);
    }
    h[q] = __floats2bfloat162_rn(y0, y1);
  }
  return c;
}

// 8 fp32 values of x -> y.
template <bool ACT>
__device__ __forceinline__ Chunk<float> apply8(Chunk<float> c, const float (&m)[8], const float (&a)[8]) {
  float* v = reinterpret_cast<float*>(&c);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float y = __fadd_rn(__fmul_rn(v[e], m[e]), a[e]);
    v[e] = ACT ? silu_f32(y) : y;
  }
  return c;
}

// The chunk's 8 values as fp32.
__device__ __forceinline__ void to_f32x8(const Chunk<bf16>& c, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c.u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 t = __bfloat1622float2(h[q]);
    f[2 * q] = t.x;
    f[2 * q + 1] = t.y;
  }
}
__device__ __forceinline__ void to_f32x8(const Chunk<float>& c, float (&f)[8]) {
  f[0] = c.lo.x; f[1] = c.lo.y; f[2] = c.lo.z; f[3] = c.lo.w;
  f[4] = c.hi.x; f[5] = c.hi.y; f[6] = c.hi.z; f[7] = c.hi.w;
}

__device__ __forceinline__ void load_vec8(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Apply: block (split, b) takes rows [split * rows, (split + 1) * rows) of
// sample b; blockDim = row_map(C, APPLY_THREADS) lanes * (C / 8).
template <bool ACT, typename T>
__global__ void __launch_bounds__(ROW_THREADS_MAX)
gn_apply_kernel(const T* __restrict__ X, long long M, int C, long long rows, const float* __restrict__ mul,
                const float* __restrict__ add, T* __restrict__ Y) {
  const RowMap rm = row_map(C, APPLY_THREADS);
  const int rl = threadIdx.x / rm.per_row, u = threadIdx.x - rl * rm.per_row;
  const int b = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  const size_t base = (size_t)b * M * rm.per_row + u;  // in chunks
  const Chunk<T>* xs = reinterpret_cast<const Chunk<T>*>(X) + base;
  Chunk<T>* ys = reinterpret_cast<Chunk<T>*>(Y) + base;
  float m[8], a[8];
  load_vec8(mul + (size_t)b * C + 8 * u, m);
  load_vec8(add + (size_t)b * C + 8 * u, a);
  const long long step = (long long)APPLY_UNROLL * rm.lanes;
  for (long long r = r0 + rl; r < r1; r += step) {
    Chunk<T> v[APPLY_UNROLL];
#pragma unroll
    for (int j = 0; j < APPLY_UNROLL; ++j) {
      const long long rr = r + (long long)j * rm.lanes;
      if (rr < r1) v[j] = ldg_chunk(xs + rr * rm.per_row);
    }
#pragma unroll
    for (int j = 0; j < APPLY_UNROLL; ++j) {
      const long long rr = r + (long long)j * rm.lanes;
      if (rr < r1) ys[rr * rm.per_row] = apply8<ACT>(v[j], m, a);
    }
  }
}

// 8 consecutive values of x as fp32
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 t = __bfloat1622float2(h[q]);
    f[2 * q] = t.x;
    f[2 * q + 1] = t.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Stage 1: block (split, b) sums rows [split * rows, (split + 1) * rows) of
// sample b into part[split, b, 0 | 1, :] (sum | sum of squares per channel).
// blockDim.x = lanes * (C / 8); thread t owns channels 8 (t % (C / 8)) .. + 7
// and rows t / (C / 8), + lanes, ...
template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ X, long long M, int C, long long rows,
                                  float* __restrict__ part) {
  extern __shared__ float red[];  // [2][lanes][C]
  const int per_row = C / 8;
  const int lanes = blockDim.x / per_row;
  const int u = threadIdx.x % per_row, rl = threadIdx.x / per_row;
  const int b = blockIdx.y;
  const long long r0 = blockIdx.x * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  const T* xb = X + (size_t)b * M * C + 8 * u;
  float s[8], ss[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = ss[e] = 0.f;
#pragma unroll 4
  for (long long r = r0 + rl; r < r1; r += lanes) {
    float v[8];
    load8(xb + (size_t)r * C, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] += v[e];
      ss[e] += v[e] * v[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[rl * C + 8 * u + e] = s[e];
    red[(lanes + rl) * C + 8 * u + e] = ss[e];
  }
  __syncthreads();
  float* out = part + ((size_t)blockIdx.x * gridDim.y + b) * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    const int which = c / C, ch = c - which * C;
    float acc = 0.f;
    for (int i = 0; i < lanes; ++i) acc += red[(which * lanes + i) * C + ch];
    out[c] = acc;
  }
}

// Stage 2: block (g, b): the group's sums over the splits and its channels
// in a fixed order (a strided sum per thread, then a fixed shuffle tree and
// the warps in order), then (mul, add) of its channels.
template <typename V>
__global__ void __launch_bounds__(FOLD_THREADS)
gn_fold_kernel(const float* __restrict__ part, int splits, int C, int G, long long M,
               const V* __restrict__ scale, const V* __restrict__ bias, float eps,
               float* __restrict__ mul, float* __restrict__ add) {
  __shared__ float red[2][FOLD_THREADS / 32];
  __shared__ float stat[2];
  const int g = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const int cg = C / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < splits * cg; i += FOLD_THREADS) {
    const int sp = i / cg;
    const float* p = part + ((size_t)sp * B + b) * 2 * C + g * cg + (i - sp * cg);
    s += p[0];
    ss += p[C];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float S = 0.f, SS = 0.f;
    for (int w = 0; w < FOLD_THREADS / 32; ++w) {
      S += red[0][w];
      SS += red[1][w];
    }
    const float n = (float)(M * cg);
    const float mean = S / n;
    stat[0] = mean;
    stat[1] = rsqrtf(hopper::fast_variance(SS / n, mean) + eps);
  }
  __syncthreads();
  for (int c = g * cg + threadIdx.x; c < (g + 1) * cg; c += FOLD_THREADS) {
    const float m = stat[1] * to_f32(scale[c]);
    mul[(size_t)b * C + c] = m;
    add[(size_t)b * C + c] = to_f32(bias[c]) - stat[0] * m;
  }
}

// The 8 channels of a row that thread u of a cluster- or grid-route row
// owns, and how it reaches them: in bf16 channels 8u .. 8u + 7, one 16-byte
// access; in fp32 4u .. 4u + 3 and C / 2 + 4u .. + 3, two 16-byte accesses
// each of which the lanes of a warp make at consecutive addresses (a 32-byte
// chunk a thread would make each access of a warp touch every sector
// twice). The per-channel sums do not depend on which thread owns a
// channel. Rows are C elements, in device and in shared memory alike.
template <typename T>
struct Lane;
template <>
struct Lane<bf16> {
  static __device__ __forceinline__ int chan(int u, int e, int) { return 8 * u + e; }
  static __device__ __forceinline__ Chunk<bf16> ld(const bf16* row, int u, int) {
    return {reinterpret_cast<const uint4*>(row)[u]};
  }
  static __device__ __forceinline__ Chunk<bf16> ldg(const bf16* row, int u, int) {
    return {__ldg(reinterpret_cast<const uint4*>(row) + u)};
  }
  static __device__ __forceinline__ Chunk<bf16> ldcs(const bf16* row, int u, int) {
    return {__ldcs(reinterpret_cast<const uint4*>(row) + u)};
  }
  static __device__ __forceinline__ void st(bf16* row, int u, int, const Chunk<bf16>& c) {
    reinterpret_cast<uint4*>(row)[u] = c.u;
  }
  static __device__ __forceinline__ void stcs(bf16* row, int u, int, const Chunk<bf16>& c) {
    __stcs(reinterpret_cast<uint4*>(row) + u, c.u);
  }
};
template <>
struct Lane<float> {
  static __device__ __forceinline__ int chan(int u, int e, int C) { return e < 4 ? 4 * u + e : (C >> 1) + 4 * u + e - 4; }
  static __device__ __forceinline__ Chunk<float> ld(const float* row, int u, int C) {
    const float4* r = reinterpret_cast<const float4*>(row);
    return {r[u], r[u + (C >> 3)]};
  }
  static __device__ __forceinline__ Chunk<float> ldg(const float* row, int u, int C) {
    const float4* r = reinterpret_cast<const float4*>(row);
    return {__ldg(r + u), __ldg(r + u + (C >> 3))};
  }
  static __device__ __forceinline__ Chunk<float> ldcs(const float* row, int u, int C) {
    const float4* r = reinterpret_cast<const float4*>(row);
    return {__ldcs(r + u), __ldcs(r + u + (C >> 3))};
  }
  static __device__ __forceinline__ void st(float* row, int u, int C, const Chunk<float>& c) {
    float4* r = reinterpret_cast<float4*>(row);
    r[u] = c.lo;
    r[u + (C >> 3)] = c.hi;
  }
  static __device__ __forceinline__ void stcs(float* row, int u, int C, const Chunk<float>& c) {
    float4* r = reinterpret_cast<float4*>(row);
    __stcs(r + u, c.lo);
    __stcs(r + u + (C >> 3), c.hi);
  }
};

// A float in block `rank` of the cluster, at the offset of `p` in this block.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(hopper::smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Shared memory of a cluster-route block: the slab [rows, C] of `elem`-byte
// elements (2 bf16, 4 fp32), the row lanes' sums [lanes][C] fp32 (sums, then
// sums of squares; later the cluster's group partials [CS][2][G]), the
// block's per-channel sums [2][C] (later the folded mul | add), its group
// partials [2][G] and the group statistics [2][G].
__host__ __device__ __forceinline__ long long cluster_smem(long long rows, int C, int G, int elem) {
  return rows * C * elem + ((long long)(row_map(C, CLUSTER_THREADS).lanes + 2) * C + 4LL * G) * 4;
}

// The cluster route: block (rank, b) of a cluster of CS = gridDim.x blocks
// holds rows [rank * rows, min(M, (rank + 1) * rows)) of sample b; blockDim
// = row_map(C, CLUSTER_THREADS) lanes * (C / 8).
template <bool ACT, typename V, typename T>
__global__ void __launch_bounds__(ROW_THREADS_MAX)
gn_cluster_kernel(const T* __restrict__ X, int M, int C, int G, int rows, const V* __restrict__ scale,
                  const V* __restrict__ bias, float eps, T* __restrict__ Y, float* __restrict__ vec_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  using L = Lane<T>;
  const RowMap rm = row_map(C, CLUSTER_THREADS);
  T* slab = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + (size_t)rows * C * sizeof(T));
  float* csum = red + rm.lanes * C;
  float* gpart = csum + 2 * C;
  float* gstat = gpart + 2 * G;
  const uint32_t rank = hopper::cluster_rank();
  const int CS = gridDim.x, B = gridDim.y, b = blockIdx.y;
  const int r0 = (int)rank * rows;
  const int n = rows < M - r0 ? rows : M - r0;
  const int rl = threadIdx.x / rm.per_row, u = threadIdx.x - rl * rm.per_row;
  const T* xs = X + ((size_t)b * M + r0) * C;  // the block's first row
  T* ys = Y + ((size_t)b * M + r0) * C;

  // 1. the slab into shared memory, summed per channel on the way
  float s[8], ss[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = ss[e] = 0.f;
  for (int r = rl; r < n; r += CLUSTER_UNROLL * rm.lanes) {
    Chunk<T> v[CLUSTER_UNROLL];
#pragma unroll
    for (int j = 0; j < CLUSTER_UNROLL; ++j) {
      const int rr = r + j * rm.lanes;
      if (rr < n) v[j] = L::ldcs(xs + (size_t)rr * C, u, C);
    }
#pragma unroll
    for (int j = 0; j < CLUSTER_UNROLL; ++j) {
      const int rr = r + j * rm.lanes;
      if (rr < n) {
        L::st(slab + (size_t)rr * C, u, C, v[j]);
        float f[8];
        to_f32x8(v[j], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s[e] += f[e];
          ss[e] += f[e] * f[e];
        }
      }
    }
  }
  // 2. per channel, the row lanes in order: the sums, then the sums of squares
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[rl * C + L::chan(u, e, C)] = which ? ss[e] : s[e];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < rm.lanes; ++i) acc += red[i * C + c];
      csum[which * C + c] = acc;
    }
    __syncthreads();
  }
  // 3. the group's channels in order: this block's group partials
  const int cg = C / G;
  for (int t = threadIdx.x; t < 2 * G; t += blockDim.x) {
    const int which = t / G, g = t - which * G;
    const float* col = csum + which * C + g * cg;
    float acc = 0.f;
    for (int j = 0; j < cg; ++j) acc += col[j];
    gpart[t] = acc;
  }
  // 4. every block's partials (all loads in flight at once, into red), added
  // in rank order, folded
  hopper::cluster_sync_all();
  for (int i = threadIdx.x; i < CS * 2 * G; i += blockDim.x) {
    const int q = i / (2 * G);
    red[i] = ld_cluster(gpart + (i - q * 2 * G), q);
  }
  cluster_arrive();  // no read of another block's shared memory after this
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float S = 0.f, SS = 0.f;
    for (int q = 0; q < CS; ++q) {
      S += red[q * 2 * G + g];
      SS += red[q * 2 * G + G + g];
    }
    const float nn = (float)((long long)M * cg);
    const float mean = S / nn;
    gstat[g] = mean;
    gstat[G + g] = rsqrtf(hopper::fast_variance(SS / nn, mean) + eps);
  }
  __syncthreads();
  float* vec = csum;  // mul [C] | add [C]
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float m = gstat[G + g] * to_f32(scale[c]);
    const float a = to_f32(bias[c]) - gstat[g] * m;
    vec[c] = m;
    vec[C + c] = a;
    if (vec_out != nullptr && rank == 0) {
      vec_out[(size_t)b * C + c] = m;
      vec_out[((size_t)B + b) * C + c] = a;
    }
  }
  __syncthreads();
  // 5. apply from shared memory
  float m[8], a[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    m[e] = vec[L::chan(u, e, C)];
    a[e] = vec[C + L::chan(u, e, C)];
  }
#pragma unroll 4
  for (int r = rl; r < n; r += rm.lanes)
    L::st(ys + (size_t)r * C, u, C, apply8<ACT>(L::ld(slab + (size_t)r * C, u, C), m, a));
  cluster_wait();  // the other blocks have read this block's partials
}

// Every block of the launch arrives once a pass (after its partials are
// written) at an integer counter and waits until all gridDim.x have: `target`
// is (pass + 1) x gridDim.x. Thread 0 releases the block's writes at the
// device's scope and acquires the others'.
__device__ __forceinline__ void grid_sync(int* counter, int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1);
    int seen;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// Rows [r_begin, r_end) of x (from row0, rows of C elements) into the same
// rows of the slab, the range's 16-byte units spread over the block's
// threads (each warp's lanes at consecutive addresses), as one cp.async
// group.
template <typename T>
__device__ __forceinline__ void grid_fill(T* slab, const T* row0, int r_begin, int r_end, int C) {
  const int per = C * (int)sizeof(T) / 16;  // 16-byte units a row
  const uint4* src = reinterpret_cast<const uint4*>(row0);
  uint4* dst = reinterpret_cast<uint4*>(slab);
  for (int i = r_begin * per + threadIdx.x; i < r_end * per; i += blockDim.x) hopper::cp_async16(dst + i, src + i);
  hopper::cp_async_commit();
}

// The grid route: one cooperative launch of gridDim.x = per_pass x cs
// blocks, all resident, walks the samples per_pass at a time (a pass).
// Block (slot, q) takes rows [q * rows, min(M, (q + 1) * rows)) of sample
// pass * per_pass + slot: the first `held` of them (the slab, rows of C as
// in x) come into its shared memory by cp.async in two halves, every copy
// in flight at once, while the rest, if any, stream through registers; it
// sums x and x^2 per channel (each thread its 8 channels, Lane<T>, over its
// rows in order: the streamed rows, then the slab's), reduces them to group
// partials as the cluster route does and writes those to part[pass % 2]
// [block] (device memory); then the grid barrier; every block of the sample
// adds the sample's cs partials in a fixed order (the same sums in every
// block, the same bits on every run), folds them, and applies (+ SiLU) to
// the streamed rows read again and to the slab, into y. The partials
// alternate between two buffers by pass: a block writes pass p + 2's only
// after the barrier of pass p + 1, which every block reaches after it has
// read pass p's. blockDim = row_map(C, CLUSTER_THREADS) lanes * (C / 8);
// the shared memory is cluster_smem(held, C, G, elem). The first block of a
// sample writes the folded mul | add to vec [2, B, C].
template <bool ACT, typename V, typename T>
__global__ void __launch_bounds__(ROW_THREADS_MAX)
gn_grid_kernel(const T* __restrict__ X, int B, int M, int C, int G, int cs, int rows, int held, int per_pass,
               const V* __restrict__ scale, const V* __restrict__ bias, float eps, T* __restrict__ Y,
               float* __restrict__ vec, float* __restrict__ part, int* __restrict__ counter) {
  extern __shared__ __align__(16) uint8_t smem[];
  using L = Lane<T>;
  const RowMap rm = row_map(C, CLUSTER_THREADS);
  T* slab = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + (size_t)held * C * sizeof(T));
  float* csum = red + rm.lanes * C;
  float* gstat = csum + 2 * C + 2 * G;  // cluster_smem's layout (its group partials go to device memory here)
  const int rl = threadIdx.x / rm.per_row, u = threadIdx.x - rl * rm.per_row;
  const int slot = blockIdx.x / cs, q = blockIdx.x - slot * cs;
  const int r0 = q * rows;
  const int n = rows < M - r0 ? rows : M - r0;  // > 0: the plan leaves no block empty
  const int ns = n < held ? n : held;           // of which in shared memory
  const int ns0 = (ns + 1) / 2;                 // the slab's first half: rows [0, ns0)
  const int cg = C / G, passes = (B + per_pass - 1) / per_pass;
  const int step = CLUSTER_UNROLL * rm.lanes;
  for (int p = 0; p < passes; ++p) {
    const int b = p * per_pass + slot;
    const bool active = b < B;  // block-uniform: the last pass may hold fewer samples
    float* pp = part + (size_t)(p & 1) * gridDim.x * 2 * G;
    const T* xs = X + ((size_t)b * M + r0) * C;  // the block's first row
    T* ys = Y + ((size_t)b * M + r0) * C;
    if (active) {
      // 1. the slab's halves into shared memory, the streamed rows meanwhile
      // through registers; summed per channel, the streamed rows first, then
      // the slab's, each in order
      grid_fill(slab, xs, 0, ns0, C);
      grid_fill(slab, xs, ns0, ns, C);
      float s[8], ss[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = ss[e] = 0.f;
      for (int r = ns + rl; r < n; r += step) {
        Chunk<T> v[CLUSTER_UNROLL];
#pragma unroll
        for (int j = 0; j < CLUSTER_UNROLL; ++j)
          if (r + j * rm.lanes < n) v[j] = L::ldg(xs + (size_t)(r + j * rm.lanes) * C, u, C);
#pragma unroll
        for (int j = 0; j < CLUSTER_UNROLL; ++j)
          if (r + j * rm.lanes < n) {
            float f[8];
            to_f32x8(v[j], f);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              s[e] += f[e];
              ss[e] += f[e] * f[e];
            }
          }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half == 0)
          hopper::cp_async_wait<1>();
        else
          hopper::cp_async_wait<0>();
        __syncthreads();  // every thread's copies of the half have landed
#pragma unroll 4
        for (int r = rl + (half ? (ns0 - rl + rm.lanes - 1) / rm.lanes * rm.lanes : 0); r < (half ? ns : ns0);
             r += rm.lanes) {
          float f[8];
          to_f32x8(L::ld(slab + (size_t)r * C, u, C), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            s[e] += f[e];
            ss[e] += f[e] * f[e];
          }
        }
      }
      // 2. per channel, the row lanes in order; 3. the group's channels in order
#pragma unroll
      for (int which = 0; which < 2; ++which) {
#pragma unroll
        for (int e = 0; e < 8; ++e) red[rl * C + L::chan(u, e, C)] = which ? ss[e] : s[e];
        __syncthreads();
        for (int c = threadIdx.x; c < C; c += blockDim.x) {
          float acc = 0.f;
          for (int i = 0; i < rm.lanes; ++i) acc += red[i * C + c];
          csum[which * C + c] = acc;
        }
        __syncthreads();
      }
      for (int t = threadIdx.x; t < 2 * G; t += blockDim.x) {
        const int which = t / G, g = t - which * G;
        const float* col = csum + which * C + g * cg;
        float acc = 0.f;
        for (int j = 0; j < cg; ++j) acc += col[j];
        __stcg(pp + (size_t)blockIdx.x * 2 * G + t, acc);
      }
    }
    grid_sync(counter, (p + 1) * (int)gridDim.x);
    if (active) {
      // 4. the sample's cs blocks' partials: 8 threads a (sum | sum of
      // squares, group) each add every 8th block's in block order into four
      // sums (four loads in flight), then the 8 by a fixed shuffle tree (the
      // same bits in every block); folded
      const float* sp = pp + (size_t)slot * cs * 2 * G;
      const int lane = threadIdx.x & 31;
      const unsigned eight = 0xffu << (lane & 24);
      for (int i = threadIdx.x; i < 16 * G && threadIdx.x < (blockDim.x & ~7u); i += blockDim.x & ~7u) {
        const int t = i >> 3;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // blocks j, j + 8, j + 16, j + 24 of each 32
        int j = i & 7;
        for (; j + 24 < cs; j += 32) {
          a0 += __ldcg(sp + (size_t)j * 2 * G + t);
          a1 += __ldcg(sp + (size_t)(j + 8) * 2 * G + t);
          a2 += __ldcg(sp + (size_t)(j + 16) * 2 * G + t);
          a3 += __ldcg(sp + (size_t)(j + 24) * 2 * G + t);
        }
        for (; j < cs; j += 8) a0 += __ldcg(sp + (size_t)j * 2 * G + t);
        float acc = (a0 + a1) + (a2 + a3);
        acc += __shfl_xor_sync(eight, acc, 4);
        acc += __shfl_xor_sync(eight, acc, 2);
        acc += __shfl_xor_sync(eight, acc, 1);
        if ((i & 7) == 0) red[t] = acc;
      }
      __syncthreads();
      for (int g = threadIdx.x; g < G; g += blockDim.x) {
        const float nn = (float)((long long)M * cg);
        const float mean = red[g] / nn;
        gstat[g] = mean;
        gstat[G + g] = rsqrtf(hopper::fast_variance(red[G + g] / nn, mean) + eps);
      }
      __syncthreads();
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const int g = c / cg;
        const float m = gstat[G + g] * to_f32(scale[c]);
        const float a = to_f32(bias[c]) - gstat[g] * m;
        csum[c] = m;
        csum[C + c] = a;
        if (q == 0) {
          vec[(size_t)b * C + c] = m;
          vec[((size_t)B + b) * C + c] = a;
        }
      }
      __syncthreads();
      // 5. apply: first the streamed rows read again (read last by the
      // statistics, so the ones L2 still holds), then the slab
      float m[8], a[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        m[e] = csum[L::chan(u, e, C)];
        a[e] = csum[C + L::chan(u, e, C)];
      }
      for (int r = ns + rl; r < n; r += step) {
        Chunk<T> v[CLUSTER_UNROLL];
#pragma unroll
        for (int j = 0; j < CLUSTER_UNROLL; ++j)
          if (r + j * rm.lanes < n) v[j] = L::ldcs(xs + (size_t)(r + j * rm.lanes) * C, u, C);
#pragma unroll
        for (int j = 0; j < CLUSTER_UNROLL; ++j)
          if (r + j * rm.lanes < n) L::stcs(ys + (size_t)(r + j * rm.lanes) * C, u, C, apply8<ACT>(v[j], m, a));
      }
#pragma unroll 4
      for (int r = rl; r < ns; r += rm.lanes)
        L::stcs(ys + (size_t)r * C, u, C, apply8<ACT>(L::ld(slab + (size_t)r * C, u, C), m, a));
    }
    __syncthreads();  // the slab and the vectors are free for the next pass
  }
}

// ---- launches ----------------------------------------------------------------

cudaError_t stats_launch(const void* X, int is_f32, int B, long long M, int C, int G, int splits,
                         const void* scale, const void* bias, int vec_f32, float eps, float* part, float* mul,
                         float* add, cudaStream_t s) {
  const int per_row = C / 8;
  const int lanes = per_row < STATS_THREADS ? STATS_THREADS / per_row : 1;
  const long long rows = (M + splits - 1) / splits;
  const dim3 grid((unsigned)splits, (unsigned)B);
  const size_t smem = 2 * (size_t)lanes * C * sizeof(float);
  if (is_f32)
    gn_partial_kernel<float><<<grid, lanes * per_row, smem, s>>>(static_cast<const float*>(X), M, C, rows, part);
  else
    gn_partial_kernel<bf16><<<grid, lanes * per_row, smem, s>>>(static_cast<const bf16*>(X), M, C, rows, part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (vec_f32)
    gn_fold_kernel<float><<<dim3(G, B), FOLD_THREADS, 0, s>>>(part, splits, C, G, M, static_cast<const float*>(scale),
                                                              static_cast<const float*>(bias), eps, mul, add);
  else
    gn_fold_kernel<bf16><<<dim3(G, B), FOLD_THREADS, 0, s>>>(part, splits, C, G, M, static_cast<const bf16*>(scale),
                                                             static_cast<const bf16*>(bias), eps, mul, add);
  return cudaGetLastError();
}

// The statistics' row splits of a sample, as cuda_lib.gn_stats_splits
// reckons them: a block's lanes times STATS_ROWS rows each.
long long stats_splits(long long M, int C) {
  const int per_row = C / 8;
  const long long lanes = per_row < STATS_THREADS ? STATS_THREADS / per_row : 1;
  return (M + lanes * STATS_ROWS - 1) / (lanes * STATS_ROWS);
}

// Blocks of `threads` threads the card keeps resident (an SM's share at the
// kernel's occupancy, times the SMs), asked once per block size.
template <bool ACT, typename T>
int apply_resident(int threads) {
  static int cache[ROW_THREADS_MAX + 1] = {0};
  if (cache[threads] == 0) {
    int per = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, gn_apply_kernel<ACT, T>, threads, 0) != cudaSuccess ||
        per < 1)
      per = 1;
    cache[threads] = hopper::sm_count() * per;
  }
  return cache[threads];
}

template <bool ACT, typename T>
cudaError_t apply_launch(const T* x, int B, long long M, int C, const float* mul, const float* add, T* y,
                         cudaStream_t s) {
  const RowMap rm = row_map(C, APPLY_THREADS);
  const int threads = rm.lanes * rm.per_row;
  long long splits = (2 * apply_resident<ACT, T>(threads) + B - 1) / B;  // two waves: the last one balances
  const long long most = (M + rm.lanes - 1) / rm.lanes;  // a lane's row at least a block
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  const long long rows = (M + splits - 1) / splits;
  splits = (M + rows - 1) / rows;
  gn_apply_kernel<ACT, T><<<dim3((unsigned)splits, (unsigned)B), threads, 0, s>>>(x, M, C, rows, mul, add, y);
  return cudaGetLastError();
}

// The apply at the activation type of is_f32.
template <bool ACT>
cudaError_t apply_any(const void* x, int is_f32, int B, long long M, int C, const float* mul, const float* add,
                      void* y, cudaStream_t s) {
  return is_f32 ? apply_launch<ACT, float>(static_cast<const float*>(x), B, M, C, mul, add, static_cast<float*>(y), s)
                : apply_launch<ACT, bf16>(static_cast<const bf16*>(x), B, M, C, mul, add, static_cast<bf16*>(y), s);
}

template <bool ACT, typename V, typename T>
cudaError_t cluster_config(int cs, int B, int C, int smem, cudaStream_t s, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute* attr) {
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(gn_cluster_kernel<ACT, V, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gn_cluster_kernel<ACT, V, T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const RowMap rm = row_map(C, CLUSTER_THREADS);
  cfg = {};
  cfg.gridDim = dim3((unsigned)cs, (unsigned)B);
  cfg.blockDim = dim3((unsigned)(rm.lanes * rm.per_row));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <bool ACT, typename V, typename T>
cudaError_t cluster_launch(const void* x, int B, int M, int C, int G, int cs, int rows, int smem, const void* scale,
                           const void* bias, float eps, void* y, float* vec_out, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config<ACT, V, T>(cs, B, C, smem, s, cfg, attr);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, gn_cluster_kernel<ACT, V, T>, static_cast<const T*>(x), M, C, G, rows,
                         static_cast<const V*>(scale), static_cast<const V*>(bias), eps, static_cast<T*>(y), vec_out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool ACT, typename T>
cudaError_t cluster_any(const void* x, int B, int M, int C, int G, int cs, int rows, int smem, const void* scale,
                        const void* bias, int vec_f32, float eps, void* y, float* vec_out, cudaStream_t s) {
  return vec_f32 ? cluster_launch<ACT, float, T>(x, B, M, C, G, cs, rows, smem, scale, bias, eps, y, vec_out, s)
                 : cluster_launch<ACT, bf16, T>(x, B, M, C, G, cs, rows, smem, scale, bias, eps, y, vec_out, s);
}

template <bool ACT, typename V, typename T>
cudaError_t grid_launch(const void* x, int B, int M, int C, int G, int cs, int rows, int held, int per_pass, int smem,
                        const void* scale, const void* bias, float eps, void* y, float* sc, cudaStream_t s) {
  void (*kern)(const T*, int, int, int, int, int, int, int, int, const V*, const V*, float, T*, float*, float*, int*) =
      gn_grid_kernel<ACT, V, T>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const RowMap rm = row_map(C, CLUSTER_THREADS);
  const int threads = rm.lanes * rm.per_row, grid = per_pass * cs;
  int per = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, threads, smem);
  if (e != cudaSuccess) return e;
  if ((long long)per * hopper::sm_count() < grid) return cudaErrorCooperativeLaunchTooLarge;  // not all resident
  float* vec = sc;
  float* part = sc + 2 * (size_t)B * C;
  int* counter = reinterpret_cast<int*>(part + 4 * (size_t)grid * G);
  e = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), B, M, C, G, cs, rows, held, per_pass,
                         static_cast<const V*>(scale), static_cast<const V*>(bias), eps, static_cast<T*>(y), vec, part,
                         counter);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool ACT>
cudaError_t grid_any(const void* x, int B, int M, int C, int G, int cs, int rows, int held, int per_pass, int smem,
                     const void* scale, const void* bias, int vec_f32, float eps, void* y, float* sc, cudaStream_t s) {
  return vec_f32
             ? grid_launch<ACT, float, float>(x, B, M, C, G, cs, rows, held, per_pass, smem, scale, bias, eps, y, sc, s)
             : grid_launch<ACT, bf16, float>(x, B, M, C, G, cs, rows, held, per_pass, smem, scale, bias, eps, y, sc, s);
}

bool shape_ok(int B, long long M, int C, int G) {
  return B > 0 && B <= 65535 && M > 0 && C > 0 && C % 8 == 0 && C <= C_MAX && G > 0 && C % G == 0;
}

}  // namespace

// x, y: [B, per_sample] bf16 (is_f32 = 0) or fp32 (is_f32 = 1), 16-byte
// aligned, per_sample = M * C; C % 8 == 0; mul, add: [B, C] fp32 (checked in
// Python before the call).
extern "C" int ds_gn_silu(const void* X, int B, long long per_sample, int C, const void* mul,
                          const void* add, int act, void* Y, int is_f32, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || C % 8 || C > C_MAX || per_sample % C) return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mul);
  const float* a = static_cast<const float*>(add);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = per_sample / C;
  return (int)(act ? apply_any<true>(X, is_f32, B, M, C, m, a, Y, s)
                   : apply_any<false>(X, is_f32, B, M, C, m, a, Y, s));
}

// x: [B, M, C] bf16 (is_f32 = 0) or fp32 (is_f32 = 1), 16-byte aligned;
// C % 8 == 0, C % G == 0, C <= 6144; scale, bias: [C] bf16 (vec_f32 = 0) or
// fp32 (vec_f32 = 1); part: fp32 [splits, B, 2, C] scratch (the wrapper
// reckons splits: cuda_lib.gn_stats_splits); mul, add: [B, C] fp32 out.
extern "C" int ds_gn_stats(const void* X, int is_f32, int B, long long M, int C, int G, int splits,
                           const void* scale, const void* bias, int vec_f32, float eps, void* part, void* mul,
                           void* add, void* stream) {
  if (!shape_ok(B, M, C, G) || splits <= 0) return (int)cudaErrorInvalidValue;
  return (int)stats_launch(X, is_f32, B, M, C, G, splits, scale, bias, vec_f32, eps, static_cast<float*>(part),
                           static_cast<float*>(mul), static_cast<float*>(add), static_cast<cudaStream_t>(stream));
}

// GroupNorm(G) [-> SiLU] of x [B, M, C] with statistics per sample, into
// y [B, M, C], both bf16 (is_f32 = 0) or fp32 (is_f32 = 1); scale, bias [C]
// bf16 (vec_f32 = 0) or fp32. The plan is
// cuda_lib.gn_plan's: route 0 "cluster" (cs blocks a sample of `rows` rows,
// smem bytes of dynamic shared memory each; scratch null, or [2, B, C] fp32
// that receives the folded mul | add), route 1 "split" (`splits` row
// splits of `rows` rows for the statistics, whose kernel takes smem bytes;
// scratch [2, B, C] mul | add then [splits, B, 2, C] partials, fp32) or
// route 2 "grid", fp32 only (`splits` samples a pass, cs blocks a sample of
// `rows` rows, smem bytes each, which hold min(rows, what fits) of them; scratch
// [2, B, C] mul | add, then [2, splits * cs, 2, G] partials, then the
// barrier's int counter). A plan that does not match this file's reckoning
// returns cudaErrorInvalidValue; a grid whose blocks the card cannot hold
// all at once returns cudaErrorCooperativeLaunchTooLarge.
extern "C" int ds_group_norm_silu(const void* X, int B, long long M, int C, int G, const void* scale,
                                  const void* bias, int vec_f32, float eps, int act, int route, int cs,
                                  long long rows, int smem, int splits, void* scratch, void* Y, int is_f32,
                                  void* stream) {
  if (!shape_ok(B, M, C, G) || rows <= 0) return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (cs < 1 || cs > CLUSTER_MAX || (long long)(cs - 1) * rows >= M || (long long)cs * rows < M ||
        smem != cluster_smem(rows, C, G, is_f32 ? 4 : 2) || smem > SMEM_MAX ||
        2 * G * cs > row_map(C, CLUSTER_THREADS).lanes * C)  // the gathered partials fit the lanes' sums
      return (int)cudaErrorInvalidValue;
    const int m = (int)M, r = (int)rows;
    cudaError_t e;
    if (is_f32)
      e = act ? cluster_any<true, float>(X, B, m, C, G, cs, r, smem, scale, bias, vec_f32, eps, Y, sc, s)
              : cluster_any<false, float>(X, B, m, C, G, cs, r, smem, scale, bias, vec_f32, eps, Y, sc, s);
    else
      e = act ? cluster_any<true, bf16>(X, B, m, C, G, cs, r, smem, scale, bias, vec_f32, eps, Y, sc, s)
              : cluster_any<false, bf16>(X, B, m, C, G, cs, r, smem, scale, bias, vec_f32, eps, Y, sc, s);
    return (int)e;
  }
  if (route == 2) {  // fp32 only
    const long long fit = (SMEM_MAX - cluster_smem(0, C, G, 4)) / (4LL * C);  // rows a block holds
    const long long held = rows < fit ? rows : fit;
    if (!is_f32 || sc == nullptr || M > INT_MAX || cs < 1 || splits < 1 || splits > B ||
        (long long)(cs - 1) * rows >= M || (long long)cs * rows < M || held < 1 || smem != cluster_smem(held, C, G, 4))
      return (int)cudaErrorInvalidValue;
    const int m = (int)M, r = (int)rows, hd = (int)held;
    return (int)(act ? grid_any<true>(X, B, m, C, G, cs, r, hd, splits, smem, scale, bias, vec_f32, eps, Y, sc, s)
                     : grid_any<false>(X, B, m, C, G, cs, r, hd, splits, smem, scale, bias, vec_f32, eps, Y, sc, s));
  }
  const int per_row = C / 8;
  const int lanes = per_row < STATS_THREADS ? STATS_THREADS / per_row : 1;
  if (route != 1 || sc == nullptr || splits != stats_splits(M, C) || rows != (M + splits - 1) / splits ||
      smem != 2 * lanes * C * (int)sizeof(float))
    return (int)cudaErrorInvalidValue;
  float* mul = sc;
  float* add = sc + (size_t)B * C;
  cudaError_t e = stats_launch(X, is_f32, B, M, C, G, splits, scale, bias, vec_f32, eps, sc + 2 * (size_t)B * C,
                               mul, add, s);
  if (e != cudaSuccess) return (int)e;
  return (int)(act ? apply_any<true>(X, is_f32, B, M, C, mul, add, Y, s)
                   : apply_any<false>(X, is_f32, B, M, C, mul, add, Y, s));
}

// How many clusters of `cs` cluster-route blocks with `smem` bytes of shared
// memory at width C the card holds at once (cudaOccupancyMaxActiveClusters),
// into *out.
extern "C" int ds_gn_clusters(int cs, int C, int smem, int* out, void* stream) {
  if (cs < 1 || cs > CLUSTER_MAX || C <= 0 || C % 8 || C > C_MAX || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config<true, bf16, bf16>(cs, 1, C, smem, static_cast<cudaStream_t>(stream), cfg, attr);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(out, gn_cluster_kernel<true, bf16, bf16>, &cfg);
  return (int)e;
}
