"""Variants of the fp32 tensor-core kernels, timed in one call on one card.

    python3 chip_tf32_variants.py               # one CUDA card; every kernel
    python3 chip_tf32_variants.py block         # only some: gemm, flash, block
                                                # (= temporal and spatial), gn, ta

``csrc/gemm_f32.cu::ds_ln_gemm_f32``, ``csrc/attention_f32.cu::
ds_flash_attention_f32``, ``csrc/temporal_f32.cu`` (kernels 10 and 12,
``ds_temporal_block_f32`` and ``ds_temporal_mega_f32``) and
``csrc/spatial_f32.cu`` (kernels 11 and 13, ``ds_spatial_block_f32`` and
``ds_mega_spatial_f32``) multiply fp32 operands as three tf32 products.
This script builds variants of the sources (the source as committed,
changed by text replacement, a patch applying to the file that holds its
text: the source, ``tc_f32.cuh`` or ``hopper.cuh``; each built alone with
``nvcc`` into ``build/tf32_variants/``, ptxas's spill bytes printed), runs
each through the port's own wrappers (``cuda_lib.ln_gemm``,
``fused_spatial.flash_attention``, ``fused_mega.temporal_mega``,
``fused_block.fused_temporal_block``, ``fused_block.fused_spatial_block``,
``fused_mega.spatial_mega``) at shapes of the full-width batch-8 i2v fp32
forward, holds it against the plain version, and times the variants in
turns (as built, then each variant, then the same in reverse order). The
variants answer the design's questions:

* ``integer rounding``: ``hopper.cuh::tf32_rna`` in integer operations
  (the same bits, inf and NaN kept) instead of ``cvt.rna.tf32.f32``;
* ``one accumulator``: every product of a tile into one accumulator, no
  per-stage fold: the error the tensor core's rounding towards zero adds;
* ``weights split in shared memory``: the GEMM reads the raw weights and
  three warps of its producer warpgroup split each B stage in shared
  memory, the other way to split them (the design takes them split once,
  ``cuda_lib.tf32_split_weights``, twice the fp32 weights in memory);
* ``A not split``, ``K, V not split`` (results wrong, the gate not
  applied): what the split of the activations and of the flash kernel's
  keys and values costs;
* kernels 10 and 12 at the t320 and t640 transformers (kernel 12) and at
  t1280 (kernel 10: the 10x16 level and the middle block's 5x8), each
  variant at each token tile it builds (TM 128 and 64), held against the
  plain version and against the kernel as built at the same tile (``same
  bits``): ``CL 2`` (clusters of two blocks sharing each weight tile by
  multicast), ``weights ahead`` (a product's first three stages of weights
  issued before the consumers' pass ends, where the pass leaves the ring
  alone), ``split at write`` (the passes write the token rows already
  split, into the scratch and a mirror of it; the stage brings both, a
  ring of 3), ``A not split`` (wrong by design: what splitting the rows in
  registers costs, the most that splitting them when written could save),
  ``residual resident`` (the residual stream in shared memory beside a ring
  of 3 where it fits: TM 64 at C 320), ``BN 64`` (column tiles of 64 weight
  rows), ``2 stages`` (a ring of 2), ``one accumulator`` (every product of
  a column tile into the tile's accumulator) and ``fold every stage`` (each
  32-deep stage's products folded alone, as gemm_f32.cu folds them);
* kernels 11 and 13 at the s320 and s640 transformers, at TM 128 and 64:
  ``a barrier a stage`` (the first version's handoffs), ``Q in
  registers`` (Q's lo half too), ``indices hoistable`` (the attention's
  thread indices not made opaque), ``attention not inlined``, ``P V one
  accumulator`` (no fold), ``test_wait`` (a spinning mbarrier wait),
  ``splitter warps`` (FA.f32's split in the block instead of the split
  once a launch, TM 128), and wrong by design ``no attention``, ``no self-attention`` (its key tiles
  still streamed; also with their hi halves alone), ``no
  cross-attention`` and ``one key sample`` (every query tile on sample 0's
  keys, L2-resident): where the time goes;
* kernel 9 at fp32 (``csrc/gn_silu.cu::ds_group_norm_silu``, through
  ``fused_twrap.gn_silu`` on ``gn_plan``'s route) at the largest calls of the
  forward and the VAE: ``plain re-read order`` (the grid route's apply
  writes the slab before it reads again the rows that did not fit shared
  memory), and the fp32 SiLU as the accurate ``h / (1 + expf(-h))`` or as
  ``h * __frcp_rn(1 + __expf(-h))`` against the built ``__fdividef(h, 1 +
  __expf(-h))``; and the
  grid route's phases a pass (the load and sums, the reductions, the grid
  barrier, the partials' gather and fold, the apply) from ``%globaltimer``
  stamps of four blocks, in a build with the stamps patched in;
* K1's attention at fp32 (``csrc/attention_f32.cu::
  ds_temporal_attention_f32``, through ``fused_temporal.temporal_attention``)
  at the forward's K1 calls: tiles of 64 tokens in a ring of 2 and of 3
  slots against 128 tokens in 2 (3 slots of 128 do not fit).

Prints one line per shape, then one JSON object of every time and error.
Fails if a variant does not build or an as-built run misses the fp32 gate.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

from dynamicscaler_tpu_torch.ops import cuda_lib, fused_block, fused_mega, fused_spatial

TOL_F32 = 1e-5
OUT = cuda_lib.REPO_ROOT / "build" / "tf32_variants"
HOPPER = (cuda_lib.CSRC / "hopper.cuh").read_text()
SHARED = (cuda_lib.CSRC / "tc_f32.cuh").read_text()


def _rna_body(src):
    start = src.index("__device__ __forceinline__ uint32_t tf32_rna(float x) {")
    return src[start:src.index("\n}\n", start) + 2]


INT_RNA = """__device__ __forceinline__ uint32_t tf32_rna(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x7F800000u) == 0x7F800000u ? u : (u + 0x1000u) & 0xFFFFE000u;
}"""
SPLIT_A = ("""        split_tf32(*reinterpret_cast<const float*>(arow + h * 8 * ROW + (((2 * j + c) ^ g) << 4)),
                   f[0][j][h + 2 * c], f[1][j][h + 2 * c]);""",
           """        {
          f[0][j][h + 2 * c] = *reinterpret_cast<const uint32_t*>(arow + h * 8 * ROW + (((2 * j + c) ^ g) << 4));
          f[1][j][h + 2 * c] = 0u;
        }""")
ONE_ACC = [("issue_stage<BN>(part, f0,", "issue_stage<BN>(acc, f0,"),
           ("issue_stage<BN>(part, f1,", "issue_stage<BN>(acc, f1,"),
           ("    WgmmaTf32RegA<BN>::mma(part, f[1][j], bh + 2 * j, j);",
            "    WgmmaTf32RegA<BN>::mma(part, f[1][j], bh + 2 * j, 1);")]
# the raw weights by TMA, three warps of the producer warpgroup splitting each
# B stage in shared memory (in place, the remainders beside it) before the
# consumers (a third mbarrier a stage) read it
SMEM_SPLIT = [
    ("  return SMEM_ALIGN + stages * stage_bytes(bn) + 2 * stages * 8;",
     "  return SMEM_ALIGN + stages * stage_bytes(bn) + 3 * stages * 8;"),
    ("constexpr int CONSUMER_REGS = 232;", "constexpr int CONSUMER_REGS = 224;"),
    ("constexpr int PRODUCER_REGS = 40;", "constexpr int PRODUCER_REGS = 56;"),
    ("      mbar_init(&empty[s], 8);  // one arrival per consumer warp",
     "      mbar_init(&empty[s], 8);  // one arrival per consumer warp\n      mbar_init(&empty[S + s], 3);"),
    ("  mbar_wait(&full[it % S], (it / S) & 1);\n}",
     "  mbar_wait(&full[it % S], (it / S) & 1);\n  mbar_wait(&full[2 * S + it % S], (it / S) & 1);\n}"),
    ("          mbar_expect_tx(&full[s], A_BYTES + 2 * B_BYTES);", "          mbar_expect_tx(&full[s], A_BYTES + B_BYTES);"),
    ("          for (int half = 0; half < 2; ++half) {  // W_hi, then W_lo",
     "          for (int half = 0; half < 1; ++half) {"),
    ("    }\n  } else {\n    // ---- consumers: warpgroup wg owns tile rows", """    } else if (tid >= 32) {
      const int sid = tid - 32, lane = tid & 31;
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&full[s], (it / S) & 1);
          uint4* hi = reinterpret_cast<uint4*>(smem + s * STAGE + A_BYTES);
          uint4* lo = hi + B_BYTES / 16;
          for (int i = sid; i < B_BYTES / 16; i += 96) {
            const float4 v = *reinterpret_cast<const float4*>(hi + i);
            uint4 h, l;
            split_tf32(v.x, h.x, l.x);
            split_tf32(v.y, h.y, l.y);
            split_tf32(v.z, h.z, l.z);
            split_tf32(v.w, h.w, l.w);
            hi[i] = h;
            lo[i] = l;
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[S + s]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows"""),
    ("    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 2};",
     "    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 1};")]
RAW_W = ("weights split in shared memory",)  # the variants that take the raw weights
GEMM_VARIANTS = {"as built": ([], None), "integer rounding": ([], INT_RNA), "one accumulator": (ONE_ACC, None),
                 "weights split in shared memory": (SMEM_SPLIT, None), "A not split": ([SPLIT_A], None)}
WRONG = ("A not split", "K, V not split")
SPLIT_KV = [("            for (int i = sid; i < 2 * KH / 16; i += F_SPLITTERS) {\n              const float4 v",
             "            for (int i = sid; i < 0; i += F_SPLITTERS) {\n              const float4 v"),
            ("            for (int i = sid; i < 2 * KH / 16; i += F_SPLITTERS) {\n              const int d",
             "            for (int i = sid; i < 0; i += F_SPLITTERS) {\n              const int d")]
FLASH_VARIANTS = {"as built": ([], None), "integer rounding": ([], INT_RNA), "K, V not split": (SPLIT_KV, None)}
# (M, K, N, mode, LayerNorm prologue, calls per batch-8 i2v fp32 forward): the
# heaviest GEMM shapes of the forward (chip_smoke.py phase 10's table)
GEMM_SHAPES = [(327680, 320, 2560, cuda_lib.MODE_GEGLU, True, 5), (81920, 2560, 640, cuda_lib.MODE_RESIDUAL, False, 10),
               (20480, 5120, 1280, cuda_lib.MODE_RESIDUAL, False, 10),
               (327680, 320, 320, cuda_lib.MODE_RESIDUAL, False, 15),
               (20480, 1280, 3840, cuda_lib.MODE_STORE, True, 15), (9856, 1024, 2560, cuda_lib.MODE_STORE, False, 6)]
# (B, Nq, key segments): K2's self-attention at 40x64 and K3's i2v cross-attention
FLASH_SHAPES = [(128, 2560, (2560,)), (128, 640, (640,)), (128, 2560, (77, 16))]
# temporal_f32.cu (kernels 10 and 12): the variants of its source, each run at the token tiles it builds (the
# source as committed: TM 128 and 64)
TILES = [128, 64]
# clusters of 2 blocks walking the same tiles in step, each producer issuing half of every weight tile's
# boxes multicast to both, a slot refilled once the consumers of both released it, `ready` once both
# blocks' consumers wrote their A rows
CL2 = [
    ("// ---- the consumers' passes", """// tma_load_3d landing at offset `dst` of every block of the cluster in `mask`
__device__ __forceinline__ void tma_load_3d_multicast(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                                      int c1, int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%4, %5, %6}], [%2], %3;\\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---- the consumers' passes"""),
    ("  if (lane == 0) mbar_arrive(&empty[s]);\n}", "  if (lane < 2) mbar_arrive_cluster(&empty[s], lane);\n}"),
    ("  constexpr int BOX = T::HB * ROW;\n", "  constexpr int BOX = T::HB * ROW;\n  const uint32_t rank = cluster_rank();\n"),
    ("""  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    for (int g = MEGA ? G_IN : G_QKV1; g <= (MEGA ? G_OUT : G_W2); ++g) {
      mbar_wait(ready, rp);""", """  for (int base = blockIdx.x - rank; base < a.tiles; base += gridDim.x) {
    for (int g = MEGA ? G_IN : G_QKV1; g <= (MEGA ? G_OUT : G_W2); ++g) {
      mbar_wait_cluster(ready, rp);"""),
    ("""            if (n < 0) continue;
            for (int half = 0; half < 2; ++half)
              tma_load_3d(sa + T::A_BYTES + half * BN * ROW + b * BOX, &m.w[g], &full[s], kt * BK, n, half);""",
     """            if (n < 0 || b % 2 != (int)rank) continue;
            for (int half = 0; half < 2; ++half)
              tma_load_3d_multicast(sa + T::A_BYTES + half * BN * ROW + b * BOX, &m.w[g], &full[s], kt * BK, n, half,
                                    3);"""),
    ("  const size_t slot = (size_t)blockIdx.x * TM;\n",
     "  const size_t slot = (size_t)blockIdx.x * TM;\n  const uint32_t rank = cluster_rank();\n"),
    ("""  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long t0 = (long long)tile * TM;
    const int rows = (int)min((long long)TM, a.T - t0);""",
     """  for (int base = blockIdx.x - rank; base < a.tiles; base += gridDim.x) {
    const long long t0 = (long long)(base + rank) * TM;
    const int rows = a.T > t0 ? (int)min((long long)TM, a.T - t0) : 0;"""),
    ("      if (tid == 0) mbar_arrive(ready);",
     "      if (tid == 0) {\n        mbar_arrive_remote(ready, rank);\n        mbar_arrive_remote(ready, rank ^ 1);\n      }"),
    ("      mbar_init(&empty[s], 8);  // one arrival per consumer warp", "      mbar_init(&empty[s], 16);"),
    ("    mbar_init(ready, 1);", "    mbar_init(ready, 2);"),
    ("  __syncthreads();\n  if (threadIdx.x >= CONSUMERS) {", "  cluster_sync_all();\n  if (threadIdx.x >= CONSUMERS) {"),
    ("    consume<TM, MEGA>(a, smem, full, empty, ready);\n  }\n}",
     "    consume<TM, MEGA>(a, smem, full, empty, ready);\n  }\n  __syncwarp();\n  cluster_sync_all();\n}"),
    ("""  temporal_tc_f32_kernel<TM, MEGA><<<blocks, THREADS, smem_bytes<TM>(), stream>>>(m, a);
  return cudaGetLastError();""", """  static int fit = 0;  // blocks on the card at once
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<TM>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (fit == 0) {
    int clusters = 0;
    cfg.gridDim = dim3(2);
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, temporal_tc_f32_kernel<TM, MEGA>, &cfg);
    if (e != cudaSuccess) return e;
    fit = 2 * clusters;
  }
  blocks &= ~1;
  if (blocks < 2 || fit < 2) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(blocks < fit ? blocks : fit);
  return cudaLaunchKernelEx(&cfg, temporal_tc_f32_kernel<TM, MEGA>, m, a);""")]
# the schedule: the weights of a product's first 3 stages go out before the consumers' pass ends (`ready`),
# where the pass leaves the ring alone (all but the attention's), their token rows after it
WEIGHTS_AHEAD = [
    ("""      mbar_wait(ready, rp);  // the consumers wrote this product's A rows
      rp ^= 1;
      const int N = gemm_n(g, C), KT = gemm_k(g, C) / BK;
      const bool geglu = g == G_W1;
      const int nt = geglu ? N / BN : (N + BN - 1) / BN;""", """      const int N = gemm_n(g, C), KT = gemm_k(g, C) / BK;
      const bool geglu = g == G_W1;
      const int nt = geglu ? N / BN : (N + BN - 1) / BN;
      const int P = g == G_WO1 || g == G_WO2 ? 0 : min(STAGES - 1, nt * KT - 1);
      const int it0 = it;
      if (P == 0) {
        mbar_wait(ready, rp);
        rp ^= 1;
      }"""),
    ("          tma_load_2d(sa, &m.a[gemm_a(g)], &full[s], kt * BK, row0);\n", ""),
    ("""              tma_load_3d(sa + T::A_BYTES + half * BN * ROW + b * BOX, &m.w[g], &full[s], kt * BK, n, half);
          }""", """              tma_load_3d(sa + T::A_BYTES + half * BN * ROW + b * BOX, &m.w[g], &full[s], kt * BK, n, half);
          }
          if (P > 0 && it - it0 == P) {
            mbar_wait(ready, rp);
            rp ^= 1;
            for (int e = 0; e < P; ++e)
              tma_load_2d(smem + ((it0 + e) % STAGES) * T::STAGE, &m.a[gemm_a(g)], &full[(it0 + e) % STAGES],
                          (e % KT) * BK, row0);
          }
          if (it - it0 >= P) tma_load_2d(sa, &m.a[gemm_a(g)], &full[s], kt * BK, row0);""")]
# the token rows written already split by the passes that write a product's A rows (LayerNorm,
# GroupNorm apply, attention, GEGLU, kernel 12's last residual) into the scratch and a mirror of it, the
# stage bringing both (so 3 slots fit), the consumers loading the fragments without a split
SPLIT_AT_WRITE = [
    ("__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }\n",
     """__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ long long g_lo;  // floats from a scratch row to its remainders in the mirror
__device__ __forceinline__ void store_split(float* p, float4 v) {
  uint4 h, l;
  split_tf32(v.x, h.x, l.x);
  split_tf32(v.y, h.y, l.y);
  split_tf32(v.z, h.z, l.z);
  split_tf32(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(p) = h;
  *reinterpret_cast<uint4*>(p + g_lo) = l;
}
__device__ __forceinline__ void store_split(float* p, float2 v) {
  uint2 h, l;
  split_tf32(v.x, h.x, l.x);
  split_tf32(v.y, h.y, l.y);
  *reinterpret_cast<uint2*>(p) = h;
  *reinterpret_cast<uint2*>(p + g_lo) = l;
}
"""),
    ("        *reinterpret_cast<float4*>(dst + (size_t)(r0 + i) * C + k) = o;",
     "        store_split(dst + (size_t)(r0 + i) * C + k, o);"),
    ("      *reinterpret_cast<float4*>(dst + (size_t)r * C + c) = v[u];",
     "      store_split(dst + (size_t)r * C + c, v[u]);"),
    ("      *reinterpret_cast<float4*>(y + d) = make_float4(o[d] * il, o[d + 1] * il, o[d + 2] * il, o[d + 3] * il);",
     "      store_split(y + d, make_float4(o[d] * il, o[d + 1] * il, o[d + 2] * il, o[d + 3] * il));"),
    ("        *reinterpret_cast<float2*>(y + 8 * dt) = make_float2(o[dt][2 * r] * il, o[dt][2 * r + 1] * il);",
     "        store_split(y + 8 * dt, make_float2(o[dt][2 * r] * il, o[dt][2 * r + 1] * il));"),
    ("              *reinterpret_cast<float2*>(y + n) = make_float2(v.x * gelu_erf(gt.x), v.y * gelu_erf(gt.y));",
     "              store_split(y + n, make_float2(v.x * gelu_erf(gt.x), v.y * gelu_erf(gt.y)));"),
    ("              *reinterpret_cast<float2*>(y + n) = v;",
     "              if (MEGA && g == G_W2) store_split(y + n, v);\n"
     "              else *reinterpret_cast<float2*>(y + n) = v;"),
    ("  static constexpr int STAGE = A_BYTES + 2 * BN * ROW;", "  static constexpr int STAGE = 2 * A_BYTES + 2 * BN * ROW;"),
    ("constexpr int STAGES = 4; ", "constexpr int STAGES = 3; "),
    ("__device__ __forceinline__ void load_frags(", "template <int LO>\n__device__ __forceinline__ void load_frags("),
    ("""        split_tf32(*reinterpret_cast<const float*>(arow + h * 8 * ROW + (((2 * j + c) ^ g) << 4)),
                   f[0][j][h + 2 * c], f[1][j][h + 2 * c]);""",
     """        {
          const uint8_t* q = arow + h * 8 * ROW + (((2 * j + c) ^ g) << 4);
          f[0][j][h + 2 * c] = *reinterpret_cast<const uint32_t*>(q);
          f[1][j][h + 2 * c] = *reinterpret_cast<const uint32_t*>(q + LO);
        }"""),
    ("load_frags(smem", "load_frags<T::A_BYTES + 2 * BN * ROW>(smem"),
    ("""          mbar_expect_tx(&full[s], T::A_BYTES + boxes * 2 * BOX);
          tma_load_2d(sa, &m.a[gemm_a(g)], &full[s], kt * BK, row0);""",
     """          mbar_expect_tx(&full[s], 2 * T::A_BYTES + boxes * 2 * BOX);
          tma_load_2d(sa, &m.a[gemm_a(g)], &full[s], kt * BK, row0);
          tma_load_2d(sa + T::A_BYTES + 2 * BN * ROW, &m.alo[gemm_a(g)], &full[s], kt * BK, row0);"""),
    ("  CUtensorMap a[N_REGIONS];", "  CUtensorMap alo[N_REGIONS];\n  CUtensorMap a[N_REGIONS];"),
    ("  a.reg[R_S] = base + rows * 5 * C;\n", """  a.reg[R_S] = base + rows * 5 * C;
  static float* lo = nullptr;
  static long long lo_floats = 0;
  if (lo_floats < scratch_floats) {
    if (lo) cudaFree(lo);
    if (cudaMalloc(&lo, scratch_floats * 4) != cudaSuccess) return (int)cudaErrorMemoryAllocation;
    lo_floats = scratch_floats;
  }
  static long long delta;
  delta = lo - base;
  if (cudaMemcpyToSymbolAsync(g_lo, &delta, sizeof(delta), 0, cudaMemcpyHostToDevice,
                              static_cast<cudaStream_t>(stream)) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
"""),
    ("""    if (!make_map(&m.a[r], a.reg[r], 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return (int)cudaErrorInvalidValue;""",
     """    if (!make_map(&m.a[r], a.reg[r], 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
        !make_map(&m.alo[r], lo + (a.reg[r] - base), 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return (int)cudaErrorInvalidValue;""")]
# the residual stream in shared memory beside a ring of 3 slots where it fits (80 KB: TM 64 at C <= 320),
# kernel 12's last residual written to the LayerNorm rows' region for w_out's TMA
RESIDENT = [
    ("constexpr int STAGES = 4; ", "constexpr int STAGES = 3; "),
    ("constexpr int SMEM_ALIGN = 1024; ", "constexpr int RES = 64 * 320 * 4;\nconstexpr int SMEM_ALIGN = 1024; "),
    ("  static_assert(SMEM_ALIGN + Tile<TM>::RING + (2 * STAGES + 1) * 8 <= SMEM_MAX, \"the ring fits\");\n"
     "  return SMEM_ALIGN + Tile<TM>::RING + (2 * STAGES + 1) * 8;",
     "  return SMEM_ALIGN + Tile<TM>::RING + RES + (2 * STAGES + 1) * 8;"),
    ("  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile<TM>::RING);",
     "  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile<TM>::RING + RES);"),
    ("  float* ss = a.reg[R_S] + slot * C;",
     "  float* ss = TM * C * 4 <= RES ? reinterpret_cast<float*>(smem + T::RING) : a.reg[R_S] + slot * C;"),
    ("g == G_OUT ? R_S : R_H; }", "R_H; }"),
    ("""          } else if (g == G_WO1 || g == G_WO2 || (g == G_W2 && MEGA)) {
            y = ss + (size_t)r * C;
            res = y;""",
     """          } else if (g == G_WO1 || g == G_WO2) {
            y = ss + (size_t)r * C;
            res = y;
          } else if (g == G_W2 && MEGA) {
            y = hs + (size_t)r * C;
            res = ss + (size_t)r * C;""")]
# the ring at least as large as the F-frame attention that borrows it (for rings smaller than 4 slots of 128
# weight rows)
RING_FIT = ("  static constexpr int RING = STAGES * STAGE;",
            "  static constexpr int RING = STAGES * STAGE > TM * (2 * (D + 4) + 129) * 4 ? STAGES * STAGE\n"
            "                                                                         : TM * (2 * (D + 4) + 129) * 4;")
BLOCK_ONE_ACC = [("issue_stage<T::WN>(part, f0,", "issue_stage<T::WN>(acc, f0,"),
                 ("issue_stage<T::WN>(part, f1,", "issue_stage<T::WN>(acc, f1,"),
                 ("    WgmmaTf32RegA<WN>::mma(part, f[1][j], bh + 2 * j, j || cont);",
                  "    WgmmaTf32RegA<WN>::mma(part, f[1][j], bh + 2 * j, 1);")]
BN64 = [RING_FIT, ("constexpr int BN = 128; ", "constexpr int BN = 64;  "),
        ("  else e = mega ? launch<64, true>(m, a, slots, s) : launch<64, false>(m, a, slots, s);",
         "  else e = cudaErrorInvalidValue;")]
# each stage's products into an accumulator of their own, folded into the tile's after every stage (the design
# of kernels 1-8 at fp32, gemm_f32.cu): the tensor cores wait for the fold after every stage
FOLD1 = [
    ("    WgmmaTf32RegA<WN>::mma(part, f[1][j], bh + 2 * j, j || cont);",
     "    WgmmaTf32RegA<WN>::mma(part, f[1][j], bh + 2 * j, j);"),
    ("""    issue_stage<T::WN>(part, f1, smem + s1 * T::STAGE + T::A_BYTES + wrow, true);
    wgmma_wait<1>();  // the first stage's products are done: its slot and f0 are free
    release(empty, s0, lane);
    if (kt + 2 < KT) {""", """    wgmma_wait<0>();
    fence_acc(part);
    release(empty, s0, lane);
#pragma unroll
    for (int i = 0; i < T::ACC; ++i) acc[i] += part[i];
    issue_stage<T::WN>(part, f1, smem + s1 * T::STAGE + T::A_BYTES + wrow, false);
    if (kt + 2 < KT) {""")]
# each accumulator of the stages' own holding four stages' products (128 k), the stages issued one behind the
# other, each stage's fragments loaded while the one before it runs
FOLD4_LOOP = """  stage_wait(full, it);
  load_frags(smem + (it % STAGES) * T::STAGE, r0, g8, t4, f0);
  issue_stage<T::WN>(part, f0, smem + (it % STAGES) * T::STAGE + T::A_BYTES + wrow, false);
  stage_wait(full, it + 1);
  load_frags(smem + ((it + 1) % STAGES) * T::STAGE, r0, g8, t4, f1);
#define STEP(K, FC, FN)                                                                                  \\
  {                                                                                                      \\
    issue_stage<T::WN>(part, FC, smem + ((it + (K)) % STAGES) * T::STAGE + T::A_BYTES + wrow, (K) % 4 != 0); \\
    wgmma_wait<1>();                                                                                     \\
    if ((K) % 4 != 0) release(empty, (it + (K) - 1) % STAGES, lane);                                    \\
    if ((K) + 1 < KT) {                                                                                  \\
      stage_wait(full, it + (K) + 1);                                                                    \\
      load_frags(smem + ((it + (K) + 1) % STAGES) * T::STAGE, r0, g8, t4, FN);                           \\
    }                                                                                                    \\
    if (((K) + 1) % 4 == 0 || (K) + 1 == KT) {                                                           \\
      wgmma_wait<0>();                                                                                   \\
      fence_acc(part);                                                                                   \\
      release(empty, (it + (K)) % STAGES, lane);                                                         \\
      _Pragma("unroll") for (int i = 0; i < T::ACC; ++i) acc[i] += part[i];                              \\
    }                                                                                                    \\
  }
#pragma unroll 1
  for (int kt = 1; kt < KT; kt += 2) {
    STEP(kt, f1, f0)
    if (kt + 1 < KT) STEP(kt + 1, f0, f1)
  }
#undef STEP
  it += KT;
}"""
FOLD4 = [("""  stage_wait(full, it);
  load_frags(smem + (it % STAGES) * T::STAGE, r0, g8, t4, f0);
#pragma unroll 1
  for (int kt = 0; kt < KT; kt += 2, it += 2) {""", "#if 0\n  for (int kt = 0; kt < KT; kt += 2, it += 2) {"),
         ("""#pragma unroll
    for (int i = 0; i < T::ACC; ++i) acc[i] += part[i];
  }
}""", """#pragma unroll
    for (int i = 0; i < T::ACC; ++i) acc[i] += part[i];
  }
#endif
""" + FOLD4_LOOP)]
# variant -> (source patches, the tiles it runs at); "as built" is the port's own library
BLOCK_VARIANTS = {"as built": ([], TILES), "CL 2": (CL2, TILES), "weights ahead": (WEIGHTS_AHEAD, TILES),
                  "split at write": (SPLIT_AT_WRITE, TILES), "A not split": ([SPLIT_A], TILES),
                  "residual resident": (RESIDENT, [64]), "BN 64": (BN64, [128]),
                  "2 stages": ([RING_FIT, ("constexpr int STAGES = 4; ", "constexpr int STAGES = 2; ")], TILES),
                  "one accumulator": (BLOCK_ONE_ACC, [128]), "fold every stage": (FOLD1, TILES),
                  "fold every 4 stages": (FOLD4, TILES)}
WRONG += ("block A not split",)
# (kernel, x's shape, C, calls per batch-8 i2v fp32 forward): kernel 12 at t320 (the plan) and t640 ("off"),
# kernel 10 at t1280 ("off": the 10x16 level and the middle block's 5x8)
BLOCK_SHAPES = [("K12", (8, 16, 40, 64), 320, 5), ("K12", (8, 16, 20, 32), 640, 5),
                ("K10", (8 * 10 * 16, 16), 1280, 5), ("K10", (8 * 5 * 8, 16), 1280, 1)]


# spatial_f32.cu (kernels 11 and 13): the variants of its source, each run at the query tiles it builds
# every query tile attends over the first frame sample's keys (wrong by design): the keys and values read from
# L2 alone, what their reads from device memory cost
ONE_SAMPLE = [("        const int z = sample + lo * a.samples[seg];",
               "        const int z = (seg == S_SELF ? 0 : sample) + lo * a.samples[seg];")]
# the N-token attention's products and softmax skipped, its key tiles still waited for and handed back (wrong
# by design): what streaming them costs
NO_SELF = [("a.qkv + tok0 * 3 * C, 3 * (size_t)C, rows, hs, attends, r0,",
            "a.qkv + tok0 * 3 * C, 3 * (size_t)C, rows, hs, false, r0,")]
# the cross-attention's products and softmax skipped (wrong by design): what the cross-attention's route costs
NO_CROSS = [("attention<TM>(a, smem, full, empty, it, S_TEXT, a.nseg, bs, 4 * (size_t)C, rows, hs, attends, r0, t4, lane);",
             "attention<TM>(a, smem, full, empty, it, S_TEXT, a.nseg, bs, 4 * (size_t)C, rows, hs, false, r0, t4, lane);")]
# neither attention in the source, nor its key tiles in the ring (wrong by design): the products and passes alone
NO_ATTENTION = [("attention<TM>(a, smem", "if (false) attention<TM>(a, smem"),
                ("produce_keys<TM>(m, a, smem", "if (false) produce_keys<TM>(m, a, smem")]
# the keys' and values' hi halves alone (wrong by design): half the key tiles' bytes and TMA copies
HI_ONLY = [("    mbar_expect_tx(&full[s], 8 * KH);", "    mbar_expect_tx(&full[s], 4 * KH);"),
           ("    for (int lo = 0; lo < 2; ++lo)\n#pragma unroll\n      for (int half = 0; half < 2; ++half) {",
            "    for (int lo = 0; lo < 1; ++lo)\n#pragma unroll\n      for (int half = 0; half < 2; ++half) {")]
# P V of every key tile accumulated in O's accumulator (O rescaled in registers first), no fold
PV_ONE_ACC = [("      WgmmaTf32RegA<64>::mma(ot, pl[j], vh + 2 * j, half || j);",
               "      WgmmaTf32RegA<64>::mma(ot, pl[j], vh + 2 * j, 1);"),
              ("""          float ot[32];
          pv(ot, s, smem + sv * T::STAGE + T::A_BYTES);
#pragma unroll
          for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], ot[i]);""",
               """#pragma unroll
          for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
          pv(o, s, smem + sv * T::STAGE + T::A_BYTES);""")]
# the first version's handoffs: a barrier a stage (the K stage waited for before S = Q K^T and handed back
# after it, the V^T stage waited for before P V)
A_BARRIER_A_STAGE = [("""  for (int k0 = 0; k0 < a.len[seg]; k0 += KEYS, it += 2) {
    const int s = it % STAGES;
    const uint32_t parity = ((it / STAGES) & 1) ^ 1;
    mbar_wait(&empty[s], parity);
    mbar_wait(&empty[s + 1], parity);
    mbar_expect_tx(&full[s], 8 * KH);
    mbar_arrive(&full[s + 1]);
    uint8_t* w = smem + s * T::STAGE + T::A_BYTES;
#pragma unroll
    for (int lo = 0; lo < 2; ++lo)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int z = sample + lo * a.samples[seg];
        tma_load_3d(w + (2 * lo + half) * KH, &m.k[seg], &full[s], h * D + 32 * half, k0, z);
        tma_load_3d(w + T::STAGE + (2 * lo + half) * KH, &m.vt[seg], &full[s], k0 + 32 * half, h * D, z);
      }
  }""", """  for (int k0 = 0; k0 < a.len[seg]; k0 += KEYS) {
    for (int v = 0; v < 2; ++v, ++it) {
      const int s = it % STAGES;
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      uint8_t* w = smem + s * T::STAGE + T::A_BYTES;
      mbar_expect_tx(&full[s], 4 * KH);
#pragma unroll
      for (int lo = 0; lo < 2; ++lo)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int z = sample + lo * a.samples[seg];
          if (v == 0) tma_load_3d(w + (2 * lo + half) * KH, &m.k[seg], &full[s], h * D + 32 * half, k0, z);
          else tma_load_3d(w + (2 * lo + half) * KH, &m.vt[seg], &full[s], k0 + 32 * half, h * D, z);
        }
    }
  }"""),
                     ("""        if (active) qk(s, qh, qlo, smem + sk * T::STAGE + T::A_BYTES);
        if (active) {""", """        if (active) qk(s, qh, qlo, smem + sk * T::STAGE + T::A_BYTES);
        release(empty, sk, lane);
        if (active) {"""),
                     ("""        if (active) {
          float ot[32];""", """        stage_wait(full, it + 1);
        if (active) {
          float ot[32];"""),
                     ("""        release(empty, sk, lane);
        release(empty, sv, lane);""", """        release(empty, sv, lane);""")]
def _span(src_name, start, end):
    """The text of a source from ``start`` up to ``end``, as committed."""
    text = (cuda_lib.CSRC / src_name).read_text()
    i = text.index(start)
    return text[i:text.index(end, i)]


# Q's lo half in registers too (64 registers of Q a thread, the products a_lo.b_hi with A from registers)
Q_IN_REGISTERS = [
    (_span("spatial_f32.cu", "// A head's 64 query columns at q, split", "// ot = P V over"),
     """// The A fragments of a head's 64 query columns at q, split: rows r0, r0 + 8
// (zeros at rows >= rows), columns 8j + t, 8j + t + 4.
__device__ __forceinline__ void load_q(const float* q, size_t ld, int r0, int rows, int t, uint32_t (&qh)[8][4],
                                       uint32_t (&ql)[8][4]) {
  const float* row[2] = {r0 < rows ? q + (size_t)r0 * ld : nullptr, r0 + 8 < rows ? q + (size_t)(r0 + 8) * ld : nullptr};
  float v[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* p = row[e & 1];
      v[j][e] = p ? p[8 * j + t + 4 * (e >> 1)] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[j][e], qh[j][e], ql[j][e]);
}

// s = Q K^T over the head's 64 columns: 8 k8 steps x 3 products into an
// accumulator started at zero, K (hi: two halves of 32 columns, then lo) at kb.
__device__ __forceinline__ void qk(float (&s)[32], uint32_t (&qh)[8][4], uint32_t (&ql)[8][4], const uint8_t* kb) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int half = j >> 2, step = 2 * (j & 3);
    const uint64_t kh = smem_desc(kb + half * KH) + step, kl = smem_desc(kb + (2 + half) * KH) + step;
    WgmmaTf32RegA<64>::mma(s, ql[j], kh, j);
    WgmmaTf32RegA<64>::mma(s, qh[j], kl, 1);
    WgmmaTf32RegA<64>::mma(s, qh[j], kh, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  fence_frags(qh);
  fence_frags(ql);
}

"""),
    ("""    uint8_t* qlo = smem + T::RING + wg * 2 * KH;  // this warpgroup's Q_lo tile
    uint32_t qh[8][4];
    if (active) {  // (the last head's products that read Q_lo are done: qk waits for them)
      load_q(q + h * D, ld, r0, r0 & 63, rows, t, qh, qlo);
      fence_proxy_async();  // the wgmma reads Q_lo through the async proxy
      asm volatile("bar.sync %0, 128;\\n" ::"r"(2 + wg) : "memory");
    }
""",
     """    uint32_t qh[8][4], ql[8][4];
    if (active) load_q(q + h * D, ld, r0, rows, t, qh, ql);
"""),
    ("""        if (active) qk(s, qh, qlo, smem + sk * T::STAGE + T::A_BYTES);""",
     """        if (active) qk(s, qh, ql, smem + sk * T::STAGE + T::A_BYTES);""")]
# FA.f32's way instead of the split once a launch (TM 128 only): no split pass; each key tile's raw K lands in
# its stage's hi boxes and raw V in the next stage's token rows, three splitter warps of the producer
# warpgroup (walking the producer's schedule) split K in place with its lo beside it and write V^T split and
# permuted, then arrive on a fourth barrier a slot that the consumers wait on
SPLITTERS = [
    ("(2 * STAGES + 1) * 8", "(4 * STAGES + 1) * 8"),
    ("""    split_kv_kernel<<<dim3(lpad / KEYS, C / KEYS, samples[s]), 256, 0, st>>>(f(src[s]), ld, kc, kc + C, samples[s], L,
                                                                             lpad, C, ks, vt);
""", """    (void)ks;
    (void)vt;
"""),
    ("""    const cuuint64_t kdims[3] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)B2};
    const cuuint64_t kstrides[2] = {(cuuint64_t)C * 4, (cuuint64_t)L * C * 4};
    const cuuint64_t vdims[3] = {(cuuint64_t)lpad, (cuuint64_t)C, (cuuint64_t)B2};
    const cuuint64_t vstrides[2] = {(cuuint64_t)lpad * 4, (cuuint64_t)C * lpad * 4};
    const cuuint32_t box[3] = {32, KEYS, 1};
    if (!make_map(&m.k[s], ks, 3, kdims, kstrides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
        !make_map(&m.vt[s], vt, 3, vdims, vstrides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))""",
     """    const cuuint64_t kdims[3] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)samples[s]};
    const cuuint64_t kstrides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)L * ld * 4};
    const cuuint32_t box[3] = {32, KEYS, 1};
    (void)lpad;
    if (!make_map(&m.k[s], f(src[s]) + kc, 3, kdims, kstrides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
        !make_map(&m.vt[s], f(src[s]) + kc + C, 3, kdims, kstrides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))"""),
    ("""    mbar_expect_tx(&full[s], 8 * KH);
    mbar_arrive(&full[s + 1]);
    uint8_t* w = smem + s * T::STAGE + T::A_BYTES;
#pragma unroll
    for (int lo = 0; lo < 2; ++lo)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int z = sample + lo * a.samples[seg];
        tma_load_3d(w + (2 * lo + half) * KH, &m.k[seg], &full[s], h * D + 32 * half, k0, z);
        tma_load_3d(w + T::STAGE + (2 * lo + half) * KH, &m.vt[seg], &full[s], k0 + 32 * half, h * D, z);
      }""", """    mbar_expect_tx(&full[s], 4 * KH);
    mbar_arrive(&full[s + 1]);
    mbar_arrive(&full[3 * STAGES + 1 + s]);  // a key tile in slot s: the splitters' cue
    uint8_t* w = smem + s * T::STAGE + T::A_BYTES;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      tma_load_3d(w + half * KH, &m.k[seg], &full[s], h * D + 32 * half, k0, sample);
      tma_load_3d(smem + (s + 1) * T::STAGE + half * KH, &m.vt[seg], &full[s], h * D + 32 * half, k0, sample);
    }"""),
    ("""        stage_wait(full, it);  // the key tile's K and V^T""",
     """        mbar_wait(full + 2 * STAGES + 1 + it % STAGES, kuse[it % STAGES / 2]++ & 1);  // split by the splitters"""),
    ("int& it, int seg0, int nseg,", "int& it, int (&kuse)[2], int seg0, int nseg,"),
    ("attention<TM>(a, smem, full, empty, it, S_SELF", "attention<TM>(a, smem, full, empty, it, kuse, S_SELF"),
    ("attention<TM>(a, smem, full, empty, it, S_TEXT", "attention<TM>(a, smem, full, empty, it, kuse, S_TEXT"),
    ("  float* ss = a.reg[R_S] + slot * C;\n  int it = 0;",
     "  float* ss = a.reg[R_S] + slot * C;\n  int it = 0, kuse[2] = {0, 0};  // and the key tiles each key-tile slot held"),
    ("""      mbar_init(&empty[s], 8);  // one arrival per consumer warp""",
     """      mbar_init(&empty[s], 8);  // one arrival per consumer warp
      mbar_init(&full[2 * STAGES + 1 + s], 3);
      mbar_init(&full[3 * STAGES + 1 + s], 1);"""),
    ("""    if (threadIdx.x == CONSUMERS) produce<TM, MEGA>(maps, a, smem, full, empty, ready);""",
     """    if (threadIdx.x == CONSUMERS) produce<TM, MEGA>(maps, a, smem, full, empty, ready);
    else if (threadIdx.x >= CONSUMERS + 32) split_keys<TM, MEGA>(a, smem, full, full + 2 * STAGES + 1);"""),
    ("""  else e = mega ? launch<64, true>(m, a, slots, st) : launch<64, false>(m, a, slots, st);""",
     """  else e = cudaErrorInvalidValue;"""),
    ("""// ---- the consumers --------------------------------------------------------------""",
     """// byte offset of (row r, column c) in a [rows][32] fp32 tile in the 128-byte swizzle
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((((c >> 2) ^ (r & 7))) << 4) + ((c & 3) << 2); }

// The splitter warps: the producer's schedule, each key tile split in shared memory once it lands
template <int TM, bool MEGA>
__device__ void split_keys(const Args& a, uint8_t* smem, uint64_t* full, uint64_t* split) {
  using T = Tile<TM>;
  const int C = a.C, heads = C / D, sid = threadIdx.x - CONSUMERS - 32, lane = threadIdx.x & 31;
  uint64_t* cue = split + STAGES;  // the producer's arrival for each key tile it issues into a slot
  int it = 0, uses[STAGES] = {};  // the key tiles each slot has held: the splitters skip the products' stages
  auto keys = [&](int seg) {
    for (int k0 = 0; k0 < a.len[seg]; k0 += KEYS, it += 2) {
      const int s = it % STAGES;
      mbar_wait(&cue[s], uses[s]++ & 1);  // (the slot's phases cannot run ahead of its key tiles' splits)
      mbar_wait(&full[s], (it / STAGES) & 1);
      uint8_t* w = smem + s * T::STAGE + T::A_BYTES;  // K raw in the hi boxes; lo 2 KH further
      const uint8_t* vraw = smem + (s + 1) * T::STAGE;  // V raw in the next stage's token rows
      uint8_t* vt = w + T::STAGE;                      // V^T hi, then lo 2 KH further
      for (int i = sid; i < 2 * KH / 16; i += 96) {
        const float4 v = reinterpret_cast<const float4*>(w)[i];
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        reinterpret_cast<uint4*>(w)[i] = hi;
        reinterpret_cast<uint4*>(w + 2 * KH)[i] = lo;
      }
      for (int i = sid; i < 2 * KH / 16; i += 96) {
        const int d = i & 63, c4 = (i >> 6) & 7, kh2 = i >> 9;
        const int key0 = kh2 * 32 + 8 * (c4 >> 1) + (c4 & 1);
        const uint8_t* vcol = vraw + (d >> 5) * KH;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(*reinterpret_cast<const float*>(vcol + swz(key0 + 2 * e, d & 31)), hi[e], lo[e]);
        const int off = kh2 * KH + swz(d, 4 * c4);
        *reinterpret_cast<uint4*>(vt + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(vt + 2 * KH + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&split[s]);
    }
  };
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    for (int h = 0; h < heads; ++h) keys(S_SELF);
    for (int g = G_WO1; g <= (MEGA ? G_OUT : G_W2); ++g) {
      const int N = gemm_n(g, C), KT = gemm_k(g, C) / BK;
      it += (g == G_W1 ? N / BN : (N + BN - 1) / BN) * KT;
      if (g == G_Q2)
        for (int h = 0; h < heads; ++h)
          for (int sg = S_TEXT; sg < S_TEXT + a.nseg; ++sg) keys(sg);
    }
  }
}

// ---- the consumers --------------------------------------------------------------""")]
# every mbarrier wait a spin of mbarrier.test_wait (never suspending the thread) instead of try_wait
TEST_WAIT = [('        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"',
              '        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\\n"')]
# the attention a function of its own (its registers allocated apart from the products')
NOINLINE = [("template <int TM>\n__device__ void attention(", "template <int TM>\n__device__ __noinline__ void attention(")]
# the attention's thread indices as they come (the compiler free to hoist what it derives from them)
HOISTABLE = [("""    int r0 = r0_, t = t_, wg = threadIdx.x >> 7;
    asm volatile("" : "+r"(r0), "+r"(t), "+r"(wg));""", """    const int r0 = r0_, t = t_, wg = threadIdx.x >> 7;""")]
SPATIAL_VARIANTS = {"as built": ([], TILES), "attention not inlined": (NOINLINE, TILES), "indices hoistable": (HOISTABLE, TILES), "a barrier a stage": (A_BARRIER_A_STAGE, TILES),
                    "Q in registers": (Q_IN_REGISTERS, TILES), "P V one accumulator": (PV_ONE_ACC, [128]),
                    "test_wait": (TEST_WAIT, [128]), "splitter warps": (SPLITTERS, [128]),
                    "no attention": (NO_ATTENTION, TILES),
                    "no self-attention": (NO_SELF, [128]), "no self-attention, hi halves": (NO_SELF + HI_ONLY, [128]),
                    "no cross-attention": (NO_CROSS, [128]), "one key sample": (ONE_SAMPLE, [128])}
WRONG += tuple(f"spatial {n}" for n in ("no attention", "no self-attention", "no self-attention, hi halves",
                                         "no cross-attention", "one key sample"))
# (kernel, clips, H, W, C, calls per batch-8 i2v fp32 forward): kernels 11 (all-wrap+blk) and 13 ("off") at s320
# and s640, 16 frames a clip, i2v (77 text and 16 image keys)
SPATIAL_SHAPES = [("K11", 8, 40, 64, 320, 5), ("K11", 8, 20, 32, 640, 5), ("K13", 8, 40, 64, 320, 5),
                  ("K13", 8, 20, 32, 640, 5)]
SPATIAL_NAMES = ("ds_spatial_block_f32", "ds_mega_spatial_f32")


class _Body:
    """A library whose spatial bodies are a variant's, everything else (the
    GEMM heads, the weight split) the port's own."""

    def __init__(self, real, var):
        self.real, self.var = real, var

    def __getattr__(self, name):
        return getattr(self.var if name in SPATIAL_NAMES else self.real, name)


def _spatial_rows(libs, real, rn, report):
    """Kernels 11 and 13 at SPATIAL_SHAPES, each variant at each of its query
    tiles held against the plain version and the kernel as built at the same
    tile (``same_bits``) and timed in turns, as :func:`_block_rows`."""
    for k, clips, H, W, C, calls in SPATIAL_SHAPES:
        heads, BF, N, L, Dc = C // 64, clips * 16, H * W, 93, 1024

        def w(n_out, n_in):
            return rn(n_out, n_in, s=n_in ** -0.5)
        lns = tuple(1.0 + rn(C, s=0.1) if i % 2 == 0 else rn(C, s=0.1) for i in range(6))
        a1 = (w(C, C), w(C, C), w(C, C), w(C, C), rn(C, s=0.1))
        a2 = (w(C, C), w(C, Dc), w(C, Dc), w(C, C), rn(C, s=0.1), w(C, Dc), w(C, Dc))
        ff = (w(8 * C, C), rn(8 * C, s=0.1), w(C, 4 * C), rn(C, s=0.1))
        ctx = rn(clips, L, Dc)
        if k == "K13":
            x = rn(BF, H, W, C)
            mul, add = 1.0 + rn(BF, C, s=0.1), rn(BF, C, s=0.1)
            wi, bi, wo, bo = w(C, C), rn(C, s=0.1), w(C, C), rn(C, s=0.1)
            op = fused_mega.pack_spatial_mega(wi, bi, lns, a1, a2, ff, wo, bo, dtype=torch.float32)

            def run(plan):
                return fused_mega.spatial_mega(x, ctx, mul, add, wi, bi, lns, a1, a2, ff, wo, bo, heads=heads,
                                               scale=0.125, operands=op, plan=plan)
        else:
            x = rn(BF, N, C)
            op = fused_block.pack_spatial_block(lns, a1, a2, ff, dtype=torch.float32)

            def run(plan):
                return fused_block.fused_spatial_block(x, ctx, lns, a1, a2, ff, heads=heads, scale=0.125,
                                                       operands=op, plan=plan)
        # the body's products and both attentions' (the heads not counted)
        flops = 2 * BF * N * (15 + (k == "K13")) * C * C + 4 * BF * N * (N + L) * C
        cuda_lib._lib = real
        with cuda_lib.plain_kernels():
            ref = run(None)
        chosen = cuda_lib.spatial_f32_plan(C, N, BF)
        run(chosen)  # the weights split once, by the real library
        names = [f"{n} TM {tm}" for n, (_, tiles) in SPATIAL_VARIANTS.items() for tm in tiles]

        def call(key):
            n, tm = key.rsplit(" TM ", 1)
            cuda_lib._lib = _Body(real, libs[f"spatial {n}"]) if n != "as built" else real
            return run(cuda_lib.BlockF32Plan(int(tm)))
        errs, built = {}, {}
        for key in names:
            got = call(key)
            tile = key.split(" TM ", 1)[1]
            if key.startswith("as built "):
                built[tile] = got
            errs[key] = {"vs_plain": float((got - ref).abs().max() / ref.abs().max()),
                         "l2": float((got - ref).norm() / (ref - x).norm()),
                         "same_bits": bool(torch.equal(got, built[tile]))}
        del built
        ms = _turns(names, lambda key: _time_ms(lambda: call(key)))
        cuda_lib._lib = real
        bound = flops / (494.7e12 / 3) * 1e3
        report["spatial"].append({"kernel": k, "x": list(x.shape), "calls": calls, "bound_ms": bound, "ms": ms,
                                  "err": errs, "plan": chosen._asdict(),
                                  "grid": {tm: cuda_lib.spatial_f32_grid(cuda_lib.BlockF32Plan(tm), BF, N)
                                           for tm in TILES}})
        print(f"{k} x{list(x.shape)} x{calls} (3xTF32 bound {bound:.3f} ms; plan TM {chosen.tm}): "
              + "; ".join(f"{key} {ms[key]:.3f} ms ({100 * bound / ms[key]:.0f}%, err {errs[key]['vs_plain']:.1e}, "
                          f"L2 {errs[key]['l2']:.1e}{', same bits as built' if errs[key]['same_bits'] else ''}"
                          + (", wrong by design" if f"spatial {key.split(' TM ')[0]}" in WRONG else "") + ")"
                          for key in names), flush=True)
        for key in names:
            if key.startswith("as built ") and (errs[key]["vs_plain"] > TOL_F32 or errs[key]["l2"] > TOL_F32):
                _fail(f"{k} {key} misses the fp32 gate at {list(x.shape)}")
        del x, op, ref
        torch.cuda.empty_cache()


# kernel 9 at fp32 (csrc/gn_silu.cu, ds_group_norm_silu): the apply's order on
# the grid route where a sample's rows do not all fit the card's shared
# memory, and the fp32 SiLU's arithmetic
REREAD = """      for (int r = ns + rl; r < n; r += step) {
        Chunk<T> v[CLUSTER_UNROLL];
#pragma unroll
        for (int j = 0; j < CLUSTER_UNROLL; ++j)
          if (r + j * rm.lanes < n) v[j] = L::ldcs(xs + (size_t)(r + j * rm.lanes) * C, u, C);
#pragma unroll
        for (int j = 0; j < CLUSTER_UNROLL; ++j)
          if (r + j * rm.lanes < n) L::stcs(ys + (size_t)(r + j * rm.lanes) * C, u, C, apply8<ACT>(v[j], m, a));
      }
"""
SLAB_OUT = """#pragma unroll 4
      for (int r = rl; r < ns; r += rm.lanes)
        L::stcs(ys + (size_t)r * C, u, C, apply8<ACT>(L::ld(slab + (size_t)r * C, u, C), m, a));
"""
REREAD_LAST = [(REREAD + SLAB_OUT, SLAB_OUT + REREAD)]  # the slab written out first, then the rows read again
SILU_F32 = "float silu_f32(float h) { return __fdividef(h, 1.0f + __expf(-h)); }"
ACCURATE_SILU = [(SILU_F32, "float silu_f32(float h) { return h / (1.0f + expf(-h)); }")]
SILU_RCP = [(SILU_F32, "float silu_f32(float h) { return h * __frcp_rn(1.0f + __expf(-h)); }")]
GN_VARIANTS = {"as built": ([], None), "plain re-read order": (REREAD_LAST, None),
               "expf, division": (ACCURATE_SILU, None), "__expf, __frcp_rn": (SILU_RCP, None)}
# (B, M, C, eps, SiLU): the batch-8 i2v fp32 forward's largest calls on each
# route (the temporal-conv norm of 52 MB a sample, whose rows past the
# slabs the apply reads again) and the VAE's largest frame
GN_SHAPES = [(8, 40960, 320, 1e-5, True), (8, 10240, 640, 1e-5, True), (128, 2560, 320, 1e-5, True),
             (128, 2560, 960, 1e-5, True), (128, 640, 640, 1e-5, True), (1, 589824, 128, 1e-6, True),
             (1, 147456, 512, 1e-6, True), (1, 3072, 512, 1e-6, False)]
# K1's attention at fp32 (csrc/attention_f32.cu, ds_temporal_attention_f32):
# the ring's depth, at the tile of 64 tokens where three slots fit
TA_TOK64 = [("constexpr int TA_TOK = 128; ", "constexpr int TA_TOK = 64; ")]
TA_3 = [("constexpr int TA_STAGES = 2; ", "constexpr int TA_STAGES = 3; ")]
TA_VARIANTS = {"as built": ([], None), "2 slots of 64 tokens": (TA_TOK64, None),
               "3 slots of 64 tokens": (TA_TOK64 + TA_3, None)}
# (rows, F, C): the batch-8 i2v fp32 forward's K1 calls (t640, t1280 at 10x16
# and 5x8) and the 40x64 level's t320; t640's tokens at F 8 (the tensor-core
# body with the other row's keys masked) and at F 32 (the CUDA-core body)
TA_SHAPES = [(5120, 16, 640), (1280, 16, 1280), (320, 16, 1280), (20480, 16, 320), (10240, 8, 640), (2560, 32, 640)]


# the grid route's phases, timed: %globaltimer stamps by thread 0 of blocks
# 0, 1, 64 and the last into a __device__ array read back by an extra entry
# point (a build of gn_silu.cu with these patches)
GN_STAMP = """
__device__ unsigned long long g_stamp[4][64][8];
__device__ __forceinline__ void stamp(int p, int k) {
  const int b = blockIdx.x == 0 ? 0 : blockIdx.x == 1 ? 1 : blockIdx.x == 64 ? 2 : blockIdx.x == gridDim.x - 1 ? 3 : -1;
  if (b < 0 || threadIdx.x != 0 || p >= 64) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_stamp[b][p][k] = t;
}
"""
GN_PHASES = [("// Rows [r_begin, r_end) of x (from row0,", GN_STAMP + "\n// Rows [r_begin, r_end) of x (from row0,"),
             ("  for (int p = 0; p < passes; ++p) {\n", "  for (int p = 0; p < passes; ++p) {\n    stamp(p, 0);\n"),
             ("      // 2. per channel, the row lanes in order; 3.",
              "      __syncthreads();\n      stamp(p, 1);\n      // 2. per channel, the row lanes in order; 3."),
             ("    grid_sync(counter, (p + 1) * (int)gridDim.x);\n",
              "    stamp(p, 2);\n    grid_sync(counter, (p + 1) * (int)gridDim.x);\n    stamp(p, 3);\n"),
             ("      // 5. apply: first the streamed rows", "      stamp(p, 4);\n      // 5. apply: first the streamed rows"),
             ("    __syncthreads();  // the slab and the vectors are free for the next pass\n",
              "    __syncthreads();  // the slab and the vectors are free for the next pass\n    stamp(p, 5);\n"),
             ('extern "C" int ds_gn_clusters(', 'extern "C" int ds_gn_stamps(void* out) {\n  return (int)cudaMemcpyFromSymbol(out, '
              'g_stamp, sizeof(g_stamp));\n}\n\nextern "C" int ds_gn_clusters(')]
GN_PHASE_NAMES = ("load and sums", "reductions and partials", "grid barrier", "partials gathered and folded", "apply")
GN_PHASE_SHAPES = [(128, 2560, 320), (8, 40960, 320), (128, 2560, 960), (8, 10240, 640), (128, 640, 1280)]


def _gn_phase_rows(lib, real, rn, report):
    """The grid route (forced) at GN_PHASE_SHAPES, one launch after three
    warm ones, its phases per pass from the stamps of four blocks (mean
    over the passes, us)."""
    from dynamicscaler_tpu_torch.ops import fused_twrap
    lib.ds_gn_stamps.argtypes = [ctypes.c_void_p]
    lib.ds_gn_stamps.restype = ctypes.c_int
    for B, M, C in GN_PHASE_SHAPES:
        x, s, b = rn(B, M, C), 1.0 + rn(C, s=0.1), rn(C, s=0.1)
        plan = cuda_lib.gn_plan(B, M, C, 32, 4, cuda_lib.sm_count(x.device), "grid")
        cuda_lib._lib = lib
        for _ in range(4):
            fused_twrap.gn_silu(x, s, b, plan=plan)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (4 * 64 * 8))()
        lib.ds_gn_stamps(ctypes.cast(buf, ctypes.c_void_p))
        cuda_lib._lib = real
        st = torch.tensor(list(buf), dtype=torch.float64).reshape(4, 64, 8)
        passes = min(64, -(-B // plan.splits))
        blocks = {}
        for i, name in enumerate(("0", "1", "64", "last")):
            rows = st[i, :passes]
            blocks[name] = [float((rows[:, k + 1] - rows[:, k]).mean()) / 1e3 for k in range(5)]
        report["gn_phases"].append({"x": [B, M, C], "plan": plan._asdict(), "passes": passes, "us_per_pass": blocks})
        print(f"gn phases x[{B}, {M}, {C}] grid ({passes} passes of {plan.splits} samples, {plan.cs} blocks each), "
              f"us a pass in blocks 0 / 1 / 64 / last: " + "; ".join(
                  f"{n} " + " / ".join(f"{blocks[bk][k]:.2f}" for bk in blocks) for k, n in enumerate(GN_PHASE_NAMES)),
              flush=True)
        del x


def _gn_rows(libs, real, rn, report):
    """Kernel 9 at fp32 at GN_SHAPES on the route ``gn_plan`` takes, each
    variant held against the plain version (max error against max|plain|,
    L2; ``same_bits`` as built) and timed in turns."""
    from dynamicscaler_tpu_torch.ops import fused_twrap
    for B, M, C, eps, act in GN_SHAPES:
        x, s, b = rn(B, M, C, s=2.0) + 0.5, 1.0 + rn(C, s=0.1), rn(C, s=0.1)
        plan = cuda_lib.gn_plan(B, M, C, 32, 4, cuda_lib.sm_count(x.device))
        mul, add = fused_twrap.group_norm_fold_plain(x, s, b, 32, eps)
        ref = fused_twrap.gn_silu_plain(x, mul, add, act=act)
        names = list(GN_VARIANTS)

        def call(n):
            cuda_lib._lib = libs[f"gn {n}"]
            return fused_twrap.gn_silu(x, s, b, eps=eps, act=act, plan=plan)
        errs, built = {}, call("as built")
        for n in names:
            got = call(n)
            errs[n] = {"vs_plain": float((got - ref).abs().max() / ref.abs().max()),
                       "l2": float((got - ref).norm() / ref.norm()), "same_bits": bool(torch.equal(got, built))}
        ms = _turns(names, lambda n: _time_ms(lambda: call(n)))
        cuda_lib._lib = real
        bound = 2 * x.numel() * 4 / 3.35e12 * 1e3
        report["gn"].append({"x": [B, M, C], "eps": eps, "act": act, "plan": plan._asdict(), "bound_ms": bound,
                             "ms": ms, "err": errs})
        print(f"gn x[{B}, {M}, {C}] {plan.route} (bound {bound:.4f} ms): " + "; ".join(
            f"{n} {ms[n]:.4f} ms ({100 * bound / ms[n]:.0f}%, err {errs[n]['vs_plain']:.1e}, L2 {errs[n]['l2']:.1e}"
            f"{', same bits as built' if errs[n]['same_bits'] else ''})" for n in names), flush=True)
        for n in names:
            if errs[n]["vs_plain"] > TOL_F32 or errs[n]["l2"] > TOL_F32:
                print(f"gn x[{B}, {M}, {C}]: {n} misses the fp32 gate", flush=True)
        if errs["as built"]["vs_plain"] > TOL_F32 or errs["as built"]["l2"] > TOL_F32:
            _fail(f"ds_group_norm_silu as built misses the fp32 gate at {[B, M, C]}")
        del x, ref, built


def _ta_rows(libs, real, rn, report):
    """K1's attention at fp32 at TA_SHAPES, each variant held against the
    plain version and timed in turns."""
    from dynamicscaler_tpu_torch.ops import fused_temporal
    for R, Fn, C in TA_SHAPES:
        heads = C // 64
        qkv = rn(R, Fn, 3 * C)
        with cuda_lib.plain_kernels():
            ref = fused_temporal.temporal_attention(qkv, heads=heads, scale=0.125)
        names = list(TA_VARIANTS)

        def call(n):
            cuda_lib._lib = libs[f"ta {n}"]
            return fused_temporal.temporal_attention(qkv, heads=heads, scale=0.125)
        errs, built = {}, call("as built")
        for n in names:
            got = call(n)
            errs[n] = {"vs_plain": float((got - ref).abs().max() / ref.abs().max()),
                       "l2": float((got - ref).norm() / ref.norm()), "same_bits": bool(torch.equal(got, built))}
        ms = _turns(names, lambda n: _time_ms(lambda: call(n)))
        cuda_lib._lib = real
        bound = (qkv.numel() + ref.numel()) * 4 / 3.35e12 * 1e3
        report["ta"].append({"qkv": [R, Fn, 3 * C], "bound_ms": bound, "ms": ms, "err": errs})
        print(f"ta qkv[{R}, {Fn}, {3 * C}] (bound {bound:.4f} ms): " + "; ".join(
            f"{n} {ms[n]:.4f} ms ({100 * bound / ms[n]:.0f}%, err {errs[n]['vs_plain']:.1e}"
            f"{', same bits as built' if errs[n]['same_bits'] else ''})" for n in names), flush=True)
        if errs["as built"]["vs_plain"] > TOL_F32 or errs["as built"]["l2"] > TOL_F32:
            _fail(f"ds_temporal_attention_f32 as built misses the fp32 gate at {[R, Fn, C]}")
        del qkv, ref, built


def _fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _variant_sources(src_name, variants):
    """variant -> ({file: text} of the source as k.cu and tc_f32.cuh, each
    patch applied where its text is, hopper.cuh's text)."""
    src = (cuda_lib.CSRC / src_name).read_text()
    out = {}
    for name, (patches, rna) in variants.items():
        files = {"k.cu": src, "tc_f32.cuh": SHARED, "hopper.cuh": HOPPER.replace(_rna_body(HOPPER), rna) if rna else HOPPER}
        for old, new in patches:
            where = [f for f, text in files.items() if old in text]
            if not where:
                _fail(f"{src_name} variant {name!r}: the source no longer has {old[:60]!r}")
            files[where[0]] = files[where[0]].replace(old, new)
        out[name] = (files,)
    return out


def _build_all(jobs):
    """jobs: {key: ({file: text}, entry point)} -> loaded libraries, nvcc all at once."""
    procs = {}
    for key, (files, _) in jobs.items():
        d = OUT / key.replace(" ", "_").replace(",", "").replace(".", "_")
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        procs[key] = (d, subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-I",
                                           str(d), "-o", str(d / "k.so"), str(d / "k.cu")],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (d, p) in procs.items():
        out, err = p.communicate()
        if p.returncode:
            _fail(f"variant {key} does not build:\n{out}\n{err[-3000:]}")
        # ptxas: registers and spill bytes of each whole-block kernel
        spills = re.findall(r"entry function '\w*?(spatial|temporal)_tc_f32_kernelILi(\d+)ELb(\d)[^\n]*\n(?:[^\n]*"
                            r"Function properties[^\n]*\n)?\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", out + err)
        if spills:
            print(f"variant {key}: ptxas spill stores / loads (bytes): " + ", ".join(
                f"{n} TM {tm}{' mega' if m == '1' else ''} {st} / {ld}" for n, tm, m, _, st, ld in spills), flush=True)
        lib = ctypes.CDLL(str(d / "k.so"))
        names = jobs[key][1]
        for name in (names,) if isinstance(names, str) else names:
            fn = getattr(lib, name)
            fn.argtypes = list(cuda_lib._SIGNATURES[name])
            fn.restype = ctypes.c_int
        libs[key] = lib
    return libs


def _time_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _turns(names, run):
    """Each variant timed twice: in order, then in reverse order."""
    ms = {n: [] for n in names}
    for n in list(names) + list(reversed(names)):
        ms[n].append(run(n))
    return {n: sum(v) / len(v) for n, v in ms.items()}


def _block_rows(libs, real, rn, report):
    """Kernels 10 and 12 at BLOCK_SHAPES, each variant at each of its tiles
    (TM, CL) held against the plain version (max error against max|plain|,
    L2 against the block's own output; ``same_bits``: equal to the kernel as
    built at the same tile) and timed in turns."""
    for k, shape, C, calls in BLOCK_SHAPES:
        heads = C // 64

        def w(n_out, n_in):
            return rn(n_out, n_in, s=n_in ** -0.5)
        lns = tuple(1.0 + rn(C, s=0.1) if i % 2 == 0 else rn(C, s=0.1) for i in range(6))
        a1, a2 = ((w(C, C), w(C, C), w(C, C), w(C, C), rn(C, s=0.1)) for _ in range(2))
        ff = (w(8 * C, C), rn(8 * C, s=0.1), w(C, 4 * C), rn(C, s=0.1))
        if k == "K12":
            B, F, H, W = shape
            x = rn(B, F, H, W, C)
            mul, add = 1.0 + rn(B, C, s=0.1), rn(B, C, s=0.1)
            wi, bi, wo, bo = w(C, C), rn(C, s=0.1), w(C, C), rn(C, s=0.1)
            op = fused_mega.pack_temporal_mega(wi, bi, lns, a1, a2, ff, wo, bo, dtype=torch.float32)

            def run(plan):
                return fused_mega.temporal_mega(x, mul, add, wi, bi, lns, a1, a2, ff, wo, bo, heads=heads, scale=0.125,
                                                operands=op, plan=plan)
            flops = 2 * x.numel() * 22 * C
        else:
            R, F = shape
            x = rn(R, F, C)
            op = fused_block.pack_temporal_block(lns, a1, a2, ff, dtype=torch.float32)

            def run(plan):
                return fused_block.fused_temporal_block(x, lns, a1, a2, ff, heads=heads, scale=0.125, operands=op,
                                                        plan=plan)
            flops = 2 * x.numel() * 20 * C
        T = x.numel() // C
        cuda_lib._lib = real
        with cuda_lib.plain_kernels():
            ref = run(None)
        chosen = cuda_lib.block_f32_plan(C, F, T, k == "K12")
        run(chosen)  # the weights split once, by the real library
        names = [f"{n} TM {tm}" for n, (_, tiles) in BLOCK_VARIANTS.items() for tm in tiles]

        def call(key):
            n, tm = key.rsplit(" TM ", 1)
            cuda_lib._lib = libs.get(f"block {n}", real)
            return run(cuda_lib.BlockF32Plan(int(tm)))
        errs, built = {}, {}
        for key in names:
            got = call(key)
            tile = key.split(" TM ", 1)[1]
            if key.startswith("as built "):
                built[tile] = got
            errs[key] = {"vs_plain": float((got - ref).abs().max() / ref.abs().max()),
                         "l2": float((got - ref).norm() / (ref - x).norm()),
                         "same_bits": bool(torch.equal(got, built[tile]))}
        del built
        ms = _turns(names, lambda key: _time_ms(lambda: call(key)))
        cuda_lib._lib = real
        bound = flops / (494.7e12 / 3) * 1e3
        report["block"].append({"kernel": k, "x": list(x.shape), "calls": calls, "bound_ms": bound, "ms": ms,
                                "err": errs, "plan": chosen._asdict(),
                                "grid": {tm: cuda_lib.block_f32_grid(cuda_lib.BlockF32Plan(tm), T) for tm in TILES}})
        print(f"{k} x{list(x.shape)} x{calls} (3xTF32 bound {bound:.3f} ms; plan TM {chosen.tm}): "
              + "; ".join(f"{key} {ms[key]:.3f} ms ({100 * bound / ms[key]:.0f}%, err {errs[key]['vs_plain']:.1e}, "
                          f"L2 {errs[key]['l2']:.1e}{', same bits as built' if errs[key]['same_bits'] else ''}"
                          + (", wrong by design" if f"block {key.split(' TM ')[0]}" in WRONG else "") + ")"
                          for key in names), flush=True)
        for key in names:
            if key.startswith("as built ") and (errs[key]["vs_plain"] > TOL_F32 or errs[key]["l2"] > TOL_F32):
                _fail(f"{k} {key} misses the fp32 gate at {list(x.shape)}")
        del x, op, ref


def _errors(got, ref, ref64):
    top = float(ref.abs().max())
    err = {"vs_plain": float((got - ref).abs().max()) / top}
    if ref64 is not None:
        err["vs_fp64"] = float((got.double() - ref64).abs().max() / ref64.abs().max())
    return err


def main():
    if not torch.cuda.is_available():
        _fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    only = set(sys.argv[1:]) or {"gemm", "flash", "block", "gn", "ta"}
    if "block" in only:  # kernels 10 and 12, and 11 and 13
        only |= {"temporal", "spatial"}
    jobs = {}
    if "gemm" in only:
        jobs.update({f"gemm {n}": (*v, "ds_ln_gemm_f32")
                     for n, v in _variant_sources("gemm_f32.cu", GEMM_VARIANTS).items()})
    if "flash" in only:
        jobs.update({f"flash {n}": (*v, "ds_flash_attention_f32")
                     for n, v in _variant_sources("attention_f32.cu", FLASH_VARIANTS).items()})
    if "temporal" in only:
        patched = {n: (patches, None) for n, (patches, _) in BLOCK_VARIANTS.items() if patches}
        jobs.update({f"block {n}": (*v, ("ds_temporal_block_f32", "ds_temporal_mega_f32"))
                     for n, v in _variant_sources("temporal_f32.cu", patched).items()})
    if "spatial" in only:
        patched = {n: (patches, None) for n, (patches, _) in SPATIAL_VARIANTS.items() if patches}
        jobs.update({f"spatial {n}": (*v, SPATIAL_NAMES) for n, v in _variant_sources("spatial_f32.cu", patched).items()})
    if "gn" in only:
        jobs.update({f"gn {n}": (*v, "ds_group_norm_silu") for n, v in _variant_sources("gn_silu.cu", GN_VARIANTS).items()})
        jobs["gn phases"] = (*_variant_sources("gn_silu.cu", {"phases": (GN_PHASES, None)})["phases"], "ds_group_norm_silu")
    if "ta" in only:
        jobs.update({f"ta {n}": (*v, "ds_temporal_attention_f32")
                     for n, v in _variant_sources("attention_f32.cu", TA_VARIANTS).items()})
    cuda_lib.library()
    libs = _build_all(jobs)
    real = cuda_lib._lib
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    report = {"device": smi, "gemm": [], "flash": [], "block": [], "spatial": [], "gn": [], "gn_phases": [], "ta": []}
    if "gn" in only:
        _gn_rows(libs, real, rn, report)
        _gn_phase_rows(libs["gn phases"], real, rn, report)
    if "ta" in only:
        _ta_rows(libs, real, rn, report)
    if "temporal" in only:
        _block_rows(libs, real, rn, report)
    if "spatial" in only:
        _spatial_rows(libs, real, rn, report)
    for M, K, N, mode, ln, calls in GEMM_SHAPES if "gemm" in only else ():
        x, w = rn(M, K), rn(N, K, s=K ** -0.5)
        kw = dict(mode=mode, bias=rn(N, s=0.1))
        if ln:
            kw["ln"] = (1.0 + rn(K, s=0.1), rn(K, s=0.1))
        if mode == cuda_lib.MODE_RESIDUAL:
            kw["residual"] = rn(M, N)
        ref = cuda_lib.ln_gemm_plain(x, w, **kw)
        ref64 = None
        if not ln and mode != cuda_lib.MODE_GEGLU:
            ref64 = x.double() @ w.double().t() + kw["bias"].double()
            if mode == cuda_lib.MODE_RESIDUAL:
                ref64 += kw["residual"].double()
        names = list(GEMM_VARIANTS)

        def call(n):
            cuda_lib._lib = libs[f"gemm {n}"]
            if n not in RAW_W:
                return cuda_lib.ln_gemm(x, w, **kw)
            # ln_gemm's call with the raw weights
            y = torch.empty((M, N // 2 if mode == cuda_lib.MODE_GEGLU else N), device="cuda")
            scratch = torch.empty_like(x) if ln else None
            tile = cuda_lib.gemm_f32_tile(M, K, N, mode)
            p, lnw = cuda_lib.ptr, kw.get("ln") or (None, None)
            cuda_lib.call("ds_ln_gemm_f32", p(x), M, K, p(lnw[0]), p(lnw[1]), 1e-5, None, None, 0, 0, 0, p(w), N,
                          p(kw["bias"]), p(kw.get("residual")), p(y), mode, p(scratch), tile.block_n, tile.stages)
            return y
        errs = {}
        for n in names:
            errs[n] = _errors(call(n), ref, ref64)
        ms = _turns(names, lambda n: _time_ms(lambda: call(n)))
        cuda_lib._lib = real
        lib_ms = _time_ms(lambda: F.linear(x, w))
        row = {"M": M, "K": K, "N": N, "mode": mode, "ln": ln, "calls": calls, "F.linear_ms": lib_ms,
               "ms": ms, "err": errs}
        report["gemm"].append(row)
        print(f"gemm M={M} K={K} N={N} mode {mode}{' LN' if ln else ''} x{calls}: F.linear {lib_ms:.3f} ms; "
              + "; ".join(f"{n} {ms[n]:.3f} ms (err {errs[n]['vs_plain']:.1e}"
                          + (f", vs fp64 {errs[n]['vs_fp64']:.1e}" if "vs_fp64" in errs[n] else "")
                          + (", wrong by design" if n in WRONG else "") + ")" for n in names), flush=True)
        if errs["as built"]["vs_plain"] > TOL_F32:
            _fail(f"ds_ln_gemm_f32 as built misses the fp32 gate at M={M} K={K} N={N}")
        del x, w, kw, ref, ref64
    for B, Nq, lens in FLASH_SHAPES if "flash" in only else ():
        C, heads = 320, 5
        q = rn(B, Nq, 3 * C)[..., :C]
        segs = []
        for L in lens:
            kv = rn(B, L, 2 * C)
            segs += [kv[..., :C], kv[..., C:]]
        with cuda_lib.plain_kernels():
            ref = fused_spatial.flash_attention(q, *segs, heads=heads, scale=0.125)
        names = list(FLASH_VARIANTS)

        def fcall(n):
            cuda_lib._lib = libs[f"flash {n}"]
            return fused_spatial.flash_attention(q, *segs, heads=heads, scale=0.125)
        errs = {n: _errors(fcall(n), ref, None) for n in names}
        ms = _turns(names, lambda n: _time_ms(lambda: fcall(n)))
        cuda_lib._lib = real
        report["flash"].append({"B": B, "Nq": Nq, "keys": list(lens), "ms": ms, "err": errs})
        print(f"flash B={B} Nq={Nq} keys {'+'.join(map(str, lens))}: "
              + "; ".join(f"{n} {ms[n]:.3f} ms (err {errs[n]['vs_plain']:.1e}"
                          + (", wrong by design" if n in WRONG else "") + ")" for n in names), flush=True)
        if errs["as built"]["vs_plain"] > TOL_F32:
            _fail(f"ds_flash_attention_f32 as built misses the fp32 gate at B={B} Nq={Nq} keys {lens}")
        del q, segs, ref
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
