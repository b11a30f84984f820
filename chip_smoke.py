"""On-card smoke run of the PyTorch port (``dynamicscaler_tpu_torch``).

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases, in order, one result line each (any failure exits non-zero):

1. card and build: ``nvidia-smi`` name and power limit; build the CUDA
   kernels of ``dynamicscaler_tpu_torch/csrc`` (nvcc, sm_90a); the clusters
   of each size ``ds_group_norm_silu``'s plan can give that the card holds
   at once (at least one of each).
2. the models' forwards, each through the kernels and through the plain
   versions (seeded random bf16 weights, zero-initialised layers perturbed):
   one full-width VideoCrafter2 t2v UNet forward at window batch 2 (one CFG
   pair, 16 frames, 40x64 latent); full-width i2v UNet forwards at the UNet
   batch 8 of phases 5 and 6 under the port's dispatch plan (these two with
   a device-time profile by kernel class), under "off" (the highest legal level
   everywhere: kernel 12 at the temporal transformers of C 320 / 640,
   kernel 10 at init_attn and C 1280, kernel 13 at the spatial ones of C
   320 / 640) and under the all-wrap+blk plan (kernel 10 at all 17 temporal
   blocks, kernel 11 at the 10 spatial blocks of C 320 / 640); the tiled
   VAE encode of phase 5's panorama and the ring decode of one of its latent
   frames; batch-2 i2v forwards at a 40x40 latent (a 320x320 window) and at
   8 frames. Relative error, times and exact launch counts (derived from the
   plan, the UNet layout and the kernels' gates by ``expected_launches``).
   Every kernel call of the kernel-path runs is recorded with its input
   shapes.
3. each kernel against its plain PyTorch version, bf16, at every shape that
   phase 2 recorded: K1-K4 (K3 in its t2v and i2v variants), the
   transformer wrapper heads and tails K5-K8, ``gn_silu`` K9 (UNet and VAE:
   GroupNorm + SiLU in one call, ``ds_group_norm_silu``, against the plain
   fold then the plain apply, bit for bit against a rerun; with its route,
   cluster size and clusters at once, its folded statistics against the
   plain fold, and the apply kernel alone, ``gn_silu_apply``, against the
   plain apply; times against the route's bound and the apply's), the whole
   blocks K10 and K11 and the whole transformers K12 and K13, the
   device kernels inside K1 (TA, ``ds_temporal_attention``) and K2 / K3
   (FA, ``ds_flash_attention``, against one SDPA call a key segment), and
   the GroupNorm statistics (GN, ``ds_gn_stats``, whose vectors K5, K7, K12
   and K13 read, and which K9's split route launches inside its call;
   against the plain fold and bit for bit against a second
   run, beside ``torch.var_mean``); and at the shapes no forward of phase 2
   gives (:func:`_repair_cases`: clip geometries of the earlier repairs, and
   K11 and K13 at the 40x40 latent's levels, t2v, 8 frames a clip and N 256
   and 4096); and the statistics where the fast variance is inf - inf
   (:func:`_nan_statistics`: K9 on every route, GN and ``ds_ln_gemm``'s
   LayerNorm prologue, bf16 and fp32, NaN where the plain version is). Per
   shape: max abs error against the stated tolerance, L2 error, and the
   kernel, plain and library-composite times (CUDA events) beside the bound
   (the least time the H100 could take for the kernel's work); the
   statistics pass is also timed at each K5, K7, K12, K13 site; K10 and
   K12 also with their tile plan (TM, CL, ring stages, head group, hidden
   chunk, shared memory), the clusters of it the card holds at once
   (``cudaOccupancyMaxActiveClusters``), their TFLOP/s and share of 989,
   and the weight bytes a launch reads from L2, once per cluster, against
   once per block (the design before clusters); K11 and K13 with their tile
   plan (TM, ring stages, hidden chunk, shared memory), grid, TFLOP/s and
   share of 989. Then the GEMM
   table: every distinct ``ds_ln_gemm`` call of the batch-8 i2v forward
   (M, K, N, prologue, epilogue mode, row map, calls per forward) against
   ``cuda_lib.ln_gemm_plain`` under the same gates, with its time, TFLOP/s
   and share of the 989 TFLOP/s peak, bound and ``F.linear`` on the same bf16
   operands (a yardstick; the port never calls it), the parent's pick (the
   planner's table before the 160-column widths) timed beside the
   planner's, every (schedule, BN) held to cooperative BN 128 bit for bit,
   and the forward's launches by (schedule, BN). Then the
   transformer module at every legal level (mega, wrap+blk, wrap+sub) at
   every (side, width) of the batch-8 i2v forward, the fold included, and
   one line saying whether ``PLAN_DEFAULT`` still names each shape's fastest
   level (naming any shape where another level was faster by more than 5%).
4. the t2v path: after a one-step warm-up request, two prompts through
   ``pipelines.t2v.sample_shift_multi_windows`` (2 windows of 320x512, a
   320x1024x16 panorama, 4 DDIM steps, CFG 7.5, frame-chunked VAE decode);
   the launch counters are zeroed just before and read just after.
5. the i2v path (stage 2 of gen_pano_360): the full-width i2v bundle (CLIP
   ViT-H vision, Resampler) through ``pipelines.i2v.sample_shift_multi_windows``
   on a smooth seeded 512x1024 panorama, 2x2 windows of 320x512, 16 frames,
   CFG 7.5, UNet batch 8, skip-time init from the tiled VAE encode, the last
   4 steps of the 48-step table, ring-aware decode; a one-step warm-up
   request, then one timed request under the dispatch plan and one under
   "off", the counters zeroed before and read after each.
6. stage 1 of gen_pano_360, the sphere sampler, at the CLI's geometry: the
   full-width i2v bundle on a smooth seeded 2048x1024 equirect panorama
   (latent 128x256, 16 frames), the CLI's 44-view grid with its per-phi
   prompts, FOV 120, 10 theta phases, ``last`` overlap, paste-on-static,
   the CLI's frame-overlap and merge-prev schedules, UNet batch 88 per step
   as 11 forwards of 8; steps cut to 2 of the 48-step table (step 0 the
   warm-up, step 1 timed), counters zeroed before and read after.
7. the CLI, ``cli/gen_pano_360.py``: ``main(VArgs.from_args(argv))`` on the
   phase-2 i2v bundle, all three stages at the CLI's defaults but for the
   steps (6-step table, 3 steps a stage): stage 1 at 2048x1024 (44 views,
   10 phases), stage 2 on 2x2 and stage 3 on 4x4 windows of 320x512, 16
   frames, CFG 7.5, UNet batch 8; the panorama phase 5's as a PNG,
   outputs in a temporary directory removed afterwards. The
   three latents finite at their shapes, both videos written through
   whichever writer the machine allows, ``args.json`` and ``e2e.json``,
   each stage's wall seconds and steady s/step, exact launch counts (48
   UNet forwards of batch 8 at ``expected_launches`` each, plus K9 and the
   statistics of the VAE encode and decodes as recorded); K9 and the
   statistics at every VAE shape of the run that phase 3 did not hold
   (stage 1's 2048x1024 tiles, the 1024x2048 ring decode), each against
   its plain version with phase 3's gates; stage 2 again from the stage-1
   latent the run wrote, equal to the run's bit for bit;
   the ``--dev_full_random`` bundle (every bf16 parameter 0.01 on the card,
   the random bundle's parameter count).
8. the single-clip CLI, ``cli/sample.py``, on a full-width VideoCrafter2
   t2v bundle built again (seeded random bf16 weights, zero-initialised
   layers perturbed): first three new UNet forwards at batch 2 through
   the kernels and through the plain versions, with exact launch counts
   (``expected_launches``, its FreeTraj variant for the trajectory
   forwards): one FIFO iteration's (the staggered per-frame timesteps
   [2, 16]) and one FreeTraj forward at an active and one at an inactive
   step. Then ``main(parse_args(argv))`` in its four modes at 320x512, 16
   frames, CFG 12, the steps cut: ``t2v`` and ``freetraj`` (two boxes,
   spatial threshold 600) on a 4-step table, ``i2v`` on the phase-2 i2v
   bundle with phase 5's panorama cropped to 320x512 as a PNG and a 4-step
   table, ``fifo`` with a queue of 16 and 8 output frames; then
   ``fifo_sample(scheduler="lcm")`` directly with 8 output frames. Per
   run: wall seconds and s/step, finite latents of the expected shapes,
   the video through the writer that ran, exact launch counts (the UNet
   forwards at ``expected_launches`` each, plus the VAE's K9 and
   statistics as recorded), and for FIFO each output frame equal to the
   front slot's ``denoised`` of the step that emitted it. Every kernel
   call of the phase at a shape no earlier phase held is held against its
   plain version with phase 3's gates.
9. the demo server ``cli/demo.py`` and the batch eval ``cli/batch_eval.py``
   on phase 8's t2v bundle and the phase-2 i2v bundle, at 320x512, 16
   frames, CFG 12, 4 steps: the demo's ``make_server`` in a thread, its
   page, a t2v ``POST /generate`` answered with the clip inlined as a GIF
   (16 frames of 512x320) while a second POST sent during the generation
   gets 503 and starts nothing; one i2v batch-2 forward of
   ``i2v.basic_sample`` (text and image tokens, the zero-image uncond)
   against the plain versions, then the multipart ``POST /generate_i2v``
   of a 320x512 PNG; ``batch_eval.main`` in process over three prompts at
   ``--rank 1`` and ``--rank 0`` of 2 (t2v), and over two prompts with a
   PNG and an MJPEG AVI as conditioning files (i2v, each clip conditioned
   on its file's first frame); two spawned processes joined through
   ``parallel/dist.py`` on gloo, each with its own t2v bundle, writing
   exactly their shards of three prompts at 2 steps; one batch-2 t2v
   forward with ``no_temporal_attn`` against the plain versions. Per run
   wall seconds and s/step and exact launch counts (the UNet forwards at
   ``expected_launches`` each, plus the VAE decode's K9 and statistics as
   recorded); every kernel call of the phase at a shape no earlier phase
   held against its plain version with phase 3's gates.

10. fp32: seeded random fp32 bundles, the draws of the bf16 bundles before
   their rounding. A full-width t2v UNet forward at batch 2 and an i2v one
   at batch 8 (40x64x16) through the fp32 kernels against the plain
   versions (rel L2 within ``TOL_F32_PATH``, 1e-4) and against the bf16 forward
   of the same weights (printed; sanity gate 0.1), with exact launch
   counts (``expected_launches(..., dtype=float32)``: the fp32 plan,
   ``PLAN_DEFAULT_F32``, runs kernel 12 at t320, kernel 13 at s320 and
   s640 and kernel 10 at t512), the i2v one with a device-time profile;
   the batch-8 i2v forward also under "off" and under the all-wrap+blk plan
   (kernel 11 runs only there), each against the plain versions with exact
   launches; every fp32 kernel (K1-K13, TA, FA, GN) at every shape these
   forwards recorded, kernels 11 and 13 at ``SPATIAL_REPAIRS`` and TA at
   ``TA_F32_REPAIRS`` (F 8, 2, 4, 32, 128: the attention's other bodies),
   against its plain version (max error within 1e-5 of max|plain|, L2
   error within 1e-5 of the op's own output, bit-exact on a rerun; GN its
   statistics' gates; kernels 10-13 a ``tile:`` line, the other TM held
   to the same gates and timed in turns; K9 also forced on every route that
   holds at the shape, cluster, grid and split, each held to the same gates
   and timed, the table ``gn_plan``'s fp32 rule comes from, and per forward
   the calls, ms and bound of each route), timed
   beside the plain version, the same function as PyTorch calls in fp32
   with TF32 off, and two bounds (products over the tensor cores'
   fp32-accurate 494.7 / 3 TFLOP/s, the least time, and over the CUDA
   cores' 67 TFLOP/s; bytes at 4 B an element over 3.35 TB/s), with
   TFLOP/s and the share of each, summed per batch-8 forward; the fp32
   GEMM table (every distinct ``ds_ln_gemm_f32`` call of the batch-8 i2v
   fp32 forward against ``ln_gemm_plain`` with the fp32 gates, its ms,
   TFLOP/s, both bounds, plain, ``F.linear`` with TF32 off and the kernel
   at the planner's other column width, summed per forward); the fp32
   level table at every key (as phase 3's, against ``PLAN_DEFAULT_F32``);
   then the CLIs
   in fp32 through their ``main`` on these bundles, TF32 switched on before
   each and off by its startup: ``cli/sample.py --dtype float32`` in t2v and
   i2v modes (2 steps, 320x512x16) and ``cli/gen_pano_360.py --dtype float32
   --dev_full_random true`` at the CLI's geometry, two steps a stage (stage
   1's 11 forwards of 8 a step, stage 2's 1, stage 3's 4), each with finite
   outputs of their shapes, s/step and exact launches, and every new kernel
   shape (the VAE's) held with the fp32 gates; the ``--dev_full_random``
   bundle in fp32 (every parameter 0.01) and the tiny fp32 bundle through
   a VideoCrafter-named checkpoint and ``load_videocrafter_checkpoint`` on
   the card, fp32 and bit-exact.
11. the window-batch mesh (``parallel/mesh.py``) at world size 1: one NCCL
   rank on this card (``init_rank``, ``make_mesh(n_data=1)``), the NCCL
   version printed; phase 6's stage-1 sphere call for one step and phase
   5's stage-2 request for two steps, each once without a mesh and once
   with ``mesh=``, where every CFG-packed window batch goes through
   ``mesh.apply_sharded`` and its NCCL collectives (rank 0's batch
   broadcast, the eps gathered; one batch a step). The mesh runs equal the
   mesh-less ones bit for bit (latent, denoised, video), with the same
   launch counts and one window batch a step; the phase's time and the
   collectives' ms a batch.
12. temporal relative position and the pooled / alternate encoders: the
   full-width VideoCrafter2 t2v UNet with ``use_relative_position`` (the
   ``relative_position_{k,v}`` tables of every temporal attention; seeded
   random weights, zero-initialised layers perturbed) at window batch 2,
   16 frames, 40x64 latent, in fp32 and then in bf16 (the same draws
   rounded), each through the kernels against the plain versions (rel L2
   within ``TOL_F32_PATH`` in fp32, ``TOL_PATH_REL_L2`` in bf16) with exact
   launches (``expected_launches``: the rel-pos temporal transformers on
   K5 + K6 around plain attention and K4, never K1, kernel 10 or 12), the
   kernel calls at shapes no earlier phase held against their plain
   versions with the gates of their type; then, in fp32, the full-width
   ``OpenCLIPImageEmbedderPooled`` (ViT-H/14, an injected dropout mask),
   ``ClipImageEmbedder`` (the same tower with QuickGELU), the HF CLIP-L
   text encoder and the T5 v1.1-large encoder, seeded weights, once on the
   card against the same weights on the CPU (rel L2 within
   ``TOL_F32_PATH``).
13. the modules that are dead upstream, ``models/vae_aux.py`` and
   ``models/x_transformer.py``, with seeded random weights (zero-initialised
   layers perturbed): the DDPM LSUN-256 ``Model`` (ch 128, ch_mult (1, 1, 2,
   2, 4, 4), 2 blocks, attention at 16, about 114M parameters) at batch 4
   with timesteps, with vanilla and with linear attention;
   ``MergedRescaleEncoder`` at the VideoCrafter VAE's widths on 2 frames of
   320x512; ``MergedRescaleDecoder`` at those widths with z 8;
   ``Upsampler`` 64 -> 256; ``SimpleDecoder``, ``UpsampleDecoder`` and
   ``FirstStagePostProcessor`` on the 40x64 latent. Each in fp32, then bf16
   (the same weights rounded), through the kernels against the plain
   versions (rel L2 within ``TOL_F32_PATH`` / ``TOL_PATH_REL_L2``), finite,
   with K9 launched exactly once at each of the module's GroupNorm sites
   and no other kernel; the K9 calls at new shapes held against their plain
   versions with the gates of their type. Then the x-transformer in fp32 on
   the card against the CPU (rel L2 within ``TOL_F32_PATH``):
   ``TransformerWrapper`` at the width of LDM's BERTEmbedder (vocabulary
   30522, 77 positions, Encoder dim 1280 depth 32, 8 heads of 64) on [2, 77]
   tokens with ``return_embeddings``, and an ``AttentionLayers`` stack at dim
   1280, depth 4, with talking heads, memory KV, sparse top-k, GEGLU, GRU
   gating, residual attention and cross-attention with a context mask (the
   CPU keeps the logits the card's top-k kept; a row where they differ must
   be a tie within fp32 rounding).
14. DynamiCrafter 1024 (``config.dynamicrafter_i2v_1024``): the full-width
   bundle with seeded random bf16 weights (zero-initialised layers
   perturbed); one UNet forward at batch 8 (16 frames, 72x128 latent, 8
   input channels, a 333-token context: 16 image tokens a frame) through
   the kernels, with exact launch counts (``expected_launches`` at 72x128)
   and a device-time profile by kernel class, against the plain versions
   on rows 0 and 7 (the plain spatial attention of a whole batch-8 forward
   at 9216 tokens would hold 43 GB of logits a head); every kernel call of
   the forward at a shape no earlier phase held against its plain version
   with phase 3's gates (K2 and FA at 9216 tokens on one clip's 16 rows);
   the flash table (``ds_flash_attention`` at every recorded shape of the
   forward: ms, TFLOP/s, share of 989, bound, one SDPA call a key segment);
   phase 3's GEMM table at the forward's ``ds_ln_gemm`` shapes (M up to
   1,179,648 rows); and the transformer levels at 72x128 against
   ``PLAN_DEFAULT``. ``python3 chip_smoke.py --phase 14`` runs phases 1 and
   14 alone.

Then one JSON line of kernel records (K1-K13, TA, FA, GN; ``launches`` is
the sum over the paths: the three samplers, the gen_pano_360 CLI, the
sample CLI's four modes and the LCM stream, the demo's two requests, the
batch eval's three runs, the ``no_temporal_attn`` forward, phase 5's
"off" request, phase 2's two override forwards, phase 11's two mesh
runs, phase 12's bf16 rel-pos forward and phase 13's bf16 vae_aux runs;
and the fp32 records ``K1.f32`` ... ``GN.f32``, launches summed over phase
10's forwards and CLI runs, phase 12's fp32 rel-pos forward and phase 13's
fp32 vae_aux runs, times per the first batch-8 fp32 forward in which the kernel runs),
and last the device JSON line.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import dataclasses
import http.client
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse

import numpy as np
import torch
import torch.nn.functional as F

from dynamicscaler_tpu_torch.ops import cuda_lib, fused_block, fused_mega, fused_spatial, fused_temporal, fused_twrap

# name -> (wrapper, description, CUDA source, TPU kernel it replaces)
KERNELS = {
    "K1": (fused_temporal.fused_ln_attention, "fused_ln_attention (temporal LN-attention)",
           "dynamicscaler_tpu_torch/csrc/attention.cu", "dynamicscaler_tpu/ops/fused_temporal.py:267"),
    "K2": (fused_spatial.fused_ln_spatial_attention,
           "fused_ln_spatial_attention (spatial LN-self-attention)",
           "dynamicscaler_tpu_torch/csrc/attention.cu", "dynamicscaler_tpu/ops/fused_spatial.py:156"),
    "K3": (fused_spatial.fused_ln_cross_attention, "fused_ln_cross_attention (LN-cross-attention)",
           "dynamicscaler_tpu_torch/csrc/attention.cu", "dynamicscaler_tpu/ops/fused_spatial.py:337"),
    "K4": (fused_temporal.fused_ln_geglu, "fused_ln_geglu (LN+GEGLU feed-forward)",
           "dynamicscaler_tpu_torch/csrc/gemm.cu", "dynamicscaler_tpu/ops/fused_temporal.py:350"),
    "K5": (fused_twrap.head_temporal, "head_temporal (temporal wrapper head: folded GN apply, permute, proj_in)",
           "dynamicscaler_tpu_torch/csrc/gemm.cu", "dynamicscaler_tpu/ops/fused_twrap.py:150"),
    "K6": (fused_twrap.tail_temporal, "tail_temporal (temporal wrapper tail: proj_out, permute, residual)",
           "dynamicscaler_tpu_torch/csrc/gemm.cu", "dynamicscaler_tpu/ops/fused_twrap.py:193"),
    "K7": (fused_twrap.head_spatial, "head_spatial (spatial wrapper head: folded GN apply, proj_in)",
           "dynamicscaler_tpu_torch/csrc/gemm.cu", "dynamicscaler_tpu/ops/fused_twrap.py:236"),
    "K8": (fused_twrap.tail_spatial, "tail_spatial (spatial wrapper tail: proj_out, residual)",
           "dynamicscaler_tpu_torch/csrc/gemm.cu", "dynamicscaler_tpu/ops/fused_twrap.py:277"),
    "K9": (fused_twrap.gn_silu, "gn_silu (GroupNorm + SiLU in one call with its statistics, ds_group_norm_silu: "
           "a thread-block cluster a sample with the slab in shared memory, or ds_gn_stats's kernels then the "
           "apply kernel of ds_gn_silu)", "dynamicscaler_tpu_torch/csrc/gn_silu.cu",
           "dynamicscaler_tpu/ops/fused_twrap.py:386"),
    "K10": (fused_block.fused_temporal_block, "fused_temporal_block (whole temporal transformer block)",
            "dynamicscaler_tpu_torch/csrc/block.cu", "dynamicscaler_tpu/ops/fused_block.py:292"),
    "K11": (fused_block.fused_spatial_block, "fused_spatial_block (whole spatial transformer block)",
            "dynamicscaler_tpu_torch/csrc/mega.cu", "dynamicscaler_tpu/ops/fused_block.py:447"),
    "K12": (fused_mega.temporal_mega, "temporal_mega (whole temporal transformer, folded GroupNorm)",
            "dynamicscaler_tpu_torch/csrc/block.cu", "dynamicscaler_tpu/ops/fused_mega.py:164"),
    "K13": (fused_mega.spatial_mega, "spatial_mega (whole spatial transformer, folded GroupNorm)",
            "dynamicscaler_tpu_torch/csrc/mega.cu", "dynamicscaler_tpu/ops/fused_mega.py:340"),
    # the device kernels inside K1 and K2 / K3, and the statistics pass under
    # kernels 5, 7, 12 and 13 and K9's split route, each with a wrapper and a
    # counter of its own (K9's split route counts its statistics launches in
    # gn_silu.launches_split)
    "TA": (fused_temporal.temporal_attention, "temporal_attention (K1's attention core, ds_temporal_attention)",
           "dynamicscaler_tpu_torch/csrc/attention.cu", "dynamicscaler_tpu/ops/fused_temporal.py:267"),
    "FA": (fused_spatial.flash_attention,
           "flash_attention (K2's and K3's attention core, ds_flash_attention; K3 is fused_spatial.py:337)",
           "dynamicscaler_tpu_torch/csrc/attention.cu", "dynamicscaler_tpu/ops/fused_spatial.py:156"),
    "GN": (fused_twrap.group_norm_fold,
           "group_norm_fold (GroupNorm statistics under K5, K7, K12, K13 and K9's split route, ds_gn_stats; an "
           "XLA reduction in the JAX package)", "dynamicscaler_tpu_torch/csrc/gn_silu.cu", "dynamicscaler_tpu/ops/fused_twrap.py:58"),
}
# the kernels whose launches the VAE adds to a UNet forward's (gn_silu and its statistics)
VAE_KERNELS = ("K9", "GN")
# the roles of each wrapper's positional arguments, for making inputs of a
# recorded shape: x / y activations, gx a GroupNorm input or residual, ctx
# the context, ln a LayerNorm scale, vec a bias, w a weight [out, in], and
# mul / add the folded GroupNorm vectors (computed from gx)
ROLES = {
    "K1": ("x", "ln", "vec", "w", "w", "w", "w", "vec"),
    "K2": ("x", "ln", "vec", "w", "w", "w", "w", "vec"),
    "K3": ("x", "ctx", "ln", "vec", "w", "w", "w", "w", "vec", "w", "w"),
    "K4": ("x", "ln", "vec", "w", "vec", "w", "vec"),
    "K5": ("gx", "mul", "add", "w", "vec"),
    "K6": ("y", "gx", "w", "vec"),
    "K7": ("gx", "mul", "add", "w", "vec"),
    "K8": ("y", "gx", "w", "vec"),
    "K9": ("gx", "ln", "vec"),
    "K10": ("x", "lns", "attn", "attn", "ff"),
    "K11": ("x", "ctx", "lns", "attn", "attn", "ff"),
    "K12": ("gx", "mul", "add", "w", "vec", "lns", "attn", "attn", "ff", "w", "vec"),
    "K13": ("gx", "ctx", "mul", "add", "w", "vec", "lns", "attn", "attn", "ff", "w", "vec"),
    "TA": ("x",),
    "FA": ("x", "x", "x", "x", "x"),
    "GN": ("gx", "ln", "vec"),
}

# bf16 tolerances of kernel vs plain: both round q/k/v, probabilities,
# normalised activations and outputs to bf16 at the same points but
# accumulate in other orders, so a few outputs may land one or two bf16 ulps
# apart (2^-7 relative each). TOL_REL bounds the worst element against
# max|plain|; TOL_BRANCH_REL_L2 bounds the L2 error against the op's own
# output (plain - x for the ops with a residual, which x would otherwise
# hide). K9 (gn_silu) and its apply kernel alone round once after the
# GroupNorm vectors (the one call folds its own, within TOL_FOLD_REL of the
# plain fold's), so each element must be within one bf16 ulp of plain (|d|
# <= 2^-7 |plain| + 1e-6 max|plain|) and the L2 error within 1e-3.
TOL_REL = 0.03
TOL_BRANCH_REL_L2 = 0.02
TOL_GN_ULP = 2.0 ** -7
TOL_GN_REL_L2 = 1e-3
# the GroupNorm statistics (mul, add): kernel and plain sum the same fp32
# values in other orders (the kernel per thread, then per block, then over
# the blocks; PyTorch its own tree), about 1e-6 relative apart, and the fast
# variance E[x^2] - mean^2 can amplify that by (mean^2 + var) / var; so each
# vector element within 1e-4 of max|plain|, the L2 error within 1e-5; and two
# runs of the kernel equal bit for bit (no atomics, a fixed order)
TOL_FOLD_REL = 1e-4
TOL_FOLD_REL_L2 = 1e-5
# relative L2 error of a whole model path (a full UNet forward, the tiled VAE
# encode, a ring decode), kernels vs plain, in bf16
TOL_PATH_REL_L2 = 0.05
# fp32 (phase 10): kernel and plain round nowhere and differ only in the
# order of their sums (fp32 eps 2^-24), so each kernel is held within
# TOL_F32 of max|plain| and its L2 error within TOL_F32 of the op's own
# output, bit-exact on a rerun (1e-5: the first runs' worst kernel was at
# 2.1e-6 of max|plain| and 1.4e-6 in L2), and a whole fp32 forward within
# rel L2 TOL_F32_PATH of plain; the fp32 forward against the bf16 forward of
# the same weights (rounded to bf16) is printed, with a sanity gate
TOL_F32 = 1e-5
TOL_F32_PATH = 1e-4
TOL_F32_VS_BF16 = 0.1
# the runs whose per-shape sums make the kernels line's figures (as in
# PERF.md): the batch-2 t2v forward, else the first batch-8 i2v forward in
# which the kernel runs (default plan, then the two override plans)
MAIN_FWD = "t2v UNet fwd batch 2"
I2V_FWD = "i2v UNet fwd batch 8"
# the override plans of phase 2 (and phase 5's "off" request): "off" runs
# the highest legal level everywhere; WRAP_BLK runs every whole block
# (kernels 10, 11) inside the wrapper kernels, at every width
WRAP_BLK = "s320=wrap+blk,s640=wrap+blk,t320=wrap+blk,t512=wrap+blk,t640=wrap+blk,t1280=wrap+blk"
OVERRIDES = {f"{I2V_FWD}, plan off": "off", f"{I2V_FWD}, plan wrap+blk": WRAP_BLK}
# the window geometries beside the CLI's 40x64x16 latent that the JAX
# package runs and the port takes since kernel 5, K1, kernels 10 and 12 take
# every clip geometry the JAX gates admit: a 320x320 window (a 40x40 latent:
# H*W 100 and 25 at the two deepest levels) and 8-frame clips
GEOMETRIES = {"i2v UNet fwd batch 2, 40x40 latent": (16, 40, 40), "i2v UNet fwd batch 2, 8 frames": (8, 40, 64)}
FORWARDS = (MAIN_FWD, I2V_FWD, *OVERRIDES, *GEOMETRIES)
# H100 SXM datasheet peaks: bf16 dense tensor cores, fp32
# CUDA cores, HBM3; and the fp32-accurate rate of the tensor cores, TF32's
# 494.7 TFLOP/s over the three products of a split fp32 product (the least
# time for fp32 products: ds_ln_gemm_f32 and ds_flash_attention_f32 run on it)
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_TF32X3 = 494.7e12 / 3
DEV = torch.device("cuda:0")
BF = torch.bfloat16


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# every ds_ln_gemm call of each phase-2 kernel-path run: where -> Counter of
# (x shape, w shape, prologue, rows_per_sample, frame_map, bias, mode)
GEMM_SITES = {}
# the modules whose ops call cuda_lib.ln_gemm by that name
GEMM_CALLERS = (fused_block, fused_spatial, fused_temporal, fused_twrap)


def _reset_launches() -> None:
    for fn, *_ in KERNELS.values():
        fn.launches = 0
    fused_spatial.fused_ln_cross_attention.launches_i2v = 0
    fused_twrap.gn_silu.launches_split = 0


def _launches() -> dict:
    n = {k: fn.launches for k, (fn, *_) in KERNELS.items()}
    n["GN"] += fused_twrap.gn_silu.launches_split  # ds_gn_stats's kernels inside K9's split route
    return n


def _k9_route(pos):
    """The ``gn_plan`` route of a recorded K9 call (positional arguments as
    :func:`_describe` gives them), at its activation's element size."""
    shape, dt = pos[0]
    B, C = shape[0], shape[-1]
    return cuda_lib.gn_plan(B, int(np.prod(shape)) // (B * C), C, 32, _elem(dt)).route


def _elem(dt) -> int:
    """Bytes of an element of dtype ``dt``."""
    return torch.empty((), dtype=dt).element_size()


def _k9_split(calls) -> int:
    """Recorded K9 calls on the split route (each launches the statistics
    kernels inside it)."""
    return sum(n for (k, pos, _), n in calls.items() if k == "K9" and _k9_route(pos) == "split")


def main() -> None:
    if not torch.cuda.is_available():
        _fail("no CUDA device: the port's smoke run needs an NVIDIA GPU")
    # fp32 products of the plain versions stay fp32 (no TF32) on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: card and build -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.build(verbose=True)
    cuda_lib.library()
    built_s = time.perf_counter() - t0
    # every cluster size gn_plan can give must be schedulable at the most shared memory a block may take
    held = [cuda_lib.gn_clusters(cuda_lib.GnPlan("cluster", cs, 1, cuda_lib.GEMM_SMEM_MAX, 0), 320)
            for cs in range(1, cuda_lib.GN_CLUSTER_MAX + 1)]
    print(f"phase 1 ds_group_norm_silu: clusters of 1-{cuda_lib.GN_CLUSTER_MAX} blocks of {cuda_lib.GEMM_SMEM_MAX} B "
          f"the card holds at once (cudaOccupancyMaxActiveClusters): {held}", flush=True)
    if min(held) < 1:
        _fail(f"a cluster size of ds_group_norm_silu's plan does not fit the card: {held}")
    print(f"phase 1 ok: built {lib.relative_to(cuda_lib.REPO_ROOT)} in {built_s:.1f} s "
          f"on {torch.cuda.get_device_name(0)} [{smi}]", flush=True)

    t2v_model, i2v_model = _random_model("t2v"), _random_model("i2v")
    sites, paths = _phase_forwards(t2v_model, i2v_model)
    records = _phase_kernels(sites, i2v_model.unet.cfg)
    paths["t2v"] = _phase_sampler(t2v_model, steps=4)
    del t2v_model
    torch.cuda.empty_cache()
    paths["i2v"], paths["i2v, plan off"] = _phase_i2v_sampler(i2v_model, steps=4)
    paths["sphere"] = _phase_sphere(i2v_model, steps=2)
    held = {key for calls in sites.values() for key in calls}
    paths["cli"], errs = _phase_cli(i2v_model, held)
    t2v_model = _random_model("t2v")  # phases 8 and 9
    sample_paths, sample_errs = _phase_sample(t2v_model, i2v_model, held)
    paths.update(sample_paths)
    serve_paths, serve_errs = _phase_serve(t2v_model, i2v_model, held, lib)
    paths.update(serve_paths)
    for k in KERNELS:
        records[k]["max_abs_err"] = max(records[k]["max_abs_err"], errs.get(k, 0.0), sample_errs.get(k, 0.0),
                                        serve_errs.get(k, 0.0))
    f32_records, f32_paths = _phase_fp32(t2v_model, i2v_model)
    paths.update(_phase_mesh(i2v_model))
    del t2v_model, i2v_model
    torch.cuda.empty_cache()
    relpos_paths, relpos_errs = _phase_relpos(held)
    for where, n in relpos_paths.items():
        (f32_paths if where.startswith("fp32") else paths)[where] = n
    for recs, dt in ((records, BF), (f32_records, F32)):
        for k, e in relpos_errs[dt].items():
            recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], e)
    _phase_encoders()
    aux_paths, aux_errs = _phase_aux(held)
    for where, n in aux_paths.items():
        (f32_paths if where.startswith("fp32") else paths)[where] = n
    for recs, dt in ((records, BF), (f32_records, F32)):
        for k, e in aux_errs[dt].items():
            recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], e)
    _phase_xtransformer()
    paths[DC_FWD] = _phase_dynamicrafter(held)

    kernels = [
        {"name": f"{k} {desc}", "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(n[k] for n in paths.values()),
         "launches_by_path": {path: n[k] for path, n in paths.items()},
         **records[k]}
        for k, (_, desc, src, rep) in KERNELS.items()
    ]
    kernels += [
        {"name": f"{k}.f32 {KERNELS[k][1]} at fp32", "route": "cuda", "source": FP32_SOURCES[k],
         "replaces": KERNELS[k][3], "launches": sum(n[k] for n in f32_paths.values()),
         "launches_by_path": {path: n[k] for path, n in f32_paths.items()}, **f32_records[k]}
        for k in FP32_KERNELS
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _wall_ms(fn, iters: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


# ---------------------------------------------------------------------------
# recording the kernel calls of a run
# ---------------------------------------------------------------------------


def _describe(v):
    """A call argument as the recorder keeps it: (shape, dtype) of a
    tensor, a tuple of those for a tuple of tensors, else the value
    itself."""
    if isinstance(v, tuple):
        return tuple(_describe(e) for e in v)
    return (tuple(v.shape), v.dtype) if torch.is_tensor(v) else v


class _Recorder:
    """Stands in for kernel ``k``'s wrapper: counts each call in ``calls``,
    keyed by (kernel, positional arguments, options) as :func:`_describe`
    gives them (the packed ``operands`` left out), and calls the wrapper.
    Attributes (the launch counters the wrapper bumps through its own name)
    are the wrapper's."""

    def __init__(self, k, fn, calls):
        object.__setattr__(self, "_rec", (k, fn, calls))

    def __call__(self, *a, **kw):
        k, fn, calls = self._rec
        opts = tuple(sorted((n, _describe(v)) for n, v in kw.items() if n != "operands"))
        calls[(k, tuple(map(_describe, a)), opts)] += 1
        return fn(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._rec[1], name)

    def __setattr__(self, name, value):
        setattr(self._rec[1], name, value)


@contextlib.contextmanager
def _recording(calls: collections.Counter):
    """Record every kernel-wrapper call inside the block in ``calls``: each
    wrapper is swapped for a :class:`_Recorder` in the module that defines
    it, where its callers look it up. Inside another such block the inner
    one records alone, and the outer one resumes after it."""
    saved = []
    for k, (fn, *_) in KERNELS.items():
        mod = sys.modules[fn.__module__]
        saved.append((mod, fn.__name__, getattr(mod, fn.__name__)))
        setattr(mod, fn.__name__, _Recorder(k, fn, calls))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _gemm_key(x2d, w, *, ln=None, eps=1e-5, gn=None, rows_per_sample=0, frame_map=None, bias=None,
              residual=None, mode=cuda_lib.MODE_STORE):
    pro = "LN" if ln is not None else "GN" if gn is not None else "-"
    return (tuple(x2d.shape), tuple(w.shape), pro, int(rows_per_sample), tuple(frame_map) if frame_map else None,
            bias is not None, int(mode))


@contextlib.contextmanager
def _recording_gemms(calls: collections.Counter):
    """Count every ``cuda_lib.ln_gemm`` call inside the block in ``calls``,
    keyed by :func:`_gemm_key`, through a stand-in in each calling module."""
    def recorded(*a, **kw):
        calls[_gemm_key(*a, **kw)] += 1
        return cuda_lib.ln_gemm(*a, **kw)
    for mod in GEMM_CALLERS:
        mod.ln_gemm = recorded
    try:
        yield calls
    finally:
        for mod in GEMM_CALLERS:
            mod.ln_gemm = cuda_lib.ln_gemm


# ---------------------------------------------------------------------------
# models, phase 2
# ---------------------------------------------------------------------------


def _random_model(kind, dtype="bfloat16"):
    """The full-width bundle of ``kind`` with seeded random weights in
    ``dtype``: the same draws at every dtype (fp32, then cast), so the fp32
    bundle's weights rounded to bf16 are the bf16 bundle's."""
    from dynamicscaler_tpu_torch.config import videocrafter2_t2v, videocrafter_i2v
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
    from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer
    from dynamicscaler_tpu_torch.utils.weights import perturb_zero_params

    t0 = time.perf_counter()
    cfg = videocrafter2_t2v(dtype) if kind == "t2v" else videocrafter_i2v(dtype)
    gen = torch.Generator(device=DEV).manual_seed(0 if kind == "t2v" else 2)
    model = LatentVideoDiffusion.init_random(cfg, gen, tokenizer=HashTokenizer())
    # without this the zero-initialised output layers make eps identically 0
    perturb_zero_params(model.unet, gen)
    n = sum(p.numel() for _, m in model.components() for p in m.parameters())
    print(f"model {kind}: {n / 1e9:.3f}B random {dtype} weights on {model.device} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model


def _unet_inputs(B, L, seed, frames=16, H=40, W=64):
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn((B, frames, H, W, 4), generator=g, device=DEV)
    ctx = torch.randn((B, L, 1024), generator=g, device=DEV)
    return x, ctx, torch.full((B,), 500, device=DEV)


Versus = collections.namedtuple("Versus", "out rel finite launches i2v_k3 ms plain_ms")


def _against_plain(where, fn, sites, iters, plain_iters):
    """Run ``fn`` through the kernels, recording every kernel call into
    ``sites[where]``, and through the plain versions; then time both paths
    (host clock, synchronised)."""
    calls = sites.setdefault(where, collections.Counter())
    _reset_launches()
    with _recording(calls), _recording_gemms(GEMM_SITES.setdefault(where, collections.Counter())):
        got = fn()
    torch.cuda.synchronize()
    launches = _launches()
    i2v_k3 = fused_spatial.fused_ln_cross_attention.launches_i2v
    with cuda_lib.plain_kernels():
        ref = fn()
    torch.cuda.synchronize()
    rel = float((got.float() - ref.float()).norm() / ref.float().norm())
    finite = bool(torch.isfinite(got).all())
    del ref
    ms = _wall_ms(fn, iters)
    with cuda_lib.plain_kernels():
        plain_ms = _wall_ms(fn, plain_iters)
    recorded = dict.fromkeys(KERNELS, 0)
    for (k, *_), n in calls.items():
        recorded[k] += n
    recorded["GN"] += _k9_split(calls)
    if recorded != launches:
        _fail(f"{where}: recorded calls {recorded} != launches {launches}")
    return Versus(got, rel, finite, launches, i2v_k3, ms, plain_ms)


def unet_transformers(cfg, H, W):
    """(side, C, inner, heads, H, W) of every transformer of a UNet forward
    at an H x W latent, in the order the forward runs them, with init_attn
    (8 heads on model_channels) after the first input block."""
    from dynamicscaler_tpu_torch.models.unet3d import unet_layout

    ins, outs, mid, _ = unet_layout(cfg)
    out, size = [], [H, W]
    d = cfg.num_head_channels

    def walk(specs):
        for sp in specs:
            if sp.kind == "down":
                size[:] = [(n + 1) // 2 for n in size]
            elif sp.kind == "up":
                size[:] = [2 * n for n in size]
            elif sp.kind in ("spatial", "temporal"):
                out.append((sp.kind[0], sp.channels, sp.channels, sp.channels // d, *size))
    walk(ins[0])
    if cfg.addition_attention:
        out.append(("t", cfg.model_channels, 8 * d, 8, *size))
    for specs in (*ins[1:], mid, *outs):
        walk(specs)
    return out


def expected_launches(cfg, H, W, frames=16, traj=None, no_temporal_attn=False, dtype=BF):
    """Kernel launches of one UNet forward at an H x W latent under the
    current dispatch plan, from the UNet layout, the plan and the kernels'
    gates: per transformer the whole transformer (K12 / K13) where the plan
    allows ``mega`` and its gate admits the shape; else the wrapper head and
    tail (K5 + K6 / K7 + K8) around the whole block (K10 / K11) where the
    plan allows ``block`` and its gate admits it, or around the sub-blocks
    (K1 x 2 + K4 / K2 + K3 + K4). ``traj`` (temporal, self, cross): the
    FreeTraj classes on, which keep their transformers on the wrapper
    kernels and the sub-blocks: a temporal transformer with the temporal
    class runs K1 once (attn2; attn1 is re-weighted in plain math) and K4,
    a spatial one with the self or the cross class K2 unless self, K3
    unless cross, and K4. ``no_temporal_attn`` skips every temporal
    transformer and init_attn (no K1, K5, K6, K10, K12 there, nor their
    K4). With ``cfg.use_relative_position`` a temporal transformer runs
    the wrapper head and tail around plain attention and K4 (no K1, kernel
    10 or 12), as the JAX gates keep it. gn_silu (K9): 2 per ResBlock, 4 more in
    its temporal conv block, and the out norm (``unet3d.gn_silu_calls``).
    The device-kernel wrappers inside them: K1's attention core (TA) once
    per K1, K2's and K3's (FA) once per K2 and per K3, the GroupNorm
    statistics (GN) once per K5, K7, K12 and K13 and per K9 call on the
    split route (``cuda_lib.gn_plan``: whether a call splits depends on a
    sample's rows, channels and element size, not on the batch; no fp32
    call splits, the grid route taking them). ``dtype`` the activations',
    whose element size K9's plan reckons (fp32 runs every other kernel where
    bf16 does)."""
    from dynamicscaler_tpu_torch.models.unet3d import gn_silu_calls

    n = collections.Counter()

    def allows(kind, side, C):
        return fused_temporal.plan_allows(kind, side, C, dtype)
    t_traj, s_traj, c_traj = traj or (False, False, False)
    for side, C, inner, heads, h, w in unet_transformers(cfg, H, W):
        if side == "t" and no_temporal_attn:
            continue
        if side == "t" and cfg.use_relative_position:
            # plain attention with the tables at both sites; off K1 and kernels 10 and 12
            n.update(("K5", "K6", "K4"))
        elif side == "t" and t_traj:
            n.update(("K5", "K6", "K1", "K4"))
        elif side == "s" and (s_traj or c_traj):
            n.update(("K7", "K8", "K4") + (() if s_traj else ("K2",)) + (() if c_traj else ("K3",)))
        elif side == "t":
            if allows("mega", "t", C) and fused_mega.temporal_ok(frames, C, inner, heads):
                n["K12"] += 1
                continue
            n.update(("K5", "K6"))
            if allows("block", "t", inner) and fused_block.temporal_block_ok(frames, inner, inner, heads):
                n["K10"] += 1
            else:
                n.update(("K1", "K1", "K4"))
        else:
            if allows("mega", "s", C) and fused_mega.spatial_ok(h * w, C, inner, heads, cfg.context_dim):
                n["K13"] += 1
                continue
            n.update(("K7", "K8"))
            if allows("block", "s", inner) and fused_block.spatial_block_ok(h * w, inner, inner, heads,
                                                                             cfg.context_dim):
                n["K11"] += 1
            else:
                n.update(("K2", "K3", "K4"))
    k9 = gn_silu_calls(cfg, 1, frames, H, W)
    n["K9"] = len(k9)
    n["TA"], n["FA"] = n["K1"], n["K2"] + n["K3"]
    n["GN"] = n["K5"] + n["K7"] + n["K12"] + n["K13"] + sum(
        cuda_lib.gn_plan(*c, 32, _elem(dtype)).route == "split" for c in k9)
    return {k: n[k] for k in KERNELS}


@contextlib.contextmanager
def _plan(spec):
    """The dispatch plan ``spec`` inside the block, the default after it."""
    fused_temporal.set_plan(spec)
    try:
        yield
    finally:
        fused_temporal.set_plan()


def _phase_forwards(model, i2v_model):
    """Phase 2: one full-width t2v UNet forward at batch 2 (with a device
    profile) and i2v UNet forwards at batch 8 under the default plan, under
    "off" and under the all-wrap+blk plan, the tiled encode of the phase-5
    panorama and the ring decode of one of its latent frames, each through
    the kernels against the plain versions, with the exact launch counts of
    :func:`expected_launches`. Returns the recorded kernel calls of each run
    and the launches of the override forwards by name."""
    from dynamicscaler_tpu_torch.pipelines.tiled_vae import ring_aware_decode, tiled_vae_encode

    sites, paths = {}, {}
    runs = [("t2v", model, 2, 77, 7, MAIN_FWD, None, (16, 40, 64)),
            ("i2v", i2v_model, 8, 93, 8, I2V_FWD, None, (16, 40, 64))]
    runs += [("i2v", i2v_model, 8, 93, 8, where, spec, (16, 40, 64)) for where, spec in OVERRIDES.items()]
    runs += [("i2v", i2v_model, 2, 93, 9, where, None, geo) for where, geo in GEOMETRIES.items()]
    for kind, m, B, L, seed, where, spec, (Fn, H, W) in runs:
        x, ctx, t = _unet_inputs(B, L, seed, Fn, H, W)

        def fwd(m=m, x=x, ctx=ctx, t=t, Fn=Fn):
            return m.apply_unet(x, t, ctx, Fn)

        with _plan(spec):
            want = expected_launches(m.unet.cfg, H, W, Fn)
            r = _against_plain(where, fwd, sites, 3 if B == 2 else 2, 2 if B == 2 else 1)
        print(f"phase 2 {where}: [{B},{Fn},{H},{W},4] ctx [{B},{L},1024]: rel_l2 {r.rel:.5f} "
              f"(tol {TOL_PATH_REL_L2}) |eps| mean {float(r.out.abs().mean()):.4f} kernels {r.ms:.1f} ms "
              f"plain {r.plain_ms:.1f} ms launches {r.launches} (K3 with image keys {r.i2v_k3})", flush=True)
        if not r.finite or r.rel > TOL_PATH_REL_L2:
            _fail(f"{where}: the kernel path disagrees with the plain path: rel_l2 {r.rel} finite {r.finite}")
        if r.launches != want:
            _fail(f"{where}: launch counts {r.launches} != {want} (plan {spec or 'default'})")
        if r.i2v_k3 != (want["K3"] if kind == "i2v" else 0):
            _fail(f"{where}: {r.i2v_k3} K3 launches with image keys")
        if spec:
            paths[where] = r.launches
        if where in (MAIN_FWD, I2V_FWD):
            _profile_forward(where, fwd, r.ms)
        del r
    pano = smooth_panorama(512, 1024, seed=5)
    enc = _against_plain("i2v tiled VAE encode", lambda: tiled_vae_encode(i2v_model, pano), sites, 1, 1)
    z = enc.out
    dec = _against_plain("i2v ring decode, one frame", lambda: ring_aware_decode(i2v_model, z), sites, 1, 1)
    for name, where, r, shape in (
            ("tiled VAE encode of the 512x1024 panorama", "i2v tiled VAE encode", enc, (1, 1, 64, 128, 4)),
            ("ring decode of one 64x128 latent frame", "i2v ring decode, one frame", dec, (1, 1, 512, 1024, 3))):
        print(f"phase 2 i2v {name}: {tuple(r.out.shape)} rel_l2 {r.rel:.5f} (tol {TOL_PATH_REL_L2}) "
              f"kernels {r.ms:.1f} ms plain {r.plain_ms:.1f} ms gn_silu launches {r.launches['K9']} (split route "
              f"{_k9_split(sites[where])}) GroupNorm statistics launches {r.launches['GN']}", flush=True)
        others = {k: n for k, n in r.launches.items() if k not in VAE_KERNELS and n}
        split = _k9_split(sites[where])
        if tuple(r.out.shape) != shape or not r.finite or r.rel > TOL_PATH_REL_L2 or not r.launches["K9"] \
                or r.launches["GN"] != split or others:
            _fail(f"VAE {name}: shape {tuple(r.out.shape)} finite {r.finite} rel_l2 {r.rel} "
                  f"launches {r.launches}")
    print("phase 2 ok", flush=True)
    return sites, paths


def _profile_forward(where, fwd, wall_ms, phase="phase 2"):
    """Device time of one kernel-path forward by CUDA kernel (torch.profiler),
    by kernel class: the GEMM, the two attention kernels, gn_silu, cuDNN,
    cuBLAS (the time embedding; FreeTraj's plain attention products) and the
    remaining elementwise/reduction work."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in rows) / 1e3
    if total <= 0:
        print(f"{phase} profile of {where}: no device time recorded (profiler saw no CUDA activity)", flush=True)
        return
    groups = {}
    for e in rows:
        n = e.key.lower()
        key = ("ds_ln_gemm (K1-K4 projections, K5-K8 wrapper heads/tails; GEMM + prologue pass)"
               if any(k in n for k in ("ds_gemm_kernel", "prologue_ln_kernel", "prologue_gn_kernel", "gemm_f32_kernel",
                                       "prologue_ln_f32_kernel", "prologue_gn_f32_kernel", "tf32_split_kernel"))
               else "ds_group_norm_silu cluster route (K9)" if "gn_cluster_kernel" in n
               else "ds_group_norm_silu grid route (K9 fp32)" if "gn_grid_kernel" in n
               else "ds_gn_silu apply kernel (K9 split route)" if "gn_apply_kernel" in n
               else "ds_gn_stats (GroupNorm statistics: K5, K7, K12, K13, K9 split route)"
               if "gn_partial_kernel" in n or "gn_fold_kernel" in n
               else "ds_flash_attn (K2, K3)" if "flash_attn" in n
               else "ds_temporal_attn (K1)" if "temporal_attn" in n
               else "ds_temporal_block / ds_temporal_mega (K10, K12)" if "temporal_block_tma_kernel" in n
               else "ds_spatial_block / ds_mega_spatial body (K11, K13)" if "spatial_body_kernel" in n
               else "ds_temporal_block_f32 / ds_temporal_mega_f32 (K10, K12 fp32)" if "temporal_tc_f32_kernel" in n
               else "ds_spatial_block_f32 / ds_mega_spatial_f32 body and key split (K11, K13 fp32)"
               if "spatial_tc_f32_kernel" in n or "split_kv_kernel" in n
               else "conv (cuDNN)" if any(s in n for s in ("conv", "cudnn", "fprop", "implicit"))
               else "gemm (cuBLAS: time emb, FreeTraj's plain attention)" if any(s in n for s in ("gemm", "cutlass"))
               else "elementwise/reduce (casts, cat)")
        groups[key] = groups.get(key, 0.0) + e.self_device_time_total / 1e3
    parts = ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.0f}%)"
                      for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"{phase} profile of {where}: device busy {total:.1f} ms of {wall_ms:.1f} ms wall "
          f"(idle share {max(0.0, 1 - total / wall_ms):.2f}); {parts}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at the recorded shapes
# ---------------------------------------------------------------------------


class Case:
    """One kernel at one recorded shape: ``run`` launches the kernel,
    ``plain`` computes the plain version, ``library`` the same function
    composed of PyTorch library calls in bf16 (a yardstick; the port never
    calls it), ``fold`` the plain GroupNorm statistics pass whose vectors
    the kernel reads (or None). ``base``: the residual the op adds (L2 error
    is measured against plain - base). ``flops``: the products' operations,
    tensor-core bf16 (over 989 TFLOP/s) for bf16 activations and
    fp32-accurate tensor-core products (over 494.7 / 3 TFLOP/s, the least
    time the card can take for them) for ``fp32`` ones, whose bound at the
    CUDA cores' 67 TFLOP/s is kept beside it (``bound_cc_ms``); ``ops``:
    fp32 CUDA-core operations; with the output, :meth:`set_bound` adds its
    bytes to the inputs' (each read once, each output written once)."""

    lib_comparable = True  # the library call computes the same output (the GroupNorm statistics' does not)
    block = None  # K10, K12: (tokens, C, F, mega) for the tile plan line
    run_at = None  # K10-K13: run(plan), the kernel at another tile plan
    f32_tile = None  # K10-K13 at fp32: (plan, the other tile or None, grid(plan)) for the tile line
    spatial = None  # K11, K13: (samples, N, C) for the tile plan line
    gn = None  # K9: (x, scale, bias, eps, act) for the route line

    def __init__(self, k, desc, run, plain, library, inputs, *, base=None, fold=None, flops=0.0, ops=0.0,
                 fp32=False):
        self.k, self.desc, self.fp32 = k, desc, fp32
        self.run, self.plain, self.library, self.base, self.fold = run, plain, library, base, fold
        self.flops = flops
        self.op_ms = max(flops / (PEAK_TF32X3 if fp32 else PEAK_BF16), ops / PEAK_FP32) * 1e3
        self.op_cc_ms = max(flops, ops) / PEAK_FP32 * 1e3  # fp32: every product on the CUDA cores
        self.in_bytes = sum(t.numel() * t.element_size() for t in inputs if torch.is_tensor(t))

    def set_bound(self, out):
        byte_ms = (self.in_bytes + out.numel() * out.element_size()) / PEAK_BYTES * 1e3
        self.bound_ms = max(self.op_ms, byte_ms)
        self.bound_cc_ms = max(self.op_cc_ms, byte_ms)
        self.bound_by = "bytes" if byte_ms >= self.op_ms else "operations"


def _plain(fn, *a, **kw):
    def call():
        with cuda_lib.plain_kernels():
            return fn(*a, **kw)
    return call


def _gen():
    g = torch.Generator(device=DEV).manual_seed(1)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=DEV) * s
    return rn


# the roles inside a tuple argument: LayerNorm (scale, bias) x 3; attention
# (wq, wk, wv, wo, bo[, wk_ip, wv_ip]); feed-forward (w1, b1, w2, b2)
TUPLE_ROLES = {"lns": ("ln", "vec") * 3, "attn": ("w", "w", "w", "w", "vec", "w", "w"),
               "ff": ("w", "vec", "w", "vec")}


def _synth(role, d, rn):
    """An input of the recorded (shape, dtype) ``d`` for its role."""
    if d is None:
        return None
    if role in TUPLE_ROLES:
        return tuple(_synth(r, e, rn) for r, e in zip(TUPLE_ROLES[role], d))
    shape, dtype = d
    t = (rn(*shape) / shape[-1] ** 0.5 if role == "w" else 1.0 + rn(*shape, s=0.1) if role == "ln"
         else rn(*shape, s=0.1) if role == "vec" else 2 * rn(*shape) + 0.5 if role == "gx" else rn(*shape))
    return t.to(dtype)


def _case(k, pos, opts, rn):
    """The Case of kernel ``k`` called with positional arguments ``pos`` and
    options ``opts`` as recorded."""
    fn = KERNELS[k][0]
    a = [_synth(role, d, rn) for role, d in zip(ROLES[k], pos)]
    x = a[0]
    C = x.shape[-1]
    T = x.numel() // C
    fold = gn = None
    if "mul" in ROLES[k]:  # K5, K7, K9, K12, K13: folded vectors of gx with a GroupNorm scale and bias
        gn = (1.0 + rn(C, s=0.1), rn(C, s=0.1))

        def fold():
            return fused_twrap.group_norm_fold(x, *gn)
        i = ROLES[k].index("mul")
        a[i:i + 2] = fold()
    run_kw = dict(opts)
    if k == "K10":
        run_kw["operands"] = fused_block.pack_temporal_block(*a[1:], dtype=x.dtype)
    elif k == "K11":
        run_kw["operands"] = fused_block.pack_spatial_block(*a[2:], dtype=x.dtype)
    elif k == "K12":
        run_kw["operands"] = fused_mega.pack_temporal_mega(*a[3:], dtype=x.dtype)
    elif k == "K13":
        run_kw["operands"] = fused_mega.pack_spatial_mega(*a[4:], dtype=x.dtype)
    elif k in ("K1", "K2"):
        run_kw["operands"] = fused_temporal.pack_ln_attention(*a[1:], dtype=x.dtype)
    elif k == "K3":
        run_kw["operands"] = fused_spatial.pack_ln_cross_attention(*a[2:], dtype=x.dtype)
    elif k == "K4":
        run_kw["operands"] = fused_temporal.pack_ln_geglu(*a[1:], dtype=x.dtype)

    def run():
        return fn(*a, **run_kw)
    plain = _plain(fn, *a, **opts)
    common = dict(inputs=[t for v in a for t in (v if isinstance(v, tuple) else (v,))], fold=fold,
                  fp32=x.dtype == torch.float32)
    if k == "K10":
        R, Fn, _ = x.shape
        case = Case(k, f"x{list(x.shape)}", run, plain, _lib_temporal_block(a, opts["heads"], opts["scale"]),
                    base=x, flops=2 * (8 * T * C * C + 4 * R * Fn * Fn * C) + 24 * T * C * C, **common)
        case.run_at = lambda plan: fn(*a, **run_kw, plan=plan)
        # the tile plan line of block.cu, or of temporal_f32.cu at fp32
        case.block = (T, C, Fn, False)
        case.f32_tile = _temporal_f32_tile(C, Fn, T, False) if case.fp32 else None
        return case
    if k == "K12":
        B, Fn, H, W, _ = x.shape
        flops = 4 * T * C * C + 2 * (8 * T * C * C + 4 * B * H * W * Fn * Fn * C) + 24 * T * C * C
        case = Case(k, f"x5{list(x.shape)}", run, plain,
                    _lib_temporal_transformer(x, gn, a[3:], opts["heads"], opts["scale"]), base=x, flops=flops,
                    **common)
        case.run_at = lambda plan: fn(*a, **run_kw, plan=plan)
        case.block = (T, C, Fn, True)
        case.f32_tile = _temporal_f32_tile(C, Fn, T, True) if case.fp32 else None
        return case
    if k in ("K11", "K13"):
        BFn, N = x.shape[0], T // x.shape[0]
        clips, L, Dc = a[1].shape
        rest = a[4:] if k == "K13" else (None, None, *a[2:], None, None)
        Ci = opts["heads"] * 64
        img = len(rest[4]) == 7
        text_len = opts.get("text_len", 77) if img else None
        flops = (8 * T * Ci * Ci + 4 * BFn * N * N * Ci  # self-attention
                 + 4 * T * Ci * Ci + 4 * clips * L * Dc * Ci + 4 * T * L * Ci  # cross-attention, K/V per clip
                 + 24 * T * Ci * Ci + (4 * T * C * Ci if k == "K13" else 0))  # feed-forward, proj_in/out
        lib = (_lib_spatial_transformer(x, a[1], gn, rest, opts["heads"], opts["scale"], text_len) if k == "K13"
               else _lib_spatial_block(x, a[1], rest[2:6], opts["heads"], opts["scale"], text_len))
        case = Case(k, f"x{list(x.shape)} ctx{list(a[1].shape)} {'i2v' if img else 't2v'}", run, plain, lib,
                    base=x, flops=flops, **common)
        if not case.fp32:  # the tile plan line of mega.cu
            case.spatial = (BFn, N, C)
        else:  # of spatial_f32.cu: its query tile, and the other
            case.run_at = lambda plan: fn(*a, **run_kw, plan=plan)
            plan = cuda_lib.spatial_f32_plan(C, N, BFn)
            case.f32_tile = (plan, cuda_lib.BlockF32Plan(64 if plan.tm == 128 else 128),
                             lambda p: cuda_lib.spatial_f32_grid(p, BFn, N))
        return case
    if k in ("K1", "K2"):
        B, N, _ = x.shape
        return Case(k, f"x{list(x.shape)}", run, plain, _lib_self_attention(a, opts["heads"], opts["scale"]),
                    base=x, flops=8 * T * C * C + 4 * B * N * N * C, **common)
    if k == "K3":
        B, N, _ = x.shape
        _, L, D = a[1].shape
        img = a[9] is not None
        return Case(k, f"x{list(x.shape)} ctx{list(a[1].shape)} {'i2v' if img else 't2v'}", run, plain,
                    _lib_cross_attention(a, opts["heads"], opts["scale"], opts.get("text_len", 77) if img else None),
                    base=x, flops=4 * T * C * C + 4 * B * L * D * C + 4 * B * N * L * C, **common)
    if k == "K4":
        return Case(k, f"x{list(x.shape)}", run, plain, _lib_geglu(a), base=x, flops=24 * T * C * C, **common)
    if k in ("K5", "K7"):
        Ci = a[3].shape[0]
        return Case(k, f"x{list(x.shape)} -> {Ci}", run, plain, _lib_head(x, *gn, *a[3:], temporal=k == "K5"),
                    flops=2 * T * C * Ci, **common)
    if k in ("K6", "K8"):
        res = a[1]
        return Case(k, f"y{list(x.shape)} x{list(res.shape)}", run, plain,
                    _lib_tail(x, res, *a[2:], temporal=k == "K6"), base=res,
                    flops=2 * T * C * res.shape[-1], **common)
    if k == "TA":
        R, Fn, C3 = x.shape
        heads, C = opts["heads"], C3 // 3
        q, kk, v = (_heads(t.reshape(R, Fn, C), heads) for t in x.chunk(3, dim=-1))
        return Case(k, f"qkv{list(x.shape)}", run, plain,
                    lambda: F.scaled_dot_product_attention(q, kk, v, scale=opts["scale"]).transpose(1, 2),
                    flops=4 * R * Fn * Fn * C, **common)
    if k == "FA":
        B, Nq, C = x.shape
        heads = opts["heads"]
        segs = [(a[i], a[i + 1]) for i in (1, 3) if i < len(a) and a[i] is not None]

        def sdpa():  # one SDPA call a key segment (the i2v cross-attention has two), summed
            qh = _heads(x, heads)
            return sum(F.scaled_dot_product_attention(qh, _heads(kt, heads), _heads(vt, heads), scale=opts["scale"])
                       for kt, vt in segs).transpose(1, 2)
        lens = "+".join(str(kt.shape[1]) for kt, _ in segs)
        return Case(k, f"q{list(x.shape)} keys {lens} ({'self' if len(segs) == 1 and lens == str(Nq) else 'cross'})",
                    run, plain, sdpa, flops=sum(4 * B * Nq * kt.shape[1] * C for kt, _ in segs), **common)
    if k == "GN":
        B, C = x.shape[0], x.shape[-1]
        G = opts.get("num_groups", 32)
        kw = dict(opts)

        def run_gn():  # (mul, add) stacked, [2, B, C]
            return torch.stack(fn(*a, **kw))

        def plain_gn():
            return torch.stack(fused_twrap.group_norm_fold_plain(*a, **kw))
        case = Case(k, f"x{list(x.shape)} eps {opts.get('eps', 1e-6):g}", run_gn, plain_gn,
                    lambda: torch.var_mean(x.view(B, -1, G, C // G), dim=(1, 3)), ops=3 * x.numel(), **common)
        case.lib_comparable = False
        return case
    eps, act = opts.get("eps", 1e-5), opts.get("act", True)
    fp32 = " fp32" if x.dtype == torch.float32 else ""
    case = Case(k, f"x{list(x.shape)} eps {eps:g}{'' if act else ' no SiLU'}{fp32}", run, plain,
                _lib_gn_silu(x, a[1], a[2], eps, act), ops=x.numel() * (9 if act else 5), **common)
    case.gn = (x, a[1], a[2], eps, act)
    return case


def _bf(*ts, dt=BF):
    """Vectors cast to the activation type ``dt`` of a library composite."""
    return [t.to(dt) for t in ts]


def _heads(t, heads):
    """[B, N, heads*64] -> [B, heads, N, 64] (a view)."""
    B, N, _ = t.shape
    return t.view(B, N, heads, 64).transpose(1, 2)


def _lib_self_attention(a, heads, scale):
    x, s, b, wq, wk, wv, wo, bo = a
    C = x.shape[-1]
    s, b, bo = _bf(s, b, bo, dt=x.dtype)
    wqkv = torch.cat([wq, wk, wv])

    def run():
        x3 = x.reshape(-1, x.shape[-2], C)
        q, k, v = F.linear(F.layer_norm(x3, (C,), s, b, 1e-5), wqkv).chunk(3, dim=-1)
        o = F.scaled_dot_product_attention(_heads(q, heads), _heads(k, heads), _heads(v, heads), scale=scale)
        return (F.linear(o.transpose(1, 2).reshape(x3.shape), wo, bo) + x3).reshape(x.shape)
    return run


def _lib_cross_attention(a, heads, scale, text_len):
    """One SDPA call per context segment (text; image from ``text_len`` on
    when not None), outputs summed."""
    x, ctx, s, b, wq, wk, wv, wo, bo = a[:9]
    C = x.shape[-1]
    s, b, bo = _bf(s, b, bo, dt=x.dtype)
    ctx = ctx.to(x.dtype)
    segs = [(torch.cat([wk, wv]), slice(0, text_len))]
    if text_len is not None:
        segs.append((torch.cat(a[9:11]), slice(text_len, None)))

    def run():
        q = _heads(F.linear(F.layer_norm(x, (C,), s, b, 1e-5), wq), heads)
        o = 0
        for wkv, sl in segs:
            k, v = F.linear(ctx[:, sl], wkv).chunk(2, dim=-1)
            o = o + F.scaled_dot_product_attention(q, _heads(k, heads), _heads(v, heads), scale=scale)
        return F.linear(o.transpose(1, 2).reshape(x.shape), wo, bo) + x
    return run


def _lib_geglu(a):
    x, s, b, w1, b1, w2, b2 = a
    C = x.shape[-1]
    s, b, b1, b2 = _bf(s, b, b1, b2, dt=x.dtype)

    def run():
        val, gate = F.linear(F.layer_norm(x, (C,), s, b, 1e-5), w1, b1).chunk(2, dim=-1)
        return F.linear(val * F.gelu(gate), w2, b2) + x
    return run


def _lib_temporal_block_fn(lns, a1, a2, ff, heads, scale, dt=BF):
    """K1, K1, K4's composites in sequence: F.layer_norm, F.linear, SDPA,
    F.gelu, as a function of h [rows, F, C] in the activation type ``dt``."""
    s1, b1, s2, b2, s3, b3 = _bf(*lns, dt=dt)
    attns = [(s, b, torch.cat(w[:3]), w[3], w[4].to(dt)) for s, b, w in ((s1, b1, a1), (s2, b2, a2))]
    w1, bb1, w2, bb2 = ff
    bb1, bb2 = _bf(bb1, bb2, dt=dt)

    def block(h):
        C = h.shape[-1]
        for s, b, wqkv, wo, bo in attns:
            q, k, v = F.linear(F.layer_norm(h, (C,), s, b, 1e-5), wqkv).chunk(3, dim=-1)
            o = F.scaled_dot_product_attention(_heads(q, heads), _heads(k, heads), _heads(v, heads), scale=scale)
            h = F.linear(o.transpose(1, 2).reshape(h.shape), wo, bo) + h
        val, gate = F.linear(F.layer_norm(h, (C,), s3, b3, 1e-5), w1, bb1).chunk(2, dim=-1)
        return F.linear(val * F.gelu(gate), w2, bb2) + h
    return block


def _lib_temporal_block(a, heads, scale):
    x, lns, a1, a2, ff = a
    block = _lib_temporal_block_fn(lns, a1, a2, ff, heads, scale, x.dtype)
    return lambda: block(x)


def _lib_temporal_transformer(x5, gn, rest, heads, scale):
    """F.group_norm over each clip (statistics included), the permute to
    16-frame rows and F.linear proj_in, the K10 composite, F.linear proj_out,
    the permute back + x5."""
    w_in, b_in, lns, a1, a2, ff, w_out, b_out = rest
    B, Fn, H, W, C = x5.shape
    gs, gb, b_in, b_out = _bf(*gn, b_in, b_out, dt=x5.dtype)
    block = _lib_temporal_block_fn(lns, a1, a2, ff, heads, scale, x5.dtype)

    def run():
        xn = F.group_norm(_channels_first(x5), 32, gs, gb, 1e-6)  # [B, C, F, H, W]
        h = F.linear(xn.permute(0, 3, 4, 2, 1).reshape(B * H * W, Fn, C), w_in, b_in)
        o = F.linear(block(h), w_out, b_out).reshape(B, H, W, Fn, C).permute(0, 3, 1, 2, 4)
        return o + x5
    return run


def _lib_spatial_block_fn(ctx, lns, a1, a2, ff, heads, scale, text_len, frames, dt=BF):
    """K2, K3, K4's composites in sequence (the context K/V projected per
    clip and repeated over its frames), as a function of h [BF, N, C] in the
    activation type ``dt``."""
    s1, b1, s2, b2, s3, b3 = _bf(*lns, dt=dt)
    wqkv, wo1, bo1 = torch.cat(a1[:3]), a1[3], a1[4].to(dt)
    wq2, wo2, bo2 = a2[0], a2[3], a2[4].to(dt)
    segs = [(torch.cat(a2[1:3]), slice(0, text_len))]
    if text_len is not None:
        segs.append((torch.cat(a2[5:7]), slice(text_len, None)))
    w1, bb1, w2, bb2 = ff
    bb1, bb2 = _bf(bb1, bb2, dt=dt)
    ctx = ctx.to(dt)

    def block(h):
        Ci = h.shape[-1]
        q, k, v = F.linear(F.layer_norm(h, (Ci,), s1, b1, 1e-5), wqkv).chunk(3, dim=-1)
        o = F.scaled_dot_product_attention(_heads(q, heads), _heads(k, heads), _heads(v, heads), scale=scale)
        h = F.linear(o.transpose(1, 2).reshape(h.shape), wo1, bo1) + h
        q = _heads(F.linear(F.layer_norm(h, (Ci,), s2, b2, 1e-5), wq2), heads)
        o = 0
        for wkv, sl in segs:
            k, v = (_heads(t, heads).repeat_interleave(frames, dim=0)
                    for t in F.linear(ctx[:, sl], wkv).chunk(2, dim=-1))
            o = o + F.scaled_dot_product_attention(q, k, v, scale=scale)
        h = F.linear(o.transpose(1, 2).reshape(h.shape), wo2, bo2) + h
        val, gate = F.linear(F.layer_norm(h, (Ci,), s3, b3, 1e-5), w1, bb1).chunk(2, dim=-1)
        return F.linear(val * F.gelu(gate), w2, bb2) + h
    return block


def _lib_spatial_block(x, ctx, block_w, heads, scale, text_len):
    block = _lib_spatial_block_fn(ctx, *block_w, heads, scale, text_len, x.shape[0] // ctx.shape[0], x.dtype)
    return lambda: block(x)


def _lib_spatial_transformer(x, ctx, gn, rest, heads, scale, text_len):
    """F.group_norm (statistics included) + F.linear proj_in, the K2, K3, K4
    composites, F.linear proj_out + x."""
    w_in, b_in, lns, a1, a2, ff, w_out, b_out = rest
    BFn, H, W, C = x.shape
    gs, gb, b_in, b_out = _bf(*gn, b_in, b_out, dt=x.dtype)
    block = _lib_spatial_block_fn(ctx, lns, a1, a2, ff, heads, scale, text_len, BFn // ctx.shape[0], x.dtype)

    def run():
        xn = _channels_last(F.group_norm(_channels_first(x), 32, gs, gb, 1e-6))
        h = block(F.linear(xn.reshape(BFn, H * W, C), w_in, b_in))
        return F.linear(h, w_out, b_out).reshape(x.shape) + x
    return run


def _channels_first(x):
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def _channels_last(x):
    return x.permute(0, *range(2, x.ndim), 1)


def _lib_head(x, s, b, wi, bi, temporal):
    """F.group_norm on the channels-first view (statistics included), the
    layout copy to tokens, F.linear."""
    s, b, bi = _bf(s, b, bi, dt=x.dtype)
    C = x.shape[-1]

    def run():
        xn = F.group_norm(_channels_first(x), 32, s, b, 1e-6)
        h = xn.permute(0, 3, 4, 2, 1) if temporal else _channels_last(xn)  # [B,H,W,F,C] / [BF,H,W,C]
        return F.linear(h.reshape(-1, C), wi, bi)
    return run


def _lib_tail(y, x, wo, bo, temporal):
    bo = bo.to(x.dtype)

    def run():
        o = F.linear(y, wo, bo)
        if temporal:
            B, Fn, H, W, C = x.shape
            o = o.reshape(B, H, W, Fn, C).permute(0, 3, 1, 2, 4)
        return o.reshape(x.shape) + x
    return run


def _lib_gn_silu(x, s, b, eps, act):
    """F.group_norm (statistics included) [-> F.silu], back to channels-last."""
    s, b = _bf(s, b, dt=x.dtype)

    def run():
        h = F.group_norm(_channels_first(x), 32, s, b, eps)
        return _channels_last(F.silu(h) if act else h).contiguous()
    return run


def _check(case, got, ref):
    """(max abs error, its tolerance, L2 error, its tolerance, ok)."""
    diff = got.float() - ref.float()
    err = float(diff.abs().max())
    own = ref.float() - (case.base.float() if case.base is not None else 0.0)
    rel = float(diff.norm() / own.norm())
    finite = bool(torch.isfinite(got).all())
    if case.k == "GN":
        tol = TOL_FOLD_REL * float(ref.float().abs().max())
        again = case.run()
        same = bool(torch.equal(again, got))
        return (err, f"{tol:.2e}, bit-exact rerun {same}", rel, TOL_FOLD_REL_L2,
                finite and same and err <= tol and rel <= TOL_FOLD_REL_L2)
    if case.fp32:
        # fp32: kernel and plain differ only in the order of their sums
        tol = TOL_F32 * float(ref.float().abs().max())
        same = bool(torch.equal(case.run(), got))
        return (err, f"{tol:.2e}, bit-exact rerun {same}", rel, TOL_F32,
                finite and same and err <= tol and rel <= TOL_F32)
    if case.k == "K9":
        beyond = _beyond_ulp(got, ref)
        same = bool(torch.equal(case.run(), got))
        return (err, f"1 bf16 ulp, {beyond} beyond, bit-exact rerun {same}", rel, TOL_GN_REL_L2,
                finite and same and beyond == 0 and rel <= TOL_GN_REL_L2)
    tol = TOL_REL * max(1.0, float(ref.float().abs().max()))
    return err, f"{tol:.5f}", rel, TOL_BRANCH_REL_L2, finite and err <= tol and rel <= TOL_BRANCH_REL_L2


def _beyond_ulp(got, ref) -> int:
    """Elements of ``got`` more than one bf16 ulp from ``ref`` (the K9 gate)."""
    r = ref.float()
    return int(((got.float() - r).abs() > TOL_GN_ULP * r.abs() + 1e-6 * float(r.abs().max())).sum())


def _gn_route_bound(plan, x):
    """ms of the least traffic of ``plan``'s route for x: x read once and y
    written once, x read once more on the split route, and on the grid route
    the rows past the blocks' slabs read once more."""
    B, C = x.shape[0], x.shape[-1]
    M = x.numel() // (B * C)
    nbytes = 2 * x.numel() * x.element_size()
    if plan.route == "split":
        nbytes += x.numel() * x.element_size()
    elif plan.route == "grid":
        held = cuda_lib.gn_grid_held(plan, C, 32, x.element_size())
        past = sum(max(0, min(plan.rows, M - q * plan.rows) - held) for q in range(plan.cs))
        nbytes += B * past * C * x.element_size()
    return nbytes / PEAK_BYTES * 1e3


def _gn_plan_desc(plan, C, elem, clusters=None):
    if plan.route == "cluster":
        return f"cluster CS {plan.cs} rows {plan.rows} smem {plan.smem} B, {clusters} clusters at once"
    if plan.route == "grid":
        return (f"grid, {plan.splits} samples a pass of {plan.cs} blocks each ({plan.splits * plan.cs} blocks), "
                f"rows {plan.rows} ({cuda_lib.gn_grid_held(plan, C, 32, elem)} in shared memory) smem {plan.smem} B")
    return f"split, {plan.splits} statistics splits of {plan.rows} rows"


def _gn_route(case, ms, phase="phase 3"):
    """K9 at one shape beside its one-call check: the route of ``gn_plan``
    (blocks a cluster, rows, shared memory, and how many such clusters the
    card holds at once; on the grid route the samples a pass, the blocks and
    the rows a block holds), the statistics it folded against the plain fold
    (within TOL_FOLD_REL, bit-exact on a rerun), the apply kernel alone
    (``gn_silu_apply`` on the plain fold's vectors) against the plain apply
    within one bf16 ulp (fp32: TOL_F32) and bit-exact on a rerun, and the
    times against the route's bound (:func:`_gn_route_bound`) and the
    apply's own (2 x bytes). At fp32 also every route that holds at the
    shape (cluster, grid, split), each forced through ``gn_silu(...,
    plan=)``, held to the fp32 gates, bit-exact on a rerun, and timed: the
    table ``gn_plan``'s fp32 rule is set from. Returns (ok, timings)."""
    x, s, b, eps, act = case.gn
    B, C = x.shape[0], x.shape[-1]
    M = x.numel() // (B * C)
    elem = x.element_size()
    plan = cuda_lib.gn_plan(B, M, C, 32, elem, cuda_lib.sm_count(x.device))
    y, vec = fused_twrap.gn_silu(x, s, b, eps=eps, act=act, vectors=True)
    y2, vec2 = fused_twrap.gn_silu(x, s, b, eps=eps, act=act, vectors=True)
    vec, vec2 = torch.stack(vec), torch.stack(vec2)
    pm, pa = fused_twrap.group_norm_fold_plain(x, s, b, 32, eps)
    pvec = torch.stack([pm, pa])
    verr, vtol = float((vec - pvec).abs().max()), TOL_FOLD_REL * float(pvec.abs().max())
    vrel = float((vec - pvec).norm() / pvec.norm())
    vec_ok = verr <= vtol and vrel <= TOL_FOLD_REL_L2 and torch.equal(vec, vec2) and torch.equal(y, y2)

    def apply():
        return fused_twrap.gn_silu_apply(x, pm, pa, act=act)
    ref = fused_twrap.gn_silu_plain(x, pm, pa, act=act)
    ya = apply()
    arel = float((ya.float() - ref.float()).norm() / ref.float().norm())
    if case.fp32:
        aerr = float((ya - ref).abs().max()) / float(ref.abs().max())
        beyond = f"max err {aerr:.1e} of max|plain| (tol {TOL_F32})"
        within = aerr <= TOL_F32 and arel <= TOL_F32
    else:
        n_beyond = _beyond_ulp(ya, ref)
        beyond, within = f"{n_beyond} beyond 1 bf16 ulp", n_beyond == 0 and arel <= TOL_GN_REL_L2
    apply_ok = bool(torch.isfinite(ya).all()) and torch.equal(ya, apply()) and within
    del y, y2, ya
    apply_ms = _time_ms(apply, 10)
    bound = 2 * x.numel() * elem / PEAK_BYTES * 1e3
    route_bound = _gn_route_bound(plan, x)
    clusters = cuda_lib.gn_clusters(plan, C) if plan.route == "cluster" else None
    print(f"{phase} K9 {case.desc} route: {_gn_plan_desc(plan, C, elem, clusters)}; statistics max err {verr:.2e} "
          f"(tol {vtol:.2e}) rel_l2 {vrel:.1e}, bit-exact rerun {torch.equal(vec, vec2)}; one call {ms:.4f} ms "
          f"against the route bound {route_bound:.4f} ({100 * route_bound / ms:.0f}%); apply kernel alone "
          f"{apply_ms:.4f} ms against {bound:.4f} ({100 * bound / apply_ms:.0f}%), {beyond}, rel_l2 {arel:.1e} "
          f"{'ok' if vec_ok and apply_ok else 'FAIL'}", flush=True)
    if clusters is not None and clusters < 1:
        vec_ok = False
    t = {"apply_ms": apply_ms, "apply_bound_ms": bound, "route_bound_ms": route_bound, f"{plan.route}_calls": 1.0,
         f"{plan.route}_ms": ms, f"{plan.route}_bound_ms": route_bound}
    routes_ok = True
    if case.fp32:
        line = []
        for route in cuda_lib.GN_ROUTES:
            try:
                other = cuda_lib.gn_plan(B, M, C, 32, elem, cuda_lib.sm_count(x.device), route)
            except ValueError:
                continue

            def run(other=other):
                return fused_twrap.gn_silu(x, s, b, eps=eps, act=act, plan=other)
            got = run()
            err = float((got - ref).abs().max()) / float(ref.abs().max())
            rel = float((got - ref).norm() / ref.norm())
            same = torch.equal(got, run())
            ok = bool(torch.isfinite(got).all()) and same and err <= TOL_F32 and rel <= TOL_F32
            del got
            r_ms = _time_ms(run, 10)
            t[f"every_{route}_ms"] = r_ms
            routes_ok = routes_ok and ok
            line.append(f"{route}{' (plan)' if route == plan.route else ''} {r_ms:.4f} ms / "
                        f"{_gn_route_bound(other, x):.4f} (err {err:.1e}, rel_l2 {rel:.1e}, bit-exact {same}"
                        f"{'' if ok else ', FAIL'})")
        print(f"{phase} K9 {case.desc} every route: " + "; ".join(line), flush=True)
    del ref
    return vec_ok and apply_ok and routes_ok, t


def _d(*shape, dt=BF):
    """A recorded argument's description: (shape, dtype)."""
    return tuple(shape), dt


def _block_desc(C):
    """The descriptions of a temporal block's (lns, attn1, attn2, ff)."""
    vec, w = _d(C), _d(C, C)
    attn = (w, w, w, w, vec)
    return (vec,) * 6, attn, attn, (_d(8 * C, C), _d(8 * C), _d(C, 4 * C), vec)


REPAIR = "repair shapes"


def _spatial_desc(C, img, Dc=1024, dt=BF):
    """The descriptions of a spatial block's (lns, attn1, attn2, ff) in
    activation type ``dt``; attn2 with image keys (i2v) or without (t2v)."""
    vec, w = _d(C, dt=dt), _d(C, C, dt=dt)
    attn2 = (w, _d(C, Dc, dt=dt), _d(C, Dc, dt=dt), w, vec) + ((_d(C, Dc, dt=dt), _d(C, Dc, dt=dt)) if img else ())
    return (vec,) * 6, (w, w, w, w, vec), attn2, (_d(8 * C, C, dt=dt), _d(8 * C, dt=dt), _d(C, 4 * C, dt=dt), vec)


# kernels 11 and 13 at shapes no batch-8 override forward gives them (the
# batch-2 forwards run the default plan): (clips, frames, H, W, C, image
# keys): the 40x40 latent's two levels (N 1600 and 400: a ragged last query
# tile), t2v (77 text keys, no image keys), 8 frames a clip (the per-clip
# context index), and the gate's ends N 256 and 4096
SPATIAL_REPAIRS = ((2, 16, 40, 40, 320, True), (2, 16, 20, 20, 640, True), (2, 16, 40, 64, 320, False),
                   (2, 8, 40, 64, 320, True), (2, 16, 16, 16, 320, True), (2, 16, 64, 64, 320, True))


def _repair_cases():
    """Calls, as phase 2 records them, of the clip geometries the repaired
    kernels take and no phase-2 forward gives (the 40x40 and the 8-frame
    forwards give kernel 5 at H*W 100 and 25, K1 at 8 frames): kernel 5 at
    a 384x384 window's deepest level (H*W 36), K1 at 32 frames, kernel 10 at
    8, 32 and 128 frames (a row over a cluster of 2 and of 8 blocks at C
    1280), kernel 12 at 8 and 32 frames; kernels 11 and 13 at
    :data:`SPATIAL_REPAIRS`."""
    f32 = torch.float32

    def opts(C):
        return ("eps", 1e-5), ("heads", C // 64), ("scale", 0.125)
    cases = [("K5", (_d(8, 16, 6, 6, 1280), _d(8, 1280, dt=f32), _d(8, 1280, dt=f32), _d(1280, 1280),
                     _d(1280, dt=f32)), ()),
             ("K1", (_d(2560, 32, 320), _d(320), _d(320), *(_d(320, 320),) * 4, _d(320)), opts(320))]
    cases += [("K10", (_d(R, Fn, C), *_block_desc(C)), opts(C))
              for R, Fn, C in ((2560, 8, 320), (320, 32, 1280), (40, 128, 1280))]
    cases += [("K12", (_d(B, Fn, H, W, C), _d(B, C, dt=f32), _d(B, C, dt=f32), _d(C, C), _d(C), *_block_desc(C),
                       _d(C, C), _d(C)), opts(C))
              for B, Fn, H, W, C in ((2, 8, 40, 64, 320), (1, 32, 20, 32, 640))]
    return {**{case: {REPAIR: 1} for case in cases}, **_spatial_repair_cases()}


def _spatial_repair_cases(dt=BF):
    """Kernels 11 and 13 at :data:`SPATIAL_REPAIRS` in activation type
    ``dt``, as phase 2 records the calls (phases 3 and 10)."""
    f32 = torch.float32
    cases = []
    for clips, Fn, H, W, C, img in SPATIAL_REPAIRS:
        BFn, ctx = clips * Fn, _d(clips, 93 if img else 77, 1024, dt=dt)
        o = (("eps", 1e-5), ("heads", C // 64), ("scale", 0.125), ("text_len", 77))
        cases += [("K11", (_d(BFn, H * W, C, dt=dt), ctx, *_spatial_desc(C, img, dt=dt)), o),
                  ("K13", (_d(BFn, H, W, C, dt=dt), ctx, _d(BFn, C, dt=f32), _d(BFn, C, dt=f32), _d(C, C, dt=dt),
                           _d(C, dt=dt), *_spatial_desc(C, img, dt=dt), _d(C, C, dt=dt), _d(C, dt=dt)), o)]
    return {case: {REPAIR: 1} for case in cases}


# K1's attention at fp32 at frame counts no fp32 forward gives (those run 16
# frames): (rows, F, C) at t640's 81920 tokens, F 8 on the tensor-core body
# (each query's own row of 8 keys, the other row of the 16-token slab masked)
# and F 2, 4, 32, 128 on the CUDA-core body (a row of 128 a whole tile)
TA_F32_REPAIRS = ((10240, 8, 640), (40960, 2, 640), (20480, 4, 640), (2560, 32, 640), (640, 128, 640))


def _ta_f32_repair_cases():
    """TA at fp32 at :data:`TA_F32_REPAIRS`, as K1 records its calls
    (phase 10)."""
    return {("TA", (_d(R, Fn, 3 * C, dt=torch.float32),), (("heads", C // 64), ("scale", 0.125))): {REPAIR: 1}
            for R, Fn, C in TA_F32_REPAIRS}


def _recorded_shapes(sites):
    """(kernel, args, options) -> {run: calls} over the recorded runs."""
    shapes = collections.defaultdict(dict)
    for where, calls in sites.items():
        for key, n in calls.items():
            shapes[key][where] = n
    return shapes


def _time_cases(shapes, runs, phase):
    """Every kernel call of ``shapes`` against its plain version with the
    gates of :func:`_check` (K9 also :func:`_gn_route`; kernels 10-13 their
    tile lines), timed beside its plain version, its library composite and
    its bound, the sums per run of ``runs`` printed. Fails on any
    disagreement. Returns the sums, the largest error and the bound ms by
    limiting resource per kernel, and the tile records of kernels 10-13."""
    rn = _gen()
    sums = {where: {k: collections.Counter() for k in KERNELS} for where in runs}
    max_err = dict.fromkeys(KERNELS, 0.0)
    bound_by = {k: collections.Counter() for k in KERNELS}  # bound ms per limiting resource
    tiles = {"K10": [], "K11": [], "K12": [], "K13": []}  # the tile plan and rate of kernels 10-13 at each shape
    bad = []
    order = list(KERNELS)
    for (k, pos, opts), where_n in sorted(shapes.items(), key=lambda kv: order.index(kv[0][0])):
        case = _case(k, pos, dict(opts), rn)
        got = case.run()
        ref = case.plain()
        lib = case.library()
        torch.cuda.synchronize()
        case.set_bound(got)
        err, tol, rel, tol_l2, ok = _check(case, got, ref)
        lib_rel = (float((lib.float().reshape(ref.shape) - ref.float()).norm() / ref.float().norm())
                   if case.lib_comparable else float("nan"))
        del got, lib
        t = {"ms": _time_ms(case.run, 10), "plain_ms": _time_ms(case.plain, 3),
             "library_ms": _time_ms(case.library, 10), "bound_ms": case.bound_ms,
             "fold_ms": _time_ms(case.fold, 10) if case.fold else 0.0}
        rates = ""
        if case.fp32:  # the bound at the CUDA cores' rate beside the tensor cores' fp32-accurate one
            t["bound_cc_ms"] = case.bound_cc_ms
        if case.fp32 and case.flops:
            rates = (f" {case.flops / t['ms'] / 1e9:.1f} TFLOP/s, {100 * case.bound_ms / t['ms']:.0f}% of the bound, "
                     f"{100 * case.bound_cc_ms / t['ms']:.0f}% of the bound at 67 TFLOP/s "
                     f"{case.bound_cc_ms:.4f} ms")
        print(f"{phase} {k} {case.desc}: max_abs_err {err:.5g} (tol {tol}) rel_l2 {rel:.5g} (tol {tol_l2}) "
              f"kernel {t['ms']:.3f} ms plain {t['plain_ms']:.3f} ms library {t['library_ms']:.3f} ms "
              f"(rel_l2 vs plain {lib_rel:.4f}) bound {case.bound_ms:.4f} ms ({case.bound_by})" + rates
              + (f" group_norm_fold {t['fold_ms']:.3f} ms" if case.fold else "")
              + " [" + ", ".join(f"x{n} per {w}" for w, n in where_n.items()) + f"] {'ok' if ok else 'FAIL'}",
              flush=True)
        if case.f32_tile:
            tile = _block_f32_tile(case, t["ms"], ref)
            tiles[k].append(tile)
            ok = ok and tile["other_tm_ok"]
            print(f"{phase} {k} {case.desc} tile: {_block_f32_line(tile)}", flush=True)
        elif case.block:
            tile, reckoned = _block_tile(case, t["ms"], ref)
            tiles[k].append(tile)
            ok = ok and tile["other_cl_ok"]
            print(f"{phase} {k} {case.desc} tile: {_block_line(tile, reckoned)}", flush=True)
        if case.gn:
            gn_ok, extra = _gn_route(case, t["ms"], phase)
            ok = ok and gn_ok
            t.update(extra)
        if case.spatial:
            tile = _spatial_tile(case, t["ms"])
            tiles[k].append(tile)
            print(f"{phase} {k} {case.desc} tile: plan TM {tile['tm']} stages {tile['stages']} hidden chunk "
                  f"{tile['hc']} smem {tile['smem']} B, no cluster; grid {tile['grid']} blocks; {tile['tflops']:.1f} "
                  f"TFLOP/s ({100 * tile['share_of_989']:.1f}% of 989); kernel {t['ms']:.3f} ms", flush=True)
        del ref
        max_err[k] = max(max_err[k], err)
        for where, n in where_n.items():
            for key, v in t.items():
                sums[where][k][key] += n * v
            bound_by[k][case.bound_by] += n * case.bound_ms
        if not ok:
            bad.append(f"{k} {case.desc}")
        del case
    torch.cuda.empty_cache()
    if bad:
        _fail(f"{phase}: kernel disagrees with its plain version: {bad}")
    for where, per_k in sums.items():
        cc = any(c["bound_cc_ms"] for c in per_k.values())
        print(f"{phase} sums per {where} (ms: kernel / plain / library / bound"
              + (" / bound at 67 TFLOP/s" if cc else "") + "; + group_norm_fold): " + ", ".join(
                  f"{k} {c['ms']:.2f}/{c['plain_ms']:.2f}/{c['library_ms']:.2f}/{c['bound_ms']:.3f}"
                  + (f"/{c['bound_cc_ms']:.3f}" if c["bound_cc_ms"] else "")
                  + (f" + {c['fold_ms']:.2f}" if c["fold_ms"] else "") for k, c in per_k.items() if c), flush=True)
        c = per_k["K9"]
        if c:
            print(f"{phase} K9 per {where}: {c['ms']:.2f} ms against the routes' bound {c['route_bound_ms']:.3f} "
                  f"(function bound {c['bound_ms']:.3f}); " + ", ".join(
                      f"{r} route {c[f'{r}_calls']:.0f} calls {c[f'{r}_ms']:.2f} ms / {c[f'{r}_bound_ms']:.3f}"
                      for r in cuda_lib.GN_ROUTES)
                  + f"; the apply kernel alone {c['apply_ms']:.2f} ms / {c['apply_bound_ms']:.3f}"
                  + ("; every call forced on one route: " + ", ".join(
                      f"{r} {c[f'every_{r}_ms']:.2f} ms" for r in cuda_lib.GN_ROUTES if c[f"every_{r}_ms"])
                     + " (cluster where it holds)" if c["every_grid_ms"] else ""), flush=True)
    return sums, max_err, bound_by, tiles


def _nan_statistics():
    """The statistics' fast variance E[x^2] - mean^2 where it is inf - inf:
    x [2, M, 320] with sample 0's group 0 at 1e20 (x^2 overflows), one inf
    in sample 1's group 3 and sample 1's group 10 constant at 3 (an exact
    zero variance). K9 on every route that holds (``gn_silu(plan=)``), GN
    (``group_norm_fold``) and ``ln_gemm``'s LayerNorm prologue (row 3 at
    1e20), bf16 and fp32: NaN exactly where the plain version is (the two
    groups; the row), every other element within the shape's gates (bf16:
    K9 one ulp but TOL_REL at the constant group, the fold TOL_FOLD_REL, the
    GEMM TOL_REL; fp32: TOL_F32)."""
    g = torch.Generator().manual_seed(19)
    ok = True
    for dt in (BF, F32):
        for M in (1024, 10240):
            x = 2.0 * torch.randn(2, M, 320, generator=g) + 0.5
            x[0, :, :10] = 1e20
            x[1, M // 2, 30] = float("inf")
            x[1, :, 100:110] = 3.0
            x = x.to("cuda", dt)
            s = (1.0 + 0.1 * torch.randn(320, generator=g)).cuda()
            b = (0.1 * torch.randn(320, generator=g)).cuda()
            nan = torch.zeros(2, 320, dtype=torch.bool, device="cuda")
            nan[0, :10], nan[1, 30:40] = True, True
            pm, pa = fused_twrap.group_norm_fold_plain(x, s, b, 32, 1e-5)
            ref = fused_twrap.gn_silu_plain(x, pm, pa)
            fin = ~torch.isnan(ref)
            # the constant group: its apply x * mul + add cancels to about an fp32 ulp of |x * mul| (316 x),
            # in the kernel and in plain alike, so bf16 holds it to TOL_REL of its largest |plain|
            flat = torch.zeros_like(fin)
            flat[1, :, 100:110] = True
            line = []
            for route in cuda_lib.GN_ROUTES:
                try:
                    plan = cuda_lib.gn_plan(2, M, 320, 32, x.element_size(), cuda_lib.sm_count(x.device), route)
                except ValueError:
                    continue
                got = fused_twrap.gn_silu(x, s, b, eps=1e-5, plan=plan)
                same_nan = torch.equal(torch.isnan(got), ~fin) and torch.equal(~fin, nan[:, None].expand_as(fin))
                r, o = ref[fin].float(), got[fin].float()
                err = float((o - r).abs().max()) / float(r.abs().max())
                rf, of = ref[flat].float(), got[flat].float()
                ferr = float((of - rf).abs().max()) / float(rf.abs().max())
                if dt == F32:
                    within = err <= TOL_F32
                else:
                    rest = fin & ~flat
                    within = _beyond_ulp(got[rest].float(), ref[rest].float()) == 0 and ferr <= TOL_REL
                ok = ok and same_nan and within
                line.append(f"K9 {route} NaN where plain {same_nan}, finite max err {err:.1e} (constant group "
                            f"{ferr:.1e}){'' if within else ' FAIL'}")
            vec = torch.stack(fused_twrap.group_norm_fold(x, s, b, 32, 1e-5))
            pvec = torch.stack([pm, pa])
            vnan = torch.equal(torch.isnan(vec), torch.isnan(pvec)) and torch.equal(torch.isnan(pvec[0]), nan)
            verr = float((vec - pvec)[:, ~nan].abs().max()) / float(pvec[:, ~nan].abs().max())
            vok = vnan and verr <= (TOL_F32 if dt == F32 else TOL_FOLD_REL)
            ok = ok and vok
            line.append(f"GN NaN where plain {vnan}, max err {verr:.1e}{'' if vok else ' FAIL'}")
            if M == 1024:
                x2 = x[1, :256].clone()
                x2[3] = 1e20
                w = (torch.randn(640, 320, generator=g) / 320 ** 0.5).to("cuda", dt)
                ln = ((1.0 + 0.1 * torch.randn(320, generator=g)).cuda(), (0.1 * torch.randn(320, generator=g)).cuda())
                got, r = cuda_lib.ln_gemm(x2, w, ln=ln), cuda_lib.ln_gemm_plain(x2, w, ln=ln)
                rnan = torch.zeros(256, dtype=torch.bool, device="cuda")
                rnan[3] = True
                lnan = torch.equal(torch.isnan(got), torch.isnan(r)) and torch.equal(torch.isnan(r).all(1), rnan) \
                    and not bool(torch.isnan(r[~rnan]).any())
                lerr = float((got[~rnan] - r[~rnan]).abs().max()) / float(r[~rnan].abs().max())
                lok = lnan and lerr <= (TOL_F32 if dt == F32 else TOL_REL)
                ok = ok and lok
                line.append(f"ln_gemm NaN row where plain {lnan}, max err {lerr:.1e}{'' if lok else ' FAIL'}")
            print(f"phase 3 NaN statistics {str(dt)[6:]} [2, {M}, 320]: " + "; ".join(line), flush=True)
    if not ok:
        _fail("phase 3: a kernel's statistics did not give NaN where its plain version does")


KEYS = ("ms", "plain_ms", "bound_ms", "library_ms")


def _record(k, main, max_err, bound_by, per):
    """Kernel ``k``'s figures for the kernels line: the sums ``main`` over
    the forward ``per``."""
    return {"max_abs_err": max_err[k], **{key: main[key] for key in KEYS},
            "bound_by": bound_by[k].most_common(1)[0][0], "fold_ms": main["fold_ms"] if "mul" in ROLES[k] else None,
            "per": per}


def _phase_kernels(sites, cfg):
    """Phase 3: every kernel against its plain version at every shape that
    phase 2 recorded and at :func:`_repair_cases` (:func:`_time_cases`);
    then the GEMM table and the transformer levels (:func:`_phase_levels`).
    Returns, per kernel, the largest error and the kernel, plain, library,
    bound and fold ms summed over one forward: the batch-2 t2v forward, else
    the first batch-8 i2v forward in which the kernel runs ("per"), with the
    same sums over every phase-2 forward that runs it."""
    shapes = _recorded_shapes(sites)
    for key, runs in _repair_cases().items():
        shapes[key] = {**shapes.get(key, {}), **runs}
    sums, max_err, bound_by, tiles = _time_cases(shapes, (*sites, REPAIR), "phase 3")
    _phase_gemms(GEMM_SITES[I2V_FWD])
    _phase_levels(cfg)
    _nan_statistics()
    print("phase 3 ok", flush=True)
    records = {}
    for k in KERNELS:
        ran = [w for w in FORWARDS if sums[w][k]]
        if not ran:
            _fail(f"{k} ran in none of the phase-2 forwards")
        main = sums[ran[0]][k]
        records[k] = {**_record(k, main, max_err, bound_by, ran[0]),
                      "sums_by_forward": {w: {key: sums[w][k][key] for key in KEYS + ("fold_ms",)} for w in ran}}
        if k in tiles:
            records[k]["tiles"] = tiles[k]
        if k == "K9":
            records[k].update({key: main[key] for key in (
                "apply_ms", "apply_bound_ms", "route_bound_ms", "cluster_calls", "cluster_ms", "cluster_bound_ms",
                "split_calls", "split_ms", "split_bound_ms")})
    return records


def _block_tile(case, ms, ref):
    """Kernel 10 / 12 at one shape: the tile plan (cuda_lib.block_plan), how
    many of its clusters the card holds at once, the tensor-core rate and
    its share of the 989 TFLOP/s peak; where a row lies in one block, the
    kernel also at the other cluster size (CL 1, each block alone on its
    weights, against CL 2, each weight tile multicast to two blocks): its
    output held to the plain version's gates, and both timed in turn
    (plan, other, other, plan; ``ms_by_cl``). Returns the record and, for
    the tile line only, the weight bytes a launch reads from L2 at each
    timed CL as this design reckons them (once per cluster; no counter
    reads them)."""
    T, C, Fn, mega = case.block
    plan = cuda_lib.block_plan(C, Fn, mega)
    grid = cuda_lib.block_grid(plan, T)
    wbytes = (20 + 2 * mega) * C * C * 2
    rate = case.op_ms / ms * PEAK_BF16 / 1e12
    rec = {"shape": case.desc, **plan._asdict(), "grid": grid, "clusters_at_once": cuda_lib.block_clusters(plan, mega),
           "tflops": rate, "share_of_989": rate * 1e12 / PEAK_BF16, "ms_by_cl": {plan.cl: ms}, "other_cl_ok": True}
    if Fn <= plan.tm:
        other = plan._replace(cl=2 if plan.cl == 1 else 1)
        err, tol, rel, tol_l2, ok = _check(case, case.run_at(other), ref)
        times = {plan.cl: [], other.cl: []}
        for p in (plan, other, other, plan):
            times[p.cl].append(_time_ms(lambda: case.run_at(p), 10))
        rec.update(ms_by_cl={cl: sum(v) / len(v) for cl, v in sorted(times.items())}, other_cl_ok=ok,
                   other_cl_max_abs_err=err, other_cl_rel_l2=rel,
                   other_cl_clusters_at_once=cuda_lib.block_clusters(other, mega))
    reckoned = {cl: wbytes * cuda_lib.block_grid(plan._replace(cl=cl), T) // cl / 1e9 for cl in rec["ms_by_cl"]}
    return rec, reckoned


def _temporal_f32_tile(C, Fn, T, mega):
    """Kernel 10 / 12 at fp32: (cuda_lib.block_f32_plan's tile, the other TM
    where it holds whole rows of Fn frames, else None, the grid at a tile)."""
    plan = cuda_lib.block_f32_plan(C, Fn, T, mega)
    other = cuda_lib.BlockF32Plan(64 if plan.tm == 128 else 128)
    return plan, None if T % other.tm or other.tm % Fn else other, lambda p: cuda_lib.block_f32_grid(p, T)


def _block_f32_tile(case, ms, ref):
    """Kernels 10-13 at fp32 at one shape: the tile plan (TM:
    cuda_lib.block_f32_plan, spatial_f32_plan), grid, the tensor-core rate
    (the fp32 products over the measured ms) and the share of each bound
    (3xTF32 and the CUDA cores' 67 TFLOP/s); the kernel also at the other
    tile (TM 128 against 64), its output held to the plain version's gates
    and bit-exact on rerun, both timed in turn (plan, other, other, plan;
    ``ms_by_tm``)."""
    plan, other, grid = case.f32_tile
    if other is None:
        return {"shape": case.desc, **plan._asdict(), "grid": grid(plan),
                "tflops": case.flops / ms / 1e9, "share_of_bound": case.bound_ms / ms,
                "share_of_bound_67": case.bound_cc_ms / ms, "ms": ms, "ms_by_tm": {plan.tm: ms}, "other_tm_ok": True}
    got = case.run_at(other)
    err, tol, rel, tol_l2, ok = _check(case, got, ref)
    ok = ok and torch.equal(got, case.run_at(other))
    del got
    times = {plan.tm: [], other.tm: []}
    for p in (plan, other, other, plan):
        times[p.tm].append(_time_ms(lambda: case.run_at(p), 5))
    return {"shape": case.desc, **plan._asdict(), "grid": grid(plan),
            "tflops": case.flops / ms / 1e9, "share_of_bound": case.bound_ms / ms,
            "share_of_bound_67": case.bound_cc_ms / ms, "ms": ms,
            "ms_by_tm": {tm: sum(v) / len(v) for tm, v in sorted(times.items())}, "other_tm": other.tm,
            "other_tm_ok": ok, "other_tm_max_abs_err": err, "other_tm_rel_l2": rel}


def _block_f32_line(r):
    other = (f" (TM {r['other_tm']}: max_abs_err {r['other_tm_max_abs_err']:.3g} rel_l2 {r['other_tm_rel_l2']:.3g}, "
             f"bit-exact on rerun {'ok' if r['other_tm_ok'] else 'FAIL'})" if "other_tm" in r else
             " (TM 64 does not hold whole rows of these frames)")
    return (f"plan TM {r['tm']} (BN 128, 4 stages); grid {r['grid']} blocks; "
            f"{r['tflops']:.1f} TFLOP/s of fp32 products, {100 * r['share_of_bound']:.0f}% of the 3xTF32 bound, "
            f"{100 * r['share_of_bound_67']:.0f}% of the bound at 67 TFLOP/s; timed: "
            + "; ".join(f"TM {tm} {ms:.3f} ms" for tm, ms in r["ms_by_tm"].items()) + other)


def _spatial_tile(case, ms):
    """Kernel 11 / 13 at one shape: its tile plan (cuda_lib.spatial_plan),
    grid, and tensor-core rate (the bf16 operations the function needs over
    the measured ms) and its share of the 989 TFLOP/s peak."""
    samples, N, C = case.spatial
    plan = cuda_lib.spatial_plan(C)
    rate = case.op_ms / ms * PEAK_BF16 / 1e12
    return {"shape": case.desc, **plan._asdict(), "grid": cuda_lib.spatial_grid(plan, samples, N), "tflops": rate,
            "share_of_989": rate * 1e12 / PEAK_BF16, "ms": ms}


def _block_line(r, reckoned):
    by_cl = "; ".join(f"CL {cl} {ms:.3f} ms" for cl, ms in r["ms_by_cl"].items())
    other = (f" (CL {'2' if r['cl'] == 1 else '1'}: max_abs_err {r['other_cl_max_abs_err']:.5f} rel_l2 "
             f"{r['other_cl_rel_l2']:.5f} {'ok' if r['other_cl_ok'] else 'FAIL'}, "
             f"{r['other_cl_clusters_at_once']} clusters at once)" if "other_cl_rel_l2" in r else
             " (CL fixed by a row over F / TM blocks)")
    return (f"plan TM {r['tm']} CL {r['cl']} stages {r['stages']} heads/group {r['hg']} hidden chunk {r['hc']} "
            f"smem {r['smem']} B; grid {r['grid']} blocks, {r['clusters_at_once']} clusters at once "
            f"(cudaOccupancyMaxActiveClusters); {r['tflops']:.1f} TFLOP/s ({100 * r['share_of_989']:.1f}% of 989); "
            f"timed: {by_cl}{other}; L2 weight bytes a launch, reckoned, not measured: "
            + ", ".join(f"CL {cl} {gb:.2f} GB" for cl, gb in reckoned.items()))


def _gemm_case(key, rn, dt=BF):
    """Inputs of a recorded ds_ln_gemm call in activation type ``dt``: x (a
    GroupNorm or LayerNorm input where there is a prologue), w [N, K] /
    sqrt(K), fp32 bias and prologue vectors, a residual."""
    (M, K), (N, _), pro, rps, fmap, has_bias, mode = key
    x = (2 * rn(M, K) + 0.5 if pro != "-" else rn(M, K)).to(dt)
    w = (rn(N, K) / K ** 0.5).to(dt)
    kw = dict(mode=mode, frame_map=fmap)
    if has_bias:
        kw["bias"] = rn(N, s=0.1)
    if pro == "LN":
        kw["ln"] = (1.0 + rn(K, s=0.1), rn(K, s=0.1))
    if pro == "GN":
        kw.update(gn=(1.0 + rn(M // rps, K, s=0.1), rn(M // rps, K, s=0.1)), rows_per_sample=rps)
    if mode == cuda_lib.MODE_RESIDUAL:
        kw["residual"] = rn(M, N).to(dt)
    return x, w, kw


MODE_NAMES = {cuda_lib.MODE_STORE: "store", cuda_lib.MODE_RESIDUAL: "+residual", cuda_lib.MODE_GEGLU: "GEGLU"}


@contextlib.contextmanager
def _gemm_f32_block_n(block_n):
    """ds_ln_gemm_f32 at the other column width of its planner (the ring
    stages as the planner gives them at that width), inside the block."""
    plan = cuda_lib.gemm_f32_tile
    cuda_lib.gemm_f32_tile = lambda M, K, N, mode=cuda_lib.MODE_STORE: plan(M, K, N, mode, block_n=block_n)
    try:
        yield
    finally:
        cuda_lib.gemm_f32_tile = plan


@contextlib.contextmanager
def _gemm_schedule(schedule, block_n=None):
    """ds_ln_gemm on one schedule (at the column width and ring stages the
    planner gives it there, or at ``block_n``), inside the block."""
    plan = cuda_lib.gemm_tile
    cuda_lib.gemm_tile = lambda M, K, N, mode=cuda_lib.MODE_STORE: plan(M, K, N, mode, schedule=schedule,
                                                                         block_n=block_n)
    try:
        yield
    finally:
        cuda_lib.gemm_tile = plan


# The planner's cost table before the 160-column widths (cooperative 320,
# ping-pong 160) were added, for the parent's pick beside the planner's
def _parent_pick(M, K, N, mode):
    """(schedule, BN) that gemm_tile chose among cooperative 64 / 128 / 256
    and ping-pong 128 with its cost table of then."""
    table = {("cooperative", 256): (0.01302, (4.785, 14.04, 4.717)),
             ("cooperative", 128): (0.00798, (2.518, 6.964, 2.498)),
             ("cooperative", 64): (0.00568, (1.437, 3.895, 1.388)),
             ("pingpong", 128): (0.0094, (5.596, 7.905, 6.634))}

    def cost(c):
        per_k, per_tile = table[c]
        products, epilogue = K * per_k, per_tile[mode]
        tile = max(products, (products + epilogue) / 2) if c[0] == "pingpong" else products + epilogue
        return -(-(-(-M // cuda_lib.GEMM_BM)) * cuda_lib.gemm_n_tiles(N, c[1], mode) // cuda_lib.GEMM_SMS) * tile
    return min((c for c in table if mode != cuda_lib.MODE_GEGLU or (N // 2) % (c[1] // 2) == 0), key=cost)


def _prologue_ms(x, w, kw, ms):
    """The LayerNorm / GroupNorm prologue pass's share of a ds_ln_gemm call
    that took ``ms``: less the same GEMM on an A of x's shape without the
    prologue (unmapped: a frame map's TMA box reads the same bytes), so the
    difference is the pass's launch, read of X and write of A."""
    bare = {k: v for k, v in kw.items() if k not in ("ln", "gn", "rows_per_sample", "frame_map")}
    return ms - _time_ms(lambda: cuda_lib.ln_gemm(x, w, **bare), 10)


def _phase_gemms(calls, dt=BF, phase="phase 3", where=None):
    """The GEMM table: every distinct ds_ln_gemm call of a batch-8 i2v
    forward against ln_gemm_plain, bf16 (``calls`` of the phase-2 forward)
    or fp32 (``ds_ln_gemm_f32``, the phase-10 forward's). Gates: in bf16 max
    error within TOL_REL of max|plain|, L2 error within TOL_BRANCH_REL_L2 of
    the op's own output (plain - residual in mode 1); in fp32 within TOL_F32
    of max|plain| and TOL_F32 in L2, and bit-exact on a rerun. Per shape
    kernel ms (the prologue passes included), TFLOP/s and share of the peak
    (bf16: 989; fp32: the bound at 494.7 / 3 TFLOP/s and the one at the CUDA
    cores' 67), bound (the larger of 2MNK over the peak and the bytes over
    the HBM rate: inputs read once, the output written once), F.linear on
    the same operands (fp32: TF32 off), and in fp32 the plain version's ms
    and the kernel at the planner's other column width. In bf16 also the
    parent's pick (:func:`_parent_pick`: the widths before the 160-column
    products) and its ms, each schedule's tile and ms (the planner's choice
    marked), both held to the gates, every (schedule, BN) the shape admits
    held to cooperative BN 128's output bit for bit, and the prologue pass's
    own ms (:func:`_prologue_ms`). Then the sums per forward (calls x ms;
    bf16: the planner's and the parent's picks, and the forward's launches
    by (schedule, BN)) and the compute-bound shapes with M >= 20480 and K, N
    >= 640 below 40% of the peak."""
    rn = _gen()
    fp32 = dt == F32
    peak = PEAK_TF32X3 if fp32 else PEAK_BF16
    where = where or (FP32_I2V if fp32 else I2V_FWD)
    bad, low = [], []
    tot, widths = collections.Counter(), collections.Counter()
    for key, n in sorted(calls.items(), key=lambda kv: -kv[0][0][0] * kv[0][0][1] * kv[0][1][0]):
        (M, K), (N, _), pro, rps, fmap, has_bias, mode = key
        x, w, kw = _gemm_case(key, rn, dt)
        got = cuda_lib.ln_gemm(x, w, **kw)
        ref = cuda_lib.ln_gemm_plain(x, w, **kw)
        torch.cuda.synchronize()
        diff = got.float() - ref.float()
        err = float(diff.abs().max())
        own = ref.float() - (kw["residual"].float() if mode == cuda_lib.MODE_RESIDUAL else 0.0)
        rel = float(diff.norm() / own.norm())
        if fp32:
            tol, tol_l2 = TOL_F32 * float(ref.abs().max()), TOL_F32
            same = bool(torch.equal(cuda_lib.ln_gemm(x, w, **kw), got))
        else:
            tol, tol_l2, same = TOL_REL * max(1.0, float(ref.float().abs().max())), TOL_BRANCH_REL_L2, True
        ok = bool(torch.isfinite(got).all()) and err <= tol and rel <= tol_l2 and same
        ins = [x, w, got, kw.get("bias"), kw.get("residual"), *(kw.get("ln") or ()), *(kw.get("gn") or ())]
        nbytes = sum(t.numel() * t.element_size() for t in ins if t is not None)
        ref_f, own_norm = ref.float(), own.norm()
        del got, ref, diff, own
        flops = 2 * M * N * K
        op_ms, byte_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(op_ms, byte_ms)
        ms = _time_ms(lambda: cuda_lib.ln_gemm(x, w, **kw), 10)
        lib_ms = _time_ms(lambda: F.linear(x, w), 10)
        share = flops / (ms * 1e-3) / peak
        tile = (cuda_lib.gemm_f32_tile if fp32 else cuda_lib.gemm_tile)(M, K, N, mode)
        line = (f"{phase} gemm M={M} K={K} N={N} {pro} {MODE_NAMES[mode]}"
                + (f" rows/sample {rps}" if pro == "GN" else "") + (f" map {fmap}" if fmap else "")
                + f" x{n} per forward: tile {'' if fp32 else tile.schedule + ' '}128x{tile.block_n}x{tile.stages} ")
        if fp32:
            line += (f"max_abs_err {err:.5g} (tol {tol:.5g}, bit-exact rerun {same}) rel_l2 {rel:.5g} (tol {tol_l2}) "
                     f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {100 * bound / ms:.1f}% of the bound) "
                     f"bound {bound:.4f} ms ({'bytes' if byte_ms >= op_ms else 'operations'}) F.linear {lib_ms:.3f} ms")
        else:
            line += (f"max_abs_err {err:.5f} (tol {tol:.5f}) rel_l2 {rel:.5f} (tol {tol_l2}) kernel {ms:.3f} ms "
                     f"({flops / ms / 1e9:.0f} TFLOP/s, {100 * share:.1f}% of 989) bound {bound:.4f} ms "
                     f"({'bytes' if byte_ms >= op_ms else 'operations'}) F.linear {lib_ms:.3f} ms")
        if not fp32:
            scheds = []
            for sched in cuda_lib.GEMM_BLOCK_N:
                with _gemm_schedule(sched):
                    t = cuda_lib.gemm_tile(M, K, N, mode)
                    out = cuda_lib.ln_gemm(x, w, **kw)
                    torch.cuda.synchronize()
                    d = out.float() - ref_f
                    if not (bool(torch.isfinite(out).all()) and float(d.abs().max()) <= tol
                            and float(d.norm() / own_norm) <= tol_l2):
                        ok = False
                    sched_ms = _time_ms(lambda: cuda_lib.ln_gemm(x, w, **kw), 10)
                tot[sched] += n * sched_ms
                scheds.append(f"{sched} 128x{t.block_n}x{t.stages} {sched_ms:.3f} ms"
                              + (" (chosen)" if sched == tile.schedule else ""))
            del out, d
            # every width the shape admits against cooperative BN 128, bit for bit
            with _gemm_schedule("cooperative", 128):
                base = cuda_lib.ln_gemm(x, w, **kw)
            differ = []
            for sched, bns in cuda_lib.GEMM_BLOCK_N.items():
                for bn in bns:
                    if mode == cuda_lib.MODE_GEGLU and (N // 2) % (bn // 2):
                        continue
                    with _gemm_schedule(sched, bn):
                        if not torch.equal(cuda_lib.ln_gemm(x, w, **kw), base):
                            differ.append(f"{sched} {bn}")
            ok = ok and not differ
            del base
            par = _parent_pick(M, K, N, mode)
            with _gemm_schedule(*par):
                par_ms = _time_ms(lambda: cuda_lib.ln_gemm(x, w, **kw), 10)
            tot["parent"] += n * par_ms
            widths[tile.schedule, tile.block_n] += n
            pro_ms = _prologue_ms(x, w, kw, ms) if pro != "-" else 0.0
            tot["prologue"] += n * pro_ms
            line += (f"; parent's pick {par[0]} 128x{par[1]} {par_ms:.3f} ms ({ms / par_ms - 1:+.1%} chosen against it)"
                     f"; {', '.join(scheds)}; every width equal to cooperative 128 bit for bit: "
                     + ("yes" if not differ else f"NO: {differ}")
                     + (f"; prologue pass {pro_ms:.4f} ms" if pro != "-" else ""))
        if fp32:
            other = 64 if tile.block_n == 128 else 128
            legal = mode != cuda_lib.MODE_GEGLU or (N // 2) % (other // 2) == 0
            with _gemm_f32_block_n(other):
                other_ms = _time_ms(lambda: cuda_lib.ln_gemm(x, w, **kw), 10) if legal else float("nan")
            plain_ms = _time_ms(lambda: cuda_lib.ln_gemm_plain(x, w, **kw), 3)
            bound_cc = max(flops / PEAK_FP32 * 1e3, byte_ms)
            line += (f" plain {plain_ms:.3f} ms; bound at 67 TFLOP/s {bound_cc:.4f} ms "
                     f"({100 * bound_cc / ms:.1f}%); at BN {other} {other_ms:.3f} ms")
            tot["plain"] += n * plain_ms
            tot["bound_cc"] += n * bound_cc
        del ref_f
        print(line + f" {'ok' if ok else 'FAIL'}", flush=True)
        tot["ms"] += n * ms
        tot["lib"] += n * lib_ms
        tot["bound"] += n * bound
        tot["calls"] += n
        if not ok:
            bad.append(str(key))
        if op_ms > byte_ms and M >= 20480 and K >= 640 and N >= 640 and share < 0.4:
            low.append(f"M={M} K={K} N={N} {pro} {MODE_NAMES[mode]} {100 * share:.1f}%")
        del x, w, kw
    torch.cuda.empty_cache()
    print(f"{phase} gemm sums per {where} ({tot['calls']} calls, {len(calls)} shapes): kernel {tot['ms']:.2f} ms, "
          f"F.linear {tot['lib']:.2f} ms, bound {tot['bound']:.2f} ms"
          + (f", plain {tot['plain']:.2f} ms, bound at 67 TFLOP/s {tot['bound_cc']:.2f} ms" if fp32 else
             f", the parent's picks {tot['parent']:.2f} ms"
             + "".join(f", {sched} alone {tot[sched]:.2f} ms" for sched in cuda_lib.GEMM_BLOCK_N)
             + f", of the kernel the prologue passes {tot['prologue']:.2f} ms; launches by width "
             + ", ".join(f"{s} {bn}: {k}" for (s, bn), k in sorted(widths.items()))
             + f" ({sum(k for (_, bn), k in widths.items() if bn in (160, 320))} of {tot['calls']} on 160-column"
             " products)")
          + f"; compute-bound shapes with M >= 20480, K, N >= 640 below 40% of "
          + ("the bound" if fp32 else "989 TFLOP/s") + f": {low or 'none'}", flush=True)
    if bad:
        _fail(f"{'ds_ln_gemm_f32' if fp32 else 'ds_ln_gemm'} disagrees with ln_gemm_plain at {bad}")


# the ladder's levels, highest first
LEVEL_NAMES = ("mega", "wrap+blk", "wrap+sub")


def _level_module(side, C, inner, heads, H, W, B=8, Fn=16, L=93, Dc=1024, dtype=BF):
    """The UNet's transformer at (side, C, inner) with random weights in
    ``dtype`` and a call of it at the batch-B forward's shape; init_attn
    (inner != C) has Conv1d projections."""
    from dynamicscaler_tpu_torch.models.lvdm import init_module_random
    from dynamicscaler_tpu_torch.models.unet3d import SpatialTransformer, TemporalTransformer

    g = torch.Generator(device=DEV).manual_seed(4)
    with torch.device(DEV):
        m = (TemporalTransformer(C, heads, 64, use_linear=inner == C) if side == "t" else
             SpatialTransformer(C, heads, 64, context_dim=Dc, img_cross_attention=True, text_context_len=77))
    init_module_random(m, g)
    m.to(dtype).eval()
    x = torch.randn((B * Fn, H, W, C), generator=g, device=DEV).to(dtype)
    if side == "t":
        return lambda: m(x, Fn)
    ctx = torch.randn((B, L, Dc), generator=g, device=DEV).to(dtype).repeat_interleave(Fn, dim=0)
    return lambda: m(x, ctx, Fn)


def _legal_levels(side, C, inner, heads, H, W, Dc=1024):
    """The levels the transformer at this shape can run: mega where the
    transformer's gate admits it, wrap+blk where the block's does, and
    wrap+sub."""
    if side == "t":
        gates = (fused_mega.temporal_ok(16, C, inner, heads), fused_block.temporal_block_ok(16, inner, inner, heads))
    else:
        gates = (fused_mega.spatial_ok(H * W, C, inner, heads, Dc),
                 fused_block.spatial_block_ok(H * W, inner, inner, heads, Dc))
    return [lvl for lvl, ok in zip(LEVEL_NAMES, (*gates, True)) if ok]


def _phase_levels(cfg, dtype=BF, sides=("t", "s"), phase="phase 3", hw=(40, 64)):
    """The plan levels (phase 3 in bf16; phase 10 in fp32): the transformer
    module in ``dtype`` at every legal level at every
    (side, width) of ``sides`` in the batch-8 i2v forward (the width of
    init_attn its block's, 512), CUDA events, the GroupNorm fold included.
    Prints each shape's times, the per-forward sums of each plan key (its
    shapes' calls x ms per call), the fastest plan by those sums, and
    whether the type's table (PLAN_DEFAULT in bf16, PLAN_DEFAULT_F32 in
    fp32) still names each key's fastest level (a key where another level
    was faster by more than 5% is named)."""
    shapes = collections.Counter(sh for sh in unet_transformers(cfg, *hw) if sh[0] in sides)
    sums = collections.defaultdict(collections.Counter)  # plan key -> level -> ms per forward
    for (side, C, inner, heads, H, W), calls in sorted(shapes.items()):
        call = _level_module(side, C, inner, heads, H, W, dtype=dtype)
        t = {}
        with torch.inference_mode():
            for lvl in _legal_levels(side, C, inner, heads, H, W):
                with _plan({(side, inner): lvl}):
                    t[lvl] = _time_ms(call, 5)
        del call
        for lvl, ms in t.items():
            sums[(side, inner)][lvl] += calls * ms
        print(f"{phase} level {side}{inner} [128,{H},{W},{C}] {str(dtype)[6:]} x{calls} per forward: "
              + ", ".join(f"{lvl} {ms:.3f} ms" for lvl, ms in t.items()) + f"; fastest {min(t, key=t.get)}",
              flush=True)
    torch.cuda.empty_cache()
    # a level must be legal at every shape of its key to be chosen for it
    fastest, beaten = {}, []
    name = "PLAN_DEFAULT_F32" if dtype == torch.float32 else "PLAN_DEFAULT"
    table = getattr(fused_temporal, name)
    for key, per in sorted(sums.items()):
        legal = {lvl: ms for lvl, ms in per.items()
                 if all(lvl in _legal_levels(*sh) for sh in shapes if (sh[0], sh[2]) == key)}
        best = fastest[key] = min(legal, key=legal.get)
        have = table.get(key, "wrap+sub")
        if legal.get(have, float("inf")) > 1.05 * legal[best]:
            beaten.append(f"{key[0]}{key[1]} ({best} {legal[best]:.2f} ms vs {name}'s {have} "
                          f"{legal.get(have, float('nan')):.2f} ms per forward)")
    print(f"{phase} levels per i2v batch-8 forward in {str(dtype)[6:]} (ms): " + ", ".join(
        f"{s}{c} " + "/".join(f"{lvl} {ms:.2f}" for lvl, ms in per.items()) for (s, c), per in sorted(sums.items())),
        flush=True)
    print(f"{phase} fastest plan in {str(dtype)[6:]}: "
          + json.dumps({f"{s}{c}": lvl for (s, c), lvl in fastest.items()}), flush=True)
    print(f"{phase} plan in {str(dtype)[6:]}: " + (f"{name} names the fastest level at every shape (within 5%)"
                                                   if not beaten else f"{name} is beaten by more than 5% at "
                                                   + "; ".join(beaten)), flush=True)


# ---------------------------------------------------------------------------
# phases 4 and 5: the two sampler paths
# ---------------------------------------------------------------------------


def _check_per_forward(where, launches, n_fwd, cfg):
    """Every UNet kernel launched exactly its per-forward count under the
    current plan (:func:`expected_launches` at the 40x64 latent) times the
    run's UNet forwards (gn_silu and the GroupNorm statistics aside: the VAE
    launches them too, so they must have launched at least the UNet's)."""
    per = expected_launches(cfg, 40, 64)
    want = {k: n * n_fwd for k, n in per.items() if k not in VAE_KERNELS}
    got = {k: launches[k] for k in want}
    if got != want or any(launches[k] < per[k] * n_fwd for k in VAE_KERNELS):
        _fail(f"{where}: launches {launches} over {n_fwd} UNet forwards, expected {want} and at least "
              f"{ {k: per[k] * n_fwd for k in VAE_KERNELS} }")


def _phase_sampler(model, steps):
    """Phase 4: a one-step warm-up request, then two requests through the
    t2v shift-window sampler, timed warm."""
    from dynamicscaler_tpu_torch.pipelines import t2v

    gen = torch.Generator(device=DEV).manual_seed(11)
    probe = _Probe(model, [(model, "apply_unet", "unet")])

    def request(prompt, n_steps):
        """One request; returns (video, sampling s/step, decode s)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, den = t2v.sample_shift_multi_windows(
            model, prompt, num_windows_w=2, height=320, width=512, frames=16, fps=16,
            guidance_scale=7.5, num_inference_steps=n_steps, loop_step=n_steps, generator=gen,
            decode=False,
        )
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        video = model.decode_video_chunked(den, frame_chunk=4)
        torch.cuda.synchronize()
        return video, (t1 - t0) / n_steps, time.perf_counter() - t1

    _, cold, cold_decode = request("warm-up", 1)
    prompts = ["a snowy mountain village at dusk, panorama", "waves rolling onto a tropical beach, panorama"]
    _reset_launches()
    probe.stats.clear()
    timings = []
    for p in prompts:
        video, per_step, decode_s = request(p, steps)
        shape = tuple(video.shape)
        finite = bool(torch.isfinite(video).all())
        print(f"phase 4: request {p!r}: video {shape} finite {finite} |video| mean "
              f"{float(video.abs().mean()):.4f} sampling {per_step:.3f} s/step "
              f"decode {decode_s:.2f} s", flush=True)
        if shape != (1, 16, 320, 1024, 3) or not finite:
            _fail(f"bad video {shape} finite={finite}")
        timings.append(per_step)
        del video
    launches = _launches()
    print(f"phase 4 ok: {len(prompts)} warm requests, {sum(timings) / len(timings):.3f} s/step mean "
          f"(cold one-step warm-up request {cold:.3f} s/step, decode {cold_decode:.2f} s), "
          f"kernel launches {launches}", flush=True)
    _check_per_forward("t2v path", launches, probe.stats["unet calls"], model.unet.cfg)
    return launches


def smooth_panorama(h, w, seed):
    """A smooth seeded [h, w, 3] panorama image in [-1, 1] that wraps in w."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 2 * np.pi, w, endpoint=False), indexing="ij")
    img = np.stack([np.sin(xx * k + p) * np.cos(yy * 3 + p)
                    for k, p in zip((1, 2, 3), rng.uniform(0, 6, 3))], -1)
    return (0.8 * img + 0.05 * rng.standard_normal(img.shape)).clip(-1, 1).astype(np.float32)


class _Probe:
    """Seconds (synchronised) and gn_silu launches spent inside some of the
    model's methods, per label; installed on the model instance."""

    def __init__(self, model, methods):
        self.stats = collections.Counter()
        self._saved = [(obj, name, getattr(obj, name)) for obj, name, _ in methods]
        for obj, name, label in methods:
            setattr(obj, name, self._wrap(getattr(obj, name), label))

    def remove(self):
        """Put the wrapped methods back."""
        for obj, name, fn in reversed(self._saved):
            setattr(obj, name, fn)

    def _wrap(self, fn, label):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), fused_twrap.gn_silu.launches
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.stats[label + " calls"] += 1
            self.stats[label + " s"] += time.perf_counter() - t0
            self.stats[label + " gn_silu"] += fused_twrap.gn_silu.launches - n0
            return out
        return wrapped


# phase 5's request: stage 2 of gen_pano_360 (512x1024x16, 2x2 windows of 320x512, UNet batch 8)
STAGE2_KW = dict(total_w=1024, total_h=512, total_f=16, num_windows_w=2, num_windows_h=2, loop_step=16, height=320,
                 width=512, frames=16, fps=8, guidance_scale=7.5, num_inference_steps=48, use_skip_time=True,
                 unet_microbatch=8, decode=True)
STAGE2_PROMPT = "a panoramic mountain lake at sunrise"


def _phase_i2v_sampler(model, steps):
    """Phase 5: stage 2 of gen_pano_360 on the i2v sampler at full width: a
    one-step warm-up request, one timed request of ``steps`` steps under the
    default plan, then one under "off" (kernel 12 at the temporal
    transformers of C 320 / 640, kernel 13 at the spatial ones). Returns the
    launches of the two timed requests."""
    from dynamicscaler_tpu_torch.pipelines import i2v

    pano = smooth_panorama(512, 1024, seed=5)
    probe = _Probe(model, [(model, "encode_text", "conditioning"), (model, "encode_image_cond", "conditioning"),
                           (model, "encode_video", "encode"), (model, "decode_video", "decode"),
                           (model, "apply_unet", "unet")])
    gen = torch.Generator(device=DEV).manual_seed(13)

    def request(n_steps):
        probe.stats.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video, _ = i2v.sample_shift_multi_windows(model, STAGE2_PROMPT, pano, skip_time_step_idx=48 - n_steps,
                                                  generator=gen, **STAGE2_KW)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        st = collections.Counter(probe.stats)
        sampling = total - st["conditioning s"] - st["encode s"] - st["decode s"]
        return video, total, sampling / n_steps, st

    _, cold_total, cold_step, _ = request(1)
    out, per_step_by_plan = [], {}
    for spec in (None, "off"):
        plan = spec or "default"
        with _plan(spec):
            _reset_launches()
            video, total, per_step, st = request(steps)
            launches = _launches()
            i2v_k3 = fused_spatial.fused_ln_cross_attention.launches_i2v
            shape = tuple(video.shape)
            finite = bool(torch.isfinite(video).all())
            vae_gn = st["encode gn_silu"] + st["decode gn_silu"]
            print(f"phase 5 (plan {plan}): i2v stage 2, 512x1024x16 panorama, 2x2 windows of 320x512 (UNet batch "
                  f"8), {steps} of 48 steps: video {shape} finite {finite} |video| mean "
                  f"{float(video.abs().mean()):.4f}; request {total:.2f} s: conditioning (64 CLIP crops + text) "
                  f"{st['conditioning s']:.2f} s, tiled VAE encode {st['encode s']:.2f} s, sampling "
                  f"{per_step:.3f} s/step, ring decode {st['decode s']:.2f} s"
                  + (f" (cold one-step warm-up request {cold_total:.2f} s, {cold_step:.3f} s/step)" if not spec
                     else ""), flush=True)
            print(f"phase 5 (plan {plan}) launches {launches}; K3 with image keys {i2v_k3}; gn_silu in the VAE "
                  f"{vae_gn} (encode {st['encode gn_silu']}, decode {st['decode gn_silu']})", flush=True)
            if shape != (1, 16, 512, 1024, 3) or not finite:
                _fail(f"bad i2v video {shape} finite={finite} (plan {plan})")
            if i2v_k3 != launches["K3"] or st["encode gn_silu"] == 0 or st["decode gn_silu"] == 0:
                _fail(f"i2v path (plan {plan}): K3 {launches['K3']} of which with image keys {i2v_k3}, "
                      f"VAE gn_silu {st['encode gn_silu']}/{st['decode gn_silu']}")
            _check_per_forward(f"i2v path (plan {plan})", launches, st["unet calls"], model.unet.cfg)
            out.append(launches)
            per_step_by_plan[plan] = per_step
            del video
    probe.remove()
    print("phase 5 ok: sampling s/step " + ", ".join(f"plan {p} {v:.3f}" for p, v in per_step_by_plan.items()),
          flush=True)
    return out


# the gen_pano_360 stage-1 geometry: a 1024x512 equirect at sphere scale 2,
# its view grid (phi -> thetas, 44 views) and per-phi prompts
CLI_PROMPT = "Massive green blue ocean wave, dynamic ocean spray, breaking waves"
CLI_PHI_PROMPTS = {
    90.0: "Clear light blue sky", 75.0: "Clear light blue sky", 60.0: "Clear light blue sky",
    45.0: CLI_PROMPT, 0.0: CLI_PROMPT, -45.0: "green blue ocean with waves and swirling foam patterns",
    -60.0: "green blue ocean with waves", -75.0: "green blue ocean water", -90.0: "green blue ocean water",
}
CLI_THETAS = [360 * t // 6 for t in range(6)]
CLI_GRID = {90: [0], -90: [0], 75: CLI_THETAS, -75: CLI_THETAS, 60: CLI_THETAS, -60: CLI_THETAS,
            45: CLI_THETAS, -45: CLI_THETAS, 0: CLI_THETAS}
# phase 6's stage-1 call at the CLI's geometry and schedules (48-step table)
SPHERE_KW = dict(
    equirect_width=2048, equirect_height=1024, phi_theta_dict=CLI_GRID, view_fov=120, loop_step_theta=10,
    phi_prompt_dict=CLI_PHI_PROMPTS, total_f=16, dock_at_f=True,
    overlap_ratio_list_f=[[0.75, 0.5][i * 2 // 48] for i in range(48)], loop_step_frame=8, height=320, width=512,
    frames=16, fps=8, guidance_scale=7.5, num_inference_steps=48, paste_on_static=True,
    merge_renoised_overlap_latent_ratio=1.0,
    merge_prev_denoised_ratio_list=[0.5 * (1 - t / 20) for t in range(20)] + [0.0] * 28, overlap_mode="last",
    unet_microbatch=8)


def _phase_sphere(model, steps):
    """Phase 6: stage 1 of gen_pano_360 (the sphere sampler) at the CLI's
    geometry and schedules, ``steps`` of the 48-step table: step 0 the
    warm-up, the last step timed."""
    from dynamicscaler_tpu_torch.pipelines import sphere

    pano = smooth_panorama(1024, 2048, seed=9)
    probe = _Probe(model, [(model, "encode_text", "conditioning"), (model, "encode_image_cond", "conditioning"),
                           (model, "encode_video", "encode"), (model, "apply_unet", "unet"),
                           (sphere, "_phase_view_maps", "view maps"), (sphere, "_view_contexts", "view contexts")])
    step_s, step_launches = [], []
    orig_step = sphere._Sampler.step

    def timed_step(self, *a, **kw):
        torch.cuda.synchronize()
        t0, n0 = time.perf_counter(), _launches()
        out = orig_step(self, *a, **kw)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_launches.append({k: n - n0[k] for k, n in _launches().items()})
        return out

    gen = torch.Generator(device=DEV).manual_seed(17)
    _reset_launches()
    sphere._Sampler.step = timed_step
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, latent, den = sphere.sample_shift_sphere_panorama(model, CLI_PROMPT, pano, denoise_to_step=steps,
                                                             generator=gen, **SPHERE_KW)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        sphere._Sampler.step = orig_step
    launches = _launches()
    probe.remove()
    st = probe.stats
    shape = tuple(latent.shape)
    finite = bool(torch.isfinite(latent).all()) and bool(torch.isfinite(den).all())
    whole = ("K10", "K11", "K12", "K13")
    per_step = [{k: n[k] for k in whole if n[k]} for n in step_launches]
    print(f"phase 6: sphere stage 1, 2048x1024 equirect (latent 128x256), 16 frames, 44 views x 10 phases, "
          f"UNet batch 88 per step in forwards of 8, {steps} of 48 steps: latent {shape} finite {finite} "
          f"|latent| mean {float(latent.abs().mean()):.4f}; request {total:.2f} s: view maps (host, 3 x 10 "
          f"phases x 44 views) {st['view maps s']:.2f} s, per-view contexts (440 view casts on the host, crops "
          f"gathered on the card, CLIP and text encodes) {st['view contexts s']:.2f} s, all CLIP/text encodes {st['conditioning s']:.2f} s, "
          f"static tiled VAE encode {st['encode s']:.2f} s, steps "
          + ", ".join(f"{t:.3f}" for t in step_s) + f" s (step 0 warm-up; {step_s[-1]:.3f} s/step timed), "
          f"UNet forwards {st['unet calls']}, whole-block/transformer launches per step {per_step}", flush=True)
    print(f"phase 6 launches {launches}", flush=True)
    if shape != (1, 16, 128, 256, 4) or not finite:
        _fail(f"bad sphere latent {shape} finite={finite}")
    if st["encode gn_silu"] == 0:
        _fail("the sphere path's static encode launched no gn_silu")
    _check_per_forward("sphere path", launches, st["unet calls"], model.unet.cfg)
    per = expected_launches(model.unet.cfg, 40, 64)
    if any(n != {k: 11 * per[k] for k in whole if per[k]} for n in per_step):
        _fail(f"sphere steps launched {per_step}, expected 11 forwards of the per-forward counts")
    print("phase 6 ok", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 7: the CLI
# ---------------------------------------------------------------------------

# only the steps are cut: 3 of stage 1's (to denoise_to_step) and the last 3
# of the 6-step table in stages 2 and 3; everything else at the CLI's defaults
CLI_STEPS = ["--num_inference_steps", "6", "--denoise_to_step", "3", "--merge_prev_step", "3"]


def _png(path, image):
    """A [-1, 1] [h, w, 3] image written as a PNG at ``path`` (PIL)."""
    from PIL import Image

    Image.fromarray(np.round((image + 1) * 127.5).astype(np.uint8)).save(path)
    return path


def _written_video(out, name, frames_shape):
    """The video ``name`` the CLI wrote in ``out``, through whichever writer
    the machine allows (``utils.io.save_video``); returns the writer."""
    from dynamicscaler_tpu_torch.utils.avi import read_avi_info

    base = os.path.join(out, name)
    if os.path.exists(base + ".mp4"):
        ok, writer = os.path.getsize(base + ".mp4") > 0, "mp4 through imageio"
    elif os.path.exists(base + ".avi"):
        info = read_avi_info(base + ".avi")
        ok = (info["frames"], info["height"], info["width"]) == frames_shape[:3] \
            and len(os.listdir(base + "_frames")) == frames_shape[0]
        writer = "MJPEG AVI and PNG frames through PIL"
    else:
        ok, writer = False, "none"
    if not ok:
        _fail(f"{out}: video {name} {frames_shape} not written as expected (writer {writer})")
    return writer


def _hold_new_shapes(calls, held, phase):
    """Every kernel call of ``calls`` at a shape no earlier phase held
    (``held``, which then gains them), against its plain version with phase
    3's gates (:func:`_check`; for K9 also :func:`_gn_route`: the
    statistics it folds and its apply kernel alone; for kernels 10 and 12
    the other cluster size, :func:`_block_tile`). Fails on any
    disagreement; returns the largest error per kernel."""
    rn = _gen()
    errs, bad = {}, []
    for k, pos, opts in sorted({key for key in calls if key not in held}, key=str):
        case = _case(k, pos, dict(opts), rn)
        got = case.run()
        ref = case.plain()
        torch.cuda.synchronize()
        err, tol, rel, tol_l2, ok = _check(case, got, ref)
        del got
        ms, plain_ms = _time_ms(case.run, 10), _time_ms(case.plain, 3)
        print(f"{phase} {k} {case.desc}: max_abs_err {err:.5f} (tol {tol}) rel_l2 {rel:.5f} (tol {tol_l2}) "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms [x{calls[(k, pos, opts)]} in the {phase} runs] "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if case.gn:
            ok = _gn_route(case, ms, phase=phase)[0] and ok
        if case.block:
            tile, reckoned = _block_tile(case, ms, ref)
            ok = ok and tile["other_cl_ok"]
            print(f"{phase} {k} {case.desc} tile: {_block_line(tile, reckoned)}", flush=True)
        errs[k] = max(errs.get(k, 0.0), err)
        held.add((k, pos, opts))
        if not ok:
            bad.append(f"{k} {case.desc}")
        del case, ref
    torch.cuda.empty_cache()
    if bad:
        _fail(f"{phase}: kernel disagrees with its plain version at a shape of the phase's runs: {bad}")
    return errs


def _cli_run(model, vargs, held, phase):
    """One ``gen_pano_360.main(vargs, _model=model)`` run at the CLI's
    geometry: stage 1 at 2048x1024 with 44 views over 10 phases, stages 2
    and 3 on 2x2 and 4x4 windows of 320x512, 16 frames, UNet microbatch 8.
    Checks the three latents finite at their shapes, both videos, the
    files, and the exact launch counts (the UNet forwards at
    :func:`expected_launches` each at the bundle's dtype, and K9 and the
    statistics of the VAE's calls as recorded), and holds every VAE kernel
    call at a shape not in ``held`` against its plain version
    (:func:`_hold_new_shapes`). Returns the output directory, the launches,
    the largest error per kernel of the new shapes and the latents."""
    from dynamicscaler_tpu_torch.cli import gen_pano_360 as cli

    # UNet forwards: s1 stage-1 steps of 44 views (88 CFG-packed, 11
    # forwards of 8), s23 stage-2 steps of 2x2 windows (1 forward), s23
    # stage-3 steps of 4x4 windows (4 forwards)
    s1 = min(vargs.num_inference_steps, vargs.denoise_to_step)
    s23 = vargs.num_inference_steps - vargs.denoise_to_step
    want_fwd = s1 * 11 + s23 * 1 + s23 * 4
    batches, vae_calls = collections.Counter(), collections.Counter()
    apply_unet, encode_video, decode_video = model.apply_unet, model.encode_video, model.decode_video

    def counted_unet(x, *a, **kw):
        batches[x.shape[0]] += 1
        return apply_unet(x, *a, **kw)

    def recorded(fn):
        def call(*a, **kw):
            with _recording(vae_calls):
                return fn(*a, **kw)
        return call

    model.apply_unet, model.encode_video, model.decode_video = \
        counted_unet, recorded(encode_video), recorded(decode_video)
    try:
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.main(vargs, _model=model)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _launches()
    finally:
        model.apply_unet, model.encode_video, model.decode_video = apply_unet, encode_video, decode_video
    e2e = json.load(open(os.path.join(out, "e2e.json")))
    for stage, secs in e2e["stages_sec"].items():
        steady = e2e["steady_sec_per_step"][stage]
        print(f"{phase} stage {stage}: {secs:.2f} s wall, steady "
              + ("not measured" if steady is None else f"{steady:.3f} s/step"), flush=True)
    latents = {}
    for name, shape in (("sphere_SW_latent.npy", (1, 16, 128, 256, 4)),
                        ("basic_SW_latent.npy", (1, 16, 64, 128, 4)),
                        ("denoised_latent2x.npy", (1, 16, 128, 256, 4))):
        latents[name] = np.load(os.path.join(out, name))
        if latents[name].shape != shape or not np.isfinite(latents[name]).all():
            _fail(f"cli path: {name} {latents[name].shape} finite {np.isfinite(latents[name]).all()}, "
                  f"expected {shape}")
    writers = {name: _written_video(out, name, shape)
               for name, shape in (("shift_windows", (16, 512, 1024, 3)), ("SW_2X", (16, 1024, 2048, 3)))}
    for f in ("args.json", "e2e.json"):
        if not os.path.exists(os.path.join(out, f)):
            _fail(f"cli path: no {f}")
    per = expected_launches(model.unet.cfg, 40, 64, dtype=model.dtype)
    n_fwd = sum(batches.values())
    vae = dict.fromkeys(KERNELS, 0)
    for (k, *_), n in vae_calls.items():
        vae[k] += n
    want = {k: n * n_fwd for k, n in per.items()}
    want["K9"] += vae["K9"]
    want["GN"] += _k9_split(vae_calls)
    print(f"{phase} cli: run {run_s:.2f} s: latents {[v.shape for v in latents.values()]} finite, videos "
          f"{writers}; UNet forwards {dict(batches)} (expected {want_fwd} of 8); gn_silu in the VAE "
          f"{vae['K9']} (split route {_k9_split(vae_calls)}); launches {launches}", flush=True)
    if dict(batches) != {8: want_fwd} or launches != want or any(vae[k] for k in KERNELS if k not in VAE_KERNELS) \
            or not vae["K9"]:
        _fail(f"cli path: UNet forwards {dict(batches)} (expected {want_fwd} of 8), launches {launches}, "
              f"expected {want}; VAE calls {vae}")
    errs = _hold_new_shapes(vae_calls, held, phase)
    return out, launches, errs, latents


def _phase_cli(model, held):
    """Phase 7: ``cli/gen_pano_360.py`` through ``main(VArgs.from_args(argv))``
    on the phase-2 bundle, at the CLI's defaults but for the steps
    (:data:`CLI_STEPS`): the 1024x512 equirect, stage 1 at 2048x1024 with 44
    views over 10 phases, stages 2 and 3 on 2x2 and 4x4 windows of 320x512,
    16 frames, CFG 7.5, UNet microbatch 8; the panorama the smooth seeded
    image of phase 5 as a PNG, outputs in a temporary directory.
    Exact launch counts: the UNet forwards at :func:`expected_launches`
    each, and K9 and the statistics of the VAE's calls as recorded. Then
    stage 2 again from the stage-1 latent the run wrote, and the
    ``--dev_full_random`` bundle. K9 and the statistics are held against
    their plain versions at each VAE shape of the run that is not in
    ``held``, the keys phase 3 checked (:func:`_hold_new_shapes`).
    Returns the run's launches and the largest error per kernel there."""
    from dynamicscaler_tpu_torch.cli import gen_pano_360 as cli

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        pano = _png(os.path.join(tmp, "pano.png"), smooth_panorama(512, 1024, seed=5))
        argv = ["--pano_image_path", pano, "--output_dir", tmp, *CLI_STEPS]
        out, launches, errs, latents = _cli_run(model, cli.VArgs.from_args(argv + ["--project_name", "run"]), held,
                                                "phase 7")

        # stage 2 alone, from the stage-1 latent of the run
        t0 = time.perf_counter()
        out2 = cli.main(cli.VArgs.from_args(argv + [
            "--project_name", "resume", "--predenoised_SP_latent_path", os.path.join(out, "sphere_SW_latent.npy"),
            "--do_upscale", "false"]), _model=model)
        resume_s = time.perf_counter() - t0
        a, b = latents["basic_SW_latent.npy"], np.load(os.path.join(out2, "basic_SW_latent.npy"))
        same = np.array_equal(a, b)
        print(f"phase 7 resume: stage 2 alone from the stage-1 latent in {resume_s:.2f} s: bit-identical to the "
              f"full run's: {same} (max abs diff {float(np.abs(b - a).max()):.2e}); files "
              f"{sorted(os.listdir(out2))}", flush=True)
        if not same or os.path.exists(os.path.join(out2, "denoised_latent2x.npy")):
            _fail("cli resume: the stage-2 latent differs from the full run's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    full = cli.build_model(cli.VArgs.from_args(["--dev_full_random", "true"]))
    params = [p for _, m in full.components() for p in m.parameters()]
    value = torch.tensor(0.01, dtype=BF, device=DEV)
    ok = all(p.device == DEV and p.dtype == BF and bool((p == value).all()) for p in params)
    n, n_ref = sum(p.numel() for p in params), sum(p.numel() for _, m in model.components() for p in m.parameters())
    print(f"phase 7 --dev_full_random: {n / 1e9:.3f}B parameters (random bundle {n_ref / 1e9:.3f}B), all bf16 0.01 "
          f"on {DEV}: {ok}, built in {time.perf_counter() - t0:.2f} s", flush=True)
    del full, params
    torch.cuda.empty_cache()
    if not ok or n != n_ref:
        _fail("the --dev_full_random bundle is not the full i2v bundle with every bf16 parameter 0.01 on the card")
    print(f"phase 7 ok in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, errs



# ---------------------------------------------------------------------------
# phase 8: the single-clip CLI, cli/sample.py
# ---------------------------------------------------------------------------

SAMPLE_PROMPT = "a red sports car driving along a coastal road"
# two FreeTraj keyframes: the box moves left to right at mid height
SAMPLE_TRAJ = "0:0.3-0.7:0.0-0.4;1:0.3-0.7:0.6-1.0"
SAMPLE_THRES = 600.0  # spatial masking while t > 600: steps at t 999, 666 on, 333, 0 off (4-step table)
TRAJ_ALL = (True, True, True)  # FreeTraj's (temporal, self, cross) classes, all on in the CLI
SAMPLE_STEPS = 4  # the t2v, i2v and freetraj modes' DDIM table
FIFO_OUT = 8  # FIFO output frames (queue 16: one UNet forward a frame)


class _SampleProbe:
    """Installed on a bundle for one run: each UNet call's batch, FreeTraj
    classes and synchronised seconds; the seconds of conditioning, decode
    and the video write (``utils.io.save_video``); the VAE decode's kernel
    calls (recorded apart, by :func:`_recording`)."""

    def __init__(self, model):
        from dynamicscaler_tpu_torch.utils import io

        self.model, self.unet, self.secs, self.vae_calls = model, [], collections.Counter(), collections.Counter()
        self._saved = {n: getattr(model, n) for n in ("apply_unet", "encode_text", "encode_image_cond",
                                                      "decode_video")}
        self._io = (io, io.save_video)

        def timed(fn, label, record=False):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with _recording(self.vae_calls) if record else contextlib.nullcontext():
                    out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.secs[label] += time.perf_counter() - t0
                return out
            return call

        def unet(x, t, ctx, fps=16, no_temporal_attn=False, traj=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._saved["apply_unet"](x, t, ctx, fps, no_temporal_attn, traj=traj)
            torch.cuda.synchronize()
            classes = None if traj is None else (traj.temporal_attn, traj.self_attn, traj.cross_attn)
            self.unet.append((x.shape[0], classes, None if traj is None else bool(traj.active.any()),
                              time.perf_counter() - t0))
            return out

        model.apply_unet = unet
        for n in ("encode_text", "encode_image_cond"):
            setattr(model, n, timed(self._saved[n], "conditioning"))
        model.decode_video = timed(self._saved["decode_video"], "decode", record=True)
        io.save_video = timed(io.save_video, "write")

    def remove(self):
        for n, fn in self._saved.items():
            setattr(self.model, n, fn)
        self._io[0].save_video = self._io[1]


@contextlib.contextmanager
def _kept(module, name, store, pick):
    """``module.name`` wrapped inside the block to append ``pick(result)``
    to ``store``."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        store.append(pick(out))
        return out
    setattr(module, name, wrapped)
    try:
        yield store
    finally:
        setattr(module, name, fn)


def _check_run(where, model, launches, probe, calls, want_fwd, traj, decoded=True):
    """Exact launches of one phase-8 run: its UNet forwards (``want_fwd``
    of batch 2, with the FreeTraj classes ``traj``) at
    :func:`expected_launches` each, plus the VAE decode's K9 and statistics
    as recorded (and some K9 calls there where the run ``decoded``); K3
    with image keys on the i2v bundle only."""
    per = expected_launches(model.unet.cfg, 40, 64, traj=traj, dtype=model.dtype)
    fwds = [(b, c) for b, c, _, _ in probe.unet]
    vae = dict.fromkeys(KERNELS, 0)
    for (k, *_), n in probe.vae_calls.items():
        vae[k] += n
    want = {k: n * len(fwds) for k, n in per.items()}
    want["K9"] += vae["K9"]
    want["GN"] += _k9_split(probe.vae_calls)
    i2v_k3 = fused_spatial.fused_ln_cross_attention.launches_i2v
    want_k3 = launches["K3"] if model.unet.cfg.use_image_attention else 0
    if fwds != [(2, traj)] * want_fwd or launches != want or i2v_k3 != want_k3 or bool(vae["K9"]) != decoded \
            or any(vae[k] for k in KERNELS if k not in VAE_KERNELS):
        _fail(f"{where}: UNet forwards {fwds} (expected {want_fwd} of batch 2 with traj {traj}), launches "
              f"{launches}, expected {want}; K3 with image keys {i2v_k3}; VAE calls {vae}")
    calls.update(probe.vae_calls)


def _phase_sample(model, i2v_model, held):
    """Phase 8: ``cli/sample.py`` on ``model``, a full-width VideoCrafter2
    t2v bundle built again (and the phase-2 i2v bundle for ``--mode i2v``): the new
    forwards against the plain versions, the four modes through
    ``main(parse_args(argv))`` with the steps cut, the LCM stream through
    ``fifo_sample`` directly; every kernel call of the phase at a shape not
    in ``held`` held against its plain version with phase 3's gates.
    Returns the launches of each run by path name and the largest error
    per kernel of the new shapes."""
    from dynamicscaler_tpu_torch.cli import sample
    from dynamicscaler_tpu_torch.ops import freetraj as ft
    from dynamicscaler_tpu_torch.pipelines import fifo, i2v, t2v

    t_phase = time.perf_counter()
    cfg = model.unet.cfg
    calls = collections.Counter()  # every kernel call of the phase, for the new-shape check

    # the new forwards, kernels against plain versions
    sites = {}
    x, ctx, _ = _unet_inputs(2, 77, 10)
    t_fifo = t2v.make_schedule_for_model(model, 16).ddim_timesteps[None].expand(2, -1)  # queue slot j at index j
    traj = ft.make_freetraj(sample.parse_traj_spec(SAMPLE_TRAJ), 16, batch=2, device=DEV)
    outs = {}
    for where, t, classes in (("t2v FIFO fwd batch 2, per-frame t [2, 16]", t_fifo, None),
                              ("t2v FreeTraj fwd batch 2, t 999 (spatial masks on)", 999, TRAJ_ALL),
                              ("t2v FreeTraj fwd batch 2, t 333 (spatial masks off)", 333, TRAJ_ALL)):
        t2 = torch.as_tensor(t, device=DEV).expand(2, *([] if isinstance(t, int) else [16]))
        tr = None if classes is None else ft.gate_active(traj, t2, SAMPLE_THRES, 2, 16)

        def fwd(t2=t2, tr=tr):
            return model.apply_unet(x, t2, ctx, 8, traj=tr)

        want = expected_launches(cfg, 40, 64, traj=classes)
        r = _against_plain(where, fwd, sites, 2, 1)
        active = "" if tr is None else f" active frames {int(tr.active.sum())} of 32,"
        print(f"phase 8 {where}:{active} rel_l2 {r.rel:.5f} (tol {TOL_PATH_REL_L2}) |eps| mean "
              f"{float(r.out.abs().mean()):.4f} kernels {r.ms:.1f} ms plain {r.plain_ms:.1f} ms launches "
              f"{r.launches}", flush=True)
        if not r.finite or r.rel > TOL_PATH_REL_L2 or r.launches != want or r.i2v_k3:
            _fail(f"{where}: rel_l2 {r.rel} finite {r.finite} launches {r.launches}, expected {want}")
        outs[where] = r.out
        if classes and tr.active.all():
            _profile_forward(where, fwd, r.ms, phase="phase 8")
        del r
    on, off = (outs[w] for w in list(outs)[1:])
    masks = float((on - off).norm() / off.norm())
    print(f"phase 8 FreeTraj forwards: the spatial masks move eps by rel_l2 {masks:.4f} between the active and "
          f"the inactive step", flush=True)
    if masks == 0.0:
        _fail("the FreeTraj spatial masks leave the forward unchanged at an active step")
    del outs, on, off
    for c in sites.values():
        calls.update(c)

    paths = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sample_")
    try:
        image = _png(os.path.join(tmp, "crop.png"), smooth_panorama(512, 1024, seed=5)[:320, :512])
        steps = ["--num_inference_steps", str(SAMPLE_STEPS)]
        runs = (("t2v", model, steps, SAMPLE_STEPS, None, (t2v, "basic_sample")),
                ("i2v", i2v_model, ["--image", image, *steps], SAMPLE_STEPS, None,
                 (i2v, "sample_shift_multi_windows_integer")),
                ("fifo", model, ["--num_frames", str(FIFO_OUT)], FIFO_OUT, None, (fifo, "fifo_sample")),
                ("freetraj", model, ["--traj", SAMPLE_TRAJ, "--traj_thres", str(SAMPLE_THRES), *steps],
                 SAMPLE_STEPS, TRAJ_ALL, (t2v, "freetraj_sample")))
        for mode, m, extra, n_fwd, classes, (mod, fn) in runs:
            args = sample.parse_args(["--mode", mode, "--prompt", SAMPLE_PROMPT, "--name", mode,
                                      "--output_dir", os.path.join(tmp, mode), *extra])
            probe = _SampleProbe(m)
            latents, fronts = [], []
            try:
                with _kept(mod, fn, latents, lambda out: out[1]), \
                        _kept(fifo, "ddim_step", fronts, lambda out: out[1][:, 0].clone()), _recording(calls):
                    _reset_launches()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    path = sample.main(args, _model=m)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    launches = _launches()
            finally:
                probe.remove()
            lat = latents[0]
            shape = (1, FIFO_OUT if mode == "fifo" else 16, 40, 64, 4)
            finite = bool(torch.isfinite(lat).all())
            writer = _written_video(os.path.dirname(path), mode, (shape[1], 320, 512, 3))
            unet_s = [s for *_, s in probe.unet]
            sampling = wall - probe.secs["conditioning"] - probe.secs["decode"] - probe.secs["write"]
            steady = sum(unet_s[1:]) / (len(unet_s) - 1)
            act = [a for _, _, a, _ in probe.unet]
            print(f"phase 8 sample --mode {mode}: {wall:.2f} s wall: conditioning {probe.secs['conditioning']:.2f} "
                  f"s, sampling {sampling / n_fwd:.3f} s/step over {n_fwd} "
                  f"{'output frames' if mode == 'fifo' else 'steps'} (UNet forward {unet_s[0] * 1e3:.1f} ms first, "
                  f"{steady * 1e3:.1f} ms steady; the rest of the loop {sampling - sum(unet_s):.2f} s), decode "
                  f"{probe.secs['decode']:.2f} s, write {probe.secs['write']:.2f} s; latent {tuple(lat.shape)} "
                  f"finite {finite}; video {path} ({writer}); launches {launches}"
                  + (f"; spatial masks on at steps {act}" if classes else ""), flush=True)
            if tuple(lat.shape) != shape or not finite:
                _fail(f"sample --mode {mode}: latent {tuple(lat.shape)} finite {finite}, expected {shape}")
            if classes and act != [True, True, False, False]:
                _fail(f"sample --mode freetraj: spatial masks on at steps {act}, expected [True, True, False, False]")
            if mode == "fifo":
                _check_fronts("sample --mode fifo", lat, fronts)
            _check_run(f"sample --mode {mode}", m, launches, probe, calls, n_fwd, classes)
            paths[f"sample {mode}"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the LCM stream, which the CLI does not reach
    probe = _SampleProbe(model)
    fronts = []
    try:
        with _kept(fifo, "lcm_step", fronts, lambda out: out[1][:, 0].clone()), _recording(calls):
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, lat = fifo.fifo_sample(model, SAMPLE_PROMPT, FIFO_OUT, frames=16, fps=8, guidance_scale=12.0,
                                      generator=torch.Generator(device=DEV).manual_seed(5), decode=False,
                                      scheduler="lcm")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
    finally:
        probe.remove()
    finite = bool(torch.isfinite(lat).all())
    print(f"phase 8 fifo_sample(scheduler=\"lcm\"): {FIFO_OUT} output frames in {wall:.2f} s "
          f"({wall / FIFO_OUT:.3f} s a frame, no decode); latent {tuple(lat.shape)} finite {finite}; launches "
          f"{launches}", flush=True)
    if tuple(lat.shape) != (1, FIFO_OUT, 40, 64, 4) or not finite:
        _fail(f"fifo lcm: latent {tuple(lat.shape)} finite {finite}")
    _check_fronts("fifo lcm", lat, fronts)
    _check_run("fifo lcm", model, launches, probe, calls, FIFO_OUT, None, decoded=False)
    paths["fifo lcm"] = launches
    del lat
    torch.cuda.empty_cache()

    errs = _hold_new_shapes(calls, held, "phase 8")
    print(f"phase 8 ok in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths, errs


def _check_fronts(where, frames_out, fronts):
    """Each output frame of a FIFO stream equals the front slot's
    ``denoised`` of the step that emitted it, bit for bit."""
    same = len(fronts) == frames_out.shape[1] and all(
        torch.equal(frames_out[:, i], f) for i, f in enumerate(fronts))
    print(f"phase 8 {where}: {len(fronts)} steps, each output frame the front slot's denoised of its step: {same}",
          flush=True)
    if not same:
        _fail(f"{where}: the output frames are not the front slots' denoised of their steps")



# ---------------------------------------------------------------------------
# phase 9: the demo server and the batch eval
# ---------------------------------------------------------------------------

DEMO_DEFAULTS = {"steps": 4, "height": 320, "width": 512}
DEMO_PROMPT = "a black swan swims on the pond"
EVAL_PROMPTS = ("a lighthouse on a rocky coast at night", "a paper boat drifting down a rainy street",
                "a hot air balloon over autumn hills")
RANK_TIMEOUT_S = 300  # the two coordinated ranks of step 4, together
FORM = {"Content-Type": "application/x-www-form-urlencoded"}


class _Gate:
    """Holds a bundle's first UNet call until ``release`` is set, with
    ``started`` set as it arrives: a request sent meanwhile finds a
    generation running. ``waited``: the seconds it held the call."""

    def __init__(self, model):
        self.model, self._fn = model, model.apply_unet
        self.started, self.release, self.waited = threading.Event(), threading.Event(), 0.0

        def gated(*a, **kw):
            if not self.started.is_set():
                self.started.set()
                t0 = time.perf_counter()
                if not self.release.wait(120):
                    raise RuntimeError("the gate of the demo's first UNet call was never released")
                self.waited = time.perf_counter() - t0
            return self._fn(*a, **kw)

        model.apply_unet = gated

    def remove(self):
        self.model.apply_unet = self._fn


def _http(port, method, path, body=None, headers=None):
    """One request to the demo on 127.0.0.1:``port``: (status, page, wall s)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    page = r.read().decode()
    conn.close()
    return r.status, page, time.perf_counter() - t0


def _inlined_gif(page):
    """(frames, (width, height)) of the GIF a result page inlines."""
    from PIL import Image

    m = re.search(r'data:image/gif;base64,([A-Za-z0-9+/=]+)"', page)
    if not m:
        _fail(f"the demo's page inlines no GIF: {page[-300:]!r}")
    with Image.open(io.BytesIO(base64.b64decode(m.group(1)))) as im:
        return im.n_frames, im.size


@contextlib.contextmanager
def _timed(module, name, store):
    """``module.name`` timed (synchronised) inside the block, its seconds
    appended to ``store``."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        store.append(time.perf_counter() - t0)
        return out
    setattr(module, name, wrapped)
    try:
        yield store
    finally:
        setattr(module, name, fn)


def _run_line(where, wall, probe, steps):
    """Wall s and s/step of one phase-9 run; the UNet forwards timed in the
    thread that ran them."""
    unet_ms = [sec * 1e3 for *_, sec in probe.unet] or [0.0]
    sampling = wall - probe.secs["conditioning"] - probe.secs["decode"] - probe.secs["write"]
    return (f"{where}: {wall:.2f} s wall: conditioning {probe.secs['conditioning']:.2f} s, sampling "
            f"{sampling / steps:.3f} s/step (UNet forward {unet_ms[0]:.1f} ms first, "
            f"{sum(unet_ms[1:]) / max(1, len(unet_ms) - 1):.1f} ms on), decode {probe.secs['decode']:.2f} s, "
            f"write {probe.secs['write']:.2f} s")


def _demo_request(model, where, server_dir, calls, post, busy=False):
    """Serve ``model`` with ``cli/demo.py::make_server`` in a thread and send
    ``post`` (path, body, headers); with ``busy`` a second POST while the
    first generates, which must get 503 and start nothing. Exact launches:
    ``DEMO_DEFAULTS['steps']`` batch-2 forwards and the decode. Returns the
    launches and the GIF's write seconds."""
    from dynamicscaler_tpu_torch.cli import demo
    from dynamicscaler_tpu_torch.utils import io as dio

    server = demo.make_server(model, port=0, result_dir=server_dir, defaults=DEMO_DEFAULTS)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        status, page, _ = _http(port, "GET", "/")
        i2v_form = "/generate_i2v" in page and 'type="file"' in page
        print(f"phase 9 {where}: GET / {status}, i2v form {i2v_form}", flush=True)
        if status != 200 or "Generate" not in page or i2v_form != (model.image_encoder is not None):
            _fail(f"{where}: the page (status {status}, i2v form {i2v_form})")
        probe = _SampleProbe(model)
        gate = _Gate(model) if busy else None
        first, gif_s = {}, []
        try:
            with _recording(calls), _timed(dio, "_write_gif", gif_s):
                _reset_launches()
                if busy:
                    t = threading.Thread(target=lambda: first.update(r=_http(port, "POST", *post)))
                    t.start()
                    if not gate.started.wait(300):
                        _fail(f"{where}: the first request never reached the UNet")
                    b_status, b_page, b_wall = _http(port, "POST", "/generate", "prompt=busy", FORM)
                    gate.release.set()
                    t.join(600)
                    print(f"phase 9 {where}: a second POST while the first generates: {b_status} in "
                          f"{b_wall * 1e3:.1f} ms ({'the Busy page' if 'Busy' in b_page else 'another page'})",
                          flush=True)
                    if b_status != 503 or "Busy" not in b_page:
                        _fail(f"{where}: the request sent during a generation got {b_status}, not 503")
                else:
                    first["r"] = _http(port, "POST", *post)
                torch.cuda.synchronize()
                launches = _launches()
        finally:
            if gate is not None:
                gate.remove()
            probe.remove()
        status, page, wall = first.get("r", (None, "", 0.0))
        wall -= gate.waited if gate is not None else 0.0
        gif = _inlined_gif(page) if status == 200 else None
        print(f"phase 9 {_run_line(where, wall, probe, DEMO_DEFAULTS['steps'])} (GIF {gif_s[0] if gif_s else 0:.3f} "
              f"s); POST {status}, inlined GIF {gif}; launches {launches}", flush=True)
        if status != 200 or gif != (16, (512, 320)):
            _fail(f"{where}: POST {status}, inlined GIF {gif}, expected 16 frames of 512x320")
        _written_video(server_dir, demo._clip_name(DEMO_PROMPT), (16, 320, 512, 3))
        _check_run(where, model, launches, probe, calls, DEMO_DEFAULTS["steps"], None)
        return launches, gif_s
    finally:
        server.shutdown()
        server.server_close()


def _batch_eval_run(model, where, argv, calls, want_fwd):
    """``batch_eval.main(parse_args(argv), _model=model)`` with exact
    launches (``want_fwd`` batch-2 forwards and the decodes); returns the
    launches and the written paths."""
    from dynamicscaler_tpu_torch.cli import batch_eval

    probe = _SampleProbe(model)
    try:
        with _recording(calls):
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            written = batch_eval.main(batch_eval.parse_args(argv), _model=model)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
    finally:
        probe.remove()
    print(f"phase 9 {_run_line(where, wall, probe, want_fwd)}; videos "
          f"{[os.path.basename(p) for p in written]}; launches {launches}", flush=True)
    _check_run(where, model, launches, probe, calls, want_fwd, None)
    return launches, written


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _eval_rank(rank, port, lib, prompt_file, out_dir, result):
    """One of the two coordinated ranks of phase 9 (a spawned process): the
    full-width t2v bundle from phase 8's seed, ``batch_eval.main`` with the
    group's flags at 2 steps; its launches, forwards and the kernel calls
    it recorded written to the JSON file ``result``."""
    from dynamicscaler_tpu_torch.cli import batch_eval

    if not os.path.exists(lib):
        raise RuntimeError(f"rank {rank}: the kernel library {lib} is not built")
    cuda_lib.library()
    model = _random_model("t2v")
    argv = ["--prompt_file", prompt_file, "--output_dir", out_dir, "--num_inference_steps", "2", "--coordinator",
            f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(rank)]
    calls = collections.Counter()
    probe = _SampleProbe(model)
    with _recording(calls):
        _reset_launches()
        t0 = time.perf_counter()
        written = batch_eval.main(batch_eval.parse_args(argv), _model=model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launches()
    probe.remove()
    calls.update(probe.vae_calls)
    vae = dict.fromkeys(KERNELS, 0)
    for (k, *_), n in probe.vae_calls.items():
        vae[k] += n
    with open(result, "w") as f:
        json.dump({"launches": launches, "forwards": [[b, c] for b, c, _, _ in probe.unet], "vae": vae,
                   "vae_split": _k9_split(probe.vae_calls), "wall": wall, "written": written,
                   "unet_ms": [sec * 1e3 for *_, sec in probe.unet], "calls": sorted(map(repr, calls))}, f)


def _two_ranks(model, tmp, pf, calls, held, lib):
    """Two spawned processes coordinated through ``parallel/dist.py`` on
    gloo, each with its own full-width t2v bundle, three prompts at 2
    steps: they write exactly ``r0_0000``, ``r0_0001`` and ``r1_0000``,
    each with exact launches; a rank that fails or outlasts
    :data:`RANK_TIMEOUT_S` fails the phase. Returns the two ranks' launches
    summed."""
    import multiprocessing

    out = os.path.join(tmp, "ranks")
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")  # CUDA after fork breaks
    results = [os.path.join(tmp, f"rank{r}.json") for r in (0, 1)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_eval_rank, args=(r, port, str(lib), pf, out, results[r])) for r in (0, 1)]
    for p in procs:
        p.start()
    deadline = t0 + RANK_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    print(f"phase 9 batch_eval 2 ranks: {wall:.2f} s for two spawned processes (bundle builds included), exit "
          f"codes {codes}" + (f", ranks {hung} killed after {RANK_TIMEOUT_S} s" if hung else ""), flush=True)
    if hung or codes != [0, 0]:
        _fail(f"batch_eval 2 ranks: exit codes {codes}, hung {hung}")
    per = expected_launches(model.unet.cfg, 40, 64)
    total = collections.Counter()
    known = {repr(k) for k in held} | {repr(k) for k in calls}
    for r, path in enumerate(results):
        with open(path) as f:
            res = json.load(f)
        n_fwd = 2 * (2 if r == 0 else 1)  # 2 steps for each prompt of the shard
        want = {k: n * n_fwd for k, n in per.items()}
        want["K9"] += res["vae"]["K9"]
        want["GN"] += res["vae_split"]
        new = [c for c in res["calls"] if c not in known]
        print(f"phase 9 rank {r}: {res['wall']:.2f} s in batch_eval.main, UNet forwards "
              f"{[round(ms, 1) for ms in res['unet_ms']]} ms, videos {[os.path.basename(p) for p in res['written']]}, "
              f"launches {res['launches']}, kernel calls at shapes no earlier run held {len(new)}", flush=True)
        if res["forwards"] != [[2, None]] * n_fwd or res["launches"] != want or new:
            _fail(f"rank {r}: forwards {res['forwards']}, launches {res['launches']} (expected {want}), new shapes "
                  f"{new}")
        total.update(res["launches"])
    names = sorted(n for n in os.listdir(out) if n.endswith((".mp4", ".avi")))
    want_names = sorted(f"{tag}_" + "".join(c if c.isalnum() else "_" for c in EVAL_PROMPTS[i][:40])
                        for tag, i in (("r0_0000", 0), ("r0_0001", 2), ("r1_0000", 1)))
    if [os.path.splitext(n)[0] for n in names] != want_names:
        _fail(f"batch_eval 2 ranks wrote {names}, expected {want_names}")
    return {k: total[k] for k in KERNELS}


def _phase_serve(model, i2v_model, held, lib):
    """Phase 9: ``cli/demo.py`` and ``cli/batch_eval.py`` on phase 8's t2v
    bundle ``model`` and the phase-2 i2v bundle: the demo's t2v request
    (with a second request turned away with 503 while it generates) and
    its i2v request (``i2v.basic_sample``; one such forward first against
    the plain versions); the batch eval in process (t2v at rank 1 and 0 of
    2, i2v on a PNG and an MJPEG AVI) and as two coordinated spawned ranks;
    a t2v forward with ``no_temporal_attn`` against the plain versions.
    Every kernel call of the phase at a shape not in ``held`` is held
    against its plain version with phase 3's gates. Returns the launches of
    each path and the largest error per kernel of the new shapes."""
    from PIL import Image

    from dynamicscaler_tpu_torch.pipelines import i2v
    from dynamicscaler_tpu_torch.pipelines.conditioning import build_uncond_context, cat_text_image
    from dynamicscaler_tpu_torch.utils import avi
    from dynamicscaler_tpu_torch.utils.io import load_image

    t_phase = time.perf_counter()
    calls, sites, paths = collections.Counter(), {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        crop = smooth_panorama(512, 1024, seed=5)[:320, :512]
        png = _png(os.path.join(tmp, "crop.png"), crop)

        # 1. the demo, t2v, and a request turned away while it generates
        body = urllib.parse.urlencode({"prompt": DEMO_PROMPT, "steps": 4, "cfg": 12, "seed": 1})
        paths["demo t2v"], gif_s = _demo_request(model, "demo t2v", os.path.join(tmp, "demo_t2v"), calls,
                                                 ("/generate", body, FORM), busy=True)

        # 2. the demo, i2v: first one of its forwards against the plain versions
        x = torch.randn((1, 16, 40, 64, 4), generator=torch.Generator(device=DEV).manual_seed(21), device=DEV)
        ctx2 = torch.cat([cat_text_image(i2v_model.encode_text([DEMO_PROMPT]), i2v_model.encode_image_cond(crop[None])),
                          build_uncond_context(i2v_model, with_image=True, image_hw=crop.shape[:2])])
        where = "i2v basic_sample fwd batch 2 (text + image tokens, zero-image uncond)"
        r = _against_plain(where, lambda: i2v_model.apply_unet(torch.cat([x, x]), torch.full((2,), 999, device=DEV),
                                                               ctx2, 16), sites, 2, 1)
        want = expected_launches(i2v_model.unet.cfg, 40, 64)
        print(f"phase 9 {where}: ctx {tuple(ctx2.shape)} rel_l2 {r.rel:.5f} (tol {TOL_PATH_REL_L2}) kernels "
              f"{r.ms:.1f} ms plain {r.plain_ms:.1f} ms launches {r.launches} (K3 with image keys {r.i2v_k3})",
              flush=True)
        if not r.finite or r.rel > TOL_PATH_REL_L2 or r.launches != want or r.i2v_k3 != want["K3"]:
            _fail(f"{where}: rel_l2 {r.rel} finite {r.finite} launches {r.launches}, expected {want}")
        del r
        with open(png, "rb") as f:
            image = f.read()
        boundary = "chipsmokeboundary"
        parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
                 for k, v in (("prompt", DEMO_PROMPT), ("steps", "4"), ("cfg", "12"), ("seed", "1"))]
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="image"; filename="crop.png"\r\n'
                     f"Content-Type: image/png\r\n\r\n".encode() + image + b"\r\n")
        post = ("/generate_i2v", b"".join(parts) + f"--{boundary}--\r\n".encode(),
                {"Content-Type": f"multipart/form-data; boundary={boundary}"})
        paths["demo i2v"], i2v_gif_s = _demo_request(i2v_model, "demo i2v", os.path.join(tmp, "demo_i2v"), calls,
                                                     post)

        # 3. the batch eval in process
        pf = os.path.join(tmp, "prompts.txt")
        with open(pf, "w") as f:
            f.write("\n".join(EVAL_PROMPTS) + "\n")
        steps = ["--num_inference_steps", "4", "--world_size", "2"]
        eval_t2v = collections.Counter()
        for rank, n in ((1, 1), (0, 2)):
            out = os.path.join(tmp, "eval_t2v")
            launches, written = _batch_eval_run(model, f"batch_eval t2v rank {rank} of 2", [
                "--prompt_file", pf, "--output_dir", out, "--rank", str(rank), *steps], calls, 4 * n)
            want_names = [f"r{rank}_{i:04d}_" + "".join(c if c.isalnum() else "_" for c in p[:40])
                          for i, p in enumerate(EVAL_PROMPTS[rank::2])]
            if [os.path.splitext(os.path.basename(w))[0] for w in written] != want_names:
                _fail(f"batch_eval t2v rank {rank}: wrote {written}, expected {want_names}")
            for w in written:
                _written_video(out, os.path.splitext(os.path.basename(w))[0], (16, 320, 512, 3))
            eval_t2v.update(launches)
        paths["batch_eval t2v"] = {k: eval_t2v[k] for k in KERNELS}

        conds = os.path.join(tmp, "conds")
        os.makedirs(conds)
        _png(os.path.join(conds, "a.png"), crop)
        clip = ((smooth_panorama(256, 832, seed=6)[:, :416] + 1) * 127.5).round().astype(np.uint8)
        avi.write_mjpeg_avi(os.path.join(conds, "b.avi"), [clip, np.flipud(clip).copy()], fps=8)
        decoded = avi.read_mjpeg_avi(os.path.join(conds, "b.avi"))[0][0]
        want_conds = [load_image(os.path.join(conds, "a.png"), 320, 512),
                      (np.asarray(Image.fromarray(decoded).convert("RGB").resize((512, 320), Image.BILINEAR),
                                  np.float32) / 255.0 - 0.5) * 2]
        got_conds, reads = [], []
        basic_sample = i2v.basic_sample

        def keep_cond(m, prompt, cond_image, **kw):
            got_conds.append(np.array(cond_image))
            return basic_sample(m, prompt, cond_image, **kw)

        with open(pf, "w") as f:
            f.write("\n".join(EVAL_PROMPTS[:2]) + "\n")
        i2v.basic_sample = keep_cond
        try:
            with _kept(avi, "read_mjpeg_avi", reads, lambda out: out[0].shape):
                paths["batch_eval i2v"], _ = _batch_eval_run(i2v_model, "batch_eval i2v", [
                    "--prompt_file", pf, "--output_dir", os.path.join(tmp, "eval_i2v"), "--mode", "i2v",
                    "--cond_input", conds, "--num_inference_steps", "4"], calls, 8)
        finally:
            i2v.basic_sample = basic_sample
        same = len(got_conds) == 2 and all(np.array_equal(g, w) for g, w in zip(got_conds, want_conds))
        print(f"phase 9 batch_eval i2v: conditioning files a.png, b.avi (MJPEG AVI, frames 256x416); "
              f"read_mjpeg_avi decodes during the run {reads}; each clip's conditioning frame equal to its file's "
              f"first frame after the same resize: {same}", flush=True)
        if reads != [(2, 256, 416, 3)] or not same:
            _fail("batch_eval i2v: the AVI conditioning did not come from read_mjpeg_avi's first frame")

        # 4. two coordinated ranks
        with open(pf, "w") as f:
            f.write("\n".join(EVAL_PROMPTS) + "\n")
        paths["batch_eval 2 ranks"] = _two_ranks(model, tmp, pf, calls, held, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 5. no_temporal_attn
    x, ctx, t = _unet_inputs(2, 77, 7)
    full = model.apply_unet(x, t, ctx, 16)
    where = "t2v UNet fwd batch 2, no_temporal_attn"
    r = _against_plain(where, lambda: model.apply_unet(x, t, ctx, 16, no_temporal_attn=True), sites, 3, 2)
    want = expected_launches(model.unet.cfg, 40, 64, no_temporal_attn=True)
    moved = float((r.out.float() - full.float()).norm() / full.float().norm())
    print(f"phase 9 {where}: rel_l2 {r.rel:.5f} (tol {TOL_PATH_REL_L2}) kernels {r.ms:.1f} ms plain "
          f"{r.plain_ms:.1f} ms launches {r.launches}; against the full forward rel_l2 {moved:.4f}", flush=True)
    if not r.finite or r.rel > TOL_PATH_REL_L2 or r.launches != want or moved == 0.0:
        _fail(f"{where}: rel_l2 {r.rel} finite {r.finite} launches {r.launches}, expected {want}; moved {moved}")
    paths["no_temporal_attn forward"] = r.launches
    del r, full

    # 6. new shapes
    for c in sites.values():
        calls.update(c)
    new = len({key for key in calls if key not in held})
    print(f"phase 9: {new} kernel calls at shapes no earlier phase held", flush=True)
    errs = _hold_new_shapes(calls, held, "phase 9")
    print(f"phase 9 ok in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths, errs


# ---------------------------------------------------------------------------
# phase 10: fp32
# ---------------------------------------------------------------------------

F32 = torch.float32
FP32_T2V = "fp32 t2v UNet fwd batch 2"
FP32_I2V = "fp32 i2v UNet fwd batch 8"
# the override plans at fp32, as phase 2 runs them at bf16: kernel 11 runs
# only under these (the fp32 plan runs kernels 10, 12 and 13 at some keys)
FP32_OVERRIDES = {f"{FP32_I2V}, plan off": "off", f"{FP32_I2V}, plan wrap+blk": WRAP_BLK}
# the runs whose sums make the fp32 records: the first in which the kernel runs
FP32_FORWARDS = (FP32_I2V, *FP32_OVERRIDES)
# every kernel has an fp32 route; the source of its fp32 kernel (K1-K3: the
# GEMM's, where most of their time goes; their attention cores are TA and FA)
FP32_KERNELS = list(KERNELS)
FP32_SOURCES = {**dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"),
                                "dynamicscaler_tpu_torch/csrc/gemm_f32.cu"),
                **dict.fromkeys(("TA", "FA"), "dynamicscaler_tpu_torch/csrc/attention_f32.cu"),
                **dict.fromkeys(("K9", "GN"), "dynamicscaler_tpu_torch/csrc/gn_silu.cu"),
                **dict.fromkeys(("K10", "K12"), "dynamicscaler_tpu_torch/csrc/temporal_f32.cu"),
                **dict.fromkeys(("K11", "K13"), "dynamicscaler_tpu_torch/csrc/spatial_f32.cu")}
# the fp32 CLI run: the steps cut to 2 a stage (stage 1's 11 forwards of 8
# a step, stage 2's 1, stage 3's 4; the second step of each gives its steady
# s/step), the geometry the CLI's
FP32_CLI_STEPS = ["--num_inference_steps", "4", "--denoise_to_step", "2", "--merge_prev_step", "2"]
FP32_SAMPLE_STEPS = 2


def _tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _fp32_kernels(sites):
    """Every fp32 kernel at every shape the phase-10 forwards recorded (and
    kernels 11 and 13 at :data:`SPATIAL_REPAIRS`, TA at
    :data:`TA_F32_REPAIRS`), against its plain version
    with the fp32 gates (:func:`_time_cases`; kernels 10-13 also at their
    other tile, bit-exact on rerun),
    timed beside its plain version, the same function as PyTorch library
    calls in fp32 (TF32 off) and its bound (operations over 67 TFLOP/s fp32
    or bytes at 4 B an element over 3.35 TB/s). Returns per kernel the
    largest error and the ms summed over the first batch-8 i2v fp32 forward
    in which it runs (the default plan, then "off", then all-wrap+blk)."""
    shapes = _recorded_shapes(sites)
    for key, runs in {**_spatial_repair_cases(F32), **_ta_f32_repair_cases()}.items():
        shapes[key] = {**shapes.get(key, {}), **runs}
    sums, max_err, bound_by, tiles = _time_cases(shapes, (*sites, REPAIR), "phase 10")
    records = {}
    for k in FP32_KERNELS:
        ran = [w for w in FP32_FORWARDS if sums[w][k]]
        if not ran:
            _fail(f"phase 10: {k} ran in none of the batch-8 fp32 forwards")
        records[k] = {**_record(k, sums[ran[0]][k], max_err, bound_by, ran[0]),
                      "bound_cc_ms": sums[ran[0]][k]["bound_cc_ms"]}
        if tiles.get(k):
            records[k]["tiles"] = tiles[k]
    _phase_gemms(GEMM_SITES[FP32_I2V], F32, "phase 10")
    return records


def _fp32_sample(model, mode, image, tmp, calls):
    """``cli/sample.py --dtype float32`` in ``mode`` on the fp32 bundle,
    2 steps at 320x512x16: the latent finite at its shape, the video, the
    exact launches, s/step, and both TF32 flags off after the CLI's
    startup (set on before it)."""
    from dynamicscaler_tpu_torch.cli import sample
    from dynamicscaler_tpu_torch.pipelines import i2v, t2v

    mod, fn = (t2v, "basic_sample") if mode == "t2v" else (i2v, "sample_shift_multi_windows_integer")
    args = sample.parse_args(["--mode", mode, "--prompt", SAMPLE_PROMPT, "--name", mode, "--dtype", "float32",
                              "--num_inference_steps", str(FP32_SAMPLE_STEPS), "--output_dir",
                              os.path.join(tmp, mode), *(["--image", image] if mode == "i2v" else [])])
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    probe = _SampleProbe(model)
    latents = []
    try:
        with _kept(mod, fn, latents, lambda out: out[1]), _recording(calls):
            _reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = sample.main(args, _model=model)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _launches()
    finally:
        probe.remove()
    flags = _tf32_flags()
    lat = latents[0]
    finite = bool(torch.isfinite(lat).all())
    writer = _written_video(os.path.dirname(path), mode, (16, 320, 512, 3))
    unet_s = [s for *_, s in probe.unet]
    sampling = wall - probe.secs["conditioning"] - probe.secs["decode"] - probe.secs["write"]
    print(f"phase 10 sample --mode {mode} --dtype float32: {wall:.2f} s wall: conditioning "
          f"{probe.secs['conditioning']:.2f} s, sampling {sampling / FP32_SAMPLE_STEPS:.3f} s/step over "
          f"{FP32_SAMPLE_STEPS} steps (UNet forward {unet_s[0] * 1e3:.1f} ms first, {unet_s[-1] * 1e3:.1f} ms last), "
          f"decode {probe.secs['decode']:.2f} s, write {probe.secs['write']:.2f} s; latent {tuple(lat.shape)} "
          f"{lat.dtype} finite {finite}; video ({writer}); TF32 flags after startup (cudnn, matmul) {flags}; "
          f"launches {launches}", flush=True)
    if tuple(lat.shape) != (1, 16, 40, 64, 4) or not finite or flags != (False, False):
        _fail(f"sample --mode {mode} --dtype float32: latent {tuple(lat.shape)} finite {finite}, TF32 {flags}")
    _check_run(f"sample --mode {mode} --dtype float32", model, launches, probe, calls, FP32_SAMPLE_STEPS, None)
    return launches


def _phase_fp32(t2v_bf, i2v_bf):
    """Phase 10: the model in fp32. The full-width t2v (batch 2) and i2v
    (batch 8) UNet forwards at 40x64x16 on seeded random fp32 bundles (the
    bf16 bundles' draws before their rounding) through the kernels against
    the plain versions (rel L2 <= TOL_F32_PATH) and against the bf16 forward of
    the same weights (printed, gated at TOL_F32_VS_BF16), with exact
    launches, and the batch-8 i2v forward under the two override plans
    (kernels 10, 11 and 13 at every key) against the plain versions; every
    fp32 kernel at every recorded shape against its plain version
    (:func:`_fp32_kernels`); the fp32 level table at every key; the
    CLIs at ``--dtype float32`` (``cli/sample.py`` t2v and i2v, 2 steps;
    ``cli/gen_pano_360.py --dev_full_random true`` on the fp32 i2v bundle,
    two steps a stage at the CLI's geometry) with TF32 set on before each
    and off after its startup, exact launches, every new kernel shape held
    with the fp32 gates; the ``--dev_full_random`` bundle in fp32 and a
    VideoCrafter-named checkpoint of the tiny fp32 bundle loaded on the card
    (fp32 carried across). Returns the fp32 kernel records and the fp32
    paths' launches."""
    from dynamicscaler_tpu_torch.cli import gen_pano_360 as cli
    from dynamicscaler_tpu_torch.config import tiny_test_config
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
    from dynamicscaler_tpu_torch.utils import weights
    from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer

    t_phase = time.perf_counter()
    t2v32, i2v32 = _random_model("t2v", "float32"), _random_model("i2v", "float32")
    sites, paths = {}, {}
    runs = [("t2v", t2v32, t2v_bf, 2, 77, 7, FP32_T2V, None), ("i2v", i2v32, i2v_bf, 8, 93, 8, FP32_I2V, None)]
    runs += [("i2v", i2v32, None, 8, 93, 8, where, spec) for where, spec in FP32_OVERRIDES.items()]
    for kind, m, mb, B, L, seed, where, spec in runs:
        x, ctx, t = _unet_inputs(B, L, seed)

        def fwd(m=m, x=x, ctx=ctx, t=t):
            return m.apply_unet(x, t, ctx, 16)

        with _plan(spec):
            want = expected_launches(m.unet.cfg, 40, 64, dtype=F32)
            r = _against_plain(where, fwd, sites, 1 if spec else 2, 1)
        vs_bf = 0.0
        if mb is not None:
            bf = mb.apply_unet(x, t, ctx, 16).float()
            vs_bf = float((r.out.float() - bf).norm() / bf.norm())
            del bf
        print(f"phase 10 {where}: [{B},16,40,64,4] ctx [{B},{L},1024] {r.out.dtype}: rel_l2 against plain {r.rel:.2e} "
              f"(tol {TOL_F32_PATH})" + (f", against the bf16 forward of the same weights {vs_bf:.4f} (tol "
                                         f"{TOL_F32_VS_BF16})" if mb is not None else "")
              + f" |eps| mean {float(r.out.abs().mean()):.4f} kernels {r.ms:.1f} ms plain {r.plain_ms:.1f} ms "
              f"launches {r.launches} (K3 with image keys {r.i2v_k3})", flush=True)
        if not r.finite or r.rel > TOL_F32_PATH or vs_bf > TOL_F32_VS_BF16 or r.launches != want \
                or r.i2v_k3 != (want["K3"] if kind == "i2v" else 0):
            _fail(f"{where}: rel_l2 {r.rel} against bf16 {vs_bf} finite {r.finite} launches {r.launches}, "
                  f"expected {want}")
        paths[where] = r.launches
        if where == FP32_I2V:
            _profile_forward(where, fwd, r.ms, phase="phase 10")
        del r
    torch.cuda.empty_cache()
    records = _fp32_kernels(sites)
    _phase_levels(i2v_bf.unet.cfg, F32, ("t", "s"), "phase 10")

    held = {key for calls in sites.values() for key in calls}
    errs, calls = {}, collections.Counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fp32_")
    try:
        image = _png(os.path.join(tmp, "crop.png"), smooth_panorama(512, 1024, seed=5)[:320, :512])
        for mode, m in (("t2v", t2v32), ("i2v", i2v32)):
            paths[f"fp32 sample {mode}"] = _fp32_sample(m, mode, image, tmp, calls)
        for k, e in _hold_new_shapes(calls, held, "phase 10").items():
            errs[k] = max(errs.get(k, 0.0), e)
        pano = _png(os.path.join(tmp, "pano.png"), smooth_panorama(512, 1024, seed=5))
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        vargs = cli.VArgs.from_args(["--pano_image_path", pano, "--output_dir", tmp, "--project_name", "fp32",
                                     "--dtype", "float32", "--dev_full_random", "true", *FP32_CLI_STEPS])
        _, launches, e, _ = _cli_run(i2v32, vargs, held, "phase 10")
        flags = _tf32_flags()
        print(f"phase 10 gen_pano_360 --dtype float32: TF32 flags after startup (cudnn, matmul) {flags}", flush=True)
        if flags != (False, False):
            _fail(f"gen_pano_360 --dtype float32 left TF32 on: {flags}")
        paths["fp32 cli"] = launches
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_ref = sum(p.numel() for _, mm in i2v32.components() for p in mm.parameters())
    del t2v32, i2v32
    torch.cuda.empty_cache()

    # the --dev_full_random bundle at fp32, and fp32 weights through the checkpoint loader
    t0 = time.perf_counter()
    full = cli.build_model(cli.VArgs.from_args(["--dev_full_random", "true", "--dtype", "float32"]))
    params = [p for _, mm in full.components() for p in mm.parameters()]
    value = torch.tensor(0.01, dtype=F32, device=DEV)
    ok = all(p.device == DEV and p.dtype == F32 and bool((p == value).all()) for p in params)
    n = sum(p.numel() for p in params)
    print(f"phase 10 --dev_full_random --dtype float32: {n / 1e9:.3f}B parameters (random bundle {n_ref / 1e9:.3f}B), "
          f"all fp32 0.01 on {DEV}: {ok}, built in {time.perf_counter() - t0:.2f} s", flush=True)
    del full, params
    torch.cuda.empty_cache()
    if not ok or n != n_ref:
        _fail("the fp32 --dev_full_random bundle is not the full i2v bundle with every fp32 parameter 0.01 on the card")
    tiny_cfg = tiny_test_config(True)
    src = LatentVideoDiffusion.init_random(tiny_cfg, torch.Generator(device=DEV).manual_seed(3),
                                           tokenizer=HashTokenizer(512))
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        sd = {weights.COMPONENT_PREFIXES[name] + k: v for name, mm in src.components()
              for k, v in mm.state_dict().items()}
        path = os.path.join(ckpt_dir, "tiny.ckpt")
        torch.save({"state_dict": sd}, path)
        loaded = LatentVideoDiffusion.build(tiny_cfg, "cuda").load_state_dicts(
            **weights.load_videocrafter_checkpoint(path, tiny_cfg))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    pairs = [(a, b) for (_, ma), (_, mb) in zip(src.components(), loaded.components())
             for a, b in zip(ma.state_dict().values(), mb.state_dict().values())]
    ok = all(b.dtype == a.dtype and b.device.type == "cuda" and torch.equal(a, b) for a, b in pairs) and all(
        a.dtype == F32 for a, _ in pairs if a.is_floating_point())
    print(f"phase 10 checkpoint: the tiny fp32 bundle's {len(pairs)} tensors through load_videocrafter_checkpoint "
          f"and load_state_dicts on the card, fp32 and equal bit for bit: {ok}", flush=True)
    if not ok:
        _fail("the checkpoint loader did not carry fp32 weights across")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(f"phase 10 ok in {time.perf_counter() - t_phase:.1f} s", flush=True)
    for k in FP32_KERNELS:
        records[k]["max_abs_err"] = max(records[k]["max_abs_err"], errs.get(k, 0.0))
    return records, paths



# ---------------------------------------------------------------------------
# phase 11: the window-batch mesh at world size 1
# ---------------------------------------------------------------------------


def _phase_mesh(model):
    """Phase 11: phase 6's stage-1 step and phase 5's stage-2 request, each
    without a mesh and on a one-rank NCCL mesh, equal bit for bit with equal
    launches. Returns the mesh runs' launches by path."""
    import torch.distributed as dist

    from dynamicscaler_tpu_torch.parallel import mesh as mesh_lib
    from dynamicscaler_tpu_torch.pipelines import i2v, sphere

    t_phase = time.perf_counter()
    if dist.is_initialized():
        _fail("phase 11: a process group is already initialised")
    mesh_lib.init_rank(0, 1, mesh_lib.free_port(), "cuda")
    try:
        mesh = mesh_lib.make_mesh(n_data=1)
        print(f"phase 11: NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, backend "
              f"{dist.get_backend()}, mesh {mesh.n_data} x {mesh.n_seq} on {mesh.device}", flush=True)
        sphere_pano = smooth_panorama(1024, 2048, seed=9)
        stage2_pano = smooth_panorama(512, 1024, seed=5)
        runs = {
            "sphere": (1, lambda m: sphere.sample_shift_sphere_panorama(
                model, CLI_PROMPT, sphere_pano, denoise_to_step=1, mesh=m,
                generator=torch.Generator(device=DEV).manual_seed(17), **SPHERE_KW)[1:]),
            "i2v": (2, lambda m: i2v.sample_shift_multi_windows(
                model, STAGE2_PROMPT, stage2_pano, skip_time_step_idx=46, mesh=m,
                generator=torch.Generator(device=DEV).manual_seed(13), **STAGE2_KW)),
        }
        paths = {}
        for name, (steps, fn) in runs.items():
            got = {}
            for on in (False, True):
                mesh.take_gather_seconds()
                _reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = fn(mesh if on else None)
                torch.cuda.synchronize()
                got[on] = (outs, _launches(), time.perf_counter() - t0, mesh.take_gather_seconds())
            (ref, ref_n, ref_s, _), (outs, n, sec, (gathers, gather_s)) = got[False], got[True]
            same = [bool(torch.equal(a, b)) for a, b in zip(outs, ref)]
            print(f"phase 11 {name} ({steps} step{'s' * (steps > 1)}): without a mesh {ref_s:.2f} s, on the "
                  f"one-rank mesh {sec:.2f} s with {gathers} window batches, {1e3 * gather_s / max(gathers, 1):.3f} "
                  f"ms each in their collectives (rank 0's inputs broadcast, the eps gathered); outputs "
                  f"{[tuple(o.shape) for o in outs]} bit-identical {same}; launches equal {n == ref_n}", flush=True)
            if not all(same) or n != ref_n or gathers != steps:
                _fail(f"phase 11 {name}: bit-identical {same}, launches {n} against {ref_n}, window batches "
                      f"{gathers} (expected {steps})")
            paths[f"mesh {name}"] = n
    finally:
        dist.destroy_process_group()
    print(f"phase 11 ok in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths



# ---------------------------------------------------------------------------
# phase 12: temporal relative position; the pooled and alternate encoders
# ---------------------------------------------------------------------------

RELPOS_FWD = "rel-pos t2v UNet fwd batch 2"


def _relpos_unet():
    """The full-width VideoCrafter2 t2v UNet with relative position on the
    card in fp32: seeded random weights (the tables drawn like every
    weight), the zero-initialised layers perturbed."""
    from dynamicscaler_tpu_torch.config import videocrafter2_t2v
    from dynamicscaler_tpu_torch.models.lvdm import init_module_random
    from dynamicscaler_tpu_torch.models.unet3d import UNet3D, is_zero_init
    from dynamicscaler_tpu_torch.utils.weights import perturb_zero_params

    cfg = dataclasses.replace(videocrafter2_t2v().unet, use_relative_position=True)
    gen = torch.Generator(device=DEV).manual_seed(4)
    with torch.device("meta"):
        unet = UNet3D(cfg)
    unet.to_empty(device=DEV)
    init_module_random(unet, gen, is_zero_init)
    perturb_zero_params(unet, gen)
    return unet.eval()


def _phase_relpos(held):
    """Phase 12, the rel-pos forwards: fp32, then bf16 (the same weights
    rounded), each against the plain versions with exact launches; the
    kernel calls at new shapes held with their type's gates. Returns the
    launches by path and the largest error per kernel by dtype."""
    t_phase = time.perf_counter()
    unet = _relpos_unet()
    tables = sum(n.endswith("embeddings_table") for n, _ in unet.named_parameters())
    x, ctx, t = _unet_inputs(2, 77, 12)
    sites, paths, errs = {}, {}, {}
    for dt, where, tol in ((F32, f"fp32 {RELPOS_FWD}", TOL_F32_PATH), (BF, RELPOS_FWD, TOL_PATH_REL_L2)):
        unet.to(dt)

        def fwd():
            with torch.inference_mode():
                return unet(x, t, ctx, 16)

        want = expected_launches(unet.cfg, 40, 64, dtype=dt)
        r = _against_plain(where, fwd, sites, 2, 1)
        print(f"phase 12 {where}: [2,16,40,64,4] ctx [2,77,1024] {dt}, {tables} relative-position tables: rel_l2 "
              f"against plain {r.rel:.3e} (tol {tol}) |eps| mean {float(r.out.float().abs().mean()):.4f} kernels "
              f"{r.ms:.1f} ms plain {r.plain_ms:.1f} ms launches {r.launches}", flush=True)
        if not r.finite or r.rel > tol or r.launches != want:
            _fail(f"{where}: rel_l2 {r.rel} finite {r.finite} launches {r.launches}, expected {want}")
        paths[where] = r.launches
        del r
        errs[dt] = _hold_new_shapes(sites[where], held, "phase 12")
    del unet
    torch.cuda.empty_cache()
    print(f"phase 12 rel-pos forwards ok in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths, errs


def _phase_encoders():
    """Phase 12, the encoders: full-width pooled image embedders (ViT-H/14,
    the OpenCLIP one with an injected dropout mask, the QuickGELU one on the
    same weights), the HF CLIP-L text encoder and T5 v1.1-large (its query
    weights scaled as T5 initialises them), seeded weights on the CPU, then
    once on the card in fp32 (TF32 off) against the CPU's output, rel L2
    within TOL_F32_PATH."""
    from dynamicscaler_tpu_torch.config import CLIPVisionConfig
    from dynamicscaler_tpu_torch.models.clip import ClipImageEmbedder, OpenCLIPImageEmbedderPooled
    from dynamicscaler_tpu_torch.models.encoders_alt import (HFCLIPTextConfig, HFCLIPTextEncoder, T5Config,
                                                             T5TextEncoder)
    from dynamicscaler_tpu_torch.models.lvdm import init_module_random

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(12)
    rng = np.random.default_rng(12)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 320, 512, 3)).astype(np.float32))
    clip_cfg, t5_cfg = HFCLIPTextConfig(), T5Config()
    clip_tok = rng.integers(1, clip_cfg.vocab_size - 1, (2, 77))
    clip_tok[:, 12] = clip_cfg.vocab_size - 1  # the EOT id, the largest
    t5_tok = rng.integers(0, t5_cfg.vocab_size, (2, 77))
    pooled = OpenCLIPImageEmbedderPooled(CLIPVisionConfig(), ucg_rate=0.5)
    quick = ClipImageEmbedder(CLIPVisionConfig())
    clip_text, t5 = HFCLIPTextEncoder(clip_cfg), T5TextEncoder(t5_cfg)
    for mod in (pooled, clip_text, t5):
        init_module_random(mod, g)
    with torch.no_grad():
        # T5's logits are unscaled: its initialisation folds 1 / sqrt(d_kv)
        # into the query weights. Without it the random tower's softmaxes are
        # near one-hot and 24 layers amplify the card's and the CPU's orders
        # of summation to a rel L2 of 5.7e-3 on an H100.
        for blk in t5.encoder.block:
            blk.layer[0].SelfAttention.q.weight.mul_(t5_cfg.d_kv ** -0.5)
    quick.load_state_dict(pooled.state_dict())
    runs = [("OpenCLIPImageEmbedderPooled ViT-H/14", pooled, images, dict(keep=torch.tensor([1.0, 0.0]))),
            ("ClipImageEmbedder ViT-H/14 (QuickGELU)", quick, images, {}),
            ("HFCLIPTextEncoder CLIP-L/14", clip_text, clip_tok, {}),
            ("T5TextEncoder v1.1-large", t5, t5_tok, {})]
    del pooled, quick, clip_text, t5
    bad = []
    while runs:
        name, mod, inp, kw = runs.pop(0)
        mod.eval()
        n = sum(p.numel() for p in mod.parameters())
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = mod(inp, **kw)
        cpu_s = time.perf_counter() - t0
        mod.to(DEV)
        dinp = inp.to(DEV) if torch.is_tensor(inp) else inp  # token ids (numpy) go to the module's device
        with torch.inference_mode():
            mod(dinp, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = mod(dinp, **kw)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = got.float().cpu()
        rel = float((got - ref).norm() / ref.norm())
        finite = bool(torch.isfinite(got).all())
        print(f"phase 12 {name}: {n / 1e6:.1f}M fp32 parameters, input {tuple(inp.shape)} -> {tuple(got.shape)}; "
              f"card {ms:.2f} ms, CPU {cpu_s:.2f} s; rel_l2 card against CPU {rel:.3e} (tol {TOL_F32_PATH}) "
              f"finite {finite}", flush=True)
        if not finite or not rel <= TOL_F32_PATH:
            bad.append(name)
        mod.to("cpu")
        del mod
    torch.cuda.empty_cache()
    if bad:
        _fail(f"phase 12: the card's fp32 encoders disagree with the CPU: {bad}")
    print(f"phase 12 ok: encoders in {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 13: the dead-upstream modules: models/vae_aux.py, models/x_transformer.py
# ---------------------------------------------------------------------------

# Ho et al.'s DDPM LSUN-256 (hojonathanho/diffusion, diffusion/scripts/run_lsun.py): ch 128, ch_mult
# (1, 1, 2, 2, 4, 4), 2 ResNet blocks, attention at 16x16, 256x256x3 (about 114M parameters)
LSUN_256 = dict(ch=128, out_ch=3, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2, attn_resolutions=(16,),
                in_channels=3, resolution=256)
# LDM's BERTEmbedder (CompVis latent-diffusion configs/latent-diffusion/txt2img-1p4B-eval.yaml):
# vocabulary 30522, 77 positions, Encoder(dim 1280, depth 32), 8 heads of 64 (about 540M parameters)
BERT_1P4B = dict(num_tokens=30522, max_seq_len=77, attn_layers_cfg=dict(dim=1280, depth=32, heads=8))
# an AttentionLayers stack at the same width with the knobs the wrapper leaves off
XSTACK = dict(dim=1280, depth=4, heads=8, cross_attend=True, residual_attn=True, gate_residual=True,
              attn_kwargs={"talking_heads": True, "num_mem_kv": 4, "sparse_topk": 16}, ff_kwargs={"glu": True})


def _k9_sites(module) -> int:
    """K9 calls of one forward of a vae_aux module: each GroupNorm runs once
    through ``models/vae.py::_gn``, but ``FirstStagePostProcessor``'s
    ``proj_norm`` (C // 2 groups, the plain fold)."""
    skip = getattr(module, "proj_norm", None)
    return sum(isinstance(m, torch.nn.GroupNorm) and m is not skip for m in module.modules())


def _scale_linear_attention(mod) -> None:
    """Scale the q and v rows of each ``LinAttnBlock``'s ``to_qkv`` by
    C^-1/2. The block (no norm, no residual, unscaled ``context · q``) maps
    an input of size |x| to about sqrt(C) |x|^2 at N(0, 1/fan_in) weights,
    so at random weights the six blocks of the LSUN-256 Model square their
    way past fp32 (a CPU run: 7.2 -> 355 -> 4.3e5 -> 3.9e11 -> 3.3e22 ->
    NaN); scaled, they keep their outputs at 0.07-0.7 beside ResNet
    outputs of 1.4-7."""
    from dynamicscaler_tpu_torch.models.vae_aux import LinAttnBlock

    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, LinAttnBlock):
                C = m.to_out.weight.shape[0]
                m.to_qkv.weight[:C].mul_(C ** -0.5)
                m.to_qkv.weight[2 * C:].mul_(C ** -0.5)


def _aux_runs(rn):
    """(name, module builder on the card in fp32, inputs) of each vae_aux run."""
    from dynamicscaler_tpu_torch.config import VAEConfig
    from dynamicscaler_tpu_torch.models import vae_aux as A

    lsun = A.AuxModelConfig(**LSUN_256)
    t = torch.tensor([10, 250, 500, 999], device=DEV)
    img = rn(4, 256, 256, 3)
    return [
        ("Model LSUN-256 vanilla [4,256,256,3]", lambda: A.Model(lsun, device=DEV), (img, t)),
        ("Model LSUN-256 linear [4,256,256,3]",
         lambda: A.Model(dataclasses.replace(lsun, attn_type="linear"), device=DEV), (img, t)),
        ("MergedRescaleEncoder VAE widths [2,320,512,3]",
         lambda: A.MergedRescaleEncoder(VAEConfig(), out_ch=4, device=DEV), (rn(2, 320, 512, 3),)),
        ("MergedRescaleDecoder VAE widths z 8 [2,40,64,8]",
         lambda: A.MergedRescaleDecoder(VAEConfig(z_channels=8), device=DEV), (rn(2, 40, 64, 8),)),
        ("Upsampler 64->256 [2,64,64,64]", lambda: A.Upsampler(64, 256, 64, 3, device=DEV), (rn(2, 64, 64, 64),)),
        ("SimpleDecoder [2,40,64,128]", lambda: A.SimpleDecoder(128, 3, device=DEV), (rn(2, 40, 64, 128),)),
        ("UpsampleDecoder [2,40,64,128]", lambda: A.UpsampleDecoder(128, 3, 128, 2, (2, 2), device=DEV),
         (rn(2, 40, 64, 128),)),
        ("FirstStagePostProcessor [2,40,64,4]",
         lambda: A.FirstStagePostProcessor((1, 2), 4, 128, do_reshape=True, device=DEV), (rn(2, 40, 64, 4),)),
    ]


def _phase_aux(held):
    """Phase 13, vae_aux: each module with seeded random weights (the
    zero-initialised ones perturbed, the linear attention's q and v scaled:
    :func:`_scale_linear_attention`) in fp32, then bf16 (the same weights
    rounded), through the kernels against the plain versions (rel L2 within
    ``TOL_F32_PATH`` / ``TOL_PATH_REL_L2``), finite, K9 launched exactly once
    at each of its GroupNorm sites and no other kernel; the K9 calls at
    shapes no earlier phase held against their plain versions with the gates
    of their type. Returns the launches by path and the largest error per
    kernel by dtype."""
    from dynamicscaler_tpu_torch.models.lvdm import init_module_random
    from dynamicscaler_tpu_torch.utils.weights import perturb_zero_params

    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(13)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    sites, paths, errs, bad = {}, {}, {F32: {}, BF: {}}, []
    for name, build, inputs in _aux_runs(rn):
        mod = build().eval()
        init_module_random(mod, gen)
        perturb_zero_params(mod, gen)
        _scale_linear_attention(mod)
        n_par, n_k9 = sum(p.numel() for p in mod.parameters()), _k9_sites(mod)
        for dt, tol in ((F32, TOL_F32_PATH), (BF, TOL_PATH_REL_L2)):
            mod.to(dt)
            where = f"{'fp32 ' if dt == F32 else ''}aux {name}"

            def fwd():
                with torch.inference_mode():
                    return mod(*inputs)

            r = _against_plain(where, fwd, sites, 2, 1)
            want = dict.fromkeys(KERNELS, 0)
            want["K9"], want["GN"] = n_k9, _k9_split(sites[where])
            print(f"phase 13 {where}: {n_par / 1e6:.1f}M {dt} parameters -> {tuple(r.out.shape)}: rel_l2 against "
                  f"plain {r.rel:.3e} (tol {tol}) finite {r.finite} kernels {r.ms:.2f} ms plain {r.plain_ms:.2f} ms "
                  f"launches K9 {r.launches['K9']} (GroupNorm sites {n_k9}), GN {r.launches['GN']}", flush=True)
            if not r.finite or not r.rel <= tol or r.launches != want:
                bad.append(f"{where}: rel_l2 {r.rel} finite {r.finite} launches {r.launches}, expected {want}")
            paths[where] = r.launches
            del r
            for k, e in _hold_new_shapes(sites[where], held, "phase 13").items():
                errs[dt][k] = max(errs[dt].get(k, 0.0), e)
        del mod
        torch.cuda.empty_cache()
    if bad:
        _fail(f"phase 13: {bad}")
    print(f"phase 13 vae_aux ok in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths, errs


def _xtransformer_runs(g):
    """(name, module on the CPU with seeded weights, inputs, forward keyword
    arguments) of the x-transformer runs."""
    from dynamicscaler_tpu_torch.models import x_transformer as X
    from dynamicscaler_tpu_torch.models.lvdm import init_module_random
    from dynamicscaler_tpu_torch.utils.weights import perturb_zero_params

    wrapper = X.TransformerWrapper(**BERT_1P4B, device="cpu")
    stack = X.AttentionLayers(**XSTACK, device="cpu")
    for mod in (wrapper, stack):
        init_module_random(mod, g)
        perturb_zero_params(mod, g)
    tokens = torch.randint(0, BERT_1P4B["num_tokens"], (2, 77), generator=g)
    x, ctx = torch.randn((2, 77, 1280), generator=g), torch.randn((2, 64, 1280), generator=g)
    cmask = torch.ones((2, 64), dtype=torch.bool)
    cmask[:, 48:] = False
    return [("TransformerWrapper BERTEmbedder 1.4B-eval (Encoder dim 1280 depth 32), return_embeddings",
             wrapper, (tokens,), {"return_embeddings": True}),
            ("AttentionLayers dim 1280 depth 4 (talking heads, memory KV 4, sparse top-16, GEGLU, GRU gating, "
             "residual attention, cross-attention with a context mask)", stack, (x,),
             {"context": ctx, "context_mask": cmask})]


@contextlib.contextmanager
def _topk_selections(kept, replay=False):
    """Record in ``kept`` the logits each sparse top-k call of
    ``x_transformer`` keeps (bool, on the CPU), or with ``replay`` keep those
    recorded instead, in the same order, while counting the rows where the
    call's own selection differs and the largest top-k margin (the k-th
    minus the (k+1)-th largest logit, over max|logit|) among them. Top-k is
    discontinuous where a row's k-th and (k+1)-th logits tie within the
    rounding of fp32 sums (a margin of 2.3e-6 in a CPU run of the stack at
    logits up to 10.6; the CPU's fp32 logits were up to 1.1e-5 from fp64's),
    so the card and the CPU may keep different logits there: the CPU
    reference takes the card's, and any row where they differ must be such
    a tie. Yields a dict of ``rows`` and ``margin``."""
    from dynamicscaler_tpu_torch.models import x_transformer as X

    keep_topk, diff = X.keep_topk, {"rows": 0, "margin": 0.0}

    def wrapped(dots, k, mask_value):
        vals = torch.topk(dots, k + 1, dim=-1).values
        own = dots >= vals[..., k - 1:k]
        if not replay:
            kept.append(own.cpu())
            return keep_topk(dots, k, mask_value)
        card = kept.pop(0).to(dots.device)
        rows = (card != own).any(dim=-1)
        if bool(rows.any()):
            margin = (vals[..., k - 1] - vals[..., k])[rows].max() / dots[dots > mask_value].abs().max()
            diff["rows"] += int(rows.sum())
            diff["margin"] = max(diff["margin"], float(margin))
        return dots.masked_fill(~card, mask_value)

    X.keep_topk = wrapped
    try:
        yield diff
    finally:
        X.keep_topk = keep_topk


# a row where the card and the CPU keep different top-k logits must be a tie within fp32 rounding
TOPK_TIE = 1e-4


def _phase_xtransformer():
    """Phase 13, the x-transformer: the modules with seeded weights, once on
    the card in fp32 (TF32 off), then on the CPU, rel L2 within
    ``TOL_F32_PATH``; the CPU's sparse top-k keeps the logits the card kept
    (:func:`_topk_selections`)."""
    t_phase = time.perf_counter()
    runs = _xtransformer_runs(torch.Generator().manual_seed(13))
    bad = []
    while runs:
        name, mod, args, kw = runs.pop(0)
        mod.eval().to(DEV)
        n = sum(p.numel() for p in mod.parameters())
        dargs = [a.to(DEV) for a in args]
        dkw = {k: v.to(DEV) if torch.is_tensor(v) else v for k, v in kw.items()}
        kept = []
        with torch.inference_mode():
            mod(*dargs, **dkw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _topk_selections(kept):
                got = mod(*dargs, **dkw)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = got.float().cpu()
        mod.to("cpu")
        t0 = time.perf_counter()
        with torch.inference_mode(), _topk_selections(kept, replay=True) as diff:
            ref = mod(*args, **kw)
        cpu_s = time.perf_counter() - t0
        rel = float((got - ref).norm() / ref.norm())
        finite = bool(torch.isfinite(got).all())
        ties_ok = not kept and diff["margin"] <= TOPK_TIE
        print(f"phase 13 {name}: {n / 1e6:.1f}M fp32 parameters, input {tuple(args[0].shape)} -> "
              f"{tuple(got.shape)}; card {ms:.2f} ms, CPU {cpu_s:.2f} s; rel_l2 card against CPU {rel:.3e} "
              f"(tol {TOL_F32_PATH}) finite {finite}; sparse top-k rows where the card's selection differs from "
              f"the CPU's {diff['rows']}, largest margin among them {diff['margin']:.1e} of max|logit| "
              f"(tol {TOPK_TIE})", flush=True)
        if not finite or not rel <= TOL_F32_PATH or not ties_ok:
            bad.append(name)
        del mod, ref, got
    torch.cuda.empty_cache()
    if bad:
        _fail(f"phase 13: the card's fp32 x-transformer disagrees with the CPU: {bad}")
    print(f"phase 13 ok: x-transformer in {time.perf_counter() - t_phase:.1f} s", flush=True)

# ---------------------------------------------------------------------------
# phase 14: DynamiCrafter 1024 at its 72x128 latent
# ---------------------------------------------------------------------------

DC_FWD = "DynamiCrafter UNet fwd batch 8, 72x128"
DC_LOGITS_MAX = 8 << 30  # bytes of one head's fp32 logits a plain attention may hold


def _dc_slice(key, B, rows=16):
    """A recorded K2 / FA call whose plain version's logits would pass
    ``DC_LOGITS_MAX``, cut to its first ``rows`` batch rows (one clip)."""
    k, pos, opts = key
    q = pos[0][0]
    if k not in ("K2", "FA") or q[0] * q[1] * q[1] * 4 <= DC_LOGITS_MAX:
        return key

    def cut(d):
        if isinstance(d, tuple) and len(d) == 2 and isinstance(d[0], tuple) and len(d[0]) == 3 and d[0][0] == B:
            return ((rows,) + d[0][1:], d[1])
        return d
    return k, tuple(cut(d) for d in pos), opts


def _flash_table(calls):
    """``ds_flash_attention`` at every recorded shape of ``calls``: ms,
    TFLOP/s, share of 989, the bound (operations over 989 TFLOP/s or q, the
    keys, values and output once over 3.35 TB/s) and one SDPA call a key
    segment on the same operands."""
    rn = _gen()
    tot = collections.Counter()
    for key, n in sorted(calls.items(), key=str):
        if key[0] != "FA":
            continue
        k, pos, opts = key
        case = _case(k, pos, dict(opts), rn)
        ms, lib_ms = _time_ms(case.run, 5), _time_ms(case.library, 5)
        shapes = [d[0] for d in key[1] if isinstance(d, tuple) and len(d) == 2 and isinstance(d[0], tuple)]
        nbytes = 2 * (sum(math.prod(sh) for sh in shapes) + math.prod(shapes[0]))  # the output is q's shape
        bound = max(case.flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
        print(f"phase 14 flash {case.desc} x{n} per forward: kernel {ms:.3f} ms ({case.flops / ms / 1e9:.0f} "
              f"TFLOP/s, {100 * case.flops / (ms * 1e-3) / PEAK_BF16:.1f}% of 989) bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}% of it) SDPA {lib_ms:.3f} ms", flush=True)
        tot["ms"] += n * ms
        tot["lib"] += n * lib_ms
        tot["bound"] += n * bound
        del case
    torch.cuda.empty_cache()
    print(f"phase 14 flash sums per {DC_FWD}: kernel {tot['ms']:.2f} ms, SDPA {tot['lib']:.2f} ms, "
          f"bound {tot['bound']:.2f} ms", flush=True)


def _phase_dynamicrafter(held):
    """Phase 14 (see the module docstring). Returns the forward's launches."""
    from dynamicscaler_tpu_torch.config import dynamicrafter_i2v_1024
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
    from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer
    from dynamicscaler_tpu_torch.utils.weights import perturb_zero_params

    t0 = time.perf_counter()
    cfg = dynamicrafter_i2v_1024()
    gen = torch.Generator(device=DEV).manual_seed(14)
    model = LatentVideoDiffusion.init_random(cfg, gen, tokenizer=HashTokenizer())
    perturb_zero_params(model.unet, gen)
    n = sum(p.numel() for _, m in model.components() for p in m.parameters())
    print(f"phase 14 model dynamicrafter_1024: {n / 1e9:.3f}B random bf16 weights in {time.perf_counter() - t0:.1f} s",
          flush=True)
    B, Fn, H, W = 8, 16, 72, 128
    L = cfg.unet.text_context_len + Fn * cfg.unet.image_tokens_per_frame
    g = torch.Generator(device=DEV).manual_seed(15)
    x = torch.randn((B, Fn, H, W, cfg.unet.in_channels), generator=g, device=DEV)
    ctx = torch.randn((B, L, cfg.unet.context_dim), generator=g, device=DEV)
    t = torch.full((B,), 999, device=DEV)

    def fwd(rows=slice(None)):
        return model.apply_unet(x[rows], t[rows], ctx[rows], 10)
    calls = collections.Counter()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with _recording(calls), _recording_gemms(GEMM_SITES.setdefault(DC_FWD, collections.Counter())):
        got = fwd()
    torch.cuda.synchronize()
    launches, want = _launches(), expected_launches(cfg.unet, H, W, Fn)
    peak = torch.cuda.max_memory_allocated()
    ms = _wall_ms(fwd, 2)
    rels = []
    with cuda_lib.plain_kernels():
        for r in (0, B - 1):
            ref = fwd(slice(r, r + 1))
            rels.append(float((got[r:r + 1].float() - ref.float()).norm() / ref.float().norm()))
            del ref
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all())
    print(f"phase 14 {DC_FWD}: x [{B},{Fn},{H},{W},{cfg.unet.in_channels}] ctx [{B},{L},1024] -> "
          f"{tuple(got.shape)}: rel_l2 rows 0 / {B - 1} {rels[0]:.5f} / {rels[1]:.5f} (tol {TOL_PATH_REL_L2}) "
          f"|v| mean {float(got.abs().mean()):.4f} kernels {ms:.1f} ms peak memory {peak / 2**30:.2f} GiB "
          f"launches {launches}", flush=True)
    del got
    if not finite or max(rels) > TOL_PATH_REL_L2:
        _fail(f"{DC_FWD}: the kernel path disagrees with the plain path: rel_l2 {rels} finite {finite}")
    if launches != want:
        _fail(f"{DC_FWD}: launch counts {launches} != {want}")
    _profile_forward(DC_FWD, fwd, ms, phase="phase 14")
    torch.cuda.empty_cache()
    sliced = collections.Counter()
    for key, k_n in calls.items():
        sliced[_dc_slice(key, B * Fn)] += k_n
    errs = _hold_new_shapes(sliced, held, "phase 14")
    _flash_table(calls)
    _phase_gemms(GEMM_SITES[DC_FWD], phase="phase 14", where=DC_FWD)
    del model, x, ctx
    torch.cuda.empty_cache()
    _phase_levels(cfg.unet, phase="phase 14", hw=(H, W))
    print(f"phase 14 ok: largest errors at new shapes {errs}", flush=True)
    return launches


def _only(phase: str) -> None:
    """``--phase 14``: phase 1's build, then phase 14 alone."""
    if phase != "14":
        _fail(f"--phase {phase}: only 14 runs alone")
    if not torch.cuda.is_available():
        _fail("no CUDA device: the port's smoke run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = cuda_lib.build(verbose=True)
    cuda_lib.library()
    print(f"phase 1 ok: built {lib.relative_to(cuda_lib.REPO_ROOT)} in {time.perf_counter() - t0:.1f} s "
          f"on {torch.cuda.get_device_name(0)} [{smi}]", flush=True)
    _phase_dynamicrafter(set())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--phase":
        _only(sys.argv[2])
    else:
        main()
