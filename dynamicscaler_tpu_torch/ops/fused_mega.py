"""Kernels 12 and 13: the whole TemporalTransformer and the whole
SpatialTransformer (depth 1) with folded GroupNorm.

Counterparts of ``dynamicscaler_tpu/ops/fused_mega.py``:

* ``temporal_transformer`` -> kernel 12 (Pallas ``_t_mega_call``):
  GroupNorm apply -> frame permute -> proj_in -> the whole temporal block
  (kernel 10's) -> proj_out -> permute back -> + x, over x5 [B, F, H, W, C]
  with inner == C;
* ``spatial_transformer`` -> kernel 13 (``_s_mega_call``): GroupNorm apply
  -> proj_in -> LN1 -> N-token self-attention -> + h, LN2 -> text (+ image)
  cross-attention -> + h, LN3 -> GEGLU FF -> + h -> proj_out -> + x, over x
  [BF, H, W, C].

Weights are in torch ``Linear`` layout ``[out, in]``. The spatial context is
given per CLIP, ``ctx`` [clips, L, Dc] with BF = clips * frames: the UNet
repeats it over a clip's frames, and the kernel projects its K/V once per
clip instead of once per frame sample. With image keys (``attn2`` of 7
weights, i2v) the tokens from ``text_len`` on are image tokens; without them
every token is text.

``temporal_mega`` and ``spatial_mega`` are the kernel wrappers (with their
launch counters ``.launches``): they take the folded GroupNorm vectors
``(mul, add)`` [B, C], which ``temporal_transformer`` and
``spatial_transformer`` compute with the statistics pass
``fused_twrap.group_norm_fold`` (the JAX package leaves it to XLA outside
the kernels; on the card it is ``csrc/gn_silu.cu::ds_gn_stats``). On the card kernel 12 runs as
``csrc/block.cu::ds_temporal_mega`` (one launch, kernel 10's design) and kernel 13 as
``csrc/gemm.cu`` GEMMs (the context K/V once per clip, the GroupNorm apply ->
proj_in head, LN1 -> q|k|v) and one launch of ``csrc/mega.cu::ds_mega_spatial``
(the body and proj_out on kernel 10's design); see the notes there. The
plain versions are the plain versions of kernels 5, 10 and 6, and of 7, 2,
3, 4 and 8, in sequence, which hold the TPU kernels' rounding points.

The gates :func:`temporal_ok` and :func:`spatial_ok` are the JAX package's
shape conditions without its TPU tiling terms; the module dispatch routes by
them and the wrappers refuse what they do not admit. An fp32 activation
takes the fp32 kernels instead, with the same operands in fp32:
``csrc/temporal_f32.cu::ds_temporal_mega_f32`` (one launch on the tensor
cores, kernel 10's at fp32 with the wrapper's products; the weights split
once each), and the same GEMM heads (``ds_ln_gemm_f32``) then
``csrc/spatial_f32.cu::ds_mega_spatial_f32`` (one launch on the tensor
cores: kernel 11's body at fp32, the N-token and cross-attention included,
and proj_out).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamicscaler_tpu_torch.ops import cuda_lib, fused_twrap
from dynamicscaler_tpu_torch.ops.fused_block import (
    BlockOperands,
    refuse_unless,
    block_pointers,
    block_weights,
    check_block_operands,
    check_spatial_operands,
    pack_spatial_block,
    pack_temporal_block,
    spatial_block_ok,
    spatial_block_plain,
    spatial_launch,
    temporal_block_plain,
)
from dynamicscaler_tpu_torch.ops.fused_temporal import frames_ok
from dynamicscaler_tpu_torch.ops.fused_twrap import (
    head_spatial_plain,
    head_temporal_plain,
    pack_wrapper,
    tail_spatial_plain,
    tail_temporal_plain,
)


class MegaOperands(NamedTuple):
    """Kernel operands of one transformer: the wrapper's (as kernels 5-8
    pack them) and its block's (kernel 12: as kernel 10 packs them; kernel
    13: as kernel 11 does)."""

    w_in: torch.Tensor
    b_in: torch.Tensor
    block: BlockOperands
    w_out: torch.Tensor
    b_out: torch.Tensor
    maps: dict = None  # kernels 12, 13: their weights' TMA maps (eight by cluster size; six), kept with them


def _check_wrapper(op: MegaOperands, C: int, Ci: int, dt: torch.dtype) -> None:
    cuda_lib.check_operand("w_in", op.w_in, dt, (Ci, C))
    cuda_lib.check_operand("w_out", op.w_out, dt, (C, Ci))
    cuda_lib.check_operand("b_in", op.b_in, torch.float32, (Ci,))
    cuda_lib.check_operand("b_out", op.b_out, torch.float32, (C,))


def _check_gn(mul, add, B: int, C: int) -> None:
    cuda_lib.check_operand("gn mul", mul, torch.float32, (B, C))
    cuda_lib.check_operand("gn add", add, torch.float32, (B, C))


# ---------------------------------------------------------------------------
# kernel 12: the whole temporal transformer
# ---------------------------------------------------------------------------


def temporal_ok(frames: int, C: int, inner: int, heads: int) -> bool:
    """Kernel 12's gate: the shape conditions of the JAX package's
    ``temporal_ok`` (fused_mega.py:76-89) without its TPU row tile
    ``_t_th``."""
    return frames_ok(frames) and inner == C and inner % heads == 0 and inner <= 640 and (inner // heads) % 8 == 0


def pack_temporal_mega(w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *, dtype) -> MegaOperands:
    wi, bi, wo, bo = pack_wrapper(w_in, b_in, w_out, b_out, dtype=dtype)
    return MegaOperands(wi, bi, pack_temporal_block(lns, attn1, attn2, ff, dtype=dtype), wo, bo, {})


def temporal_mega_plain(x5, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *, heads, scale,
                        eps=1e-5):
    """Plain PyTorch version of kernel 12: kernels 5, 10 and 6's plain
    versions. x5 [B, F, H, W, C]; mul/add [B, C]; w_in [Ci, C], w_out [C,
    Ci]; lns, attn1, attn2, ff as :func:`fused_block.temporal_block_plain`."""
    h = head_temporal_plain(x5, mul, add, w_in.reshape(w_in.shape[0], -1), b_in)
    h = temporal_block_plain(h, lns, attn1, attn2, ff, heads=heads, scale=scale, eps=eps)
    return tail_temporal_plain(h, x5, w_out.reshape(w_out.shape[0], -1), b_out)


def temporal_mega(x5, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *, heads, scale, eps=1e-5,
                  operands=None, plan=None):
    """Kernel 12 with the folded GroupNorm vectors ``(mul, add)`` [B, C]:
    [B, F, H, W, C] -> [B, F, H, W, C]. On the card one launch (head dim 64,
    inner == C <= 640) of ``ds_temporal_mega`` (bf16) at the tile ``plan``
    (``cuda_lib.block_plan``'s when None) with the TMA maps of its weights,
    or of ``ds_temporal_mega_f32`` (fp32) at the tile ``plan``
    (``cuda_lib.block_f32_plan``'s when None) with its weights split,
    reading ``operands`` (from :func:`pack_temporal_mega`; packed here when
    None)."""
    dt = cuda_lib.check_dtypes("K12", x5)
    if not cuda_lib.use_kernel(x5):
        return temporal_mega_plain(x5, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, heads=heads,
                                   scale=scale, eps=eps)
    B, Fn, H, W, C = x5.shape
    inner = heads * 64
    refuse_unless("12", temporal_ok(Fn, C, inner, heads), f"x5 {tuple(x5.shape)} with {heads} heads")
    cuda_lib.check_operand("x5", x5, dt)
    op = operands or pack_temporal_mega(w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, dtype=dt)
    _check_wrapper(op, C, C, dt)
    check_block_operands(op.block, C, dt)
    _check_gn(mul, add, B, C)
    out = torch.empty_like(x5)
    f32 = dt == torch.float32
    w = cuda_lib.tf32_split_weights if f32 else (lambda t: t)
    ptrs = cuda_lib.ptr_array([x5, out, *block_pointers(op.block, split=f32), mul, add, w(op.w_in), op.b_in,
                               w(op.w_out), op.b_out])
    if f32:
        T = B * Fn * H * W
        plan = plan or cuda_lib.block_f32_plan(C, Fn, T, mega=True)
        scratch = torch.empty(cuda_lib.temporal_f32_scratch(T, C, plan), device=x5.device, dtype=dt)
        cuda_lib.call("ds_temporal_mega_f32", ptrs, B, Fn, H * W, C, float(scale), float(eps), cuda_lib.ptr(scratch),
                      scratch.numel(), cuda_lib.block_f32_grid(plan, T), *plan)
        temporal_mega.launches += 1
        return out
    plan = plan or cuda_lib.block_plan(C, Fn, mega=True)
    maps = cuda_lib.block_maps(op.maps, [*block_weights(op.block), op.w_in, op.w_out], C, plan.cl)
    cuda_lib.call("ds_temporal_mega", ptrs, B, Fn, H * W, C, float(scale), float(eps), maps, *plan)
    temporal_mega.launches += 1
    return out


temporal_mega.launches = 0


def temporal_transformer(x5, gn_scale, gn_bias, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *, heads,
                         scale, gn_eps=1e-6, eps=1e-5, operands=None):
    """The whole TemporalTransformer: the GroupNorm statistics pass over each
    clip, then :func:`temporal_mega`. x5 [B, F, H, W, C]."""
    mul, add = fused_twrap.group_norm_fold(x5, gn_scale, gn_bias, eps=gn_eps)
    return temporal_mega(x5, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, heads=heads,
                         scale=scale, eps=eps, operands=operands)


# ---------------------------------------------------------------------------
# kernel 13: the whole spatial transformer
# ---------------------------------------------------------------------------


def spatial_ok(n_tokens: int, C: int, inner: int, heads: int, ctx_dim: int) -> bool:
    """Kernel 13's gate: the shape conditions of the JAX package's
    ``spatial_ok`` (fused_mega.py:217-230), those of kernel 11's gate at
    width C."""
    return inner == C and spatial_block_ok(n_tokens, inner, C, heads, ctx_dim)


def pack_spatial_mega(w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *, dtype) -> MegaOperands:
    wi, bi, wo, bo = pack_wrapper(w_in, b_in, w_out, b_out, dtype=dtype)
    return MegaOperands(wi, bi, pack_spatial_block(lns, attn1, attn2, ff, dtype=dtype), wo, bo, {})


def spatial_mega_plain(x4, ctx, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *, heads,
                       scale, text_len=77, eps=1e-5):
    """Plain PyTorch version of kernel 13: kernels 7, 11 (2, 3, 4) and 8's
    plain versions. x4 [BF, H, W, C]; ctx [clips, L, Dc]; mul/add [BF, C];
    the block's weights as :func:`fused_block.spatial_block_plain`."""
    h = head_spatial_plain(x4, mul, add, w_in, b_in)
    h = spatial_block_plain(h, ctx, lns, attn1, attn2, ff, heads=heads, scale=scale, text_len=text_len, eps=eps)
    return tail_spatial_plain(h, x4, w_out, b_out)


def spatial_mega(x4, ctx, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *, heads, scale,
                 text_len=77, eps=1e-5, operands=None, plan=None):
    """Kernel 13 with the folded GroupNorm vectors ``(mul, add)`` [BF, C]:
    [BF, H, W, C] -> [BF, H, W, C]. On the card
    :func:`fused_block.spatial_launch` (the context K/V, proj_in and q|k|v
    GEMMs, then one launch of ``ds_mega_spatial``; head dim 64, inner == C
    <= 640; at fp32 ``ds_mega_spatial_f32`` at the query tile ``plan``,
    ``cuda_lib.spatial_f32_plan``'s when None), reading ``operands`` (from
    :func:`pack_spatial_mega`; packed here when None) and their TMA maps."""
    dt = cuda_lib.check_dtypes("K13", x4)
    if not cuda_lib.use_kernel(x4, ctx):
        return spatial_mega_plain(x4, ctx, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out,
                                  heads=heads, scale=scale, text_len=text_len, eps=eps)
    BF, H, W, C = x4.shape
    clips, L, Dc = ctx.shape
    has_img = len(attn2) == 7
    Ci = heads * 64
    refuse_unless("13", spatial_ok(H * W, C, Ci, heads, Dc) and BF % clips == 0 and (not has_img or 0 < text_len < L),
                  f"x {tuple(x4.shape)} ctx {tuple(ctx.shape)} with {heads} heads")
    cuda_lib.check_operand("x", x4, dt)
    op = operands or pack_spatial_mega(w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, dtype=dt)
    _check_wrapper(op, C, Ci, dt)
    check_spatial_operands(op.block, Ci, Dc, has_img, dt)
    _check_gn(mul, add, BF, C)
    out = spatial_launch(x4.reshape(BF, H * W, C), ctx, op.block, (mul, add, op.w_in, op.b_in, op.w_out, op.b_out),
                         op.maps, heads=heads, scale=scale, text_len=text_len, eps=eps, plan=plan)
    spatial_mega.launches += 1
    return out.reshape(x4.shape)


spatial_mega.launches = 0


def spatial_transformer(x4, ctx, gn_scale, gn_bias, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *,
                        heads, scale, text_len=77, gn_eps=1e-6, eps=1e-5, operands=None):
    """The whole SpatialTransformer: the GroupNorm statistics pass, then
    :func:`spatial_mega`. x4 [BF, H, W, C]; ctx [clips, L, Dc] per clip."""
    mul, add = fused_twrap.group_norm_fold(x4, gn_scale, gn_bias, eps=gn_eps)
    return spatial_mega(x4, ctx, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, heads=heads,
                        scale=scale, text_len=text_len, eps=eps, operands=operands)

