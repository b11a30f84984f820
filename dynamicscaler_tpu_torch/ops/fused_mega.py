"""Kernel 13: the whole SpatialTransformer (depth 1) with folded GroupNorm.

Counterpart of ``dynamicscaler_tpu/ops/fused_mega.py``
``spatial_transformer`` (Pallas ``_s_mega_call``): GroupNorm apply ->
proj_in -> LN1 -> N-token self-attention -> + h, LN2 -> text (+ image)
cross-attention -> + h, LN3 -> GEGLU FF -> + h -> proj_out -> + x, over x
[BF, H, W, C]. Weights are in torch ``Linear`` layout ``[out, in]``.

The context is given per CLIP, ``ctx`` [clips, L, Dc] with BF = clips *
frames: the UNet repeats it over a clip's frames, and the kernel projects
its K/V once per clip instead of once per frame sample. With image keys
(``attn2`` of 7 weights, i2v) the tokens from ``text_len`` on are image
tokens; without them every token is text.

``spatial_mega`` is the kernel wrapper (kernel 13, with its launch counter
``spatial_mega.launches``): it takes the folded GroupNorm vectors ``(mul,
add)`` [BF, C], which ``spatial_transformer`` computes with the plain
statistics pass ``fused_twrap.group_norm_fold`` (the JAX package leaves it
to XLA outside the kernel too). On the card the wrapper runs
``csrc/mega.cu::ds_mega_spatial`` (two launches; see the note there); its
plain version is the plain versions of kernels 7, 2, 3, 4 and 8 in
sequence, which hold the TPU kernel's rounding points.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.ops.fused_spatial import (
    ln_cross_attention_plain,
    ln_spatial_attention_plain,
    pack_ln_cross_attention,
)
from dynamicscaler_tpu_torch.ops.fused_temporal import (
    AttnOperands,
    FFOperands,
    ln_geglu_plain,
    pack_ln_attention,
    pack_ln_geglu,
)
from dynamicscaler_tpu_torch.ops.fused_twrap import (
    group_norm_fold,
    head_spatial_plain,
    pack_wrapper,
    tail_spatial_plain,
)


class MegaOperands(NamedTuple):
    """Kernel operands of one SpatialTransformer: the wrapper's (as kernels
    7/8 pack them) and the block's (as K2, K3 and K4 pack them)."""

    w_in: torch.Tensor
    b_in: torch.Tensor
    attn1: AttnOperands
    attn2: AttnOperands
    ff: FFOperands
    w_out: torch.Tensor
    b_out: torch.Tensor


def pack_spatial_mega(w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *, dtype) -> MegaOperands:
    s1, b1, s2, b2, s3, b3 = lns
    wi, bi, wo, bo = pack_wrapper(w_in, b_in, w_out, b_out, dtype=dtype)
    return MegaOperands(wi, bi, pack_ln_attention(s1, b1, *attn1, dtype=dtype),
                        pack_ln_cross_attention(s2, b2, *attn2, dtype=dtype),
                        pack_ln_geglu(s3, b3, *ff, dtype=dtype), wo, bo)


def spatial_mega_plain(x4, ctx, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *, heads,
                       scale, text_len=77, eps=1e-5):
    """Plain PyTorch version of kernel 13. x4 [BF, H, W, C]; ctx [clips, L,
    Dc]; mul/add [BF, C]; lns (s1, b1, s2, b2, s3, b3); attn1 (wq, wk, wv,
    wo, bo); attn2 the same, + (wk_ip, wv_ip) with image keys; ff (w1, b1,
    w2, b2)."""
    s1, b1, s2, b2, s3, b3 = lns
    ctx_s = ctx.repeat_interleave(x4.shape[0] // ctx.shape[0], dim=0)
    h = head_spatial_plain(x4, mul, add, w_in, b_in)
    h = ln_spatial_attention_plain(h, s1, b1, *attn1, heads=heads, scale=scale, eps=eps)
    h = ln_cross_attention_plain(h, ctx_s, s2, b2, *attn2, heads=heads, scale=scale, text_len=text_len,
                                 eps=eps)
    h = ln_geglu_plain(h, s3, b3, *ff, eps=eps)
    return tail_spatial_plain(h, x4, w_out, b_out)


def _check_operands(op: MegaOperands, C, Ci, Dc, has_img) -> None:
    f32 = torch.float32
    cuda_lib.check_operand("w_in", op.w_in, shape=(Ci, C))
    cuda_lib.check_operand("w_out", op.w_out, shape=(C, Ci))
    cuda_lib.check_operand("b_in", op.b_in, f32, (Ci,))
    cuda_lib.check_operand("b_out", op.b_out, f32, (C,))
    cuda_lib.check_operand("attn1 w_qkv", op.attn1.w_in, shape=(3 * Ci, Ci))
    cuda_lib.check_operand("attn2 wq", op.attn2.w_in, shape=(Ci, Ci))
    if len(op.attn2.w_kv) != 1 + has_img:
        raise ValueError(f"attn2 packs {len(op.attn2.w_kv)} key segments, the call has {1 + has_img}")
    for w_kv in op.attn2.w_kv:
        cuda_lib.check_operand("attn2 w_kv", w_kv, shape=(2 * Ci, Dc))
    for a in (op.attn1, op.attn2):
        cuda_lib.check_operand("wo", a.wo, shape=(Ci, Ci))
        for v in (a.ln_scale, a.ln_bias, a.bo):
            cuda_lib.check_operand("attention vector", v, f32, (Ci,))
    cuda_lib.check_operand("ff w1", op.ff.w1, shape=(8 * Ci, Ci))
    cuda_lib.check_operand("ff w2", op.ff.w2, shape=(Ci, 4 * Ci))
    cuda_lib.check_operand("ff b1", op.ff.b1, f32, (8 * Ci,))
    for v in (op.ff.ln_scale, op.ff.ln_bias, op.ff.b2):
        cuda_lib.check_operand("ff vector", v, f32, (Ci,))


def spatial_mega(x4, ctx, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *, heads, scale,
                 text_len=77, eps=1e-5, operands=None):
    """Kernel 13 with the folded GroupNorm vectors ``(mul, add)`` [BF, C]:
    [BF, H, W, C] -> [BF, H, W, C]. On the card ``ds_mega_spatial`` (H*W %
    64 == 0, C and Ci = 64 * heads multiples of 64 up to 320, Dc % 64 == 0 up
    to 1024), reading ``operands`` (from :func:`pack_spatial_mega`; packed
    here when None)."""
    if not cuda_lib.use_kernel(x4, ctx):
        return spatial_mega_plain(x4, ctx, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out,
                                  heads=heads, scale=scale, text_len=text_len, eps=eps)
    BF, H, W, C = x4.shape
    N = H * W
    clips, L, Dc = ctx.shape
    has_img = len(attn2) == 7
    Ci = heads * 64
    if N % 64 or C % 64 or C > 320 or Ci > 320 or Dc % 64 or Dc > 1024 or BF % clips \
            or (has_img and not 0 < text_len < L):
        raise ValueError(f"kernel 13 takes H*W % 64 == 0, C and Ci = 64 * heads up to 320, Dc % 64 == 0 "
                         f"up to 1024, whole clips; got x {tuple(x4.shape)} ctx {tuple(ctx.shape)} "
                         f"heads={heads} text_len={text_len}")
    cuda_lib.check_operand("x", x4)
    dt = x4.dtype
    op = operands or pack_spatial_mega(w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, dtype=dt)
    _check_operands(op, C, Ci, Dc, has_img)
    cuda_lib.check_operand("gn mul", mul, torch.float32, (BF, C))
    cuda_lib.check_operand("gn add", add, torch.float32, (BF, C))
    ctx = ctx.to(dt)
    Lt = text_len if has_img else L
    ctx_t = ctx[:, :Lt].reshape(clips * Lt, Dc).contiguous()
    ctx_i = ctx[:, Lt:].reshape(clips * (L - Lt), Dc).contiguous() if has_img else None
    dev = x4.device
    h = torch.empty((BF * N, Ci), device=dev, dtype=dt)
    qkv = torch.empty((BF * N, 3 * Ci), device=dev, dtype=dt)
    kv_t = torch.empty((clips * Lt, 2 * Ci), device=dev, dtype=dt)
    kv_i = torch.empty((clips * (L - Lt), 2 * Ci), device=dev, dtype=dt) if has_img else None
    out = torch.empty_like(x4)
    a1, a2, f = op.attn1, op.attn2, op.ff
    ptrs = [x4, mul, add, op.w_in, op.b_in,
            a1.ln_scale, a1.ln_bias, a1.w_in, a1.wo, a1.bo,
            a2.ln_scale, a2.ln_bias, a2.w_in, a2.w_kv[0], a2.w_kv[1] if has_img else None, a2.wo, a2.bo,
            f.ln_scale, f.ln_bias, f.w1, f.b1, f.w2, f.b2, op.w_out, op.b_out,
            ctx_t, ctx_i, h, qkv, kv_t, kv_i, out]
    cuda_lib.call("ds_mega_spatial", cuda_lib.ptr_array(ptrs), BF, N, C, Ci, BF // clips, Dc, Lt, L - Lt,
                  float(scale), float(eps))
    spatial_mega.launches += 1
    return out


spatial_mega.launches = 0


def spatial_transformer(x4, ctx, gn_scale, gn_bias, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, *,
                        heads, scale, text_len=77, gn_eps=1e-6, eps=1e-5, operands=None):
    """The whole SpatialTransformer: the GroupNorm statistics pass, then
    :func:`spatial_mega`. x4 [BF, H, W, C]; ctx [clips, L, Dc] per clip."""
    mul, add = group_norm_fold(x4, gn_scale, gn_bias, eps=gn_eps)
    return spatial_mega(x4, ctx, mul, add, w_in, b_in, lns, attn1, attn2, ff, w_out, b_out, heads=heads,
                        scale=scale, text_len=text_len, eps=eps, operands=operands)
