"""K2 (spatial LN-self-attention sub-block) and K3 (LN-cross-attention
sub-block, t2v text-only and i2v dual text/image variants).

Counterparts of ``dynamicscaler_tpu/ops/fused_spatial.py``
``fused_ln_spatial_attention`` (Pallas ``_kernel``) and
``fused_ln_cross_attention`` (``_cross_kernel``). Weights are in torch
``Linear`` layout ``[out, in]``.

On the card each op runs as hand-written CUDA kernels: an LN-prologue GEMM
for the projections, the flash-style ``ds_flash_attention`` (N up to 2560;
one or two key segments) and a GEMM with the bias + residual epilogue. K3
projects the context K/V with the same GEMM kernel. The plain versions keep
the TPU kernels' rounding points; softmax is normalised AFTER the PV product.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from dynamicscaler_tpu_torch.models.layers import layer_norm
from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.ops.cuda_lib import MODE_RESIDUAL, act, f32, ln_gemm
from dynamicscaler_tpu_torch.ops.fused_temporal import AttnOperands, mm_f32, pack_ln_attention


def _attend_plain(q, k, v, scale):
    """[B, N, d] x [B, L, d]: fp32 logits and softmax, exponentials rounded
    to the activation type for PV, normalised after PV; fp32 result."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    denom = e.sum(dim=-1, keepdim=True)
    return torch.matmul(e.to(q.dtype).float(), v.float()) / denom


def _heads_attention_plain(q, kvs, heads, scale):
    """Per head (bounds the [B, N, L] logits to one head at a time): sum of
    the normalised attentions over each (k, v) segment, rounded to q.dtype."""
    C = q.shape[-1]
    d = C // heads
    outs = []
    for hh in range(heads):
        sl = slice(hh * d, (hh + 1) * d)
        oh = sum(_attend_plain(q[..., sl], k[..., sl], v[..., sl], scale) for k, v in kvs)
        outs.append(oh.to(q.dtype))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# K2: LayerNorm -> QKV -> N-token self-attention -> out-proj -> +x
# ---------------------------------------------------------------------------


def ln_spatial_attention_plain(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *, heads, scale, eps=1e-5):
    """Plain PyTorch version of K2. x [B, N, C]; weights [C, C]."""
    dt = x.dtype
    h = layer_norm(x, ln_scale, ln_bias, eps)
    q, k, v = (mm_f32(h, w).to(dt) for w in (wq, wk, wv))
    o = _heads_attention_plain(q, [(k, v)], heads, scale)
    return (mm_f32(o, wo) + bo.float()).to(dt) + x


def fused_ln_spatial_attention(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *, heads, scale, eps=1e-5,
                               operands=None):
    """K2: LayerNorm -> QKV -> N-token self-attention -> out-proj -> +x.
    x: [B, N, C] (B = batch * frames, N = H * W); weights [C, C].
    On the card: LN-prologue GEMM (q|k|v) -> ds_flash_attention ->
    GEMM + bias + residual, reading ``operands`` (from
    ``fused_temporal.pack_ln_attention``; packed here when None)."""
    if not cuda_lib.use_kernel(x):
        return ln_spatial_attention_plain(x, ln_scale, ln_bias, wq, wk, wv, wo, bo,
                                          heads=heads, scale=scale, eps=eps)
    B, N, C = x.shape
    if C != heads * 64:
        raise ValueError(f"K2 kernel takes head dim 64, got C={C} heads={heads}")
    cuda_lib.check_operand("x", x)
    op = operands or pack_ln_attention(ln_scale, ln_bias, wq, wk, wv, wo, bo, dtype=x.dtype)
    x2d = x.reshape(B * N, C)
    qkv = ln_gemm(x2d, op.w_in, ln=(op.ln_scale, op.ln_bias), eps=eps)
    o = torch.empty_like(x2d)
    p = cuda_lib.ptr
    cuda_lib.call(
        "ds_flash_attention", p(qkv), 3 * C, B, N, heads,
        p(qkv[:, C:]), p(qkv[:, 2 * C:]), 3 * C, N,
        None, None, 0, 0, 1, float(scale), p(o), C,
    )
    out = ln_gemm(o, op.wo, bias=op.bo, residual=x2d, mode=MODE_RESIDUAL)
    fused_ln_spatial_attention.launches += 1
    return out.reshape(B, N, C)


fused_ln_spatial_attention.launches = 0


# ---------------------------------------------------------------------------
# K3: LayerNorm -> Q; context K/V -> text (+ image) attention -> out-proj -> +x
# ---------------------------------------------------------------------------


def _split_ctx(ctx, has_img, text_len):
    # t2v: every context token is text (fused_spatial.py:394-395)
    if not has_img:
        return ctx, None
    return ctx[:, :text_len], ctx[:, text_len:]


def ln_cross_attention_plain(x, ctx, ln_scale, ln_bias, wq, wk, wv, wo, bo, wk_ip=None,
                             wv_ip=None, *, heads, scale, text_len=77, eps=1e-5):
    """Plain PyTorch version of K3. x [B, N, C]; ctx [B, L, Dc];
    wq/wo [C, C]; wk/wv (/wk_ip/wv_ip) [C, Dc]."""
    dt = x.dtype
    has_img = wk_ip is not None
    ctx = ctx.to(dt)
    ctx_t, ctx_i = _split_ctx(ctx, has_img, text_len)
    h = layer_norm(x, ln_scale, ln_bias, eps)
    q = mm_f32(h, wq).to(dt)
    kvs = [(mm_f32(ctx_t, wk).to(dt), mm_f32(ctx_t, wv).to(dt))]
    if has_img:
        # image_cross_attention_scale = 1.0 (lvdm attention.py:116-124)
        kvs.append((mm_f32(ctx_i, wk_ip).to(dt), mm_f32(ctx_i, wv_ip).to(dt)))
    o = _heads_attention_plain(q, kvs, heads, scale)
    return (mm_f32(o, wo) + bo.float()).to(dt) + x


def pack_ln_cross_attention(ln_scale, ln_bias, wq, wk, wv, wo, bo, wk_ip=None, wv_ip=None, *,
                            dtype) -> AttnOperands:
    """K3 operands: the q weight, and k|v stacked per context segment (text,
    then image with ``wk_ip``/``wv_ip``)."""
    segs = ((wk, wv), (wk_ip, wv_ip))[: 2 if wk_ip is not None else 1]
    return AttnOperands(f32(ln_scale), f32(ln_bias), act(wq, dtype), act(wo, dtype), f32(bo),
                        tuple(torch.cat([act(k, dtype), act(v, dtype)]) for k, v in segs))


def fused_ln_cross_attention(x, ctx, ln_scale, ln_bias, wq, wk, wv, wo, bo, wk_ip=None,
                             wv_ip=None, *, heads, scale, text_len=77, eps=1e-5, operands=None):
    """K3: LayerNorm -> Q proj -> softmax over the text keys (+ a separate
    softmax over the image keys, outputs summed) -> out-proj -> +x.

    ctx: [B, L, Dc], text tokens first; with ``wk_ip``/``wv_ip`` (i2v) the
    tokens from ``text_len`` on are image tokens; without them (t2v) all L
    tokens are text. On the card: LN-prologue GEMM (q), GEMM (context k|v
    per segment), ds_flash_attention with one or two segments, GEMM + bias
    + residual, reading ``operands`` (from :func:`pack_ln_cross_attention`;
    packed here when None)."""
    if not cuda_lib.use_kernel(x, ctx):
        return ln_cross_attention_plain(x, ctx, ln_scale, ln_bias, wq, wk, wv, wo, bo, wk_ip,
                                        wv_ip, heads=heads, scale=scale, text_len=text_len, eps=eps)
    B, N, C = x.shape
    if C != heads * 64:
        raise ValueError(f"K3 kernel takes head dim 64, got C={C} heads={heads}")
    cuda_lib.check_operand("x", x)
    dt = x.dtype
    has_img = wk_ip is not None
    op = operands or pack_ln_cross_attention(ln_scale, ln_bias, wq, wk, wv, wo, bo, wk_ip, wv_ip,
                                             dtype=dt)
    x2d = x.reshape(B * N, C)
    q = ln_gemm(x2d, op.w_in, ln=(op.ln_scale, op.ln_bias), eps=eps)
    ctx_t, ctx_i = _split_ctx(ctx.to(dt), has_img, text_len)
    segs = []
    for c, w_kv in zip((ctx_t, ctx_i), op.w_kv):
        L, Dc = c.shape[1], c.shape[2]
        segs.append((ln_gemm(c.reshape(B * L, Dc).contiguous(), w_kv), L))
    (kv0, l0) = segs[0]
    (kv1, l1) = segs[1] if has_img else (None, 0)
    o = torch.empty_like(x2d)
    p = cuda_lib.ptr
    cuda_lib.call(
        "ds_flash_attention", p(q), C, B, N, heads,
        p(kv0), p(kv0[:, C:]), 2 * C, l0,
        p(kv1), None if kv1 is None else p(kv1[:, C:]), 2 * C, l1,
        len(segs), float(scale), p(o), C,
    )
    out = ln_gemm(o, op.wo, bias=op.bo, residual=x2d, mode=MODE_RESIDUAL)
    fused_ln_cross_attention.launches += 1
    fused_ln_cross_attention.launches_i2v += has_img
    return out.reshape(B, N, C)


fused_ln_cross_attention.launches = 0
fused_ln_cross_attention.launches_i2v = 0  # the launches with image keys (i2v variant)
