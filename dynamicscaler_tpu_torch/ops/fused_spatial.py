"""K2 (spatial LN-self-attention sub-block) and K3 (LN-cross-attention
sub-block, t2v text-only and i2v dual text/image variants).

Counterparts of ``dynamicscaler_tpu/ops/fused_spatial.py``
``fused_ln_spatial_attention`` (Pallas ``_kernel``) and
``fused_ln_cross_attention`` (``_cross_kernel``). Weights are in torch
``Linear`` layout ``[out, in]``.

On the card each op runs as hand-written CUDA kernels: an LN-prologue GEMM
for the projections, :func:`flash_attention` (``ds_flash_attention``, a
TMA/wgmma flash-attention forward; N up to 2560, one or two key segments;
at fp32 ``ds_flash_attention_f32``, ``csrc/attention_f32.cu``) and a GEMM
with the bias + residual epilogue. K3 projects the context K/V
with the same GEMM kernel. The plain versions keep the TPU kernels' rounding
points; softmax is normalised AFTER the PV product.

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


def flash_attention_plain(q, k0, v0, k1=None, v1=None, *, heads, scale):
    """Plain version of ``ds_flash_attention``: :func:`_heads_attention_plain`
    over the key segments (k0, v0) and, where given, (k1, v1)."""
    kvs = [(k0, v0)] + ([(k1, v1)] if k1 is not None else [])
    return _heads_attention_plain(q, kvs, heads, scale)


def _check_rows(name, t, B, C, dtype=torch.bfloat16):
    """A [B, n, >= C] CUDA view of ``dtype`` whose rows ds_flash_attention
    (or its fp32 twin) reads with a pitch: unit column stride, 16-byte
    aligned rows, samples packed."""
    if (t.device.type != "cuda" or t.dtype != dtype or t.dim() != 3 or t.shape[0] != B
            or t.shape[2] != C or t.stride(2) != 1 or (t.stride(1) * t.element_size()) % 16
            or t.stride(0) != t.shape[1] * t.stride(1) or t.data_ptr() % 16):
        raise ValueError(f"{name}: ds_flash_attention reads [{B}, n, {C}] {dtype} CUDA rows with a pitch of whole "
                         f"16 bytes and packed samples, got {tuple(t.shape)} strides {t.stride()} "
                         f"{t.dtype} on {t.device} address {t.data_ptr():#x}")


def flash_attention(q, k0, v0, k1=None, v1=None, *, heads, scale):
    """K2's and K3's attention core: per (sample, head) the sum over the key
    segments (k0, v0) and, where given, (k1, v1) of softmax(q k^T * scale) v,
    each segment with its own softmax (exponentials rounded to the activation
    type for PV, the sum divided out after). q [B, Nq, C], k/v [B, L_s, C]
    (views with a row pitch, such as columns of a packed q|k|v); returns
    [B, Nq, C]. On the card one launch of ``csrc/attention.cu::
    ds_flash_attention`` (bf16) or ``csrc/attention_f32.cu::
    ds_flash_attention_f32`` (fp32) (head dim 64)."""
    dt = cuda_lib.check_dtypes("flash_attention", q, k0, v0, k1, v1)
    if not cuda_lib.use_kernel(q, k0, v0, k1, v1):
        return flash_attention_plain(q, k0, v0, k1, v1, heads=heads, scale=scale)
    B, Nq, C = q.shape
    if C != heads * 64 or (k1 is None) != (v1 is None):
        raise ValueError(f"ds_flash_attention takes head dim 64 and whole segments, got C={C} heads={heads}")
    segs = [(k0, v0)] + ([(k1, v1)] if k1 is not None else [])
    for name, t in (("q", q), *((f"k/v {i}", t) for i, kv in enumerate(segs) for t in kv)):
        _check_rows(name, t, B, C, dt)
    for k, v in segs:
        if k.shape != v.shape or k.stride() != v.stride() or k.shape[1] == 0:
            raise ValueError(f"ds_flash_attention: a segment's keys and values must be alike and non-empty, got "
                             f"{tuple(k.shape)} {k.stride()} and {tuple(v.shape)} {v.stride()}")
    o = torch.empty((B, Nq, C), device=q.device, dtype=q.dtype)
    p = cuda_lib.ptr
    ld1, len1 = (k1.stride(1), k1.shape[1]) if k1 is not None else (0, 0)
    name = "ds_flash_attention_f32" if dt == torch.float32 else "ds_flash_attention"
    cuda_lib.call(name, p(q), q.stride(1), B, Nq, heads, p(k0), p(v0), k0.stride(1), k0.shape[1],
                  p(k1), p(v1), ld1, len1, len(segs), float(scale), p(o), C)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


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
    dt = cuda_lib.check_dtypes("K2", x)
    if not cuda_lib.use_kernel(x):
        return ln_spatial_attention_plain(x, ln_scale, ln_bias, wq, wk, wv, wo, bo,
                                          heads=heads, scale=scale, eps=eps)
    B, N, C = x.shape
    if C != heads * 64:
        raise ValueError(f"K2 kernel takes head dim 64, got C={C} heads={heads}")
    cuda_lib.check_operand("x", x, dt)
    op = operands or pack_ln_attention(ln_scale, ln_bias, wq, wk, wv, wo, bo, dtype=x.dtype)
    x2d = x.reshape(B * N, C)
    qkv = ln_gemm(x2d, op.w_in, ln=(op.ln_scale, op.ln_bias), eps=eps).view(B, N, 3 * C)
    o = flash_attention(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], heads=heads, scale=scale)
    out = ln_gemm(o.view(B * N, C), op.wo, bias=op.bo, residual=x2d, mode=MODE_RESIDUAL)
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
    dt = cuda_lib.check_dtypes("K3", x)
    if not cuda_lib.use_kernel(x, ctx):
        return ln_cross_attention_plain(x, ctx, ln_scale, ln_bias, wq, wk, wv, wo, bo, wk_ip,
                                        wv_ip, heads=heads, scale=scale, text_len=text_len, eps=eps)
    B, N, C = x.shape
    if C != heads * 64:
        raise ValueError(f"K3 kernel takes head dim 64, got C={C} heads={heads}")
    cuda_lib.check_operand("x", x, dt)
    has_img = wk_ip is not None
    op = operands or pack_ln_cross_attention(ln_scale, ln_bias, wq, wk, wv, wo, bo, wk_ip, wv_ip,
                                             dtype=dt)
    x2d = x.reshape(B * N, C)
    q = ln_gemm(x2d, op.w_in, ln=(op.ln_scale, op.ln_bias), eps=eps)
    ctx_t, ctx_i = _split_ctx(ctx.to(dt), has_img, text_len)
    kv = []
    for c, w_kv in zip((ctx_t, ctx_i), op.w_kv):
        L, Dc = c.shape[1], c.shape[2]
        t = ln_gemm(c.reshape(B * L, Dc).contiguous(), w_kv).view(B, L, 2 * C)
        kv += [t[..., :C], t[..., C:]]
    o = flash_attention(q.view(B, N, C), *kv, heads=heads, scale=scale)
    out = ln_gemm(o.view(B * N, C), op.wo, bias=op.bo, residual=x2d, mode=MODE_RESIDUAL)
    fused_ln_cross_attention.launches += 1
    fused_ln_cross_attention.launches_i2v += has_img
    return out.reshape(B, N, C)


fused_ln_cross_attention.launches = 0
fused_ln_cross_attention.launches_i2v = 0  # the launches with image keys (i2v variant)
