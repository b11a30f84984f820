"""Transformer wrapper layers and folded GroupNorm, plain PyTorch.

Counterparts of the plain paths of ``dynamicscaler_tpu/ops/fused_twrap.py``
(``group_norm_fold``, ``gn_proj_in_temporal``, ``tail_temporal``,
``gn_proj_in_spatial``, ``tail_spatial``, ``gn_silu``). Their Pallas
kernels (``_head_temporal``, ``_tail_temporal``, ``_head_spatial``,
``_tail_spatial``, ``_gn_silu_call``) have no Hopper port yet (ROADMAP
queue 2); proj_in/proj_out are plain products here, as XLA ran them
outside any kernel. Weights are in torch layout ``[out, in]``.

GroupNorm eps: 1e-6 in the transformer wrappers (lvdm attention.py
Normalize, fused_twrap.py:311,347); 1e-5 in the UNet ResBlocks and
TemporalConvBlock (``gn_silu`` default, fused_twrap.py:438); 1e-6 in the VAE
(its callers pass it).
"""

from __future__ import annotations

import torch


def group_norm_fold(x, scale, bias, num_groups: int = 32, eps: float = 1e-6):
    """Per-(sample, channel) GroupNorm vectors ``(mul, add)`` [B, C] fp32,
    such that ``normalized = x * mul + add``. Statistics reduce over every
    axis but the first (B) and the channel group, fp32 fast variance."""
    B, C = x.shape[0], x.shape[-1]
    G = num_groups
    xf = x.float().reshape(B, -1, G, C // G)
    mu = xf.mean(dim=(1, 3))
    var = ((xf * xf).mean(dim=(1, 3)) - mu * mu).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    rstd_c = rstd.repeat_interleave(C // G, dim=1)
    mu_c = mu.repeat_interleave(C // G, dim=1)
    mul = rstd_c * scale.float()[None]
    add = bias.float()[None] - mu_c * mul
    return mul, add


def _proj(x, w, b):
    """``x @ w.T + b`` with fp32 accumulation, rounded to x.dtype."""
    return torch.addmm(b.float(), x.reshape(-1, x.shape[-1]).float(), w.float().t()).to(
        x.dtype
    ).reshape(*x.shape[:-1], w.shape[0])


def gn_proj_in_temporal(x5, gn_scale, gn_bias, w, b, *, eps: float = 1e-6):
    """[B,F,H,W,C] -> GroupNorm(32) over each clip -> [B*H*W, F, Ci] tokens
    -> proj_in (the TemporalTransformer head)."""
    B, Fn, H, W, C = x5.shape
    mul, add = group_norm_fold(x5, gn_scale, gn_bias, eps=eps)
    xn = (x5.float() * mul[:, None, None, None] + add[:, None, None, None]).to(x5.dtype)
    h = xn.permute(0, 2, 3, 1, 4).reshape(B * H * W, Fn, C)
    return _proj(h, w, b)


def tail_temporal(y, x5, w, b):
    """proj_out -> permute back -> + residual: [BHW,F,Ci], [B,F,H,W,C] ->
    [B,F,H,W,C]."""
    B, Fn, H, W, C = x5.shape
    o = _proj(y, w, b)
    o = o.reshape(B, H, W, Fn, C).permute(0, 3, 1, 2, 4)
    return o + x5


def gn_proj_in_spatial(x4, gn_scale, gn_bias, w, b, *, eps: float = 1e-6):
    """[BF,H,W,C] -> GroupNorm(32) per frame -> [BF, H*W, Ci] proj_in tokens
    (the SpatialTransformer head)."""
    BF, H, W, C = x4.shape
    mul, add = group_norm_fold(x4, gn_scale, gn_bias, eps=eps)
    x3 = x4.reshape(BF, H * W, C)
    xn = (x3.float() * mul[:, None] + add[:, None]).to(x4.dtype)
    return _proj(xn, w, b)


def tail_spatial(y, x4, w, b):
    """proj_out -> + residual: [BF,N,Ci], [BF,H,W,C] -> [BF,H,W,C]."""
    BF, H, W, C = x4.shape
    o = _proj(y, w, b)
    return (o + x4.reshape(BF, H * W, C)).reshape(BF, H, W, C)


def gn_silu(x, gn_scale, gn_bias, *, eps: float = 1e-5, act: bool = True):
    """GroupNorm(32) [-> SiLU] with folded statistics per sample x.shape[0]
    (ResBlock / TemporalConvBlock / UNet out prologue; the VAE passes
    eps=1e-6). x: [B, *spatial, C]."""
    B, C = x.shape[0], x.shape[-1]
    mul, add = group_norm_fold(x, gn_scale, gn_bias, eps=eps)
    bshape = (B,) + (1,) * (x.ndim - 2) + (C,)
    h = x.float() * mul.reshape(bshape) + add.reshape(bshape)
    if act:
        h = h * torch.sigmoid(h)
    return h.to(x.dtype)
