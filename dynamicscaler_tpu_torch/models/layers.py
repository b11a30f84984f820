"""Shared building blocks for the LVDM model stack (PyTorch).

Numerics follow ``dynamicscaler_tpu/models/layers.py``: sinusoidal timestep
embedding with [cos, sin] order, LayerNorm with fp32 fast-variance
statistics, exact (erf) GELU in the GEGLU feed-forward.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dynamicscaler_tpu_torch.ops import cuda_lib


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings; the reference concatenates [cos, sin]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def layer_norm(x, scale, bias, eps: float = 1e-5, dtype=None):
    """flax ``nn.LayerNorm`` numerics: fp32 fast-variance statistics
    ``var = max(0, E[x^2] - mu^2)``, ``y = (x - mu) * (rsqrt(var + eps) *
    scale) + bias``, cast to ``dtype`` (default x.dtype)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    return y.to(dtype if dtype is not None else x.dtype)


def place(module: nn.Module, device, dtype) -> nn.Module:
    """Move a freshly built ``module`` to ``device`` in ``dtype`` (bf16 or
    fp32) and return it. ``device`` None leaves it where it was built: a
    module built inside another, which places the whole."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{type(module).__name__}: dtype bfloat16 or float32, got {dtype}")
    if device is None:
        return module.to(dtype=dtype)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{type(module).__name__} is built on the CUDA card by default and none is "
                           "available: pass device='cpu' to build it on the CPU")
    return module.to(device=device, dtype=dtype)


class MLPEmbed(nn.Sequential):
    """Linear -> SiLU -> Linear (time / fps embedding MLP); state_dict
    names ``0.*`` and ``2.*`` as VideoCrafter's ``time_embed``."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__(nn.Linear(in_dim, hidden), nn.SiLU(), nn.Linear(hidden, hidden))


class GEGLU(nn.Module):
    """Parameter holder of VideoCrafter's GEGLU (``proj``: dim -> 2 * inner,
    value rows first, gate rows second)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward (lvdm/modules/attention.py:386-403, glu=True);
    state_dict names ``net.0.proj.*`` and ``net.2.*``.

    ``forward(x, ln)`` runs the whole LN -> GEGLU -> out -> +x sub-block as
    K4 (``ops/fused_temporal.fused_ln_geglu``), which takes its plain
    PyTorch version for CPU tensors; on the card it reads kernel operands
    packed once from these parameters."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(0.0), nn.Linear(inner, dim))
        self._operands = cuda_lib.PackCache()

    def forward(self, x, ln: nn.LayerNorm):
        from dynamicscaler_tpu_torch.ops import fused_temporal

        proj, out = self.net[0].proj, self.net[2]
        params = (ln.weight, ln.bias, proj.weight, proj.bias, out.weight, out.bias)
        ops = None
        if x.is_cuda:
            ops = self._operands.get(lambda: fused_temporal.pack_ln_geglu(*params, dtype=x.dtype),
                                     params, x.dtype)
        return fused_temporal.fused_ln_geglu(x, *params, eps=ln.eps, operands=ops)
