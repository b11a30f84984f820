"""The control: the reference computed one precision below the configuration's
bf16, in fp8 (e4m3). Every weight of two or more dimensions is rounded to
fp8 with a per-tensor scale, every input of a linear layer or convolution
is rounded the same way as it enters, and the sampler's state tensors are
rounded when they are written. The arithmetic between the roundings stays
fp32."""

from __future__ import annotations

import torch
from torch import nn

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through fp8 e4m3 with a per-tensor scale (amax to 448)."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return ((t.float() * scale).clamp(-FP8_MAX, FP8_MAX).to(FP8).float() / scale).to(t.dtype)


def _round_input(module, args):
    return (round_fp8(args[0]),) + tuple(args[1:])


@torch.no_grad()
def to_fp8(module: nn.Module) -> nn.Module:
    """Round ``module``'s weights to fp8 in place and round the inputs of
    its linear layers and convolutions as they enter."""
    for p in module.parameters():
        if p.ndim >= 2:
            p.copy_(round_fp8(p))
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            m.register_forward_pre_hook(_round_input)
    return module
