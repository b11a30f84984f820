"""Plain attention for the sites that hold no repository kernel: the CLIP
text tower (causal) and the VAE mid-block (single head, N up to tens of
thousands at panorama widths).

Counterpart of ``dynamicscaler_tpu/ops/attention.py`` (its naive, chunked
and JAX-flash paths are stock code there too); here one call to PyTorch's
``scaled_dot_product_attention`` covers all three, and picks a
memory-efficient backend for the long VAE sequences on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def attention(q, k, v, scale: float, causal: bool = False) -> torch.Tensor:
    """Attention over [B, H, N, D] x [B, H, M, D] -> [B, H, N, D]."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale)
