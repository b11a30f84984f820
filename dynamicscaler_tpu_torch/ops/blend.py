"""Latent blending primitives (overlap merging); counterpart of
``dynamicscaler_tpu/ops/blend.py`` (reference utils/tensor_utils.py:19-38)."""

from __future__ import annotations

import torch


def mix_with_mask(latent_1, latent_to_add, mask, mix_ratio):
    """Outside ``mask``: ``latent_1``. Inside: ``(1 - r) * latent_1 +
    r * latent_to_add``. ``mask`` broadcasts against the latents."""
    mixed = latent_1 * (1.0 - mix_ratio) + latent_to_add * mix_ratio
    return latent_1 * (1.0 - mask) + mixed * mask


def checkerboard_mix(cur, residual, ratio, parity):
    """Sparse residual merge on a step-parity checkerboard over (H, W)
    (t2v_normal_pipeline.py:462-466): pixels with (h + w + parity) even get
    ``ratio * cur + (1 - ratio) * residual``. cur/residual [B, F, H, W, C]."""
    _, _, H, W, _ = cur.shape
    hh = torch.arange(H, device=cur.device)[:, None]
    ww = torch.arange(W, device=cur.device)[None, :]
    checker = ((hh + ww + int(parity)) % 2 == 0)[None, None, :, :, None]
    return torch.where(checker, ratio * cur + (1.0 - ratio) * residual, cur)


def normalize_accumulated(accum, count, fallback=None):
    """Divide scatter-accumulated values by their hit counts; where
    count == 0 keep ``fallback`` (or zero)."""
    avg = accum / torch.clamp(count, min=1.0)
    return torch.where(count > 0, avg, torch.zeros_like(avg) if fallback is None else fallback)
