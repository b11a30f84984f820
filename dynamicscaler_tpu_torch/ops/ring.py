"""Ring (toroidal wrap-around) window gather / scatter on video latents.

Counterpart of ``dynamicscaler_tpu/ops/ring.py`` (reference RingLatent,
utils/shift_window_utils.py:40-207): a window is one gather with modular
indices over the (F, H, W) axes of a ``[B, F, H, W, C]`` latent, written
back through the same indices. ``set_ring_window`` and ``add_ring_window``
update the latent IN PLACE (the JAX twins return a new array) and return it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def wrap_slice_indices(start, size: int, dim: int, device=None) -> torch.Tensor:
    """Indices ``[start, start + size) mod dim``."""
    return (int(start) + torch.arange(size, device=device)) % dim


def _indices(latent, origin, sizes):
    _, Fn, H, W, _ = latent.shape
    f0, h0, w0 = origin
    fs, hs, ws = sizes
    dev = latent.device
    fi = wrap_slice_indices(f0, fs, Fn, dev)
    hi = wrap_slice_indices(h0, hs, H, dev)
    wi = wrap_slice_indices(w0, ws, W, dev)
    return (slice(None), fi[:, None, None], hi[None, :, None], wi[None, None, :])


def get_ring_window(latent: torch.Tensor, origin: Tuple, sizes: Tuple[int, int, int]) -> torch.Tensor:
    """Extract a wrap-around window ``[B, fs, hs, ws, C]`` at ``origin``
    (f0, h0, w0); window extents may exceed the latent's (up to 2x)."""
    return latent[_indices(latent, origin, sizes)]


def _check_fits(latent, window):
    _, Fn, H, W, _ = latent.shape
    _, fs, hs, ws, _ = window.shape
    if fs > Fn or hs > H or ws > W:
        raise ValueError(f"window {tuple(window.shape)} larger than ring {tuple(latent.shape)}")


def set_ring_window(latent: torch.Tensor, window: torch.Tensor, origin: Tuple) -> torch.Tensor:
    """Write a window back with wrap-around, in place (last write wins)."""
    _check_fits(latent, window)
    latent[_indices(latent, origin, window.shape[1:4])] = window.to(latent.dtype)
    return latent


def add_ring_window(latent: torch.Tensor, window: torch.Tensor, origin: Tuple) -> torch.Tensor:
    """Accumulate a window with wrap-around, in place (``+=`` scatter). A
    window no larger than the ring has no repeated index, so the gather-add-
    scatter is exact."""
    _check_fits(latent, window)
    idx = _indices(latent, origin, window.shape[1:4])
    latent[idx] = latent[idx] + window.to(latent.dtype)
    return latent
