"""Video-latent spatial resize (stage-to-stage rescaling) and frame padding.

Counterpart of ``dynamicscaler_tpu/ops/resize.py`` (reference
utils/diffusion_utils.py:4-36): ``nearest`` (torch's legacy asymmetric
``src = floor(dst * in / out)``), ``bicubic`` / ``cubic`` (Keys kernel a =
-0.75, half-pixel centres, edge clamp, weights normalised per output pixel:
torch's own bicubic) and ``bilinear`` / ``linear``, the default, which is
``jax.image.resize(method="bilinear")``: half-pixel centres and, since it
antialiases, a triangle kernel widened by the factor when an axis shrinks,
its weights normalised per output pixel (``F.interpolate`` neither widens
nor renormalises). Latents are ``[B, F, H, W, C]``.
"""

from __future__ import annotations

import torch


def resize_video_latent(latent: torch.Tensor, target_height: int, target_width: int,
                        mode: str = "bilinear") -> torch.Tensor:
    """Per-frame spatial resize of a ``[B, F, H, W, C]`` latent
    (``bilinear`` / ``linear``, ``nearest``, or ``bicubic`` / ``cubic``)."""
    _, _, H, W, _ = latent.shape
    if mode == "nearest":
        dev = latent.device
        hi = torch.floor(torch.arange(target_height, device=dev) * (H / target_height)).long()
        wi = torch.floor(torch.arange(target_width, device=dev) * (W / target_width)).long()
        return latent[:, :, hi[:, None], wi[None, :], :]
    if mode in ("bicubic", "cubic"):
        return _cubic_resample_axis(_cubic_resample_axis(latent, 2, target_height), 3, target_width)
    if mode in ("bilinear", "linear"):
        return _linear_resample_axis(_linear_resample_axis(latent, 2, target_height), 3, target_width)
    raise ValueError(f"resize mode {mode!r}: one of bilinear, linear, nearest, bicubic, cubic")


def _linear_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in_size, out_size] weights of ``jax.image.resize``'s antialiased
    triangle kernel: tap i of output o weighs max(0, 1 - |s_o - i| / k)
    with s_o = (o + 0.5) * in / out - 0.5 and k = max(in / out, 1), each
    column normalised to sum 1; an output whose centre lies outside the
    input gets none."""
    inv = 1.0 / (out_size / in_size)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    taps = torch.arange(in_size, dtype=torch.float32, device=device)
    w = (1.0 - (sample[None, :] - taps[:, None]).abs() / max(inv, 1.0)).clamp_min(0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _linear_resample_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """Resample ``axis`` of ``x`` to ``out_size`` through
    :func:`_linear_weights` (an axis of unchanged size is left as it is)."""
    if x.shape[axis] == out_size:
        return x
    w = _linear_weights(x.shape[axis], out_size, x.device).to(x.dtype)
    return torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)


def _cubic_kernel(x: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    ax = x.abs()
    ax2, ax3 = ax * ax, ax * ax * ax
    w1 = (a + 2) * ax3 - (a + 3) * ax2 + 1
    w2 = a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a
    return torch.where(ax <= 1, w1, torch.where(ax < 2, w2, torch.zeros_like(ax)))


def _cubic_resample_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    scale = in_size / out_size
    coords = (torch.arange(out_size, dtype=torch.float32, device=x.device) + 0.5) * scale - 0.5
    base = torch.floor(coords).long()
    frac = coords - base
    offsets = torch.arange(-1, 3, device=x.device)
    idx = (base[:, None] + offsets[None, :]).clamp(0, in_size - 1)  # [out, 4]
    wts = _cubic_kernel(frac[:, None] - offsets[None, :].float())
    wts = wts / wts.sum(dim=1, keepdim=True)
    gathered = torch.index_select(x, axis, idx.reshape(-1))
    shape = list(x.shape)
    shape[axis:axis + 1] = [out_size, 4]
    gathered = gathered.reshape(shape)
    wshape = [1] * len(shape)
    wshape[axis], wshape[axis + 1] = out_size, 4
    return (gathered * wts.reshape(wshape).to(x.dtype)).sum(dim=axis + 1)


def pad_frames_front(latent: torch.Tensor, n: int) -> torch.Tensor:
    """Repeat the first frame ``n`` times at the front (diffusion_utils.py:4)."""
    return torch.cat([latent[:, :1].expand(-1, n, *latent.shape[2:]), latent], dim=1)


def pad_frames_end(latent: torch.Tensor, n: int) -> torch.Tensor:
    """Repeat the last frame ``n`` times at the end (diffusion_utils.py:13)."""
    return torch.cat([latent, latent[:, -1:].expand(-1, n, *latent.shape[2:])], dim=1)
