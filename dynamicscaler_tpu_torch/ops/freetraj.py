"""FreeTraj trajectory control: path planning and the attention
re-weighting factors (PyTorch).

Counterpart of ``dynamicscaler_tpu/ops/freetraj.py`` (reference
lvdm/modules/attention_freetraj.py:29-56 gaussian weight, :131-249 temporal
logit re-weighting, :252-421 spatial self/cross masking). A per-frame
foreground box rides a planned path:

* temporal attention: frame-pair logits are multiplied by
  ``coef + (1 - coef) (fg_i fg_j + bg_i bg_j)`` per spatial position;
* spatial self-attention: token-pair logits within a frame get the same
  rank-1 re-weighting from that frame's box indicator;
* cross-attention: text logits are floored for queries inside the box and
  for the target word's columns, and the target word's post-softmax
  attention gets a gaussian bump centred on the box.

The semantics are the JAX package's, not the reference's: a level's (H, W)
are exact, where the reference infers them from the token count and swaps
the axes of its temporal path (the JAX module's notes, freetraj.py:31-36).
Attention receives O(B N) factors (the per-token indicator); the [N, N]
re-weighting is formed inside the attention (``models/attention.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

COEF = 0.01  # the reference's off-pair logit keep (attention_freetraj.py:215, 340)
# absorbs float32 path noise: a box meant to span exactly k cells must floor
# to k even when (p1 - p0) * len lands at k - 1e-7
_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class FreeTraj:
    """Trajectory state threaded through the UNet. ``paths`` [F, 4] float32
    per-frame box (h0, h1, w0, w1), fractions of the latent extent;
    ``active`` [B, F] bool, whether spatial masking applies at the current
    timestep (temporal re-weighting is ungated); ``fg_tok`` [text_len] bool,
    the target word's token positions. The flags select which attention
    classes are re-weighted."""

    paths: torch.Tensor
    active: torch.Tensor
    fg_tok: torch.Tensor
    temporal_attn: bool = True
    self_attn: bool = True
    cross_attn: bool = True

    def replace(self, **changes) -> "FreeTraj":
        return dataclasses.replace(self, **changes)


def plan_path(keyframes: Sequence[Sequence[float]], n_frames: int) -> np.ndarray:
    """Box keyframes -> a per-frame path, float32 [n_frames, 4] = (h0, h1,
    w0, w1). Rows ``(frame, h0, h1, w0, w1)``, fractions in [0, 1]; the
    frame an index or, when every frame is <= 1, a fraction of the clip.
    Linear between keyframes, flat outside them, clipped to [0, 1]."""
    kf = np.asarray(keyframes, np.float64)
    if kf.ndim != 2 or kf.shape[1] != 5:
        raise ValueError(f"keyframe rows are (f, h0, h1, w0, w1), got shape {kf.shape}")
    f = kf[:, 0].copy()
    if np.all(f <= 1.0):  # fractions -> frame indices
        f = f * (n_frames - 1)
    order = np.argsort(f)
    f, boxes = f[order], kf[order, 1:]
    out = np.empty((n_frames, 4), np.float64)
    for c in range(4):
        out[:, c] = np.interp(np.arange(n_frames), f, boxes[:, c])
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def gaussian_weight(height: int, width: int, kernel_division: float = 3.0, device=None) -> torch.Tensor:
    """Max-normalised 2-D gaussian over a [height, width] grid
    (attention_freetraj.py:29-56, with its linspace(0, n, n) spacing and
    int(n / 2) mean)."""
    x = torch.linspace(0.0, float(height), height, device=device)[:, None]
    y = torch.linspace(0.0, float(width), width, device=device)[None, :]
    sx, sy = height / kernel_division, width / kernel_division
    g = (1.0 / (2 * math.pi * sx * sy)) * torch.exp(
        -((x - int(height / 2)) ** 2 / (2 * sx ** 2) + (y - int(width / 2)) ** 2 / (2 * sy ** 2)))
    return g / g.max()


def box_grid(paths, h_len: int, w_len: int):
    """Per-frame integer box (h_start, sub_h, w_start, sub_w) on a level's
    latent grid, with the reference's floor and at-least-1 semantics
    (attention_freetraj.py:163-165, 284-286). paths [F, 4] fractions."""
    p = torch.as_tensor(paths).float()
    h0 = torch.floor(p[:, 0] * h_len + _EPS).long()
    w0 = torch.floor(p[:, 2] * w_len + _EPS).long()
    sub_h = torch.floor((p[:, 1] - p[:, 0]) * h_len + _EPS).long().clamp_min(1)
    sub_w = torch.floor((p[:, 3] - p[:, 2]) * w_len + _EPS).long().clamp_min(1)
    return h0, sub_h, w0, sub_w


def _in_box(paths, h_len: int, w_len: int):
    """[F, H] and [F, W] bool: rows and columns inside each frame's box."""
    h0, sub_h, w0, sub_w = box_grid(paths, h_len, w_len)
    hh = torch.arange(h_len, device=h0.device)[None, :]
    ww = torch.arange(w_len, device=h0.device)[None, :]
    in_h = (hh >= h0[:, None]) & (hh < (h0 + sub_h)[:, None])
    in_w = (ww >= w0[:, None]) & (ww < (w0 + sub_w)[:, None])
    return in_h, in_w


def fg_map(paths, h_len: int, w_len: int) -> torch.Tensor:
    """[F, h_len, w_len] float32 0/1 foreground-box indicator per frame."""
    in_h, in_w = _in_box(paths, h_len, w_len)
    return (in_h[:, :, None] & in_w[:, None, :]).float()


def pair_mul(fg: torch.Tensor, coef: float = COEF) -> torch.Tensor:
    """The rank-1 logit re-weighting ``coef + (1 - coef)(fg_i fg_j + bg_i
    bg_j)`` from a per-token indicator: [..., N] -> [..., N, N]."""
    bg = 1.0 - fg
    return coef + (1.0 - coef) * (fg[..., :, None] * fg[..., None, :] + bg[..., :, None] * bg[..., None, :])


def cross_weight_map(paths, h_len: int, w_len: int, n_fg_tokens) -> torch.Tensor:
    """[F, h_len, w_len] post-softmax bump for the target word: the
    max-normalised gaussian pasted into each frame's box, scaled by
    ``0.25 / box_area_fraction / n_fg_tokens`` (attention_freetraj.py:
    317-318, 380); the box size may vary per frame."""
    p = torch.as_tensor(paths).float()
    h0, sub_h, w0, sub_w = box_grid(p, h_len, w_len)
    area = (p[:, 1] - p[:, 0]) * (p[:, 3] - p[:, 2])
    n_fg = torch.as_tensor(n_fg_tokens, device=p.device).float().clamp_min(1.0)
    coef_a = 0.25 / area.clamp_min(1e-6) / n_fg

    hh = torch.arange(h_len, dtype=torch.float32, device=p.device)[None, :]
    ww = torch.arange(w_len, dtype=torch.float32, device=p.device)[None, :]
    # the reference evaluates gaussian_weight(sub_h, sub_w) on a
    # linspace(0, sub, sub) grid and pastes it at (h0, w0): in-box index i
    # sits at i * sub / (sub - 1), the mean at int(sub / 2)
    sh, sw = sub_h.float()[:, None], sub_w.float()[:, None]
    xh = (hh - h0[:, None]) * sh / (sh - 1.0).clamp_min(1.0)
    xw = (ww - w0[:, None]) * sw / (sw - 1.0).clamp_min(1.0)
    gx = torch.exp(-((xh - torch.floor(sh / 2.0)) ** 2) / (2 * (sh / 3.0) ** 2))
    gy = torch.exp(-((xw - torch.floor(sw / 2.0)) ** 2) / (2 * (sw / 3.0) ** 2))
    in_h, in_w = _in_box(p, h_len, w_len)
    g = gx[:, :, None] * gy[:, None, :] * (in_h[:, :, None] & in_w[:, None, :])
    gmax = g.amax(dim=(1, 2), keepdim=True).clamp_min(1e-20)
    return g / gmax * coef_a[:, None, None]


def fg_token_mask(text_len: int, fg_token_ids: Optional[Sequence[int]] = None, device=None) -> torch.Tensor:
    """[text_len] bool: True at the target word's positions (the
    reference's ``idx_list``; default token 2, attention_freetraj.py:
    373-375)."""
    ids = list(fg_token_ids) if fg_token_ids else [2]
    m = torch.zeros(text_len, dtype=torch.bool, device=device)
    m[torch.as_tensor(ids, dtype=torch.long, device=device)] = True
    return m


def make_freetraj(keyframes: Sequence[Sequence[float]], n_frames: int, text_len: int = 77,
                  fg_token_ids: Optional[Sequence[int]] = None, batch: int = 1, *, temporal_attn: bool = True,
                  self_attn: bool = True, cross_attn: bool = True, device=None) -> FreeTraj:
    """A FreeTraj state with every frame active (a sampler re-gates
    ``active`` each step from the timestep, :func:`gate_active`)."""
    return FreeTraj(
        paths=torch.as_tensor(plan_path(keyframes, n_frames), device=device),
        active=torch.ones((batch, n_frames), dtype=torch.bool, device=device),
        fg_tok=fg_token_mask(text_len, fg_token_ids, device=device),
        temporal_attn=temporal_attn, self_attn=self_attn, cross_attn=cross_attn,
    )


def gate_active(traj: FreeTraj, timesteps, thres: float, batch: int, n_frames: int) -> FreeTraj:
    """``active`` from the current timestep(s): spatial masking applies
    while ``t > thres`` (attention_freetraj.py:304-312). Takes scalar, [B]
    or [B, F] timesteps."""
    t = torch.as_tensor(timesteps, device=traj.paths.device).float()
    if t.ndim == 0:
        t = t.expand(batch, n_frames)
    elif t.ndim == 1:
        t = t[:, None].expand(batch, n_frames)
    return traj.replace(active=t > thres)
