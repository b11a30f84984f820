"""Equirectangular sphere <-> perspective view projection (PyTorch).

Counterpart of ``dynamicscaler_tpu/ops/sphere.py`` (reference
utils/panorama_tensor_utils.py:5-246): the pinhole -> sphere ray cast runs on
the host in numpy float32 (:func:`uv_grid`, a copy of the JAX package's,
which the port does not import), and each view's index maps are made once
(:class:`SphereView`). View extraction is one gather of precomputed linear
indices; view write-back is one scatter of unique indices.

Scatter semantics, made explicit on the host (:func:`plan_scatter`):

* *Drop.* Invalid view pixels carry the index ``H*W`` (one past the pano),
  which the JAX scatter drops with ``mode='drop'``. Here they are removed
  from the index list before the scatter; nothing is clamped.
* *Last write wins.* Near the poles many view pixels land on one pano pixel;
  the JAX package on the CPU applies the updates in order, so the last one
  wins. Of each target only the last view pixel (in view-pixel order) is
  kept, so every device scatter has unique indices and gives the same result
  on the CPU and the card. Within a step, later views overwrite earlier
  ones because their scatters run later on the stream.

Pano layout ``[B, F, H, W, C]`` with ``W == 2 * H``; view layout
``[B, F, h, w, C]``. ``set_view_nearest``, ``add_view_nearest`` and
``add_view_bilinear`` update their pano tensors IN PLACE (the JAX twins
return new arrays) and return them.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamicscaler_tpu_torch.ops.ring import wrap_slice_indices

# ---------------------------------------------------------------------------
# host geometry (numpy float32, the same arithmetic as the JAX package)
# ---------------------------------------------------------------------------


def uv_grid(fov: float, theta: float, phi: float, view_width: int, view_height: int, pano_height: int,
            pano_width: int, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel-space (u, v) sample coordinates into the equirect pano of each
    view pixel (panorama_tensor_utils.py:204-245): ``[view_height,
    view_width]`` arrays, u in [0, W-1] after the longitude wrap, v in
    [0, H-1]."""
    fov_rad = np.deg2rad(np.asarray(fov, dtype=dtype))
    theta_rad = np.deg2rad(np.asarray(theta, dtype=dtype))
    phi_rad = np.deg2rad(np.asarray(phi, dtype=dtype))

    f = 0.5 * view_width / np.tan(fov_rad / 2)

    x = np.linspace(-view_width / 2, view_width / 2 - 1, view_width, dtype=dtype)
    y = np.linspace(-view_height / 2, view_height / 2 - 1, view_height, dtype=dtype)
    yv, xv = np.meshgrid(y, x, indexing="ij")
    zv = np.full_like(xv, f)
    xyz = np.stack([xv, yv, zv], axis=-1)
    xyz = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)

    cp, sp = np.cos(phi_rad), np.sin(phi_rad)
    ct, st = np.cos(theta_rad), np.sin(theta_rad)
    r_phi = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], dtype=dtype)
    r_theta = np.array([[ct, 0, st], [0, 1, 0], [-st, 0, ct]], dtype=dtype)
    rot = (r_theta @ r_phi).astype(dtype)

    xyz_rot = (xyz.reshape(-1, 3) @ rot.T).reshape(view_height, view_width, 3)
    lon = np.arctan2(xyz_rot[..., 0], xyz_rot[..., 2])
    lat = np.arcsin(np.clip(xyz_rot[..., 1], -1.0, 1.0))
    lon = (lon + 2 * np.pi) % (2 * np.pi)
    u = lon / (2 * np.pi) * (pano_width - 1)
    v = (lat + np.pi / 2) / np.pi * (pano_height - 1)
    return u.astype(dtype), v.astype(dtype)


@dataclasses.dataclass(frozen=True)
class SphereView:
    """Precomputed projection maps of one (fov, theta, phi) view."""

    fov: float
    theta: float
    phi: float
    view_height: int
    view_width: int
    pano_height: int
    pano_width: int
    u: np.ndarray  # [h, w] float32 pixel coords
    v: np.ndarray  # [h, w] float32
    # nearest (floor) sampling, longitude-wrapped / latitude-clamped
    gather_idx: np.ndarray  # [h, w] int32 linear index v*W + u into the pano
    # nearest scatter; invalid pixels carry the index H*W (dropped)
    scatter_idx: np.ndarray  # [h, w] int32
    valid: np.ndarray  # [h, w] bool


def make_sphere_view(fov: float, theta: float, phi: float, view_height: int, view_width: int,
                     pano_height: int, pano_width: int) -> SphereView:
    """The static index maps of one view direction."""
    u, v = uv_grid(fov, theta, phi, view_width, view_height, pano_height, pano_width)
    W, H = pano_width, pano_height
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    # get: wrap longitude, clamp latitude (panorama_tensor_utils.py:185-202)
    gather_idx = (np.clip(v0, 0, H - 1) * W + u0 % W).astype(np.int32)
    # validity (panorama_tensor_utils.py:170,197): float coords in range
    valid = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    # set: floor indices, invalid pixels marked H*W (panorama_tensor_utils.py:154-183)
    sidx = np.where(valid & (u0 >= 0) & (u0 < W) & (v0 >= 0) & (v0 < H), v0 * W + u0, H * W)
    return SphereView(fov=fov, theta=theta, phi=phi, view_height=view_height, view_width=view_width,
                      pano_height=pano_height, pano_width=pano_width, u=u, v=v, gather_idx=gather_idx,
                      scatter_idx=sidx.astype(np.int32), valid=valid)


def make_sphere_views(specs: Sequence[Tuple[float, float, float]], view_height: int, view_width: int,
                      pano_height: int, pano_width: int) -> list:
    """Index maps of many (fov, theta, phi) views, in ``specs`` order. Views
    of 64K pixels or more (the image crops) are cast on a thread pool:
    numpy's array loops release the GIL, and each view's arithmetic is the
    same as alone. Smaller views (the latent maps) cost less than the pool."""
    def one(spec):
        f, t, p = spec
        return make_sphere_view(f, t, p, view_height, view_width, pano_height, pano_width)
    if len(specs) < 2 or view_height * view_width < 65536:
        return [one(s) for s in specs]
    with ThreadPoolExecutor(max_workers=min(len(specs), os.cpu_count() or 1)) as pool:
        return list(pool.map(one, specs))


def stack_views(views: Sequence[SphereView], device=None):
    """Per-view gather / scatter index maps and validity stacked into
    tensors ``[Nv, h, w]`` on ``device``."""
    def st(name, dtype):
        return torch.as_tensor(np.stack([getattr(v, name) for v in views]), dtype=dtype, device=device)
    return st("gather_idx", torch.long), st("scatter_idx", torch.long), st("valid", torch.bool)


# ---------------------------------------------------------------------------
# scatter plans: drops and duplicate targets resolved on the host
# ---------------------------------------------------------------------------


class ScatterPlan(NamedTuple):
    """The writes of a nearest scatter that survive: view pixels ``src``
    (flat, [n]) written to pano pixels ``tgt`` (flat, [n], unique)."""

    src: torch.Tensor
    tgt: torch.Tensor


def plan_scatter(scatter_idx, eq_pixels: int, device=None) -> ScatterPlan:
    """Drop the invalid pixels (index >= ``eq_pixels``) of a view's scatter
    map and keep, of each target, the last view pixel in view-pixel order
    (the JAX CPU scatter's winner)."""
    flat = np.asarray(scatter_idx).reshape(-1).astype(np.int64)
    tgt, first_from_end = np.unique(flat[::-1], return_index=True)
    src = flat.size - 1 - first_from_end
    keep = (tgt >= 0) & (tgt < eq_pixels)
    order = np.argsort(src[keep], kind="stable")
    return ScatterPlan(torch.as_tensor(src[keep][order], device=device),
                       torch.as_tensor(tgt[keep][order], device=device))


def _plan(scatter_idx, eq_pixels, device) -> ScatterPlan:
    return scatter_idx if isinstance(scatter_idx, ScatterPlan) else plan_scatter(scatter_idx, eq_pixels, device)


def _frame_targets(tgt, F, HW, frame_origin, Fv, device):
    """Flat [Fv * n] indices into a [F * HW] frame-major pano of the targets
    in each frame of the window (all F frames without a frame origin)."""
    fi = torch.arange(F, device=device) if frame_origin is None else wrap_slice_indices(frame_origin, Fv, F,
                                                                                           device)
    return (fi[:, None] * HW + tgt[None, :]).reshape(-1)


# ---------------------------------------------------------------------------
# tensor ops
# ---------------------------------------------------------------------------


def get_view_nearest(pano: torch.Tensor, gather_idx, valid=None, frame_origin=None,
                     frame_count: Optional[int] = None) -> torch.Tensor:
    """Nearest view extraction (one gather): pano [B, F, H, W, C],
    gather_idx [h, w] -> [B, F', h, w, C] (F' = ``frame_count`` frames of a
    wrap-around window from ``frame_origin``, else F); with ``valid`` [h, w]
    the invalid view pixels are zeroed (panorama_tensor_utils.py:200)."""
    B, F, H, W, C = pano.shape
    if frame_origin is not None:
        pano = pano[:, wrap_slice_indices(frame_origin, frame_count, F, pano.device)]
    gi = torch.as_tensor(gather_idx, dtype=torch.long, device=pano.device)
    h, w = gi.shape
    view = pano.reshape(B, pano.shape[1], H * W, C)[:, :, gi.reshape(-1)].reshape(B, pano.shape[1], h, w, C)
    if valid is not None:
        vm = torch.as_tensor(valid, device=pano.device)
        view = view * vm[None, None, :, :, None].to(view.dtype)
    return view


def get_view_bilinear(pano: torch.Tensor, u, v) -> torch.Tensor:
    """Bilinear view extraction with border clamp (``F.grid_sample`` with
    ``padding_mode='border', align_corners=True`` at pixel coords,
    panorama_tensor_utils.py:28-51). u, v [h, w] pixel coords."""
    B, F, H, W, C = pano.shape
    u = torch.as_tensor(u, dtype=torch.float32, device=pano.device).clamp(0.0, W - 1.0)
    v = torch.as_tensor(v, dtype=torch.float32, device=pano.device).clamp(0.0, H - 1.0)
    u0, v0 = torch.floor(u).long(), torch.floor(v).long()
    u1, v1 = (u0 + 1).clamp(0, W - 1), (v0 + 1).clamp(0, H - 1)
    du = (u - u0).to(pano.dtype)[None, None, :, :, None]
    dv = (v - v0).to(pano.dtype)[None, None, :, :, None]
    flat = pano.reshape(B, F, H * W, C)
    h, w = u.shape

    def g(vi, ui):
        return flat[:, :, (vi * W + ui).reshape(-1)].reshape(B, F, h, w, C)

    return (g(v0, u0) * (1 - du) * (1 - dv) + g(v1, u0) * (1 - du) * dv
            + g(v0, u1) * du * (1 - dv) + g(v1, u1) * du * dv)


def set_view_nearest(pano: torch.Tensor, view: torch.Tensor, scatter_idx, frame_origin=None) -> torch.Tensor:
    """Nearest scatter of a view back onto the pano, in place: invalid pixels
    dropped, the last view pixel wins on duplicate targets
    (set_view_tensor_no_interpolation, panorama_tensor_utils.py:154-183).
    ``scatter_idx`` is the view's [h, w] scatter map or its
    :class:`ScatterPlan`. With ``frame_origin`` the view's frames write into
    a wrap-around frame window of the pano."""
    B, F, H, W, C = pano.shape
    Bv, Fv, h, w, _ = view.shape
    if frame_origin is None and Fv != F:
        raise ValueError(f"view of {Fv} frames onto a pano of {F} without a frame origin")
    plan = _plan(scatter_idx, H * W, pano.device)
    idx = _frame_targets(plan.tgt, F, H * W, frame_origin, Fv, pano.device)
    vals = view.reshape(Bv, Fv, h * w, C)[:, :, plan.src].reshape(Bv, -1, C)
    pano.view(B, F * H * W, C)[:, idx] = vals.to(pano.dtype)
    return pano


def add_view_nearest(pano_accum: torch.Tensor, count_accum: torch.Tensor, view: torch.Tensor, scatter_idx,
                     frame_origin=None, weight=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulating variant of :func:`set_view_nearest` for order-free
    blending, in place: every valid view pixel adds its value (times its
    ``weight`` [h, w], default 1) to ``pano_accum`` and its weight to
    ``count_accum`` [B, F, H, W, 1]; invalid pixels are dropped. Normalise
    later with ``ops.blend.normalize_accumulated``."""
    B, F, H, W, C = pano_accum.shape
    Bv, Fv, h, w, _ = view.shape
    dev = pano_accum.device
    sidx = torch.as_tensor(scatter_idx, dtype=torch.long, device=dev).reshape(-1)
    keep = torch.nonzero((sidx >= 0) & (sidx < H * W)).reshape(-1)
    wflat = (torch.ones(h * w, dtype=pano_accum.dtype, device=dev) if weight is None
             else torch.as_tensor(weight, device=dev).reshape(-1).to(pano_accum.dtype))[keep]
    idx = _frame_targets(sidx[keep], F, H * W, frame_origin, Fv, dev)
    vals = view.reshape(Bv, Fv, h * w, C)[:, :, keep].to(pano_accum.dtype) * wflat[None, None, :, None]
    pano_accum.view(B, F * H * W, C).index_add_(1, idx, vals.reshape(Bv, -1, C))
    cnt = wflat[None, None, :, None].expand(B, Fv, -1, 1).reshape(B, -1, 1)
    count_accum.view(B, F * H * W, 1).index_add_(1, idx, cnt)
    return pano_accum, count_accum


def add_view_bilinear(pano_accum: torch.Tensor, weight_accum: torch.Tensor, view: torch.Tensor, u,
                      v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear splat (4-corner weighted scatter-add) of a view onto the
    pano, in place, longitude-wrapped / latitude-clamped
    (set_view_tensor_bilinear, panorama_tensor_utils.py:98-152)."""
    B, F, H, W, C = pano_accum.shape
    Bv, Fv, h, w, _ = view.shape
    dev = pano_accum.device
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    v = torch.as_tensor(v, dtype=torch.float32, device=dev)
    u0, v0 = torch.floor(u).long(), torch.floor(v).long()
    u1, v1 = (u0 + 1) % W, (v0 + 1).clamp(0, H - 1)
    du, dv = (u - u0).to(pano_accum.dtype), (v - v0).to(pano_accum.dtype)
    pflat = pano_accum.view(B, F, H * W, C)
    wflat = weight_accum.view(B, F, H * W, 1)
    vflat = view.reshape(Bv, Fv, h * w, C)
    for vi, ui, wgt in ((v0, u0, (1 - du) * (1 - dv)), (v1, u0, (1 - du) * dv),
                        (v0, u1, du * (1 - dv)), (v1, u1, du * dv)):
        idx = (vi.clamp(0, H - 1) * W + ui % W).reshape(-1)
        wg = wgt.reshape(-1)
        pflat.index_add_(2, idx, vflat * wg[None, None, :, None])
        wflat.index_add_(2, idx, wg[None, None, :, None].expand(B, Fv, -1, 1))
    return pano_accum, weight_accum
