"""Shift-window grid arithmetic (host side, pure Python).

Counterpart of ``dynamicscaler_tpu/core/windows.py``: frame windows with a
cyclic start offset and docking (``frame_window_origins``,
i2v_sphere_panorama_pipeline.py:256-318), the fractional-overlap planar grid
of the i2v sampler (``PlanarGrid``, :732-768) and the integer-grid planar
windows (``IntegerGrid``, i2v_normal_pipeline.py:254-313,
t2v_normal_pipeline.py:471-522) and the sphere view grids of the
equirectangular sampler (``default_phi_theta_grid``, ``sphere_step_views``,
``sphere_phase_views``, i2v_sphere_panorama_pipeline.py:235,320-327).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

DOCK_START = "dock_start"
DOCK_END = "dock_end"


def frame_window_origins(step: int, total_f: int, frames: int, overlap_ratio_f: float,
                         loop_step_frame: Optional[int] = None, dock_at_f: bool = False) -> List[int]:
    """Frame-window start indices for DDIM step ``step``: cyclic start
    offset ``(step % loop_step_frame) * offset step``, a ``ceil`` window count
    over the ring, and with ``dock_at_f`` windows pinned to the clip start
    and end (skipped when the cycle is at its origin; a docking run never
    wraps past the clip end)."""
    if total_f == frames:
        return [0]
    if total_f < frames:
        raise ValueError(f"total_f {total_f} must be >= frames {frames}")
    n = math.ceil((total_f // frames - 1) / (1 - overlap_ratio_f)) + 1
    begin = (step % loop_step_frame) * max(int(overlap_ratio_f * frames / loop_step_frame), 1)
    stride = int(frames * (1 - overlap_ratio_f))
    idx_list = [DOCK_START, *range(n), DOCK_END] if dock_at_f else list(range(n))
    origins: List[int] = []
    for idx in idx_list:
        if idx in (DOCK_START, DOCK_END):
            if begin == 0:
                continue
            f0 = 0 if idx == DOCK_START else total_f - frames
        else:
            f0 = (begin + idx * stride) % total_f
        if dock_at_f and f0 + frames > total_f:
            continue
        origins.append(f0)
    return origins


@dataclasses.dataclass(frozen=True)
class PlanarGrid:
    """Fractional-overlap planar window grid over a [total_h, total_w]
    latent with [win_h, win_w] windows; the overlap follows from the total
    size and the window count, and the origins shift by whole latent pixels
    each step with period ``loop_step``."""

    total_h: int
    total_w: int
    win_h: int
    win_w: int
    num_windows_h: int
    num_windows_w: int
    loop_step: int
    vae_scale: int = 8

    def __post_init__(self):
        for axis in ("w", "h"):
            r = getattr(self, f"overlap_ratio_{axis}")
            if not 0 <= r < 1:
                raise ValueError(f"overlap_ratio_{axis}={r} not legal for grid {self}")
            n, total, win = (getattr(self, f"{k}_{axis}") for k in ("num_windows", "total", "win"))
            # one window must fit exactly (the reference divides by zero there)
            if n == 1 and total != win:
                raise ValueError(f"1 window of {axis}={win} cannot cover total_{axis}={total}")
            if n > 1 and getattr(self, f"offset_step_{axis}") < 1:
                raise ValueError(f"latent offset step along {axis} must be >= 1 for grid {self}")

    @property
    def overlap_ratio_w(self) -> float:
        if self.num_windows_w == 1:
            return 0.0
        return 1 - (self.total_w / self.win_w - 1) / (self.num_windows_w - 1)

    @property
    def overlap_ratio_h(self) -> float:
        if self.num_windows_h == 1:
            return 0.0
        return 1 - (self.total_h / self.win_h - 1) / (self.num_windows_h - 1)

    @property
    def window_step_w(self) -> float:
        return self.win_w * (1 - self.overlap_ratio_w)

    @property
    def window_step_h(self) -> float:
        return self.win_h * (1 - self.overlap_ratio_h)

    @property
    def offset_step_w(self) -> int:
        if self.num_windows_w == 1:
            return 0
        # the reference steps in image pixels, then divides by the VAE scale
        img_w = self.win_w * self.vae_scale
        return int((1 - self.overlap_ratio_w) * img_w / self.loop_step) // self.vae_scale

    @property
    def offset_step_h(self) -> int:
        if self.num_windows_h == 1:
            return 0
        img_h = self.win_h * self.vae_scale
        return int((1 - self.overlap_ratio_h) * img_h / self.loop_step) // self.vae_scale

    def step_origins(self, step: int, begin_index_offset: int = 0) -> List[Tuple[int, int]]:
        """(h0, w0) latent origins of every window at DDIM ``step``, w outer."""
        phase = (step + begin_index_offset) % self.loop_step
        left0, top0 = phase * self.offset_step_w, phase * self.offset_step_h
        return [(top0 + round(hi * self.window_step_h), left0 + round(wi * self.window_step_w))
                for wi in range(self.num_windows_w) for hi in range(self.num_windows_h)]


@dataclasses.dataclass(frozen=True)
class IntegerGrid:
    """Integer-grid windows: total = window * num_windows, step offsets in
    whole latent pixels, optional H docking (pin top/bottom rows),
    odd-step half-period jumps (t2v ``shift_jump_odd``) and per-axis docking
    on the steps in ``docking_step_range``. Each jump applies to its own
    axis (the reference swaps h and w at t2v_normal_pipeline.py:471-476)."""

    win_f: int
    win_h: int
    win_w: int
    num_windows_f: int
    num_windows_h: int
    num_windows_w: int
    loop_step: int
    dock_at_h: bool = False
    shift_jump_odd_w: bool = False
    shift_jump_odd_h: bool = False
    shift_jump_odd_f: bool = False
    docking_w: bool = False
    docking_h: bool = False
    docking_f: bool = False
    docking_step_range: Optional[Tuple[int, ...]] = None

    @property
    def total_f(self):
        return self.win_f * self.num_windows_f

    @property
    def total_h(self):
        return self.win_h * self.num_windows_h

    @property
    def total_w(self):
        return self.win_w * self.num_windows_w

    def _offset(self, step: int, size: int, jump_odd: bool) -> int:
        base = (step % self.loop_step) * (size // self.loop_step)
        if jump_odd and step % 2 == 1:
            base = (base + size // 2) % size
        return base

    def step_origins(self, step: int) -> List[Tuple[int, int, int]]:
        """(f0, h0, w0) origins of all windows at ``step`` (+ dock rows), in
        the reference loop order (f outer, then w, then h)."""
        off_f = self._offset(step, self.win_f, self.shift_jump_odd_f) if self.num_windows_f > 1 else 0
        off_h = self._offset(step, self.win_h, self.shift_jump_odd_h) if self.num_windows_h > 1 else 0
        off_w = self._offset(step, self.win_w, self.shift_jump_odd_w) if self.num_windows_w > 1 else 0
        dock_now = self.docking_step_range is not None and step in self.docking_step_range

        def axis_positions(n, win, total, off, docking):
            # on docking steps the docked axis prepends a window pinned to 0
            # and replaces its last window with one pinned to the far edge
            pos = [off + i * win for i in range(n)]
            if docking and dock_now and n > 1:
                pos = [0] + pos[:-1] + [total - win]
            return pos

        fs = axis_positions(self.num_windows_f, self.win_f, self.total_f, off_f, self.docking_f)
        ws = axis_positions(self.num_windows_w, self.win_w, self.total_w, off_w, self.docking_w)
        hs = axis_positions(self.num_windows_h, self.win_h, self.total_h, off_h, self.docking_h)

        origins = [(f0, h0, w0) for f0 in fs for w0 in ws for h0 in hs]
        if self.dock_at_h and off_h != 0 and self.num_windows_h > 1:
            # pin top and bottom edges (i2v_normal_pipeline.py:275-313)
            for f0 in fs:
                for w0 in ws:
                    origins.append((f0, 0, w0))
                    origins.append((f0, self.total_h - self.win_h, w0))
        return origins


# ---------------------------------------------------------------------------
# Sphere view grids
# ---------------------------------------------------------------------------


def default_phi_theta_grid(phi_num: int = 6) -> Dict[float, List[float]]:
    """The gen_pano_360 view grid: an equator ring of ``phi_num`` thetas at
    phi 0, rings at +-45 and +-67.5, and the two poles."""
    thetas = [i * (360.0 / phi_num) for i in range(phi_num)]
    return {-90.0: [0.0], -67.5: thetas, -45.0: thetas, 0.0: thetas, 45.0: thetas, 67.5: thetas, 90.0: [0.0]}


def sphere_step_views(phi_theta_dict: Dict[float, Sequence[float]], step: int, loop_step_theta: int,
                      view_fov: float) -> List[Tuple[float, float]]:
    """(phi, theta + offset) of every view at DDIM ``step``: the thetas turn
    by ``view_fov // loop_step_theta`` degrees a step, period
    ``loop_step_theta``."""
    theta_offset = (step % loop_step_theta) * (view_fov // loop_step_theta)
    return [(phi, theta + theta_offset) for phi, thetas in phi_theta_dict.items() for theta in thetas]


def sphere_phase_views(phi_theta_dict: Dict[float, Sequence[float]], loop_step_theta: int,
                       view_fov: float) -> Dict[int, List[Tuple[float, float]]]:
    """Every step phase -> its view list (a finite set: the projection maps
    and the per-view conditioning are made once per phase)."""
    return {p: sphere_step_views(phi_theta_dict, p, loop_step_theta, view_fov) for p in range(loop_step_theta)}
