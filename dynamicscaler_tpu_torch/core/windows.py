"""Shift-window grid arithmetic (host side, pure Python).

Counterpart of ``dynamicscaler_tpu/core/windows.py::IntegerGrid``: the
integer-grid planar window enumeration of the reference
(i2v_normal_pipeline.py:254-313, t2v_normal_pipeline.py:471-522). The
fractional ``PlanarGrid`` and the sphere view grids come with the i2v and
sphere slices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


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
