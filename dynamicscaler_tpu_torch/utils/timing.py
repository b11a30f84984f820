"""Steady-state rate of the sampler step loops.

Counterpart of ``LoopStats`` in ``dynamicscaler_tpu/utils/timing.py``. The
planar engine (``pipelines/planar.py``) and the sphere sampler
(``pipelines/sphere.py``) each keep one ``LOOP_STATS``: ``start`` before the
loop, ``mark_first`` after its first step (so the first step's one-off costs
stay out), ``finish`` after the last. The CLI reads
``steady_sec_per_step`` per stage. With a mesh (``parallel.mesh``) a step's
time is the wall time of the whole step on the rank that reads it (the CLI:
rank 0), the window batch's gather included: the gather is on the rank's
stream, which the synchronise at each end waits for.
"""

from __future__ import annotations

import time

import torch


class LoopStats:
    """Seconds per step of the most recent loop, steps 2..n, on the host
    clock after a device synchronise at both ends."""

    def __init__(self):
        self.steps = 0
        self.steady_sec_per_step = None
        self._t = None

    def start(self, n_steps: int) -> None:
        self.steps = int(n_steps)
        self.steady_sec_per_step = None
        self._t = None

    @staticmethod
    def _readback(t: torch.Tensor) -> None:
        """Wait for the work that produces ``t``: a CUDA tensor's device is
        synchronised; a CPU tensor is ready when the call returns."""
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def mark_first(self, t: torch.Tensor) -> None:
        self._readback(t)
        self._t = time.perf_counter()

    def finish(self, t: torch.Tensor) -> None:
        if self._t is None or self.steps < 2:
            return
        self._readback(t)
        self.steady_sec_per_step = (time.perf_counter() - self._t) / (self.steps - 1)
