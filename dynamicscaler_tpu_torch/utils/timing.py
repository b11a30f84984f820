"""Wall-clock marks of the sampler phases and the steady rate of their
step loops.

Counterpart of ``dynamicscaler_tpu/utils/timing.py``. ``Marker`` prints
cumulative setup marks and per-step laps when ``DSCALER_STEP_TIMING`` is
set (the sphere, i2v and planar samplers mark their phases with it); unset,
it does nothing and synchronises nothing. ``LoopStats``: the
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

import os
import time

import torch


def _enabled() -> bool:
    return bool(os.environ.get("DSCALER_STEP_TIMING"))


class Marker:
    """Prints ``[tag] name: Xs cum`` marks and ``[tag] label Xs`` laps on
    the host clock, when ``DSCALER_STEP_TIMING`` is set (read at
    construction). A mark or lap given ``block`` (a tensor or a tuple of
    them) first waits for the work that produces it: a CUDA event recorded
    on the current stream of each CUDA tensor's device, synchronised."""

    def __init__(self, tag: str):
        self.tag = tag
        self.on = _enabled()
        self.t0 = time.perf_counter()
        self.last = self.t0

    @staticmethod
    def _sync(block) -> None:
        if block is None:
            return
        for t in block if isinstance(block, (tuple, list)) else (block,):
            if torch.is_tensor(t) and t.is_cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
                ev.synchronize()

    def mark(self, name: str, block=None) -> None:
        """Cumulative-since-construction mark (setup phases)."""
        if not self.on:
            return
        self._sync(block)
        print(f"[{self.tag}] {name}: {time.perf_counter() - self.t0:.2f}s cum", flush=True)
        self.last = time.perf_counter()

    def lap(self, label: str, block=None) -> None:
        """Delta-since-last-lap mark (per-step timing)."""
        if not self.on:
            return
        self._sync(block)
        now = time.perf_counter()
        print(f"[{self.tag}] {label} {now - self.last:.2f}s", flush=True)
        self.last = now

    def reset_lap(self) -> None:
        self.last = time.perf_counter()


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
