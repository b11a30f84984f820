"""The port's tracing: spans around the samplers' phases on the profiler's
clock, the operator's phase marks, and the steady rate of the step loops.

Counterpart of ``dynamicscaler_tpu/utils/timing.py``, rebuilt on one
recorder.

* ``span(name, device=None, **counts)`` opens a span where the work
  happens (the samplers' preambles, steps and decodes, the UNet batch).
  It records only while tracing is on: inside a :func:`tracing` block,
  with ``DSCALER_STEP_TIMING`` set, or while a ``torch.profiler`` records.
  Off, it returns one shared no-op object: no event, no synchronise.
  On, a span opens a profiler range ``ds.<name>`` (so a profiler trace
  holds it on the kernels' clock; a function-scope range, as aten ops
  have: ``record_function``'s user scope would make the profiler project
  each range onto the card's timeline as if it were device work),
  records a CUDA event at each end on the current stream of a CUDA
  ``device`` (taken from the enclosing span when not given), keeps its
  host ``perf_counter_ns`` ends, its parent, its request and its integer
  ``counts``. Nothing synchronises while spans record: device times are
  read by :meth:`Span.device_ms` after the caller has synchronised.
  :func:`take` returns and clears the spans kept (at most ``MAX_SPANS``;
  the rest are counted as dropped).
* :func:`request` decorates a sampler entry point: a ``request`` span with
  a new request id, which its spans carry.
* ``Marker`` gives the JAX package's ``[tag] name: Xs cum`` marks and
  ``[tag] label Xs`` laps, when ``DSCALER_STEP_TIMING`` is set: each names
  the span that closed last, and takes its time from the spans. With the
  variable set, :func:`report` prints, after one synchronise when the
  outermost sampler call ends, those lines, then each request's spans by
  name: their total seconds, their number and their summed counts.
* ``LoopStats``: the planar engine (``pipelines/planar.py``) and the sphere
  sampler (``pipelines/sphere.py``) each keep one ``LOOP_STATS``: ``start``
  before the loop, ``mark_first`` after its first step (so the first
  step's one-off costs stay out), ``finish`` after the last, each a CUDA
  event; the CLI reads ``steady_sec_per_step`` per stage, which waits for
  the last event. With a mesh (``parallel.mesh``) a step's time is the
  time of the whole step on the rank that reads it (the CLI: rank 0), the
  window batch's gather included: the gather is ordered on the rank's
  stream before the events that follow it.

The recorder is one per process, as the profiler is: spans open deep in
the call tree, where no caller could hand one down.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import List, NamedTuple, Optional

import torch

MAX_SPANS = 1 << 16
_ENV = "DSCALER_STEP_TIMING"


def _env_on() -> bool:
    return bool(os.environ.get(_ENV))


def _is_cuda(device) -> bool:
    return device is not None and device.type == "cuda"


def _event(device):
    """A timing CUDA event recorded now on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _between(a, a_end: bool, b) -> float:
    """Seconds from span ``a``'s start (its end if ``a_end``) to span
    ``b``'s end: device time when both have events (completed), else host
    time."""
    ea, ta = (a.ev1, a.t1_ns) if a_end else (a.ev0, a.t0_ns)
    if ea is not None and b.ev1 is not None:
        return ea.elapsed_time(b.ev1) / 1e3
    return (b.t1_ns - ta) / 1e9


class Span:
    """One recorded span. ``device_ms`` is read after a synchronise."""

    __slots__ = ("name", "id", "parent", "request", "counts", "device", "profiled", "ev0", "ev1", "t0_ns",
                 "t1_ns", "marks")

    def __init__(self, name, id, parent, request, counts, device, profiled):
        self.name, self.id, self.parent, self.request = name, id, parent, request
        self.counts, self.device, self.profiled = counts, device, profiled
        self.ev0 = self.ev1 = None
        self.t0_ns = self.t1_ns = None
        self.marks = None  # the operator's lines that name this span (Marker)

    @property
    def device_ms(self) -> Optional[float]:
        """Time between the span's two CUDA events; None off the card."""
        if self.ev0 is None:
            return None
        return self.ev0.elapsed_time(self.ev1)

    @property
    def seconds(self) -> float:
        """Device seconds when the span has events, else host seconds."""
        return _between(self, False, self)

    def __repr__(self):
        return f"Span({self.name!r}, id={self.id}, parent={self.parent}, request={self.request}, {self.counts})"


class Recording(NamedTuple):
    spans: List[Span]  # in the order they opened
    dropped: int


class _Recorder:
    def __init__(self):
        self.forced = 0  # open tracing() blocks
        self.spans: List[Span] = []
        self.dropped = 0
        self.stack: List[Span] = []  # the open recorded spans
        self.next_id = 0
        self.requests = 0
        self.request = None  # id of the request in flight
        self.closed = None  # the span that closed last
        self.reported = 0  # spans before this index were printed by report()


_REC = _Recorder()


def enabled() -> bool:
    """Whether spans record now."""
    return _REC.forced > 0 or torch._C._autograd._profiler_enabled() or _env_on()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    __slots__ = ("span", "rf")

    def __init__(self, span):
        self.span = span
        self.rf = None

    def __enter__(self):
        s = self.span
        self.rf = torch._C._profiler._RecordFunctionFast("ds." + s.name)
        self.rf.__enter__()
        if s.device is not None:
            s.ev0 = _event(s.device)
        s.t0_ns = time.perf_counter_ns()
        _REC.stack.append(s)
        return s

    def __exit__(self, *exc):
        s = self.span
        s.t1_ns = time.perf_counter_ns()
        if s.device is not None:
            s.ev1 = _event(s.device)
        _REC.stack.pop()
        _REC.closed = s
        self.rf.__exit__(*exc)
        return False


def span(name: str, device=None, **counts):
    """Context manager: a span ``name`` with integer ``counts`` (see the
    module docstring); ``device`` the work's device, by default the
    enclosing span's."""
    if not enabled():
        return _NOOP
    rec = _REC
    if len(rec.spans) >= MAX_SPANS:
        rec.dropped += 1
        return _NOOP
    parent = rec.stack[-1] if rec.stack else None
    if device is None:
        device = parent.device if parent is not None else None
    else:
        device = torch.device(device)
        device = device if _is_cuda(device) else None
    s = Span(name, rec.next_id, parent.id if parent is not None else None, rec.request, counts, device,
             torch._C._autograd._profiler_enabled())
    rec.next_id += 1
    rec.spans.append(s)
    return _Open(s)


@contextlib.contextmanager
def tracing():
    """Record spans inside the block, whatever the environment."""
    _REC.forced += 1
    try:
        yield
    finally:
        _REC.forced -= 1


def take() -> Recording:
    """The spans recorded so far, in the order they opened, and the count
    dropped past ``MAX_SPANS``; both cleared. Synchronise before reading
    their device times."""
    rec = _REC
    out = Recording(rec.spans, rec.dropped)
    rec.spans, rec.dropped, rec.reported = [], 0, 0
    return out


def request(fn):
    """Decorates a sampler entry point whose first argument is the model:
    the call is a ``request`` span under a new request id, and when the
    outermost one ends :func:`report` prints."""
    @functools.wraps(fn)
    def call(model, *args, **kwargs):
        rec = _REC
        outer = rec.request
        rec.requests += 1
        rec.request = rec.requests
        try:
            with span("request", model.device):
                return fn(model, *args, **kwargs)
        finally:
            rec.request = outer
            report()
    return call


def report() -> None:
    """With ``DSCALER_STEP_TIMING`` set and outside any request, print the
    spans closed since the last report, after one synchronise: the marks
    and laps that name them, in the order they were marked, then per
    request and span name ``[request id] name: Xs xN count=total ...``.
    Spans recorded for this print alone (no :func:`tracing` block, no
    profiler) are then let go."""
    rec = _REC
    if rec.request is not None or not _env_on():
        return
    done = [s for s in rec.spans[rec.reported:] if s.t1_ns is not None]
    if rec.forced or torch._C._autograd._profiler_enabled():
        rec.reported = len(rec.spans)
    else:
        rec.spans, rec.reported = [], 0
    last = max((s for s in done if s.ev1 is not None), key=lambda s: s.t1_ns, default=None)
    if last is not None:
        last.ev1.synchronize()
    for s in sorted((s for s in done if s.marks), key=lambda s: s.t1_ns):
        for tag, text, ref, cum in s.marks:
            if cum:
                print(f"[{tag}] {text}: {_between(ref or s, False, s):.2f}s cum", flush=True)
            else:
                print(f"[{tag}] {text} {_between(ref or s, ref is not None, s):.2f}s", flush=True)
    totals = {}
    for s in done:
        t = totals.setdefault((s.request, s.name), [0.0, 0, {}])
        t[0] += s.seconds
        t[1] += 1
        for k, v in s.counts.items():
            t[2][k] = t[2].get(k, 0) + v
    for (req, name), (sec, n, counts) in totals.items():
        who = "spans" if req is None else f"request {req}"
        print(f"[{who}] {name}: {sec:.2f}s x{n}" + "".join(f" {k}={v}" for k, v in counts.items()), flush=True)


class Marker:
    """``[tag] name: Xs cum`` marks and ``[tag] label Xs`` laps, when
    ``DSCALER_STEP_TIMING`` is set (read at construction). Each names the
    span that closed last: a mark counts from the start of the request
    that holds the marker, a lap from the end of the previous lap's span
    (at first of the span that closed before construction or
    ``reset_lap``; without one, from its own span's start). Printed by
    :func:`report`."""

    def __init__(self, tag: str):
        self.tag = tag
        self.on = _env_on()
        if self.on:
            self.start = next((s for s in reversed(_REC.stack) if s.name == "request"), None)
            self.last = _REC.closed

    def _name(self, text, ref, cum):
        s = _REC.closed
        if s is not None:
            s.marks = (s.marks or []) + [(self.tag, text, ref, cum)]
        return s

    def mark(self, name: str) -> None:
        """Cumulative-since-the-request's-start mark (setup phases)."""
        if self.on:
            self._name(name, self.start, True)

    def lap(self, label: str) -> None:
        """Delta-since-last-lap mark (per-step timing)."""
        if self.on:
            self.last = self._name(label, self.last, False)

    def reset_lap(self) -> None:
        if self.on:
            self.last = _REC.closed


class LoopStats:
    """Seconds per step of the most recent loop, steps 2..n: the device time
    between the events of ``mark_first`` and ``finish`` (host clock on the
    CPU), read after waiting for the last."""

    def __init__(self):
        self.steps = 0
        self._first = self._last = None

    def start(self, n_steps: int) -> None:
        self.steps = int(n_steps)
        self._first = self._last = None

    @staticmethod
    def _point(t: torch.Tensor):
        return (_event(t.device) if _is_cuda(t.device) else None), time.perf_counter_ns()

    def mark_first(self, t: torch.Tensor) -> None:
        self._first = self._point(t)

    def finish(self, t: torch.Tensor) -> None:
        if self._first is None or self.steps < 2:
            return
        self._last = self._point(t)

    @property
    def steady_sec_per_step(self) -> Optional[float]:
        if self._last is None:
            return None
        (e0, t0), (e1, t1) = self._first, self._last
        if e1 is not None:
            e1.synchronize()
            return e0.elapsed_time(e1) / 1e3 / (self.steps - 1)
        return (t1 - t0) / 1e9 / (self.steps - 1)
