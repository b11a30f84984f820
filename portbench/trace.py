"""The device's share of a traced window, from a ``torch.profiler`` trace:
busy seconds (the union of every kernel, copy and set on the card), the
device operations that took most time, and the longest idle gaps named by
the host operation running through them."""

from __future__ import annotations

from torch.autograd import DeviceType

TOP = 10


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read(prof, window_s: float) -> dict:
    """{"busy_s", "window_s", "breakdown": {"device_ops", "idle_gaps"}} of a
    stopped profiler whose window lasted ``window_s`` host seconds."""
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async
            and not e.name.startswith("ProfilerStep")]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    busy = _merge([[e.time_range.start, e.time_range.end] for e in dev])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = sorted(((b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])), key=lambda g: g[0] - g[1])[:TOP]
    idle = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inside = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = min(inside, key=lambda e: e.time_range.end - e.time_range.start).name if inside else "no host op"
        idle.append([name, (g1 - g0) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s,
            "breakdown": {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": idle}}
