"""The program's spans over the profiled steps of a traced run, and what
the profiler's trace says happened inside them.

The port's recorder (``dynamicscaler_tpu_torch/utils/timing.py``) records
its spans while a ``torch.profiler`` records, and opens a host range
``ds.<name>`` in the trace for each. :func:`load` takes the spans the
recorder kept over the profiled window and matches each to its range (the
k-th span of a name to the k-th range of that name, in order): a span then
carries its device time (the program's CUDA events) and its host interval
on the trace's clock. A program without the recorder gives ``None``, and
so does every reader built on it.

Waits of the host on the card, counted by :func:`waits`: a CUDA runtime
call that synchronises (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) or a ``cudaMemcpy``/``cudaMemcpyAsync`` whose copy
(matched by correlation id) reads or writes pageable host memory. The
calls one host op makes count once: a pageable copy followed by the
synchronise that ends it is one wait.

    python3 -m portbench.spans --workload NAME --seed N --seconds S

runs the cell traced, as ``run.py --trace 1`` does, and then prints one
more line, ``spans: {...}``: the profiled step's split around the UNet,
the card's idle time by innermost span and the waits by span.
"""

from __future__ import annotations

import json
import sys

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
COPIES = ("cudaMemcpyAsync", "cudaMemcpy")
PRE = ("step.gather", "step.masks", "step.renoise")
POST = ("step.update", "step.scatter")


class Profiled:
    """The matched spans (dicts: ``name``, ``id``, ``parent``,
    ``request``, ``counts``, ``device_ms``, ``start``, ``end``, the last
    two in the trace's microseconds) and the trace's events (dicts:
    ``name``, ``device``, ``start``, ``end``, ``corr``)."""

    def __init__(self, spans, events):
        self.spans, self.events = spans, events
        self.steps = [s for s in spans if s["name"] == "step"]


def trace_events(prof) -> list:
    """A stopped profiler's events as dicts. The card's projections of
    user-scope host ranges are left out: they are not device work."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        device = e.device_type == DeviceType.CUDA
        if device and e.is_user_annotation:
            continue
        out.append({"name": e.name, "device": device, "start": e.time_range.start, "end": e.time_range.end,
                    "corr": e.id})
    return out


def match(recorded, events) -> Profiled:
    """The recorder's spans kept while the profiler recorded, each matched
    to its ``ds.<name>`` host range in ``events``."""
    ranges = {}
    for e in sorted((e for e in events if not e["device"] and e["name"].startswith("ds.")), key=lambda e: e["start"]):
        ranges.setdefault(e["name"][3:], []).append(e)
    seen, spans = {}, []
    for s in sorted((s for s in recorded if getattr(s, "profiled", True)), key=lambda s: s.id):
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        if k < len(ranges.get(s.name, ())):
            r = ranges[s.name][k]
            spans.append({"name": s.name, "id": s.id, "parent": s.parent, "request": s.request,
                          "counts": dict(s.counts), "device_ms": s.device_ms, "start": r["start"], "end": r["end"]})
    return Profiled(spans, events)


def load(r):
    """The :class:`Profiled` spans of a traced run's readings ``r``, taken
    from the program's recorder once (the readers share them); None where
    the run has no profiled window or the program no recorder."""
    if "_ds_spans" not in vars(r):
        r._ds_spans = _load(r)
    return r._ds_spans


def _load(r):
    try:
        from dynamicscaler_tpu_torch.utils import timing
    except ImportError:
        return None
    take = getattr(timing, "take", None)
    window = r.window.prof_window
    if take is None or not window or len(window) != 3:
        return None
    p = match(take().spans, trace_events(window[2]))
    return p if p.steps else None


def step_ms(p: Profiled, names) -> float:
    """Per profiled step, the device time of its child spans ``names``
    (None where a span has no device time)."""
    steps = {s["id"] for s in p.steps}
    kids = [s["device_ms"] for s in p.spans if s["name"] in names and s["parent"] in steps]
    if not p.steps or any(v is None for v in kids):
        return None
    return sum(kids) / len(p.steps)


def _innermost(spans, t):
    """The shortest span whose host interval holds ``t``, or None."""
    inside = [s for s in spans if s["start"] <= t <= s["end"]]
    return min(inside, key=lambda s: s["end"] - s["start"]) if inside else None


def waits(p: Profiled) -> list:
    """The host's waits on the card inside the profiled steps: one
    ``(innermost span name, runtime call name, host op name)`` per host op
    that waits (the op ``-`` where the call has none around it)."""
    ev = p.events
    pageable = {e["corr"] for e in ev if e["device"] and e["name"].startswith("Memcpy") and "Pageable" in e["name"]}
    calls = [e for e in ev if not e["device"] and (e["name"] in SYNCS or (e["name"] in COPIES and e["corr"] in pageable))]
    calls = [e for e in calls if any(s["start"] <= e["start"] <= s["end"] for s in p.steps)]
    ops = [e for e in ev if not e["device"] and not e["name"].startswith(("cu", "ds."))]
    out, seen = [], set()
    for c in sorted(calls, key=lambda e: e["start"]):
        holders = [o for o in ops if o["start"] <= c["start"] and c["end"] <= o["end"]]
        op = min(holders, key=lambda o: o["end"] - o["start"]) if holders else None
        key = id(op if op is not None else c)
        if key in seen:
            continue
        seen.add(key)
        s = _innermost(p.spans, c["start"])
        out.append((s["name"] if s else "outside", c["name"], op["name"] if op is not None else "-"))
    return out


def host_syncs(p: Profiled) -> float:
    return len(waits(p)) / len(p.steps)


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_by_span(p: Profiled) -> dict:
    """The card's idle microseconds between its first and last operation of
    the profiled window, by the innermost span the host was in (``outside``:
    in none)."""
    busy = _merge([[e["start"], e["end"]] for e in p.events if e["device"]])
    out = {}
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        cuts = sorted({g0, g1, *(t for s in p.spans for t in (s["start"], s["end"]) if g0 < t < g1)})
        for a, b in zip(cuts, cuts[1:]):
            s = _innermost(p.spans, (a + b) / 2)
            name = s["name"] if s else "outside"
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def breakdown(p: Profiled) -> dict:
    """What ``python3 -m portbench.spans`` prints of a traced run."""
    steps = len(p.steps)
    idle = idle_by_span(p)
    by_span = {}
    for name, call, op in waits(p):
        by_span.setdefault(name, {}).setdefault(f"{op} {call}", 0)
        by_span[name][f"{op} {call}"] += 1
    unet = [s for s in p.spans if s["name"] == "unet" and s["parent"] in {t["id"] for t in p.steps}]
    return {"steps": steps,
            "step_ms": sum(s["device_ms"] for s in p.steps) / steps,
            "pre_unet_ms": step_ms(p, PRE), "unet_ms": sum(s["device_ms"] for s in unet) / steps,
            "post_unet_ms": step_ms(p, POST),
            "phase_ms": {n: step_ms(p, (n,)) for n in (*PRE, *POST)},
            "idle_ms": {k: v / 1e3 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
            "idle_outside_share": idle.get("outside", 0.0) / max(sum(idle.values()), 1e-9),
            "host_syncs": len(waits(p)) / steps, "waits": by_span,
            "counts": {s["name"]: s["counts"] for s in p.spans if s["counts"]}}


def main(argv=None) -> int:
    from portbench import harness, run

    kept = {}

    class Kept(harness.Readings):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            p = load(self)
            kept["spans"] = breakdown(p) if p is not None else None

    harness.Readings = Kept
    rc = run.main(list(argv if argv is not None else sys.argv[1:]) + ["--trace", "1"])
    print("spans: " + json.dumps(kept.get("spans")), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
