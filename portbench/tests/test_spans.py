"""The span readers on a synthetic profiler event list and span set: the
three readers' values, a pageable copy that also synchronises counted
once, and ``None`` where the program has no recorder (as at a commit
before it) or the run profiled no step."""

import sys
import types

import pytest

from portbench import spans
from portbench.metrics import host_syncs, post_unet_ms, pre_unet_ms


def rec(id, name, parent, device_ms, request=1, **counts):
    return types.SimpleNamespace(id=id, name=name, parent=parent, request=request, counts=counts,
                                 device_ms=device_ms, profiled=True)


def host(name, start, end, corr=0):
    return {"name": name, "device": False, "start": start, "end": end, "corr": corr}


def dev(name, start, end, corr=0):
    return {"name": name, "device": True, "start": start, "end": end, "corr": corr}


def one_step(step0, id0):
    """One profiled step at host time ``step0``: its spans (device ms) and
    its trace events. Waits: a pageable H2D copy and the synchronise that
    ends it in one ``aten::copy_`` (one wait), a ``nonzero`` that copies to
    pinned memory and synchronises (one), a pinned copy (none), a pageable
    D2H copy with no host op around it (one)."""
    t = step0
    recorded = [rec(id0, "step", None, 10.0, pairs=4), rec(id0 + 1, "step.gather", id0, 1.0),
                rec(id0 + 2, "step.masks", id0, 2.0), rec(id0 + 3, "step.renoise", id0, 0.5),
                rec(id0 + 4, "unet", id0, 5.0, forwards=1, rows=8), rec(id0 + 5, "step.update", id0, 0.75),
                rec(id0 + 6, "step.scatter", id0, 0.25)]
    c = 1000 * (id0 + 1)
    events = [
        host("ds.step", t, t + 100), host("ds.step.gather", t + 1, t + 10),
        host("aten::copy_", t + 2, t + 8), host("cudaMemcpyAsync", t + 3, t + 4, c),
        dev("Memcpy HtoD (Pageable -> Device)", t + 4, t + 5, c), host("cudaStreamSynchronize", t + 5, t + 7, c + 1),
        dev("kernel", t + 8, t + 12),
        host("ds.step.masks", t + 11, t + 30), host("aten::nonzero", t + 12, t + 20),
        host("cudaMemcpyAsync", t + 13, t + 14, c + 2), dev("Memcpy DtoH (Device -> Pinned)", t + 14, t + 15, c + 2),
        host("cudaStreamSynchronize", t + 15, t + 19, c + 3),
        dev("kernel", t + 21, t + 29),
        host("ds.step.renoise", t + 31, t + 40), host("aten::copy_", t + 32, t + 34),
        host("cudaMemcpyAsync", t + 32, t + 33, c + 4), dev("Memcpy HtoD (Pinned -> Device)", t + 33, t + 34, c + 4),
        dev("kernel", t + 35, t + 40),
        host("ds.unet", t + 41, t + 80), dev("kernel", t + 42, t + 80),
        host("ds.step.update", t + 81, t + 90), dev("kernel", t + 82, t + 90),
        host("ds.step.scatter", t + 91, t + 99), host("cudaMemcpyAsync", t + 92, t + 93, c + 5),
        dev("Memcpy DtoH (Device -> Pageable)", t + 93, t + 94, c + 5), dev("kernel", t + 95, t + 99),
    ]
    return recorded, events


def profiled(n_steps=2):
    recorded, events = [], []
    for k in range(n_steps):
        r, e = one_step(1000 * k, 10 * k)
        recorded += r
        events += e
    # a span the recorder kept before the profiler started is not matched
    recorded.insert(0, types.SimpleNamespace(id=-1, name="request.plan", parent=None, request=1, counts={},
                                             device_ms=3.0, profiled=False))
    return spans.match(recorded, events)


def readings(p):
    r = types.SimpleNamespace(window=types.SimpleNamespace(prof_window=None))
    r._ds_spans = p
    return r


def test_readers_values():
    r = readings(profiled())
    assert pre_unet_ms.read(r) == pytest.approx(3.5)
    assert post_unet_ms.read(r) == pytest.approx(1.0)
    assert host_syncs.read(r) == 3


def test_pageable_copy_that_synchronises_counts_once():
    w = spans.waits(profiled(1))
    assert w == [("step.gather", "cudaMemcpyAsync", "aten::copy_"),
                 ("step.masks", "cudaStreamSynchronize", "aten::nonzero"), ("step.scatter", "cudaMemcpyAsync", "-")]


def test_matching_and_breakdown():
    p = profiled()
    assert [s["name"] for s in p.spans[:7]] == ["step", *spans.PRE[:3], "unet", *spans.POST]
    assert p.spans[0]["start"] == 0 and p.spans[7]["start"] == 1000
    b = spans.breakdown(p)
    assert b["step_ms"] == 10.0 and b["unet_ms"] == 5.0 and b["steps"] == 2
    assert b["pre_unet_ms"] + b["unet_ms"] + b["post_unet_ms"] == pytest.approx(9.5)
    # the card idles inside every span, and outside all of them between the steps
    assert set(b["idle_ms"]) == {"step.gather", "step.masks", "step.renoise", "unet", "step.update",
                                 "step.scatter", "step", "outside"}
    assert b["waits"] == {"step.gather": {"aten::copy_ cudaMemcpyAsync": 2},
                          "step.masks": {"aten::nonzero cudaStreamSynchronize": 2},
                          "step.scatter": {"- cudaMemcpyAsync": 2}}


def test_none_without_the_recorder(monkeypatch):
    """A program whose timing module has no recorder, or a run with no
    profiled window, reads None from every span reader."""
    import dynamicscaler_tpu_torch.utils as utils

    bare = types.ModuleType("dynamicscaler_tpu_torch.utils.timing")
    monkeypatch.setitem(sys.modules, "dynamicscaler_tpu_torch.utils.timing", bare)
    monkeypatch.setattr(utils, "timing", bare, raising=False)
    window = types.SimpleNamespace(prof_window=[0.0, 1.0, object()])
    for mod in (pre_unet_ms, post_unet_ms, host_syncs):
        assert mod.read(types.SimpleNamespace(window=window)) is None
    monkeypatch.undo()
    for mod in (pre_unet_ms, post_unet_ms, host_syncs):
        assert mod.read(types.SimpleNamespace(window=types.SimpleNamespace(prof_window=None))) is None
