"""The port's span recorder (``utils/timing.py``) and the spans the samplers
open, on the CPU.

Off, ``span`` is one shared no-op: nothing recorded, no event, and the
tiny sphere, i2v-planar and t2v samplers give bit-identical latents with
tracing on and off. On, one step of each sampler opens the spans of its
preamble, its step split around the UNet, and its decode, in order, with
their parents, request ids and counts. A running ``torch.profiler`` turns
the recorder on and holds the ``ds.*`` ranges. ``LoopStats`` reads the
device time between its events (a stub event here)."""

import numpy as np
import pytest
import torch

from dynamicscaler_tpu_torch.config import tiny_test_config
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.pipelines import i2v, planar, sphere, t2v
from dynamicscaler_tpu_torch.utils import timing
from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer

torch.set_num_threads(1)

PANO = np.random.default_rng(0).uniform(-1, 1, (32, 64, 3)).astype(np.float32)
STEP = ["step", "step.gather", "step.masks", "step.renoise", "unet", "step.update", "step.scatter"]


def tiny(img: bool):
    cfg = tiny_test_config(img)
    return LatentVideoDiffusion.init_random(cfg, torch.Generator().manual_seed(3), device="cpu",
                                            tokenizer=HashTokenizer(cfg.clip_text.vocab_size))


@pytest.fixture(scope="module")
def models():
    return {"i2v": tiny(True), "t2v": tiny(False)}


def run_sphere(models, steps=2):
    _, latent, den = sphere.sample_shift_sphere_panorama(
        models["i2v"], "ocean", PANO, equirect_width=64, equirect_height=32,
        phi_theta_dict={0.0: [0.0, 180.0], 60.0: [90.0]}, view_fov=110, loop_step_theta=2, height=16, width=16,
        frames=4, fps=8, num_inference_steps=3, denoise_to_step=steps, total_f=4, unet_microbatch=2,
        generator=torch.Generator().manual_seed(0), decode=True)
    return latent, den


def run_planar(models, steps=2):
    _, den = i2v.sample_shift_multi_windows(
        models["i2v"], "a lake", PANO, total_w=64, total_h=32, total_f=4, num_windows_w=2, num_windows_h=1,
        loop_step=2, height=32, width=32, frames=4, num_inference_steps=2 + steps, use_skip_time=True,
        skip_time_step_idx=2, generator=torch.Generator().manual_seed(0))
    return (den,)


def run_t2v(models, steps=2):
    _, den = t2v.sample_shift_multi_windows(
        models["t2v"], "a fox", num_windows_f=2, num_windows_w=2, height=16, width=16, frames=4,
        num_inference_steps=steps, loop_step=2, unet_microbatch=4, generator=torch.Generator().manual_seed(0))
    return (den,)


SAMPLERS = {"sphere": run_sphere, "planar": run_planar, "t2v": run_t2v}

# one step of each sampler: its request's spans, in the order they open
EXPECTED = {
    "sphere": ["request", "request.maps", "request.text", "request.image", "request.text", "request.image",
               "request.static", "request.init", "request.plan", *STEP, "request.decode"],
    "planar": ["request", "request.text", "request.image", "request.text", "request.image", "request.init",
               "request.static", "request.plan", *STEP, "request.decode"],
    "t2v": ["request", "request.text", "request.text", "request.init", "request.plan", *STEP, "request.decode"],
}
COUNTS = {
    "sphere": {"request.maps": {"views": 6}, "request.image": {"crops": 6, "tokens": 24}, "request.static": {"tiles": 16},
               "step": {"pairs": 3}, "unet": {"forwards": 3, "rows": 6}, "request.decode": {"frames": 4}},
    "planar": {"request.image": {"crops": 4, "tokens": 16}, "request.static": {"tiles": 16}, "step": {"windows": 2},
               "unet": {"forwards": 1, "rows": 4}, "request.decode": {"frames": 4}},
    "t2v": {"request.text": {"prompts": 1}, "step": {"windows": 4}, "unet": {"forwards": 2, "rows": 8},
            "request.decode": {"frames": 8}},
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_tracing_off_records_nothing_and_changes_no_bit(models, name, monkeypatch):
    timing.take()

    def no_event(*a):
        raise AssertionError("an event with tracing off")
    with monkeypatch.context() as m:
        m.setattr(timing, "_event", no_event)
        m.setattr(timing, "_Open", no_event)
        assert not timing.enabled() and timing.span("step", pairs=1) is timing._NOOP
        off = SAMPLERS[name](models)
    assert timing.take() == ([], 0)
    with timing.tracing():
        on = SAMPLERS[name](models)
    assert timing.take().spans
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_one_step_opens_the_spans_in_order(models, name):
    timing.take()
    with timing.tracing():
        SAMPLERS[name](models, steps=1)
    got, dropped = timing.take()
    assert dropped == 0
    assert [s.name for s in got] == EXPECTED[name]
    req = got[0]
    assert req.parent is None and all(s.request == req.request for s in got)
    ids = {s.name: s.id for s in reversed(got)}
    for s in got[1:]:
        parent = "step" if s.name in STEP[1:] else "request.init" if s.name == "request.static" and \
            name == "planar" else "request"
        assert s.parent == ids[parent], s
        assert s.t0_ns <= s.t1_ns and s.device_ms is None  # the CPU: host times only
    for span_name, counts in COUNTS[name].items():
        assert next(s for s in got if s.name == span_name).counts == counts
    # a new request id each call
    with timing.tracing():
        SAMPLERS[name](models, steps=1)
    assert timing.take().spans[0].request == req.request + 1


def test_a_running_profiler_turns_the_recorder_on():
    from torch.profiler import ProfilerActivity, profile

    timing.take()
    assert not timing.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timing.enabled()
        with timing.span("step", windows=2):
            with timing.span("step.gather"):
                torch.ones(4).sum()
    assert not timing.enabled()
    got = timing.take().spans
    assert [(s.name, s.profiled, s.counts) for s in got] == [("step", True, {"windows": 2}),
                                                             ("step.gather", True, {})]
    names = [e.name for e in prof.events()]
    assert names.index("ds.step") < names.index("ds.step.gather") < names.index("aten::sum")


def test_spans_past_the_cap_are_dropped(monkeypatch):
    timing.take()
    monkeypatch.setattr(timing, "MAX_SPANS", 2)
    with timing.tracing():
        for _ in range(5):
            with timing.span("unet"):
                pass
    got = timing.take()
    assert len(got.spans) == 2 and got.dropped == 3


class StubEvent:
    """A CUDA event's timing interface on the host clock, in ms."""

    def __init__(self, clock):
        self.t = clock()
        self.waited = False

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3

    def synchronize(self):
        self.waited = True


def test_loop_stats_on_the_event_path(monkeypatch):
    """``mark_first`` and ``finish`` record events and never synchronise;
    reading ``steady_sec_per_step`` waits for the last event and divides
    the device time between the two by the steps after the first."""
    clock = iter(np.arange(0.0, 100.0, 1.5)).__next__
    made = []

    def event(device):
        made.append(StubEvent(clock))
        return made[-1]
    monkeypatch.setattr(timing, "_is_cuda", lambda device: True)
    monkeypatch.setattr(timing, "_event", event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("a device synchronise"))
    stats = timing.LoopStats()
    x = torch.zeros(4)
    stats.start(4)
    stats.mark_first(x)
    stats.finish(x)
    assert len(made) == 2 and not any(e.waited for e in made)
    assert stats.steady_sec_per_step == pytest.approx(1.5 / 3)
    assert made[1].waited
    stats.start(1)
    stats.mark_first(x)
    stats.finish(x)
    assert stats.steady_sec_per_step is None
    assert isinstance(planar.LOOP_STATS, timing.LoopStats) and isinstance(sphere.LOOP_STATS, timing.LoopStats)


def test_the_operators_print_leaves_traced_spans_to_take(models, monkeypatch, capsys):
    """With ``DSCALER_STEP_TIMING`` set inside a ``tracing()`` block, the
    print at the end of the call reads the spans and leaves them to
    ``take``; the env alone lets them go once printed."""
    monkeypatch.setenv("DSCALER_STEP_TIMING", "1")
    timing.take()
    with timing.tracing():
        run_t2v(models, steps=1)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[planar] step 0/1 N=4 ")  # the engine's lap
    assert [s.split("] ")[1].split(":")[0] for s in out[1:4]] == ["request", "request.text", "request.init"]
    assert [s.name for s in timing.take().spans] == EXPECTED["t2v"]
    run_t2v(models, steps=1)
    assert capsys.readouterr().out and timing.take() == ([], 0)
