"""The port's span recorder (``utils/timing.py``) and the spans the samplers
open, on the CPU.

Off, ``span`` is one shared no-op: nothing recorded, no event, and the
tiny sphere, i2v-planar and t2v samplers give bit-identical latents with
tracing on and off. On, one step of each sampler opens the spans of its
preamble, its step split around the UNet, and its decode, in order, with
their parents, request ids and counts: in each overlap mode, and with a
tiny DynamiCrafter (the concat join and the guidance rescale) on the
planar and sphere windows. A running ``torch.profiler`` turns the
recorder on and holds the ``ds.*`` ranges. ``LoopStats`` reads the device
time between its events (a stub event here)."""

import functools

import numpy as np
import pytest
import torch

from dynamicscaler_tpu_torch.config import tiny_dynamicrafter_config, tiny_test_config
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.pipelines import i2v, planar, sphere, t2v
from dynamicscaler_tpu_torch.utils import timing
from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer

torch.set_num_threads(1)

PANO = np.random.default_rng(0).uniform(-1, 1, (32, 64, 3)).astype(np.float32)
# one window's spans inside a step: the batch of a ``last`` step, or each
# window of a ``sequential`` one
WINDOW = ["step.gather", "step.masks", "step.renoise", "unet", "step.update", "step.scatter"]
STEP = ["step", *WINDOW]
# ``average`` on the ring: no masks, so no re-noise and no merge
AVERAGE = ["step", "step.gather", "step.renoise", "unet", "step.update", "step.scatter"]
# hybrid conditioning: the concat join before the UNet, the rescale and the
# v conversion inside the update
HYBRID = ["step", "step.gather", "step.masks", "step.renoise", "step.concat", "unet", "step.update", "step.rescale",
          "step.scatter"]
PARENT = {**{n: "step" for n in WINDOW + ["step.concat"]}, "step.rescale": "step.update"}


def tiny(cfg):
    return LatentVideoDiffusion.init_random(cfg, torch.Generator().manual_seed(3), device="cpu",
                                            tokenizer=HashTokenizer(cfg.clip_text.vocab_size))


@pytest.fixture(scope="module")
def models():
    return {"i2v": tiny(tiny_test_config(True)), "t2v": tiny(tiny_test_config(False)),
            "dc": tiny(tiny_dynamicrafter_config())}


def run_sphere(models, steps=2, mode="last", model="i2v", **kw):
    _, latent, den = sphere.sample_shift_sphere_panorama(
        models[model], "ocean", PANO, equirect_width=64, equirect_height=32,
        phi_theta_dict={0.0: [0.0, 180.0], 60.0: [90.0]}, view_fov=110, loop_step_theta=2, height=16, width=16,
        frames=4, fps=8, num_inference_steps=3, denoise_to_step=steps, total_f=4, unet_microbatch=2,
        overlap_mode=mode, generator=torch.Generator().manual_seed(0), decode=True, **kw)
    return latent, den


def run_planar(models, steps=2, mode="last", model="i2v", **kw):
    _, den = i2v.sample_shift_multi_windows(
        models[model], "a lake", PANO, total_w=64, total_h=32, total_f=4, num_windows_w=2, num_windows_h=1,
        loop_step=2, height=32, width=32, frames=4, num_inference_steps=2 + steps, use_skip_time=True,
        skip_time_step_idx=2, overlap_mode=mode, generator=torch.Generator().manual_seed(0), **kw)
    return (den,)


def run_t2v(models, steps=2, mode="last"):
    _, den = t2v.sample_shift_multi_windows(
        models["t2v"], "a fox", num_windows_f=2, num_windows_w=2, height=16, width=16, frames=4,
        num_inference_steps=steps, loop_step=2, unet_microbatch=4, overlap_mode=mode,
        generator=torch.Generator().manual_seed(0))
    return (den,)


SAMPLERS = {"sphere": run_sphere, "planar": run_planar, "t2v": run_t2v}
for _name, _run in list(SAMPLERS.items()):
    for _mode in ("average", "sequential"):
        SAMPLERS[f"{_name}-{_mode}"] = functools.partial(_run, mode=_mode)
SAMPLERS["sphere-dc"] = functools.partial(run_sphere, model="dc", guidance_rescale=0.7)
SAMPLERS["planar-dc"] = functools.partial(run_planar, model="dc", guidance_rescale=0.7)

SPHERE = ["request", "request.maps", "request.text", "request.image", "request.text", "request.image",
          "request.static", "request.init", "request.plan"]
# the skip-time init encodes the panorama inside ``request.init``; a hybrid
# model's concat latent is encoded before it, and the init reuses it
PLANAR = ["request", "request.text", "request.image", "request.text", "request.image", "request.init",
          "request.static", "request.plan"]
STATIC_IN_INIT = {"planar", "planar-average", "planar-sequential"}
T2V = ["request", "request.text", "request.text", "request.init", "request.plan"]

# one step of each sampler: its request's spans, in the order they open
EXPECTED = {
    "sphere": [*SPHERE, *STEP, "request.decode"],
    "sphere-average": [*SPHERE, *STEP, "request.decode"],
    # the paste target first (its draw comes before the pairs'), then pair by pair
    "sphere-sequential": [*SPHERE, "step", "step.scatter", *WINDOW * 3, "request.decode"],
    "sphere-dc": [*SPHERE, *HYBRID, "request.decode"],
    "planar": [*PLANAR, *STEP, "request.decode"],
    "planar-average": [*PLANAR, *AVERAGE, "request.decode"],
    # the window contexts first, then window by window
    "planar-sequential": [*PLANAR, "step", "step.renoise", *WINDOW * 2, "request.decode"],
    "planar-dc": [*PLANAR[:5], "request.static", "request.init", "request.plan", *HYBRID, "request.decode"],
    "t2v": [*T2V, *STEP, "request.decode"],
    "t2v-average": [*T2V, *AVERAGE, "request.decode"],
    "t2v-sequential": [*T2V, "step", "step.renoise", *WINDOW * 4, "request.decode"],
}
COUNTS = {
    "sphere": {"request.maps": {"views": 6}, "request.image": {"crops": 6, "tokens": 24}, "request.static": {"tiles": 16},
               "step": {"pairs": 3}, "unet": {"forwards": 3, "rows": 6}, "request.decode": {"frames": 4}},
    "sphere-average": {"step": {"pairs": 3}, "unet": {"forwards": 3, "rows": 6}},
    "sphere-sequential": {"step": {"pairs": 3}, "unet": {"forwards": 1, "rows": 2}},
    "sphere-dc": {"request.image": {"crops": 6, "tokens": 48}, "step": {"pairs": 3}, "step.concat": {"rows": 6},
                  "unet": {"forwards": 3, "rows": 6}, "step.rescale": {"rows": 3}},
    "planar": {"request.image": {"crops": 4, "tokens": 16}, "request.static": {"tiles": 16}, "step": {"windows": 2},
               "unet": {"forwards": 1, "rows": 4}, "request.decode": {"frames": 4}},
    "planar-average": {"step": {"windows": 2}, "unet": {"forwards": 1, "rows": 4}},
    "planar-sequential": {"step": {"windows": 2}, "unet": {"forwards": 1, "rows": 2}},
    "planar-dc": {"request.image": {"crops": 4, "tokens": 32}, "request.static": {"tiles": 16}, "step": {"windows": 2},
                  "step.concat": {"rows": 4}, "unet": {"forwards": 1, "rows": 4}, "step.rescale": {"rows": 2}},
    "t2v": {"request.text": {"prompts": 1}, "step": {"windows": 4}, "unet": {"forwards": 2, "rows": 8},
            "request.decode": {"frames": 8}},
    "t2v-average": {"step": {"windows": 4}, "unet": {"forwards": 2, "rows": 8}},
    "t2v-sequential": {"step": {"windows": 4}, "unet": {"forwards": 1, "rows": 2}},
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
    latest = {req.name: req.id}  # the last span of each name opened so far
    for s in got[1:]:
        parent = PARENT.get(s.name, "request.init" if s.name == "request.static" and name in STATIC_IN_INIT
                            else "request")
        assert s.parent == latest[parent], s
        assert s.t0_ns <= s.t1_ns and s.device_ms is None  # the CPU: host times only
        latest[s.name] = s.id
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
