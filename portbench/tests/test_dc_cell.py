"""The DynamiCrafter cell ``dc1024_planar_2k`` at the program's tiny
DynamiCrafter sizes on the CPU: the sound program is correct; each fault
DynamiCrafter's path can have, planted underneath the timed path (the
concat dropped, frame 0's image tokens on every frame, the v output read as
eps, the guidance rescale off), and the fp8 control come out not correct;
and the reference against the program's plain path."""

import contextlib
import copy
import dataclasses
import json
import time

import pytest
import torch

from portbench import control, harness, inputs
from portbench.reference import dynamicrafter as dc
from portbench.reference import nets, pipeline

CELL = "dc1024_planar_2k"
SEED = 2 ** 31 + 4321


def tiny_spec() -> harness.Spec:
    """The cell with the tiny DynamiCrafter model and small traffic, fp32,
    the cell's own limits; the Resampler's queries as one count, as in the
    configuration file."""
    from dynamicscaler_tpu_torch.config import tiny_dynamicrafter_config

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    real = harness.Spec(CELL, bench)
    config, mix = copy.deepcopy(real.config), copy.deepcopy(real.mix)
    cfg = tiny_dynamicrafter_config()
    m = json.loads(json.dumps(dataclasses.asdict(cfg)))
    m.pop("dtype")
    m["resampler"].update(num_queries=cfg.resampler.tokens, video_length=1)
    config["model"], config["dtype"] = m, "float32"
    S = 6
    mix.update(total_w=64, total_h=32, total_f=4, frames=4, height=16, width=32, loop_step=2, num_inference_steps=S,
               overlap_f=[0.5] * S, loop_step_frame=2, merge_prev=[0.5, 0.25, 0.0, 0.0, 0.0, 0.0], unet_microbatch=4,
               check_steps=[1, 2], unet_shape={"frames": 4, "h": 8, "w": 16, "ctx_len": 79})
    return harness.Spec(CELL, bench, config, mix)


def run(fault=None):
    return harness.run_cell(CELL, SEED, 0.5, False, time.perf_counter(), device="cpu", spec=tiny_spec(), fault=fault)


def test_sound_program_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert {c["name"] for c in r["checks"]} == {"init", "static", "eps", "state", "video"}
    assert set(r["metrics"]) == {"step_s", "setup_s"} and r["attempted"] >= 1


@contextlib.contextmanager
def patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def concat_dropped(model):
    from dynamicscaler_tpu_torch.pipelines import planar

    def make(orig):
        def joined(self, x, origins):
            y = orig(self, x, origins)
            y[..., x.shape[-1]:] = 0.0
            return y
        return joined
    return patched(planar.PlanarShiftWindowEngine, "_joined", make)


def frame0_tokens(model):
    from dynamicscaler_tpu_torch.models import unet3d

    def make(orig):
        def frame_context(self, context, Fn):
            ctx, run = orig(self, context, Fn)
            Lt = self.cfg.text_context_len
            img = ctx[:, Lt:].reshape(ctx.shape[0] // Fn, Fn, -1, ctx.shape[-1])[:, :1].expand(-1, Fn, -1, -1)
            return torch.cat([ctx[:, :Lt], img.reshape(ctx.shape[0], -1, ctx.shape[-1])], dim=1), run
        return frame_context
    return patched(unet3d.UNet3D, "frame_context", make)


def eps_read_as_v(model):
    from dynamicscaler_tpu_torch.pipelines import i2v

    def make(orig):
        return lambda model, steps: dataclasses.replace(orig(model, steps), parameterization="eps")
    return patched(i2v, "make_schedule_for_model", make)


def rescale_off(model):
    from dynamicscaler_tpu_torch.pipelines import planar

    def make(orig):
        def init(self, *a, **kw):
            orig(self, *a, **kw)
            self.guidance_rescale = 0.0
        return init
    return patched(planar.PlanarShiftWindowEngine, "__init__", make)


FAULTS = {"concat_dropped": concat_dropped, "frame0_tokens": frame0_tokens, "eps_read_as_v": eps_read_as_v,
          "rescale_off": rescale_off}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    r = run(FAULTS[fault])
    assert not r["correct"], r["checks"]


def test_control_fails_a_number():
    checks = control.readings(CELL, SEED, torch.device("cpu"), tiny_spec())
    assert any(c["value"] > c["limit"] for c in checks), checks


@pytest.fixture(scope="module")
def pair():
    spec = tiny_spec()
    mods = nets.build(spec.config["model"])
    weights = inputs.make_weights(mods, 77, torch.float32, torch.device("cpu"))
    tok = inputs.HashTokenizer(harness.vocab(spec))
    model = harness.port_model(spec, weights, torch.device("cpu"), tok)
    ref = {}
    for name, mod in nets.build(spec.config["model"]).items():
        mod.to_empty(device="cpu")
        mod.load_state_dict(weights[name])
        ref[name] = mod.eval()
    dc.per_frame(ref["unet"])
    return spec, model, ref


@torch.no_grad()
def test_reference_unet_and_step(pair):
    """The per-frame-context UNet on 8-channel rows, then one v step with
    the rescale from the same output; fp32 on both sides (2e-5: the two
    order their sums differently)."""
    from dynamicscaler_tpu_torch.ops import ddim
    from dynamicscaler_tpu_torch.pipelines.t2v import make_schedule_for_model

    spec, model, ref = pair
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 4, 8, 16, 8, generator=g)
    ctx = torch.randn(2, 77 + 4 * 2, spec.config["model"]["unet"]["context_dim"], generator=g)
    t = torch.tensor([999, 20])
    ours, theirs = model.apply_unet(x, t, ctx, 10), ref["unet"](x, t, ctx, 10)
    assert float((ours - theirs).norm() / theirs.norm()) < 2e-5
    sched = dc.Schedule(6, spec.config["model"]["diffusion"], "cpu")
    port = make_schedule_for_model(model, 6)
    assert list(sched.timesteps) == port.ddim_timesteps.tolist()
    rows = torch.cat([ours[:1], ours[1:]])
    lat = torch.randn(1, 4, 8, 16, 4, generator=g)
    for index in (5, 2, 0):
        want = sched.ddim(lat, dc.guided(rows, 1, 7.5, 0.7), index)
        got = ddim.ddim_step(port, lat, ddim.guided(rows[:1], rows[1:], 7.5, 0.7), torch.full((4,), index))
        for a, b in zip(got, want):
            assert float((a - b).norm() / b.norm()) < 1e-6


def test_reference_concat_rows():
    static = torch.randn(1, 1, 8, 12, 4, generator=torch.Generator().manual_seed(2))
    origins = [(0, 6, 9), (0, 0, 0)]
    rows = dc.concat_rows(static, origins, (3, 4, 5))
    from dynamicscaler_tpu_torch.ops.ring import get_ring_window

    for k, (_, h0, w0) in enumerate(origins):
        want = get_ring_window(static, (0, h0, w0), (1, 4, 5))[0].expand(3, -1, -1, -1)
        assert torch.equal(rows[k], want) and torch.equal(rows[k + 2], want)
    assert pipeline.ring_index((1, 1, 8, 12, 4), (0, 6, 9), (1, 4, 5), "cpu")[1].tolist() == [6, 7, 0, 1]


def test_the_reference_loads_nothing_of_the_program():
    from portbench.tests.test_imports import FORBIDDEN, loaded_by

    mods = loaded_by("import portbench.reference.dynamicrafter, portbench.traffic.dc_planar_stage, "
                     "portbench.metrics.cond_ms")
    assert not mods & {"dynamicscaler_tpu_torch", *FORBIDDEN}
