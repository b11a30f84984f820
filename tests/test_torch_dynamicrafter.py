"""DynamiCrafter 1024 on the port (``config.dynamicrafter_i2v_1024``) against
the benchmark's plain reference ``portbench/reference/dynamicrafter.py`` on
the CPU, on the tiny DynamiCrafter topology
(``config.tiny_dynamicrafter_config``) with seeded weights and the
zero-initialised layers perturbed: the 8-channel UNet with image tokens per
frame, the zero-terminal-SNR trailing schedule, the v step with the
guidance rescale, one planar engine step with the concat; the per-frame
contexts on every fusion level through the plain versions of kernels 11
and 13; the latent width of every sampler under an 8-channel UNet; a
DynamiCrafter-named checkpoint through the loader and the CLI's preset.

Tolerances, each the sum order of two fp32 implementations: the UNet 2e-5
relative (the reference runs NCHW convolutions and chunked attention, the
port NHWC and its own sub-block order); tables and one DDIM update 1e-6;
the engine step 1e-5 (the step's own arithmetic after two UNet forwards
that agree to 2e-5 relative, shrunk by the update's small coefficient).
"""

import collections
import dataclasses
import os

import numpy as np
import pytest
import torch

from dynamicscaler_tpu_torch import config
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.models.unet3d import UNet3D
from dynamicscaler_tpu_torch.ops import ddim, fused_block, fused_mega, fused_temporal
from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer
from dynamicscaler_tpu_torch.utils.weights import perturb_zero_params
from portbench.reference import dynamicrafter as dc
from portbench.reference import nets

DIFFUSION = dataclasses.asdict(config.tiny_dynamicrafter_config().diffusion)


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def reference_unet(cfg: config.UNetConfig, state_dict) -> dc.UNet:
    unet = dc.per_frame(nets.UNet(nets.namespace(dataclasses.asdict(cfg))))
    unet.load_state_dict(state_dict)
    return unet.eval()


def port_unet(cfg: config.UNetConfig, seed: int) -> UNet3D:
    torch.manual_seed(seed)
    unet = UNet3D(cfg)
    perturb_zero_params(unet, torch.Generator().manual_seed(seed))
    return unet.eval()


@pytest.fixture(scope="module")
def tiny():
    """The tiny DynamiCrafter bundle with its zero layers perturbed, and
    the reference UNet holding the same weights."""
    cfg = config.tiny_dynamicrafter_config()
    model = LatentVideoDiffusion.init_random(cfg, torch.Generator().manual_seed(11), device="cpu",
                                             tokenizer=HashTokenizer(512))
    perturb_zero_params(model.unet, torch.Generator().manual_seed(12))
    return model, reference_unet(cfg.unet, model.unet.state_dict())


@torch.no_grad()
def test_unet_forward_matches_reference(tiny):
    model, ref = tiny
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, 8, 8, generator=g)  # 4 noisy channels, then 4 of the concat
    ctx = torch.randn(2, 77 + 4 * 2, 32, generator=g)
    t = torch.tensor([999, 387])
    got = model.apply_unet(x, t, ctx, 10)
    assert got.shape == (2, 4, 8, 8, 4)
    assert rel(got, ref(x, t, ctx, 10)) < 2e-5
    # each frame reads its own image tokens: moving frame 3's changes frame 3 most
    ctx2 = ctx.clone()
    ctx2[:, 77 + 3 * 2:] += 1.0
    moved = (model.apply_unet(x, t, ctx2, 10) - got).abs().mean(dim=(0, 2, 3, 4))
    assert int(moved.argmax()) == 3


def test_unet_refuses_wrong_widths(tiny):
    model, _ = tiny
    with pytest.raises(ValueError, match="takes 8"):
        model.apply_unet(torch.zeros(1, 4, 8, 8, 4), torch.tensor([5]), torch.zeros(1, 85, 32))
    with pytest.raises(ValueError, match="make 85"):
        model.apply_unet(torch.zeros(1, 4, 8, 8, 8), torch.tensor([5]), torch.zeros(1, 81, 32))


@pytest.mark.parametrize("steps", [6, 48, 50])
def test_schedule_matches_reference(steps):
    port = ddim.make_ddim_schedule(steps, discretize="uniform_trailing", rescale_betas_zero_snr=True,
                                   parameterization="v")
    ref = dc.Schedule(steps, DIFFUSION, "cpu")
    assert port.ddim_timesteps.tolist() == list(ref.timesteps) and int(port.ddim_timesteps[-1]) == 999
    assert float(port.alphas_cumprod[-1]) == 0.0 and float(port.sqrt_one_minus_alphas_cumprod[-1]) == 1.0
    assert torch.equal(port.alphas_cumprod, ref.acp)
    assert torch.equal(port.ddim_alphas_prev, ref.alphas_prev)
    # the first alphas_cumprod keeps its value (Lin et al. 2023, Algorithm 1)
    plain = ddim.make_ddim_schedule(steps)
    assert abs(float(port.alphas_cumprod[0]) - float(plain.alphas_cumprod[0])) < 1e-7


def test_trailing_and_zero_snr_tables():
    """Independently of both: the trailing timesteps of 50 steps are 999,
    979, ..., 19 and the rescaled betas give sqrt(acp) linear in the
    original's, 0 at the end."""
    ts = ddim.make_ddim_timesteps(50, 1000, "uniform_trailing")
    assert ts.tolist() == list(range(19, 1000, 20))
    betas = ddim.make_beta_schedule("linear", 1000, 0.00085, 0.012)
    sq = np.sqrt(np.cumprod(1 - betas))
    new = np.sqrt(np.cumprod(1 - ddim.rescale_zero_terminal_snr(betas)))
    a = (sq[0] - 0.0) / (sq[0] - sq[-1])
    np.testing.assert_allclose(new, a * (sq - sq[-1]), atol=1e-12)


@pytest.mark.parametrize("index", [5, 3, 0])
def test_v_step_and_rescale_match_reference(index):
    g = torch.Generator().manual_seed(index)
    port = ddim.make_ddim_schedule(6, discretize="uniform_trailing", rescale_betas_zero_snr=True,
                                   parameterization="v")
    ref = dc.Schedule(6, DIFFUSION, "cpu")
    x = torch.randn(2, 4, 5, 6, 4, generator=g)
    rows = torch.randn(4, 4, 5, 6, 4, generator=g)
    got_v = ddim.guided(rows[:2], rows[2:], 7.5, 0.7)
    want_v = dc.guided(rows, 2, 7.5, 0.7)
    assert rel(got_v, want_v) < 1e-6
    for a, b in zip(ddim.ddim_step(port, x, got_v, torch.full((4,), index)), ref.ddim(x, want_v, index)):
        assert rel(a, b) < 1e-6
    # no rescale: the plain CFG, bit for bit
    assert torch.equal(ddim.guided(rows[:2], rows[2:], 7.5), rows[2:] + 7.5 * (rows[:2] - rows[2:]))


@torch.no_grad()
def test_planar_engine_step_with_concat_matches_reference(tiny):
    from dynamicscaler_tpu_torch.pipelines.planar import PlanarShiftWindowEngine, StepPlan
    from dynamicscaler_tpu_torch.pipelines.t2v import make_schedule_for_model

    model, ref = tiny
    g = torch.Generator().manual_seed(3)
    lat = torch.randn(1, 4, 16, 24, 4, generator=g)
    static = torch.randn(1, 1, 16, 24, 4, generator=g)
    ctx = torch.randn(3, 77 + 8, 32, generator=g)
    uncond = torch.randn(1, 77 + 8, 32, generator=g)
    origins = np.array([[0, 0, 0], [0, 10, 14], [0, 4, 20]])  # the last two wrap in h and w
    draws = {}

    def noise_fn(name, shape):
        return draws.setdefault(name, torch.randn(shape, generator=g))
    sched = make_schedule_for_model(model, 6)
    step, index = 1, 4
    plan = StepPlan(t=int(sched.ddim_timesteps[index]), index=index, origins=origins, context=ctx,
                    renoise_ratio=1.0, merge_prev_ratio=0.4)
    engine = PlanarShiftWindowEngine(model, sched, (4, 8, 12), guidance_scale=7.5, fps=10, concat=static,
                                     guidance_rescale=0.7)
    latent, denoised = lat.clone(), torch.zeros_like(lat)
    engine.step(latent, denoised, plan, uncond, noise_fn=noise_fn, name=f"renoise:{step}")

    p = dict(frames=4, height=16, width=24, vs=2, renoise_ratio=1.0, guidance=7.5, guidance_rescale=0.7,
             merge_prev=[0.0, 0.4])

    def eps_fn(x, ids):
        t = torch.full((x.shape[0],), plan.t)
        return ref(x, t, torch.cat([ctx, uncond.expand(3, -1, -1)]), 10)
    want_l, want_d, x_rows = dc.planar_step(dc.Schedule(6, DIFFUSION, "cpu"),
                                            {"latent": lat, "denoised": torch.zeros_like(lat), "static": static},
                                            lambda name, shape: draws[name], eps_fn, p, step, index, False,
                                            [tuple(o) for o in origins.tolist()])
    assert x_rows.shape == (6, 4, 8, 12, 8)
    assert rel(latent, want_l) < 1e-5 and rel(denoised, want_d) < 1e-5


# ---------------------------------------------------------------------------
# per-frame contexts on every fusion level
# ---------------------------------------------------------------------------

TINY_WRAP_BLK = "t32=wrap+blk,t64=wrap+blk,t128=wrap+blk,s32=wrap+blk,s64=wrap+blk"
ROUTES = ((fused_block, "spatial_block_plain", "K11"), (fused_mega, "spatial_mega_plain", "K13"))


@pytest.mark.parametrize("spec,expected", [("off", {"K13": 3}), ("auto", {}), (TINY_WRAP_BLK, {"K11": 3})])
@torch.no_grad()
def test_per_frame_contexts_on_every_fusion_level(spec, expected, monkeypatch):
    """Kernels 11 and 13 project a run's context once: with image tokens per
    frame the UNet hands them every frame's own context. At a 16x16 latent
    (N 256 passes their gates) and a 128-wide context, each level gives the
    plain reference's output: "off" through kernel 13's plain version at the
    three 16x16 spatial transformers, the all-wrap+blk plan through kernel
    11's, the default plan through neither."""
    cfg = dataclasses.replace(config.tiny_dynamicrafter_config().unet, context_dim=128)
    unet = port_unet(cfg, 21)
    ref = reference_unet(cfg, unet.state_dict())
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 4, 16, 16, 8, generator=g)
    ctx = torch.randn(2, 77 + 4 * 2, 128, generator=g)
    t = torch.tensor([640, 90])
    calls = collections.Counter()
    for mod, name, k in ROUTES:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _k=k, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    try:
        fused_temporal.set_plan(spec)
        got = unet(x, t, ctx, 10)
    finally:
        fused_temporal.set_plan()
    assert dict(calls) == expected
    assert rel(got, ref(x, t, ctx, 10)) < 2e-5


# ---------------------------------------------------------------------------
# every sampler under an 8-channel UNet
# ---------------------------------------------------------------------------


def _pano(h=32, w=64):
    return np.random.default_rng(1).uniform(-1, 1, (h, w, 3)).astype(np.float32)


def _planar(model):
    from dynamicscaler_tpu_torch.pipelines import i2v

    return i2v.sample_shift_multi_windows(model, "a wave", _pano(), total_w=64, total_h=32, total_f=4, num_windows_w=2,
                                          num_windows_h=2, loop_step=2, height=16, width=32, frames=4,
                                          num_inference_steps=3, guidance_rescale=0.7, decode=False,
                                          generator=torch.Generator().manual_seed(0))[1]


def _planar_skip(model):
    from dynamicscaler_tpu_torch.pipelines import i2v

    return i2v.sample_shift_multi_windows(model, "a wave", _pano(), total_w=64, total_h=32, total_f=4, num_windows_w=2,
                                          num_windows_h=2, loop_step=2, height=16, width=32, frames=4,
                                          num_inference_steps=3, use_skip_time=True, skip_time_step_idx=1,
                                          overlap_mode="sequential", decode=False,
                                          generator=torch.Generator().manual_seed(0))[1]


def _integer(model):
    from dynamicscaler_tpu_torch.pipelines import i2v

    return i2v.sample_shift_multi_windows_integer(model, "a wave", _pano(32, 32), num_windows_w=2, num_windows_h=2,
                                                  height=16, width=16, frames=4, num_inference_steps=2,
                                                  overlap_mode="average", decode=False,
                                                  generator=torch.Generator().manual_seed(0))[1]


def _basic(model):
    from dynamicscaler_tpu_torch.pipelines import i2v

    return i2v.basic_sample(model, "a wave", _pano(16, 16), height=16, width=16, frames=4, num_inference_steps=2,
                            guidance_rescale=0.7, decode=False, generator=torch.Generator().manual_seed(0))[1]


def _sphere(mode):
    def run(model):
        from dynamicscaler_tpu_torch.pipelines import sphere

        return sphere.sample_shift_sphere_panorama(
            model, "a wave", _pano(), equirect_width=64, equirect_height=32, phi_theta_dict={0: [0, 180]},
            view_fov=110, loop_step_theta=2, height=16, width=16, frames=4, total_f=4, num_inference_steps=2,
            guidance_rescale=0.7, overlap_mode=mode, generator=torch.Generator().manual_seed(0))[1]
    return run


SAMPLERS = {"planar": _planar, "planar_skip_sequential": _planar_skip, "integer_average": _integer,
            "basic": _basic, "sphere": _sphere("last"), "sphere_sequential": _sphere("sequential")}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_i2v_samplers_give_latents_of_the_output_width(tiny, name):
    model, _ = tiny
    lat = SAMPLERS[name](model)
    assert lat.shape[-1] == 4 and torch.isfinite(lat).all()


def _t2v_samplers():
    from dynamicscaler_tpu_torch.pipelines import fifo, t2v

    return {"t2v_basic": lambda m: t2v.basic_sample(m, "a wave", 16, 16, frames=4, num_inference_steps=2),
            "t2v_windows": lambda m: t2v.sample_shift_multi_windows(m, "a wave", height=16, width=16, frames=4,
                                                                    num_inference_steps=2),
            "fifo": lambda m: fifo.fifo_sample(m, "a wave", 2, height=16, width=16, frames=4)}


@pytest.mark.parametrize("name", ["t2v_basic", "t2v_windows", "fifo"])
def test_t2v_samplers_refuse_a_concat_model(tiny, name):
    model, _ = tiny
    with pytest.raises(ValueError, match="image-to-video|i2v"):
        _t2v_samplers()[name](model)


def test_t2v_samplers_draw_latents_of_the_output_width():
    """A text-to-video UNet whose output is narrower than its input is not
    a published configuration: the width of the draws comes from
    ``out_channels`` all the same (here both 4)."""
    from dynamicscaler_tpu_torch.pipelines import fifo, t2v

    model = LatentVideoDiffusion.init_random(config.tiny_test_config(False), torch.Generator().manual_seed(1),
                                             device="cpu", tokenizer=HashTokenizer(512))
    shapes = {}

    def noise_fn(name, shape):
        shapes[name] = shape
        return torch.zeros(shape)
    t2v.sample_shift_multi_windows(model, "a", height=16, width=16, frames=4, num_inference_steps=1,
                                   noise_fn=noise_fn, decode=False)
    fifo.fifo_sample(model, "a", 1, height=16, width=16, frames=4, noise_fn=noise_fn, decode=False)
    assert shapes["init"][-1] == model.config.unet.out_channels == 4


# ---------------------------------------------------------------------------
# the checkpoint and the CLI's preset
# ---------------------------------------------------------------------------

DC_PREFIXES = {"unet": "model.diffusion_model.", "vae": "first_stage_model.", "clip_text": "cond_stage_model.model.",
               "clip_vision": "embedder.model.visual.", "resampler": "image_proj_model."}


def test_dynamicrafter_named_checkpoint_loads_through_the_preset(tiny, tmp_path):
    """DynamiCrafter's checkpoint names (its LatentVisualDiffusion: the
    UNet under ``model.diffusion_model``, ``first_stage_model``,
    ``cond_stage_model``, ``embedder``, ``image_proj_model``, and schedule
    buffers the loader ignores) load into the CLI preset's tiny model."""
    from dynamicscaler_tpu_torch.cli import gen_pano_360 as cli
    from dynamicscaler_tpu_torch.utils.weights import load_videocrafter_checkpoint

    model, _ = tiny
    sd = {DC_PREFIXES[name] + k: v.clone() for name, mod in model.components() for k, v in mod.state_dict().items()}
    sd.update({"betas": torch.zeros(1000), "alphas_cumprod": torch.zeros(1000), "scale_arr": torch.ones(1000)})
    assert sd["model.diffusion_model.input_blocks.0.0.weight"].shape[1] == 8
    assert sd["image_proj_model.latents"].shape == (1, 8, 32)
    path = tmp_path / "dynamicrafter_1024_tiny.ckpt"
    torch.save({"state_dict": sd}, path)
    cfg = cli.model_config("dynamicrafter_1024", tiny=True)
    assert cfg == config.tiny_dynamicrafter_config()
    loaded = LatentVideoDiffusion.build(cfg, "cpu", HashTokenizer(512)).load_state_dicts(
        **load_videocrafter_checkpoint(str(path), cfg))
    for (name, a), (_, b) in zip(model.components(), loaded.components()):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), (name, ka)


def test_cli_preset_flags():
    from dynamicscaler_tpu_torch.cli import gen_pano_360 as cli

    v = cli.VArgs.from_args(["--model", "dynamicrafter_1024", "--width", "512"])
    assert (v.height, v.width, v.fps, v.equirect_width, v.guidance_rescale) == (576, 512, 10, 2048, 0.7)
    assert cli.VArgs.from_args([]).guidance_rescale == 0.0
    full = cli.model_config("dynamicrafter_1024")
    assert full == config.dynamicrafter_i2v_1024() and full.unet.concat_channels == 4
    assert full.resampler.tokens == 256 and full.unet.image_tokens_per_frame == 16
    with pytest.raises(ValueError, match="--model"):
        cli.check_flags(cli.VArgs(model="dynamicrafter_512"))


def test_cli_runs_the_preset_tiny(tmp_path):
    """``--dev_tiny`` with ``--model dynamicrafter_1024``: all three stages,
    the planar stages on ``i2v.sample_shift_multi_windows`` with the concat,
    4-channel latents out."""
    from PIL import Image

    from dynamicscaler_tpu_torch.cli import gen_pano_360 as cli

    pano = str(tmp_path / "pano.png")
    Image.fromarray((np.random.default_rng(2).uniform(0, 255, (32, 64, 3))).astype(np.uint8)).save(pano)
    out = cli.main(cli.VArgs.from_args(["--dev_tiny", "true", "--model", "dynamicrafter_1024", "--pano_image_path",
                                        pano, "--output_dir", str(tmp_path), "--project_name", "dc"]))
    for name in ("sphere_SW_latent.npy", "basic_SW_latent.npy", "denoised_latent2x.npy"):
        lat = np.load(os.path.join(out, name))
        assert lat.shape[-1] == 4 and np.isfinite(lat).all()
