"""The frozen reference against the program's plain path at the program's
tiny test sizes, on the CPU, with the benchmark's weights loaded into both."""

import numpy as np
import pytest
import torch

from portbench import harness, inputs
from portbench.reference import nets, pipeline
from portbench.tests.tiny import tiny_spec

TOL = 2e-5


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module", params=["i2v_sphere_2k", "t2v_loop_wide"])
def pair(request):
    spec = tiny_spec(request.param)
    mods = nets.build(spec.config["model"])
    weights = inputs.make_weights(mods, 1234, torch.float32, torch.device("cpu"))
    tok = inputs.HashTokenizer(harness.vocab(spec))
    model = harness.port_model(spec, weights, torch.device("cpu"), tok)
    ref = {}
    for name, mod in nets.build(spec.config["model"]).items():
        mod.to_empty(device="cpu")
        mod.load_state_dict(weights[name])
        ref[name] = mod.eval()
    return spec, model, ref, tok


@torch.no_grad()
def test_unet(pair):
    spec, model, ref, _ = pair
    g = torch.Generator().manual_seed(0)
    L = 81 if spec.config["model"]["clip_vision"] else 77
    x = torch.randn(2, 4, 8, 8, 4, generator=g)
    ctx = torch.randn(2, L, spec.config["model"]["unet"]["context_dim"], generator=g)
    t = torch.tensor([999, 401])
    assert rel(ref["unet"](x, t, ctx, 8), model.apply_unet(x, t, ctx, 8)) < TOL


@torch.no_grad()
def test_conditioning(pair):
    spec, model, ref, tok = pair
    cond = pipeline.Conditioner(ref, tok, spec.config["model"])
    prompts = ["a red fox in snow", ""]
    assert rel(cond.text(prompts), model.encode_text(prompts)) < TOL
    if spec.config["model"]["clip_vision"]:
        img = torch.rand(3, 20, 28, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
        assert rel(cond.image(img), model.encode_image_cond(img)) < TOL


@torch.no_grad()
def test_vae(pair):
    from dynamicscaler_tpu_torch.pipelines.tiled_vae import ring_aware_decode, tiled_vae_encode

    spec, model, ref, _ = pair
    img = torch.rand(2, 16, 24, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    z = ref["vae"].encode(img)
    assert rel(z, model.encode_video(img[:, None])[:, 0]) < TOL
    assert rel(ref["vae"].decode(z), model.decode_video(z[:, None])[:, 0]) < TOL
    ring = torch.randn(1, 2, 8, 32, 4, generator=torch.Generator().manual_seed(3))
    assert rel(pipeline.ring_decode(ref["vae"], ring[0]), ring_aware_decode(model, ring)[0]) < TOL
    pano = torch.rand(32, 64, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1
    assert rel(pipeline.tiled_encode(ref["vae"], pano, 2), tiled_vae_encode(model, pano.numpy())) < TOL


def test_sphere_maps():
    from dynamicscaler_tpu_torch.ops import sphere

    for fov, th, phi in ((120, 12, 75), (120, 300, -90), (110, 240, 0)):
        v = sphere.make_sphere_view(fov, th, phi, 40, 64, 128, 256)
        g, valid, s = pipeline.view_maps(fov, th, phi, 40, 64, 128, 256)
        np.testing.assert_array_equal(g, v.gather_idx.reshape(-1))
        np.testing.assert_array_equal(valid, v.valid.reshape(-1))
        np.testing.assert_array_equal(s, v.scatter_idx.reshape(-1))


def test_grids_and_ddim():
    from dynamicscaler_tpu_torch.core.windows import IntegerGrid, frame_window_origins, sphere_step_views
    from dynamicscaler_tpu_torch.ops import ddim

    p = dict(frames=16, height=320, width=512, vs=8, num_windows_f=4, num_windows_h=1, num_windows_w=2, loop_step=8)
    grid = IntegerGrid(16, 40, 64, 4, 1, 2, 8)
    phi_theta = {90.0: [0], 0.0: [0, 60, 120]}
    for step in range(20):
        assert pipeline.grid_origins(step, p) == grid.step_origins(step)
        assert pipeline.frame_origins(step, 64, 16, 0.5, 8, True) == frame_window_origins(step, 64, 16, 0.5, 8, True)
        assert pipeline.phase_views(phi_theta, step, 10, 120) == sphere_step_views(phi_theta, step, 10, 120)
    from dynamicscaler_tpu_torch.core.windows import PlanarGrid

    q = dict(frames=16, height=320, width=512, vs=8, total_h=512, total_w=1024, total_f=16, num_windows_h=2,
             num_windows_w=2, loop_step=16, overlap_f=[0.75] * 20, loop_step_frame=8, dock_at_f=True)
    planar = PlanarGrid(64, 128, 40, 64, 2, 2, 16, 8)
    for step in range(20):
        assert pipeline.fractional_origins(step, q) == [
            (f0, h0, w0) for f0 in frame_window_origins(step, 16, 16, 0.75, 8, True)
            for h0, w0 in planar.step_origins(step)]
    diffusion = harness.load_json(harness.HERE / "configs" / "vc_i2v_512.json")["model"]["diffusion"]
    sched = pipeline.Schedule(48, diffusion, "cpu")
    theirs = ddim.make_ddim_schedule(48, linear_start=diffusion["linear_start"], linear_end=diffusion["linear_end"])
    g = torch.Generator().manual_seed(3)
    x, eps, noise = (torch.randn(1, 16, 4, 4, 4, generator=g) for _ in range(3))
    for index in (47, 20, 0):
        ours, theirs_step = sched.ddim(x, eps, index), ddim.ddim_step(theirs, x, eps, torch.full((16,), index))
        for a, b in zip(ours, theirs_step):
            assert rel(a, b) < 1e-6
        assert rel(sched.re_noise(x, max(index - 1, 0), index, noise),
                   ddim.re_noise(theirs, x, max(index - 1, 0), index, noise=noise)) < 1e-6
