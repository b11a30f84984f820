"""The PyTorch port's CLI (``cli/gen_pano_360.py``) and what it reads and
writes, against the JAX package, on the CPU.

* The three-stage ``--dev_tiny`` run twice, once through the JAX CLI and
  once through the port's, on the tiny i2v twin bundle (JAX parameters ->
  the port's modules) and the same PNG panorama; the port is handed the
  JAX draws of every noise site (the JAX CLI folds its key with 1, 2, 4
  for the stage samplers and 3 for the re-noise before stage 3). The three
  stage latents agree within ``close_fp32_chain``, the lossless PNG frames
  of both videos within 2 of 255, and both write the same files and the
  same ``args.json`` keys (less the JAX CLI's four warm-start flags).
* Resume: a port run from the stage-1 latent of a full run (default
  generators) reproduces its stage-2 and stage-3 latents exactly.
* ``VArgs`` parity, the startup refusals, ``--dev_tiny`` on the CPU.
* The checkpoint loader on tiny checkpoints written here (Lightning,
  DeepSpeed, EMA shadows with and without ``prefer_ema``), exactly equal to
  the JAX loader's trees through ``from_jax_*``; missing and extra keys.
* the MJPEG AVI against the JAX writer and reader, ``LoopStats``,
  ``init_constant``, ``load_tokenizer``, and the port importing with PIL
  and imageio blocked, where ``save_video`` refuses with a clear error.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.cli import gen_pano_360 as jcli
from dynamicscaler_tpu.models.lvdm import tiny_test_config as jtiny
from dynamicscaler_tpu.models.unet3d import UNet3D as JUNet3D
from dynamicscaler_tpu.utils import avi as javi
from dynamicscaler_tpu.utils import weights as jweights
from dynamicscaler_tpu_torch.cli import gen_pano_360 as cli
from dynamicscaler_tpu_torch.config import tiny_test_config
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.pipelines import planar
from dynamicscaler_tpu_torch.utils import avi, timing, tokenizer, weights
from torch_port_helpers import (close_fp32_chain, i2v_jax_params, i2v_twin_models, jax_noise, random_jax_params,
                                smooth_pano)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX CLI's flags for its TPU server and XLA compiles, not ported
DROPPED = {"aot_warm", "warm_probe", "repeat_warm", "resident_pass"}
# the port's own flags, which the JAX CLI does not have: the preset and the guidance rescale
PORT_ONLY = {"model": ("videocrafter_i2v_512", "str"), "guidance_rescale": (0.0, "float")}
LATENTS = ("sphere_SW_latent.npy", "basic_SW_latent.npy", "denoised_latent2x.npy")
SEED = 11


def _png(path, img):
    Image.fromarray(img).save(path)
    return str(path)


@pytest.fixture(scope="module")
def pano(tmp_path_factory):
    """A smooth 64x128 panorama as PNG (the CLI resizes it to 128x64, 64x32
    and 128x64 for its stages)."""
    img = np.round((smooth_pano(7, 64, 128) + 1) * 127.5).astype(np.uint8)
    return _png(tmp_path_factory.mktemp("in") / "pano.png", img)


def _jax_draws(key):
    """The port's ``_noise``: site k's draws from the JAX CLI's key folded
    with k (its samplers split that key; the re-noise draws from it
    directly)."""
    def site(k):
        kk = jax.random.fold_in(key, k)
        if k == 3:
            return lambda name, shape: np.array(jax.random.normal(kk, shape))
        return jax_noise(kk)
    return site


@pytest.fixture(scope="module")
def twin_runs(pano, tmp_path_factory):
    jmodel, tmodel = i2v_twin_models()
    out = str(tmp_path_factory.mktemp("cli"))
    kw = dict(dev_tiny=True, pano_image_path=pano, output_dir=out, seed=SEED)
    saved = os.environ.get("DSCALER_NO_COMPILE_CACHE")
    os.environ["DSCALER_NO_COMPILE_CACHE"] = "1"  # keep the suite's compile cache where conftest put it
    try:
        jdir = jcli.main(jcli.VArgs(aot_warm=False, project_name="jax", **kw), _model=jmodel)
    finally:
        if saved is None:
            del os.environ["DSCALER_NO_COMPILE_CACHE"]
        else:
            os.environ["DSCALER_NO_COMPILE_CACHE"] = saved
    tdir = cli.main(cli.VArgs(project_name="port", **kw), _model=tmodel,
                    _noise=_jax_draws(jax.random.PRNGKey(SEED % (2**31))))
    return jdir, tdir


@pytest.mark.parametrize("name", LATENTS)
def test_cli_stage_latents_match_jax(twin_runs, name):
    jdir, tdir = twin_runs
    got, ref = np.load(os.path.join(tdir, name)), np.load(os.path.join(jdir, name))
    assert got.shape == ref.shape and np.isfinite(got).all()
    close_fp32_chain(torch.from_numpy(got), ref)


@pytest.mark.parametrize("video", ["shift_windows", "SW_2X"])
def test_cli_video_frames_match_jax(twin_runs, video):
    """The lossless PNG frames beside the AVI (no mp4 backend here)."""
    jdir, tdir = twin_runs
    names = sorted(os.listdir(os.path.join(jdir, f"{video}_frames")))
    assert names == sorted(os.listdir(os.path.join(tdir, f"{video}_frames"))) and len(names) == 4
    for n in names:
        a = np.asarray(Image.open(os.path.join(tdir, f"{video}_frames", n)), np.int16)
        b = np.asarray(Image.open(os.path.join(jdir, f"{video}_frames", n)), np.int16)
        assert a.shape == b.shape == ((32, 64, 3) if video == "shift_windows" else (64, 128, 3))
        assert np.abs(a - b).max() <= 2


def test_cli_writes_the_jax_files_and_args(twin_runs):
    jdir, tdir = twin_runs
    assert set(os.listdir(tdir)) == set(os.listdir(jdir)) | {"e2e.json"}
    jargs = json.load(open(os.path.join(jdir, "args.json")))
    targs = json.load(open(os.path.join(tdir, "args.json")))
    assert set(targs) == (set(jargs) - DROPPED) | set(PORT_ONLY)
    assert {k: targs[k] for k in targs if k not in ("project_name", *PORT_ONLY)} == \
        {k: jargs[k] for k in targs if k not in ("project_name", *PORT_ONLY)}
    assert {k: targs[k] for k in PORT_ONLY} == {k: v[0] for k, v in PORT_ONLY.items()}
    e2e = json.load(open(os.path.join(tdir, "e2e.json")))
    assert e2e["device"] == "cpu" and set(e2e["stages_sec"]) == {"sphere", "planar_1x", "upscale"}
    # dev_tiny: stage 1 runs 3 steps, stages 2 and 3 one each (4 steps, skip 3)
    assert e2e["steady_sec_per_step"]["sphere"] > 0 and e2e["steady_sec_per_step"]["upscale"] is None


def test_cli_resume_reproduces_the_full_run(pano, tmp_path):
    kw = dict(dev_tiny=True, pano_image_path=pano, output_dir=str(tmp_path), seed=5)
    full = cli.main(cli.VArgs(project_name="full", profile_dir=str(tmp_path / "prof"), **kw))
    trace = json.load(open(tmp_path / "prof" / "stage1_trace.json"))
    assert trace["traceEvents"]  # stage 1's profile
    resumed = cli.main(cli.VArgs.from_args([
        "--dev_tiny", "true", "--pano_image_path", pano, "--output_dir", str(tmp_path), "--seed", "5",
        "--project_name", "resumed", "--predenoised_SP_latent_path", os.path.join(full, LATENTS[0])]))
    assert "sphere_SW_latent.npy" not in os.listdir(resumed)
    for name in LATENTS[1:]:
        a, b = np.load(os.path.join(full, name)), np.load(os.path.join(resumed, name))
        assert np.isfinite(a).all() and np.array_equal(a, b)


def test_vargs_match_jax_less_the_warm_flags():
    ours = {f.name: (f.default, f.type) for f in dataclasses.fields(cli.VArgs)}
    ref = {f.name: (f.default, f.type) for f in dataclasses.fields(jcli.VArgs) if f.name not in DROPPED}
    assert {k: v for k, v in ours.items() if k not in PORT_ONLY} == ref
    assert {k: ours[k] for k in PORT_ONLY} == PORT_ONLY
    # the same parsing, bools included
    argv = ["--skip_1x", "yes", "--do_upscale", "false", "--guidance_scale", "5", "--phi_num", "4"]
    a = dataclasses.asdict(cli.VArgs.from_args(argv))
    b = dataclasses.asdict(jcli.VArgs.from_args(argv))
    assert {k: v for k, v in a.items() if k not in PORT_ONLY} == {k: v for k, v in b.items() if k not in DROPPED}
    assert a["skip_1x"] is True and a["do_upscale"] is False and a["guidance_scale"] == 5.0


@pytest.mark.parametrize("argv,match", [
    # more ranks than cards (none here); the id is the one this case had when every N > 1 was refused
    pytest.param(["--data_parallel_devices", "2"],
                 "data_parallel_devices 2: one rank a CUDA card needs 2 cards; found 0",
                 id="argv0-data_parallel_devices 2"),
    (["--dtype", "float16"], "bfloat16 only"),
])
def test_cli_refuses_at_startup(argv, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        cli.main(cli.VArgs.from_args(argv + ["--output_dir", str(tmp_path)]))
    assert not os.listdir(tmp_path)  # refused before anything was built or written


def test_data_parallel_ranks_match_one_process(pano, tmp_path):
    """``--dev_tiny --data_parallel_devices 2``: two gloo ranks give the
    three stage latents of the one-process run bit for bit (``--unet_microbatch
    2``: every stage's shares are whole microbatches), and only rank 0
    writes: the one-process run's files, ``e2e.json`` with the gathers."""
    kw = ["--dev_tiny", "true", "--pano_image_path", pano, "--output_dir", str(tmp_path), "--seed", "3",
          "--unet_microbatch", "2"]
    one = cli.main(cli.VArgs.from_args(kw + ["--project_name", "one"]))
    two = cli.main(cli.VArgs.from_args(kw + ["--project_name", "two", "--data_parallel_devices", "2"]))
    assert sorted(os.listdir(tmp_path)) == ["one", "two"] and set(os.listdir(one)) == set(os.listdir(two))
    for name in LATENTS:
        a, b = np.load(os.path.join(one, name)), np.load(os.path.join(two, name))
        assert np.isfinite(a).all() and np.array_equal(a, b), name
    e2e = json.load(open(os.path.join(two, "e2e.json")))
    assert e2e["ranks"] == 2 and set(e2e["gathers"]) == {"sphere", "planar_1x", "upscale"}
    assert e2e["gathers"]["sphere"] == 3 and e2e["gathers"]["upscale"] == 1  # a gather a step
    assert json.load(open(os.path.join(two, "args.json")))["data_parallel_devices"] == 2
    with pytest.raises(ValueError, match="one process"):
        cli.main(cli.VArgs(dev_tiny=True, data_parallel_devices=2), _model=object())


def test_build_model_dev_tiny_on_cpu_and_others_need_the_card(monkeypatch):
    m = cli.build_model(cli.VArgs(dev_tiny=True))
    assert m.device.type == "cpu" and m.dtype == torch.float32 and m.image_encoder is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in (dict(dev_full_random=True), dict(ckpt_path="missing.ckpt")):
        with pytest.raises(RuntimeError, match="CUDA card"):
            cli.build_model(cli.VArgs(**flags))


def test_init_constant(monkeypatch):
    cfg = dataclasses.replace(tiny_test_config(True), dtype="bfloat16")
    m = LatentVideoDiffusion.init_constant(cfg, device="cpu")
    ref = LatentVideoDiffusion.build(cfg, "meta")
    n = 0
    for (name, mod), (_, rmod) in zip(m.components(), ref.components()):
        for p in mod.parameters():
            assert p.device.type == "cpu" and p.dtype == torch.bfloat16
            assert bool((p == torch.tensor(0.01, dtype=torch.bfloat16)).all()), name
            n += p.numel()
    assert n == sum(p.numel() for _, mod in ref.components() for p in mod.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        LatentVideoDiffusion.init_constant(cfg)


def test_load_tokenizer_needs_the_bpe_file(tmp_path):
    for path in (None, str(tmp_path / "missing.txt.gz")):
        with pytest.raises(FileNotFoundError, match="bpe_simple_vocab_16e6"):
            tokenizer.load_tokenizer(path)
    assert isinstance(tokenizer.load_tokenizer(None, allow_fallback=True), tokenizer.HashTokenizer)


# ---------------------------------------------------------------------------
# the checkpoint loader
# ---------------------------------------------------------------------------

FROM_JAX = {"unet": weights.from_jax_unet, "vae": weights.from_jax_vae, "clip_text": weights.from_jax_clip_text,
            "clip_vision": weights.from_jax_clip_vision, "resampler": weights.from_jax_resampler}
# keys a VideoCrafter checkpoint holds that no module of the port has
EXTRAS = {"cond_stage_model.model.logit_scale": torch.ones(()),
          "cond_stage_model.model.text_projection": torch.ones(32, 32),
          "first_stage_model.loss.logvar": torch.zeros(())}


@pytest.fixture(scope="module")
def flat_state_dict():
    """The tiny i2v bundle's parameters as one VideoCrafter-named state_dict."""
    jcfg = jtiny(img_attention=True)
    cfg = tiny_test_config(True)
    params = i2v_jax_params(jcfg, seed=30)
    sd = {}
    for comp, fn in FROM_JAX.items():
        for k, v in fn(params[comp], getattr(cfg, comp)).items():
            sd[weights.COMPONENT_PREFIXES[comp] + k] = v
    return sd


def _checkpoint(sd, form, path):
    sd = dict(sd, **EXTRAS, betas=torch.linspace(0, 1, 10))
    if form == "deepspeed":
        obj = {"module": {"module." + k: v for k, v in sd.items()}}
    elif form.startswith("ema"):
        g = torch.Generator().manual_seed(3)
        unet = [k for k in sd if k.startswith("model.diffusion_model.")]
        shadows = {"model_ema." + k[len("model."):].replace(".", ""): sd[k] + 0.01 * torch.randn(sd[k].shape,
                                                                                                 generator=g)
                   for k in unet}
        for k in unet[::7]:  # some primaries removed: their shadows stand in
            del sd[k]
        obj = {"state_dict": dict(sd, **shadows, **{"model_ema.decay": torch.tensor(0.9999),
                                                      "model_ema.num_updates": torch.tensor(7)}),
               "epoch": 3}
    else:
        obj = {"state_dict": sd, "global_step": 12}
    torch.save(obj, path)
    return str(path)


@pytest.mark.parametrize("form", ["lightning", "deepspeed", "ema", "ema_prefer"])
def test_loader_matches_the_jax_loader_exactly(flat_state_dict, form, tmp_path, capsys):
    path = _checkpoint(flat_state_dict, form, tmp_path / "model.ckpt")
    prefer = form == "ema_prefer"
    cfg = tiny_test_config(True)
    got = weights.load_videocrafter_checkpoint(path, cfg, prefer_ema=prefer)
    assert "ignored keys the modules lack: unet 0, vae 1, clip_text 2, clip_vision 0, resampler 0" in \
        capsys.readouterr().out
    ref = jweights.load_videocrafter_checkpoint(path, jtiny(img_attention=True), prefer_ema=prefer,
                                                param_dtype="float32")
    modules = dict(LatentVideoDiffusion.build(cfg, "meta").components())
    assert set(got) == set(FROM_JAX) == set(modules)
    for comp, fn in FROM_JAX.items():
        want = fn(ref[comp], getattr(cfg, comp))
        assert list(got[comp]) == list(modules[comp].state_dict())
        assert set(got[comp]) == set(want), comp
        for k, v in want.items():
            assert torch.equal(got[comp][k], v), (comp, k)
    if form.startswith("ema"):  # a removed primary reads its shadow; a kept one its primary unless prefer_ema
        removed, kept = [k for k in flat_state_dict if k.startswith("model.diffusion_model.")][:2]
        strip = len("model.diffusion_model.")
        assert not torch.equal(got["unet"][removed[strip:]], flat_state_dict[removed])
        assert torch.equal(got["unet"][kept[strip:]], flat_state_dict[kept]) != prefer
    model = LatentVideoDiffusion.build(cfg, "cpu").load_state_dicts(**got)
    assert model.unet.out[2].weight.dtype == torch.float32


def test_loader_takes_the_t2v_config(tmp_path, capsys):
    """A tiny VideoCrafter2 t2v checkpoint (UNet, VAE, CLIP text; no image
    parts), as ``cli/sample.py`` loads it, exactly equal to the JAX
    loader's trees through ``from_jax_*``."""
    jcfg, cfg = jtiny(img_attention=False), tiny_test_config(False)
    params = i2v_jax_params(jtiny(img_attention=True), seed=40)
    comps = ("unet", "vae", "clip_text")
    t2v_unet = weights.from_jax_unet(
        random_jax_params(JUNet3D(jcfg.unet).init, jnp.zeros((1, 2, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1, 77, 32)), 16, seed=41), cfg.unet)
    sd = {weights.COMPONENT_PREFIXES["unet"] + k: v for k, v in t2v_unet.items()}
    for comp in comps[1:]:
        sd.update({weights.COMPONENT_PREFIXES[comp] + k: v
                   for k, v in FROM_JAX[comp](params[comp], getattr(cfg, comp)).items()})
    path = _checkpoint(sd, "lightning", tmp_path / "t2v.ckpt")
    got = weights.load_videocrafter_checkpoint(path, cfg)
    assert "ignored keys the modules lack: unet 0, vae 1, clip_text 2" in capsys.readouterr().out
    ref = jweights.load_videocrafter_checkpoint(path, jcfg, param_dtype="float32")
    assert set(got) == set(comps)
    for comp in comps:
        want = FROM_JAX[comp](ref[comp], getattr(cfg, comp))
        assert set(got[comp]) == set(want), comp
        for k, v in want.items():
            assert torch.equal(got[comp][k], v), (comp, k)
    model = LatentVideoDiffusion.build(cfg, "cpu").load_state_dicts(**got)
    assert model.image_encoder is None and model.unet.out[2].weight.dtype == torch.float32


def test_loader_names_a_missing_key(flat_state_dict, tmp_path):
    sd = dict(flat_state_dict)
    del sd["first_stage_model.decoder.conv_out.bias"]
    path = _checkpoint(sd, "lightning", tmp_path / "model.ckpt")
    with pytest.raises(KeyError, match="vae weights lack 1 of .* first_stage_model.decoder.conv_out.bias"):
        weights.load_videocrafter_checkpoint(path, tiny_test_config(True))


# ---------------------------------------------------------------------------
# host I/O
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(avi, javi), (javi, avi)])
def test_mjpeg_avi_round_trip_against_jax(writer, reader, tmp_path):
    frames = [np.round((smooth_pano(s, 48, 80) + 1) * 127.5).astype(np.uint8) for s in range(3)]
    path = writer.write_mjpeg_avi(str(tmp_path / "v.avi"), frames, fps=8)
    got, fps = reader.read_mjpeg_avi(path)
    assert fps == 8 and got.shape == (3, 48, 80, 3)
    assert np.abs(got.astype(int) - np.stack(frames)).mean() < 8  # JPEG at quality 92 of a noisy image
    assert np.array_equal(got, writer.read_mjpeg_avi(path)[0])
    other = reader.write_mjpeg_avi(str(tmp_path / "w.avi"), frames, fps=8)
    assert open(path, "rb").read() == open(other, "rb").read()
    assert reader.read_avi_info(path) == {"frames": 3, "fps": 8, "width": 80, "height": 48, "has_index": True,
                                          "index_entries": 3}


def test_loop_stats_on_a_cpu_loop():
    stats = timing.LoopStats()
    x = torch.zeros(4)
    for n in (1, 3):
        stats.start(n)
        for i in range(n):
            x = x + 1
            if i == 0:
                stats.mark_first(x)
        stats.finish(x)
        assert (stats.steady_sec_per_step is None) if n == 1 else stats.steady_sec_per_step >= 0
    # the planar engine keeps one
    assert isinstance(planar.LOOP_STATS, timing.LoopStats)


def test_port_imports_and_writes_without_pil_and_imageio(tmp_path):
    """The port imports with PIL and imageio blocked, and save_video then
    refuses with an error naming both, writing nothing."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['PIL'] = sys.modules['imageio'] = None\n"
        "import numpy as np\n"
        "import dynamicscaler_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from dynamicscaler_tpu_torch.utils import io\n"
        f"out = {str(tmp_path / 'out')!r}\n"
        "v = np.linspace(-1, 1, 2 * 8 * 16 * 3, dtype=np.float32).reshape(2, 8, 16, 3)\n"
        "try:\n"
        "    io.save_video(v, out, 'clip', fps=8)\n"
        "except ImportError as e:\n"
        "    print('refused:', e)\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    line = run.stdout.strip().splitlines()[-1]
    assert line.startswith("refused:") and "imageio" in line and "PIL" in line, run.stdout
    assert not os.listdir(tmp_path / "out")
