"""The PyTorch port's sampler stack against the JAX package, on the CPU:
DDIM schedule math with injected noise, ring windows, blends, the integer
window grid, and the tiny-config shift-window t2v sampler end to end in all
three overlap modes (``use_pre_denoise`` is in
tests/test_torch_t2v_pre_denoise.py). Plus: the BPE tokenizer gives the JAX
ids, the hash tokenizer gives the same ids in every process, and importing
the port pulls in no JAX.
"""

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.core.windows import IntegerGrid as JIntegerGrid
from dynamicscaler_tpu.ops import blend as jblend
from dynamicscaler_tpu.ops import ddim as jddim
from dynamicscaler_tpu.ops import ring as jring
from dynamicscaler_tpu.pipelines import t2v as jt2v
from dynamicscaler_tpu.utils.tokenizer import CLIPBPETokenizer as JCLIPBPETokenizer
from dynamicscaler_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from dynamicscaler_tpu_torch.core.windows import IntegerGrid
from dynamicscaler_tpu_torch.ops import blend, ddim, ring
from dynamicscaler_tpu_torch.pipelines import t2v
from dynamicscaler_tpu_torch.utils.tokenizer import CLIPBPETokenizer, HashTokenizer
from torch_port_helpers import close_fp32_chain, t2v_twin_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ---------------------------------------------------------------------------
# DDIM (fp32 tables; tolerance: fp32 rounding of the same formulas)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_scale,eta", [(True, 0.0), (False, 0.5)])
def test_ddim_tables_step_and_renoise_match_jax(rng, use_scale, eta):
    kw = dict(use_scale=use_scale, scale_b=0.7, eta=eta)
    js = jddim.make_ddim_schedule(12, **kw)
    ts = ddim.make_ddim_schedule(12, **kw)
    for f in ("betas", "alphas_cumprod", "ddim_alphas", "ddim_alphas_prev", "ddim_sigmas",
              "ddim_sqrt_one_minus_alphas", "scale_arr", "sqrt_alphas_cumprod"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(ts.ddim_timesteps.numpy(), np.asarray(js.ddim_timesteps))

    x = rng.standard_normal((2, 4, 3, 5, 4)).astype(np.float32)
    eps = rng.standard_normal(x.shape).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    idx = np.array([11, 7, 3, 0])
    jx, jx0 = jddim.ddim_step(js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(idx))
    tx, tx0 = ddim.ddim_step(ts, _t(x), _t(eps), torch.from_numpy(idx))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-5, rtol=1e-5)

    jr = jddim.re_noise(js, jnp.asarray(x), 2, 9, key=None, noise=jnp.asarray(noise))
    tr = ddim.re_noise(ts, _t(x), 2, 9, noise=_t(noise))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6, rtol=1e-6)
    steps = np.array([0, 4, 8, 11])
    jr = jddim.re_noise_per_frame(js, jnp.asarray(x), jnp.asarray(steps), key=None, noise=jnp.asarray(noise))
    tr = ddim.re_noise_per_frame(ts, _t(x), torch.from_numpy(steps), noise=_t(noise))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# ring windows, blends, window grid (exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("origin,sizes", [((0, 0, 0), (4, 3, 5)), ((3, 5, 9), (4, 6, 8)),
                                          ((-1, 7, 13), (2, 6, 10)), ((5, 2, 1), (6, 12, 20))])
def test_ring_get_set_add_match_jax(rng, origin, sizes):
    lat = rng.standard_normal((1, 6, 6, 10, 3)).astype(np.float32)
    jw = jring.get_ring_window(jnp.asarray(lat), origin, sizes)
    tw = ring.get_ring_window(_t(lat), origin, sizes)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    fs, hs, ws = (min(s, d) for s, d in zip(sizes, lat.shape[1:4]))
    win = rng.standard_normal((1, fs, hs, ws, 3)).astype(np.float32)
    js = jring.set_ring_window(jnp.asarray(lat), jnp.asarray(win), origin)
    ts = ring.set_ring_window(_t(lat), _t(win), origin)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ja = jring.add_ring_window(jnp.asarray(lat), jnp.asarray(win), origin)
    ta = ring.add_ring_window(_t(lat), _t(win), origin)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-7)


def test_blends_match_jax(rng):
    a, b = (rng.standard_normal((1, 2, 4, 6, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.random((1, 2, 4, 6, 1)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(blend.mix_with_mask(_t(a), _t(b), _t(mask), 0.3).numpy(),
                               np.asarray(jblend.mix_with_mask(a, b, mask, 0.3)), rtol=1e-6)
    for parity in (0, 1):
        np.testing.assert_allclose(blend.checkerboard_mix(_t(a), _t(b), 0.25, parity).numpy(),
                                   np.asarray(jblend.checkerboard_mix(a, b, 0.25, parity)), rtol=1e-6)
    count = rng.integers(0, 3, (1, 2, 4, 6, 1)).astype(np.float32)
    np.testing.assert_allclose(blend.normalize_accumulated(_t(a), _t(count), _t(b)).numpy(),
                               np.asarray(jblend.normalize_accumulated(a, count, b)), rtol=1e-6)
    np.testing.assert_allclose(blend.normalize_accumulated(_t(a), _t(count)).numpy(),
                               np.asarray(jblend.normalize_accumulated(a, count)), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(num_windows_f=1, num_windows_h=1, num_windows_w=2, loop_step=4),
    dict(num_windows_f=2, num_windows_h=2, num_windows_w=3, loop_step=3, dock_at_h=True),
    dict(num_windows_f=1, num_windows_h=2, num_windows_w=2, loop_step=5,
         shift_jump_odd_w=True, shift_jump_odd_h=True, docking_w=True, docking_h=True,
         docking_step_range=(1, 2, 6)),
])
def test_integer_grid_matches_jax(kw):
    sizes = dict(win_f=16, win_h=40, win_w=64)
    jg, tg = JIntegerGrid(**sizes, **kw), IntegerGrid(**sizes, **kw)
    assert (tg.total_f, tg.total_h, tg.total_w) == (jg.total_f, jg.total_h, jg.total_w)
    for step in range(9):
        assert tg.step_origins(step) == jg.step_origins(step), step


# ---------------------------------------------------------------------------
# the shift-window sampler end to end (tiny config, fp32)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def twin_models():
    return t2v_twin_models()


@pytest.mark.parametrize("mode", ["last", "average", "sequential"])
def test_shift_window_sampler_matches_jax(twin_models, mode):
    jmodel, tmodel = twin_models
    init = np.random.default_rng(9).standard_normal((1, 4, 16, 32, 4)).astype(np.float32)
    kw = dict(num_windows_w=2, height=32, width=32, frames=4, num_inference_steps=3,
              merge_renoised_overlap_latent_ratio=0.0, overlap_mode=mode)
    jv, jd = jt2v.sample_shift_multi_windows(jmodel, "a red fox", key=jax.random.PRNGKey(0),
                                             init_panorama_latent=jnp.asarray(init), **kw)
    tv, td = t2v.sample_shift_multi_windows(tmodel, "a red fox", init_panorama_latent=_t(init), **kw)
    assert tv.shape == (1, 4, 32, 64, 3)
    close_fp32_chain(td, jd)
    close_fp32_chain(tv, jv)


def test_basic_sample_matches_jax(twin_models):
    """Single-window DDIM with CFG from the same initial latent."""
    jmodel, tmodel = twin_models
    init = np.random.default_rng(10).standard_normal((1, 4, 16, 16, 4)).astype(np.float32)
    kw = dict(height=32, width=32, frames=4, num_inference_steps=3)
    jv, jd = jt2v.basic_sample(jmodel, "a swan", latents=jnp.asarray(init), **kw)
    tv, td = t2v.basic_sample(tmodel, "a swan", latents=_t(init), **kw)
    close_fp32_chain(td, jd)
    close_fp32_chain(tv, jv)


TEXTS = ["A cat, hello!", "  dog's 42 CATS  ", " ".join(["hello"] * 90), "naïve café"]


def test_clip_bpe_tokenizer_matches_jax(tmp_path):
    """The port's numpy-only tokenizer copy gives the JAX package's ids
    (synthetic merges file, as tests/test_tokenizer.py builds it)."""
    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: synthetic", "c a", "ca t</w>", "h e", "l l", "he ll",
                           "hell o</w>"]))
    np.testing.assert_array_equal(CLIPBPETokenizer(str(path))(TEXTS), JCLIPBPETokenizer(str(path))(TEXTS))


def test_hash_tokenizer_ids_do_not_depend_on_the_process():
    """Same ids under two string-hash seeds (the JAX twin's ``hash`` ids do
    not survive a new process), padded and bounded like the JAX twin's."""
    code = (
        "import json\n"
        "from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer\n"
        f"print(json.dumps(HashTokenizer(512)({TEXTS!r}).tolist()))\n"
    )
    ids = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED=seed)
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        ids.append(np.array(json.loads(out.stdout)))
    local = HashTokenizer(512)(TEXTS)
    np.testing.assert_array_equal(ids[0], ids[1])
    np.testing.assert_array_equal(ids[0], local)
    ref = JHashTokenizer(512)(TEXTS)
    assert local.shape == ref.shape and local.dtype == ref.dtype
    np.testing.assert_array_equal(local == 0, ref == 0)
    assert local.max() < 512 and (local[:, 0] == 510).all()


# every module of the port, the i2v and sphere slices' and the four CLIs' included; the walk below must find them all
PORT_MODULES = {
    "cli.batch_eval", "cli.demo", "cli.gen_pano_360", "cli.sample", "config", "core.windows",
    "models.attention", "models.clip", "models.encoders_alt", "models.layers", "models.lvdm", "models.resampler",
    "models.unet3d",
    "models.vae", "models.vae_aux", "models.x_transformer",
    "ops.attention", "ops.blend", "ops.cuda_lib", "ops.ddim", "ops.freetraj", "ops.fused_block",
    "ops.fused_mega", "ops.fused_spatial", "ops.fused_temporal", "ops.fused_twrap", "ops.lcm", "ops.resize",
    "ops.ring", "ops.sphere", "parallel.dist", "parallel.dryrun", "parallel.mesh", "pipelines.conditioning",
    "pipelines.fifo", "pipelines.i2v", "pipelines.planar", "pipelines.sphere", "pipelines.t2v", "pipelines.tiled_vae",
    "utils.avi", "utils.checkpoint", "utils.ema", "utils.io", "utils.precast", "utils.timing", "utils.tokenizer",
    "utils.weights",
}


def test_port_imports_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import dynamicscaler_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dynamicscaler_tpu', 'transformers')]\n"
        "assert not bad, bad\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.startswith('dynamicscaler_tpu_torch.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = {m.split(".", 1)[1] for m in json.loads(out.stdout)}
    assert PORT_MODULES <= loaded, PORT_MODULES - loaded
