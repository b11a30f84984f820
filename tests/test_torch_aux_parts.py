"""The port's smaller pieces off the main path against the JAX package, on
the CPU.

The pooled CLIP image embedders (their dropout mask handed over from the
JAX draw), ``ImageProjModel``, ``IdentityFirstStage``, the bilinear and
linear latent resize (up, down, integer and non-integer factors), the
``zero_embed`` uncond context, the frame-shuffled initial noise of the t2v
sampler, ``Marker`` and its marks in the samplers, the EMA shadows, the
precast latents of images, the checkpoint cache, and the constant
(``--dev_full_random``) bundle through a UNet forward and a DDIM step.
Inputs and weights come from numpy seeds; JAX weights' zero leaves are
perturbed.

Tolerances (fp32): modules that differ from JAX only in the order of their
sums atol 1e-5, rtol 1e-4 (the embedders atol 1e-4 for the bicubic
preprocess, as tests/test_torch_i2v_parts.py holds it within 5e-5); the
resize weights 1e-6; whole sampler chains ``close_fp32_chain``; the EMA
within 2 fp32 ulps (bf16 shadows one bf16 ulp), the cache bit for bit.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dynamicscaler_tpu import config as jconfig
from dynamicscaler_tpu.models import clip as jclip
from dynamicscaler_tpu.models.lvdm import LatentVideoDiffusion as JLVDM
from dynamicscaler_tpu.models.lvdm import tiny_test_config as jtiny
from dynamicscaler_tpu.models.resampler import ImageProjModel as JImageProjModel
from dynamicscaler_tpu.models.vae import IdentityFirstStage as JIdentityFirstStage
from dynamicscaler_tpu.ops import ddim as jddim
from dynamicscaler_tpu.ops.resize import resize_video_latent as jresize
from dynamicscaler_tpu.pipelines import conditioning as jcond
from dynamicscaler_tpu.pipelines import t2v as jt2v
from dynamicscaler_tpu.utils import ema as jema
from dynamicscaler_tpu.utils import precast as jprecast
from dynamicscaler_tpu.utils import timing as jtiming
from dynamicscaler_tpu_torch.config import CLIPVisionConfig, tiny_test_config
from dynamicscaler_tpu_torch.models import clip
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.models.resampler import ImageProjModel
from dynamicscaler_tpu_torch.models.vae import IdentityFirstStage
from dynamicscaler_tpu_torch.ops import ddim
from dynamicscaler_tpu_torch.ops.resize import resize_video_latent
from dynamicscaler_tpu_torch.pipelines import conditioning, i2v, t2v
from dynamicscaler_tpu_torch.utils import checkpoint, ema, precast, timing, weights
from torch_port_helpers import close_fp32_chain, i2v_twin_models, random_jax_params, t2v_twin_models

VISION = dict(image_size=32, patch_size=16, width=32, layers=2, heads=2, output_tokens=5, output_dim=24)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def t2v_twins():
    return t2v_twin_models()


@pytest.fixture(scope="module")
def i2v_twins():
    return i2v_twin_models()


# ---------------------------------------------------------------------------
# pooled image embedders, ImageProjModel, IdentityFirstStage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quick", [False, True])
def test_pooled_image_embedders_match_jax(quick):
    """``OpenCLIPImageEmbedderPooled`` (exact GELU) and ``ClipImageEmbedder``
    (QuickGELU): preprocess, tower, class token, ``ln_post``, ``proj``, and
    the ucg dropout with the JAX draw's keep mask."""
    jcfg, cfg = jconfig.CLIPVisionConfig(**VISION), CLIPVisionConfig(**VISION)
    rng = np.random.default_rng(11)
    images = rng.uniform(-1, 1, (4, 40, 48, 3)).astype(np.float32)
    jm = jclip.ClipImageEmbedder(jcfg, ucg_rate=0.5) if quick else jclip.OpenCLIPImageEmbedderPooled(jcfg, 0.5)
    params = random_jax_params(jm.init, jnp.asarray(images), seed=12)
    key = jax.random.PRNGKey(5)
    keep = np.array(jax.random.bernoulli(key, 0.5, (4,)))
    assert 0 < keep.sum() < 4
    m = clip.ClipImageEmbedder(cfg, ucg_rate=0.5) if quick else clip.OpenCLIPImageEmbedderPooled(cfg, 0.5)
    m.model.load_state_dict(weights.from_jax_clip_vision_pooled(params, cfg), strict=True)
    m.eval()
    with torch.no_grad():
        kept = m(_t(images), keep=torch.from_numpy(keep))
        whole = m(_t(images), keep=torch.from_numpy(keep), no_dropout=True)
        drawn = m(_t(images), generator=torch.Generator().manual_seed(0))
    _close(kept, jm(params, jnp.asarray(images), key=key), atol=1e-4)
    _close(whole, jm(params, jnp.asarray(images)), atol=1e-4)
    assert kept.shape == (4, 24)
    rows = [bool((drawn[i] == 0).all()) or torch.equal(drawn[i], whole[i]) for i in range(4)]
    assert all(rows)


def test_image_proj_model_matches_jax():
    jm = JImageProjModel(cross_attention_dim=16, clip_embeddings_dim=24, num_tokens=4)
    x = np.random.default_rng(13).standard_normal((3, 24)).astype(np.float32)
    params = random_jax_params(jm.init, jnp.asarray(x), seed=14)
    m = ImageProjModel(cross_attention_dim=16, clip_embeddings_dim=24, num_tokens=4)
    m.load_state_dict(weights.from_jax_image_proj(params), strict=True)
    with torch.no_grad():
        got = m(_t(x))
    assert got.shape == (3, 4, 16)
    _close(got, jm.apply(params, jnp.asarray(x)))


def test_identity_first_stage_passes_through():
    x = torch.randn(2, 4, 8, 8, 3)
    for stage in (IdentityFirstStage(), JIdentityFirstStage()):
        assert stage.encode(x) is x and stage.decode(x, 1, key=2) is x


# ---------------------------------------------------------------------------
# bilinear / linear resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bilinear", "linear"])
@pytest.mark.parametrize("src,dst", [((8, 12), (16, 24)), ((16, 24), (8, 12)), ((10, 14), (15, 21)),
                                     ((9, 16), (7, 10)), ((10, 14), (7, 20)), ((8, 8), (8, 3))])
def test_linear_resize_matches_jax(mode, src, dst):
    """Up and down by integer and non-integer factors, mixed, and one axis
    left alone: jax.image.resize's antialiased triangle weights."""
    x = np.random.default_rng(sum(src + dst)).standard_normal((1, 2, *src, 3)).astype(np.float32)
    ref = np.asarray(jresize(jnp.asarray(x), *dst, mode=mode))
    got = resize_video_latent(_t(x), *dst, mode=mode)
    assert got.shape == ref.shape
    _close(got, ref, atol=1e-6, rtol=1e-5)
    if dst[0] < src[0]:
        # F.interpolate neither widens the kernel nor renormalises when it shrinks
        plain = F.interpolate(_t(x)[0].permute(0, 3, 1, 2), size=dst, mode="bilinear", align_corners=False)
        assert not np.allclose(plain.permute(0, 2, 3, 1).numpy(), ref[0], atol=1e-3)


def test_resize_defaults_to_bilinear_and_refuses_unknown_modes():
    x = _t(np.random.default_rng(0).standard_normal((1, 1, 6, 6, 2)))
    assert torch.equal(resize_video_latent(x, 9, 4), resize_video_latent(x, 9, 4, mode="bilinear"))
    with pytest.raises(ValueError, match="resize mode"):
        resize_video_latent(x, 9, 4, mode="area")


# ---------------------------------------------------------------------------
# zero_embed
# ---------------------------------------------------------------------------


def test_zero_embed_t2v_matches_jax(t2v_twins):
    jmodel, tmodel = t2v_twins
    cond = np.random.default_rng(1).standard_normal((2, 77, 32)).astype(np.float32)
    ref = jcond.build_uncond_context(jmodel, batch=2, uncond_type="zero_embed", cond_like=jnp.asarray(cond))
    got = conditioning.build_uncond_context(tmodel, batch=2, uncond_type="zero_embed", cond_like=_t(cond))
    assert got.shape == ref.shape == (2, 77, 32) and not got.any()
    # the default stays empty_seq
    _close(conditioning.build_uncond_context(tmodel), jcond.build_uncond_context(jmodel))
    with pytest.raises(ValueError, match="cond_like"):
        conditioning.build_uncond_context(tmodel, uncond_type="zero_embed")
    with pytest.raises(ValueError, match="uncond_type"):
        conditioning.build_uncond_context(tmodel, uncond_type="zeros")


def test_zero_embed_i2v_matches_jax(i2v_twins):
    """On an image-conditioned model: the text part zeroed, the zero
    image's tokens appended, with the same warning."""
    jmodel, tmodel = i2v_twins
    cond = np.random.default_rng(2).standard_normal((1, 81, 32)).astype(np.float32)
    with pytest.warns(UserWarning, match="zero_embed"):
        ref = jcond.build_uncond_context(jmodel, image_hw=(8, 8), uncond_type="zero_embed",
                                         cond_like=jnp.asarray(cond))
    with pytest.warns(UserWarning, match="zero_embed"):
        got = conditioning.build_uncond_context(tmodel, image_hw=(8, 8), uncond_type="zero_embed",
                                                cond_like=_t(cond))
    assert got.shape == ref.shape == (1, 81, 32) and not got[:, :77].any()
    _close(got, ref)


# ---------------------------------------------------------------------------
# frame-shuffled initial noise
# ---------------------------------------------------------------------------


def test_shuffled_init_matches_jax(monkeypatch, t2v_twins):
    """``random_shuffle_init_frame_stride``: the port handed the JAX
    sampler's initial noise and its frame order (``shuffle_init_frame_order``
    given a numpy generator seeded from the JAX init key, which the port
    cannot reproduce) ends at the JAX sampler's latent."""
    jmodel, tmodel = t2v_twins
    key = jax.random.PRNGKey(4)
    k_init = jax.random.split(key, 3)[0]
    kw = dict(num_windows_f=3, height=32, width=32, frames=4, num_inference_steps=2,
              merge_renoised_overlap_latent_ratio=0.0, random_shuffle_init_frame_stride=3)
    _, jd = jt2v.sample_shift_multi_windows(jmodel, "a red fox", key=key, decode=False, **kw)
    seed = int(jax.random.randint(k_init, (), 0, 2 ** 31 - 1))
    order = t2v.shuffle_init_frame_order(12, 4, 3, np.random.default_rng(seed))
    assert list(order[:4]) == [0, 1, 2, 3] and sorted(order[4:7]) == [0, 1, 2] and list(order) != list(range(12))

    def noise(name, shape):
        return np.array(jax.random.normal(k_init, shape)) if name == "init" else np.zeros(shape, np.float32)

    real = t2v.shuffle_init_frame_order
    monkeypatch.setattr(t2v, "shuffle_init_frame_order",
                        lambda total_f, frames, stride, rng: real(total_f, frames, stride, np.random.default_rng(seed)))
    _, td = t2v.sample_shift_multi_windows(tmodel, "a red fox", noise_fn=noise, decode=False, **kw)
    close_fp32_chain(td, jd)
    _, plain = t2v.sample_shift_multi_windows(tmodel, "a red fox", noise_fn=noise, decode=False,
                                              **{**kw, "random_shuffle_init_frame_stride": 0})
    assert not np.allclose(plain.numpy(), np.asarray(jd), atol=1e-3)


# ---------------------------------------------------------------------------
# Marker
# ---------------------------------------------------------------------------

MARK = re.compile(r"^\[(\w+)\] (.+): \d+\.\d\ds cum$")
LAP = re.compile(r"^\[(\w+)\] (.+) \d+\.\d\ds$")


SPAN = re.compile(r"^\[request \d+\] (\S+): \d+\.\d\ds x(\d+)(.*)$")


def test_marker_prints_as_jax_and_is_silent_when_unset(monkeypatch, capsys):
    """The port's marks and laps in the JAX package's line format, each
    naming the span that closed before it, printed by ``report`` when the
    sampler call ends, then the request's spans by name with their number
    and counts; unset, no span opens and nothing prints."""
    class Model:
        device = torch.device("cpu")

    @timing.request
    def sampler(model):
        m = timing.Marker("tag")
        with timing.span("request.maps", views=3):
            pass
        m.mark("setup")
        m.reset_lap()
        for _ in range(2):
            with timing.span("step", pairs=2):
                pass
        m.lap("step 0/2")

    monkeypatch.setenv("DSCALER_STEP_TIMING", "1")
    timing.take()
    m = jtiming.Marker("tag")
    m.mark("setup")
    m.reset_lap()
    m.lap("step 0/2")
    sampler(Model())
    lines = capsys.readouterr().out.splitlines()
    assert [MARK.match(s).groups() for s in lines[0:4:2]] == [("tag", "setup")] * 2
    assert [LAP.match(s).groups() for s in lines[1:4:2]] == [("tag", "step 0/2")] * 2
    assert [SPAN.match(s).groups() for s in lines[4:]] == [("request", "1", ""), ("request.maps", "1", " views=3"),
                                                           ("step", "2", " pairs=4")]
    assert timing.take() == ([], 0)  # kept only for the print

    monkeypatch.delenv("DSCALER_STEP_TIMING")

    def no_span(*a):
        raise AssertionError("a span with DSCALER_STEP_TIMING unset")
    monkeypatch.setattr(timing, "_Open", no_span)
    assert not timing.Marker("tag").on
    sampler(Model())
    assert capsys.readouterr().out == ""
    assert timing.take() == ([], 0)


def test_samplers_mark_their_phases(i2v_twins, monkeypatch, capsys):
    """The i2v sampler's marks and the planar engine's laps, at the JAX
    package's names and in their order, then its spans with their counts,
    printed when the sampler call ends."""
    monkeypatch.setenv("DSCALER_STEP_TIMING", "1")
    _, tmodel = i2v_twins
    img = np.random.default_rng(0).uniform(-1, 1, (32, 64, 3)).astype(np.float32)
    i2v.sample_shift_multi_windows(tmodel, "a lake", img, total_w=64, total_h=32, total_f=4, num_windows_w=2,
                                   num_windows_h=1, loop_step=2, height=32, width=32, frames=4,
                                   num_inference_steps=2, generator=torch.Generator().manual_seed(0))
    out = capsys.readouterr().out.splitlines()
    got = [m.groups() for m in (MARK.match(s) or LAP.match(s) for s in out) if m]
    assert got == [("i2v", "phase conditioning (CLIP)"), ("i2v", "init latent"), ("i2v", "plan built"),
                   ("planar", "step 0/2 N=2"), ("planar", "step 1/2 N=2"), ("i2v", "denoise loop"),
                   ("i2v", "ring decode")]
    spans = {m.group(1): m.groups()[1:] for m in map(SPAN.match, out[len(got):])}
    assert len(spans) == len(out) - len(got)
    assert spans["step"] == ("2", " windows=4") and spans["unet"] == ("2", " forwards=2 rows=8")
    assert spans["request.image"] == ("2", " crops=5 tokens=20") and spans["request.decode"] == ("1", " frames=4")


# ---------------------------------------------------------------------------
# EMA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_matches_jax(use_num_updates):
    """Five updates over fp32 and bf16 tensors with the warm-up ramp, and
    with it off (``num_updates`` -1): over a state dict and over a module's
    parameters."""
    rng = np.random.default_rng(21)
    shapes = {"a.weight": (4, 3), "b": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    js = jema.ema_init({"a.weight": jnp.asarray(p0["a.weight"]), "b": jnp.asarray(p0["b"], jnp.bfloat16)},
                       decay=0.99, use_num_updates=use_num_updates)
    ts = ema.ema_init({"a.weight": _t(p0["a.weight"]), "b": _t(p0["b"]).bfloat16()}, decay=0.99,
                      use_num_updates=use_num_updates)
    mod = torch.nn.Linear(3, 4, bias=False)
    with torch.no_grad():
        mod.weight.copy_(_t(p0["a.weight"]))
    ms = ema.ema_init(mod, decay=0.99, use_num_updates=use_num_updates)
    for _ in range(5):
        p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        js = jema.ema_update(js, {"a.weight": jnp.asarray(p["a.weight"]), "b": jnp.asarray(p["b"], jnp.bfloat16)})
        ts = ema.ema_update(ts, {"a.weight": _t(p["a.weight"]), "b": _t(p["b"]).bfloat16()})
        with torch.no_grad():
            mod.weight.copy_(_t(p["a.weight"]))
        ms = ema.ema_update(ms, mod)
    assert ts.num_updates == int(js.num_updates) == (5 if use_num_updates else -1)
    shadow, jshadow = ema.ema_params(ts), jema.ema_params(js)
    assert shadow["b"].dtype == torch.bfloat16
    _close(shadow["a.weight"], jshadow["a.weight"], atol=0, rtol=2.4e-7)
    _close(shadow["b"].float(), np.asarray(jshadow["b"], np.float32), atol=0, rtol=2 ** -8)
    assert torch.equal(ema.ema_params(ms)["weight"], shadow["a.weight"])


def test_ema_refuses_a_decay_outside_0_1():
    with pytest.raises(ValueError, match="decay"):
        ema.ema_init({"w": torch.zeros(1)}, decay=1.5)


# ---------------------------------------------------------------------------
# precast latents
# ---------------------------------------------------------------------------


def test_precast_matches_jax(t2v_twins, tmp_path):
    """Images written to a folder, sorted by their trailing window index,
    encoded one at a time and frame-stacked through the VAE."""
    from PIL import Image

    jmodel, tmodel = t2v_twins
    rng = np.random.default_rng(3)
    for name in ("win_10.png", "win_2.png", "win_1.jpg", "notes.txt"):
        path = tmp_path / name
        if name.endswith(".txt"):
            path.write_text("not an image")
        else:
            Image.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(path)
    names = [os.path.basename(p) for p in precast.get_img_list_from_folder(str(tmp_path))]
    assert names == ["win_1.jpg", "win_2.png", "win_10.png"]
    assert names == [os.path.basename(p) for p in jprecast.get_img_list_from_folder(str(tmp_path))]
    got = precast.encode_folder_to_latent_tensor(tmodel, str(tmp_path), 32, 32)
    ref = jprecast.encode_folder_to_latent_tensor(jmodel, str(tmp_path), 32, 32)
    assert got.shape == ref.shape == (1, 3, 16, 16, 4)
    close_fp32_chain(got, ref)
    one = precast.encode_image_to_latent(tmodel, str(tmp_path / "win_2.png"), 32, 32)
    close_fp32_chain(one, jprecast.encode_image_to_latent(jmodel, str(tmp_path / "win_2.png"), 32, 32))


# ---------------------------------------------------------------------------
# the checkpoint cache
# ---------------------------------------------------------------------------


def test_checkpoint_cache_round_trip(tmp_path, monkeypatch, capsys):
    """First load converts and writes the cache beside the checkpoint; the
    second reads the cache alone, bit for bit; a cache that cannot be
    written is not fatal."""
    cfg = tiny_test_config(True)
    src = LatentVideoDiffusion.init_random(cfg, torch.Generator().manual_seed(1), device="cpu")
    sd = {weights.COMPONENT_PREFIXES[n] + k: v for n, m in src.components() for k, v in m.state_dict().items()}
    path = str(tmp_path / "tiny.ckpt")
    torch.save({"state_dict": sd}, path)
    first = checkpoint.load_or_convert(path, cfg)
    assert os.path.isfile(path + checkpoint.CACHE_SUFFIX)

    def no_conversion(*a, **kw):
        raise AssertionError("the cached load converted the checkpoint")
    monkeypatch.setattr(weights, "load_videocrafter_checkpoint", no_conversion)
    second = checkpoint.load_or_convert(path, cfg)
    assert first.keys() == second.keys()
    for name in first:
        assert first[name].keys() == second[name].keys()
        assert all(torch.equal(first[name][k], second[name][k]) and first[name][k].dtype == second[name][k].dtype
                   for k in first[name])
    LatentVideoDiffusion.build(cfg, "cpu").load_state_dicts(**second)
    monkeypatch.undo()
    capsys.readouterr()
    again = checkpoint.load_or_convert(path, cfg, cache_path=str(tmp_path / "missing" / "cache.pt"))
    assert "[checkpoint] cache write failed" in capsys.readouterr().out
    assert all(torch.equal(again["unet"][k], first["unet"][k]) for k in first["unet"])


def test_sample_cli_reads_the_checkpoint_through_the_cache(monkeypatch):
    from dynamicscaler_tpu_torch.cli import gen_pano_360, sample

    seen = {}
    monkeypatch.setattr(gen_pano_360, "load_bundle", lambda *a, **kw: seen.update(kw) or "bundle")
    args = sample.parse_args(["--mode", "t2v", "--prompt", "x", "--ckpt_path", "m.ckpt"])
    assert sample.build_model(args) == "bundle" and seen == {"cached": True}


# ---------------------------------------------------------------------------
# the constant bundle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("img", [False, True])
def test_constant_bundle_matches_jax(img):
    """``init_constant(device="cpu")`` (every parameter 0.01, the
    ``--dev_full_random`` bundle at the tiny config) against the JAX
    constant bundle: one UNet forward and one DDIM step, finite or not
    (non-finite values must sit at the same places)."""
    jm = JLVDM.init_constant(jtiny(img))
    tm = LatentVideoDiffusion.init_constant(tiny_test_config(img), device="cpu")
    rng = np.random.default_rng(30 + img)
    L = 77 + (4 if img else 0)
    x = rng.standard_normal((2, 4, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, L, 32)).astype(np.float32)
    t = np.array([981, 500], np.int32)
    ref = np.asarray(jm.apply_unet(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), 16))
    got = tm.apply_unet(_t(x), torch.from_numpy(t), _t(ctx), 16)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(ref))
    close_fp32_chain(got, ref)
    jsched, sched = jt2v.make_schedule_for_model(jm, 4), t2v.make_schedule_for_model(tm, 4)
    idx = np.array([3, 3, 3, 3])
    jx, jx0 = jddim.ddim_step(jsched, jnp.asarray(x), jnp.asarray(ref), jnp.asarray(idx))
    tx, tx0 = ddim.ddim_step(sched, _t(x), got, torch.from_numpy(idx))
    close_fp32_chain(tx, jx)
    close_fp32_chain(tx0, jx0)
    # the port's DiffusionConfig adds DynamiCrafter's fields, here at their VideoCrafter defaults
    ours, theirs = dataclasses.asdict(tm.config.diffusion), dataclasses.asdict(jm.config.diffusion)
    assert {k: ours.pop(k) for k in ("parameterization", "rescale_betas_zero_snr", "timestep_spacing")} == {
        "parameterization": "eps", "rescale_betas_zero_snr": False, "timestep_spacing": "uniform"}
    assert ours == theirs
