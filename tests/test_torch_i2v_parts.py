"""The modules of the PyTorch port's i2v slice against the JAX package, on
the CPU: CLIP preprocess and vision tower, Resampler, ``encode_image_cond``,
tiled VAE encode and ring-aware decode, latent resize, the window grids, the
i2v uncond context and the converters; the integer-grid i2v sampler (the
``cli/sample.py`` entry) end to end; plus the device rule of ``init_random``
and the full-width i2v parameter counts.

Tiny configs in fp32 with JAX parameters from ``random_jax_params``; the
tolerance of each comparison is stated where it is made.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.config import videocrafter_i2v as jvideocrafter_i2v
from dynamicscaler_tpu.core import windows as jwindows
from dynamicscaler_tpu.models.clip import CLIPVisionEncoder as JCLIPVision
from dynamicscaler_tpu.models.clip import clip_preprocess as jclip_preprocess
from dynamicscaler_tpu.models.resampler import Resampler as JResampler
from dynamicscaler_tpu.ops import resize as jresize
from dynamicscaler_tpu.pipelines import conditioning as jconditioning
from dynamicscaler_tpu.pipelines import i2v as ji2v
from dynamicscaler_tpu.pipelines import tiled_vae as jtiled
from dynamicscaler_tpu.utils import weights as jweights
from dynamicscaler_tpu_torch.config import tiny_test_config, videocrafter_i2v
from dynamicscaler_tpu_torch.core import windows
from dynamicscaler_tpu_torch.models.clip import CLIPVisionEncoder, clip_preprocess
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.models.resampler import Resampler
from dynamicscaler_tpu_torch.ops import resize
from dynamicscaler_tpu_torch.pipelines import conditioning, i2v, tiled_vae
from dynamicscaler_tpu_torch.utils import weights
from torch_port_helpers import close_fp32_chain, i2v_twin_models, jax_noise, random_jax_params, smooth_pano

TINY = tiny_test_config(img_attention=True)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def twin_models():
    return i2v_twin_models(seed=40)


# ---------------------------------------------------------------------------
# CLIP vision and the Resampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,size", [((320, 512), 224), ((40, 64), 224), ((48, 20), 32)])
def test_clip_preprocess_matches_jax(rng, hw, size):
    """Antialiased bicubic (a = -0.5, half-pixel centres) on both sides; the
    two resamplers sum their taps in another order: atol 5e-5 on values of
    order 2 (the JAX twin's 320x512 -> 224 and 40x64 -> 224 read 1.4e-5 and
    4.6e-6 apart)."""
    img = rng.uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    ref = jclip_preprocess(jnp.asarray(img), size)
    _close(clip_preprocess(_t(img), size), ref, atol=5e-5, rtol=0)


def test_clip_vision_tower_matches_jax(rng):
    """All grid^2 + 1 tokens, no ln_post; fp32, atol/rtol 1e-4 (LayerNorm
    variance formulas and attention sums differ in order)."""
    cfg = TINY.clip_vision
    x = rng.standard_normal((3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    jm = JCLIPVision(cfg)
    params = random_jax_params(jm.init, jnp.asarray(x), seed=11)
    ref = jm.apply(params, jnp.asarray(x))
    tm = CLIPVisionEncoder(cfg)
    tm.load_state_dict(weights.from_jax_clip_vision(params, cfg))
    with torch.no_grad():
        got = tm(_t(x))
    assert got.shape == (3, cfg.output_tokens, cfg.width)
    _close(got, ref, atol=1e-4, rtol=1e-4)


def test_resampler_matches_jax(rng):
    cfg = dataclasses.replace(TINY.resampler, depth=2)
    x = rng.standard_normal((2, 5, cfg.embedding_dim)).astype(np.float32)
    jm = JResampler(cfg)
    params = random_jax_params(jm.init, jnp.asarray(x), seed=12)
    ref = jm.apply(params, jnp.asarray(x))
    tm = Resampler(cfg)
    tm.load_state_dict(weights.from_jax_resampler(params, cfg))
    with torch.no_grad():
        got = tm(_t(x))
    assert got.shape == (2, cfg.num_queries, cfg.output_dim)
    _close(got, ref, atol=1e-4, rtol=1e-4)


def test_from_jax_clip_vision_and_resampler_invert_the_converters():
    """convert_* (the JAX package's checkpoint converters) on the port's
    state_dicts, then from_jax_*: the same names and values, exactly."""
    torch.manual_seed(0)
    for mod, conv, back, cfg in (
        (CLIPVisionEncoder(TINY.clip_vision), jweights.convert_clip_vision, weights.from_jax_clip_vision,
         TINY.clip_vision),
        (Resampler(TINY.resampler), jweights.convert_resampler, weights.from_jax_resampler, TINY.resampler),
    ):
        for p in mod.parameters():
            torch.nn.init.normal_(p)
        sd = {k: v.detach().clone() for k, v in mod.state_dict().items()}
        got = back(conv({k: v.numpy() for k, v in sd.items()}, cfg), cfg)
        assert set(got) == set(sd)
        for k in sd:
            assert torch.equal(got[k], sd[k]), k


def test_encode_image_cond_matches_jax_in_chunks(twin_models, rng):
    """Preprocess -> vision tower -> Resampler, 5 images in chunks of 2 on
    the port's side and one batch on the JAX side; atol/rtol 1e-4."""
    jmodel, tmodel = twin_models
    imgs = rng.uniform(-1, 1, (5, 24, 40, 3)).astype(np.float32)
    ref = jmodel.encode_image_cond(jnp.asarray(imgs))
    got = tmodel.encode_image_cond(imgs, microbatch=2)
    assert got.shape == (5, TINY.resampler.num_queries, TINY.resampler.output_dim)
    _close(got, ref, atol=1e-4, rtol=1e-4)


def test_uncond_context_with_the_zero_image_matches_jax(twin_models):
    """[empty text ; zero image at the LATENT size] (the reference's quirk);
    atol/rtol 1e-4."""
    jmodel, tmodel = twin_models
    ref = jconditioning.build_uncond_context(jmodel, image_hw=(12, 20))
    got = conditioning.build_uncond_context(tmodel, image_hw=(12, 20))
    assert got.shape == (1, 77 + TINY.resampler.num_queries, TINY.unet.context_dim)
    _close(got, ref, atol=1e-4, rtol=1e-4)
    txt = conditioning.build_uncond_context(tmodel, with_image=False)
    _close(conditioning.cat_text_image(txt, got[:, 77:]), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("factor", [0.0, 0.3, 0.5, 0.51, 0.99, 1.0])
def test_select_prompt_by_factor_matches_jax(factor):
    prompts = {0.5: "sky", 1.0: "ground", 0.25: "zenith"}
    assert conditioning.select_prompt_by_factor(prompts, factor) == \
        jconditioning.select_prompt_by_factor(prompts, factor)


# ---------------------------------------------------------------------------
# tiled VAE encode, ring-aware decode, resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [32, 2])
def test_tiled_vae_encode_matches_jax(twin_models, overlap):
    """4x4 tiles, each grown by ``overlap`` latents (32: every tile reads the
    whole small image; 2: edge and interior tiles differ), count-averaged;
    fp32 VAE, atol/rtol 1e-4."""
    jmodel, tmodel = twin_models
    img = smooth_pano(7, 48, 64)
    ref = jtiled.tiled_vae_encode(jmodel, jnp.asarray(img), overlap_latent=overlap)
    got = tiled_vae.tiled_vae_encode(tmodel, img, overlap_latent=overlap)
    assert got.shape == (1, 1, 24, 32, 4)
    _close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("w_tiles", [1, 2])
def test_ring_aware_decode_matches_jax(twin_models, rng, w_tiles):
    """Wrap halo w/16 on each side (per ring tile); fp32 VAE, atol/rtol 1e-4."""
    jmodel, tmodel = twin_models
    lat = rng.standard_normal((1, 2, 8, 32, 4)).astype(np.float32)
    ref = jtiled.ring_aware_decode(jmodel, jnp.asarray(lat), w_tiles=w_tiles)
    got = tiled_vae.ring_aware_decode(tmodel, _t(lat), w_tiles=w_tiles)
    assert got.shape == (1, 2, 16, 64, 3)
    _close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["nearest", "bicubic"])
@pytest.mark.parametrize("hw", [(24, 48), (5, 7), (16, 32)])
def test_resize_video_latent_matches_jax(rng, mode, hw):
    """Up, down and identity; nearest is exact, bicubic fp32 atol 1e-5; the
    default mode, bilinear, at the same sizes fp32 atol 1e-5."""
    lat = rng.standard_normal((1, 3, 8, 16, 4)).astype(np.float32)
    ref = jresize.resize_video_latent(jnp.asarray(lat), *hw, mode=mode)
    got = resize.resize_video_latent(_t(lat), *hw, mode=mode)
    assert got.shape == (1, 3, *hw, 4)
    _close(got, ref, atol=0 if mode == "nearest" else 1e-5, rtol=0 if mode == "nearest" else 1e-5)
    _close(resize.resize_video_latent(_t(lat), *hw), jresize.resize_video_latent(jnp.asarray(lat), *hw),
           atol=1e-5, rtol=1e-5)


def test_pad_frames_match_jax(rng):
    lat = rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32)
    _close(resize.pad_frames_front(_t(lat), 2), jresize.pad_frames_front(jnp.asarray(lat), 2), atol=0, rtol=0)
    _close(resize.pad_frames_end(_t(lat), 3), jresize.pad_frames_end(jnp.asarray(lat), 3), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# window grids (pure Python: exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(total_h=64, total_w=128, win_h=40, win_w=64, num_windows_h=2, num_windows_w=2, loop_step=16),
    dict(total_h=128, total_w=256, win_h=40, win_w=64, num_windows_h=4, num_windows_w=5, loop_step=12),
    dict(total_h=40, total_w=96, win_h=40, win_w=64, num_windows_h=1, num_windows_w=3, loop_step=8),
    dict(total_h=24, total_w=32, win_h=16, win_w=16, num_windows_h=2, num_windows_w=2, loop_step=4,
         vae_scale=2),
])
def test_planar_grid_matches_jax(kw):
    jg, tg = jwindows.PlanarGrid(**kw), windows.PlanarGrid(**kw)
    for prop in ("overlap_ratio_w", "overlap_ratio_h", "window_step_w", "window_step_h",
                 "offset_step_w", "offset_step_h"):
        assert getattr(tg, prop) == getattr(jg, prop), prop
    for step in range(kw["loop_step"] + 3):
        for offset in (0, 5):
            assert tg.step_origins(step, offset) == jg.step_origins(step, offset), (step, offset)


def test_planar_grid_refuses_what_jax_refuses():
    for kw in (dict(total_h=40, total_w=100, win_h=40, win_w=64, num_windows_h=1, num_windows_w=1),
               dict(total_h=40, total_w=640, win_h=40, win_w=64, num_windows_h=1, num_windows_w=2)):
        with pytest.raises(AssertionError):
            jwindows.PlanarGrid(**kw, loop_step=8)
        with pytest.raises(ValueError):
            windows.PlanarGrid(**kw, loop_step=8)


@pytest.mark.parametrize("total_f,frames,ov,lsf,dock", [
    (16, 16, 0.75, 8, True), (64, 16, 0.75, 8, True), (64, 16, 0.5, 8, True),
    (32, 16, 0.5, 4, False), (48, 16, 0.25, 8, True), (8, 4, 0.25, 2, True),
])
def test_frame_window_origins_match_jax(total_f, frames, ov, lsf, dock):
    for step in range(12):
        assert windows.frame_window_origins(step, total_f, frames, ov, lsf, dock) == \
            jwindows.frame_window_origins(step, total_f, frames, ov, lsf, dock), step


@pytest.mark.parametrize("origins,sizes,dims", [
    ([(0, 0, 0), (0, 0, 4), (0, 0, 8)], (2, 4, 8), (2, 4, 12)),  # tests/test_pipelines.py:63-70
    ([(0, 0, 0), (1, 2, 8), (0, 2, 10), (1, 0, 4)], (2, 4, 8), (2, 4, 12)),  # :215-227
    (np.random.default_rng(3).integers(-20, 20, (9, 3)).tolist(), (3, 4, 6), (4, 6, 10)),
])
def test_earlier_coverage_masks_match_jax(origins, sizes, dims):
    """The port's ``earlier_coverage_masks`` against the JAX one and the
    port's ``device_earlier_masks``: wrapping, overlapping, negative origins."""
    from dynamicscaler_tpu.pipelines.planar import earlier_coverage_masks as jmasks
    from dynamicscaler_tpu_torch.pipelines.planar import device_earlier_masks, earlier_coverage_masks

    got = earlier_coverage_masks(origins, sizes, dims, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (len(origins), *sizes, 1)
    np.testing.assert_array_equal(got.numpy(), jmasks(origins, sizes, dims))
    np.testing.assert_array_equal(got.numpy(), device_earlier_masks(origins, sizes, torch.zeros((1, *dims, 4))))


def test_i2v_integer_sampler_matches_jax(twin_models):
    """Integer grid, skip-time init from the tiled VAE encode, ring decode."""
    jmodel, tmodel = twin_models
    pano = smooth_pano(4, 32, 64)
    kw = dict(num_windows_w=2, num_windows_h=1, loop_step=2, height=32, width=32, frames=4,
              num_inference_steps=3, use_skip_time=True, skip_time_step_idx=1)
    key = jax.random.PRNGKey(7)
    jv, jd = ji2v.sample_shift_multi_windows_integer(jmodel, "a road", pano, key=key, **kw)
    tv, td = i2v.sample_shift_multi_windows_integer(tmodel, "a road", pano, noise_fn=jax_noise(key), **kw)
    close_fp32_chain(td, jd)
    close_fp32_chain(tv, jv)


# ---------------------------------------------------------------------------
# the bundle: device rule and full-width sizes
# ---------------------------------------------------------------------------


def test_init_random_builds_on_the_card_unless_asked_for_the_cpu():
    """No device given: the card. On a machine without one it raises, and
    never builds on the CPU quietly; a generator on another device than the
    weights is refused."""
    gen = torch.Generator().manual_seed(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LatentVideoDiffusion.init_random(TINY, gen)
    with pytest.raises(ValueError, match="generator"):
        LatentVideoDiffusion.init_random(TINY, gen, device="meta")
    model = LatentVideoDiffusion.init_random(TINY, gen, device="cpu")
    assert model.device.type == "cpu" and model.image_encoder is not None and model.resampler is not None
    assert all(p.device.type == "cpu" for _, m in model.components() for p in m.parameters())
    # the CLIP class token and the Resampler queries are drawn, not set to 1
    assert model.image_encoder.class_embedding.std() > 0 and model.resampler.latents.std() > 0


def test_full_width_i2v_parameter_counts_match_jax():
    """CLIP ViT-H/14 vision tower (no ln_post/proj) and the Resampler at
    their full widths, counted on the meta device against jax.eval_shape."""
    jcfg = jvideocrafter_i2v()
    model = LatentVideoDiffusion.build(videocrafter_i2v(), device="meta")
    for jmod, x, tmod in (
        (JCLIPVision(jcfg.clip_vision), jnp.zeros((1, 224, 224, 3)), model.image_encoder),
        (JResampler(jcfg.resampler), jnp.zeros((1, 257, 1280)), model.resampler),
    ):
        shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
        ref = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
        assert sum(p.numel() for p in tmod.parameters()) == ref
