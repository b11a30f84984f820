"""The PyTorch port's i2v samplers against the JAX package, on the CPU.

The tiny i2v config (``tiny_test_config(img_attention=True)``): JAX
parameters from ``random_jax_params`` (zero leaves perturbed) -> the port's
modules via ``from_jax_*``. Both twins get the same numpy panorama and the
same noise: the port's ``noise_fn`` reproduces, draw by draw, the
``jax.random`` keys the JAX sampler splits from its key. Covered: the
fractional-overlap planar sampler (stages 2 and 3 of gen_pano_360) in all
three overlap modes, from the skip-time tiled-VAE init and from a given
latent, with frame windows and docking, with multi-prompt conditioning;
single-window ``basic_sample``. The integer-grid sampler's test is in
tests/test_torch_i2v_parts.py (it shares that file's twin bundle).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.pipelines import i2v as ji2v
from dynamicscaler_tpu_torch.pipelines import i2v
from torch_port_helpers import close_fp32_chain, i2v_twin_models, jax_noise, smooth_pano


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def twin_models():
    return i2v_twin_models()


# stage-2 geometry scaled to the tiny model (VAE scale 2, 16x16 latent windows):
# 2x2 windows over a 24x32 latent, overlap 0.5 in h and 0 in w, as the CLI's
# 512x1024 panorama over 320x512 windows has 0.4 and 0
GEOM = dict(total_w=64, total_h=48, num_windows_w=2, num_windows_h=2, loop_step=4,
            height=32, width=32, frames=4, fps=8, num_inference_steps=4)


@pytest.mark.parametrize("mode", ["last", "average", "sequential"])
def test_i2v_sampler_matches_jax_from_skip_time_init(twin_models, mode):
    """The CLI's stage-2 call: skip-time init from the tiled VAE encode of
    the image, default re-noise ratio 1.0, ring-aware decode."""
    jmodel, tmodel = twin_models
    pano = smooth_pano(1, 48, 64)
    kw = dict(GEOM, total_f=4, use_skip_time=True, skip_time_step_idx=2, overlap_mode=mode)
    key = jax.random.PRNGKey(3)
    jv, jd = ji2v.sample_shift_multi_windows(jmodel, "a lake", pano, key=key, **kw)
    tv, td = i2v.sample_shift_multi_windows(tmodel, "a lake", pano, noise_fn=jax_noise(key), **kw)
    assert tv.shape == (1, 4, 48, 64, 3) and td.shape == (1, 4, 24, 32, 4)
    close_fp32_chain(td, jd)
    close_fp32_chain(tv, jv)


def test_i2v_sampler_matches_jax_with_frame_windows_and_prompts(twin_models):
    """Given latent, 8 frames in docked frame windows (3 per step), one
    window row, a phase offset, multi-prompt conditioning by window height,
    merge-prev ratios."""
    jmodel, tmodel = twin_models
    pano = smooth_pano(2, 32, 64)
    init = np.random.default_rng(4).standard_normal((1, 8, 16, 32, 4)).astype(np.float32)
    kw = dict(GEOM, total_h=32, num_windows_h=1, num_inference_steps=3, total_f=8, dock_at_f=True,
              loop_step_frame=2, begin_index_offset=1, window_multi_prompt_dict={0.5: "sky", 1.0: "ground"},
              merge_prev_denoised_ratio_list=[0.3, 0.2, 0.0], decode=False)
    key = jax.random.PRNGKey(5)
    _, jd = ji2v.sample_shift_multi_windows(jmodel, "x", pano, key=key, init_panorama_latent=jnp.asarray(init),
                                            **kw)
    _, td = i2v.sample_shift_multi_windows(tmodel, "x", pano, noise_fn=jax_noise(key),
                                           init_panorama_latent=_t(init), **kw)
    close_fp32_chain(td, jd)


def test_i2v_sampler_progressive_skip_matches_jax(twin_models):
    jmodel, tmodel = twin_models
    pano = smooth_pano(3, 48, 64)
    kw = dict(GEOM, total_f=4, use_skip_time=True, skip_time_step_idx=2, progressive_skip=True,
              decode=False)
    key = jax.random.PRNGKey(6)
    _, jd = ji2v.sample_shift_multi_windows(jmodel, "a lake", pano, key=key, **kw)
    _, td = i2v.sample_shift_multi_windows(tmodel, "a lake", pano, noise_fn=jax_noise(key), **kw)
    close_fp32_chain(td, jd)


def test_i2v_basic_sample_matches_jax(twin_models):
    jmodel, tmodel = twin_models
    cond = smooth_pano(5, 32, 32)
    init = np.random.default_rng(8).standard_normal((1, 4, 16, 16, 4)).astype(np.float32)
    kw = dict(height=32, width=32, frames=4, num_inference_steps=3)
    jv, jd = ji2v.basic_sample(jmodel, "a bird", cond, latents=jnp.asarray(init), **kw)
    tv, td = i2v.basic_sample(tmodel, "a bird", cond, latents=_t(init), **kw)
    close_fp32_chain(td, jd)
    close_fp32_chain(tv, jv)
