"""``use_pre_denoise`` of the PyTorch port's t2v shift-window sampler
against the JAX package, on the CPU (tiny config, fp32): a single-window
clip, bicubic-upsampled to the panorama, re-noised as the initial latent and
re-anchored every step, with the same noise on both sides. Kept apart from
tests/test_torch_t2v.py so that the sampler twins spread over two test
workers.
"""

import jax
import numpy as np
import pytest

from dynamicscaler_tpu.pipelines import t2v as jt2v
from dynamicscaler_tpu_torch.pipelines import t2v
from torch_port_helpers import close_fp32_chain, t2v_twin_models


@pytest.fixture(scope="module")
def twin_models():
    return t2v_twin_models()


def t2v_jax_noise(key):
    """The port's noise_fn for a JAX t2v sampler call with ``key``: the JAX
    sampler splits (k_init, k_pre, k_run); the pre-denoise clip starts from
    k_pre and is re-noised with fold_in(k_pre, 1); step i re-noises with
    fold_in(k_run, i) and re-anchors with fold_in(fold_in(k_run, i), 7)."""
    k_init, k_pre, k_run = jax.random.split(key, 3)

    def fn(name, shape):
        kind, *idx = name.split(":")
        k = {"init": k_init, "pre_denoise_init": k_pre, "pre_denoise": jax.random.fold_in(k_pre, 1),
             "renoise": k_run, "pre": k_run}[kind]
        for i in idx:
            k = jax.random.fold_in(k, int(i))
        if kind == "pre":
            k = jax.random.fold_in(k, 7)
        return np.array(jax.random.normal(k, shape))

    return fn


@pytest.mark.parametrize("sparse", [True, False])
def test_pre_denoise_matches_jax(twin_models, sparse):
    """use_pre_denoise: a single-window clip, bicubic upsampled to the
    panorama, re-noised as the init, re-anchored every step (checkerboard or
    dense) - the same noise on both sides."""
    jmodel, tmodel = twin_models
    kw = dict(num_windows_w=2, height=32, width=32, frames=4, num_inference_steps=3, use_pre_denoise=True,
              merge_predenoise_ratio_list=[0.5, 0.7, 0.9], sparse_add_residual=sparse)
    key = jax.random.PRNGKey(11)
    jv, jd = jt2v.sample_shift_multi_windows(jmodel, "a red fox", key=key, **kw)
    tv, td = t2v.sample_shift_multi_windows(tmodel, "a red fox", noise_fn=t2v_jax_noise(key), **kw)
    assert td.shape == (1, 4, 16, 32, 4)
    close_fp32_chain(td, jd)
    close_fp32_chain(tv, jv)
