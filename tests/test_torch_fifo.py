"""The PyTorch port's LCM scheduler (``ops/lcm.py``) and FIFO streaming
sampler (``pipelines/fifo.py``) against the JAX package, on the CPU.

* ``ops/lcm.py``: the twins of tests/test_lcm.py's cases (the schedule
  tables, the boundary scalings, the per-frame ``lcm_step`` in its three
  parameterisations with a negative previous timestep, ``lcm_add_noise``,
  ``fifo_timestep_vectors``, the zero-terminal-SNR rescale) on the same
  numpy inputs, fp32, each element within 1e-6 of max|JAX|.
* ``fifo_sample`` under ``ddim`` and ``lcm`` on the tiny t2v twin bundle,
  the port handed the JAX sampler's key chain through ``noise_fn``: the
  output frames and the decoded stream within ``close_fp32_chain``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicscaler_tpu.ops import lcm as jlcm
from dynamicscaler_tpu.pipelines import fifo as jfifo
from dynamicscaler_tpu_torch.ops import lcm
from dynamicscaler_tpu_torch.pipelines import fifo
from torch_port_helpers import close_fp32_chain, t2v_twin_models

TOL = 1e-6  # fp32: of max|JAX| (the twins round the same expressions in other orders)


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("steps,zero_snr,alpha_one", [(4, False, True), (1, False, True), (8, True, False),
                                                      (50, False, True)])
def test_lcm_schedule_matches_jax(steps, zero_snr, alpha_one):
    kw = dict(rescale_betas_zero_snr_flag=zero_snr, set_alpha_to_one=alpha_one)
    s, j = lcm.make_lcm_schedule(steps, **kw), jlcm.make_lcm_schedule(steps, **kw)
    assert s.alphas_cumprod.dtype == torch.float32 and s.num_inference_steps == j.num_inference_steps
    np.testing.assert_array_equal(s.timesteps.numpy(), np.asarray(j.timesteps))
    _close(s.alphas_cumprod, j.alphas_cumprod)
    _close(s.final_alpha_cumprod, j.final_alpha_cumprod)
    t, prev = lcm.fifo_timestep_vectors(s)
    jt, jprev = jlcm.fifo_timestep_vectors(j)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(prev.numpy(), np.asarray(jprev))
    assert int(prev[0]) == int(t[0])  # the front slot keeps its own timestep


def test_boundary_scalings_and_zero_snr_match_jax():
    t = np.array([0.0, 1.0, 19.0, 279.0, 999.0], np.float32)
    for got, ref in zip(lcm.boundary_scalings(torch.from_numpy(t)), jlcm.boundary_scalings(jnp.asarray(t))):
        _close(got, ref)
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2
    np.testing.assert_allclose(lcm.rescale_zero_terminal_snr(betas), jlcm.rescale_zero_terminal_snr(betas),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("prediction", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("steps", [4, 1])
def test_lcm_step_per_frame_matches_jax(prediction, steps):
    """Per-frame timesteps, the front slot's previous timestep its own and
    one slot's negative (final_alpha_cumprod); one step adds no noise."""
    rng = np.random.default_rng(3)
    x, eps, noise = (rng.standard_normal((1, 4, 3, 5, 2)).astype(np.float32) for _ in range(3))
    ts = np.array([279, 519, 759, 999])
    prev = np.array([279, 279, -1, 759])
    s = lcm.make_lcm_schedule(steps, prediction_type=prediction)
    j = jlcm.make_lcm_schedule(steps, prediction_type=prediction)
    got = lcm.lcm_step(s, torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(ts), torch.from_numpy(prev),
                       noise=torch.from_numpy(noise))
    ref = jlcm.lcm_step(j, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(ts), jnp.asarray(prev),
                        noise=jnp.asarray(noise))
    for g, r in zip(got, ref):
        _close(g, r)
    if steps == 1:
        assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("timesteps", [np.array([100, 900, 5]), np.array(640)])
def test_lcm_add_noise_matches_jax(timesteps):
    rng = np.random.default_rng(4)
    x, n = (rng.standard_normal((1, 3, 2, 4, 2)).astype(np.float32) for _ in range(2))
    s, j = lcm.make_lcm_schedule(4), jlcm.make_lcm_schedule(4)
    got = lcm.lcm_add_noise(s, torch.from_numpy(x), torch.from_numpy(timesteps), noise=torch.from_numpy(n))
    _close(got, jlcm.lcm_add_noise(j, jnp.asarray(x), jnp.asarray(timesteps), noise=jnp.asarray(n)))


def fifo_jax_noise(key, scheduler):
    """The port's noise_fn for a JAX ``fifo_sample`` call with ``key``: the
    JAX sampler splits (k_init, k_run), draws the base latent from k_init
    and the stagger from fold_in(k_init, 1); iteration i splits the run key
    into (key, k_noise) under ddim, (key, k_step, k_noise) under lcm."""
    k_init, k_run = jax.random.split(key)
    n_split = 3 if scheduler == "lcm" else 2

    def fn(name, shape):
        kind, *idx = name.split(":")
        if kind == "init":
            k = k_init
        elif kind == "stagger":
            k = jax.random.fold_in(k_init, 1)
        else:
            k = k_run
            for _ in range(int(idx[0]) + 1):
                k, *subs = jax.random.split(k, n_split)
            k = subs[0] if kind == "step" else subs[-1]
        return np.array(jax.random.normal(k, shape))

    return fn


@pytest.fixture(scope="module")
def twin_models():
    return t2v_twin_models(seed=9)


@pytest.mark.parametrize("scheduler", ["ddim", "lcm"])
def test_fifo_sample_matches_jax(twin_models, scheduler):
    """Five output frames from a queue of four, CFG 7.5: every frame one
    batch-2 forward at the queue's per-frame timesteps, then the step and
    the shift; the JAX key chain handed to the port."""
    jmodel, tmodel = twin_models
    key = jax.random.PRNGKey(21)
    kw = dict(num_output_frames=5, height=32, width=32, frames=4, fps=8, guidance_scale=7.5, scheduler=scheduler)
    jv, jf = jfifo.fifo_sample(jmodel, "a river at night", key=key, **kw)
    tv, tf = fifo.fifo_sample(tmodel, "a river at night", noise_fn=fifo_jax_noise(key, scheduler), **kw)
    assert tf.shape == (1, 5, 16, 16, 4) and tv.shape == (1, 5, 32, 32, 3)
    assert bool(torch.isfinite(tf).all())
    close_fp32_chain(tf, jf)
    close_fp32_chain(tv, jv)
