"""The PyTorch port's legacy DDIM helpers and the UNet's
``no_temporal_attn`` against the JAX package, on the CPU.

* ``ddim_scale_tables``, ``ddim_step_scaled`` (``use_scale`` on and off,
  per-frame index vectors, eta > 0 with the JAX draw handed in as
  ``noise_fn``), ``cfg_combine`` (every ``uc_type``, and the refusal of an
  unknown one), ``temporal_guidance_combine``, ``stochastic_encode``
  (DDIM and DDPM steps, scalar and per-batch t) and ``q_sample`` against
  the JAX functions on the same numpy inputs, within rtol 1e-5, atol 1e-6.
* The tiny UNet with ``no_temporal_attn`` against the JAX UNet's, and
  different from its full forward (the counterpart of
  ``tests/test_legacy_ddim.py:165``, which needs the reference tree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamicscaler_tpu.ops import ddim as jddim
from dynamicscaler_tpu_torch.config import tiny_test_config
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.ops import ddim
from torch_port_helpers import tiny_unet_twins

S = 8
SHAPE = (2, 4, 3, 5, 6)  # [B, F, H, W, C]


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def _schedules(use_scale, eta=0.0):
    kw = dict(eta=eta, use_scale=use_scale)
    return ddim.make_ddim_schedule(S, **kw), jddim.make_ddim_schedule(S, **kw)


def _randn(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("use_scale", [False, True])
def test_scale_tables_match_jax(use_scale):
    ours, ref = _schedules(use_scale)
    for got, want in zip(ddim.ddim_scale_tables(ours), jddim.ddim_scale_tables(ref)):
        _close(got, want)
    assert bool((ddim.ddim_scale_tables(ours)[0] != 1).any()) == use_scale


@pytest.mark.parametrize("use_scale", [False, True])
@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_ddim_step_scaled_matches_jax(use_scale, eta):
    ours, ref = _schedules(use_scale, eta)
    x, eps = _randn(0), _randn(1)
    indices = np.array([7, 5, 3, 0])  # a per-frame index vector
    key = jax.random.PRNGKey(3)
    draws = []

    def noise_fn(name, shape):
        draws.append(name)
        return np.array(jax.random.normal(key, shape))

    got = ddim.ddim_step_scaled(ours, torch.from_numpy(x), torch.from_numpy(eps), indices, noise_fn=noise_fn)
    want = jddim.ddim_step_scaled(ref, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(indices), key=key)
    for g, w in zip(got, want):
        _close(g, w)
    assert draws == (["step"] if eta > 0 else [])
    if not use_scale:  # the plain step
        for g, w in zip(got, ddim.ddim_step(ours, torch.from_numpy(x), torch.from_numpy(eps), indices,
                                            noise=np.array(jax.random.normal(key, SHAPE)))):
            _close(g, w)


@pytest.mark.parametrize("uc_type", [None, "cfg_original", "cfg_ours"])
def test_cfg_combine_matches_jax(uc_type):
    c, u = _randn(2), _randn(3)
    got = ddim.cfg_combine(torch.from_numpy(c), torch.from_numpy(u), 7.5, uc_type)
    _close(got, jddim.cfg_combine(jnp.asarray(c), jnp.asarray(u), 7.5, uc_type))


def test_cfg_combine_refuses_unknown_uc_type():
    x = torch.zeros(2)
    with pytest.raises(NotImplementedError, match="cfg_bogus"):
        ddim.cfg_combine(x, x, 7.5, "cfg_bogus")
    with pytest.raises(NotImplementedError, match="cfg_bogus"):
        jddim.cfg_combine(jnp.zeros(2), jnp.zeros(2), 7.5, "cfg_bogus")


def test_temporal_guidance_combine_matches_jax():
    e, et, en = _randn(4), _randn(5), _randn(6)
    got = ddim.temporal_guidance_combine(*map(torch.from_numpy, (e, et, en)), 0.5)
    _close(got, jddim.temporal_guidance_combine(*map(jnp.asarray, (e, et, en)), 0.5))


@pytest.mark.parametrize("use_original_steps,t", [(False, 5), (False, [2, 6]), (True, 600), (True, [10, 990])])
def test_stochastic_encode_matches_jax(use_original_steps, t):
    ours, ref = _schedules(False)
    x0, noise = _randn(7), _randn(8)
    got = ddim.stochastic_encode(ours, torch.from_numpy(x0), t, noise=noise, use_original_steps=use_original_steps)
    want = jddim.stochastic_encode(ref, jnp.asarray(x0), jnp.asarray(t), noise=jnp.asarray(noise),
                                   use_original_steps=use_original_steps)
    _close(got, want)
    # the draw "encode" in place of the JAX key's
    key = jax.random.PRNGKey(9)
    got = ddim.stochastic_encode(ours, torch.from_numpy(x0), t, use_original_steps=use_original_steps,
                                 noise_fn=lambda name, shape: np.array(jax.random.normal(key, shape)))
    _close(got, jddim.stochastic_encode(ref, jnp.asarray(x0), jnp.asarray(t), key=key,
                                        use_original_steps=use_original_steps))


@pytest.mark.parametrize("use_scale", [False, True])
def test_q_sample_matches_jax(use_scale):
    ours, ref = _schedules(use_scale)
    x0, noise = _randn(10), _randn(11)
    for t in (0, 250, 999):
        _close(ddim.q_sample(ours, torch.from_numpy(x0), t, noise=noise),
               jddim.q_sample(ref, jnp.asarray(x0), t, noise=jnp.asarray(noise)))
    key = jax.random.PRNGKey(12)
    got = ddim.q_sample(ours, torch.from_numpy(x0), 400,
                        noise_fn=lambda name, shape: np.array(jax.random.normal(key, shape)))
    _close(got, jddim.q_sample(ref, jnp.asarray(x0), 400, key=key))


def test_unet_no_temporal_attn_matches_jax():
    """The flag skips every temporal transformer and init_attn: the tiny
    UNet's forward with it equals the JAX UNet's and differs from the full
    forward."""
    jm, params, tm, cfg = tiny_unet_twins(False)
    assert cfg.addition_attention and cfg.temporal_attention
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 4, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, cfg.context_dim)).astype(np.float32)
    t = np.array([500, 20], np.int32)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), 16, True))
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 16)
    with torch.no_grad():
        got = tm(*args, no_temporal_attn=True)
        full = tm(*args)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)
    assert float((full - got).abs().max()) > 1e-3


def test_apply_unet_passes_no_temporal_attn():
    """``LatentVideoDiffusion.apply_unet(..., no_temporal_attn=True)``
    reaches the UNet: no temporal transformer runs."""
    model = LatentVideoDiffusion.init_random(tiny_test_config(False), torch.Generator().manual_seed(0),
                                             device="cpu")
    calls = []
    for m in model.unet.modules():
        if type(m).__name__ == "TemporalTransformer":
            m.register_forward_hook(lambda *a: calls.append(1))
    x, ctx = torch.zeros((1, 4, 8, 8, 4)), torch.zeros((1, 77, 32))
    model.apply_unet(x, torch.full((1,), 10), ctx, 8, no_temporal_attn=True)
    assert not calls
    model.apply_unet(x, torch.full((1,), 10), ctx, 8)
    assert len(calls) == 1 + sum(s.kind == "temporal" for specs in (*model.unet._in_specs, model.unet._mid_specs,
                                                                     *model.unet._out_specs) for s in specs)
