"""The PyTorch port's model stack against the JAX package, on the CPU.

Tiny-config UNet3D, CLIP text tower and AutoencoderKL: JAX parameters
(zero-initialised leaves perturbed, or the comparison is vacuous at those
outputs) -> ``from_jax_*`` -> the port's modules; the same numpy inputs
through both in fp32. Plus the converter round trip and the full-width
t2v parameter count.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.models.clip import CLIPTextEncoder as JCLIPText
from dynamicscaler_tpu.models.lvdm import tiny_test_config as jtiny
from dynamicscaler_tpu.models.unet3d import UNet3D as JUNet3D
from dynamicscaler_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from dynamicscaler_tpu.models.vae import DiagonalGaussianDistribution as JDiagonalGaussian
from dynamicscaler_tpu.utils import weights as jweights
from dynamicscaler_tpu_torch.config import tiny_test_config, videocrafter2_t2v
from dynamicscaler_tpu_torch.models.clip import CLIPTextEncoder
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.models.unet3d import UNet3D
from dynamicscaler_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussianDistribution
from dynamicscaler_tpu_torch.utils import weights
from torch_port_helpers import random_jax_params


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.mark.parametrize("variant", ["t2v", "i2v", "causal"])
def test_unet_tiny_matches_jax(variant):
    """t2v / i2v (dual text+image cross-attention) / causal temporal
    attention (the masked sites keep plain math)."""
    img = variant == "i2v"
    causal = variant == "causal"
    jcfg = dataclasses.replace(jtiny(img_attention=img).unet, use_causal_attention=causal)
    cfg = dataclasses.replace(tiny_test_config(img_attention=img).unet, use_causal_attention=causal)
    rng = np.random.default_rng(0)
    B, F, H, W = 2, 4, 8, 8
    L = 77 + (4 if img else 0)
    x = rng.standard_normal((B, F, H, W, 4)).astype(np.float32)
    ctx = rng.standard_normal((B, L, cfg.context_dim)).astype(np.float32)
    t = np.array([500, 20], np.int32)
    jm = JUNet3D(jcfg)
    params = random_jax_params(jm.init, jnp.zeros((1, 2, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, L, cfg.context_dim)), 16)
    ref = np.asarray(jax.jit(jm.apply, static_argnums=4)(params, jnp.asarray(x), jnp.asarray(t),
                                                         jnp.asarray(ctx), 16))

    tm = _load(UNet3D(cfg), weights.from_jax_unet(params, cfg))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 16)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)


def test_unet_per_frame_timesteps_match_jax():
    """[B, F] timesteps (per-frame denoising) ride the (B F) batch."""
    cfg = tiny_test_config(img_attention=False).unet
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 4, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, cfg.context_dim)).astype(np.float32)
    t = np.array([[999, 600, 300, 5]], np.int32)
    jm = JUNet3D(jtiny(img_attention=False).unet)
    params = random_jax_params(jm.init, jnp.asarray(x), jnp.asarray(t[0, :1]), jnp.asarray(ctx), 16,
                               seed=3)
    ref = np.asarray(jax.jit(jm.apply, static_argnums=4)(params, jnp.asarray(x), jnp.asarray(t),
                                                         jnp.asarray(ctx), 8))
    tm = _load(UNet3D(cfg), weights.from_jax_unet(params, cfg))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 8)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("img", [False, True])
def test_from_jax_unet_inverts_convert_unet(img):
    """convert_unet(port state_dict) -> from_jax_unet gives back the same
    names and values, exactly."""
    cfg = tiny_test_config(img_attention=img).unet
    torch.manual_seed(0)
    sd = {k: v.detach().clone() for k, v in UNet3D(cfg).state_dict().items()}
    tree = jweights.convert_unet({k: v.numpy() for k, v in sd.items()}, cfg)
    back = weights.from_jax_unet(tree, cfg)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_full_width_t2v_unet_parameter_count():
    model = LatentVideoDiffusion.build(videocrafter2_t2v(), device="meta")
    assert sum(p.numel() for p in model.unet.parameters()) == 1_413_284_420
    assert sum(p.numel() for p in model.text_encoder.parameters()) == 340_387_840
    assert sum(p.numel() for p in model.vae.parameters()) == 83_653_863


def test_clip_text_tiny_matches_jax():
    cfg = tiny_test_config(img_attention=False).clip_text
    jm = JCLIPText(jtiny(img_attention=False).clip_text)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 77)).astype(np.int32)
    params = random_jax_params(jm.init, jnp.asarray(tokens), seed=1)
    ref = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    tm = _load(CLIPTextEncoder(cfg), weights.from_jax_clip_text(params, cfg))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_vae_tiny_matches_jax():
    cfg = tiny_test_config(img_attention=False).vae
    jm = JAutoencoderKL(jtiny(img_attention=False).vae)
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    params = random_jax_params(jm.init, jnp.asarray(img), seed=2)
    z_ref = np.asarray(jm.apply(params, jnp.asarray(img), None, method=JAutoencoderKL.encode))
    x_ref = np.asarray(jm.apply(params, jnp.asarray(z_ref), method=JAutoencoderKL.decode))
    tm = _load(AutoencoderKL(cfg), weights.from_jax_vae(params, cfg))
    with torch.no_grad():
        z = tm.encode(torch.from_numpy(img))
        x = tm.decode(torch.from_numpy(z_ref.copy()))
    np.testing.assert_allclose(z.numpy(), z_ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-4, rtol=1e-4)
    # sampled encode with injected noise: mean + exp(logvar / 2) * noise
    noise = rng.standard_normal(z.shape).astype(np.float32)
    with torch.no_grad():
        zs = tm.encode(torch.from_numpy(img), noise=torch.from_numpy(noise))
        moments = tm.encode_moments(torch.from_numpy(img))
    mean, logvar = moments.chunk(2, dim=-1)
    expect = (mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * torch.from_numpy(noise)) * cfg.scale_factor
    np.testing.assert_allclose(zs.numpy(), expect.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("deterministic", [False, True])
def test_diagonal_gaussian_matches_jax(deterministic):
    rng = np.random.default_rng(4)
    params = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    other = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    sample = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    j = JDiagonalGaussian(jnp.asarray(params), deterministic)
    jo = JDiagonalGaussian(jnp.asarray(other))
    t = DiagonalGaussianDistribution(torch.from_numpy(params), deterministic)
    to = DiagonalGaussianDistribution(torch.from_numpy(other))
    for got, ref in ((t.mode(), j.mode()), (t.kl(), j.kl()), (t.kl(to), j.kl(jo)),
                     (t.nll(torch.from_numpy(sample)), j.nll(jnp.asarray(sample))),
                     (t.sample(noise=torch.from_numpy(sample)), j.mean + j.std * sample)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)
