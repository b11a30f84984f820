"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamicscaler_tpu.models.clip import CLIPTextEncoder as JCLIPText
from dynamicscaler_tpu.models.clip import CLIPVisionEncoder as JCLIPVision
from dynamicscaler_tpu.models.lvdm import LatentVideoDiffusion as JLVDM
from dynamicscaler_tpu.models.lvdm import tiny_test_config as jtiny
from dynamicscaler_tpu.models.resampler import Resampler as JResampler
from dynamicscaler_tpu.models.unet3d import UNet3D as JUNet3D
from dynamicscaler_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from dynamicscaler_tpu_torch.config import tiny_test_config
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.utils import weights
from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer

# One torch intra-op thread per test process. The suite runs several pytest
# workers on a few cores; torch's OpenMP pool of a thread per core in every
# worker oversubscribes them, and its spin-waits made the port's twin tests
# about 10x slower than with one thread (six twin files: 860 s against 75 s
# on an 8-core host). Workers import every test module at collection, so
# this holds for the whole run.
torch.set_num_threads(1)


def random_jax_params(init_fn, *args, seed=0, scale=0.02):
    """A JAX parameter tree of numpy arrays with the shapes ``init_fn``
    declares (``jax.eval_shape``: traced, not compiled), filled as the flax
    initialisers would (kernels N(0, 1/fan_in), norm scales 1, biases 0,
    embeddings N(0, 0.02)); then every all-zero leaf gets N(0, scale)
    values, since zero-initialised layers make a comparison vacuous."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)

    def fill(path, s):
        name = str(path[-1].key)
        if name == "scale":
            a = np.ones(s.shape, np.float32)
        elif name == "bias":
            a = np.zeros(s.shape, np.float32)
        elif name == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            a = 0.02 * rng.standard_normal(s.shape)
        a = np.asarray(a, np.float32)
        if not a.any():
            a = scale * rng.standard_normal(s.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def i2v_jax_params(jcfg, seed=20):
    """Random JAX parameter trees of the tiny i2v bundle (zero leaves perturbed)."""
    cv, rs = jcfg.clip_vision, jcfg.resampler
    L = jcfg.unet.text_context_len + rs.num_queries
    return {
        "unet": random_jax_params(JUNet3D(jcfg.unet).init, jnp.zeros((1, 2, 8, 8, 4)),
                                  jnp.zeros((1,), jnp.int32), jnp.zeros((1, L, 32)), 16, seed=seed),
        "vae": random_jax_params(JAutoencoderKL(jcfg.vae).init, jnp.zeros((1, 32, 32, 3)), seed=seed + 1),
        "clip_text": random_jax_params(JCLIPText(jcfg.clip_text).init, jnp.zeros((1, 77), jnp.int32),
                                       seed=seed + 2),
        "clip_vision": random_jax_params(JCLIPVision(cv).init,
                                         jnp.zeros((1, cv.image_size, cv.image_size, 3)), seed=seed + 3),
        "resampler": random_jax_params(JResampler(rs).init, jnp.zeros((1, cv.output_tokens, rs.embedding_dim)),
                                       seed=seed + 4),
    }


def port_from_jax(params, cfg, tokenizer):
    """The port's bundle on the CPU, loaded from JAX parameter trees."""
    return LatentVideoDiffusion.build(cfg, "cpu", tokenizer=tokenizer).load_state_dicts(
        unet=weights.from_jax_unet(params["unet"], cfg.unet),
        vae=weights.from_jax_vae(params["vae"], cfg.vae),
        clip_text=weights.from_jax_clip_text(params["clip_text"], cfg.clip_text),
        clip_vision=weights.from_jax_clip_vision(params["clip_vision"], cfg.clip_vision),
        resampler=weights.from_jax_resampler(params["resampler"], cfg.resampler),
    )


def t2v_twin_models(seed=5):
    """The tiny t2v bundle twice: the JAX one with random parameters and the
    port's loaded from the same numbers, sharing one tokenizer."""
    jcfg = jtiny(img_attention=False)
    params = {
        "unet": random_jax_params(JUNet3D(jcfg.unet).init, jnp.zeros((1, 2, 8, 8, 4)),
                                  jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 32)), 16, seed=seed),
        "vae": random_jax_params(JAutoencoderKL(jcfg.vae).init, jnp.zeros((1, 32, 32, 3)), seed=seed + 1),
        "clip_text": random_jax_params(JCLIPText(jcfg.clip_text).init, jnp.zeros((1, 77), jnp.int32),
                                       seed=seed + 2),
    }
    tok = HashTokenizer(512)
    cfg = tiny_test_config(img_attention=False)
    tmodel = LatentVideoDiffusion.build(cfg, "cpu", tokenizer=tok).load_state_dicts(
        unet=weights.from_jax_unet(params["unet"], cfg.unet),
        vae=weights.from_jax_vae(params["vae"], cfg.vae),
        clip_text=weights.from_jax_clip_text(params["clip_text"], cfg.clip_text),
    )
    return JLVDM(config=jcfg, params=params, tokenizer=tok), tmodel


def i2v_twin_models(seed=20):
    """The tiny i2v bundle twice: the JAX one with random parameters and the
    port's loaded from the same numbers, sharing one tokenizer (the ids are
    then the same input to both)."""
    jcfg = jtiny(img_attention=True)
    params = i2v_jax_params(jcfg, seed)
    tok = HashTokenizer(512)
    return JLVDM(config=jcfg, params=params, tokenizer=tok), port_from_jax(params, tiny_test_config(True), tok)


def jax_noise(key):
    """The port's noise_fn for a JAX sampler call with ``key``: each named
    draw is the JAX sampler's own draw (pipelines/i2v.py and
    pipelines/sphere.py split (k_init, k_run, k_noise); the planar engine
    folds the step, then the window). The sphere sampler's step key is
    k_run folded with the step; it draws the window batch's re-noise from
    the step key (``renoise:{step}``), the static panorama's from the step
    key folded with 1 (``static:{step}``) and, in ``sequential`` mode, pair
    k's from the step key folded with k + 2 (``pair:{step}:{k}``)."""
    k_init, k_run, k_noise = jax.random.split(key, 3)
    extra_fold = {"static": lambda idx: [*idx, 1], "pair": lambda idx: [idx[0], idx[1] + 2]}

    def fn(name, shape):
        kind, *idx = name.split(":")
        idx = [int(i) for i in idx]
        k = {"init": k_init, "skip": k_noise, "renoise": k_run, "static": k_run, "pair": k_run}[kind]
        for i in extra_fold.get(kind, lambda idx: idx)(idx):
            k = jax.random.fold_in(k, i)
        return np.array(jax.random.normal(k, shape))

    return fn


def close_fp32_chain(got, ref):
    """Tolerance of a whole sampler run in fp32 (several UNet forwards with
    CFG 7.5, the re-noise blends and the VAE): the twins differ only in the
    order of their sums, but pred_x0 reaches |x| ~ 80 at random weights, so
    the absolute tolerance scales with the output (2e-5 of its max, ~100
    fp32 ulps) on top of 2e-4; rtol 1e-3."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=2e-4 + 2e-5 * float(np.abs(ref).max()))


def smooth_pano(seed, h, w):
    """A smooth seeded panorama image in [-1, 1], [h, w, 3]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 2 * np.pi, w, endpoint=False), indexing="ij")
    img = np.stack([np.sin(xx * k + p) * np.cos(yy * 3 + p) for k, p in zip((1, 2, 3), rng.uniform(0, 6, 3))], -1)
    return (0.8 * img + 0.05 * rng.standard_normal(img.shape)).clip(-1, 1).astype(np.float32)


def tiny_unet_twins(img_attention, *, context_dim=128, seed=4):
    """The tiny UNet with a context width the whole-block and
    whole-transformer gates admit (a multiple of 128), twice: the JAX module
    with random parameters and the port's loaded from the same numbers.
    Returns (JAX module, JAX params, port UNet3D, port UNetConfig)."""
    import dataclasses

    from dynamicscaler_tpu_torch.models.unet3d import UNet3D

    jcfg = dataclasses.replace(jtiny(img_attention=img_attention).unet, context_dim=context_dim)
    cfg = dataclasses.replace(tiny_test_config(img_attention=img_attention).unet, context_dim=context_dim)
    L = cfg.text_context_len + (4 if img_attention else 0)
    jm = JUNet3D(jcfg)
    params = random_jax_params(jm.init, jnp.zeros((1, 2, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, L, context_dim)), 16, seed=seed)
    tm = UNet3D(cfg)
    tm.load_state_dict(weights.from_jax_unet(params, cfg))
    return jm, params, tm, cfg


def i2v_transformers():
    """(side, C, inner, heads, H, W) of every transformer of the full-width
    i2v UNet at the 40x64 latent, with init_attn (inner 512 on C 320)."""
    from dynamicscaler_tpu_torch.config import videocrafter_i2v
    from dynamicscaler_tpu_torch.models.unet3d import unet_layout

    cfg = videocrafter_i2v().unet
    ins, outs, mid, _ = unet_layout(cfg)
    sizes = {320: (40, 64), 640: (20, 32), 1280: (10, 16)}
    out = [("t", 320, 512, 8, 40, 64)]
    for spec in [s for blk in ins + outs for s in blk] + mid:
        if spec.kind in ("spatial", "temporal"):
            H, W = sizes[spec.channels] if spec.name != "mid_spatial" and spec.name != "mid_temporal" else (5, 8)
            out.append((spec.kind[0], spec.channels, spec.channels, spec.channels // 64, H, W))
    return out
