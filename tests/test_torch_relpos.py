"""Temporal relative-position attention of the PyTorch port against the JAX
package, on the CPU.

The rel-pos ``CrossAttention`` sub-block (with and without the causal mask,
at frame counts inside and past the table's reach), a whole tiny rel-pos
UNet forward with its weights through ``from_jax_unet`` and through a tiny
VideoCrafter-named checkpoint read by ``load_videocrafter_checkpoint``, and
the dispatch gates: rel-pos sites stay off K1 and kernels 10 and 12 on
both sides, while the temporal wrapper head and tail (K5, K6) and the
feed-forward (K4) still run there. Inputs and weights come from a numpy
seed; the JAX weights' zero leaves are perturbed. The JAX side's kernels
run in the Pallas interpreter where its gates admit them (the route
counts), else through XLA (the forwards compared).

Tolerances: the sub-block differs from JAX only in the order of its fp32
sums, atol 1e-5, rtol 1e-4; the tiny UNet as tests/test_torch_unet.py,
atol 2e-4, rtol 1e-3.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.models import attention as jattention
from dynamicscaler_tpu.models.lvdm import tiny_test_config as jtiny
from dynamicscaler_tpu.models.unet3d import UNet3D as JUNet3D
from dynamicscaler_tpu.ops import fused_block as jblock
from dynamicscaler_tpu.ops import fused_mega as jmega
from dynamicscaler_tpu.ops import fused_temporal as jtemporal
from dynamicscaler_tpu.ops import fused_twrap as jtwrap
from dynamicscaler_tpu_torch.config import tiny_test_config
from dynamicscaler_tpu_torch.models.attention import SITE_TEMPORAL, CrossAttention
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion, init_module_random
from dynamicscaler_tpu_torch.models.unet3d import UNet3D
from dynamicscaler_tpu_torch.ops import fused_block, fused_mega, fused_temporal, fused_twrap
from dynamicscaler_tpu_torch.utils import weights
from torch_port_helpers import random_jax_params, tiny_unet_twins


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("frames,causal", [(4, False), (8, False), (8, True)])
def test_relpos_attention_matches_jax(frames, causal):
    """The LN -> attention with the k / v tables -> out-proj -> +x sub-block
    at a temporal length of 4 (8 frames reach past the table)."""
    C, heads, L = 32, 2, 4
    rng = np.random.default_rng(frames + causal)
    x = rng.standard_normal((3, frames, C)).astype(np.float32)
    ln_s = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    jm = jattention.CrossAttention(heads=heads, dim_head=C // heads, relative_position=True, temporal_length=L)
    mask = jnp.tril(jnp.ones((1, frames, frames), bool)) if causal else None
    params = random_jax_params(lambda k, *a: jm.init(k, *a, ln=(jnp.asarray(ln_s), jnp.asarray(ln_b))),
                               jnp.asarray(x), None, mask, seed=frames)
    p = params["params"]
    assert p["rel_pos_k"].shape == (2 * L + 1, C // heads)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), None, mask, ln=(jnp.asarray(ln_s), jnp.asarray(ln_b)),
                              add_residual=True))

    tm = CrossAttention(C, None, heads, C // heads, relative_position=True, temporal_length=L)
    sd = weights._Out()
    weights._attention(sd, "a", p)
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    ln = torch.nn.LayerNorm(C)
    ln.load_state_dict({"weight": _t(ln_s), "bias": _t(ln_b)})
    tmask = None if mask is None else torch.from_numpy(np.array(mask))[:, None]
    with torch.no_grad():
        got = tm(_t(x), ln, SITE_TEMPORAL, mask=tmask)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-4)


def _relpos_cfgs():
    jcfg = dataclasses.replace(jtiny(img_attention=False).unet, use_relative_position=True)
    cfg = dataclasses.replace(tiny_test_config(img_attention=False).unet, use_relative_position=True)
    return jcfg, cfg


@pytest.fixture(scope="module")
def relpos_unet():
    """The tiny t2v UNet with relative position: JAX params, the JAX
    forward (XLA) on seeded inputs, and the inputs."""
    jcfg, cfg = _relpos_cfgs()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, cfg.context_dim)).astype(np.float32)
    t = np.array([640, 30], np.int32)
    jm = JUNet3D(jcfg)
    params = random_jax_params(jm.init, jnp.zeros((1, 2, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                               jnp.zeros((1, 77, cfg.context_dim)), 16, seed=6)
    ref = np.asarray(jax.jit(jm.apply, static_argnums=4)(params, jnp.asarray(x), jnp.asarray(t),
                                                         jnp.asarray(ctx), 16))
    return params, cfg, (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 16), ref


def _forward(unet, args):
    with torch.no_grad():
        return unet.eval()(*args).numpy()


def test_relpos_unet_from_jax_matches_jax(relpos_unet):
    params, cfg, args, ref = relpos_unet
    sd = weights.from_jax_unet(params, cfg)
    tables = [k for k in sd if k.endswith("embeddings_table")]
    # attn1 and attn2 of each of the 7 temporal transformers and init_attn, k and v
    assert len(tables) == 8 * 2 * 2
    tm = UNet3D(cfg)
    tm.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(_forward(tm, args), ref, atol=2e-4, rtol=1e-3)


def test_relpos_unet_through_a_checkpoint_matches_jax(relpos_unet, tmp_path):
    """The tables travel through a VideoCrafter-named checkpoint
    (``model.diffusion_model.*.attn1.relative_position_k.embeddings_table``)
    and the port's loader."""
    params, cfg, args, ref = relpos_unet
    mcfg = dataclasses.replace(tiny_test_config(img_attention=False), unet=cfg)
    src = LatentVideoDiffusion.build(mcfg, "cpu")
    g = torch.Generator().manual_seed(0)
    for name, mod in src.components():
        if name != "unet":
            init_module_random(mod, g)
    src.unet.load_state_dict(weights.from_jax_unet(params, cfg))
    sd = {weights.COMPONENT_PREFIXES[n] + k: v for n, m in src.components() for k, v in m.state_dict().items()}
    assert "model.diffusion_model.init_attn.0.transformer_blocks.0.attn2.relative_position_v.embeddings_table" in sd
    path = tmp_path / "relpos.ckpt"
    torch.save({"state_dict": sd}, path)
    loaded = LatentVideoDiffusion.build(mcfg, "cpu").load_state_dicts(
        **weights.load_videocrafter_checkpoint(str(path), mcfg))
    np.testing.assert_allclose(_forward(loaded.unet, args), ref, atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# the gates: which kernels a rel-pos forward reaches
# ---------------------------------------------------------------------------

PORT_ROUTES = ((fused_block, "temporal_block_plain", "K10"), (fused_mega, "temporal_mega_plain", "K12"),
               (fused_temporal, "fused_ln_attention", "K1"), (fused_temporal, "fused_ln_geglu", "K4"),
               (fused_twrap, "gn_proj_in_temporal", "K5"), (fused_twrap, "tail_temporal", "K6"))
JAX_ROUTES = ((jblock, "fused_temporal_block", "K10"), (jmega, "temporal_transformer", "K12"),
              (jtemporal, "fused_ln_attention", "K1"), (jtemporal, "fused_ln_geglu", "K4"),
              (jtwrap, "gn_proj_in_temporal", "K5"), (jtwrap, "tail_temporal", "K6"))


def _counting(monkeypatch, routes, calls, frames):
    """Count each route's calls; K1 and K4 only at temporal sites (x
    [rows, frames, C]): the JAX package picks K1 by shape, so it also
    takes spatial self-attention of 64 tokens, and the spatial
    feed-forwards are left out."""
    for mod, name, k in routes:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _k=k, **kw):
            if _k not in ("K1", "K4") or a[0].shape[-2] == frames:
                calls[_k] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)


@pytest.fixture
def plans_off():
    """Both packages' plans at "off" (the highest legal level at every
    shape) with the JAX kernels in the Pallas interpreter."""
    jtemporal.set_mode("interpret")
    jtemporal.set_plan("off")
    fused_temporal.set_plan("off")
    yield
    fused_temporal.set_plan()
    jtemporal.set_plan("auto")
    jtemporal.set_mode("auto")


@pytest.mark.parametrize("relpos", [False, True])
def test_relpos_gates_match_jax(plans_off, monkeypatch, relpos):
    """On the tiny UNet with a context width the whole-block gates admit,
    under "off": without relative position both packages run kernel 12 at
    the 7 temporal transformers and kernel 10 inside init_attn's head and
    tail (inner 128 on 32 channels keeps it off kernel 12); with it
    neither runs K1, kernel 10 or kernel 12, and both run the wrapper head
    and tail (K5, K6) at all 8 temporal transformers. The port's K4 runs
    at all 8 temporal feed-forwards, the JAX one where its width gate
    admits it (init_attn's 128). JAX routes are counted while tracing its
    forward (``jax.eval_shape``); the port's forward is held against the
    JAX forward (XLA)."""
    jm, params, tm, cfg = tiny_unet_twins(False)
    if relpos:
        cfg = dataclasses.replace(cfg, use_relative_position=True)
        jm = JUNet3D(dataclasses.replace(jm.cfg, use_relative_position=True))
        params = random_jax_params(jm.init, jnp.zeros((1, 2, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                                   jnp.zeros((1, 77, cfg.context_dim)), 16, seed=4)
        tm = UNet3D(cfg)
        tm.load_state_dict(weights.from_jax_unet(params, cfg))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 4, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, cfg.context_dim)).astype(np.float32)
    t = np.array([321], np.int32)
    jax_calls, port_calls = collections.Counter(), collections.Counter()
    _counting(monkeypatch, JAX_ROUTES, jax_calls, 4)
    _counting(monkeypatch, PORT_ROUTES, port_calls, 4)
    jax.eval_shape(lambda p, *a: jm.apply(p, *a, 16), params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    got = _forward(tm, (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 16))
    if relpos:
        assert jax_calls == {"K5": 8, "K6": 8, "K4": 1}
        assert port_calls == {"K5": 8, "K6": 8, "K4": 8}
    else:
        assert jax_calls == port_calls == {"K12": 7, "K10": 1, "K5": 1, "K6": 1}
    jtemporal.set_mode("auto")
    ref = np.asarray(jax.jit(jm.apply, static_argnums=4)(params, jnp.asarray(x), jnp.asarray(t),
                                                         jnp.asarray(ctx), 16))
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_relpos_refuses_freetraj():
    """FreeTraj's re-weighting and relative position do not combine (the
    JAX package asserts the same)."""
    a = CrossAttention(32, None, 2, 16, relative_position=True, temporal_length=4)
    with pytest.raises(ValueError, match="relative position"):
        a(torch.zeros(1, 4, 32), torch.nn.LayerNorm(32), SITE_TEMPORAL, traj={"active": torch.ones(1, dtype=bool)})
