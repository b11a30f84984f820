"""The PyTorch port's FreeTraj trajectory control against the JAX package,
on the CPU, fp32.

* ``ops/freetraj.py``: ``plan_path`` exact; ``box_grid`` and ``fg_map``
  exact, ``gaussian_weight``, ``pair_mul`` and ``cross_weight_map`` within
  1e-6, at several level shapes and paths; ``fg_token_mask``,
  ``make_freetraj`` and ``gate_active`` exact.
* ``CrossAttention._traj_attention`` through the whole sub-block (LN ->
  q/k/v -> re-weighted attention -> out-proj -> + x) for temporal and
  spatial self-attention and for cross-attention (text only, and with the
  image keys), with some rows active and some not: within 2e-5 of
  max|JAX|.
* The tiny UNet3D forward with each trajectory class alone and all three,
  at per-frame gating that mixes active and inactive frames: atol 2e-4,
  rtol 1e-3, as the UNet twins without traj.
* ``freetraj_sample`` end to end (4 steps, two of them above the spatial
  threshold) with the JAX draw injected: within ``close_fp32_chain``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dynamicscaler_tpu.models.attention import CrossAttention as JCrossAttention
from dynamicscaler_tpu.ops import freetraj as jft
from dynamicscaler_tpu.pipelines import t2v as jt2v
from dynamicscaler_tpu_torch.models.attention import SITE_CROSS, SITE_SPATIAL, SITE_TEMPORAL, CrossAttention
from dynamicscaler_tpu_torch.ops import freetraj as ft
from dynamicscaler_tpu_torch.pipelines import t2v
from torch_port_helpers import close_fp32_chain, t2v_twin_models, tiny_unet_twins

PATHS = [
    [(0, 0.1, 0.4, 0.2, 0.5), (7, 0.5, 0.8, 0.4, 0.7)],
    [(0.0, 0.25, 0.75, 0.0, 0.5), (1.0, 0.25, 0.75, 0.5, 1.0)],
    [(3, 0.0, 0.3, 0.6, 1.0)],
]


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, ref, tol=1e-6):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("kf", PATHS)
@pytest.mark.parametrize("hw", [(10, 16), (5, 8), (3, 3), (40, 64)])
def test_freetraj_ops_match_jax(kf, hw):
    H, W = hw
    p = ft.plan_path(kf, 8)
    np.testing.assert_array_equal(p, jft.plan_path(kf, 8))
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    for g, r in zip(ft.box_grid(tp, H, W), jft.box_grid(jp, H, W)):
        np.testing.assert_array_equal(_np(g), _np(r))
    np.testing.assert_array_equal(_np(ft.fg_map(tp, H, W)), _np(jft.fg_map(jp, H, W)))
    for n_fg in (1, 3):
        _close(ft.cross_weight_map(tp, H, W, n_fg), jft.cross_weight_map(jp, H, W, n_fg))
    _close(ft.gaussian_weight(H, W), jft.gaussian_weight(H, W))
    fg = ft.fg_map(tp, H, W).reshape(8, H * W)
    _close(ft.pair_mul(fg), jft.pair_mul(jnp.asarray(fg.numpy())))


def test_freetraj_state_matches_jax():
    np.testing.assert_array_equal(ft.fg_token_mask(77, [2, 5]).numpy(), _np(jft.fg_token_mask(77, [2, 5])))
    np.testing.assert_array_equal(ft.fg_token_mask(77).numpy(), _np(jft.fg_token_mask(77)))
    kw = dict(text_len=77, fg_token_ids=[3], batch=2, temporal_attn=False)
    tr, jtr = ft.make_freetraj(PATHS[0], 4, **kw), jft.make_freetraj(PATHS[0], 4, **kw)
    for f in ("paths", "active", "fg_tok"):
        np.testing.assert_array_equal(_np(getattr(tr, f)), _np(getattr(jtr, f)))
    assert (tr.temporal_attn, tr.self_attn, tr.cross_attn) == (jtr.temporal_attn, jtr.self_attn, jtr.cross_attn)
    for t in (np.array(650.0), np.array([650.0, 100.0]), np.array([[900, 700, 500, 100], [900, 900, 900, 900]])):
        got = ft.gate_active(tr, torch.from_numpy(t), 600.0, 2, 4).active
        np.testing.assert_array_equal(got.numpy(), _np(jft.gate_active(jtr, jnp.asarray(t), 600.0, 2, 4).active))


def _attn_twins(C, ctx_dim, heads, d, img, seed):
    """The JAX CrossAttention with random parameters and the port's with the
    same numbers, plus one LayerNorm's (scale, bias)."""
    rng = np.random.default_rng(seed)
    jm = JCrossAttention(heads=heads, dim_head=d, context_dim=ctx_dim, img_cross_attention=img,
                         text_context_len=77)
    cd = None if ctx_dim is None else jnp.zeros((1, 77 + (4 if img else 0), ctx_dim))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, C)), context=cd)
    params = jax.tree.map(lambda a: np.asarray(rng.standard_normal(a.shape) / np.sqrt(a.shape[0]), np.float32),
                          params)
    tm = CrossAttention(C, ctx_dim, heads, d, img_cross_attention=img, text_context_len=77)
    p = params["params"]
    with torch.no_grad():
        for name in ("to_q", "to_k", "to_v") + (("to_k_ip", "to_v_ip") if img else ()):
            getattr(tm, name).weight.copy_(torch.from_numpy(np.asarray(p[name]["kernel"]).T))
        tm.to_out[0].weight.copy_(torch.from_numpy(np.asarray(p["to_out"]["kernel"]).T))
        tm.to_out[0].bias.copy_(torch.from_numpy(np.asarray(p["to_out"]["bias"])))
    ln = nn.LayerNorm(C)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(1 + 0.1 * rng.standard_normal(C).astype(np.float32)))
        ln.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32)))
    return jm, params, tm, ln


@pytest.mark.parametrize("site", ["temporal", "spatial", "cross", "cross_img"])
def test_traj_attention_matches_jax(site):
    """The re-weighted sub-block: rows alternate active and inactive
    (temporal re-weighting is ungated in the UNet, so all rows there)."""
    C, heads, d = 32, 2, 16
    rng = np.random.default_rng(7)
    img = site == "cross_img"
    cross = site.startswith("cross")
    ctx_dim = 24 if cross else None
    jm, params, tm, ln = _attn_twins(C, ctx_dim, heads, d, img, seed=8)
    if site == "temporal":
        H, W, F = 5, 8, 4
        B, N = H * W, F
        fgm = ft.fg_map(torch.from_numpy(ft.plan_path(PATHS[0], F)), H, W)
        fg = fgm.permute(1, 2, 0).reshape(H * W, F)
        active = torch.ones(B, dtype=torch.bool)
    else:
        H, W = 10, 16
        B, N = 4, H * W
        fg = ft.fg_map(torch.from_numpy(ft.plan_path(PATHS[1], B)), H, W).reshape(B, N)
        active = torch.tensor([True, False, True, False])
    traj = {"fg": fg, "active": active}
    if cross:
        traj["fg_tok"] = ft.fg_token_mask(77, [2, 5])
        traj["wadd"] = ft.cross_weight_map(torch.from_numpy(ft.plan_path(PATHS[1], B)), H, W, 2).reshape(B, N)
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    ctx = rng.standard_normal((B, 77 + (4 if img else 0), ctx_dim)).astype(np.float32) if cross else None
    jtraj = {k: jnp.asarray(v.numpy()) for k, v in traj.items()}
    ref = jm.apply(params, jnp.asarray(x), context=None if ctx is None else jnp.asarray(ctx),
                   ln=(jnp.asarray(ln.weight.detach().numpy()), jnp.asarray(ln.bias.detach().numpy())),
                   add_residual=True, traj=jtraj)
    site_name = {"temporal": SITE_TEMPORAL, "spatial": SITE_SPATIAL}.get(site, SITE_CROSS)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), ln, site_name, context=None if ctx is None else torch.from_numpy(ctx),
                 traj=traj)
        plain = tm(torch.from_numpy(x), ln, site_name, context=None if ctx is None else torch.from_numpy(ctx))
    _close(got, ref, 2e-5)
    assert float((got - plain).abs().max()) > 1e-3  # the re-weighting acts


@pytest.fixture(scope="module")
def unet_twins():
    return tiny_unet_twins(False, context_dim=32, seed=6)


@pytest.mark.parametrize("classes", [(True, False, False), (False, True, False), (False, False, True),
                                     (True, True, True)], ids=["temporal", "self", "cross", "all"])
def test_unet_forward_with_traj_matches_jax(unet_twins, classes):
    jm, params, tm, cfg = unet_twins
    B, F, H, W = 2, 4, 8, 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, F, H, W, 4)).astype(np.float32)
    ctx = rng.standard_normal((B, 77, cfg.context_dim)).astype(np.float32)
    t = np.array([[900, 700, 500, 100], [650, 550, 900, 300]])  # active and inactive frames
    kf = [(0, 0.1, 0.5, 0.1, 0.5), (F - 1, 0.4, 0.8, 0.4, 0.8)]
    flags = dict(temporal_attn=classes[0], self_attn=classes[1], cross_attn=classes[2])
    jtr = jft.gate_active(jft.make_freetraj(kf, F, text_len=77, fg_token_ids=[2, 4], batch=B, **flags),
                          jnp.asarray(t), 600.0, B, F)
    ttr = ft.gate_active(ft.make_freetraj(kf, F, text_len=77, fg_token_ids=[2, 4], batch=B, **flags),
                         torch.from_numpy(t), 600.0, B, F)
    tt = np.array([700, 300])
    fwd = jax.jit(lambda p, x, t, c, tr: jm.apply(p, x, t, c, 8, traj=tr))
    ref = np.asarray(fwd(params, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx), jtr))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(tt), torch.from_numpy(ctx), 8, traj=ttr)
        base = tm(torch.from_numpy(x), torch.from_numpy(tt), torch.from_numpy(ctx), 8)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)
    assert float((got - base).abs().max()) > 1e-4  # the class acts


@pytest.fixture(scope="module")
def twin_models():
    return t2v_twin_models(seed=13)


def test_freetraj_sample_matches_jax(twin_models):
    """4 DDIM steps at t 999, 666 (spatial masking on) and 333, 0 (off)."""
    jmodel, tmodel = twin_models
    key = jax.random.PRNGKey(17)
    kf = [(0, 0.25, 0.75, 0.0, 0.5), (1.0, 0.25, 0.75, 0.5, 1.0)]
    kw = dict(traj_token_ids=[2, 3], traj_thres=600.0, height=32, width=32, frames=4, num_inference_steps=4,
              guidance_scale=7.5, fps=8)
    jv, jd = jt2v.freetraj_sample(jmodel, "a red car", kf, key=key, **kw)
    tv, td = t2v.freetraj_sample(tmodel, "a red car", kf, noise_fn=lambda name, shape: (
        np.array(jax.random.normal(key, shape)) if name == "init" else pytest.fail(name)), **kw)
    assert td.shape == (1, 4, 16, 16, 4) and bool(torch.isfinite(td).all())
    close_fp32_chain(td, jd)
    close_fp32_chain(tv, jv)
    with pytest.raises(ValueError, match="t2v path"):
        i2v_like = dataclasses.replace(tmodel.config, unet=dataclasses.replace(tmodel.config.unet,
                                                                               use_image_attention=True))
        t2v.freetraj_sample(type("M", (), {"config": i2v_like})(), "x", kf)
