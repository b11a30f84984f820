"""The fusion ladder of the PyTorch port against the JAX package on the
CPU: kernels 11 (``fused_block.fused_spatial_block``) and 12
(``fused_mega.temporal_transformer``), the plan's spec strings, the kernels'
shape gates at the full-width i2v UNet's shapes, and the tiny UNet's routes
under the "off" plan and the all-wrap+blk plan.

On the CPU each wrapper takes its plain PyTorch version; the JAX side runs
``_spatial_block_call`` and ``_t_mega_call`` through the Pallas interpreter
(``fused_temporal.set_mode("interpret")``, as tests/test_fused_block.py and
tests/test_fused_mega.py do). Inputs and weights come from a numpy seed
(JAX weights in flax ``[in, out]`` layout, the port's transposed).
Tolerances: the kernel twins compute in fp32 with the same rounding points
and differ only in the order of their sums, so rtol 1e-4 with an absolute
floor of 1e-4 of the output's largest magnitude (as
tests/test_torch_fused_block.py); the tiny UNet against the JAX UNet (XLA
path) atol 2e-4, rtol 1e-3 (as tests/test_torch_unet.py), and against the
port's own default path 1e-5.
"""

import collections
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.ops import fused_block as jblock
from dynamicscaler_tpu.ops import fused_mega as jmega
from dynamicscaler_tpu.ops import fused_temporal as jtemporal
from dynamicscaler_tpu_torch.ops import fused_block, fused_mega, fused_temporal
from torch_port_helpers import i2v_transformers, tiny_unet_twins

WRAP_BLK_SPEC = "s320=wrap+blk,s640=wrap+blk,t640=wrap+blk,t1280=wrap+blk"


@pytest.fixture
def interpret():
    jtemporal.set_mode("interpret")
    yield
    jtemporal.set_mode("auto")


@pytest.fixture
def restore_plans():
    yield
    fused_temporal.set_plan()
    jtemporal.set_plan("auto")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def _w(rng, n_in, n_out):
    return (rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)).astype(np.float32)


def _vec(rng, n, base=0.0):
    return (base + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _block_weights(rng, C, Dc=None, img=False):
    """One block's weights, flax layout: (lns, attn1, attn2, ff); attn2 is
    (wq, wk, wv, wo, bo) + (wk_ip, wv_ip) with image keys."""
    Dc = Dc or C
    lns = tuple(_vec(rng, C, base) for _ in range(3) for base in (1.0, 0.0))
    a1 = (_w(rng, C, C), _w(rng, C, C), _w(rng, C, C), _w(rng, C, C), _vec(rng, C))
    a2 = (_w(rng, C, C), _w(rng, Dc, C), _w(rng, Dc, C), _w(rng, C, C), _vec(rng, C))
    if img:
        a2 += (_w(rng, Dc, C), _w(rng, Dc, C))
    ff = (_w(rng, C, 8 * C), _vec(rng, 8 * C), _w(rng, 4 * C, C), _vec(rng, C))
    return lns, a1, a2, ff


def _port(ws):
    """Port layout: weights [out, in], vectors as they are."""
    return tuple(_t(w.T) if w.ndim == 2 else _t(w) for w in ws)


def _jax(ws):
    return tuple(jnp.asarray(w) for w in ws)


# ---------------------------------------------------------------------------
# kernels 11 and 12 against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("img", [False, True])
def test_spatial_block_matches_pallas(rng, interpret, img):
    """Kernel 11's plain version: the whole spatial block over N = 256
    tokens, 3 clips of 2 frames, a context width of 128 given per clip (the
    JAX kernel takes it repeated per frame); t2v with an odd text length
    (21 keys), i2v with 77 text + 16 image keys (tests/test_fused_block.py)."""
    clips, frames, N, C, Dc = 3, 2, 256, 64, 128
    L = 77 + 16 if img else 21
    x = rng.standard_normal((clips * frames, N, C)).astype(np.float32)
    ctx = rng.standard_normal((clips, L, Dc)).astype(np.float32)
    lns, a1, a2, ff = _block_weights(rng, C, Dc, img)
    scale = 64 ** -0.5
    ref = jblock.fused_spatial_block(jnp.asarray(x), jnp.asarray(np.repeat(ctx, frames, axis=0)), _jax(lns),
                                     _jax(a1), _jax(a2[:3] + a2[5:] + a2[3:5]), _jax(ff), heads=1, scale=scale)
    got = fused_block.fused_spatial_block(_t(x), _t(ctx), tuple(map(_t, lns)), _port(a1), _port(a2), _port(ff),
                                          heads=1, scale=scale)
    assert got.shape == x.shape and fused_block.fused_spatial_block.launches == 0
    _close(got, ref)


def test_spatial_block_matches_pallas_at_a_ragged_n(rng, interpret):
    """Kernel 11's plain version at N = 272 (17 x 16 tokens: no query tile
    of the card's kernel divides it, so a sample's last tile is ragged), 2
    clips of 3 frames, i2v context, two heads."""
    clips, frames, N, C, Dc, heads = 2, 3, 272, 128, 128, 2
    x = rng.standard_normal((clips * frames, N, C)).astype(np.float32)
    ctx = rng.standard_normal((clips, 77 + 16, Dc)).astype(np.float32)
    lns, a1, a2, ff = _block_weights(rng, C, Dc, True)
    scale = 64 ** -0.5
    ref = jblock.fused_spatial_block(jnp.asarray(x), jnp.asarray(np.repeat(ctx, frames, axis=0)), _jax(lns),
                                     _jax(a1), _jax(a2[:3] + a2[5:] + a2[3:5]), _jax(ff), heads=heads, scale=scale)
    got = fused_block.fused_spatial_block(_t(x), _t(ctx), tuple(map(_t, lns)), _port(a1), _port(a2), _port(ff),
                                          heads=heads, scale=scale)
    assert got.shape == x.shape and fused_block.fused_spatial_block.launches == 0
    _close(got, ref)


@pytest.mark.parametrize("C,heads", [(64, 1), (128, 2)])
def test_temporal_mega_matches_pallas(rng, interpret, C, heads):
    """Kernel 12's plain version: the whole TemporalTransformer over 2 clips
    of 4 frames at 8x16 (tests/test_fused_mega.py), GroupNorm over each
    clip."""
    B, Fn, H, W = 2, 4, 8, 16
    x5 = (2.0 * rng.standard_normal((B, Fn, H, W, C)) + 0.5).astype(np.float32)
    gs, gb = _vec(rng, C, 1.0), _vec(rng, C)
    w_in, b_in, w_out, b_out = _w(rng, C, C), _vec(rng, C), _w(rng, C, C), _vec(rng, C)
    lns, a1, a2, ff = _block_weights(rng, C)
    scale = 64 ** -0.5
    ref = jmega.temporal_transformer(jnp.asarray(x5), jnp.asarray(gs), jnp.asarray(gb), jnp.asarray(w_in),
                                     jnp.asarray(b_in), _jax(lns), _jax(a1), _jax(a2), _jax(ff), jnp.asarray(w_out),
                                     jnp.asarray(b_out), heads=heads, scale=scale)
    got = fused_mega.temporal_transformer(_t(x5), _t(gs), _t(gb), _t(w_in.T), _t(b_in), tuple(map(_t, lns)),
                                          _port(a1), _port(a2), _port(ff), _t(w_out.T), _t(b_out), heads=heads,
                                          scale=scale)
    assert got.shape == x5.shape and fused_mega.temporal_mega.launches == 0
    _close(got, ref)


@pytest.mark.parametrize("Fn", [8, 32])
def test_temporal_mega_matches_pallas_at_other_frame_counts(rng, interpret, Fn):
    """Kernel 12's plain version at 8 and 32 frames (the card's kernel takes
    every F the JAX gate admits), one clip of 2x8 positions at C 64."""
    B, H, W, C, heads = 1, 2, 8, 64, 1
    x5 = (2.0 * rng.standard_normal((B, Fn, H, W, C)) + 0.5).astype(np.float32)
    gs, gb = _vec(rng, C, 1.0), _vec(rng, C)
    w_in, b_in, w_out, b_out = _w(rng, C, C), _vec(rng, C), _w(rng, C, C), _vec(rng, C)
    lns, a1, a2, ff = _block_weights(rng, C)
    scale = 64 ** -0.5
    assert jmega.temporal_ok(Fn, C, C, heads, H, W)
    ref = jmega.temporal_transformer(jnp.asarray(x5), jnp.asarray(gs), jnp.asarray(gb), jnp.asarray(w_in),
                                     jnp.asarray(b_in), _jax(lns), _jax(a1), _jax(a2), _jax(ff), jnp.asarray(w_out),
                                     jnp.asarray(b_out), heads=heads, scale=scale)
    got = fused_mega.temporal_transformer(_t(x5), _t(gs), _t(gb), _t(w_in.T), _t(b_in), tuple(map(_t, lns)),
                                          _port(a1), _port(a2), _port(ff), _t(w_out.T), _t(b_out), heads=heads,
                                          scale=scale)
    assert got.shape == x5.shape and fused_mega.temporal_mega.launches == 0
    _close(got, ref)


@pytest.mark.parametrize("Fn", [1, 2, 3, 4, 8, 12, 16, 32, 64, 128, 256])
def test_frame_gates_match_jax(interpret, restore_plans, Fn):
    """K1's, kernel 10's and kernel 12's frame counts are the JAX gates':
    2 <= F and F dividing 128 (at a W where the JAX row tile always exists)."""
    jtemporal.set_plan("off")
    fused_temporal.set_plan("off")
    for C in (320, 640, 1280):
        heads = C // 64
        assert fused_temporal.frames_ok(Fn) == jtemporal.fusable(Fn, C, C, heads)
        assert fused_block.temporal_block_ok(Fn, C, C, heads) == jblock.temporal_block_fusable(Fn, C, C, heads)
        assert fused_mega.temporal_ok(Fn, C, C, heads) == jmega.temporal_ok(Fn, C, C, heads, 8, 128)


# ---------------------------------------------------------------------------
# the plan's spec strings (the cases of tests/test_fuse_plan.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["auto", "", "off", "t320=mega,s640=wrap+sub", "t640=mega,s320=wrap+blk",
                                  "t32=wrap+blk"])
def test_plan_specs_parse_as_jax(restore_plans, spec):
    """The port parses a spec by the JAX rules: "auto" its table, "off" no
    table (every level allowed), a patch the same entries over its table."""
    port, jax_plan = fused_temporal._parse_plan(spec), jtemporal._parse_plan(spec)
    if jax_plan is None:
        assert port is None
        fused_temporal.set_plan(spec)
        assert all(fused_temporal.plan_allows(kind, side, c)
                   for kind in ("mega", "block") for side in "ts" for c in (32, 320, 640, 1280))
        return
    patched = {(item[0], int(item[1:].partition("=")[0])): item.partition("=")[2]
               for item in spec.split(",") if spec != "auto" and item}
    assert port == {torch.bfloat16: {**fused_temporal.PLAN_DEFAULT, **patched},
                    torch.float32: {**fused_temporal.PLAN_DEFAULT_F32, **patched}}
    assert all(port[torch.bfloat16][k] == jax_plan[k] for k in patched)
    fused_temporal.set_plan(spec)
    for dt, table in port.items():
        for (side, c), level in table.items():
            assert fused_temporal.plan_allows("mega", side, c, dt) == (level == "mega")
            assert fused_temporal.plan_allows("block", side, c, dt) == (level in ("mega", "wrap+blk"))


def test_fp32_plan_is_chosen_by_the_activations_dtype(restore_plans):
    """Two tables: bf16 activations (and any other type but fp32) read
    PLAN_DEFAULT, unchanged (kernel 12 at t320, the sub-blocks elsewhere);
    fp32 ones PLAN_DEFAULT_F32, which differs at the keys phase 10's fp32
    level table moved (kernel 13 at s320 and s640, kernel 10 at t512)."""
    keys = [(side, c) for side in "ts" for c in (320, 640, 1280)] + [("t", 512)]
    assert fused_temporal.PLAN_DEFAULT == {**dict.fromkeys(keys, "wrap+sub"), ("t", 320): "mega"}
    assert fused_temporal.PLAN_DEFAULT_F32 == {**fused_temporal.PLAN_DEFAULT, ("s", 320): "mega",
                                               ("s", 640): "mega", ("t", 512): "wrap+blk"}
    fused_temporal.set_plan()
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        table = fused_temporal.PLAN_DEFAULT_F32 if dt == torch.float32 else fused_temporal.PLAN_DEFAULT
        for (side, c), level in table.items():
            assert fused_temporal.plan_allows("mega", side, c, dt) == (level == "mega"), (dt, side, c)
            assert fused_temporal.plan_allows("block", side, c, dt) == (level != "wrap+sub"), (dt, side, c)
    assert fused_temporal.plan_allows("mega", "s", 320, torch.float32)
    assert not fused_temporal.plan_allows("block", "s", 320) and not fused_temporal.plan_allows("block", "s", 640)


@pytest.mark.parametrize("spec", ["off", "s320=wrap+sub,t512=wrap+sub", {("s", 640): "wrap+blk"}])
def test_off_and_specs_apply_to_both_tables(restore_plans, spec):
    """"off" allows every level in either type; a spec (string or dict)
    patches the same entries over both tables, leaving each table's other
    entries as they were."""
    fused_temporal.set_plan(spec)
    if spec == "off":
        assert all(fused_temporal.plan_allows(kind, side, c, dt) for kind in ("mega", "block") for side in "ts"
                   for c in (320, 512, 640, 1280) for dt in (torch.bfloat16, torch.float32))
        return
    patch = spec if isinstance(spec, dict) else {(i[0], int(i[1:].partition("=")[0])): i.partition("=")[2]
                                                 for i in spec.split(",")}
    for dt, table in ((torch.bfloat16, fused_temporal.PLAN_DEFAULT), (torch.float32, fused_temporal.PLAN_DEFAULT_F32)):
        for (side, c), level in {**table, **patch}.items():
            assert fused_temporal.plan_allows("mega", side, c, dt) == (level == "mega"), (dt, side, c)
            assert fused_temporal.plan_allows("block", side, c, dt) == (level != "wrap+sub"), (dt, side, c)


@pytest.mark.parametrize("spec,error", [("t320=warp", AssertionError), ("x320=mega", AssertionError),
                                        ("tabc=mega", ValueError)])
def test_bad_plan_specs_raise_as_jax(restore_plans, spec, error):
    with pytest.raises(error):
        jtemporal.set_plan(spec)
    with pytest.raises(error):
        fused_temporal.set_plan(spec)


def test_subs_is_refused(restore_plans):
    """The JAX package's "subs" (no wrapper kernels) has no counterpart in
    the port: a clear error, in a spec and in a dict, and the plan is left
    as it was."""
    jtemporal.set_plan("t320=subs")
    fused_temporal.set_plan("off")
    for spec in ("t320=subs", {("t", 320): "subs"}):
        with pytest.raises(ValueError, match="subs"):
            fused_temporal.set_plan(spec)
    assert fused_temporal._PLAN is None


def test_env_plan_read_at_import():
    """DSCALER_FUSE_PLAN is read once, when the module is imported."""
    code = ("from dynamicscaler_tpu_torch.ops import fused_temporal as f; "
            "print(f._PLAN is None, f.plan_allows('mega', 't', 640), f.plan_allows('block', 's', 320))")
    out = {}
    for spec in ("off", "t640=mega,s320=wrap+sub"):
        env = dict(os.environ, DSCALER_FUSE_PLAN=spec, PYTHONPATH=os.getcwd())
        out[spec] = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                                   check=True).stdout.split()
    assert out["off"] == ["True", "True", "True"]
    assert out["t640=mega,s320=wrap+sub"] == ["False", "True", "False"]


# ---------------------------------------------------------------------------
# the gates at the full-width i2v UNet's transformers
# ---------------------------------------------------------------------------


def _port_gates(side, C, inner, heads, H, W, ctx_dim=1024):
    if side == "t":
        return {"mega": fused_mega.temporal_ok(16, C, inner, heads),
                "block": fused_block.temporal_block_ok(16, inner, inner, heads)}
    return {"mega": fused_mega.spatial_ok(H * W, C, inner, heads, ctx_dim),
            "block": fused_block.spatial_block_ok(H * W, inner, inner, heads, ctx_dim)}


def _jax_gates(side, C, inner, heads, H, W, ctx_dim=1024):
    if side == "t":
        return {"mega": jmega.temporal_ok(16, C, inner, heads, H, W),
                "block": jblock.temporal_block_fusable(16, inner, inner, heads)}
    return {"mega": jmega.spatial_ok(H * W, C, inner, heads, ctx_dim),
            "block": jblock.spatial_block_fusable(H * W, inner, inner, heads, ctx_dim)}


@pytest.mark.parametrize("spec", ["auto", "off", WRAP_BLK_SPEC])
def test_gates_match_jax_at_full_width(interpret, restore_plans, spec):
    """At every transformer of the full-width i2v UNet, each kernel's port
    gate admits exactly the shapes the JAX gate does under the same plan
    (the JAX gates consult their plan; the port's modules consult theirs
    beside the gate, and under "off" the two routes are the same). The port's
    own table differs from the JAX v5e table by design, so under "auto" and
    the patch the port's gates are held with the JAX plan."""
    jtemporal.set_plan(spec)
    fused_temporal.set_plan(spec)
    shapes = i2v_transformers()
    assert len(shapes) == 1 + 16 + 16
    admitted = collections.Counter()
    for shape in shapes:
        side, C, inner = shape[:3]
        port, ref = _port_gates(*shape), _jax_gates(*shape)
        for kind, ok in port.items():
            width = C if kind == "mega" else inner
            assert (ok and jtemporal.plan_allows(kind, side, width)) == ref[kind], (shape, kind)
            if spec == "off":
                assert (ok and fused_temporal.plan_allows(kind, side, width)) == ref[kind], (shape, kind)
            admitted[side + kind] += ok
    # the shape conditions alone: K12 at the 10 temporal transformers of C 320 / 640, K10 at every block (17),
    # K13 and K11 at the 10 spatial transformers of C 320 / 640
    assert admitted == {"tmega": 10, "tblock": 17, "smega": 10, "sblock": 10}


# ---------------------------------------------------------------------------
# the tiny UNet's routes under "off" and the all-wrap+blk plan
# ---------------------------------------------------------------------------

# the tiny UNet's widths: 32 and 64, and init_attn's 8 heads x 16 = 128
TINY_WRAP_BLK = "t32=wrap+blk,t64=wrap+blk,t128=wrap+blk,s32=wrap+blk,s64=wrap+blk"
PORT_ROUTES = ((fused_block, "temporal_block_plain", "K10"), (fused_block, "spatial_block_plain", "K11"),
               (fused_mega, "temporal_mega_plain", "K12"), (fused_mega, "spatial_mega_plain", "K13"))
JAX_ROUTES = ((jblock, "fused_temporal_block", "K10"), (jblock, "fused_spatial_block", "K11"),
              (jmega, "temporal_transformer", "K12"), (jmega, "spatial_transformer", "K13"))


def _counting(monkeypatch, routes, calls):
    for mod, name, k in routes:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _k=k, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)


@pytest.fixture(scope="module")
def tiny_i2v():
    """The tiny i2v UNet twins (context width 128) at a 16x16 latent, so
    that the 16x16 level's N = 256 passes the spatial gates, and the JAX
    forward through XLA."""
    jm, params, tm, cfg = tiny_unet_twins(True)
    rng = np.random.default_rng(3)
    L = cfg.text_context_len + 4
    x = rng.standard_normal((2, 4, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, L, cfg.context_dim)).astype(np.float32)
    t = np.array([700, 40], np.int32)
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), 16)
    ref = np.asarray(jax.jit(jm.apply, static_argnums=4)(params, *jargs))
    with torch.no_grad():
        default = tm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 16)
    return jm, params, tm, jargs, (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 16), ref, default


@pytest.mark.parametrize("spec,expected", [
    ("off", {"K12": 7, "K10": 1, "K13": 3}),
    (TINY_WRAP_BLK, {"K10": 8, "K11": 3}),
])
def test_tiny_unet_routes_match_jax(tiny_i2v, interpret, restore_plans, monkeypatch, spec, expected):
    """Under the same plan the port's tiny UNet takes the JAX UNet's routes:
    "off" runs kernel 12 at the 7 temporal transformers, kernel 10 at
    init_attn (inner 128 on 32 channels) and kernel 13 at the 3 spatial
    transformers of the 16x16 level (the 8x8 level's N = 64 is below the
    spatial gates); the all-wrap+blk plan runs kernel 10 at all 8 temporal
    blocks and kernel 11 at those 3. The JAX routes are counted while
    tracing its forward in interpret mode (``jax.eval_shape``, nothing runs);
    the port's forward is held against the JAX forward and its own default
    path."""
    jm, params, tm, jargs, args, ref, default = tiny_i2v
    jtemporal.set_plan(spec)
    fused_temporal.set_plan(spec)
    jax_calls, port_calls = collections.Counter(), collections.Counter()
    _counting(monkeypatch, JAX_ROUTES, jax_calls)
    _counting(monkeypatch, PORT_ROUTES, port_calls)
    jax.eval_shape(lambda p, *a: jm.apply(p, *a[:3], 16), params, *jargs[:3])
    with torch.no_grad():
        got = tm(*args)
    assert jax_calls == expected and port_calls == expected
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), default.numpy(), atol=1e-5, rtol=1e-5)
