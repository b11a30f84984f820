"""Kernels 10 and 13 of the PyTorch port (``ops/fused_block.py``,
``ops/fused_mega.py``) and its per-shape dispatch plan, against the JAX
package on the CPU.

On the CPU each wrapper takes its plain PyTorch version; the JAX side runs
``_temporal_block_call`` and ``_s_mega_call`` through the Pallas
interpreter (``fused_temporal.set_mode("interpret")``, as
tests/test_fused_block.py and tests/test_fused_mega.py do). Inputs and
weights come from a numpy seed (JAX weights in flax ``[in, out]`` layout,
the port's transposed). Tolerance: both sides compute in fp32 with the same
rounding points and differ only in the order of their sums (LayerNorm and
GroupNorm statistics, the products, the softmax denominators), so rtol 1e-4
with an absolute floor of 1e-4 of the output's largest magnitude. The tiny
UNet with the tiny widths planned onto kernels 10 and 13 is held against the
JAX UNet (XLA path) with the tolerance of tests/test_torch_unet.py. Kernels
11 and 12 and the plan's spec strings are in tests/test_torch_fused_ladder.py.
"""

import collections
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.ops import fused_block as jblock
from dynamicscaler_tpu.ops import fused_mega as jmega
from dynamicscaler_tpu.ops import fused_temporal as jtemporal
from dynamicscaler_tpu_torch.ops import cuda_lib, fused_block, fused_mega, fused_temporal
from torch_port_helpers import tiny_unet_twins


@pytest.fixture
def interpret():
    jtemporal.set_mode("interpret")
    yield
    jtemporal.set_mode("auto")


@pytest.fixture
def restore_plan():
    yield
    fused_temporal.set_plan()


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


def _jax_attn2(a2):
    """The JAX kernels' attn2 order: (wq, wk, wv[, wk_ip, wv_ip], wo, bo)."""
    return tuple(jnp.asarray(w) for w in (a2[:3] + a2[5:] + a2[3:5]))


@pytest.mark.parametrize("R,C,heads", [(40, 64, 1), (24, 128, 2)])
def test_temporal_block_matches_pallas(rng, interpret, R, C, heads):
    """Kernel 10's plain version: the whole temporal block over 16-frame
    rows (R rows, not a multiple of the TPU kernel's row tile)."""
    x = rng.standard_normal((R, 16, C)).astype(np.float32)
    lns, a1, a2, ff = _block_weights(rng, C)
    scale = 64 ** -0.5
    ref = jblock.fused_temporal_block(jnp.asarray(x), tuple(map(jnp.asarray, lns)), tuple(map(jnp.asarray, a1)),
                                      tuple(map(jnp.asarray, a2)), tuple(map(jnp.asarray, ff)), heads=heads,
                                      scale=scale)
    got = fused_block.fused_temporal_block(_t(x), tuple(map(_t, lns)), _port(a1), _port(a2), _port(ff),
                                           heads=heads, scale=scale)
    assert got.shape == (R, 16, C) and fused_block.fused_temporal_block.launches == 0
    _close(got, ref)


@pytest.mark.parametrize("R,Fn", [(12, 8), (3, 32), (40, 2)])
def test_temporal_block_matches_pallas_at_other_frame_counts(rng, interpret, R, Fn):
    """Kernel 10's plain version over rows of 8, 32 and 2 frames (the card's
    kernel takes every F the JAX gate admits, spreading a row of more
    frames than its token tile over a cluster of blocks)."""
    C, heads = 64, 1
    x = rng.standard_normal((R, Fn, C)).astype(np.float32)
    lns, a1, a2, ff = _block_weights(rng, C)
    scale = 64 ** -0.5
    ref = jblock.fused_temporal_block(jnp.asarray(x), tuple(map(jnp.asarray, lns)), tuple(map(jnp.asarray, a1)),
                                      tuple(map(jnp.asarray, a2)), tuple(map(jnp.asarray, ff)), heads=heads,
                                      scale=scale)
    got = fused_block.fused_temporal_block(_t(x), tuple(map(_t, lns)), _port(a1), _port(a2), _port(ff),
                                           heads=heads, scale=scale)
    assert got.shape == (R, Fn, C) and fused_block.fused_temporal_block.launches == 0
    _close(got, ref)


FRAMES = [2, 4, 8, 16, 32, 64, 128]  # every F with 2 <= F <= 128 that divides 128


@pytest.mark.parametrize("mega,C,Fn", [(False, C, Fn) for C in (320, 512, 640, 1280) for Fn in FRAMES]
                         + [(True, C, Fn) for C in (320, 512, 640) for Fn in FRAMES])
def test_block_plan_fits_the_card(mega, C, Fn):
    """The tile plan of kernels 10 and 12 (``cuda_lib.block_plan``) at every
    UNet width and frame count the gates admit: its shared memory is
    csrc/block.cu's reckoning and fits the H100's 232,448 bytes; the
    cluster is portable (at most 8 blocks); a cluster holds whole F-frame
    rows, and is no larger than that where the multicast did not time
    faster (every width but 512); the padded grid
    is whole clusters; and the ring, the head group, the hidden chunk and
    the token tile are what the kernel takes (csrc/block.cu::plan_ok)."""
    p = cuda_lib.block_plan(C, Fn, mega)
    assert p.smem == cuda_lib.block_smem(p.tm, C, Fn, p.stages, p.hg, p.hc) <= 232448
    assert p.cl in (1, 2, 4, 8)
    assert (p.cl * p.tm) % Fn == 0  # every row lies in one cluster
    assert p.cl == max(-(-Fn // p.tm), 2 if C == 512 else 1)
    if Fn > p.tm:
        assert p.cl % (Fn // p.tm) == 0 and p.hg == 1
    for rows in (1, 3, 37, 1280):
        grid = cuda_lib.block_grid(p, rows * Fn)
        assert grid % p.cl == 0 and grid * p.tm >= rows * Fn > (grid - p.cl) * p.tm
    assert p.tm == (64 if C <= 320 else 32 if C <= 640 else 16) and not (mega and p.tm == 16)
    assert C <= 128 * {64: 3, 32: 5, 16: 10}[p.tm]  # the second product's tiles held in registers
    assert 2 <= p.stages <= cuda_lib.BLOCK_MAX_STAGES and 1 <= p.hg <= C // 64
    assert p.hc % 128 == 0 and (4 * C) % p.hc == 0 and p.hc <= max(C, 128)


def _block_operands(C, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    vec = lambda n: torch.randn(n, generator=g)  # noqa: E731
    w = lambda o, i: torch.randn(o, i, generator=g)  # noqa: E731
    lns = tuple(vec(C) for _ in range(6))
    attn = lambda: (w(C, C), w(C, C), w(C, C), w(C, C), vec(C))  # noqa: E731
    a1, a2, ff = attn(), attn(), (w(8 * C, C), vec(8 * C), w(C, 4 * C), vec(C))
    return lns, a1, a2, ff


def test_block_wrappers_hand_their_kernels_the_plan(monkeypatch):
    """The card-side host code of kernels 10 and 12, run on CPU tensors with
    the launch replaced by a recorder: each wrapper encodes its weights'
    TMA maps once (six for kernel 10, eight with w_in and w_out for kernel
    12, at the plan's cluster size) and keeps them with the packed
    operands, hands ``ds_temporal_block`` / ``ds_temporal_mega`` the maps
    and ``block_plan``'s tile, and counts one launch; a second call reuses
    the maps. Where the kernel returns an error the wrapper raises and
    counts nothing."""
    calls = []
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "call", lambda name, *args: calls.append((name, args)))
    for fn in (fused_block.fused_temporal_block, fused_mega.temporal_mega):
        monkeypatch.setattr(fn, "launches", 0)
    bf, C, Fn = torch.bfloat16, 128, 16
    lns, a1, a2, ff = _block_operands(C)
    op = fused_block.pack_temporal_block(lns, a1, a2, ff, dtype=bf)
    x = torch.zeros(5, Fn, C, dtype=bf)
    for _ in range(2):
        out = fused_block.fused_temporal_block(x, lns, a1, a2, ff, heads=2, scale=0.125, operands=op)
        assert out.shape == x.shape
    plan = cuda_lib.block_plan(C, Fn)
    assert [c[0] for c in calls] == ["ds_block_maps", "ds_temporal_block", "ds_temporal_block"]
    maps_args, args = calls[0][1], calls[1][1]
    assert maps_args[1:4] == (6, C, plan.cl)
    assert args[1:6] == (5, Fn, C, 0.125, 1e-5) and tuple(args[7:]) == tuple(plan)
    assert args[6].value == maps_args[4].value and fused_block.fused_temporal_block.launches == 2
    assert list(op.maps) == [plan.cl]

    calls.clear()
    w_in, b_in, w_out, b_out = torch.randn(C, C), torch.randn(C), torch.randn(C, C), torch.randn(C)
    mop = fused_mega.pack_temporal_mega(w_in, b_in, lns, a1, a2, ff, w_out, b_out, dtype=bf)
    x5 = torch.zeros(2, 8, 3, 5, C, dtype=bf)
    mul, add = torch.ones(2, C), torch.zeros(2, C)
    out = fused_mega.temporal_mega(x5, mul, add, w_in, b_in, lns, a1, a2, ff, w_out, b_out, heads=2, scale=0.125,
                                   operands=mop)
    plan = cuda_lib.block_plan(C, 8, mega=True)
    assert out.shape == x5.shape and [c[0] for c in calls] == ["ds_block_maps", "ds_temporal_mega"]
    maps_args, args = calls[0][1], calls[1][1]
    assert maps_args[1:4] == (8, C, plan.cl)
    assert args[1:7] == (2, 8, 15, C, 0.125, 1e-5) and tuple(args[8:]) == tuple(plan)
    assert fused_mega.temporal_mega.launches == 1 and list(mop.maps) == [plan.cl]

    # a non-zero return of the kernel reaches the wrapper, which raises
    monkeypatch.undo()
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    failing = types.SimpleNamespace(ds_block_maps=lambda *a: 0, ds_temporal_block=lambda *a: 700,
                                    ds_temporal_mega=lambda *a: 719)
    monkeypatch.setattr(cuda_lib, "library", lambda: failing)
    for fn in (fused_block.fused_temporal_block, fused_mega.temporal_mega):
        monkeypatch.setattr(fn, "launches", 0)
    with pytest.raises(RuntimeError, match="ds_temporal_block launch failed: CUDA error 700"):
        fused_block.fused_temporal_block(x, lns, a1, a2, ff, heads=2, scale=0.125, operands=op)
    with pytest.raises(RuntimeError, match="ds_temporal_mega launch failed: CUDA error 719"):
        fused_mega.temporal_mega(x5, mul, add, w_in, b_in, lns, a1, a2, ff, w_out, b_out, heads=2, scale=0.125,
                                 operands=mop)
    assert fused_block.fused_temporal_block.launches == 0 and fused_mega.temporal_mega.launches == 0


@pytest.mark.parametrize("img,C,heads", [(False, 64, 1), (True, 128, 2)])
def test_spatial_mega_matches_pallas(rng, interpret, img, C, heads):
    """Kernel 13's plain version: the whole SpatialTransformer over N = 256
    tokens, 2 clips of 2 frames, a context width of 128 given per clip (the
    JAX kernel takes it repeated per frame); t2v with an odd text length,
    i2v with 77 text + 16 image keys."""
    clips, frames, H, W, Dc = 2, 2, 16, 16, 128
    L = 77 + 16 if img else 21
    x4 = (2.0 * rng.standard_normal((clips * frames, H, W, C)) + 0.5).astype(np.float32)
    ctx = rng.standard_normal((clips, L, Dc)).astype(np.float32)
    gs, gb = _vec(rng, C, 1.0), _vec(rng, C)
    w_in, b_in, w_out, b_out = _w(rng, C, C), _vec(rng, C), _w(rng, C, C), _vec(rng, C)
    lns, a1, a2, ff = _block_weights(rng, C, Dc, img)
    scale = 64 ** -0.5
    ref = jmega.spatial_transformer(
        jnp.asarray(x4), jnp.asarray(np.repeat(ctx, frames, axis=0)), jnp.asarray(gs), jnp.asarray(gb),
        jnp.asarray(w_in), jnp.asarray(b_in), tuple(map(jnp.asarray, lns)), tuple(map(jnp.asarray, a1)),
        _jax_attn2(a2), tuple(map(jnp.asarray, ff)), jnp.asarray(w_out), jnp.asarray(b_out), heads=heads,
        scale=scale)
    got = fused_mega.spatial_transformer(_t(x4), _t(ctx), _t(gs), _t(gb), _t(w_in.T), _t(b_in),
                                         tuple(map(_t, lns)), _port(a1), _port(a2), _port(ff), _t(w_out.T),
                                         _t(b_out), heads=heads, scale=scale)
    assert got.shape == x4.shape and fused_mega.spatial_mega.launches == 0
    _close(got, ref)


def test_plan_table_and_overrides(restore_plan):
    """The table filled from the H100 level timings (PERF.md): the whole
    temporal transformer (kernel 12) at t320, the sub-blocks at every other
    width; and the dict overrides on top of it."""
    keys = [(side, c) for side in "ts" for c in (320, 640, 1280)] + [("t", 512)]
    assert fused_temporal.PLAN_DEFAULT == {**dict.fromkeys(keys, "wrap+sub"), ("t", 320): "mega"}
    assert fused_temporal.plan_allows("mega", "t", 320) and fused_temporal.plan_allows("block", "t", 320)
    for side, c in [k for k in keys if k != ("t", 320)] + [("t", 64), ("s", 32)]:
        assert not fused_temporal.plan_allows("block", side, c) and not fused_temporal.plan_allows("mega", side, c)
    fused_temporal.set_plan({("t", 64): "wrap+blk", ("s", 32): "mega", ("s", 320): "wrap+blk"})
    assert fused_temporal.plan_allows("block", "t", 64) and fused_temporal.plan_allows("mega", "s", 32)
    assert fused_temporal.plan_allows("block", "s", 320) and not fused_temporal.plan_allows("mega", "s", 320)
    fused_temporal.set_plan({("t", 320): "wrap+blk"})
    assert fused_temporal.plan_allows("block", "t", 320) and not fused_temporal.plan_allows("block", "s", 320)
    with pytest.raises(ValueError):
        fused_temporal.set_plan({("t", 320): "subs"})
    fused_temporal.set_plan()
    assert fused_temporal._PLAN == fused_temporal.PLAN_DEFAULT


@pytest.fixture
def route_counts(monkeypatch):
    """Calls of the plain versions of kernels 10 and 13 (the routes a CPU
    forward takes)."""
    calls = collections.Counter()
    for mod, name in ((fused_block, "temporal_block_plain"), (fused_mega, "spatial_mega_plain")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("img", [False, True])
def test_unet_on_block_and_mega_routes_matches_jax(restore_plan, route_counts, img):
    """The tiny UNet (context width 128, 16x16 latent) with its widths (32,
    64) planned onto kernels 10 and 13 against the JAX UNet and against the
    port's default (sub-block) path. Kernel 13 runs where its gate admits the
    shape: the 3 spatial transformers of the 16x16 level (N = 256); the 8x8
    level's N = 64 keeps the wrapper path."""
    rng = np.random.default_rng(2)
    jm, params, tm, cfg = tiny_unet_twins(img)
    L = 77 + (4 if img else 0)
    x = rng.standard_normal((2, 4, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, L, cfg.context_dim)).astype(np.float32)
    t = np.array([700, 40], np.int32)
    ref = np.asarray(jax.jit(jm.apply, static_argnums=4)(params, jnp.asarray(x), jnp.asarray(t),
                                                         jnp.asarray(ctx), 16))
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), 16)
    with torch.no_grad():
        default = tm(*args)
        assert not route_counts
        fused_temporal.set_plan({("t", 32): "wrap+blk", ("t", 64): "wrap+blk", ("s", 32): "mega",
                                 ("s", 64): "mega"})
        got = tm(*args)
    # every temporal transformer of the tiny UNet (3 input, 1 middle, 3 output levels with attention); the
    # spatial transformers of the 16x16 level (1 input, 2 output)
    assert route_counts == {"temporal_block_plain": 7, "spatial_mega_plain": 3}
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), default.numpy(), atol=1e-5, rtol=1e-5)
