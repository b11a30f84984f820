"""Kernels 10 and 13 of the PyTorch port (``ops/fused_block.py``,
``ops/fused_mega.py``) and its per-shape dispatch plan, against the JAX
package on the CPU; the tile plans and the card-side host code of kernels
10-13 with the launches recorded.

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


@pytest.mark.parametrize("C,N", [(C, N) for C in range(64, 641, 64) for N in (256, 400, 1600, 2560, 4096)])
def test_spatial_plan_fits_the_card(C, N):
    """The tile plan of kernels 11 and 13 (``cuda_lib.spatial_plan``) at
    every width the gates admit: its shared memory is csrc/mega.cu's
    reckoning and fits the H100's 232,448 bytes; TM 64 up to C 320 and 32
    above (the second product's C / 128 output tiles held in registers); the
    ring an even number of slots, at least 4, and as deep as fits; the
    hidden chunk a multiple of 128 that divides 4C and lies in O; and the
    grid at N tokens a sample one block a
    (sample, query tile), the last tile of a sample ragged where TM does
    not divide N."""
    p = cuda_lib.spatial_plan(C)
    assert p.smem == cuda_lib.spatial_smem(p.tm, C, p.stages, p.hc) <= 232448
    assert p.tm == (64 if C <= 320 else 32) and C <= 128 * {64: 3, 32: 5}[p.tm]
    assert 4 <= p.stages <= cuda_lib.SPATIAL_MAX_STAGES and p.stages % 2 == 0
    assert cuda_lib.spatial_smem(p.tm, C, p.stages + 2, p.hc) > 232448 or p.stages == cuda_lib.SPATIAL_MAX_STAGES
    assert p.hc % 128 == 0 and (4 * C) % p.hc == 0 and p.hc <= max(C, 128)
    for samples in (1, 3, 128):
        grid = cuda_lib.spatial_grid(p, samples, N)
        tiles = grid // samples
        assert grid % samples == 0 and tiles * p.tm >= N > (tiles - 1) * p.tm


def _spatial_call_operands(C, Dc, img):
    lns, a1, a2, ff = _block_operands(C)
    g = torch.Generator().manual_seed(1)
    a2 = a2[:1] + (torch.randn(C, Dc, generator=g), torch.randn(C, Dc, generator=g)) + a2[3:]
    if img:
        a2 += (torch.randn(C, Dc, generator=g), torch.randn(C, Dc, generator=g))
    return lns, a1, a2, ff


def test_spatial_wrappers_hand_their_kernels_the_plan(monkeypatch):
    """The card-side host code of kernels 11 and 13, run on CPU tensors with
    every launch replaced by a recorder: the head runs as ``ds_ln_gemm``
    calls (the context K|V of each segment once per clip; kernel 13's
    GroupNorm apply -> proj_in with one sample per N rows; LN1 -> q|k|v),
    whose outputs the body reads; each wrapper encodes its weights' TMA maps
    once (five for kernel 11, six with w_out for kernel 13) and keeps them
    with the packed operands, hands ``ds_spatial_block`` /
    ``ds_mega_spatial`` the pointers in their order, the maps and
    ``spatial_plan``'s tile, and counts one launch; a second call reuses the
    maps. Where the kernel returns an error the wrapper raises and counts
    nothing."""
    calls = []
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "call", lambda name, *args: calls.append((name, args)))
    for fn in (fused_block.fused_spatial_block, fused_mega.spatial_mega):
        monkeypatch.setattr(fn, "launches", 0)
    bf, C, Dc, N, clips, frames = torch.bfloat16, 128, 256, 272, 2, 3
    lns, a1, a2, ff = _spatial_call_operands(C, Dc, img=True)
    op = fused_block.pack_spatial_block(lns, a1, a2, ff, dtype=bf)
    x = torch.zeros(clips * frames, N, C, dtype=bf)
    ctx = torch.zeros(clips, 77 + 16, Dc, dtype=bf)
    plan = cuda_lib.spatial_plan(C)

    def gemm_io(args):  # ds_ln_gemm's (x, M, K, ln, gn, rows/sample, w, N, y) of a recorded call
        return (args[0].value, args[1], args[2], args[3] is not None, args[6] is not None, args[8], args[11].value,
                args[12], args[15].value)
    for _ in range(2):
        out = fused_block.fused_spatial_block(x, ctx, lns, a1, a2, ff, heads=2, scale=0.125, operands=op)
        assert out.shape == x.shape
    names = ["ds_ln_gemm"] * 3 + ["ds_spatial_maps", "ds_spatial_block"] + ["ds_ln_gemm"] * 3 + ["ds_spatial_block"]
    assert [c[0] for c in calls] == names
    kv_t, kv_i, qkv = (gemm_io(c[1]) for c in calls[:3])
    T = clips * frames * N
    assert kv_t[1:6] == (clips * 77, Dc, False, False, 0) and kv_t[6:8] == (op.attn2.w_kv[0].data_ptr(), 2 * C)
    assert kv_i[1:6] == (clips * 16, Dc, False, False, 0) and kv_i[6:8] == (op.attn2.w_kv[1].data_ptr(), 2 * C)
    assert qkv[:6] == (x.data_ptr(), T, C, True, False, 0) and qkv[6:8] == (op.attn1.w_in.data_ptr(), 3 * C)
    maps_args, args = calls[3][1], calls[4][1]
    assert list(maps_args[0]) == [w.data_ptr() for w in fused_block.spatial_weights(op)] and maps_args[1:3] == (5, C)
    p = list(args[0])
    assert p[:5] == [x.data_ptr(), None, qkv[8], kv_t[8], kv_i[8]] and p[13] is None
    assert p[5:13] == [t.data_ptr() for t in (op.attn1.bo, op.attn2.ln_scale, op.attn2.ln_bias, op.attn2.bo,
                                              op.ff.ln_scale, op.ff.ln_bias, op.ff.b1, op.ff.b2)]
    assert args[1:9] == (clips * frames, N, C, frames, 77, 16, 0.125, 1e-5) and tuple(args[10:]) == tuple(plan)
    assert args[9].value == maps_args[3].value and calls[8][1][9].value == args[9].value
    assert fused_block.fused_spatial_block.launches == 2 and list(op.maps) == ["spatial"]

    calls.clear()
    w_in, b_in, w_out, b_out = torch.randn(C, C), torch.randn(C), torch.randn(C, C), torch.randn(C)
    lns, a1, a2, ff = _spatial_call_operands(C, Dc, img=False)
    mop = fused_mega.pack_spatial_mega(w_in, b_in, lns, a1, a2, ff, w_out, b_out, dtype=bf)
    x4 = torch.zeros(clips * frames, 16, 17, C, dtype=bf)
    ctx = torch.zeros(clips, 77, Dc, dtype=bf)
    mul, add = torch.ones(clips * frames, C), torch.zeros(clips * frames, C)
    out = fused_mega.spatial_mega(x4, ctx, mul, add, w_in, b_in, lns, a1, a2, ff, w_out, b_out, heads=2,
                                  scale=0.125, operands=mop)
    assert out.shape == x4.shape
    assert [c[0] for c in calls] == ["ds_ln_gemm"] * 3 + ["ds_spatial_maps", "ds_mega_spatial"]
    kv_t, head, qkv = (gemm_io(c[1]) for c in calls[:3])
    assert kv_t[1:6] == (clips * 77, Dc, False, False, 0)
    assert head[:6] == (x4.data_ptr(), T, C, False, True, N) and head[6:8] == (mop.w_in.data_ptr(), C)
    assert calls[1][1][13].value == mop.b_in.data_ptr()
    assert qkv[0] == head[8] and qkv[1:6] == (T, C, True, False, 0)
    maps_args, args = calls[3][1], calls[4][1]
    assert list(maps_args[0]) == [w.data_ptr() for w in fused_block.spatial_weights(mop.block) + [mop.w_out]]
    assert maps_args[1:3] == (6, C)
    p = list(args[0])
    assert p[:5] == [head[8], x4.data_ptr(), qkv[8], kv_t[8], None] and p[13] == mop.b_out.data_ptr()
    assert args[1:9] == (clips * frames, N, C, frames, 77, 0, 0.125, 1e-5) and tuple(args[10:]) == tuple(plan)
    assert fused_mega.spatial_mega.launches == 1 and list(mop.maps) == ["spatial"]

    # a non-zero return of the kernel reaches the wrapper, which raises
    monkeypatch.undo()
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    failing = types.SimpleNamespace(ds_ln_gemm=lambda *a: 0, ds_spatial_maps=lambda *a: 0,
                                    ds_spatial_block=lambda *a: 700, ds_mega_spatial=lambda *a: 719)
    monkeypatch.setattr(cuda_lib, "library", lambda: failing)
    for fn in (fused_block.fused_spatial_block, fused_mega.spatial_mega):
        monkeypatch.setattr(fn, "launches", 0)
    lns, a1, a2, ff = _spatial_call_operands(C, Dc, img=False)
    with pytest.raises(RuntimeError, match="ds_spatial_block launch failed: CUDA error 700"):
        fused_block.fused_spatial_block(x, ctx, lns, a1, a2, ff, heads=2, scale=0.125)
    with pytest.raises(RuntimeError, match="ds_mega_spatial launch failed: CUDA error 719"):
        fused_mega.spatial_mega(x4, ctx, mul, add, w_in, b_in, lns, a1, a2, ff, w_out, b_out, heads=2, scale=0.125,
                                operands=mop)
    assert fused_block.fused_spatial_block.launches == 0 and fused_mega.spatial_mega.launches == 0


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


def test_spatial_mega_matches_pallas_at_a_ragged_n(rng, interpret):
    """Kernel 13's plain version at N = 272 (17 x 16 tokens: no query tile
    of the card's kernel divides it, so a sample's last tile is ragged), 2
    clips of 2 frames, i2v context."""
    clips, frames, H, W, C, Dc, heads = 2, 2, 16, 17, 128, 128, 2
    x4 = (2.0 * rng.standard_normal((clips * frames, H, W, C)) + 0.5).astype(np.float32)
    ctx = rng.standard_normal((clips, 77 + 16, Dc)).astype(np.float32)
    gs, gb = _vec(rng, C, 1.0), _vec(rng, C)
    w_in, b_in, w_out, b_out = _w(rng, C, C), _vec(rng, C), _w(rng, C, C), _vec(rng, C)
    lns, a1, a2, ff = _block_weights(rng, C, Dc, True)
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
    assert fused_temporal._PLAN[torch.bfloat16] == fused_temporal.PLAN_DEFAULT


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
