"""``ds_ln_gemm``'s plain version and its host side, on the CPU.

``cuda_lib.ln_gemm_plain`` is the reference that ``chip_smoke.py`` holds the
Hopper GEMM (``dynamicscaler_tpu_torch/csrc/gemm.cu``) against on the card.
Here it is held (1) against an independent numpy version of every legal
(prologue, epilogue mode, row map) combination, at an M that is not a
multiple of the kernel's 128-row tile and with GroupNorm samples of 40 rows
(a tile straddles samples), in fp32 and in bf16 with the bf16 rounding
points emulated in numpy; (2) composed as the ops compose it, against the
JAX package's Pallas kernels in interpret mode: LN -> GEGLU then FF2 +
residual against K4 (``fused_temporal.py:350``), the GroupNorm head with the
A row map against ``_head_temporal`` (``fused_twrap.py:150``) and the tail
with the output row map against ``_tail_temporal`` (``:193``). Also: the
tile chooser (schedule, tile, shared memory as gemm.cu lays it out) at every
GEMM shape of the full-width batch-8 i2v and t2v forwards, the launch count
by schedule, the combinations ``ln_gemm`` refuses before a launch, and its
CPU routing.

Tolerances: fp32 against float64 numpy and against the JAX kernels, rtol
1e-5 with an absolute floor of 1e-5 of the output's largest magnitude (the
same rounding points, only the order of the sums differs; as
tests/test_torch_twrap.py). bf16 against numpy with the same bf16 rounding
points: a sum taken in another order can round one bf16 step the other way,
and the residual and GEGLU epilogues round twice, so two bf16 ulps (2^-6)
of the output's largest magnitude.
"""

import numpy as np
import pytest
import torch
from scipy.special import erf

import jax.numpy as jnp

from dynamicscaler_tpu.ops import fused_temporal as jtemporal
from dynamicscaler_tpu.ops import fused_twrap as jtwrap
from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.ops import fused_twrap as ttwrap
from dynamicscaler_tpu_torch.ops.cuda_lib import MODE_GEGLU, MODE_RESIDUAL, MODE_STORE, ln_gemm, ln_gemm_plain
from torch_port_helpers import i2v_transformers


@pytest.fixture
def interpret():
    jtemporal.set_mode("interpret")
    yield
    jtemporal.set_mode("auto")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol, atol=rtol * max(1.0, float(np.abs(ref).max())))


def _bf16(a):
    """Round float32 to the nearest bf16 (ties to even), as float32."""
    u = np.asarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _frame_rows(M, F, HW):
    r = np.arange(M)
    f, bhw = r % F, r // F
    return (bhw // HW * F + f) * HW + bhw % HW


def _reference(x, w, *, ln=None, eps=1e-5, gn=None, rps=0, frame_map=None, bias=None, residual=None,
               mode=MODE_STORE, rnd=lambda a: a):
    """ds_ln_gemm in numpy: float64 arithmetic, ``rnd`` at the rounding
    points (identity for fp32, bf16 rounding for bf16)."""
    M, K = x.shape
    N = w.shape[0]
    rows = _frame_rows(M, *frame_map) if frame_map else None
    a = x[rows] if gn is not None and rows is not None else x
    a = a.astype(np.float64)
    if ln is not None:
        mu = a.mean(-1, keepdims=True)
        var = np.maximum((a * a).mean(-1, keepdims=True) - mu * mu, 0.0)
        a = (a - mu) * (ln[0] / np.sqrt(var + eps)) + ln[1]
    elif gn is not None:
        s = np.arange(M) // rps
        a = a * gn[0][s] + gn[1][s]
    a = rnd(a.astype(np.float32)).astype(np.float64)
    acc = a @ w.astype(np.float64).T + (0.0 if bias is None else bias)
    if mode == MODE_GEGLU:
        val, gate = np.split(rnd(acc.astype(np.float32)).astype(np.float64), 2, axis=-1)
        return rnd((val * 0.5 * gate * (1.0 + erf(gate / np.sqrt(2.0)))).astype(np.float32))
    y = rnd(acc.astype(np.float32)).astype(np.float64)
    if mode == MODE_RESIDUAL:
        y = rnd((y + (residual if rows is None else residual[rows])).astype(np.float32))
    if rows is not None and gn is None:
        out = np.empty_like(y)
        out[rows] = y
        y = out
    return y


# (prologue, mode, frame map) combinations ds_ln_gemm takes
COMBOS = [("ln", MODE_STORE, None), ("ln", MODE_RESIDUAL, None), ("ln", MODE_GEGLU, None),
          ("gn", MODE_STORE, None), ("gn", MODE_STORE, "A"), (None, MODE_STORE, None),
          (None, MODE_RESIDUAL, None), (None, MODE_GEGLU, None), (None, MODE_RESIDUAL, "OUT")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pro,mode,fmap", COMBOS)
def test_ln_gemm_plain_matches_numpy(rng, pro, mode, fmap, dtype):
    """M = 200 rows without a map (a ragged last 128-row tile; GroupNorm
    samples of 40 rows, so tiles straddle samples); with a map 2 clips of
    F = 16 frames x HW = 24 (128 / F = 8 divides HW), K = 64, N = 128."""
    K, N = 64, 128
    M, F, HW = (2 * 16 * 24, 16, 24) if fmap else (200, 0, 0)
    rps = 16 * 24 if fmap else 40
    bf = dtype == torch.bfloat16
    rnd = _bf16 if bf else (lambda a: a)
    x = rnd((2.0 * rng.standard_normal((M, K)) + 0.5).astype(np.float32))
    w = rnd((rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32))
    bias = (0.1 * rng.standard_normal(N)).astype(np.float32)
    kw, ref_kw = dict(mode=mode, bias=_t(bias)), dict(mode=mode, bias=bias, rnd=rnd)
    if pro == "ln":
        ln = ((1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32), (0.1 * rng.standard_normal(K)).astype(np.float32))
        kw["ln"], ref_kw["ln"] = tuple(map(_t, ln)), ln
    if pro == "gn":
        gn = ((1.0 + 0.1 * rng.standard_normal((M // rps, K))).astype(np.float32),
              (0.1 * rng.standard_normal((M // rps, K))).astype(np.float32))
        kw.update(gn=tuple(map(_t, gn)), rows_per_sample=rps)
        ref_kw.update(gn=gn, rps=rps)
    if fmap:
        kw["frame_map"] = ref_kw["frame_map"] = (F, HW)
    if mode == MODE_RESIDUAL:
        res = rnd(rng.standard_normal((M, N)).astype(np.float32))
        kw["residual"], ref_kw["residual"] = _t(res, dtype), res
    got = ln_gemm_plain(_t(x, dtype), _t(w, dtype), **kw)
    ref = _reference(x, w, **ref_kw)
    assert got.dtype == dtype and got.shape == ref.shape == (M, N // 2 if mode == MODE_GEGLU else N)
    _close(got, ref, rtol=2.0 ** -6 if bf else 1e-5)


@pytest.mark.parametrize("shape", [(13, 16, 64), (4, 32, 128)])
def test_ln_geglu_then_ff2_matches_k4(rng, interpret, shape):
    """LN -> GEGLU, then FF2 + residual, as ``fused_ln_geglu`` composes the
    GEMM on the card, against K4 (208 rows: a ragged 128-row tile)."""
    C = shape[-1]
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    s, b = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32)
    w1 = (rng.standard_normal((C, 8 * C)) / np.sqrt(C)).astype(np.float32)
    w2 = (rng.standard_normal((4 * C, C)) / np.sqrt(4 * C)).astype(np.float32)
    b1, b2 = (0.1 * rng.standard_normal(8 * C)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = jtemporal.fused_ln_geglu(*map(jnp.asarray, (x, s, b, w1, b1, w2, b2)))
    x2d = _t(x).reshape(-1, C)
    inner = ln_gemm_plain(x2d, _t(w1.T), ln=(_t(s), _t(b)), bias=_t(b1), mode=MODE_GEGLU)
    got = ln_gemm_plain(inner, _t(w2.T), bias=_t(b2), residual=x2d, mode=MODE_RESIDUAL)
    _close(got.reshape(shape), ref)


@pytest.mark.parametrize("B,F,H,W,C,Ci", [(2, 8, 4, 4, 64, 64), (1, 16, 2, 4, 64, 128), (1, 16, 5, 5, 64, 64),
                                           (1, 16, 10, 10, 64, 64), (2, 8, 5, 5, 64, 64), (1, 8, 10, 10, 64, 64),
                                           (1, 16, 6, 6, 64, 64)])
def test_gn_head_and_tail_with_row_maps_match_pallas(rng, interpret, B, F, H, W, C, Ci):
    """The GroupNorm head with the A row map against ``_head_temporal`` and
    the tail with the output row map against ``_tail_temporal``, at shapes
    the kernel's TMA box takes (F divides 128, H*W a multiple of 128 / F)
    and at those where the prologue pass gathers the rows instead (H*W 25,
    100 and 36: a 40x40 latent's two deepest levels, 384x384's)."""
    assert jtwrap._enabled("t", C)
    x5 = (2.0 * rng.standard_normal((B, F, H, W, C)) + 0.5).astype(np.float32)
    s, b = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32)
    w_in, b_in = (rng.standard_normal((C, Ci)) / np.sqrt(C)).astype(np.float32), (0.1 * rng.standard_normal(Ci)).astype(np.float32)
    w_out, b_out = (rng.standard_normal((Ci, C)) / np.sqrt(Ci)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32)
    jh = jtwrap.gn_proj_in_temporal(*map(jnp.asarray, (x5, s, b, w_in, b_in)))
    mul, add = ttwrap.group_norm_fold(_t(x5), _t(s), _t(b))
    th = ln_gemm_plain(_t(x5).reshape(-1, C), _t(w_in.T), gn=(mul, add), rows_per_sample=F * H * W,
                       frame_map=(F, H * W), bias=_t(b_in))
    _close(th.reshape(B * H * W, F, Ci), jh)
    y = np.tanh(np.asarray(jh))
    jt = jtwrap.tail_temporal(*map(jnp.asarray, (y, x5, w_out, b_out)))
    tt = ln_gemm_plain(_t(y).reshape(-1, Ci), _t(w_out.T), frame_map=(F, H * W), bias=_t(b_out),
                       residual=_t(x5).reshape(-1, C), mode=MODE_RESIDUAL)
    _close(tt.reshape(x5.shape), jt)


def _forward_gemms(side, C, kind="i2v"):
    """Every ds_ln_gemm call (M, K, N, mode, kwargs of the prologue and map)
    of the full-width UNet's transformers at plan key (side, C), batch 8, 16
    frames, a 40x64 latent, at every level the plan can route them to: the
    wrapper head and tail, the sub-block GEMMs, the context K/V per clip
    (the image tokens' only in i2v; the t2v UNet has the same widths).
    ``kind`` "dc": DynamiCrafter 1024's forward at its 72x128 latent (the
    same UNet layout, each level 1.8 x 2 times the tokens), whose context
    K/V the sub-block path projects on every frame's row: 8 x 16 x 77 text
    and 8 x 16 x 16 image tokens (the shapes phase 14 records)."""
    calls = []
    for s, c, inner, _, H, W in i2v_transformers():
        if (s, inner) != (side, C):
            continue
        if kind == "dc":
            H, W = H * 72 // 40, W * 2
        T, HW = 8 * 16 * H * W, H * W
        ln = dict(ln=True)
        head = dict(gn=True, rows_per_sample=16 * HW if side == "t" else HW,
                    **({"frame_map": (16, HW)} if side == "t" else {}))
        calls += [(T, c, inner, MODE_STORE, head),
                  (T, inner, 3 * inner, MODE_STORE, ln), (T, inner, inner, MODE_RESIDUAL, {}),
                  (T, inner, 8 * inner, MODE_GEGLU, ln), (T, 4 * inner, inner, MODE_RESIDUAL, {}),
                  (T, inner, c, MODE_RESIDUAL, {"frame_map": (16, HW)} if side == "t" else {})]
        if side == "s":
            rows = 8 * 16 if kind == "dc" else 8
            calls += [(T, inner, inner, MODE_STORE, ln), (rows * 77, 1024, 2 * inner, MODE_STORE, {})]
            if kind != "t2v":
                calls.append((rows * 16, 1024, 2 * inner, MODE_STORE, {}))
    return calls


def _smem_reckoned(schedule, bn, stages):
    """A ds_ln_gemm block's shared memory as csrc/gemm.cu lays it out: the
    1024-byte alignment pad, the ring (A 128 x 64 and B bn x 64 bf16 a
    stage, full and empty mbarriers); cooperative: one bf16 staging tile of
    128 rows of one wgmma product's columns + 8 (bn up to 256; BN 320 is two
    160-column products, staged one after the other); ping-pong: each
    warpgroup's 128 x bn bf16 output tile (where the residual tile lands too:
    64-column boxes, or 32-column ones at bn 160, back to back) and its
    residual and output-free mbarriers."""
    ring = stages * (128 * 64 * 2 + bn * 64 * 2)
    if schedule == "pingpong":
        return 1024 + ring + 2 * (128 * bn * 2) + 8 * (2 * stages + 2 * 2)
    staged = {64: 64, 128: 128, 256: 256, 320: 160}[bn]
    return 1024 + ring + 128 * (staged + 8) * 2 + 8 * (2 * stages)


_SIDES = [("t", 320), ("t", 512), ("t", 640), ("t", 1280), ("s", 320), ("s", 640), ("s", 1280)]


@pytest.mark.parametrize("side,C,kind", [pytest.param(s, c, "i2v", id=f"{s}-{c}") for s, c in _SIDES]
                         + [pytest.param(s, c, "t2v", id=f"t2v-{s}-{c}") for s, c in _SIDES]
                         + [pytest.param(s, c, "dc", id=f"dc-{s}-{c}") for s, c in _SIDES])
def test_gemm_tile_fits_every_forward_shape(side, C, kind):
    """Every GEMM shape of the full-width batch-8 i2v (and t2v, and
    DynamiCrafter 72x128) forward at
    (side, C) is a combination ln_gemm takes and maps to a named schedule
    with a legal tile (cooperative BN 64, 128, 256 or 320, ping-pong BN 128
    or 160;
    GEGLU pairs value and gate columns within a tile) whose shared memory,
    reckoned as gemm.cu lays it out, fits in the H100's 232,448 bytes a
    block; the planner's choice within either schedule fits too."""
    calls = _forward_gemms(side, C, kind)
    assert calls
    for M, K, N, mode, opts in calls:
        cuda_lib._check_ln_gemm(M, K, N, ln=(1, 1) if opts.get("ln") else None,
                                gn=(1, 1) if opts.get("gn") else None,
                                rows_per_sample=opts.get("rows_per_sample", 0), frame_map=opts.get("frame_map"),
                                residual=1 if mode == MODE_RESIDUAL else None, mode=mode)
        chosen = cuda_lib.gemm_tile(M, K, N, mode)
        tiles = [cuda_lib.gemm_tile(M, K, N, mode, schedule=s) for s in ("cooperative", "pingpong")]
        assert chosen in tiles
        for tile, schedule in zip(tiles, ("cooperative", "pingpong")):
            assert tile.schedule == schedule
            assert tile.block_n in cuda_lib.GEMM_BLOCK_N[schedule] and 2 <= tile.stages <= cuda_lib.GEMM_MAX_STAGES
            assert tile.smem == cuda_lib.gemm_smem(tile.block_n, tile.stages, schedule) \
                == _smem_reckoned(schedule, tile.block_n, tile.stages) <= 232448
            assert mode != MODE_GEGLU or (N // 2) % (tile.block_n // 2) == 0


@pytest.mark.parametrize("M,K,N,mode,schedule", [
    (327680, 320, 320, MODE_RESIDUAL, "pingpong"),
    (81920, 640, 640, MODE_STORE, "pingpong"),
    (327680, 320, 2560, MODE_GEGLU, "cooperative"),
    (5120, 5120, 1280, MODE_RESIDUAL, "cooperative"),
])
def test_ln_gemm_counts_launches_by_schedule(monkeypatch, M, K, N, mode, schedule):
    """``ln_gemm`` launches the planner's schedule through its C entry point
    (``ds_ln_gemm`` cooperative, ``ds_ln_gemm_pingpong``) with its tile, and
    counts the launch under that schedule in ``ln_gemm.launches``;
    ``cuda_lib.call`` stubbed, so the operands stay on the CPU (a few rows
    stand for M: the planner and the launch read only the shapes)."""
    tile = cuda_lib.gemm_tile(M, K, N, mode)
    assert tile.schedule == schedule
    calls = []
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "call", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(cuda_lib.ln_gemm, "launches", {"cooperative": 3, "pingpong": 5})
    monkeypatch.setattr(cuda_lib, "gemm_tile", lambda *a, **k: tile)  # the plan of the full shape
    x, w = torch.zeros(128, K, dtype=torch.bfloat16), torch.zeros(N, K, dtype=torch.bfloat16)
    res = torch.zeros(128, N, dtype=torch.bfloat16) if mode == MODE_RESIDUAL else None
    for _ in range(2):
        ln_gemm(x, w, residual=res, mode=mode)
    assert [name for name, _ in calls] == [{"cooperative": "ds_ln_gemm", "pingpong": "ds_ln_gemm_pingpong"}[schedule]] * 2
    assert all(args[-2:] == (tile.block_n, tile.stages) for _, args in calls)
    want = {"cooperative": 3, "pingpong": 5}
    want[schedule] += 2
    assert cuda_lib.ln_gemm.launches == want


_TILES = [(s, bn) for s, widths in cuda_lib.GEMM_BLOCK_N.items() for bn in widths]


@pytest.mark.parametrize("schedule,bn", _TILES, ids=[f"{s}-{bn}" for s, bn in _TILES])
def test_ln_gemm_counts_launches_by_width(monkeypatch, schedule, bn):
    """``ln_gemm`` counts each bf16 launch under its (schedule, BN) in
    ``ln_gemm.launches_by_width`` beside the count by schedule, and hands
    the C entry point that width; ``cuda_lib.call`` stubbed, the planner
    forced to the tile."""
    tile = cuda_lib.GemmTile(bn, 2, cuda_lib.gemm_smem(bn, 2, schedule), schedule)
    calls = []
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "call", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(cuda_lib, "gemm_tile", lambda *a, **k: tile)
    monkeypatch.setattr(cuda_lib.ln_gemm, "launches", {"cooperative": 3, "pingpong": 5})
    monkeypatch.setattr(cuda_lib.ln_gemm, "launches_by_width", {t: 1 for t in _TILES})
    x, w = torch.zeros(128, 320, dtype=torch.bfloat16), torch.zeros(640, 320, dtype=torch.bfloat16)
    for _ in range(3):
        ln_gemm(x, w, mode=MODE_GEGLU)
    ln_gemm(x.float(), w.float())  # fp32: ds_ln_gemm_f32, counted by neither
    entry = {"cooperative": "ds_ln_gemm", "pingpong": "ds_ln_gemm_pingpong"}[schedule]
    assert [name for name, _ in calls[:3]] == [entry] * 3
    assert calls[-1][0] == "ds_ln_gemm_f32" and all(args[-2] == bn for _, args in calls[:3])
    assert cuda_lib.ln_gemm.launches_by_width == {t: 1 + 3 * (t == (schedule, bn)) for t in _TILES}
    assert cuda_lib.ln_gemm.launches == {"cooperative": 3 + 3 * (schedule == "cooperative"),
                                         "pingpong": 5 + 3 * (schedule == "pingpong")}


@pytest.mark.parametrize("schedule,bn", [("cooperative", 320), ("pingpong", 160)])
@pytest.mark.parametrize("N", [480, 640, 1280, 1536, 2048, 2560, 5120, 10240])
def test_gemm_tile_pairs_geglu_columns_where_the_width_divides(schedule, bn, N):
    """GEGLU pairs bn / 2 value columns with as many gate columns in a tile
    (cooperative 320: 160 + 160, ping-pong 160: 80 + 80), so gemm_tile
    admits the 160-column widths only where bn / 2 divides N / 2 (N / 2 =
    1280, 2560, 5120: every GEGLU of the UNets; 240 admits 80 and not 160;
    768 and 1024 neither), and its free choice within the schedule is
    always a width that pairs."""
    pairs = (N // 2) % (bn // 2) == 0
    if pairs:
        tile = cuda_lib.gemm_tile(327680, 320, N, MODE_GEGLU, schedule=schedule, block_n=bn)
        assert (tile.schedule, tile.block_n) == (schedule, bn)
        assert tile.smem == _smem_reckoned(schedule, bn, tile.stages) <= 232448
    else:
        with pytest.raises(ValueError, match="no"):
            cuda_lib.gemm_tile(327680, 320, N, MODE_GEGLU, schedule=schedule, block_n=bn)
    assert pairs == (N in (480, 640, 1280, 2560, 5120, 10240) if bn == 160 else N in (640, 1280, 2560, 5120, 10240))
    if any((N // 2) % (w // 2) == 0 for w in cuda_lib.GEMM_BLOCK_N[schedule]):
        free = cuda_lib.gemm_tile(327680, 320, N, MODE_GEGLU, schedule=schedule)
        assert (N // 2) % (free.block_n // 2) == 0


@pytest.mark.parametrize("F,HW", [(16, 25), (16, 36), (16, 100), (8, 25), (8, 36), (8, 100), (3, 32), (16, 12)])
def test_check_ln_gemm_takes_any_head_geometry(F, HW):
    """The GroupNorm head (kernel 5) takes every clip geometry whose samples
    are whole clips: its TMA box where it fits the clip, the gathering
    prologue pass elsewhere."""
    M = 2 * F * HW
    cuda_lib._check_ln_gemm(M, 64, 128, ln=None, gn=(1, 1), rows_per_sample=F * HW, frame_map=(F, HW),
                            residual=None, mode=MODE_STORE)


# (the ids keep each case's name from before the head took every clip geometry)
@pytest.mark.parametrize("case,match", [
    pytest.param(dict(gn=True, rows_per_sample=64, frame_map=(16, 8)), "rows_per_sample",
                 id="case2-rows_per_sample"),
    pytest.param(dict(mode=MODE_RESIDUAL), "residual", id="case3-residual"),
    pytest.param(dict(residual=True), "residual", id="case4-residual"),
    pytest.param(dict(K=48), "K % 32", id="case5-K % 32"),
    pytest.param(dict(ln=True, frame_map=(16, 8)), "frame_map", id="case6-frame_map"),
    pytest.param(dict(gn=True, rows_per_sample=128, mode=MODE_GEGLU), "GroupNorm prologue takes mode 0",
                 id="case7-GroupNorm prologue takes mode 0"),
])
def test_ln_gemm_refuses_what_the_kernel_cannot_take(case, match):
    """Combinations the kernel cannot take raise ValueError in ln_gemm
    before any launch, on every device (here CPU tensors)."""
    case = dict(case)
    M, K, N = 384, case.pop("K", 64), 128
    mode = case.pop("mode", MODE_STORE)
    kw = dict(mode=mode, frame_map=case.pop("frame_map", None))
    if case.pop("ln", False):
        kw["ln"] = (torch.ones(K), torch.zeros(K))
    if case.pop("gn", False):
        rps = case.pop("rows_per_sample")
        kw.update(gn=(torch.ones(M // rps, K), torch.zeros(M // rps, K)), rows_per_sample=rps)
    if case.pop("residual", False):
        kw["residual"] = torch.zeros(M, N)
    with pytest.raises(ValueError, match=match):
        ln_gemm(torch.zeros(M, K), torch.zeros(N, K), **kw)


def test_ln_gemm_takes_the_plain_version_on_cpu(rng):
    """CPU tensors take ln_gemm_plain, bit for bit."""
    x, w = _t(rng.standard_normal((130, 64))), _t(rng.standard_normal((128, 64)))
    ln, b1 = (_t(1 + 0.1 * rng.standard_normal(64)), _t(rng.standard_normal(64))), _t(rng.standard_normal(128))
    assert torch.equal(ln_gemm(x, w, ln=ln, bias=b1, mode=MODE_GEGLU),
                       ln_gemm_plain(x, w, ln=ln, bias=b1, mode=MODE_GEGLU))
