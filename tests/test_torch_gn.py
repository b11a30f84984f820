"""GroupNorm [-> SiLU] in one call (``fused_twrap.gn_silu`` ->
``csrc/gn_silu.cu::ds_group_norm_silu``) and its route plan
(``cuda_lib.gn_plan``), on the CPU.

* the plan at every ``gn_silu`` call of the full-width forwards (enumerated
  by ``unet3d.gn_silu_calls`` from ``unet_layout``, which is held against
  the calls a tiny UNet forward really makes) and of the tiled VAE's encode
  and decode (recorded from a shape-only run on the ``meta`` device);
* the one-call plain version (the plain fold, then the plain apply) against
  the JAX ``gn_silu`` with its Pallas kernel in interpret mode, rtol 1e-5
  with an absolute floor of 1e-5 of the output's largest magnitude (both
  sides compute in fp32 with the same rounding points and differ only in
  the order of the statistics' sums);
* a group whose fast variance is inf - inf (x^2 overflows) NaN in the
  plain fold and output as in the JAX fold and ``gn_silu``, and in the
  cluster route's model (the kernels keep the NaN on the card);
* a numpy model of the cluster route's reduction order (per thread, row
  lanes, the group's channels, then the cluster's blocks in rank order),
  within 1e-5 of ``group_norm_fold_plain``'s largest magnitude and bit for
  bit the same on a repeat;
* the same for the fp32 grid route (``gn_grid_kernel``: streamed rows then
  the slab per thread, row lanes, the group's channels, then the sample's
  blocks in the kernel's fixed order), at passes of several samples and at
  a sample larger than the card's shared memory, and, with the fp32 apply,
  against the JAX ``gn_silu`` in interpret mode at a per-frame and a
  per-clip shape;
* at 2-byte elements the plan field for field the one before the grid
  route, at every call of the full-width forwards and the VAE;
* the wrapper's host code on CPU tensors with the launch replaced by a
  recorder: one ``ds_group_norm_silu`` call carrying the plan (a plan
  handed in taken as it is; on the grid route route 2 and its scratch), no
  ``ds_gn_stats`` call from Python, and a raise on a non-zero return.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamicscaler_tpu.ops import fused_temporal as jtemporal
from dynamicscaler_tpu.ops import fused_twrap as jtwrap
from dynamicscaler_tpu_torch.config import tiny_test_config, videocrafter2_t2v, videocrafter_i2v
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.models.unet3d import UNet3D, gn_silu_calls
from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.ops import fused_twrap as ttwrap
from dynamicscaler_tpu_torch.pipelines.tiled_vae import ring_aware_decode, tiled_vae_encode

SMEM_MAX = 232448  # dynamic shared memory a block may have on the H100
REAL_CALL = cuda_lib.call


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _record_gn_silu(monkeypatch):
    """Replace ``fused_twrap.gn_silu`` by a recorder of (samples, rows a
    sample, channels) that returns an empty tensor of x's shape."""
    calls = []

    def rec(x, gn_scale, gn_bias, **kw):
        B, C = x.shape[0], x.shape[-1]
        calls.append((B, x.numel() // (B * C), C))
        return torch.empty_like(x)
    monkeypatch.setattr(ttwrap, "gn_silu", rec)
    return calls


def _vae_calls(monkeypatch, what):
    """The gn_silu calls of the i2v model's tiled VAE encode of the 512x1024
    panorama of the i2v path, or of the ring decode of one of its 64x128
    latent frames, from a run on the ``meta`` device (shapes only)."""
    calls = _record_gn_silu(monkeypatch)
    model = LatentVideoDiffusion.build(videocrafter_i2v("bfloat16"), "meta")
    model.vae.to(torch.bfloat16)
    if what == "encode":
        tiled_vae_encode(model, torch.empty((512, 1024, 3), device="meta"))
    else:
        ring_aware_decode(model, torch.empty((1, 1, 64, 128, 4), device="meta"))
    return calls


# where -> (its gn_silu calls, the routes they take: a decoded frame's
# smallest slab, 64 x 144 latents at C 512, is 9.4 MB)
FORWARDS = {
    "i2v UNet batch 8": (lambda mp: gn_silu_calls(videocrafter_i2v("bfloat16").unet, 8, 16, 40, 64),
                         {"cluster", "split"}),
    "t2v UNet batch 2": (lambda mp: gn_silu_calls(videocrafter2_t2v("bfloat16").unet, 2, 16, 40, 64),
                         {"cluster", "split"}),
    "i2v tiled VAE encode": (lambda mp: _vae_calls(mp, "encode"), {"cluster", "split"}),
    "i2v ring decode": (lambda mp: _vae_calls(mp, "decode"), {"split"}),
}


@pytest.mark.parametrize("where", list(FORWARDS))
def test_gn_plan_at_every_gn_silu_call(monkeypatch, where):
    """The route plan at every call: "cluster" exactly where two of a
    sample's slabs (the one normalised, the next one landing) fit 16 blocks'
    shared memory beside their reduction arrays, at most 16 blocks a
    cluster, row ranges that cover the sample with none empty, shared memory
    within the card's 232,448 bytes a block; on the split route the
    statistics kernel's own row splits."""
    enumerate_calls, want_routes = FORWARDS[where]
    calls = enumerate_calls(monkeypatch)
    if where == "i2v UNet batch 8":
        assert len(calls) == 133  # 22 ResBlocks x (2 + 4 temporal conv norms) + the out norm
    routes = set()
    for B, M, C in calls:
        plan = cuda_lib.gn_plan(B, M, C, 32)
        routes.add(plan.route)
        fit = (SMEM_MAX - cuda_lib.gn_cluster_smem(0, C, 32)) // (2 * C)
        assert plan.route == ("cluster" if -(-M // fit) <= 16 else "split"), (B, M, C, plan)
        assert 0 < plan.smem <= SMEM_MAX
        if plan.route == "cluster":
            assert 1 <= plan.cs <= 16 and plan.splits == 0
            assert (plan.cs - 1) * plan.rows < M <= plan.cs * plan.rows
            assert plan.smem == cuda_lib.gn_cluster_smem(plan.rows, C, 32)
        else:
            assert plan.cs == 0 and plan.splits == cuda_lib.gn_stats_splits(B, M, C) == ttwrap.gn_stats_splits(B, M, C)
            assert (plan.splits - 1) * plan.rows < M <= plan.splits * plan.rows
    assert routes == want_routes


@pytest.mark.parametrize("img", [False, True])
def test_gn_silu_calls_match_a_unet_forward(monkeypatch, img):
    """``unet3d.gn_silu_calls`` lists the gn_silu calls a (tiny) UNet
    forward makes, in order."""
    torch.manual_seed(0)
    cfg = tiny_test_config(img).unet
    unet = UNet3D(cfg).eval()
    calls = _record_gn_silu(monkeypatch)
    B, Fn, H, W = 2, 4, 6, 10
    with torch.no_grad():
        unet(torch.randn(B, Fn, H, W, 4), torch.full((B,), 10), torch.randn(B, 77 + 4 * img, cfg.context_dim))
    assert calls == gn_silu_calls(cfg, B, Fn, H, W)


@pytest.fixture
def interpret():
    jtemporal.set_mode("interpret")
    jtwrap.set_gnsilu_sites("unet,vae")
    yield
    jtemporal.set_mode("auto")
    jtwrap.set_gnsilu_sites("")


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape", [(8, 6, 5, 64), (2, 4, 6, 5, 96)], ids=["per-frame", "per-clip"])
def test_one_call_plain_matches_pallas(rng, interpret, shape, eps, act):
    """The one-call plain version (the plain fold, then the plain apply)
    against the JAX gn_silu through its Pallas kernel; its folded vectors
    against the JAX group_norm_fold."""
    C = shape[-1]
    x = (3.0 * rng.standard_normal(shape) + 1.0).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = np.asarray(jtwrap.gn_silu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=eps, act=act, site="unet"))
    y, (mul, add) = ttwrap.gn_silu(_t(x), _t(s), _t(b), eps=eps, act=act, vectors=True)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    jm, ja = jtwrap.group_norm_fold(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=eps)
    for got, want in ((mul, jm), (add, ja)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def _cluster_model(x, scale, bias, G, eps):
    """The cluster route's statistics as ``gn_cluster_kernel`` orders its
    fp32 sums: per thread over its rows in order (lanes rows apart), the row
    lanes in order, the group's channels in order, the cluster's blocks in
    rank order; then the fold. Returns (mul, add) [B, C] float32."""
    f32 = np.float32
    B, M, C = x.shape
    plan = cuda_lib.gn_plan(B, M, C, G)
    assert plan.route == "cluster"
    lanes = cuda_lib.gn_cluster_lanes(C)
    cg = C // G
    mul, add = np.zeros((B, C), f32), np.zeros((B, C), f32)
    for b in range(B):
        parts = []
        for rank in range(plan.cs):
            slab = x[b, rank * plan.rows:(rank + 1) * plan.rows]
            assert len(slab) > 0
            red = np.zeros((2, lanes, C), f32)
            for rl in range(lanes):
                for row in slab[rl::lanes]:  # a thread's rows, in order
                    red[0, rl] += row
                    red[1, rl] += row * row  # exact in fp32: row is bf16-representable
            lane_sum = np.zeros((2, C), f32)
            for rl in range(lanes):
                lane_sum += red[:, rl]
            gpart = np.zeros((2, G), f32)
            for j in range(cg):
                gpart += lane_sum[:, j::cg]
            parts.append(gpart)
        tot = np.zeros((2, G), f32)
        for gpart in parts:  # rank order
            tot += gpart
        n = f32(M * cg)
        mean = tot[0] / n
        rstd = f32(1.0) / np.sqrt(np.maximum(f32(0.0), tot[1] / n - mean * mean) + f32(eps))
        m = np.repeat(rstd, cg) * scale
        mul[b], add[b] = m, bias - np.repeat(mean, cg) * m
    return mul, add


@pytest.mark.parametrize("B,M,C", [(2, 3400, 64), (1, 700, 320), (1, 90, 2560), (2, 400, 640)])
def test_cluster_route_reduction_model_matches_the_plain_fold(rng, B, M, C):
    """The cluster route's reduction order gives the plain fold's vectors
    within 1e-5 of their largest magnitude, and the same bits every run
    (each sample over a cluster of 3 blocks; C 64: 64 row lanes; C 320: a
    chunk of 8 channels straddles two groups of 10; C 2560: one row lane;
    M 400 at C 640: a ragged last block)."""
    bf = torch.bfloat16
    x = (2.0 * rng.standard_normal((B, M, C)) + 0.5).astype(np.float32)
    x = torch.from_numpy(x).to(bf).float().numpy()  # bf16 values, as the kernel reads them
    s = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)).to(bf).float().numpy()
    b = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32)).to(bf).float().numpy()
    plan = cuda_lib.gn_plan(B, M, C, 32)
    assert plan.route == "cluster" and plan.cs > 1
    mul, add = _cluster_model(x, s, b, 32, 1e-5)
    pm, pa = ttwrap.group_norm_fold_plain(_t(x), _t(s), _t(b), 32, 1e-5)
    for got, want in ((mul, pm.numpy()), (add, pa.numpy())):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    again = _cluster_model(x, s, b, 32, 1e-5)
    assert mul.tobytes() == again[0].tobytes() and add.tobytes() == again[1].tobytes()


def _overflowing(rng, B, M, C):
    """x [B, M, C] whose statistics the fast variance cannot take: sample 0's
    group 0 at 1e20 (x^2 overflows: inf - inf), one inf in sample 1's group
    3, and sample 1's group 10 constant at 3 (an exact zero variance)."""
    cg = C // 32
    x = (2.0 * rng.standard_normal((B, M, C)) + 0.5).astype(np.float32)
    x[0, :, :cg] = 1e20
    x[1, M // 2, 3 * cg] = np.inf
    x[1, :, 10 * cg:11 * cg] = 3.0
    return x


def test_a_nan_variance_gives_nan_as_in_jax(rng, interpret):
    """A group whose fast variance is inf - inf gives NaN in the plain fold
    and its output, as the JAX fold and gn_silu do (``jnp.maximum`` and
    ``clamp_min`` keep a NaN; the kernels' statistics keep it too, through
    ``hopper::fast_variance``, and ``chip_smoke.py`` holds them to this on
    the card); the constant group's zero variance and every other group
    within the one-call tolerance; the cluster route's reduction model gives
    NaN at the same places."""
    B, M, C = 2, 700, 320
    x = _overflowing(rng, B, M, C)
    s = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = np.asarray(jtwrap.gn_silu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=1e-5, site="unet"))
    y, (mul, add) = ttwrap.gn_silu(_t(x), _t(s), _t(b), eps=1e-5, vectors=True)
    y = y.numpy()
    nan = np.zeros((B, C), bool)
    nan[0, :10], nan[1, 30:40] = True, True
    assert (np.isnan(ref) == nan[:, None, :]).all() and (np.isnan(y) == np.isnan(ref)).all()
    fin = ~np.isnan(ref)
    np.testing.assert_allclose(y[fin], ref[fin], rtol=1e-5, atol=1e-5 * float(np.abs(ref[fin]).max()))
    jm, ja = jtwrap.group_norm_fold(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=1e-5)
    with np.errstate(over="ignore", invalid="ignore"):
        model = _cluster_model(x, s, b, 32, 1e-5)
    for got, want, mod in ((mul.numpy(), np.asarray(jm), model[0]), (add.numpy(), np.asarray(ja), model[1])):
        assert (np.isnan(want) == nan).all() and (np.isnan(got) == nan).all() and (np.isnan(mod) == nan).all()
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-5, atol=1e-5 * float(np.abs(want[~nan]).max()))


@pytest.mark.parametrize("shape,route", [((16, 6, 10, 320), "cluster"), ((2, 16, 40, 64, 320), "split")])
def test_gn_silu_makes_one_call_with_its_plan(monkeypatch, shape, route):
    """On a CUDA tensor ``gn_silu`` makes exactly one ``cuda_lib.call``,
    ``ds_group_norm_silu``, carrying ``gn_plan``'s fields (route, blocks a
    cluster, rows, shared memory, splits) and a scratch buffer only where
    the route needs one; no ``ds_gn_stats`` call from Python. A non-zero
    return raises and counts nothing."""
    calls = []
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "call", lambda name, *args: calls.append((name, args)))
    for fn in (ttwrap.gn_silu, ttwrap.group_norm_fold, ttwrap.gn_silu_apply):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(ttwrap.gn_silu, "launches_split", 0)
    bf = torch.bfloat16
    x = torch.zeros(shape, dtype=bf)
    B, C = shape[0], shape[-1]
    M = x.numel() // (B * C)
    plan = cuda_lib.gn_plan(B, M, C, 32)
    assert plan.route == route
    y = ttwrap.gn_silu(x, torch.ones(C, dtype=bf), torch.zeros(C, dtype=bf), eps=1e-6, act=False)
    assert y.shape == x.shape and y.dtype == bf
    assert [c[0] for c in calls] == ["ds_group_norm_silu"]
    args = calls[0][1]
    assert args[1:5] == (B, M, C, 32) and args[7:10] == (0, 1e-6, 0)  # bf16 vectors, eps, no SiLU
    assert args[10:15] == (int(route == "split"), plan.cs, plan.rows, plan.smem, plan.splits)
    assert (args[15] is None) == (route == "cluster")
    split = int(route == "split")
    assert (ttwrap.gn_silu.launches, ttwrap.gn_silu.launches_split) == (1, split)
    assert ttwrap.group_norm_fold.launches == ttwrap.gn_silu_apply.launches == 0

    calls.clear()
    _, (mul, add) = ttwrap.gn_silu(x, torch.ones(C), torch.zeros(C), vectors=True)
    assert calls[0][1][7] == 1 and calls[0][1][15] is not None  # fp32 vectors; the folded vectors kept
    assert mul.shape == add.shape == (B, C) and mul.dtype == torch.float32

    monkeypatch.setattr(cuda_lib, "call", REAL_CALL)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_lib, "library", lambda: types.SimpleNamespace(ds_group_norm_silu=lambda *a: 1))
    monkeypatch.setattr(ttwrap.gn_silu, "launches", 0)
    monkeypatch.setattr(ttwrap.gn_silu, "launches_split", 0)
    with pytest.raises(RuntimeError, match="ds_group_norm_silu launch failed: CUDA error 1"):
        ttwrap.gn_silu(x, torch.ones(C, dtype=bf), torch.zeros(C, dtype=bf))
    assert ttwrap.gn_silu.launches == ttwrap.gn_silu.launches_split == 0


@pytest.mark.parametrize("B,M,C,G", [(1, 10, 12, 4), (1, 10, 6152, 8), (0, 10, 64, 32), (1, 0, 64, 32),
                                     (1, 10, 96, 64)])
def test_gn_plan_refuses_what_the_kernel_does_not_take(B, M, C, G):
    with pytest.raises(ValueError, match="gn_plan"):
        cuda_lib.gn_plan(B, M, C, G)


# ---------------------------------------------------------------------------
# the grid route (fp32): gn_grid_kernel's reduction order, modelled
# ---------------------------------------------------------------------------


def _grid_model(x, scale, bias, G, eps, plan):
    """The grid route's statistics as ``gn_grid_kernel`` orders its fp32
    sums: block q of a sample takes rows [q * rows, ...); a thread sums its
    rows (lanes rows apart) in order, first the streamed rows past the
    ``held`` ones, then the held ones from shared memory; the row lanes in
    order, the group's channels in order; then the sample's ``cs`` blocks'
    partials, every 8th block's by each of 8 threads into four sums by 32
    blocks (the tail into the first), added (0 + 1) + (2 + 3), the 8 added by
    the kernel's shuffle tree ((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7));
    then the fold. Returns (mul, add) [B, C] float32."""
    f32 = np.float32
    B, M, C = x.shape
    lanes = cuda_lib.gn_cluster_lanes(C)
    held = cuda_lib.gn_grid_held(plan, C, G, 4)
    cg = C // G
    mul, add = np.zeros((B, C), f32), np.zeros((B, C), f32)
    for b in range(B):
        parts = []
        for q in range(plan.cs):
            rows = x[b, q * plan.rows:(q + 1) * plan.rows]
            assert len(rows) > 0
            red = np.zeros((2, lanes, C), f32)
            for rl in range(lanes):
                for row in list(rows[held:][rl::lanes]) + list(rows[:held][rl::lanes]):  # a thread's rows, in order
                    red[0, rl] += row
                    red[1, rl] += row * row
            lane_sum = np.zeros((2, C), f32)
            for rl in range(lanes):
                lane_sum += red[:, rl]
            gpart = np.zeros((2, G), f32)
            for j in range(cg):
                gpart += lane_sum[:, j::cg]
            parts.append(gpart)
        lane = []
        for j0 in range(8):  # thread j0: blocks j0, j0 + 8, ... into four sums by 32, the tail into the first
            acc = [np.zeros((2, G), f32) for _ in range(4)]
            j = j0
            while j + 24 < len(parts):
                for k in range(4):
                    acc[k] += parts[j + 8 * k]
                j += 32
            while j < len(parts):
                acc[0] += parts[j]
                j += 8
            lane.append((acc[0] + acc[1]) + (acc[2] + acc[3]))
        x4 = [lane[i] + lane[i ^ 4] for i in range(8)]
        x2 = [x4[i] + x4[i ^ 2] for i in range(8)]
        tot = x2[0] + x2[1]
        n = f32(M * cg)
        mean = tot[0] / n
        rstd = f32(1.0) / np.sqrt(np.maximum(f32(0.0), tot[1] / n - mean * mean) + f32(eps))
        m = np.repeat(rstd, cg) * scale
        mul[b], add[b] = m, bias - np.repeat(mean, cg) * m
    return mul, add


def _grid_apply(x, mul, add, act):
    """The apply at fp32: the product and the sum rounded separately, then
    h / (1 + exp(-h)) (the grid route's ``__fdividef`` and ``__expf``, whose
    few ulps the tolerance covers; no SiLU without ``act``)."""
    h = x * mul[:, None] + add[:, None]
    return h / (np.float32(1.0) + np.exp(-h)) if act else h


@pytest.mark.parametrize("B,M,C,sms", [(2, 4000, 64, 4), (8, 300, 64, 4), (3, 700, 320, 16), (1, 90, 2560, 132),
                                       (1, 2600, 64, 132)],
                         ids=["rows-past-the-slab", "passes-of-4", "5-blocks-a-sample", "one-row-lane", "130-blocks"])
def test_grid_route_reduction_model_matches_the_plain_fold(rng, B, M, C, sms):
    """The grid route's reduction order gives the plain fold's vectors within
    1e-5 of their largest magnitude, and the same bits every run: a sample
    larger than the card's shared memory (C 64 on a card of 4 SMs: 1000 rows
    a block, 840 held, the rest streamed and read again), 4 samples a pass
    of one block each in two passes, 3 samples of 5 blocks, one row lane at
    C 2560, and one sample over 130 blocks (the four sums of each lane)."""
    x = (2.0 * rng.standard_normal((B, M, C)) + 0.5).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    plan = cuda_lib.gn_plan(B, M, C, 32, 4, sms, "grid")
    assert plan.route == "grid" and plan.splits * plan.cs <= sms
    assert (plan.cs - 1) * plan.rows < M <= plan.cs * plan.rows
    if B == 2:
        assert plan.splits == 1 and cuda_lib.gn_grid_held(plan, C) < plan.rows
    mul, add = _grid_model(x, s, b, 32, 1e-5, plan)
    pm, pa = ttwrap.group_norm_fold_plain(_t(x), _t(s), _t(b), 32, 1e-5)
    for got, want in ((mul, pm.numpy()), (add, pa.numpy())):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    again = _grid_model(x, s, b, 32, 1e-5, plan)
    assert mul.tobytes() == again[0].tobytes() and add.tobytes() == again[1].tobytes()


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape", [(8, 6, 5, 64), (2, 4, 6, 5, 96)], ids=["per-frame", "per-clip"])
def test_grid_route_model_matches_pallas(rng, interpret, shape, eps, act):
    """The grid route's model (its reduction order, the fold, the fp32
    apply) against the JAX gn_silu through its Pallas kernel at a per-frame
    and a per-clip shape, rtol 1e-5 with a floor of 1e-5 of the output's
    largest magnitude, bit for bit the same on a repeat; at the plan of an
    H100 (132 SMs) and of a card of 4 SMs (passes of 4 samples, or 2 row
    blocks a sample)."""
    C = shape[-1]
    x = (3.0 * rng.standard_normal(shape) + 1.0).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = np.asarray(jtwrap.gn_silu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=eps, act=act, site="unet"))
    B = shape[0]
    x3 = x.reshape(B, -1, C)
    for sms in (132, 4):
        plan = cuda_lib.gn_plan(B, x3.shape[1], C, 32, 4, sms, "grid")
        mul, add = _grid_model(x3, s, b, 32, eps, plan)
        y = _grid_apply(x3, mul, add, act).reshape(shape)
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(ref).max())))
        again = _grid_apply(x3, *_grid_model(x3, s, b, 32, eps, plan), act)
        assert again.tobytes() == y.reshape(x3.shape).tobytes()


def _plan_before_the_grid_route(B, M, C, G, elem):
    """``gn_plan`` as it was before the grid route (cluster where a sample
    fits 16 blocks, else split), kept here to hold bf16 to it."""
    fit = (SMEM_MAX - cuda_lib.gn_cluster_smem(0, C, G)) // (elem * C)
    if fit >= 1 and -(-M // fit) <= 16 and 2 * G * 16 <= cuda_lib.gn_cluster_lanes(C) * C:
        cs = -(-M // fit)
        cs = 16 if cs > 8 else 8 if cs > 5 else cs
        rows = -(-M // min(cs, M))
        return ("cluster", -(-M // rows), rows, cuda_lib.gn_cluster_smem(rows, C, G, elem), 0)
    splits = cuda_lib.gn_stats_splits(B, M, C)
    lanes = max(1, 256 // (C // 8))
    return ("split", 0, -(-M // splits), 2 * lanes * C * 4, splits)


@pytest.mark.parametrize("where", list(FORWARDS))
def test_bf16_plan_is_the_one_before_the_grid_route(monkeypatch, where):
    """At 2-byte elements ``gn_plan`` never takes the grid route: at every
    call of the full-width forwards and the VAE it is field for field the
    plan before the grid route existed, on a card of any SM count."""
    for B, M, C in FORWARDS[where][0](monkeypatch):
        want = _plan_before_the_grid_route(B, M, C, 32, 2)
        for sms in (132, 114, 4):
            assert tuple(cuda_lib.gn_plan(B, M, C, 32, 2, sms)) == want, (B, M, C, sms)


def test_gn_silu_on_the_grid_route_makes_one_call(monkeypatch):
    """On the grid route (fp32) ``gn_silu`` makes one ``ds_group_norm_silu``
    call with route 2, the plan's blocks a sample, rows, shared memory and
    samples a pass, and one scratch buffer of ``gn_grid_scratch`` elements
    (mul | add, two passes' partials, the counter) whose head it returns as
    the folded vectors; a plan handed in is taken as it is."""
    calls, bufs = [], []
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "ptr", lambda t: bufs.append(t) or (None if t is None else id(t)))
    monkeypatch.setattr(cuda_lib, "call", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(ttwrap.gn_silu, "launches", 0)
    monkeypatch.setattr(ttwrap.gn_silu, "launches_split", 0)
    B, F, H, W, C = 2, 16, 40, 64, 320
    x = torch.zeros((B, F, H, W, C))
    M = F * H * W
    plan = cuda_lib.gn_plan(B, M, C, 32, 4, cuda_lib.GN_GRID_SMS, "grid")
    y, (mul, add) = ttwrap.gn_silu(x, torch.ones(C), torch.zeros(C), vectors=True, plan=plan)
    assert [c[0] for c in calls] == ["ds_group_norm_silu"] and y.shape == x.shape
    args = calls[0][1]
    assert args[10:15] == (2, plan.cs, plan.rows, plan.smem, plan.splits) and args[17] == 1
    scratch = bufs[3]
    assert scratch.numel() == cuda_lib.gn_grid_scratch(plan, B, C) == 2 * B * C + 4 * plan.splits * plan.cs * 32 + 4
    assert mul.data_ptr() == scratch.data_ptr() and add.data_ptr() == scratch.data_ptr() + 4 * B * C
    assert (ttwrap.gn_silu.launches, ttwrap.gn_silu.launches_split) == (1, 0)
    other = cuda_lib.gn_plan(B, M, C, 32, 4, cuda_lib.GN_GRID_SMS, "split")
    ttwrap.gn_silu(x, torch.ones(C), torch.zeros(C), plan=other)
    assert calls[-1][1][10:15] == (1, 0, other.rows, other.smem, other.splits)


def test_gn_plan_refuses_a_route_that_does_not_hold():
    """A named route that does not hold raises: the cluster route where a
    sample does not fit 16 blocks, a name that is no route, and the grid
    route at 2-byte elements."""
    with pytest.raises(ValueError, match="gn_plan"):
        cuda_lib.gn_plan(8, 40960, 320, 32, 4, 132, "cluster")
    with pytest.raises(ValueError, match="gn_plan"):
        cuda_lib.gn_plan(8, 640, 320, 32, 4, 132, "grid ")
    with pytest.raises(ValueError, match="gn_plan"):
        cuda_lib.gn_plan(8, 40960, 320, 32, 2, 132, "grid")
