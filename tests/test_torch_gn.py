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
* a numpy model of the cluster route's reduction order (per thread, row
  lanes, the group's channels, then the cluster's blocks in rank order),
  within 1e-5 of ``group_norm_fold_plain``'s largest magnitude and bit for
  bit the same on a repeat;
* the wrapper's host code on CPU tensors with the launch replaced by a
  recorder: one ``ds_group_norm_silu`` call carrying the plan, no
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
