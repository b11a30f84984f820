"""The PyTorch port's sphere projection (``ops/sphere.py``) and sphere view
grids (``core/windows.py``) against the JAX package, on the CPU.

The host maps (u, v, gather and scatter indices, validity) are the same
numpy float32 arithmetic on both sides and must be bit-identical. The
tensor ops get the same numpy inputs; the scatters are checked on maps with
duplicate targets (the pole views, and hand-made maps) and with the drop
sentinel ``H*W``, where the JAX CPU scatter keeps the last write and drops
the sentinel. Gathers and nearest writes move values unchanged, so they
must match exactly; the accumulating splats differ only in the order of
their sums (rtol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamicscaler_tpu.core import windows as jwindows
from dynamicscaler_tpu.ops import sphere as jsphere
from dynamicscaler_tpu_torch.core import windows
from dynamicscaler_tpu_torch.ops import sphere

# (fov, theta, phi, view h, view w, pano h, pano w): the CLI's latent views,
# the poles (many view pixels per pano pixel), odd sizes, a wide FOV
VIEWS = [
    (120, 0.0, 0.0, 40, 64, 128, 256),
    (120, 37.0, 75.0, 40, 64, 128, 256),
    (120, 0.0, 90.0, 40, 64, 128, 256),
    (110, 200.0, -90.0, 8, 8, 16, 32),
    (140, 359.0, -45.0, 9, 13, 17, 34),
]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("spec", VIEWS)
def test_sphere_view_maps_are_bit_identical(spec):
    fov, theta, phi, h, w, H, W = spec
    got = sphere.make_sphere_view(fov, theta, phi, h, w, H, W)
    ref = jsphere.make_sphere_view(fov, theta, phi, h, w, H, W)
    for name in ("u", "v", "gather_idx", "scatter_idx", "valid"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_sphere_views_and_grids_match_jax():
    specs = [(120, t, p) for p, ts in windows.default_phi_theta_grid(6).items() for t in ts]
    got = sphere.make_sphere_views(specs, 10, 16, 32, 64)
    ref = jsphere.make_sphere_views(specs, 10, 16, 32, 64)
    assert len(got) == len(ref) == 32
    for g, r in zip(got, ref):
        assert np.array_equal(g.scatter_idx, r.scatter_idx) and np.array_equal(g.gather_idx, r.gather_idx)
    gather, scatter, valid = sphere.stack_views(got)
    jg, js, jv = jsphere.stack_views(ref)
    assert np.array_equal(gather.numpy(), np.asarray(jg)) and np.array_equal(scatter.numpy(), np.asarray(js))
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    for phi_num in (3, 6):
        assert windows.default_phi_theta_grid(phi_num) == jwindows.default_phi_theta_grid(phi_num)
    grid = {90: [0], 0: [0, 120, 240], -45.0: [30.0]}
    for step in (0, 3, 11):
        assert windows.sphere_step_views(grid, step, 10, 120) == jwindows.sphere_step_views(grid, step, 10, 120)
    assert windows.sphere_phase_views(grid, 4, 110) == jwindows.sphere_phase_views(grid, 4, 110)


def test_get_views_match_jax(rng):
    pano = rng.standard_normal((2, 6, 16, 32, 3)).astype(np.float32)
    sv = jsphere.make_sphere_view(110, 200.0, -60.0, 8, 8, 16, 32)
    ref = jsphere.get_view_nearest(jnp.asarray(pano), jnp.asarray(sv.gather_idx), jnp.asarray(sv.valid),
                                   frame_origin=4, frame_count=4)
    got = sphere.get_view_nearest(_t(pano), sv.gather_idx, sv.valid, frame_origin=4, frame_count=4)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(sphere.get_view_nearest(_t(pano), _t(sv.gather_idx)).numpy(),
                                  np.asarray(jsphere.get_view_nearest(jnp.asarray(pano), jnp.asarray(sv.gather_idx))))
    # u, v beyond the pano on both sides exercise the border clamp
    u = (sv.u * 1.1 - 1.0).astype(np.float32)
    v = (sv.v * 1.2 - 1.5).astype(np.float32)
    ref = jsphere.get_view_bilinear(jnp.asarray(pano), jnp.asarray(u), jnp.asarray(v))
    got = sphere.get_view_bilinear(_t(pano), u, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _scatter_map(rng, h, w, H, W):
    """A view scatter map with the drop sentinel and many duplicate targets."""
    idx = rng.integers(0, H * W // 4, size=(h, w)).astype(np.int32)
    idx[rng.random((h, w)) < 0.2] = H * W
    assert (idx == H * W).any() and len(np.unique(idx[idx < H * W])) < (idx < H * W).sum()
    return idx


@pytest.mark.parametrize("frame_origin", [None, 5])
def test_set_view_nearest_matches_jax(rng, frame_origin):
    """Drop sentinel and last-write-wins, on a pole view's real map and on a
    hand-made one."""
    H, W = 16, 32
    pano = rng.standard_normal((1, 6, H, W, 4)).astype(np.float32)
    Fv = 6 if frame_origin is None else 3
    pole = jsphere.make_sphere_view(120, 10.0, 90.0, 8, 8, H, W).scatter_idx
    assert len(np.unique(pole)) < pole.size  # the pole view writes many pixels onto one
    for idx in (pole, _scatter_map(rng, 8, 8, H, W)):
        view = rng.standard_normal((1, Fv, 8, 8, 4)).astype(np.float32)
        ref = jsphere.set_view_nearest(jnp.asarray(pano), jnp.asarray(view), jnp.asarray(idx),
                                       frame_origin=frame_origin)
        got = sphere.set_view_nearest(_t(pano), _t(view), idx, frame_origin=frame_origin)
        assert np.array_equal(got.numpy(), np.asarray(ref))
        plan = sphere.plan_scatter(idx, H * W)
        got = sphere.set_view_nearest(_t(pano), _t(view), plan, frame_origin=frame_origin)
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_plan_scatter_keeps_the_last_write():
    idx = np.array([[3, 7, 3], [32, 7, 0]], np.int32)  # 32 = H*W for a 4x8 pano
    plan = sphere.plan_scatter(idx, 32)
    assert plan.src.tolist() == [2, 4, 5] and plan.tgt.tolist() == [3, 7, 0]


@pytest.mark.parametrize("frame_origin,weighted", [(None, False), (4, True)])
def test_add_view_nearest_matches_jax(rng, frame_origin, weighted):
    H, W = 16, 32
    acc = rng.standard_normal((1, 6, H, W, 4)).astype(np.float32)
    cnt = rng.random((1, 6, H, W, 1)).astype(np.float32)
    Fv = 6 if frame_origin is None else 4
    view = rng.standard_normal((1, Fv, 8, 8, 4)).astype(np.float32)
    idx = _scatter_map(rng, 8, 8, H, W)
    wgt = rng.random((8, 8)).astype(np.float32) if weighted else None
    ra, rc = jsphere.add_view_nearest(jnp.asarray(acc), jnp.asarray(cnt), jnp.asarray(view), jnp.asarray(idx),
                                      frame_origin=frame_origin, weight=None if wgt is None else jnp.asarray(wgt))
    ga, gc = sphere.add_view_nearest(_t(acc), _t(cnt), _t(view), idx, frame_origin=frame_origin,
                                     weight=None if wgt is None else _t(wgt))
    np.testing.assert_allclose(ga.numpy(), np.asarray(ra), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=1e-6, atol=1e-6)


def test_add_view_bilinear_matches_jax(rng):
    H, W = 16, 32
    acc = np.zeros((1, 2, H, W, 3), np.float32)
    wacc = np.zeros((1, 2, H, W, 1), np.float32)
    view = rng.standard_normal((1, 2, 8, 8, 3)).astype(np.float32)
    sv = jsphere.make_sphere_view(120, 300.0, 80.0, 8, 8, H, W)
    ra, rw = jsphere.add_view_bilinear(jnp.asarray(acc), jnp.asarray(wacc), jnp.asarray(view),
                                       jnp.asarray(sv.u), jnp.asarray(sv.v))
    ga, gw = sphere.add_view_bilinear(_t(acc), _t(wacc), _t(view), sv.u, sv.v)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ra), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=1e-6, atol=1e-6)
