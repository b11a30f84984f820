"""The PyTorch port's ops against the JAX package, on the CPU.

K1-K4 (``dynamicscaler_tpu_torch/ops/fused_{temporal,spatial}.py``) take
their plain PyTorch versions for CPU tensors; here they are held against the
JAX Pallas kernels run in interpret mode, as the JAX tests run them, at the
JAX tests' shapes. The wrapper plain paths (``fused_twrap``) and the shared
layers are held against their JAX twins. fp32 throughout; tolerance
atol 3e-5, rtol 1e-4 (tests/test_fused_spatial.py:70) unless stated.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamicscaler_tpu.models import layers as jlayers
from dynamicscaler_tpu.ops import fused_spatial as jspatial
from dynamicscaler_tpu.ops import fused_temporal as jtemporal
from dynamicscaler_tpu.ops import fused_twrap as jtwrap
from dynamicscaler_tpu_torch.models import layers as tlayers
from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.ops import fused_spatial as tspatial
from dynamicscaler_tpu_torch.ops import fused_temporal as ttemporal
from dynamicscaler_tpu_torch.ops import fused_twrap as ttwrap

ATOL, RTOL = 3e-5, 1e-4


@pytest.fixture
def interpret():
    jtemporal.set_mode("interpret")
    yield
    jtemporal.set_mode("auto")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ln_inputs(rng, C):
    s = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return s, b


def _mats(rng, n, shape_in_out):
    i, o = shape_in_out
    return [(rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32) for _ in range(n)]


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("R,F,C,heads", [(24, 16, 64, 2), (8, 8, 32, 4), (4, 16, 256, 4), (4, 32, 64, 2),
                                         (16, 2, 64, 1), (2, 64, 64, 1)])
def test_k1_temporal_attention_matches_jax_kernel(rng, interpret, R, F, C, heads):
    x = (rng.standard_normal((R, F, C)) * 0.5).astype(np.float32)
    s, b = _ln_inputs(rng, C)
    mats = _mats(rng, 4, (C, C))
    bo = (0.1 * rng.standard_normal(C)).astype(np.float32)
    scale = (C // heads) ** -0.5
    ref = jtemporal.fused_ln_attention(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                       *map(jnp.asarray, mats), jnp.asarray(bo),
                                       heads=heads, scale=scale)
    # flax [in, out] -> torch Linear [out, in]
    got = ttemporal.fused_ln_attention(_t(x), _t(s), _t(b), *(_t(m.T) for m in mats), _t(bo),
                                       heads=heads, scale=scale)
    _close(got, ref)


@pytest.mark.parametrize("B,N,C,heads", [(3, 256, 64, 2), (2, 288, 32, 1), (1, 512, 128, 2),
                                         (1, 160, 1280, 20)])
def test_k2_spatial_attention_matches_jax_kernel(rng, interpret, B, N, C, heads):
    x = (rng.standard_normal((B, N, C)) * 0.5).astype(np.float32)
    s, b = _ln_inputs(rng, C)
    mats = _mats(rng, 4, (C, C))
    bo = (0.1 * rng.standard_normal(C)).astype(np.float32)
    scale = (C // heads) ** -0.5
    ref = jspatial.fused_ln_spatial_attention(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                              *map(jnp.asarray, mats), jnp.asarray(bo),
                                              heads=heads, scale=scale)
    got = tspatial.fused_ln_spatial_attention(_t(x), _t(s), _t(b), *(_t(m.T) for m in mats),
                                              _t(bo), heads=heads, scale=scale)
    _close(got, ref)


@pytest.mark.parametrize("img", [False, True])
@pytest.mark.parametrize("B,N,C,heads,Dc", [(3, 256, 32, 2, 128), (1, 160, 1280, 20, 1024)])
def test_k3_cross_attention_matches_jax_kernel(rng, interpret, img, B, N, C, heads, Dc):
    text_len = 7 if N == 256 else 77
    L = text_len + ((4 if N == 256 else 16) if img else 0)
    x = (rng.standard_normal((B, N, C)) * 0.5).astype(np.float32)
    ctx = rng.standard_normal((B, L, Dc)).astype(np.float32)
    s, b = _ln_inputs(rng, C)
    wq, wo = _mats(rng, 2, (C, C))
    wk, wv, wki, wvi = _mats(rng, 4, (Dc, C))
    bo = (0.1 * rng.standard_normal(C)).astype(np.float32)
    scale = (C // heads) ** -0.5
    ip = (wki, wvi) if img else (None, None)
    ref = jspatial.fused_ln_cross_attention(
        jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(s), jnp.asarray(b), jnp.asarray(wq),
        jnp.asarray(wk), jnp.asarray(wv), jnp.asarray(wo), jnp.asarray(bo),
        *(None if w is None else jnp.asarray(w) for w in ip),
        heads=heads, scale=scale, text_len=text_len,
    )
    got = tspatial.fused_ln_cross_attention(
        _t(x), _t(ctx), _t(s), _t(b), _t(wq.T), _t(wk.T), _t(wv.T), _t(wo.T), _t(bo),
        *(None if w is None else _t(w.T) for w in ip),
        heads=heads, scale=scale, text_len=text_len,
    )
    _close(got, ref)


@pytest.mark.parametrize("T,C", [(30, 128), (48, 320), (16, 512)])
def test_k4_ln_geglu_matches_jax_kernel(rng, interpret, T, C):
    x = (rng.standard_normal((T, C)) * 0.7).astype(np.float32)
    s, b = _ln_inputs(rng, C)
    (w1,) = _mats(rng, 1, (C, 8 * C))
    (w2,) = _mats(rng, 1, (4 * C, C))
    b1 = (0.1 * rng.standard_normal(8 * C)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = jtemporal.fused_ln_geglu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), jnp.asarray(w1),
                                   jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(b2))
    got = ttemporal.fused_ln_geglu(_t(x), _t(s), _t(b), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    _close(got, ref)


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch(rng):
    """A CPU tensor takes the plain version and launches nothing."""
    before = ttemporal.fused_ln_geglu.launches
    C = 64
    x = _t(rng.standard_normal((4, C)))
    ttemporal.fused_ln_geglu(x, torch.ones(C), torch.zeros(C), torch.zeros(8 * C, C),
                             torch.zeros(8 * C), torch.zeros(C, 4 * C), torch.zeros(C))
    assert ttemporal.fused_ln_geglu.launches == before
    assert not cuda_lib.use_kernel(x)
    with pytest.raises(ValueError):
        cuda_lib.use_kernel(x, torch.empty(1, device="meta"))


def test_attention_cores_take_plain_version_on_cpu_and_count_no_launch(rng):
    """K1's and K2/K3's attention cores (the wrappers of ds_temporal_attention
    and ds_flash_attention) take their plain versions for CPU tensors, on
    packed-column views as K1-K3 hand them over, and launch nothing."""
    before = (ttemporal.temporal_attention.launches, tspatial.flash_attention.launches)
    qkv = _t(rng.standard_normal((3, 8, 3 * 128)))
    got = ttemporal.temporal_attention(qkv, heads=2, scale=0.125)
    assert torch.equal(got, ttemporal.temporal_attention_plain(qkv, heads=2, scale=0.125))
    assert got.shape == (3, 8, 128)
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    kv = _t(rng.standard_normal((3, 5, 256)))
    got = tspatial.flash_attention(q, k, v, kv[..., :128], kv[..., 128:], heads=2, scale=0.125)
    ref = tspatial._heads_attention_plain(q, [(k, v), (kv[..., :128], kv[..., 128:])], 2, 0.125)
    assert torch.equal(got, ref) and got.shape == (3, 8, 128)
    assert (ttemporal.temporal_attention.launches, tspatial.flash_attention.launches) == before


def test_attention_and_statistics_wrappers_hand_their_kernels_the_right_arguments(monkeypatch):
    """The card-side host code of the attention cores and the GroupNorm
    statistics, run on CPU tensors with the launch replaced by a recorder:
    the pitches of packed q|k|v columns, the segment lengths, the frame
    count, the statistics' row splits and an output of the right shape, and
    one counted launch each."""
    calls = []
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "call", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(tspatial, "_check_rows", lambda *a: None)
    wrappers = (ttemporal.temporal_attention, tspatial.flash_attention, ttwrap.group_norm_fold)
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    bf = torch.bfloat16
    qkv = torch.zeros(6, 8, 3 * 128, dtype=bf)
    o = ttemporal.temporal_attention(qkv, heads=2, scale=0.125)
    assert o.shape == (6, 8, 128) and calls[-1][0] == "ds_temporal_attention"
    assert calls[-1][1][1:5] == (6, 8, 128, 2)
    qkv = torch.zeros(2, 40, 3 * 128, dtype=bf)
    kv = torch.zeros(2, 7, 2 * 128, dtype=bf)
    o = tspatial.flash_attention(qkv[..., :128], qkv[..., 128:256], qkv[..., 256:], kv[..., :128], kv[..., 128:],
                                 heads=2, scale=0.125)
    args = calls[-1][1]
    assert o.shape == (2, 40, 128) and calls[-1][0] == "ds_flash_attention"
    assert args[1:5] == (384, 2, 40, 2) and args[7:9] == (384, 40) and args[11:14] == (256, 7, 2) and args[16] == 128
    x = torch.zeros(2, 3, 5, 7, 64, dtype=bf)
    mul, add = ttwrap.group_norm_fold(x, torch.ones(64, dtype=bf), torch.zeros(64, dtype=bf), eps=1e-5)
    args = calls[-1][1]
    assert mul.shape == add.shape == (2, 64) and mul.is_contiguous() and add.is_contiguous()
    assert calls[-1][0] == "ds_gn_stats" and args[1:7] == (0, 2, 105, 64, 32, ttwrap.gn_stats_splits(2, 105, 64))
    assert args[9] == 0 and args[10] == 1e-5  # bf16 vectors read as they are
    assert [c[0] for c in calls] == ["ds_temporal_attention", "ds_flash_attention", "ds_gn_stats"]
    assert [fn.launches for fn in wrappers] == [1, 1, 1]


@pytest.mark.parametrize("img", [False, True])
def test_packed_operands_layout(rng, img):
    """The kernels' operands: fp32 vectors, weights in the activation type,
    q|k|v rows stacked for self-attention, k|v rows per context segment for
    cross-attention, value-then-gate w1 rows kept as given."""
    C, Dc, bf = 64, 96, torch.bfloat16
    ln_s, ln_b, bo = (_t(rng.standard_normal(C)) for _ in range(3))
    wq, wk, wv, wo = (_t(rng.standard_normal((C, C))) for _ in range(4))
    op = ttemporal.pack_ln_attention(ln_s, ln_b, wq, wk, wv, wo, bo, dtype=bf)
    assert op.ln_scale.dtype == op.bo.dtype == torch.float32 and op.w_in.dtype == op.wo.dtype == bf
    assert torch.equal(op.w_in, torch.cat([wq, wk, wv]).to(bf)) and op.w_kv == ()

    ck, cv, ik, iv = (_t(rng.standard_normal((C, Dc))) for _ in range(4))
    ip = (ik, iv) if img else (None, None)
    op = tspatial.pack_ln_cross_attention(ln_s, ln_b, wq, ck, cv, wo, bo, *ip, dtype=bf)
    assert torch.equal(op.w_in, wq.to(bf))
    segs = [(ck, cv), (ik, iv)][: 2 if img else 1]
    assert len(op.w_kv) == len(segs)
    for got, (k, v) in zip(op.w_kv, segs):
        assert torch.equal(got, torch.cat([k, v]).to(bf))

    w1, w2 = _t(rng.standard_normal((8 * C, C))), _t(rng.standard_normal((C, 4 * C)))
    ff = ttemporal.pack_ln_geglu(ln_s, ln_b, w1, _t(rng.standard_normal(8 * C)), w2, bo, dtype=bf)
    assert torch.equal(ff.w1, w1.to(bf)) and ff.b1.dtype == torch.float32


def test_pack_cache_packs_once_and_again_after_a_parameter_changes():
    lin = torch.nn.Linear(8, 8)
    cache, packs = cuda_lib.PackCache(), []

    def get():
        params = (lin.weight, lin.bias)
        return cache.get(lambda: packs.append(1) or lin.weight.detach().clone(), params, torch.float32)

    first = get()
    assert get() is first and len(packs) == 1
    with torch.no_grad():
        lin.weight.add_(1.0)  # in place, as load_state_dict copies
    assert torch.equal(get(), lin.weight) and len(packs) == 2
    lin.load_state_dict({"weight": torch.zeros(8, 8), "bias": torch.zeros(8)})
    assert torch.equal(get(), torch.zeros(8, 8)) and len(packs) == 3
    lin.to(torch.float64)  # replaces the storage
    assert get().dtype == torch.float64 and len(packs) == 4
    assert get() is get() and len(packs) == 4


@pytest.mark.parametrize("shape,eps", [((2, 4, 6, 5, 64), 1e-6), ((3, 6, 5, 32), 1e-5),
                                       # ResBlock-like [B, F, H, W, C] and VAE-like [B, H, W, C] shapes whose
                                       # M is a multiple of no block size, at both eps
                                       ((2, 3, 7, 9, 320), 1e-5), ((2, 3, 7, 9, 320), 1e-6),
                                       ((1, 13, 17, 128), 1e-6), ((2, 5, 11, 640), 1e-5)])
def test_group_norm_fold_and_gn_silu_match_jax(rng, shape, eps):
    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    s, b = _ln_inputs(rng, C)
    jm, ja = jtwrap.group_norm_fold(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=eps)
    tm, ta = ttwrap.group_norm_fold(_t(x), _t(s), _t(b), eps=eps)
    _close(tm, jm)
    _close(ta, ja)
    ref = jtwrap.gn_silu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=eps)
    _close(ttwrap.gn_silu(_t(x), _t(s), _t(b), eps=eps), ref)


def test_transformer_head_and_tail_match_jax(rng):
    B, F, H, W, C, Ci = 2, 4, 3, 5, 32, 64
    x5 = rng.standard_normal((B, F, H, W, C)).astype(np.float32)
    s, b = _ln_inputs(rng, C)
    (w_in,) = _mats(rng, 1, (C, Ci))
    (w_out,) = _mats(rng, 1, (Ci, C))
    b_in = (0.1 * rng.standard_normal(Ci)).astype(np.float32)
    b_out = (0.1 * rng.standard_normal(C)).astype(np.float32)
    jh = jtwrap.gn_proj_in_temporal(jnp.asarray(x5), jnp.asarray(s), jnp.asarray(b),
                                    jnp.asarray(w_in), jnp.asarray(b_in))
    th = ttwrap.gn_proj_in_temporal(_t(x5), _t(s), _t(b), _t(w_in.T), _t(b_in))
    _close(th, jh)
    jt = jtwrap.tail_temporal(jh, jnp.asarray(x5), jnp.asarray(w_out), jnp.asarray(b_out))
    _close(ttwrap.tail_temporal(th, _t(x5), _t(w_out.T), _t(b_out)), jt)

    x4 = x5.reshape(B * F, H, W, C)
    jh = jtwrap.gn_proj_in_spatial(jnp.asarray(x4), jnp.asarray(s), jnp.asarray(b),
                                   jnp.asarray(w_in), jnp.asarray(b_in))
    th = ttwrap.gn_proj_in_spatial(_t(x4), _t(s), _t(b), _t(w_in.T), _t(b_in))
    _close(th, jh)
    jt = jtwrap.tail_spatial(jh, jnp.asarray(x4), jnp.asarray(w_out), jnp.asarray(b_out))
    _close(ttwrap.tail_spatial(th, _t(x4), _t(w_out.T), _t(b_out)), jt)


def test_timestep_embedding_and_layer_norm_match_jax(rng):
    t = np.array([0, 1, 37, 500, 999], np.int32)
    for dim in (320, 33):
        ref = jlayers.timestep_embedding(jnp.asarray(t), dim)
        # fp32 trig argument reduction differs between XLA and torch
        _close(tlayers.timestep_embedding(torch.from_numpy(t), dim), ref, atol=2e-4, rtol=0)
    x = (3.0 + rng.standard_normal((5, 7, 96))).astype(np.float32)
    s, b = _ln_inputs(rng, 96)
    _close(tlayers.layer_norm(_t(x), _t(s), _t(b)),
           jlayers.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
