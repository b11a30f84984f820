"""Kernels 5-9 of the PyTorch port (``dynamicscaler_tpu_torch/ops/fused_twrap.py``)
against the JAX package's Pallas kernels run in interpret mode, on the CPU.

On the CPU each wrapper takes its plain PyTorch version; the JAX side runs
``_head_temporal``, ``_tail_temporal``, ``_head_spatial``, ``_tail_spatial``
and ``_gn_silu_call`` through the interpreter (``fused_temporal.set_mode
("interpret")``, and ``set_gnsilu_sites`` for ``gn_silu``, as
tests/test_fused_twrap.py does). Inputs come from a numpy seed. Tolerance:
both sides compute in fp32 with the same rounding points and differ only in
the order of the sums (GroupNorm statistics, the proj_in/proj_out dot
products), so rtol 1e-5 with an absolute floor of 1e-5 of the output's
largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamicscaler_tpu.ops import fused_temporal as jtemporal
from dynamicscaler_tpu.ops import fused_twrap as jtwrap
from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.ops import fused_twrap as ttwrap

# the kernel wrappers, each with its launch counter
WRAPPERS = (ttwrap.head_temporal, ttwrap.tail_temporal, ttwrap.head_spatial, ttwrap.tail_spatial,
            ttwrap.gn_silu_apply, ttwrap.group_norm_fold)


@pytest.fixture
def interpret():
    jtemporal.set_mode("interpret")
    jtwrap.set_gnsilu_sites("unet,vae")
    yield
    jtemporal.set_mode("auto")
    jtwrap.set_gnsilu_sites("")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def _params(rng, C, Ci):
    s = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w_in = (rng.standard_normal((C, Ci)) / np.sqrt(C)).astype(np.float32)  # flax [in, out]
    b_in = (0.1 * rng.standard_normal(Ci)).astype(np.float32)
    w_out = (rng.standard_normal((Ci, C)) / np.sqrt(Ci)).astype(np.float32)
    b_out = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return s, b, w_in, b_in, w_out, b_out


def _assert_pallas_runs(side, C):
    # the JAX dispatch plan would otherwise route these shapes to plain jnp
    assert jtwrap._enabled(side, C), (side, C)


@pytest.mark.parametrize("B,F,H,W,C,Ci", [
    (2, 4, 3, 5, 64, 64),    # permuted frames, two clips
    (1, 8, 4, 4, 64, 128),   # Ci != C (the init_attn head is 320 -> 512)
    (3, 2, 5, 7, 96, 64),    # Ci < C, three clips, odd spatial extent
    (1, 16, 5, 5, 64, 64),   # H*W 25 and 100: no 128 / F positions tile a clip (the card's
    (1, 8, 10, 10, 64, 64),  # head gathers its rows in the prologue pass)
])
def test_temporal_head_and_tail_match_pallas(rng, interpret, B, F, H, W, C, Ci):
    _assert_pallas_runs("t", C)
    x5 = (2.0 * rng.standard_normal((B, F, H, W, C)) + 0.5).astype(np.float32)
    s, b, w_in, b_in, w_out, b_out = _params(rng, C, Ci)
    jh = jtwrap.gn_proj_in_temporal(jnp.asarray(x5), jnp.asarray(s), jnp.asarray(b),
                                    jnp.asarray(w_in), jnp.asarray(b_in))
    th = ttwrap.gn_proj_in_temporal(_t(x5), _t(s), _t(b), _t(w_in.T), _t(b_in))
    assert th.shape == (B * H * W, F, Ci)
    _close(th, jh)
    y = np.tanh(np.asarray(jh))  # stand-in for the token blocks
    jt = jtwrap.tail_temporal(jnp.asarray(y), jnp.asarray(x5), jnp.asarray(w_out), jnp.asarray(b_out))
    tt = ttwrap.tail_temporal(_t(y), _t(x5), _t(w_out.T), _t(b_out))
    assert tt.shape == x5.shape
    _close(tt, jt)


@pytest.mark.parametrize("BF,H,W,C,Ci", [
    (6, 5, 7, 64, 64),    # N = 35: a 64-row tile straddles two frames
    (4, 5, 8, 96, 128),   # N = 40, as the UNet's mid level; Ci != C
    (3, 8, 16, 64, 64),   # N = 128
])
def test_spatial_head_and_tail_match_pallas(rng, interpret, BF, H, W, C, Ci):
    _assert_pallas_runs("s", C)
    x4 = (2.0 * rng.standard_normal((BF, H, W, C)) - 0.3).astype(np.float32)
    s, b, w_in, b_in, w_out, b_out = _params(rng, C, Ci)
    jh = jtwrap.gn_proj_in_spatial(jnp.asarray(x4), jnp.asarray(s), jnp.asarray(b),
                                   jnp.asarray(w_in), jnp.asarray(b_in))
    th = ttwrap.gn_proj_in_spatial(_t(x4), _t(s), _t(b), _t(w_in.T), _t(b_in))
    assert th.shape == (BF, H * W, Ci)
    _close(th, jh)
    y = np.tanh(np.asarray(jh))
    jt = jtwrap.tail_spatial(jnp.asarray(y), jnp.asarray(x4), jnp.asarray(w_out), jnp.asarray(b_out))
    _close(ttwrap.tail_spatial(_t(y), _t(x4), _t(w_out.T), _t(b_out)), jt)


@pytest.mark.parametrize("shape,eps,act,site", [
    ((8, 6, 5, 64), 1e-5, True, "unet"),       # ResBlock: per-frame statistics
    ((2, 4, 6, 5, 96), 1e-5, True, "unet"),    # TemporalConvBlock: per-clip statistics
    ((2, 12, 20, 128), 1e-6, True, "vae"),     # VAE resnet norm
    ((1, 9, 7, 64), 1e-6, False, "vae"),       # VAE attention norm: no SiLU
])
def test_gn_silu_matches_pallas(rng, interpret, shape, eps, act, site):
    C = shape[-1]
    x = (3.0 * rng.standard_normal(shape) + 1.0).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = jtwrap.gn_silu(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=eps, act=act, site=site)
    _close(ttwrap.gn_silu(_t(x), _t(s), _t(b), eps=eps, act=act), ref)


@pytest.mark.parametrize("B,M,C", [(2, 7, 64), (1, 300, 320), (3, 1, 128), (8, 40960, 320), (8, 2560, 1280)])
def test_gn_stats_splits_cover_every_row(B, M, C):
    """The statistics kernel's row splits of a sample: non-empty, covering
    all M rows, at most 32 rows a thread of a block of about 256."""
    splits = ttwrap.gn_stats_splits(B, M, C)
    rows = -(-M // splits)
    lanes = max(1, 256 // (C // 8))
    assert 1 <= splits <= max(1, M) and (splits - 1) * rows < M <= splits * rows
    assert rows <= 32 * lanes


def test_group_norm_fold_matches_jax_at_both_eps(rng):
    x = (rng.standard_normal((3, 5, 4, 64)) * 4 + 2).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    for eps in (1e-5, 1e-6):
        jm, ja = jtwrap.group_norm_fold(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=eps)
        tm, ta = ttwrap.group_norm_fold(_t(x), _t(s), _t(b), eps=eps)
        _close(tm, jm)
        _close(ta, ja)


def test_pack_wrapper_layout():
    """The heads' and tails' operands, packed once per transformer module:
    weights [out, in] in the activation type (a Conv1d k=1 weight of the
    init_attn wrapper flattened), biases fp32, values the parameters'."""
    torch.manual_seed(0)
    conv_in, lin_out = torch.nn.Conv1d(64, 128, 1), torch.nn.Linear(128, 64)
    bf = torch.bfloat16
    b_in = conv_in.bias.detach().to(bf)  # a bf16 model's bias
    w_in, b_in32, w_out, b_out = ttwrap.pack_wrapper(conv_in.weight, b_in, lin_out.weight, lin_out.bias,
                                                     dtype=bf)
    assert w_in.shape == (128, 64) and w_out.shape == (64, 128)
    assert w_in.dtype == w_out.dtype == bf and b_in32.dtype == b_out.dtype == torch.float32
    assert torch.equal(w_in, conv_in.weight.detach()[..., 0].to(bf))
    assert torch.equal(w_out, lin_out.weight.detach().to(bf))
    assert torch.equal(b_in32, b_in.float()) and torch.equal(b_out, lin_out.bias.detach())
    assert all(t.is_contiguous() for t in (w_in, b_in32, w_out, b_out))


def test_wrappers_run_plain_on_cpu_and_count_no_launch(rng):
    """CPU tensors take the plain versions (the kernels exist only on the
    card) and leave every launch counter as it was."""
    before = [fn.launches for fn in WRAPPERS]
    x5 = _t(rng.standard_normal((1, 2, 2, 3, 64)))
    w, bias = torch.zeros(64, 64), torch.zeros(64)
    h = ttwrap.gn_proj_in_temporal(x5, torch.ones(64), bias, w, bias)
    ttwrap.tail_temporal(h, x5, w, bias)
    x4 = x5.reshape(2, 2, 3, 64)
    ttwrap.tail_spatial(ttwrap.gn_proj_in_spatial(x4, torch.ones(64), bias, w, bias), x4, w, bias)
    ttwrap.gn_silu(x4, torch.ones(64), bias)
    assert [fn.launches for fn in WRAPPERS] == before
    with cuda_lib.plain_kernels():
        assert not cuda_lib.use_kernel(x5)
