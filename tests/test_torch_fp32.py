"""The port's fp32 route, on the CPU.

Every kernel takes fp32 activations on the card
(``csrc/gemm_f32.cu::ds_ln_gemm_f32``, ``csrc/attention_f32.cu``'s
``ds_temporal_attention_f32`` and ``ds_flash_attention_f32``,
``csrc/gn_silu.cu`` instantiated at fp32, ``csrc/temporal_f32.cu``'s
kernels 10 and 12 and ``csrc/spatial_f32.cu``'s kernels 11 and 13). Here:

* the dtype rules of every kernel wrapper, held on CPU tensors: one
  activation type, bf16 or fp32, for activations, weights and residuals; a
  mix, or float16, raises ValueError before any kernel or plain version runs;
* the host side on CPU tensors with the launch replaced by a recorder:
  each wrapper names its fp32 entry point, with its tile and scratch
  (kernels 10-13: the pointer array, a slot of scratch a block, and for
  kernels 11 and 13 the ``ds_ln_gemm_f32`` heads before the body);
* the planners at 4-byte elements: ``gn_plan``'s route at every GroupNorm
  call of the full-width forwards and of the VAE within the shared memory
  of a block, the fp32 GEMM's tile (``gemm_f32_tile``: BN, ring stages,
  shared memory, GEGLU pairing, the persistent grid) at every GEMM shape of
  the forward and every shape its gates admit, the tensor-core flash
  kernel's shared memory and grid at N 40-2560 and both cross segment
  layouts, the scratch of kernels 10-13 at every transformer of the
  full-width batch-8 i2v forward, and the tiles of kernels 10-13 at every
  shape their gates admit;
* the plain versions at fp32, composed as the card composes the kernels,
  against the JAX Pallas kernels in interpret mode at the main path's head
  geometry (C 320, 5 heads of 64, few tokens): TA inside K1, FA inside K2
  and inside K3 with two key segments (77 text + 16 image keys), and
  ``ln_gemm_plain`` with the LayerNorm prologue (store and GEGLU), the
  GroupNorm prologue (with and without the frame map) and the residual
  epilogue (with and without the output map); relative L2 error at most
  1e-5 of the op's own output (the output less its residual), since both
  sides compute in fp32 with no rounding point and differ only in the order
  of their sums; and kernels 10-13's plain versions against their Pallas
  kernels at C 320, 5 heads;
* the CLIs: ``--dtype float32`` on the card passes ``check_dtype`` (each
  CLI then needs the card), and each CLI's startup (``setup_precision``)
  switches TF32 off for cuDNN and matmul; bf16 and ``--dev_tiny`` keep
  PyTorch's settings.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamicscaler_tpu.ops import fused_block as jblock
from dynamicscaler_tpu.ops import fused_mega as jmega
from dynamicscaler_tpu.ops import fused_spatial as jspatial
from dynamicscaler_tpu.ops import fused_temporal as jtemporal
from dynamicscaler_tpu.ops import fused_twrap as jtwrap
from dynamicscaler_tpu_torch.config import videocrafter2_t2v, videocrafter_i2v
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.models.unet3d import gn_silu_calls
from dynamicscaler_tpu_torch.ops import cuda_lib, fused_block, fused_mega
from dynamicscaler_tpu_torch.ops import fused_spatial as tspatial
from dynamicscaler_tpu_torch.ops import fused_temporal as ttemporal
from dynamicscaler_tpu_torch.ops import fused_twrap as ttwrap
from dynamicscaler_tpu_torch.ops.cuda_lib import MODE_GEGLU, MODE_RESIDUAL, MODE_STORE, ln_gemm_plain
from dynamicscaler_tpu_torch.pipelines.tiled_vae import ring_aware_decode, tiled_vae_encode
from torch_port_helpers import i2v_transformers

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
SMEM_MAX = 232448  # dynamic shared memory a block may have on the H100
C, HEADS, SCALE = 320, 5, 64 ** -0.5
REL_L2 = 1e-5


@pytest.fixture
def interpret():
    jtemporal.set_mode("interpret")
    yield
    jtemporal.set_mode("auto")


def _t(a, dtype=F32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _rel_l2(got, ref, base=None):
    ref = np.asarray(ref, dtype=np.float64)
    own = ref - (0.0 if base is None else np.asarray(base, dtype=np.float64))
    return float(np.linalg.norm(got.double().numpy() - ref) / np.linalg.norm(own))


# ---------------------------------------------------------------------------
# the dtype rules
# ---------------------------------------------------------------------------


def _z(*shape, dt=F32):
    return torch.zeros(shape, dtype=dt)


def _vec(n):
    return torch.ones(n)


def _block_args(Cw, Dc=None):
    """A block's (lns, attn1, attn2, ff) at width Cw, fp32 (attn2 a cross
    attention over Dc-wide context when Dc is given)."""
    w, v = _z(Cw, Cw), _vec(Cw)
    attn2 = (w, _z(Cw, Dc), _z(Cw, Dc), w, v) if Dc else (w, w, w, w, v)
    return (v,) * 6, (w, w, w, w, v), attn2, (_z(8 * Cw, Cw), _vec(8 * Cw), _z(Cw, 4 * Cw), v)


# wrapper -> a call with x in `dt` and its other activation-type operands in `other`
DTYPE_CALLS = {
    "ln_gemm": lambda dt, other: cuda_lib.ln_gemm(_z(128, 64, dt=dt), _z(128, 64, dt=other)),
    "ln_gemm residual": lambda dt, other: cuda_lib.ln_gemm(_z(128, 64, dt=dt), _z(128, 64, dt=dt),
                                                           residual=_z(128, 128, dt=other), mode=MODE_RESIDUAL),
    "temporal_attention": lambda dt, other: ttemporal.temporal_attention(_z(2, 8, 3 * 64, dt=dt), heads=1, scale=0.125),
    "flash_attention": lambda dt, other: tspatial.flash_attention(_z(1, 8, 64, dt=dt), _z(1, 4, 64, dt=other),
                                                                  _z(1, 4, 64, dt=other), heads=1, scale=0.125),
    "flash_attention image keys": lambda dt, other: tspatial.flash_attention(
        _z(1, 8, 64, dt=dt), _z(1, 4, 64, dt=dt), _z(1, 4, 64, dt=dt), _z(1, 2, 64, dt=other),
        _z(1, 2, 64, dt=other), heads=1, scale=0.125),
    "K1": lambda dt, other: ttemporal.fused_ln_attention(_z(2, 8, 64, dt=dt), _vec(64), _vec(64),
                                                         *(_z(64, 64),) * 4, _vec(64), heads=1, scale=0.125),
    "K2": lambda dt, other: tspatial.fused_ln_spatial_attention(_z(2, 8, 64, dt=dt), _vec(64), _vec(64),
                                                                *(_z(64, 64),) * 4, _vec(64), heads=1, scale=0.125),
    "K3": lambda dt, other: tspatial.fused_ln_cross_attention(_z(2, 8, 64, dt=dt), _z(2, 5, 32), _vec(64), _vec(64),
                                                              _z(64, 64), _z(64, 32), _z(64, 32), _z(64, 64),
                                                              _vec(64), heads=1, scale=0.125),
    "K4": lambda dt, other: ttemporal.fused_ln_geglu(_z(4, 64, dt=dt), _vec(64), _vec(64), _z(512, 64), _vec(512),
                                                     _z(64, 256), _vec(64)),
    "head_temporal": lambda dt, other: ttwrap.head_temporal(_z(1, 2, 2, 2, 64, dt=dt), _z(1, 64), _z(1, 64),
                                                            _z(64, 64), _vec(64)),
    "tail_temporal": lambda dt, other: ttwrap.tail_temporal(_z(4, 2, 64, dt=dt), _z(1, 2, 2, 2, 64, dt=other),
                                                            _z(64, 64), _vec(64)),
    "head_spatial": lambda dt, other: ttwrap.head_spatial(_z(2, 2, 2, 64, dt=dt), _z(2, 64), _z(2, 64), _z(64, 64),
                                                          _vec(64)),
    "tail_spatial": lambda dt, other: ttwrap.tail_spatial(_z(2, 4, 64, dt=dt), _z(2, 2, 2, 64, dt=other),
                                                          _z(64, 64), _vec(64)),
    "gn_silu": lambda dt, other: ttwrap.gn_silu(_z(2, 4, 64, dt=dt), _vec(64), _vec(64)),
    "gn_silu_apply": lambda dt, other: ttwrap.gn_silu_apply(_z(2, 4, 64, dt=dt), _z(2, 64), _z(2, 64)),
    "group_norm_fold": lambda dt, other: ttwrap.group_norm_fold(_z(2, 4, 64, dt=dt), _vec(64), _vec(64)),
    "K10": lambda dt, other: fused_block.fused_temporal_block(_z(2, 4, 64, dt=dt), *_block_args(64), heads=1,
                                                              scale=0.125),
    "K11": lambda dt, other: fused_block.fused_spatial_block(_z(2, 8, 64, dt=dt), _z(1, 5, 32), *_block_args(64, 32),
                                                             heads=1, scale=0.125),
    "K12": lambda dt, other: fused_mega.temporal_mega(_z(1, 4, 2, 2, 64, dt=dt), _z(1, 64), _z(1, 64), _z(64, 64),
                                                      _vec(64), *_block_args(64), _z(64, 64), _vec(64), heads=1,
                                                      scale=0.125),
    "K13": lambda dt, other: fused_mega.spatial_mega(_z(2, 2, 4, 64, dt=dt), _z(1, 5, 32), _z(2, 64), _z(2, 64),
                                                     _z(64, 64), _vec(64), *_block_args(64, 32), _z(64, 64), _vec(64),
                                                     heads=1, scale=0.125),
}
MIXED = ("ln_gemm", "ln_gemm residual", "flash_attention", "flash_attention image keys", "tail_temporal",
         "tail_spatial")


@pytest.mark.parametrize("name", list(DTYPE_CALLS))
def test_wrappers_refuse_float16_on_every_device(name):
    """float16 is no activation type of the kernels: refused on CPU tensors
    too, before the plain version runs; fp32 and bf16 take the plain
    version here."""
    call = DTYPE_CALLS[name]
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        call(F16, F16)
    for dt in (F32, BF16):
        call(dt, dt)


@pytest.mark.parametrize("name", MIXED)
def test_wrappers_refuse_a_mix_of_activation_types(name):
    """Weights, residuals and the second segment's keys and values in
    another type than the activation: ValueError on every device."""
    call = DTYPE_CALLS[name]
    for dt, other in ((F32, BF16), (BF16, F32)):
        with pytest.raises(ValueError, match="all of one type"):
            call(dt, other)


def test_check_dtypes_returns_the_one_type_and_skips_none():
    assert cuda_lib.check_dtypes("x", _z(2), None, _z(3)) == F32
    assert cuda_lib.check_dtypes("x", _z(2, dt=BF16)) == BF16
    with pytest.raises(ValueError):
        cuda_lib.check_dtypes("x", _z(2, dt=torch.float64))


def _fake_card(monkeypatch):
    """Every wrapper takes the card's route on CPU tensors, with the launch
    replaced by a recorder of (name, arguments)."""
    calls = []
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "check_operand", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "call", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(tspatial, "_check_rows", lambda *a: None)
    return calls


# the weights' places in the pointer array of ds_temporal_block_f32 (wqkv1,
# wo1, wqkv2, wo2, w1, w2) and ds_temporal_mega_f32 (and w_in, w_out)
TEMPORAL_F32_WEIGHTS = {"ds_temporal_block_f32": (4, 5, 9, 10, 14, 16),
                        "ds_temporal_mega_f32": (4, 5, 9, 10, 14, 16, 20, 22)}
# and of ds_spatial_block_f32 (wo1, wq2, wo2, w1, w2) and ds_mega_spatial_f32 (and w_out)
SPATIAL_F32_WEIGHTS = {"ds_spatial_block_f32": (15, 16, 17, 18, 19), "ds_mega_spatial_f32": (15, 16, 17, 18, 19, 20)}
F32_BODY_WEIGHTS = {**TEMPORAL_F32_WEIGHTS, **SPATIAL_F32_WEIGHTS}


def _kernel_calls(calls):
    """The recorded calls less ``ds_tf32_split``, after checking that every
    ``ds_ln_gemm_f32`` reads as W [2, N, K] the output of a split recorded
    before it (its weights split once, at their first use), and that kernels
    10-13 at fp32 read every weight of their body so."""
    split = set()
    for name, args in calls:
        if name == "ds_tf32_split":
            split.add(args[2].value)
        elif name == "ds_ln_gemm_f32":
            assert args[11].value in split
        elif name in F32_BODY_WEIGHTS:
            assert all(args[0][i] in split for i in F32_BODY_WEIGHTS[name])
    return [(name, args) for name, args in calls if name != "ds_tf32_split"]


# kernel -> (a call at fp32 on fake CUDA tensors, its body's entry point, its pointers, the ds_ln_gemm_f32
# heads before the body: the context K|V per segment, kernel 13's proj_in, LN1 -> q|k|v)
_CW = 128


def _whole_calls():
    Cw, v, w = _CW, _vec(_CW), _z(_CW, _CW)
    lns, a1, _, ff = _block_args(Cw)
    xattn = (w, _z(Cw, 256), _z(Cw, 256), w, v, _z(Cw, 256), _z(Cw, 256))
    return {
        "K10": (lambda: fused_block.fused_temporal_block(_z(5, 16, Cw), lns, a1, a1, ff, heads=2, scale=0.125),
                "ds_temporal_block_f32", 18, 0),
        "K11": (lambda: fused_block.fused_spatial_block(_z(4, 272, Cw), _z(2, 93, 256), lns, a1, xattn, ff, heads=2,
                                                        scale=0.125, text_len=77), "ds_spatial_block_f32", 20, 3),
        "K12": (lambda: fused_mega.temporal_mega(_z(2, 8, 2, 3, Cw), _z(2, Cw), _z(2, Cw), w, v, lns, a1, a1, ff, w,
                                                 v, heads=2, scale=0.125), "ds_temporal_mega_f32", 24, 0),
        "K13": (lambda: fused_mega.spatial_mega(_z(4, 16, 17, Cw), _z(2, 93, 256), _z(4, Cw), _z(4, Cw), w, v, lns,
                                                a1, xattn, ff, w, v, heads=2, scale=0.125, text_len=77),
                "ds_mega_spatial_f32", 21, 4),
    }


WHOLE = {"K10": fused_block.fused_temporal_block, "K11": fused_block.fused_spatial_block,
         "K12": fused_mega.temporal_mega, "K13": fused_mega.spatial_mega}


@pytest.mark.parametrize("kernel", list(WHOLE))
def test_whole_block_wrappers_name_their_fp32_kernels(monkeypatch, kernel):
    """Kernels 10-13 on the card's route at fp32: the ``ds_ln_gemm_f32``
    heads (kernels 11 and 13), then one launch of the fp32 body with its
    pointers (every weight split), the tokens, its scratch and grid and its
    tile (kernels 10 and 12: the three regions of
    ``cuda_lib.temporal_f32_scratch`` and the tile of
    ``cuda_lib.block_f32_plan``; kernels 11 and 13: the regions and the key
    segments' split keys and values of ``cuda_lib.spatial_f32_scratch`` and
    the query tile of ``cuda_lib.spatial_f32_plan``); an fp32 output of x's
    shape; one launch counted."""
    calls = _fake_card(monkeypatch)
    run, name, n_ptrs, heads_gemms = _whole_calls()[kernel]
    before = WHOLE[kernel].launches
    out = run()
    calls = _kernel_calls(calls)
    assert [c[0] for c in calls] == ["ds_ln_gemm_f32"] * heads_gemms + [name]
    args = calls[-1][1]
    assert len(args[0]) == n_ptrs and out.dtype == F32 and WHOLE[kernel].launches == before + 1
    scratch_floats, slots, *plan = args[-3:]
    if kernel in ("K10", "K12"):
        T = 5 * 16 if kernel == "K10" else 2 * 8 * 6
        tile = cuda_lib.block_f32_plan(_CW, 16 if kernel == "K10" else 8, T, mega=kernel == "K12")
        assert tuple(plan) == tuple(tile) == (64,)  # two tiles of 64 tokens for 132 SMs
        assert (slots, scratch_floats) == (2, cuda_lib.temporal_f32_scratch(T, _CW, tile).numel()) == (2, 128 * 6 * _CW)
    else:  # 4 samples of 272 tokens: 12 query tiles of 128 for 132 SMs, so 20 of 64 (the last of a sample 16 rows)
        tile = cuda_lib.spatial_f32_plan(_CW, 272, 4)
        assert tuple(plan) == tuple(tile) == (64,) and slots == cuda_lib.spatial_f32_grid(tile, 4, 272) == 20
        kv = 2 * _CW * (4 * (272 + 320) + 2 * (77 + 128) + 2 * (16 + 64))  # self, text, image: [2, s, L + lpad, C]
        assert scratch_floats == cuda_lib.spatial_f32_scratch(4, 272, _CW, 2, (77, 16), tile).numel()
        assert scratch_floats == 20 * 64 * 6 * _CW + kv
    if kernel == "K10":
        assert args[1:4] == (5, 16, _CW) and out.shape == (5, 16, _CW)
    elif kernel == "K12":
        assert args[1:5] == (2, 8, 6, _CW) and out.shape == (2, 8, 2, 3, _CW)
    else:
        assert args[1:7] == (4, 272, _CW, 2, 77, 16)


# ---------------------------------------------------------------------------
# the host side of the fp32 route
# ---------------------------------------------------------------------------


def test_ln_gemm_names_the_fp32_kernel_with_its_tile(monkeypatch):
    calls = _fake_card(monkeypatch)
    M, K, N = 300, 64, 192
    w = _z(N, K)
    y = cuda_lib.ln_gemm(_z(M, K), w, ln=(_vec(K), _vec(K)), bias=_vec(N))
    assert [c[0] for c in calls] == ["ds_tf32_split", "ds_ln_gemm_f32"]
    assert calls[0][1][1] == N * K and calls[-1][1][11].value == calls[0][1][2].value
    cuda_lib.ln_gemm(_z(M, K), w.detach(), bias=_vec(N))  # the same weight: split once
    assert [c[0] for c in calls[2:]] == ["ds_ln_gemm_f32"] and calls[-1][1][11].value == calls[0][1][2].value
    del calls[2:]
    name, args = calls[-1]
    tile = cuda_lib.gemm_f32_tile(M, K, N)
    assert name == "ds_ln_gemm_f32" and y.dtype == F32 and y.shape == (M, N)
    assert args[1:3] == (M, K) and args[18:20] == (tile.block_n, tile.stages) == (64, 2)
    assert args[17] is not None  # the LayerNorm pass's rows [M, K]
    cuda_lib.ln_gemm(_z(M, K), _z(N, K), bias=_vec(N))
    assert calls[-1][0] == "ds_ln_gemm_f32" and calls[-1][1][17] is None  # no prologue, no scratch
    y = cuda_lib.ln_gemm(_z(M, K, dt=BF16), _z(N, K, dt=BF16))
    assert calls[-1][0] == "ds_ln_gemm" and y.dtype == BF16
    y = cuda_lib.ln_gemm(_z(M, K), _z(2 * N, K), ln=(_vec(K), _vec(K)), mode=MODE_GEGLU)
    tile = cuda_lib.gemm_f32_tile(M, K, 2 * N, MODE_GEGLU)
    assert y.shape == (M, N) and calls[-1][1][18:20] == (tile.block_n, tile.stages)


def test_tf32_split_weights_follow_their_weight(monkeypatch):
    """``tf32_split_weights``: one ``ds_tf32_split`` at a weight's first use
    ([2, N, K] fp32 out), none for the same storage again (a ``detach()``),
    a new one after an in-place change or for another view of it, the
    entry of a weight that is gone dropped at the next split, and an
    inference tensor (no version counter) split once."""
    calls = _fake_card(monkeypatch)
    w = _z(64, 32)
    first = cuda_lib.tf32_split_weights(w)
    assert [c[0] for c in calls] == ["ds_tf32_split"] and first.shape == (2, 64, 32) and calls[0][1][1] == 64 * 32
    assert cuda_lib.tf32_split_weights(w.detach()) is first and len(calls) == 1
    w.add_(1.0)
    assert cuda_lib.tf32_split_weights(w) is not first and len(calls) == 2
    cuda_lib.tf32_split_weights(w.view(32, 64))
    assert len(calls) == 3
    key = next(k for k in cuda_lib._split_weights if k[2] == (32, 64))
    del w
    cuda_lib.tf32_split_weights(_z(16, 32))
    assert key not in cuda_lib._split_weights
    with torch.inference_mode():  # packed inside the forward: no version counter
        wi = _z(8, 32)
        split = cuda_lib.tf32_split_weights(wi)
        assert cuda_lib.tf32_split_weights(wi) is split
    assert cuda_lib.tf32_split_weights(wi) is split and [c[0] for c in calls].count("ds_tf32_split") == 5


@pytest.mark.parametrize("F,H,W", [(16, 5, 8), (16, 5, 5), (8, 6, 6), (32, 4, 8)])
def test_gemm_f32_head_normalises_in_a_pass(monkeypatch, F, H, W):
    """Kernel 5 at fp32: ds_ln_gemm_f32 gets the frame map and fp32 scratch
    [M, K] for its GroupNorm prologue pass (which gathers the rows to
    logical order at every clip geometry), with the planner's tile."""
    calls = _fake_card(monkeypatch)
    Cw = 64
    ttwrap.head_temporal(_z(2, F, H, W, Cw), _z(2, Cw), _z(2, Cw), _z(Cw, Cw), _vec(Cw))
    name, args = calls[-1]
    M = 2 * F * H * W
    tile = cuda_lib.gemm_f32_tile(M, Cw, Cw)
    assert name == "ds_ln_gemm_f32" and args[1:3] == (M, Cw) and args[8:11] == (F * H * W, F, H * W)
    assert args[17] is not None and args[17].value is not None and args[18:20] == (tile.block_n, tile.stages)


def test_attention_cores_name_their_fp32_kernels(monkeypatch):
    calls = _fake_card(monkeypatch)
    before = (ttemporal.temporal_attention.launches, tspatial.flash_attention.launches)
    o = ttemporal.temporal_attention(_z(6, 16, 3 * 128), heads=2, scale=0.125)
    assert o.dtype == F32 and calls[-1][0] == "ds_temporal_attention_f32" and calls[-1][1][1:5] == (6, 16, 128, 2)
    qkv, kv = _z(2, 40, 3 * 128), _z(2, 93, 2 * 128)
    o = tspatial.flash_attention(qkv[..., :128], kv[:, :77, :128], kv[:, :77, 128:], kv[:, 77:, :128],
                                 kv[:, 77:, 128:], heads=2, scale=0.125)
    args = calls[-1][1]
    assert o.dtype == F32 and calls[-1][0] == "ds_flash_attention_f32"
    assert args[1:5] == (384, 2, 40, 2) and args[7:9] == (256, 77) and args[11:14] == (256, 16, 2)
    after = (ttemporal.temporal_attention.launches, tspatial.flash_attention.launches)
    assert after == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("shape", [(16, 6, 10, 320), (2, 16, 40, 64, 320)])
def test_gn_silu_takes_the_fp32_plan_and_flag(monkeypatch, shape):
    """K9 at fp32: ``gn_plan`` at 4-byte elements, ``is_f32`` the last
    argument before the stream (1), on both entry points."""
    calls = _fake_card(monkeypatch)
    x = _z(*shape)
    B, Cx = shape[0], shape[-1]
    M = x.numel() // (B * Cx)
    plan = cuda_lib.gn_plan(B, M, Cx, 32, 4)
    y = ttwrap.gn_silu(x, _vec(Cx), _vec(Cx))
    name, args = calls[-1]
    assert name == "ds_group_norm_silu" and y.dtype == F32
    assert args[10:15] == (cuda_lib.GN_ROUTES.index(plan.route), plan.cs, plan.rows, plan.smem, plan.splits)
    assert args[17] == 1
    ttwrap.gn_silu_apply(x, _z(B, Cx), _z(B, Cx))
    assert calls[-1][0] == "ds_gn_silu" and calls[-1][1][8] == 1
    ttwrap.gn_silu(x.to(BF16), _vec(Cx), _vec(Cx))
    assert calls[-1][1][17] == 0 and calls[-1][1][13] == cuda_lib.gn_plan(B, M, Cx, 32).smem


# ---------------------------------------------------------------------------
# the planners at 4-byte elements
# ---------------------------------------------------------------------------


def _vae_calls(monkeypatch, what):
    """The gn_silu calls (B, M, C) of the i2v model's tiled VAE encode of a
    512x1024 panorama or of the ring decode of one 64x128 latent frame, from
    a run on the ``meta`` device (shapes only)."""
    calls = []

    def rec(x, gn_scale, gn_bias, **kw):
        B, Cx = x.shape[0], x.shape[-1]
        calls.append((B, x.numel() // (B * Cx), Cx))
        return torch.empty_like(x)
    monkeypatch.setattr(ttwrap, "gn_silu", rec)
    model = LatentVideoDiffusion.build(videocrafter_i2v("float32"), "meta")
    if what == "encode":
        tiled_vae_encode(model, torch.empty((512, 1024, 3), device="meta"))
    else:
        ring_aware_decode(model, torch.empty((1, 1, 64, 128, 4), device="meta"))
    return calls


K9_SITES = {
    "i2v UNet batch 8": lambda mp: gn_silu_calls(videocrafter_i2v("float32").unet, 8, 16, 40, 64),
    "t2v UNet batch 2": lambda mp: gn_silu_calls(videocrafter2_t2v("float32").unet, 2, 16, 40, 64),
    "i2v tiled VAE encode": lambda mp: _vae_calls(mp, "encode"),
    "i2v ring decode": lambda mp: _vae_calls(mp, "decode"),
}


@pytest.mark.parametrize("where", list(K9_SITES))
def test_gn_plan_at_fp32_fits_shared_memory(monkeypatch, where):
    """At every K9 call of the main path and the VAE, the fp32 plan's
    cluster and grid routes hold a 4-byte slab: the rows a block holds fit
    the block's shared memory beside the reduction arrays, a cluster block
    never more rows than the bf16 plan's (and so at least as many blocks);
    no call takes the split route; the route is "cluster" exactly where the
    sample fits 16 such blocks, else "grid", whose passes of whole samples
    each spread over at most 132 / (samples a pass) blocks cover the batch
    with no empty block."""
    calls = K9_SITES[where](monkeypatch)
    assert calls
    for B, M, Cx in calls:
        plan = cuda_lib.gn_plan(B, M, Cx, 32, 4)
        fit = (SMEM_MAX - cuda_lib.gn_cluster_smem(0, Cx, 32, 4)) // (4 * Cx)
        assert 0 < plan.smem <= SMEM_MAX and plan.route != "split"
        assert plan.route == ("cluster" if -(-M // fit) <= 16 else "grid"), (B, M, Cx, plan)
        if plan.route == "cluster":
            assert plan.smem == cuda_lib.gn_cluster_smem(plan.rows, Cx, 32, 4)
            assert plan.smem - cuda_lib.gn_cluster_smem(0, Cx, 32, 4) == 4 * plan.rows * Cx
            assert (plan.cs - 1) * plan.rows < M <= plan.cs * plan.rows and plan.cs <= 16
            bf = cuda_lib.gn_plan(B, M, Cx, 32, 2)
            assert bf.route == "cluster" and plan.rows <= bf.rows and bf.cs <= plan.cs
        else:
            per_pass, passes = plan.splits, -(-B // plan.splits)
            assert 1 <= per_pass <= B and (per_pass - 1) * passes < B  # passes balanced
            assert plan.cs <= 132 // per_pass and (plan.cs - 1) * plan.rows < M <= plan.cs * plan.rows
            held = min(plan.rows, fit)
            assert held == cuda_lib.gn_grid_held(plan, Cx) and plan.smem == cuda_lib.gn_cluster_smem(held, Cx, 32, 4)
            assert held == plan.rows or per_pass == 1  # rows past the slab only where one sample spans the card


def test_gn_plan_refuses_other_element_sizes():
    with pytest.raises(ValueError, match="gn_plan"):
        cuda_lib.gn_plan(1, 10, 64, 32, 8)


def _forward_gemms(side, width):
    """(M, K, N, mode) of every GEMM of the full-width batch-8 i2v forward at
    the transformers of (side, width)."""
    shapes = []
    for s, c, inner, _, H, W in i2v_transformers():
        if (s, inner) != (side, width):
            continue
        T = 8 * 16 * H * W
        shapes += [(T, c, inner, MODE_STORE), (T, inner, 3 * inner, MODE_STORE), (T, inner, inner, MODE_RESIDUAL),
                   (T, inner, 8 * inner, MODE_GEGLU), (T, 4 * inner, inner, MODE_RESIDUAL),
                   (T, inner, c, MODE_RESIDUAL)]
        if s == "s":
            shapes += [(T, inner, inner, MODE_STORE), (8 * 77, 1024, 2 * inner, MODE_STORE),
                       (8 * 16, 1024, 2 * inner, MODE_STORE)]
    return shapes


SIDES = [("t", 320), ("t", 512), ("t", 640), ("t", 1280), ("s", 320), ("s", 640), ("s", 1280)]


@pytest.mark.parametrize("side,width", SIDES)
def test_gemm_f32_tile_at_every_forward_shape(side, width):
    """Every GEMM of the full-width batch-8 i2v forward at (side, width) in
    fp32: ``gemm_f32_tile``'s BN is 128 or 64 and pairs GEGLU's value and
    gate columns, its ring has 2 to 8 stages and no more than K has 32-deep
    steps (at least 2), its shared memory is ``gemm_f32_smem``'s and fits a
    block, and ds_ln_gemm_f32 takes the shape (K a multiple of its 32-deep
    step)."""
    shapes = _forward_gemms(side, width)
    assert shapes
    for M, K, N, mode in shapes:
        tile = cuda_lib.gemm_f32_tile(M, K, N, mode)
        assert tile.block_n in (128, 64) and K % cuda_lib.GEMM_F32_BK == 0
        assert mode != MODE_GEGLU or (N // 2) % (tile.block_n // 2) == 0
        assert 2 <= tile.stages <= cuda_lib.GEMM_F32_MAX_STAGES
        assert tile.stages == 2 or tile.stages <= K // cuda_lib.GEMM_F32_BK
        assert tile.smem == cuda_lib.gemm_f32_smem(tile.block_n, tile.stages) <= SMEM_MAX
        cuda_lib._check_ln_gemm(M, K, N, ln=None, gn=None, rows_per_sample=0, frame_map=None,
                                residual=_z(1) if mode == MODE_RESIDUAL else None, mode=mode)


@pytest.mark.parametrize("mode", [MODE_STORE, MODE_RESIDUAL, MODE_GEGLU])
def test_gemm_f32_tile_fits_every_shape_the_gates_admit(mode):
    """At every K (multiples of 32 up to 5120) and N (multiples of 64 up to
    10240) that ``_check_ln_gemm`` admits, and M from one tile to the main
    path's 327680 rows: the tile's shared memory fits a block, its ring
    holds at least 2 stages, and as many as fit where K has the steps."""
    for M in (1, 128, 616, 5120, 20480, 81920, 327680):
        for K in range(32, 5121, 32):
            for N in range(64, 10241, 64):
                if mode == MODE_GEGLU and (N // 2) % 32:
                    continue
                tile = cuda_lib.gemm_f32_tile(M, K, N, mode)
                assert tile.smem <= SMEM_MAX and tile.stages >= 2
                assert cuda_lib.gemm_f32_smem(tile.block_n, tile.stages + 1) > SMEM_MAX \
                    or tile.stages >= K // cuda_lib.GEMM_F32_BK


def test_gemm_f32_tile_pairs_geglu_columns():
    """GEGLU's tile holds BN / 2 value and BN / 2 gate columns, so BN / 2
    divides N / 2: where 64 does not divide N / 2 only BN 64 is legal
    (N / 2 = 32 mod 64), and at the main path's GEGLU widths (N / 2 = 1280,
    2560, 5120) each tile's value columns land on whole tiles of the gate
    half."""
    assert cuda_lib.gemm_f32_tile(4096, 320, 2 * 96, MODE_GEGLU).block_n == 64
    for half in (1280, 2560, 5120):
        tile = cuda_lib.gemm_f32_tile(327680, half // 4, 2 * half, MODE_GEGLU)
        assert half % (tile.block_n // 2) == 0
        assert cuda_lib.gemm_n_tiles(2 * half, tile.block_n, MODE_GEGLU) * tile.block_n // 2 == half


@pytest.mark.parametrize("side,width", SIDES)
def test_gemm_f32_grid_at_most_one_block_an_sm(side, width):
    """The persistent grid: one block a tile, never more than the 132 SMs,
    and every SM busy where there are that many tiles."""
    for M, K, N, mode in _forward_gemms(side, width):
        tile = cuda_lib.gemm_f32_tile(M, K, N, mode)
        tiles = -(-M // 128) * cuda_lib.gemm_n_tiles(N, tile.block_n, mode)
        grid = cuda_lib.gemm_grid(M, N, tile.block_n, mode)
        assert grid == min(tiles, 132) and 1 <= grid <= 132


# (Nq, key segment lengths): the self-attention at every level of the 40x64
# latent, the t2v cross-attention (77 text keys) and the i2v one (77 + 16)
FLASH_SHAPES = [(40, (40,)), (160, (160,)), (640, (640,)), (2560, (2560,)), (2560, (77,)), (2560, (77, 16))]


@pytest.mark.parametrize("Nq,lens", FLASH_SHAPES)
def test_flash_f32_fits_shared_memory(Nq, lens):
    """ds_flash_attention_f32 at N = 40, 160, 640 and 2560 and at the two
    cross segments: its block's shared memory (Q and its remainders, two
    slots of K, K's remainders, V and V^T split in two) fits the H100's
    232,448 bytes at every shape, with the 1024-byte alignment pad; the
    keys stream in tiles of 64 (the ragged last one zero-filled), and the
    grid holds a block an SM at most."""
    smem = cuda_lib.flash_f32_smem()
    assert smem == 1024 + 2 * 128 * 256 + 2 * 5 * 64 * 256 + 64 <= SMEM_MAX
    tiles = [-(-n // cuda_lib.FLASH_F32_BK) for n in lens]
    assert all(1 <= t and (t - 1) * 64 < n <= t * 64 for t, n in zip(tiles, lens))
    grid = cuda_lib.flash_grid(8 * 16, Nq, 5)
    assert grid == min(128 * 5 * -(-Nq // 128), 132)


@pytest.mark.parametrize("side,width", [("t", 320), ("t", 512), ("t", 640), ("t", 1280), ("s", 320), ("s", 640),
                                        ("s", 1280)])
def test_block_f32_scratch_at_every_transformer(side, width):
    """The scratch of kernels 10-13 at fp32 at every transformer of the
    full-width batch-8 i2v forward whose gates admit it: three regions (the
    LayerNorm or attention rows [., C], the q|k|v, q2 or GEGLU rows [., 4C],
    the stream [., C]) of the plan's TM rows a block, no more blocks than
    tiles nor than one an SM, within 1 GiB. Kernels 10 and 12: TM 128 at
    the 40x64, 20x32 and 10x16 levels, 64 at the middle block's 5x8 (40
    tiles of 128 for 132 SMs). Kernels 11 and 13: query tiles of 128 (2560
    and 640 of them), and beside the regions each key segment's keys split
    [2, 128 samples, N, C] and values transposed and split [2, 128, C,
    N] (N 2560 and 640 are whole key tiles), the 8 clips' text (77 keys,
    padded to 128) and image keys (16, padded to 64): within 2 GiB."""
    n = 0
    for s, c, inner, heads, H, W in i2v_transformers():
        if (s, inner) != (side, width):
            continue
        T = 8 * 16 * H * W
        ok = (fused_block.temporal_block_ok(16, inner, inner, heads) if s == "t"
              else fused_block.spatial_block_ok(H * W, inner, inner, heads, 1024))
        for mega in (False, True) if ok else ():
            if s == "t":
                if mega and inner > 640:
                    continue
                plan = cuda_lib.block_f32_plan(inner, 16, T, mega)
                assert plan.tm == (64 if H * W == 40 else 128)
                shape = cuda_lib.temporal_f32_scratch(T, inner, plan)
                blocks = min(-(-T // plan.tm), 132)
                assert cuda_lib.block_f32_grid(plan, T) == blocks and shape == (blocks * plan.tm * 6 * inner,)
                assert shape.numel() * 4 <= 2 ** 30
            else:
                N = H * W
                plan = cuda_lib.spatial_f32_plan(inner, N, 128)
                shape = cuda_lib.spatial_f32_scratch(128, N, inner, 8, (77, 16), plan)
                blocks = min(128 * -(-N // 128), 132)
                assert plan.tm == 128 and cuda_lib.spatial_f32_grid(plan, 128, N) == blocks == 132
                regions = blocks * 128 * 6 * inner
                kv = 2 * 128 * inner * 2 * N + 2 * 8 * inner * ((77 + 128) + (16 + 64))
                assert shape == (regions + kv,) and regions * 4 <= 2 ** 30 and shape.numel() * 4 <= 2 ** 31
            n += 1
    assert n or (side, width) in (("s", 1280),)


def test_block_f32_entry_points_take_the_wrappers_arguments():
    """The C signatures of the four fp32 bodies: the pointer array, the
    shape, scale and eps, the scratch, its floats and the blocks (slots),
    their tile (TM), then the stream."""
    P, I, F, L = cuda_lib._P, cuda_lib._I, cuda_lib._F, cuda_lib._L
    sig = cuda_lib._SIGNATURES
    assert sig["ds_temporal_block_f32"] == (P, I, I, I, F, F, P, L, I, I, P)
    assert sig["ds_temporal_mega_f32"] == (P, I, I, I, I, F, F, P, L, I, I, P)
    assert sig["ds_spatial_block_f32"] == sig["ds_mega_spatial_f32"] == (P, I, I, I, I, I, I, F, F, P, L, I, I, P)


FRAMES = [2, 4, 8, 16, 32, 64, 128]


@pytest.mark.parametrize("C", range(64, 1281, 64))
def test_block_f32_plan_fits_at_every_shape_the_gates_admit(C):
    """``cuda_lib.block_f32_plan`` (the tile of ds_temporal_block_f32 and
    ds_temporal_mega_f32) at every width and frame count the gates admit
    (kernel 12 up to C 640) and at token counts from one row to the 40x64
    level's: tiles of 128 or 64 tokens of whole F-frame rows, 64 only where
    fewer waves of them take less time (never where the 128-token tiles
    fill every SM); the kernel's shared memory at that tile (csrc/
    temporal_f32.cu::smem_bytes: the alignment pad, a ring of 4 slots of
    the tile's token rows and 128 weight rows twice, 32 fp32 each, nine
    mbarriers) within a block's, and the F-frame attention's q, k and v (at
    F 8 and 16) or keys, values and logits within the ring it borrows."""
    for F in FRAMES:
        for mega in (False, True) if C <= 640 else (False,):
            assert fused_block.temporal_block_ok(F, C, C, C // 64)
            assert not mega or fused_mega.temporal_ok(F, C, C, C // 64)
            for rows in (1, 3, 40, 64, 320, 1280, 20480):
                T = rows * F
                plan = cuda_lib.block_f32_plan(C, F, T, mega)
                assert plan.tm in (128, 64) and plan.tm % F == 0
                assert plan.tm == 128 or -(-T // 128) < 132
                tm = plan.tm
                assert 1024 + 4 * (tm + 256) * 32 * 4 + 8 * 9 <= SMEM_MAX
                attn = (2 * tm * 68 + tm * (72 if F in (8, 16) else F + 1)) * 4
                assert attn <= 4 * (tm + 256) * 32 * 4
    if C > 640:
        with pytest.raises(ValueError):
            cuda_lib.block_f32_plan(C, 16, 8 * 16 * 40, mega=True)


# (kernel, C, F, tokens) of kernels 10 and 12 in the batch-8 i2v fp32 forward
# (kernel 12 at t320 under the plan, at t640 under "off"; kernel 10 at
# init_attn's 512 and t1280 under "off", at the 10x16 level and the middle
# block's 5x8) -> the recorded tile (TM)
FORWARD_PLANS = {("K12", 320, 16, 327680): (128,), ("K12", 640, 16, 81920): (128,),
                 ("K10", 512, 16, 327680): (128,), ("K10", 1280, 16, 20480): (128,),
                 ("K10", 1280, 16, 5120): (64,)}


@pytest.mark.parametrize("kernel,C,F,T", list(FORWARD_PLANS))
def test_block_f32_plan_at_the_forward_shapes(kernel, C, F, T):
    assert tuple(cuda_lib.block_f32_plan(C, F, T, kernel == "K12")) == FORWARD_PLANS[kernel, C, F, T]
    shapes = {(s, inner, 8 * F * H * W) for s, _, inner, _, H, W in i2v_transformers()}
    assert ("t", C, T) in shapes


@pytest.mark.parametrize("kernel", ["K10", "K12"])
def test_temporal_f32_splits_each_weight_once(monkeypatch, kernel):
    """Kernels 10 and 12 on the card's route at fp32 (fake card): one
    ``ds_tf32_split`` a weight at the first call (six, with kernel 12's w_in
    and w_out eight; [2, N, K] each), the entry point reading their outputs
    in the weights' places, and none at a second call with the same packed
    operands."""
    calls = _fake_card(monkeypatch)
    Cw, v, w = _CW, _vec(_CW), _z(_CW, _CW)
    lns, a1, a2, ff = _block_args(Cw)
    a2 = (_z(Cw, Cw), _z(Cw, Cw), _z(Cw, Cw), _z(Cw, Cw), v)
    if kernel == "K10":
        op = fused_block.pack_temporal_block(lns, a1, a2, ff, dtype=F32)

        def run():
            return fused_block.fused_temporal_block(_z(5, 16, Cw), lns, a1, a2, ff, heads=2, scale=0.125, operands=op)
        weights = fused_block.block_weights(op)
        name = "ds_temporal_block_f32"
    else:
        w_in, w_out = _z(Cw, Cw), _z(Cw, Cw)
        op = fused_mega.pack_temporal_mega(w_in, v, lns, a1, a2, ff, w_out, v, dtype=F32)

        def run():
            return fused_mega.temporal_mega(_z(2, 8, 2, 3, Cw), _z(2, Cw), _z(2, Cw), w_in, v, lns, a1, a2, ff, w_out,
                                            v, heads=2, scale=0.125, operands=op)
        weights = [*fused_block.block_weights(op.block), op.w_in, op.w_out]
        name = "ds_temporal_mega_f32"
    run()
    splits = [args for n, args in calls if n == "ds_tf32_split"]
    assert len(splits) == len(weights) == len(TEMPORAL_F32_WEIGHTS[name])
    assert sorted(a[1] for a in splits) == sorted(t.numel() for t in weights)
    launch = _kernel_calls(calls)[-1]
    assert launch[0] == name
    assert [launch[1][0][i] for i in TEMPORAL_F32_WEIGHTS[name]] == [a[2].value for a in splits]
    del calls[:]
    run()
    assert [n for n, _ in calls] == [name]


@pytest.mark.parametrize("C", range(64, 641, 64))
def test_spatial_f32_plan_fits_at_every_shape_the_gates_admit(C):
    """``cuda_lib.spatial_f32_plan`` (the query tile of ds_spatial_block_f32
    and ds_mega_spatial_f32) at every width and token count the gates admit
    (N 256-4096 by 16) and at 2 to 128 frame samples: tiles of 128 or 64
    tokens of one sample, 64 only where its waves of tiles take less time
    (a tile of 64 costing ``BLOCK_F32_TM64_COST`` of one of 128), a sample's last tile
    ragged where TM does not divide N; the kernel's shared memory at that
    tile (csrc/spatial_f32.cu::smem_bytes: the alignment pad, a ring of 4
    slots of the tile's token rows and 128 weight rows twice, 32 fp32 each,
    nine mbarriers) within a block's, a key tile's K (or V^T) split, 64 keys
    x 64 columns twice, exactly a stage's weight boxes; the accumulators a
    consumer thread holds (a product: the tile's and the two stages' [TM /
    MW... WN / 2] and two stages' split A fragments; the attention: Q split,
    S, O, O_tile and a half of P split) within the 232 registers setmaxnreg
    gives a consumer; the scratch's TMA strides whole 16 bytes and the
    padded keys whole key tiles."""
    for N in range(256, 4097, 16):
        assert fused_block.spatial_block_ok(N, C, C, C // 64, 1024) and fused_mega.spatial_ok(N, C, C, C // 64, 1024)
        for samples in (2, 16, 32, 128):
            plan = cuda_lib.spatial_f32_plan(C, N, samples)
            tm = plan.tm
            waves = {t: -(-samples * -(-N // t) // 132) for t in (128, 64)}
            assert tm == (64 if waves[64] * cuda_lib.BLOCK_F32_TM64_COST < waves[128] else 128)
            grid = cuda_lib.spatial_f32_grid(plan, samples, N)
            assert 1 <= grid <= min(132, samples * -(-N // tm))
            stage = (tm + 2 * 128) * 32 * 4
            assert 1024 + 4 * stage + 8 * 9 <= SMEM_MAX
            assert 2 * 2 * 64 * 32 * 4 == 2 * 128 * 32 * 4  # K hi | lo (two halves of 32 columns each)
            wn = 128 // (2 // (tm // 64))
            assert 2 * (wn // 2) + 2 * 2 * 4 * 4 <= 232 and 2 * 32 + 3 * 32 + 2 * 4 * 4 <= 232
            lpad = -(-N // 64) * 64
            assert lpad % 64 == 0 and 0 <= lpad - N < 64 and (C * 4) % 16 == 0 and (lpad * 4) % 16 == 0
            shape = cuda_lib.spatial_f32_scratch(samples, N, C, 2, (77, 16), plan)
            assert shape.numel() == grid * tm * 6 * C + 2 * samples * C * (N + lpad) + 2 * 2 * C * (77 + 128 + 16 + 64)
    for bad in ((C, 250, 8), (C + 32, 256, 8), (704, 256, 8)):
        with pytest.raises(ValueError):
            cuda_lib.spatial_f32_plan(*bad)


@pytest.mark.parametrize("kernel", ["K11", "K13"])
def test_spatial_f32_splits_each_weight_once_and_its_keys_once_a_launch(monkeypatch, kernel):
    """Kernels 11 and 13 on the card's route at fp32 (fake card): at the
    first call one ``ds_tf32_split`` a weight (the heads': q|k|v, each
    context segment's k|v, kernel 13's w_in; the body's wo1, wq2, wo2, w1,
    w2, kernel 13's w_out; [2, N, K] each) and the body's entry point
    reading the body's in its weights' places; the keys and values split
    in the launch itself, once (its scratch holds one split copy a key
    segment: the samples' own, the text's and the image's, and no key or
    value passes through ``ds_tf32_split``); no split at a second call with
    the same packed operands."""
    calls = _fake_card(monkeypatch)
    Cw, Dc = _CW, 256
    lns, a1, _, ff = _block_args(Cw)
    a1 = (_z(Cw, Cw), _z(Cw, Cw), _z(Cw, Cw), _z(Cw, Cw), _vec(Cw))
    ff = (_z(8 * Cw, Cw), _vec(8 * Cw), _z(Cw, 4 * Cw), _vec(Cw))
    a2 = (_z(Cw, Cw), _z(Cw, Dc), _z(Cw, Dc), _z(Cw, Cw), _vec(Cw), _z(Cw, Dc), _z(Cw, Dc))
    ctx = _z(2, 93, Dc)
    if kernel == "K11":
        op = fused_block.pack_spatial_block(lns, a1, a2, ff, dtype=F32)

        def run():
            return fused_block.fused_spatial_block(_z(4, 272, Cw), ctx, lns, a1, a2, ff, heads=2, scale=0.125,
                                                   operands=op)
        block, extra, name = op, [], "ds_spatial_block_f32"
    else:
        w_in, w_out = _z(Cw, Cw), _z(Cw, Cw)
        op = fused_mega.pack_spatial_mega(w_in, _vec(Cw), lns, a1, a2, ff, w_out, _vec(Cw), dtype=F32)

        def run():
            return fused_mega.spatial_mega(_z(4, 16, 17, Cw), ctx, _z(4, Cw), _z(4, Cw), w_in, _vec(Cw), lns, a1, a2,
                                           ff, w_out, _vec(Cw), heads=2, scale=0.125, operands=op)
        block, extra, name = op.block, [op.w_in, op.w_out], "ds_mega_spatial_f32"
    body = fused_block.spatial_weights(block) + extra[1:]
    heads = [block.attn1.w_in, *block.attn2.w_kv] + extra[:1]
    run()
    splits = [args for n, args in calls if n == "ds_tf32_split"]
    assert len(splits) == len(heads) + len(body) == len(SPATIAL_F32_WEIGHTS[name]) + 3 + (kernel == "K13")
    assert sorted(a[1] for a in splits) == sorted(t.numel() for t in heads + body)
    launch = _kernel_calls(calls)[-1]
    assert launch[0] == name
    split_outs = {a[2].value for a in splits}
    assert {launch[1][0][i] for i in SPATIAL_F32_WEIGHTS[name]} <= split_outs
    tile = cuda_lib.spatial_f32_plan(Cw, 272, 4)
    regions = cuda_lib.spatial_f32_grid(tile, 4, 272) * tile.tm * 6 * Cw
    kv = 2 * Cw * (4 * (272 + 320) + 2 * (77 + 128) + 2 * (16 + 64))
    assert launch[1][-3] == regions + kv  # one split copy of each key segment's keys and values
    del calls[:]
    run()
    assert [n for n, _ in calls] == ["ds_ln_gemm_f32"] * (3 + (kernel == "K13")) + [name]


# ---------------------------------------------------------------------------
# the plain versions at fp32 against the JAX kernels, C 320, 5 heads
# ---------------------------------------------------------------------------


def _ln(rng, n):
    return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32), (0.1 * rng.standard_normal(n)).astype(np.float32)


def _mat(rng, i, o):
    return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)


def _cat_t(*mats):
    """flax [in, out] kernels -> one torch Linear [sum out, in] weight."""
    return torch.cat([_t(m.T) for m in mats])


def test_ta_inside_k1_matches_jax_kernel(rng, interpret):
    """K1 as the card runs it at fp32: the LN-prologue GEMM (q|k|v), the
    temporal attention core (TA's plain version), the out-projection GEMM
    with bias and residual; 4 rows of 16 frames."""
    R, Fn = 4, 16
    x = (rng.standard_normal((R, Fn, C)) * 0.5).astype(np.float32)
    s, b = _ln(rng, C)
    wq, wk, wv, wo = (_mat(rng, C, C) for _ in range(4))
    bo = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = jtemporal.fused_ln_attention(*map(jnp.asarray, (x, s, b, wq, wk, wv, wo, bo)), heads=HEADS, scale=SCALE)
    x2d = _t(x).reshape(-1, C)
    qkv = ln_gemm_plain(x2d, _cat_t(wq, wk, wv), ln=(_t(s), _t(b)))
    o = ttemporal.temporal_attention_plain(qkv.view(R, Fn, 3 * C), heads=HEADS, scale=SCALE)
    got = ln_gemm_plain(o.reshape(-1, C), _t(wo.T), bias=_t(bo), residual=x2d, mode=MODE_RESIDUAL)
    assert got.dtype == F32
    assert _rel_l2(got.reshape(R, Fn, C), ref, x) <= REL_L2


def test_fa_inside_k2_matches_jax_kernel(rng, interpret):
    """K2 at fp32 as the card runs it: q|k|v GEMM, the flash core's plain
    version over one segment of 160 keys, out-projection + residual."""
    B, N = 2, 160
    x = (rng.standard_normal((B, N, C)) * 0.5).astype(np.float32)
    s, b = _ln(rng, C)
    wq, wk, wv, wo = (_mat(rng, C, C) for _ in range(4))
    bo = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = jspatial.fused_ln_spatial_attention(*map(jnp.asarray, (x, s, b, wq, wk, wv, wo, bo)), heads=HEADS,
                                              scale=SCALE)
    x2d = _t(x).reshape(-1, C)
    qkv = ln_gemm_plain(x2d, _cat_t(wq, wk, wv), ln=(_t(s), _t(b))).view(B, N, 3 * C)
    o = tspatial.flash_attention_plain(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], heads=HEADS, scale=SCALE)
    got = ln_gemm_plain(o.reshape(-1, C), _t(wo.T), bias=_t(bo), residual=x2d, mode=MODE_RESIDUAL)
    assert _rel_l2(got.reshape(B, N, C), ref, x) <= REL_L2


def test_fa_two_segments_inside_k3_matches_jax_kernel(rng, interpret):
    """K3's i2v variant at fp32 as the card runs it: the LN-prologue q GEMM,
    a k|v GEMM per context segment (77 text, 16 image tokens of width
    1024), the flash core's plain version with two segments, each its own
    softmax, out-projection + residual."""
    B, N, Dc, text_len = 2, 96, 1024, 77
    L = text_len + 16
    x = (rng.standard_normal((B, N, C)) * 0.5).astype(np.float32)
    ctx = rng.standard_normal((B, L, Dc)).astype(np.float32)
    s, b = _ln(rng, C)
    wq, wo = _mat(rng, C, C), _mat(rng, C, C)
    wk, wv, wki, wvi = (_mat(rng, Dc, C) for _ in range(4))
    bo = (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = jspatial.fused_ln_cross_attention(*map(jnp.asarray, (x, ctx, s, b, wq, wk, wv, wo, bo, wki, wvi)),
                                            heads=HEADS, scale=SCALE, text_len=text_len)
    x2d = _t(x).reshape(-1, C)
    q = ln_gemm_plain(x2d, _t(wq.T), ln=(_t(s), _t(b))).view(B, N, C)
    kv = []
    for c, (k, v) in ((ctx[:, :text_len], (wk, wv)), (ctx[:, text_len:], (wki, wvi))):
        t = ln_gemm_plain(_t(c).reshape(-1, Dc), _cat_t(k, v)).view(B, c.shape[1], 2 * C)
        kv += [t[..., :C], t[..., C:]]
    o = tspatial.flash_attention_plain(q, *kv, heads=HEADS, scale=SCALE)
    got = ln_gemm_plain(o.reshape(-1, C), _t(wo.T), bias=_t(bo), residual=x2d, mode=MODE_RESIDUAL)
    assert _rel_l2(got.reshape(B, N, C), ref, x) <= REL_L2


def test_ln_gemm_plain_geglu_and_residual_match_k4(rng, interpret):
    """The LayerNorm prologue with the GEGLU epilogue, then the residual
    epilogue, against K4 at fp32 (48 tokens)."""
    x = (rng.standard_normal((48, C)) * 0.7).astype(np.float32)
    s, b = _ln(rng, C)
    w1, w2 = _mat(rng, C, 8 * C), _mat(rng, 4 * C, C)
    b1, b2 = (0.1 * rng.standard_normal(8 * C)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32)
    ref = jtemporal.fused_ln_geglu(*map(jnp.asarray, (x, s, b, w1, b1, w2, b2)))
    x2d = _t(x)
    inner = ln_gemm_plain(x2d, _t(w1.T), ln=(_t(s), _t(b)), bias=_t(b1), mode=MODE_GEGLU)
    got = ln_gemm_plain(inner, _t(w2.T), bias=_t(b2), residual=x2d, mode=MODE_RESIDUAL)
    assert _rel_l2(got, ref, x) <= REL_L2


@pytest.mark.parametrize("side", ["t", "s"])
def test_ln_gemm_plain_gn_head_and_tail_match_pallas(rng, interpret, side):
    """The GroupNorm prologue (with the A row map on the temporal side) and
    the residual epilogue (with the output row map on the temporal side)
    against the wrapper kernels 5-8 at fp32: one clip of 16 frames of 4 x 8
    positions (temporal) or 16 frames of 8 x 8 (spatial), C 320 -> 320."""
    Fn, H, W = 16, (4 if side == "t" else 8), 8
    x = (2.0 * rng.standard_normal((1, Fn, H, W, C)) + 0.5).astype(np.float32)
    s, b = _ln(rng, C)
    w_in, w_out = _mat(rng, C, C), _mat(rng, C, C)
    b_in, b_out = (0.1 * rng.standard_normal(C)).astype(np.float32), (0.1 * rng.standard_normal(C)).astype(np.float32)
    if side == "t":
        jh = jtwrap.gn_proj_in_temporal(*map(jnp.asarray, (x, s, b, w_in, b_in)))
        mul, add = ttwrap.group_norm_fold_plain(_t(x), _t(s), _t(b))
        th = ln_gemm_plain(_t(x).reshape(-1, C), _t(w_in.T), gn=(mul, add), rows_per_sample=Fn * H * W,
                           frame_map=(Fn, H * W), bias=_t(b_in))
        y = np.tanh(np.asarray(jh))
        jt = jtwrap.tail_temporal(*map(jnp.asarray, (y, x, w_out, b_out)))
        tt = ln_gemm_plain(_t(y).reshape(-1, C), _t(w_out.T), frame_map=(Fn, H * W), bias=_t(b_out),
                           residual=_t(x).reshape(-1, C), mode=MODE_RESIDUAL)
    else:
        x4 = x.reshape(Fn, H, W, C)
        jh = jtwrap.gn_proj_in_spatial(*map(jnp.asarray, (x4, s, b, w_in, b_in)))
        mul, add = ttwrap.group_norm_fold_plain(_t(x4), _t(s), _t(b))
        th = ln_gemm_plain(_t(x4).reshape(-1, C), _t(w_in.T), gn=(mul, add), rows_per_sample=H * W, bias=_t(b_in))
        y = np.tanh(np.asarray(jh))
        jt = jtwrap.tail_spatial(*map(jnp.asarray, (y, x4, w_out, b_out)))
        tt = ln_gemm_plain(_t(y).reshape(-1, C), _t(w_out.T), bias=_t(b_out), residual=_t(x4).reshape(-1, C),
                           mode=MODE_RESIDUAL)
    assert _rel_l2(th.reshape(np.asarray(jh).shape), jh) <= REL_L2
    assert _rel_l2(tt.reshape(np.asarray(jt).shape), jt, x.reshape(np.asarray(jt).shape)) <= REL_L2


def _block_np(rng, Cw, Dc=None, img=False):
    """One block's weights, flax layout [in, out]: (lns, attn1, attn2, ff);
    attn2 (wq, wk, wv, wo, bo) + (wk_ip, wv_ip) with image keys."""
    Dc = Dc or Cw

    def vec(n, base=0.0):
        return (base + 0.1 * rng.standard_normal(n)).astype(np.float32)
    lns = tuple(vec(Cw, base) for _ in range(3) for base in (1.0, 0.0))
    a1 = (*(_mat(rng, Cw, Cw) for _ in range(4)), vec(Cw))
    a2 = (_mat(rng, Cw, Cw), _mat(rng, Dc, Cw), _mat(rng, Dc, Cw), _mat(rng, Cw, Cw), vec(Cw))
    if img:
        a2 += (_mat(rng, Dc, Cw), _mat(rng, Dc, Cw))
    ff = (_mat(rng, Cw, 8 * Cw), vec(8 * Cw), _mat(rng, 4 * Cw, Cw), vec(Cw))
    return lns, a1, a2, ff


def _port(ws):
    """Port layout: weights [out, in], vectors as they are."""
    return tuple(_t(w.T) if w.ndim == 2 else _t(w) for w in ws)


def _jax(ws):
    return tuple(map(jnp.asarray, ws))


def _jax_attn2(a2):
    """The JAX kernels' attn2 order: (wq, wk, wv[, wk_ip, wv_ip], wo, bo)."""
    return _jax(a2[:3] + a2[5:] + a2[3:5])


def test_k10_plain_matches_jax_kernel(rng, interpret):
    """Kernel 10's plain version at fp32 (what ds_temporal_block_f32 is held
    to on the card) against the Pallas kernel: 3 rows of 16 frames."""
    x = (rng.standard_normal((3, 16, C)) * 0.5).astype(np.float32)
    lns, a1, a2, ff = _block_np(rng, C)
    ref = jblock.fused_temporal_block(jnp.asarray(x), _jax(lns), _jax(a1), _jax(a2), _jax(ff), heads=HEADS,
                                      scale=SCALE)
    got = fused_block.fused_temporal_block(_t(x), tuple(map(_t, lns)), _port(a1), _port(a2), _port(ff), heads=HEADS,
                                           scale=SCALE)
    assert got.dtype == F32 and _rel_l2(got, ref, x) <= REL_L2


def test_k12_plain_matches_jax_kernel(rng, interpret):
    """Kernel 12's plain version at fp32 against the Pallas kernel: one clip
    of 16 frames at 4 x 8, GroupNorm over the clip."""
    x5 = (2.0 * rng.standard_normal((1, 16, 4, 8, C)) + 0.5).astype(np.float32)
    gs, gb = _ln(rng, C)
    w_in, w_out = _mat(rng, C, C), _mat(rng, C, C)
    b_in, b_out = (0.1 * rng.standard_normal((2, C))).astype(np.float32)
    lns, a1, a2, ff = _block_np(rng, C)
    ref = jmega.temporal_transformer(*map(jnp.asarray, (x5, gs, gb, w_in, b_in)), _jax(lns), _jax(a1), _jax(a2),
                                     _jax(ff), jnp.asarray(w_out), jnp.asarray(b_out), heads=HEADS, scale=SCALE)
    got = fused_mega.temporal_transformer(_t(x5), _t(gs), _t(gb), _t(w_in.T), _t(b_in), tuple(map(_t, lns)),
                                          _port(a1), _port(a2), _port(ff), _t(w_out.T), _t(b_out), heads=HEADS,
                                          scale=SCALE)
    assert got.dtype == F32 and _rel_l2(got, ref, x5) <= REL_L2


def test_k11_plain_matches_jax_kernel(rng, interpret):
    """Kernel 11's plain version at fp32 against the Pallas kernel: one clip
    of 2 frames of 256 tokens, 77 text + 16 image keys of width 128 given
    per clip (the JAX kernel takes them repeated per frame)."""
    frames, N, Dc = 2, 256, 128
    x = (rng.standard_normal((frames, N, C)) * 0.5).astype(np.float32)
    ctx = rng.standard_normal((1, 93, Dc)).astype(np.float32)
    lns, a1, a2, ff = _block_np(rng, C, Dc, img=True)
    ref = jblock.fused_spatial_block(jnp.asarray(x), jnp.asarray(np.repeat(ctx, frames, axis=0)), _jax(lns),
                                     _jax(a1), _jax_attn2(a2), _jax(ff), heads=HEADS, scale=SCALE)
    got = fused_block.fused_spatial_block(_t(x), _t(ctx), tuple(map(_t, lns)), _port(a1), _port(a2), _port(ff),
                                          heads=HEADS, scale=SCALE)
    assert got.dtype == F32 and _rel_l2(got, ref, x) <= REL_L2


def test_k13_plain_matches_jax_kernel(rng, interpret):
    """Kernel 13's plain version at fp32 against the Pallas kernel: one clip
    of 2 frames at 16 x 16, t2v context (21 keys of width 128)."""
    frames, Dc = 2, 128
    x4 = (2.0 * rng.standard_normal((frames, 16, 16, C)) + 0.5).astype(np.float32)
    ctx = rng.standard_normal((1, 21, Dc)).astype(np.float32)
    gs, gb = _ln(rng, C)
    w_in, w_out = _mat(rng, C, C), _mat(rng, C, C)
    b_in, b_out = (0.1 * rng.standard_normal((2, C))).astype(np.float32)
    lns, a1, a2, ff = _block_np(rng, C, Dc)
    ref = jmega.spatial_transformer(
        jnp.asarray(x4), jnp.asarray(np.repeat(ctx, frames, axis=0)), *map(jnp.asarray, (gs, gb, w_in, b_in)),
        _jax(lns), _jax(a1), _jax_attn2(a2), _jax(ff), jnp.asarray(w_out), jnp.asarray(b_out), heads=HEADS,
        scale=SCALE)
    got = fused_mega.spatial_transformer(_t(x4), _t(ctx), _t(gs), _t(gb), _t(w_in.T), _t(b_in), tuple(map(_t, lns)),
                                         _port(a1), _port(a2), _port(ff), _t(w_out.T), _t(b_out), heads=HEADS,
                                         scale=SCALE)
    assert got.dtype == F32 and _rel_l2(got, ref, x4) <= REL_L2


# ---------------------------------------------------------------------------
# the CLIs at --dtype float32
# ---------------------------------------------------------------------------


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags on (PyTorch's cuDNN default), restored after."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


def _tf32():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def test_check_dtype_takes_float32_on_the_card_and_switches_tf32_off(tf32_on, capsys):
    """``check_dtype`` takes bf16 and fp32 on the card and refuses float16,
    and changes nothing; the CLIs' startup step ``setup_precision``
    switches TF32 off for an fp32 run on the card and says so."""
    from dynamicscaler_tpu_torch.cli.gen_pano_360 import check_dtype, setup_precision

    check_dtype("bfloat16", False)
    check_dtype("float32", False)
    assert _tf32() == (True, True)  # a check, no side effect
    with pytest.raises(ValueError, match="float32 or bfloat16 only"):
        check_dtype("float16", False)
    setup_precision("float32", False)
    assert _tf32() == (False, False)
    assert "TF32 off" in capsys.readouterr().out


@pytest.mark.parametrize("dtype,dev_tiny", [("bfloat16", False), ("float32", True)])
def test_setup_precision_keeps_tf32_for_bf16_and_the_cpu(tf32_on, capsys, dtype, dev_tiny):
    """A bf16 run, and ``--dev_tiny`` on the CPU at fp32, keep PyTorch's
    TF32 settings and print nothing."""
    from dynamicscaler_tpu_torch.cli.gen_pano_360 import setup_precision

    setup_precision(dtype, dev_tiny)
    assert _tf32() == (True, True) and capsys.readouterr().out == ""


def _cli_runs(tmp_path):
    from dynamicscaler_tpu_torch.cli import batch_eval, demo, gen_pano_360, sample

    pf = tmp_path / "prompts.txt"
    pf.write_text("a lighthouse\n")
    return {
        "gen_pano_360": lambda: gen_pano_360.main(gen_pano_360.VArgs.from_args(
            ["--dtype", "float32", "--dev_full_random", "true", "--output_dir", str(tmp_path / "g")])),
        "sample": lambda: sample.main(sample.parse_args(["--dtype", "float32", "--prompt", "x", "--ckpt_path",
                                                         "t2v.ckpt", "--output_dir", str(tmp_path / "s")])),
        "demo": lambda: demo.build_model(demo.parse_args(["--dtype", "float32", "--ckpt_path", "t2v.ckpt"])),
        "batch_eval": lambda: batch_eval.main(batch_eval.parse_args(
            ["--dtype", "float32", "--prompt_file", str(pf), "--ckpt_path", "t2v.ckpt",
             "--output_dir", str(tmp_path / "b")])),
    }


@pytest.mark.parametrize("cli", ["gen_pano_360", "sample", "demo", "batch_eval"])
def test_cli_takes_float32_without_dev_tiny(cli, tf32_on, tmp_path, monkeypatch):
    """``--dtype float32`` without ``--dev_tiny`` passes the dtype check (the
    CLI goes on to need the card, which this machine lacks) with both TF32
    flags switched off by its startup."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        _cli_runs(tmp_path)[cli]()
    assert _tf32() == (False, False)


def test_fake_card_k1_runs_the_fp32_gemm_and_ta(monkeypatch):
    """K1 on the card's route at fp32: two ``ds_ln_gemm_f32`` calls around
    one ``ds_temporal_attention_f32``, the weights packed in fp32."""
    calls = _fake_card(monkeypatch)
    x = _z(4, 16, 128)
    out = ttemporal.fused_ln_attention(x, _vec(128), _vec(128), *(_z(128, 128),) * 4, _vec(128), heads=2,
                                       scale=0.125)
    assert [c[0] for c in _kernel_calls(calls)] == ["ds_ln_gemm_f32", "ds_temporal_attention_f32", "ds_ln_gemm_f32"]
    assert out.dtype == F32 and out.shape == x.shape
    op = ttemporal.pack_ln_attention(_vec(128), _vec(128), *(_z(128, 128, dt=BF16),) * 3, _z(128, 128),
                                     _vec(128), dtype=F32)
    assert op.w_in.dtype == op.wo.dtype == F32 and op.bo.dtype == F32


def test_pack_cache_keys_carry_the_dtype():
    """A module packed for bf16 is packed anew for fp32: the cache key holds
    the activation type."""
    cache, packs = cuda_lib.PackCache(), []
    p = torch.nn.Parameter(torch.ones(4))

    def pack(dt):
        packs.append(dt)
        return types.SimpleNamespace(dt=dt)
    assert cache.get(lambda: pack(BF16), [p], BF16).dt == BF16
    assert cache.get(lambda: pack(BF16), [p], BF16).dt == BF16
    assert cache.get(lambda: pack(F32), [p], F32).dt == F32
    assert packs == [BF16, F32]
