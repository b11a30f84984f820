"""K1 (temporal LN-attention sub-block) and K4 (LN + GEGLU feed-forward),
and the per-shape dispatch plan of the UNet's transformers.

Counterparts of ``dynamicscaler_tpu/ops/fused_temporal.py``
``fused_ln_attention`` (Pallas ``_kernel``) and ``fused_ln_geglu``
(``_ff_kernel``). Weights are in torch ``Linear`` layout ``[out, in]``.

On the card each op runs as a short sequence of hand-written CUDA kernels
(``csrc/gemm.cu``, and for K1's attention :func:`temporal_attention`,
``csrc/attention.cu``; at fp32 activations their fp32 twins,
``csrc/gemm_f32.cu`` and ``csrc/attention_f32.cu``); see the notes there
for what bounds each on the H100. The plain versions beside them hold the same
rounding points as the TPU kernels: fp32 LayerNorm statistics, bf16 matmul
inputs with fp32 accumulation, q/k/v rounded to the activation type, fp32
softmax with probabilities rounded before PV (K1), out-projection + bias in
fp32 then rounded, residual added in the activation type.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dynamicscaler_tpu_torch.models.layers import layer_norm
from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.ops.cuda_lib import MODE_GEGLU, MODE_RESIDUAL, act, f32, ln_gemm


# ---------------------------------------------------------------------------
# Per-shape dispatch plan: which level of the fusion ladder each UNet
# transformer shape runs (counterpart of the JAX package's _PLAN_DEFAULT,
# _parse_plan, set_plan and plan_allows, fused_temporal.py:95-147). Keys are
# (side, C): side "t" for a TemporalTransformer (C its width; the block's
# width 512 is the init_attn, which the JAX table leaves out), "s" for a
# SpatialTransformer (C its channels). Levels, highest first:
#   mega      the whole transformer as kernel 12 (temporal) or 13 (spatial),
#             ops/fused_mega.py; the block as kernel 10 / 11 where the
#             transformer's gate refuses (init_attn: inner 512 != C 320);
#   wrap+blk  the wrapper head and tail (kernels 5-8) around the whole block
#             as kernel 10 / 11 (ops/fused_block.py);
#   wrap+sub  the wrapper head and tail around the sub-block kernels K1-K4.
# The JAX package's fourth level, "subs" (no wrapper kernels), has no
# counterpart: the port's wrapper kernels run wherever the wrapper does.
# A level names the preferred kernel set; the kernels' shape gates
# (fused_block.temporal_block_ok / spatial_block_ok, fused_mega.temporal_ok /
# spatial_ok) veto on top, falling through to the next level. Shapes not in
# the table keep wrap+sub, so small test configs keep the sub-block path
# unless a test sets the plan. There is a table for each activation type:
# PLAN_DEFAULT (bf16) and PLAN_DEFAULT_F32 (fp32, whose kernels have their
# own timings); plan_allows picks it by the activations' dtype.
# DSCALER_FUSE_PLAN (read once, at import) or set_plan takes "auto" (the
# tables), "off" (the highest legal level at every shape, either type) or a
# comma spec such as "t640=mega,s320=wrap+blk" patching both tables.
#
# The table is the fastest level at each shape of the batch-8 i2v UNet
# forward in one recorded run of chip_smoke.py (phase 3, module ms per
# forward with the GroupNorm fold, NVIDIA H100 80GB HBM3 at 700 W; the run
# is in PERF.md). With the sub-block GEMMs on wgmma (csrc/gemm.cu) and
# kernels 10 and 12 on TMA and wgmma (csrc/block.cu), the whole temporal
# transformer (kernel 12) is the fastest at t320 and the sub-blocks
# everywhere else:
#   t320 : mega 35.38 (wrap+blk 35.75, wrap+sub 37.94)
#   t512 : wrap+sub 11.70 (wrap+blk 15.63; init_attn, no mega: inner != C)
#   t640 : wrap+sub 22.63 (wrap+blk 36.33, mega 42.22)
#   t1280: wrap+sub 17.81 (wrap+blk 52.85; no mega: inner > 640)
#   s320 : wrap+sub 45.59 (wrap+blk 151.27, mega 160.10)
#   s640 : wrap+sub 22.48 (wrap+blk 144.30, mega 161.05)
#   s1280: wrap+sub 18.92 (the only legal level)
# Kernels 10, 11 and 13 run where a plan override or "off" asks for them.
# ---------------------------------------------------------------------------

PLAN_DEFAULT = {
    ("t", 320): "mega",
    ("t", 512): "wrap+sub",
    ("t", 640): "wrap+sub",
    ("t", 1280): "wrap+sub",
    ("s", 320): "wrap+sub",
    ("s", 640): "wrap+sub",
    ("s", 1280): "wrap+sub",
}
# The fp32 table: PLAN_DEFAULT with the fastest fp32 level at each key where
# PLAN_DEFAULT's lost by more than 5% (s640, t512) or nearly (s320, 4.6%),
# from phase 10's fp32 level table (module ms per batch-8 i2v fp32 forward
# with the GroupNorm fold, the same card; the run is in PERF.md). With kernels 11 and 13 on the tensor cores
# (csrc/spatial_f32.cu), as kernels 10 and 12 are (csrc/temporal_f32.cu):
#   s320 : mega 169.70 (wrap+blk 170.81, wrap+sub 177.49)
#   s640 : mega 92.96 (wrap+blk 95.50, wrap+sub 98.50)
#   t512 : wrap+blk 41.71 (wrap+sub 45.10)
# and within 5% of PLAN_DEFAULT's level everywhere else (t320 mega 98.80,
# wrap+blk 98.32; t640 wrap+sub 83.36, mega 83.11).
PLAN_DEFAULT_F32 = {**PLAN_DEFAULT, ("t", 512): "wrap+blk", ("s", 320): "mega", ("s", 640): "mega"}
_LEVEL_ALLOWS = {
    "mega": frozenset({"mega", "block"}),
    "wrap+blk": frozenset({"block"}),
    "wrap+sub": frozenset(),
}


class PlanError(ValueError, AssertionError):
    """A plan the port does not take. An AssertionError, as the JAX
    package's ``_parse_plan`` raises for a bad level or key, and a
    ValueError."""


def _level(level: str, where: str) -> str:
    if level == "subs":
        raise PlanError(f"plan level 'subs' in {where}: the port has no level without its wrapper kernels "
                        f"(kernels 5-8 run wherever the wrapper does); use wrap+sub")
    if level not in _LEVEL_ALLOWS:
        raise PlanError(f"bad plan level {level!r} in {where}")
    return level


def _tables(patch: dict) -> dict:
    """The plan of each activation type: its table patched by ``patch``."""
    return {torch.bfloat16: {**PLAN_DEFAULT, **patch}, torch.float32: {**PLAN_DEFAULT_F32, **patch}}


def _parse_plan(spec: str):
    """The JAX package's spec rules: "auto" or "" the tables, "off" None
    (the highest legal level everywhere), else comma items side+C=level
    patching both tables."""
    if spec in ("auto", ""):
        return _tables({})
    if spec == "off":
        return None
    patch = {}
    for item in spec.split(","):
        k, _, lvl = item.partition("=")
        _level(lvl, repr(spec))
        side, c = k[0], int(k[1:])
        if side not in ("t", "s"):
            raise PlanError(f"bad plan key {k!r} in {spec!r}")
        patch[(side, c)] = lvl
    return _tables(patch)


_PLAN = _parse_plan(os.environ.get("DSCALER_FUSE_PLAN", "auto"))


def set_plan(spec=None) -> None:
    """Set the plan: None or "auto" the tables :data:`PLAN_DEFAULT` (bf16)
    and :data:`PLAN_DEFAULT_F32` (fp32), "off" the highest legal level at
    every shape, a comma spec ("t640=mega,s320=wrap+blk") or a dict
    ``{(side, C): level}`` patching both tables."""
    global _PLAN
    if spec is None or isinstance(spec, str):
        _PLAN = _parse_plan(spec or "auto")
        return
    patch = {}
    for (side, c), level in spec.items():
        if side not in ("t", "s"):
            raise PlanError(f"bad plan key {(side, c)!r}")
        patch[(side, int(c))] = _level(level, f"{(side, c)!r}")
    _PLAN = _tables(patch)


def plan_allows(kind: str, side: str, C: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Does the plan let the ``side`` ("t"/"s") transformer at width ``C``
    with activations of ``dtype`` (fp32 reads :data:`PLAN_DEFAULT_F32`'s
    table, any other type :data:`PLAN_DEFAULT`'s) run kernel class ``kind``
    ("block": kernel 10 / 11, "mega": kernel 12 / 13)? Always under "off"."""
    if _PLAN is None:
        return True
    table = _PLAN[torch.float32 if dtype == torch.float32 else torch.bfloat16]
    return kind in _LEVEL_ALLOWS[table.get((side, C), "wrap+sub")]


def mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` with fp32 accumulation, returned in fp32 (the plain
    versions' ``preferred_element_type=float32`` product)."""
    return torch.matmul(a.float(), w.float().t())


class AttnOperands(NamedTuple):
    """Kernel operands of one LN-attention sub-block (K1, K2, K3): fp32
    LayerNorm and bias vectors, weights in the activation type."""

    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    w_in: torch.Tensor  # self-attention: q|k|v rows [3C, C]; cross: q [C, C]
    wo: torch.Tensor
    bo: torch.Tensor
    w_kv: tuple = ()  # cross: k|v rows [2C, Dc] per context segment


def pack_ln_attention(ln_scale, ln_bias, wq, wk, wv, wo, bo, *, dtype) -> AttnOperands:
    """K1/K2 operands: q, k and v weights stacked for one projection GEMM."""
    return AttnOperands(f32(ln_scale), f32(ln_bias), torch.cat([act(w, dtype) for w in (wq, wk, wv)]),
                        act(wo, dtype), f32(bo))


# ---------------------------------------------------------------------------
# K1: LayerNorm -> QKV -> F-token self-attention -> out-proj -> +x
# ---------------------------------------------------------------------------


def _frames_attend(q, k, v, heads, scale):
    """[R, F, C] each: fp32 logits and softmax per (row, head), the
    probabilities rounded to the activation type before PV; rounded result."""
    R, Fn, C = q.shape
    d = C // heads

    def split(t):
        return t.reshape(R, Fn, heads, d).transpose(1, 2)

    logits = torch.matmul(split(q).float(), split(k).float().transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.matmul(p.float(), split(v).float()).to(q.dtype)
    return o.transpose(1, 2).reshape(R, Fn, C)


def ln_attention_plain(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *, heads, scale, eps=1e-5):
    """Plain PyTorch version of K1. x [R, F, C]; weights [C, C]."""
    dt = x.dtype
    h = layer_norm(x, ln_scale, ln_bias, eps)
    q, k, v = (mm_f32(h, w).to(dt) for w in (wq, wk, wv))
    o = _frames_attend(q, k, v, heads, scale)
    return (mm_f32(o, wo) + bo.float()).to(dt) + x


def frames_ok(frames: int) -> bool:
    """The frame counts K1's attention (and kernels 10 and 12) take: those of
    the JAX gate ``fusable`` (fused_temporal.py:157-175), 2 <= F and F
    dividing 128."""
    return frames >= 2 and 128 % frames == 0


def temporal_attention_plain(qkv, *, heads, scale):
    """Plain version of ``ds_temporal_attention``: qkv [R, F, 3C] (q | k | v)
    -> [R, F, C]."""
    return _frames_attend(*qkv.chunk(3, dim=-1), heads, scale)


def temporal_attention(qkv, *, heads, scale):
    """K1's attention core: per (row, head), softmax(q k^T * scale) rounded,
    times v, over the F frame tokens of each row. qkv [R, F, 3C] with the
    q, k and v columns side by side (head h at columns 64h of each); returns
    [R, F, C]. On the card one launch of ``csrc/attention.cu::
    ds_temporal_attention`` (bf16) or ``csrc/attention_f32.cu::
    ds_temporal_attention_f32`` (fp32) (head dim 64, F as
    :func:`frames_ok`)."""
    dt = cuda_lib.check_dtypes("temporal_attention", qkv)
    if not cuda_lib.use_kernel(qkv):
        return temporal_attention_plain(qkv, heads=heads, scale=scale)
    R, Fn, C3 = qkv.shape
    C = C3 // 3
    if not frames_ok(Fn) or C != heads * 64:
        raise ValueError(f"ds_temporal_attention takes 2 <= F, 128 % F == 0 and head dim 64, got F={Fn} "
                         f"C={C} heads={heads}")
    cuda_lib.check_operand("qkv", qkv, dt)
    o = torch.empty((R, Fn, C), device=qkv.device, dtype=dt)
    name = "ds_temporal_attention_f32" if dt == torch.float32 else "ds_temporal_attention"
    cuda_lib.call(name, cuda_lib.ptr(qkv), R, Fn, C, heads, float(scale), cuda_lib.ptr(o))
    temporal_attention.launches += 1
    return o


temporal_attention.launches = 0


def fused_ln_attention(x, ln_scale, ln_bias, wq, wk, wv, wo, bo, *, heads, scale, eps=1e-5,
                       operands=None):
    """K1: LayerNorm -> QKV -> F-token self-attention -> out-proj -> +x.

    x: [rows, F, C]; rows = B*H*W, F as :func:`frames_ok` on the card;
    weights [C, C] torch layout; ln_scale/ln_bias/bo [C]. Returns [rows, F,
    C]. On the card: LN-prologue GEMM (q|k|v) -> :func:`temporal_attention`
    -> GEMM + bias + residual, reading ``operands`` (from
    :func:`pack_ln_attention`; packed here when None)."""
    dt = cuda_lib.check_dtypes("K1", x)
    if not cuda_lib.use_kernel(x):
        return ln_attention_plain(x, ln_scale, ln_bias, wq, wk, wv, wo, bo,
                                  heads=heads, scale=scale, eps=eps)
    R, Fn, C = x.shape
    if not frames_ok(Fn) or C != heads * 64:
        raise ValueError(f"K1 kernel takes 2 <= F, 128 % F == 0 and head dim 64, got F={Fn} C={C} heads={heads}")
    cuda_lib.check_operand("x", x, dt)
    op = operands or pack_ln_attention(ln_scale, ln_bias, wq, wk, wv, wo, bo, dtype=x.dtype)
    x2d = x.reshape(R * Fn, C)
    qkv = ln_gemm(x2d, op.w_in, ln=(op.ln_scale, op.ln_bias), eps=eps)
    o = temporal_attention(qkv.view(R, Fn, 3 * C), heads=heads, scale=scale)
    out = ln_gemm(o.view(R * Fn, C), op.wo, bias=op.bo, residual=x2d, mode=MODE_RESIDUAL)
    fused_ln_attention.launches += 1
    return out.reshape(R, Fn, C)


fused_ln_attention.launches = 0


# ---------------------------------------------------------------------------
# K4: LayerNorm -> GEGLU feed-forward -> +x
# ---------------------------------------------------------------------------


def ln_geglu_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps=1e-5):
    """Plain PyTorch version of K4. w1 [8C, C] (value rows first, then gate
    rows), w2 [C, 4C]."""
    dt = x.dtype
    h = layer_norm(x, ln_scale, ln_bias, eps)
    a = (mm_f32(h, w1) + b1.float()).to(dt)
    val, gate = a.chunk(2, dim=-1)
    inner = (val.float() * F.gelu(gate.float(), approximate="none")).to(dt)
    return (mm_f32(inner, w2) + b2.float()).to(dt) + x


class FFOperands(NamedTuple):
    """Kernel operands of one LN + GEGLU sub-block (K4)."""

    ln_scale: torch.Tensor
    ln_bias: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def pack_ln_geglu(ln_scale, ln_bias, w1, b1, w2, b2, *, dtype) -> FFOperands:
    return FFOperands(f32(ln_scale), f32(ln_bias), act(w1, dtype), f32(b1), act(w2, dtype), f32(b2))


def fused_ln_geglu(x, ln_scale, ln_bias, w1, b1, w2, b2, *, eps=1e-5, operands=None):
    """K4: LayerNorm -> [C, 8C] + b1 -> value * GELU(gate) (exact erf) ->
    [4C, C] + b2 -> +x, over the flattened leading axes of x [..., C].
    On the card: LN-prologue GEMM with the GEGLU epilogue -> GEMM + bias +
    residual, reading ``operands`` (from :func:`pack_ln_geglu`; packed here
    when None)."""
    dt = cuda_lib.check_dtypes("K4", x)
    if not cuda_lib.use_kernel(x):
        return ln_geglu_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps)
    C = x.shape[-1]
    cuda_lib.check_operand("x", x, dt)
    op = operands or pack_ln_geglu(ln_scale, ln_bias, w1, b1, w2, b2, dtype=x.dtype)
    x2d = x.reshape(-1, C)
    inner = ln_gemm(x2d, op.w1, ln=(op.ln_scale, op.ln_bias), eps=eps, bias=op.b1, mode=MODE_GEGLU)
    out = ln_gemm(inner, op.w2, bias=op.b2, residual=x2d, mode=MODE_RESIDUAL)
    fused_ln_geglu.launches += 1
    return out.reshape(x.shape)


fused_ln_geglu.launches = 0
