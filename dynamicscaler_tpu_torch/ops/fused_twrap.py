"""Transformer wrapper head and tail, and GroupNorm [-> SiLU], with folded
GroupNorm statistics (kernels 5-9).

Counterparts of ``dynamicscaler_tpu/ops/fused_twrap.py``:

* ``head_temporal`` -> kernel 5 (Pallas ``_head_temporal``): GroupNorm
  apply -> frame permute [B,F,H,W,C] -> [BHW,F,C] -> proj_in + bias;
* ``tail_temporal`` -> kernel 6 (``_tail_temporal``): proj_out + bias ->
  permute back -> + residual;
* ``head_spatial`` / ``tail_spatial`` -> kernels 7 and 8
  (``_head_spatial``, ``_tail_spatial``): the same without the permute;
* ``gn_silu_apply`` -> kernel 9 (``_gn_silu_call``).

The heads and ``gn_silu_apply`` take the folded GroupNorm vectors;
``gn_proj_in_temporal`` and ``gn_proj_in_spatial`` compute them with
``group_norm_fold``, the statistics reduction (the JAX package leaves it to
XLA outside the kernels; the port runs it as one CUDA reduction,
``csrc/gn_silu.cu::ds_gn_stats``). ``gn_silu`` is the JAX ``gn_silu`` (the
fold, then kernel 9) as one call, ``csrc/gn_silu.cu::ds_group_norm_silu``,
with the statistics inside it. On the card the heads and tails run as
``csrc/gemm.cu::ds_ln_gemm`` with its GroupNorm prologue, frame row map and
residual epilogue, and ``gn_silu_apply`` as ``csrc/gn_silu.cu::ds_gn_silu``;
see the notes there for what bounds each. Activations are bf16 or fp32: at
fp32 the heads and tails run ``csrc/gemm_f32.cu::ds_ln_gemm_f32`` and
kernel 9 the fp32 instantiation of the same ``gn_silu.cu`` kernels (its
cluster route reckoning 4-byte elements in ``cuda_lib.gn_plan``, and a grid
route of its own). Each
kernel wrapper takes its plain version (``*_plain``,
same rounding points: normalised activation rounded to the activation type
before the product, bias added in fp32 before the rounding, residual added
in the activation type) for CPU tensors, and counts its kernel launches in
``<wrapper>.launches``. Weights are in torch layout ``[out, in]``; the
transformer modules hand the heads and tails the weights and fp32 biases
packed once (:func:`pack_wrapper`).

GroupNorm eps: 1e-6 in the transformer wrappers (lvdm attention.py
Normalize, fused_twrap.py:311,347); 1e-5 in the UNet ResBlocks and
TemporalConvBlock (``gn_silu`` default, fused_twrap.py:438); 1e-6 in the VAE
(its callers pass it).
"""

from __future__ import annotations

import torch

from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.ops.cuda_lib import MODE_RESIDUAL, act, f32, gn_stats_splits, ln_gemm


def group_norm_fold_plain(x, scale, bias, num_groups: int = 32, eps: float = 1e-6):
    """Plain version of :func:`group_norm_fold`."""
    B, C = x.shape[0], x.shape[-1]
    G = num_groups
    xf = x.float().reshape(B, -1, G, C // G)
    mu = xf.mean(dim=(1, 3))
    var = ((xf * xf).mean(dim=(1, 3)) - mu * mu).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    rstd_c = rstd.repeat_interleave(C // G, dim=1)
    mu_c = mu.repeat_interleave(C // G, dim=1)
    mul = rstd_c * scale.float()[None]
    add = bias.float()[None] - mu_c * mul
    return mul, add


def _gn_vectors(scale, bias):
    """A GroupNorm (scale, bias) as the statistics kernels read them: a bf16
    model's vectors as they are (no cast launch), else fp32; contiguous."""
    s, b = scale.detach(), bias.detach()
    if s.dtype != b.dtype or s.dtype not in (torch.bfloat16, torch.float32):
        s, b = f32(s), f32(b)
    return s.contiguous(), b.contiguous()


def group_norm_fold(x, scale, bias, num_groups: int = 32, eps: float = 1e-6):
    """Per-(sample, channel) GroupNorm vectors ``(mul, add)`` [B, C] fp32,
    such that ``normalized = x * mul + add``. Statistics reduce over every
    axis but the first (B) and the channel group, fp32 fast variance. x [B,
    ..., C] bf16 or fp32. On the card one launch of ``csrc/gn_silu.cu::
    ds_gn_stats`` (a reduction pass over x and a small fold launch): C % 8
    == 0, C divisible by the groups, C <= 6144."""
    cuda_lib.check_dtypes("group_norm_fold", x)
    if not cuda_lib.use_kernel(x):
        return group_norm_fold_plain(x, scale, bias, num_groups, eps)
    B, C = x.shape[0], x.shape[-1]
    cuda_lib.check_operand("x", x, x.dtype)
    if C % 8 or C % num_groups or C > 6144 or x.numel() == 0:
        raise ValueError(f"ds_gn_stats takes C % 8 == 0, C % groups == 0 and C <= 6144, got C={C} "
                         f"groups={num_groups} shape {tuple(x.shape)}")
    M = x.numel() // (B * C)
    splits = gn_stats_splits(B, M, C)
    # one allocation: the kernel's partial sums [splits, B, 2, C], then mul, add
    buf = torch.empty((splits + 1) * 2 * B * C, device=x.device, dtype=torch.float32)
    part = buf[:splits * 2 * B * C]
    mul, add = buf[splits * 2 * B * C:].view(2, B, C).unbind(0)
    s, b = _gn_vectors(scale, bias)
    cuda_lib.call("ds_gn_stats", cuda_lib.ptr(x), int(x.dtype == torch.float32), B, M, C, num_groups, splits,
                  cuda_lib.ptr(s), cuda_lib.ptr(b), int(s.dtype == torch.float32), float(eps), cuda_lib.ptr(part),
                  cuda_lib.ptr(mul), cuda_lib.ptr(add))
    group_norm_fold.launches += 1
    return mul, add


group_norm_fold.launches = 0


def _proj(x, w, b):
    """``x @ w.T + b`` with fp32 accumulation, rounded to x.dtype."""
    return torch.addmm(b.float(), x.reshape(-1, x.shape[-1]).float(), w.float().t()).to(
        x.dtype
    ).reshape(*x.shape[:-1], w.shape[0])


def _apply(x, mul, add):
    """``x * mul[b] + add[b]`` in fp32 (product and sum rounded separately)
    for x [B, *spatial, C]."""
    bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return x.float() * mul.reshape(bshape) + add.reshape(bshape)


def pack_wrapper(w_in, b_in, w_out, b_out, *, dtype):
    """Kernel operands of one transformer wrapper (kernels 5-8): proj_in and
    proj_out weights [out, in] in the activation type, fp32 biases."""
    return (act(w_in.reshape(w_in.shape[0], -1), dtype), f32(b_in),
            act(w_out.reshape(w_out.shape[0], -1), dtype), f32(b_out))


def _check_wrapper(name, x, C, Ci):
    cuda_lib.check_operand(name, x, x.dtype)
    if C % 32 or Ci % 64:
        raise ValueError(f"{name}: the kernel takes C % 32 == 0 and Ci % 64 == 0, got C={C} Ci={Ci}")


# ---------------------------------------------------------------------------
# kernels 5 and 6: TemporalTransformer head and tail
# ---------------------------------------------------------------------------


def head_temporal_plain(x5, mul, add, w, b):
    """Plain version of kernel 5: [B,F,H,W,C] -> [B*H*W, F, Ci]."""
    B, Fn, H, W, C = x5.shape
    xn = _apply(x5, mul, add).to(x5.dtype)
    return _proj(xn.permute(0, 2, 3, 1, 4).reshape(B * H * W, Fn, C), w, b)


def head_temporal(x5, mul, add, w, b):
    """Kernel 5: GroupNorm apply with the folded vectors ``(mul, add)``
    [B, C] -> [B*H*W, F, Ci] tokens -> proj_in + bias. On the card: the GEMM
    with the GroupNorm prologue, reading the rows of x5 in (b, h, w, f)
    order."""
    cuda_lib.check_dtypes("head_temporal", x5)
    if not cuda_lib.use_kernel(x5, w):
        return head_temporal_plain(x5, mul, add, w, b)
    B, Fn, H, W, C = x5.shape
    Ci = w.shape[0]
    _check_wrapper("x5", x5, C, Ci)
    y = ln_gemm(x5.reshape(-1, C), act(w, x5.dtype), gn=(mul, add), rows_per_sample=Fn * H * W,
                frame_map=(Fn, H * W), bias=f32(b))
    head_temporal.launches += 1
    return y.reshape(B * H * W, Fn, Ci)


head_temporal.launches = 0


def gn_proj_in_temporal(x5, gn_scale, gn_bias, w, b, *, eps: float = 1e-6):
    """[B,F,H,W,C] -> GroupNorm(32) over each clip -> [B*H*W, F, Ci] tokens
    -> proj_in (the TemporalTransformer head): the statistics pass, then
    :func:`head_temporal`."""
    mul, add = group_norm_fold(x5, gn_scale, gn_bias, eps=eps)
    return head_temporal(x5, mul, add, w, b)


def tail_temporal_plain(y, x5, w, b):
    """Plain version of kernel 6: [BHW,F,Ci], [B,F,H,W,C] -> [B,F,H,W,C]."""
    B, Fn, H, W, C = x5.shape
    o = _proj(y, w, b)
    o = o.reshape(B, H, W, Fn, C).permute(0, 3, 1, 2, 4)
    return o + x5


def tail_temporal(y, x5, w, b):
    """proj_out -> permute back -> + residual: [BHW,F,Ci], [B,F,H,W,C] ->
    [B,F,H,W,C]. On the card: the GEMM with the residual epilogue, writing
    (and reading the residual at) the rows of x5 in (b, h, w, f) order."""
    dt = cuda_lib.check_dtypes("tail_temporal", y, x5)
    if not cuda_lib.use_kernel(y, x5, w):
        return tail_temporal_plain(y, x5, w, b)
    B, Fn, H, W, C = x5.shape
    Ci = y.shape[-1]
    _check_wrapper("y", y, Ci, C)
    cuda_lib.check_operand("x5", x5, dt)
    out = ln_gemm(y.reshape(-1, Ci), act(w, y.dtype), frame_map=(Fn, H * W), bias=f32(b),
                  residual=x5.reshape(-1, C), mode=MODE_RESIDUAL)
    tail_temporal.launches += 1
    return out.reshape(x5.shape)


tail_temporal.launches = 0


# ---------------------------------------------------------------------------
# kernels 7 and 8: SpatialTransformer head and tail
# ---------------------------------------------------------------------------


def head_spatial_plain(x4, mul, add, w, b):
    """Plain version of kernel 7: [BF,H,W,C] -> [BF, H*W, Ci]."""
    BF, H, W, C = x4.shape
    xn = _apply(x4.reshape(BF, H * W, C), mul, add).to(x4.dtype)
    return _proj(xn, w, b)


def head_spatial(x4, mul, add, w, b):
    """Kernel 7: GroupNorm apply with the folded vectors ``(mul, add)``
    [BF, C] -> proj_in + bias: [BF,H,W,C] -> [BF, H*W, Ci]. On the card: the
    GEMM with the GroupNorm prologue, one sample per H*W rows."""
    cuda_lib.check_dtypes("head_spatial", x4)
    if not cuda_lib.use_kernel(x4, w):
        return head_spatial_plain(x4, mul, add, w, b)
    BF, H, W, C = x4.shape
    Ci = w.shape[0]
    _check_wrapper("x4", x4, C, Ci)
    y = ln_gemm(x4.reshape(-1, C), act(w, x4.dtype), gn=(mul, add), rows_per_sample=H * W,
                bias=f32(b))
    head_spatial.launches += 1
    return y.reshape(BF, H * W, Ci)


head_spatial.launches = 0


def gn_proj_in_spatial(x4, gn_scale, gn_bias, w, b, *, eps: float = 1e-6):
    """[BF,H,W,C] -> GroupNorm(32) per frame -> [BF, H*W, Ci] proj_in tokens
    (the SpatialTransformer head): the statistics pass, then
    :func:`head_spatial`."""
    mul, add = group_norm_fold(x4, gn_scale, gn_bias, eps=eps)
    return head_spatial(x4, mul, add, w, b)


def tail_spatial_plain(y, x4, w, b):
    """Plain version of kernel 8: [BF,N,Ci], [BF,H,W,C] -> [BF,H,W,C]."""
    BF, H, W, C = x4.shape
    o = _proj(y, w, b)
    return (o + x4.reshape(BF, H * W, C)).reshape(BF, H, W, C)


def tail_spatial(y, x4, w, b):
    """proj_out -> + residual: [BF,N,Ci], [BF,H,W,C] -> [BF,H,W,C]. On the
    card: the GEMM with the residual epilogue."""
    dt = cuda_lib.check_dtypes("tail_spatial", y, x4)
    if not cuda_lib.use_kernel(y, x4, w):
        return tail_spatial_plain(y, x4, w, b)
    C = x4.shape[-1]
    Ci = y.shape[-1]
    _check_wrapper("y", y, Ci, C)
    cuda_lib.check_operand("x4", x4, dt)
    out = ln_gemm(y.reshape(-1, Ci), act(w, y.dtype), bias=f32(b), residual=x4.reshape(-1, C),
                  mode=MODE_RESIDUAL)
    tail_spatial.launches += 1
    return out.reshape(x4.shape)


tail_spatial.launches = 0


# ---------------------------------------------------------------------------
# kernel 9: GroupNorm [-> SiLU]
# ---------------------------------------------------------------------------


def gn_silu_plain(x, mul, add, *, act: bool = True):
    """Plain version of kernel 9: ``silu(x * mul[b] + add[b])`` in fp32,
    rounded to x.dtype (no SiLU with ``act=False``)."""
    h = _apply(x, mul, add)
    if act:
        h = h * torch.sigmoid(h)
    return h.to(x.dtype)


def gn_silu_apply(x, mul, add, *, act: bool = True):
    """Kernel 9: ``silu(x * mul[b] + add[b])`` with the folded vectors
    ``(mul, add)`` [B, C] per sample x.shape[0] (no SiLU with
    ``act=False``). x: [B, *spatial, C] bf16 or fp32. On the card: one
    elementwise pass."""
    dt = cuda_lib.check_dtypes("gn_silu_apply", x)
    if not cuda_lib.use_kernel(x):
        return gn_silu_plain(x, mul, add, act=act)
    B, C = x.shape[0], x.shape[-1]
    cuda_lib.check_operand("x", x, dt)
    if C % 8 or C > 6144:
        raise ValueError(f"gn_silu kernel takes C % 8 == 0 and C <= 6144, got C={C}")
    y = torch.empty_like(x)
    cuda_lib.call("ds_gn_silu", cuda_lib.ptr(x), B, x.numel() // B, C, cuda_lib.ptr(mul),
                  cuda_lib.ptr(add), int(act), cuda_lib.ptr(y), int(dt == torch.float32))
    gn_silu_apply.launches += 1
    return y


gn_silu_apply.launches = 0


def gn_silu(x, gn_scale, gn_bias, *, eps: float = 1e-5, act: bool = True, vectors: bool = False, plan=None):
    """GroupNorm(32) [-> SiLU] with statistics per sample x.shape[0]
    (ResBlock / TemporalConvBlock / UNet out prologue; the VAE passes
    eps=1e-6): the JAX ``gn_silu`` (``group_norm_fold``, then kernel 9).
    On the card one call of ``csrc/gn_silu.cu::ds_group_norm_silu`` on the
    route of :func:`cuda_lib.gn_plan` for the card's SMs (a thread-block
    cluster a sample with the slab in shared memory; ``ds_gn_stats``'s
    kernels then the apply kernel; or one cooperative launch over every SM
    that walks the samples in passes), counted in ``gn_silu.launches`` (and,
    on the split route, ``gn_silu.launches_split``: the call launches the
    statistics kernels too). ``plan`` a :class:`cuda_lib.GnPlan` to take
    instead (to time the routes). With ``vectors`` also returns the folded
    ``(mul, add)`` [B, C] fp32 the call applied (to check the statistics).
    x bf16 or fp32 (the fp32 instantiation of the same kernels, ``gn_plan``
    at 4-byte elements)."""
    dt = cuda_lib.check_dtypes("gn_silu", x)
    if not cuda_lib.use_kernel(x):
        mul, add = group_norm_fold_plain(x, gn_scale, gn_bias, 32, eps)
        y = gn_silu_plain(x, mul, add, act=act)
        return (y, (mul, add)) if vectors else y
    B, C = x.shape[0], x.shape[-1]
    cuda_lib.check_operand("x", x, dt)
    if C % 32 or C > 6144 or x.numel() == 0 or B > 65535:
        raise ValueError(f"ds_group_norm_silu takes C % 32 == 0, C <= 6144 and B <= 65535, got shape "
                         f"{tuple(x.shape)}")
    M = x.numel() // (B * C)
    if plan is None:
        plan = cuda_lib.gn_plan(B, M, C, 32, x.element_size(), cuda_lib.sm_count(x.device))
    s, b = _gn_vectors(gn_scale, gn_bias)
    y = torch.empty_like(x)
    # [2, B, C] mul | add, then the split route's partials [splits, B, 2, C]
    # or the grid route's partials and counter
    n = {"split": 2 * B * C * (plan.splits + 1), "grid": cuda_lib.gn_grid_scratch(plan, B, C),
         "cluster": 2 * B * C if vectors else 0}[plan.route]
    scratch = torch.empty(n, device=x.device, dtype=torch.float32) if n else None
    cuda_lib.call("ds_group_norm_silu", cuda_lib.ptr(x), B, M, C, 32, cuda_lib.ptr(s), cuda_lib.ptr(b),
                  int(s.dtype == torch.float32), float(eps), int(act), cuda_lib.GN_ROUTES.index(plan.route), plan.cs,
                  plan.rows, plan.smem, plan.splits, cuda_lib.ptr(scratch), cuda_lib.ptr(y),
                  int(dt == torch.float32))
    gn_silu.launches += 1
    if plan.route == "split":
        gn_silu.launches_split += 1
    return (y, tuple(scratch[:2 * B * C].view(2, B, C).unbind(0))) if vectors else y


gn_silu.launches = 0
gn_silu.launches_split = 0
