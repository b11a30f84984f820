"""Kernels 10 and 11: the whole temporal and the whole spatial
BasicTransformerBlock.

Counterparts of ``dynamicscaler_tpu/ops/fused_block.py``:

* ``fused_temporal_block`` -> kernel 10 (Pallas ``_temporal_block_call``):
  LN1 -> F-frame self-attention -> + x, LN2 -> F-frame self-attention ->
  + x, LN3 -> GEGLU FF -> + x, over x [rows, F, C];
* ``fused_spatial_block`` -> kernel 11 (``_spatial_block_call``): LN1 ->
  N-token self-attention -> + x, LN2 -> text (+ image) cross-attention -> +
  x, LN3 -> GEGLU FF -> + x, over x [BF, N, C] with the context given per
  CLIP, ``ctx`` [clips, L, Dc] (BF = clips * frames; the UNet repeats it
  over a clip's frames, and the kernel projects its K/V once per clip).

Weights are in torch ``Linear`` layout ``[out, in]``. On the card kernel 10
runs as ``csrc/block.cu::ds_temporal_block`` (one launch; TM tokens of
F-frame rows resident in shared memory through all three sub-blocks, the
weights streamed by TMA once per thread-block cluster into wgmma products,
a row of more than TM frames spread over the cluster; its tile plan from
``cuda_lib.block_plan``, its weights' TMA maps from ``cuda_lib.block_maps``) and
kernel 11 as the context K/V projection and the LN1 -> q|k|v head on
``csrc/gemm.cu``'s GEMM, then ``csrc/mega.cu::ds_spatial_block`` (kernel
13's body without proj_out: TM query tokens resident through the whole
block, the weights and the attention's K/V tiles streamed by TMA into wgmma
products; its tile plan from ``cuda_lib.spatial_plan``, its weights' TMA
maps from ``cuda_lib.spatial_maps``); see the notes there for what bounds
each.
The plain versions are the sub-blocks' plain versions in sequence (K1, K1,
K4; K2, K3, K4), which hold the TPU kernels' rounding points. Each wrapper
counts its kernel launches in ``<wrapper>.launches``.

The gates :func:`temporal_block_ok` and :func:`spatial_block_ok` are the
JAX package's shape conditions (``temporal_block_fusable``,
``spatial_block_fusable``); the module dispatch routes by them and the
wrappers refuse what they do not admit. On the card the kernels also need
head dim 64, as the sub-block kernels K1-K4 do. An fp32 activation takes
the fp32 kernels instead, with the same operands in fp32:
``csrc/temporal_f32.cu::ds_temporal_block_f32`` (one launch on the tensor
cores, the weights split for them once each by
``cuda_lib.tf32_split_weights``, its tile from ``cuda_lib.block_f32_plan``),
and the same GEMM heads (``ds_ln_gemm_f32``) then
``csrc/spatial_f32.cu::ds_spatial_block_f32`` (one launch on the tensor
cores, the N-token and cross-attention included, kernel 10's block and
products at fp32; its query tile from ``cuda_lib.spatial_f32_plan``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.ops.cuda_lib import ln_gemm
from dynamicscaler_tpu_torch.ops.fused_spatial import (
    ln_cross_attention_plain,
    ln_spatial_attention_plain,
    pack_ln_cross_attention,
)
from dynamicscaler_tpu_torch.ops.fused_temporal import (
    AttnOperands,
    FFOperands,
    frames_ok,
    ln_attention_plain,
    ln_geglu_plain,
    pack_ln_attention,
    pack_ln_geglu,
)


class BlockOperands(NamedTuple):
    """Kernel operands of one block: the two attention sub-blocks' and the
    feed-forward's (as K4 packs them). Kernel 10 packs both attentions as K1
    does but with the q, k and v rows of each head of 64 together; kernel 11
    packs attn1 as K2 and attn2 as K3 do."""

    attn1: AttnOperands
    attn2: AttnOperands
    ff: FFOperands
    maps: dict = None  # kernels 10, 11: their weights' TMA maps (cuda_lib.block_maps / spatial_maps), kept with them


def temporal_block_ok(frames: int, inner: int, dim: int, heads: int) -> bool:
    """Kernel 10's gate: the shape conditions of the JAX package's
    ``temporal_block_fusable`` (fused_block.py:214-225)."""
    return frames_ok(frames) and inner == dim and inner % heads == 0 and inner <= 1280 and (inner // heads) % 8 == 0


def spatial_block_ok(n_tokens: int, inner: int, dim: int, heads: int, ctx_dim: int) -> bool:
    """Kernel 11's gate: the shape conditions of the JAX package's
    ``spatial_block_fusable`` (fused_block.py:339-351)."""
    return (256 <= n_tokens <= 4096 and n_tokens % 16 == 0 and inner == dim and inner % heads == 0
            and inner <= 640 and (inner // heads) % 8 == 0 and ctx_dim % 128 == 0)


def refuse_unless(kernel: str, ok: bool, shape: str) -> None:
    """Raise unless the card's kernel takes the shape (``ok``)."""
    if not ok:
        raise ValueError(f"kernel {kernel} does not take {shape}: outside its gate, or not head dim 64 "
                         f"as the card's kernels need")


# ---------------------------------------------------------------------------
# kernel 10: the whole temporal block
# ---------------------------------------------------------------------------


def _rows_by_head(op: AttnOperands) -> AttnOperands:
    """q|k|v weight rows [3C, C] -> rows ordered (head, q|k|v, 64)."""
    C = op.w_in.shape[1]
    w = op.w_in.reshape(3, C // 64, 64, C).transpose(0, 1).reshape(3 * C, C).contiguous()
    return op._replace(w_in=w)


def pack_temporal_block(lns, attn1, attn2, ff, *, dtype) -> BlockOperands:
    s1, b1, s2, b2, s3, b3 = lns
    return BlockOperands(_rows_by_head(pack_ln_attention(s1, b1, *attn1, dtype=dtype)),
                         _rows_by_head(pack_ln_attention(s2, b2, *attn2, dtype=dtype)),
                         pack_ln_geglu(s3, b3, *ff, dtype=dtype), {})


def temporal_block_plain(x, lns, attn1, attn2, ff, *, heads, scale, eps=1e-5):
    """Plain PyTorch version of kernel 10. x [R, F, C]; lns (s1, b1, s2, b2,
    s3, b3); attn1/attn2 (wq, wk, wv, wo, bo); ff (w1, b1, w2, b2)."""
    s1, b1, s2, b2, s3, b3 = lns
    x = ln_attention_plain(x, s1, b1, *attn1, heads=heads, scale=scale, eps=eps)
    x = ln_attention_plain(x, s2, b2, *attn2, heads=heads, scale=scale, eps=eps)
    return ln_geglu_plain(x, s3, b3, *ff, eps=eps)


def check_block_operands(op: BlockOperands, C: int, dt: torch.dtype) -> None:
    """Kernel 10's (and 12's) packed block operands at width C, weights in
    the activation type ``dt``."""
    for name, a in (("attn1", op.attn1), ("attn2", op.attn2)):
        cuda_lib.check_operand(f"{name} w_qkv", a.w_in, dt, (3 * C, C))
        cuda_lib.check_operand(f"{name} wo", a.wo, dt, (C, C))
        for v in (a.ln_scale, a.ln_bias, a.bo):
            cuda_lib.check_operand(f"{name} vector", v, torch.float32, (C,))
    _check_ff(op.ff, C, dt)


def _check_ff(f: FFOperands, C: int, dt: torch.dtype) -> None:
    cuda_lib.check_operand("ff w1", f.w1, dt, (8 * C, C))
    cuda_lib.check_operand("ff w2", f.w2, dt, (C, 4 * C))
    cuda_lib.check_operand("ff b1", f.b1, torch.float32, (8 * C,))
    for v in (f.ln_scale, f.ln_bias, f.b2):
        cuda_lib.check_operand("ff vector", v, torch.float32, (C,))


def block_pointers(op: BlockOperands, split: bool = False) -> list:
    """The block operands in ``ds_temporal_block``'s pointer order (after x,
    out); ``split``: every weight split for the tensor cores, [2, N, K]
    (``cuda_lib.tf32_split_weights``, once a weight), as the fp32 kernels 10
    and 12 read them."""
    a1, a2, f = op.attn1, op.attn2, op.ff
    w = cuda_lib.tf32_split_weights if split else (lambda t: t)
    return [a1.ln_scale, a1.ln_bias, w(a1.w_in), w(a1.wo), a1.bo,
            a2.ln_scale, a2.ln_bias, w(a2.w_in), w(a2.wo), a2.bo,
            f.ln_scale, f.ln_bias, w(f.w1), f.b1, w(f.w2), f.b2]


def block_weights(op: BlockOperands) -> list:
    """The weights whose TMA maps ``ds_temporal_block`` reads, in
    ``ds_block_maps``' order: wqkv1, wo1, wqkv2, wo2, w1, w2."""
    a1, a2, f = op.attn1, op.attn2, op.ff
    return [a1.w_in, a1.wo, a2.w_in, a2.wo, f.w1, f.w2]


def fused_temporal_block(x, lns, attn1, attn2, ff, *, heads, scale, eps=1e-5, operands=None, plan=None):
    """Kernel 10: the whole temporal BasicTransformerBlock. x [rows, F, C];
    returns [rows, F, C]. On the card one launch (head dim 64, C <= 1280)
    of ``ds_temporal_block`` (bf16) at the tile ``plan``
    (``cuda_lib.block_plan``'s when None; the kernel refuses one it cannot
    take) with the TMA maps of its weights, or of ``ds_temporal_block_f32``
    (fp32) at the tile ``plan`` (``cuda_lib.block_f32_plan``'s when None)
    with its weights split and a slot of scratch a block
    (``cuda_lib.temporal_f32_scratch``), reading ``operands`` (from
    :func:`pack_temporal_block`; packed here when None)."""
    dt = cuda_lib.check_dtypes("K10", x)
    if not cuda_lib.use_kernel(x):
        return temporal_block_plain(x, lns, attn1, attn2, ff, heads=heads, scale=scale, eps=eps)
    R, Fn, C = x.shape
    refuse_unless("10", temporal_block_ok(Fn, C, C, heads) and C == heads * 64, f"x {tuple(x.shape)} with {heads} heads")
    cuda_lib.check_operand("x", x, dt)
    op = operands or pack_temporal_block(lns, attn1, attn2, ff, dtype=dt)
    check_block_operands(op, C, dt)
    out = torch.empty_like(x)
    if dt == torch.float32:
        plan = plan or cuda_lib.block_f32_plan(C, Fn, R * Fn)
        scratch = torch.empty(cuda_lib.temporal_f32_scratch(R * Fn, C, plan), device=x.device, dtype=dt)
        cuda_lib.call("ds_temporal_block_f32", cuda_lib.ptr_array([x, out, *block_pointers(op, split=True)]), R, Fn,
                      C, float(scale), float(eps), cuda_lib.ptr(scratch), scratch.numel(),
                      cuda_lib.block_f32_grid(plan, R * Fn), *plan)
        fused_temporal_block.launches += 1
        return out
    plan = plan or cuda_lib.block_plan(C, Fn)
    maps = cuda_lib.block_maps(op.maps, block_weights(op), C, plan.cl)
    cuda_lib.call("ds_temporal_block", cuda_lib.ptr_array([x, out, *block_pointers(op)]), R, Fn, C, float(scale),
                  float(eps), maps, *plan)
    fused_temporal_block.launches += 1
    return out


fused_temporal_block.launches = 0


# ---------------------------------------------------------------------------
# kernel 11: the whole spatial block (and the launch it shares with kernel 13)
# ---------------------------------------------------------------------------


def pack_spatial_block(lns, attn1, attn2, ff, *, dtype) -> BlockOperands:
    s1, b1, s2, b2, s3, b3 = lns
    return BlockOperands(pack_ln_attention(s1, b1, *attn1, dtype=dtype),
                         pack_ln_cross_attention(s2, b2, *attn2, dtype=dtype),
                         pack_ln_geglu(s3, b3, *ff, dtype=dtype), {})


def spatial_block_plain(x, ctx, lns, attn1, attn2, ff, *, heads, scale, text_len=77, eps=1e-5):
    """Plain PyTorch version of kernel 11. x [BF, N, C]; ctx [clips, L, Dc];
    lns (s1, b1, s2, b2, s3, b3); attn1 (wq, wk, wv, wo, bo); attn2 the same,
    + (wk_ip, wv_ip) with image keys; ff (w1, b1, w2, b2)."""
    s1, b1, s2, b2, s3, b3 = lns
    ctx_s = ctx.repeat_interleave(x.shape[0] // ctx.shape[0], dim=0)
    h = ln_spatial_attention_plain(x, s1, b1, *attn1, heads=heads, scale=scale, eps=eps)
    h = ln_cross_attention_plain(h, ctx_s, s2, b2, *attn2, heads=heads, scale=scale, text_len=text_len, eps=eps)
    return ln_geglu_plain(h, s3, b3, *ff, eps=eps)


def check_spatial_operands(op: BlockOperands, Ci: int, Dc: int, has_img: bool, dt: torch.dtype) -> None:
    """Kernel 11's (and 13's) packed block operands at width Ci, weights in
    the activation type ``dt``."""
    f32 = torch.float32
    cuda_lib.check_operand("attn1 w_qkv", op.attn1.w_in, dt, (3 * Ci, Ci))
    cuda_lib.check_operand("attn2 wq", op.attn2.w_in, dt, (Ci, Ci))
    if len(op.attn2.w_kv) != 1 + has_img:
        raise ValueError(f"attn2 packs {len(op.attn2.w_kv)} key segments, the call has {1 + has_img}")
    for w_kv in op.attn2.w_kv:
        cuda_lib.check_operand("attn2 w_kv", w_kv, dt, (2 * Ci, Dc))
    for a in (op.attn1, op.attn2):
        cuda_lib.check_operand("wo", a.wo, dt, (Ci, Ci))
        for v in (a.ln_scale, a.ln_bias, a.bo):
            cuda_lib.check_operand("attention vector", v, f32, (Ci,))
    _check_ff(op.ff, Ci, dt)


def spatial_weights(op: BlockOperands) -> list:
    """The block weights whose TMA maps ``ds_spatial_block`` /
    ``ds_mega_spatial`` read, in ``ds_spatial_maps``' order: wo1, wq2, wo2,
    w1, w2."""
    return [op.attn1.wo, op.attn2.w_in, op.attn2.wo, op.ff.w1, op.ff.w2]


def spatial_launch(x3, ctx, op: BlockOperands, wrapper, maps: dict, *, heads, scale, text_len, eps, plan=None):
    """Launch kernel 13 (``wrapper`` = (mul, add, w_in, b_in, w_out, b_out))
    or kernel 11 (``wrapper`` None) on x3 [BF, N, C] with the per-clip
    context ``ctx`` [clips, L, Dc]: by ``ds_ln_gemm`` the context K|V of each
    segment (text; image from ``text_len`` on with image keys) once per clip,
    (kernel 13) GroupNorm apply -> proj_in -> h, and LN1(h) -> q|k|v; then
    ``ds_mega_spatial`` / ``ds_spatial_block`` at ``cuda_lib.spatial_plan``'s
    tile with the weights' TMA maps, encoded once into ``maps`` (bf16), or
    ``ds_mega_spatial_f32`` / ``ds_spatial_block_f32`` (fp32) at the query
    tile ``plan`` (``cuda_lib.spatial_f32_plan``'s when None) with every
    weight split once (``cuda_lib.tf32_split_weights``) and its scratch
    (``cuda_lib.spatial_f32_scratch``). Returns [BF, N, C]."""
    BF, N, C = x3.shape
    clips, L, Dc = ctx.shape
    dt = x3.dtype
    has_img = len(op.attn2.w_kv) == 2
    Lt = text_len if has_img else L
    ctx = ctx.to(dt)
    segs = (ctx[:, :Lt], ctx[:, Lt:]) if has_img else (ctx,)
    kv = [ln_gemm(c.reshape(-1, Dc).contiguous(), w) for c, w in zip(segs, op.attn2.w_kv)]
    x2 = x3.reshape(BF * N, C)
    a1, a2, f = op.attn1, op.attn2, op.ff
    weights = spatial_weights(op)
    b_out = None
    h = x2
    if wrapper:
        mul, add, w_in, b_in, w_out, b_out = wrapper
        h = ln_gemm(x2, w_in, gn=(mul, add), rows_per_sample=N, bias=b_in)
        weights.append(w_out)
    qkv = ln_gemm(h, a1.w_in, ln=(a1.ln_scale, a1.ln_bias), eps=eps)
    out = torch.empty_like(x3)
    ptrs = [h, x2 if wrapper else None, qkv, kv[0], kv[1] if has_img else None,
            a1.bo, a2.ln_scale, a2.ln_bias, a2.bo, f.ln_scale, f.ln_bias, f.b1, f.b2, b_out, out]
    if dt == torch.float32:
        plan = plan or cuda_lib.spatial_f32_plan(C, N, BF)
        scratch = torch.empty(cuda_lib.spatial_f32_scratch(BF, N, C, clips, (Lt, L - Lt), plan), device=x3.device,
                              dtype=dt)
        cuda_lib.call("ds_mega_spatial_f32" if wrapper else "ds_spatial_block_f32",
                      cuda_lib.ptr_array(ptrs + [cuda_lib.tf32_split_weights(w) for w in weights]), BF, N, C,
                      BF // clips, Lt, L - Lt, float(scale), float(eps), cuda_lib.ptr(scratch), scratch.numel(),
                      cuda_lib.spatial_f32_grid(plan, BF, N), plan.tm)
        return out
    ptrs = cuda_lib.ptr_array(ptrs)
    cuda_lib.call("ds_mega_spatial" if wrapper else "ds_spatial_block", ptrs, BF, N, C, BF // clips, Lt, L - Lt,
                  float(scale), float(eps), cuda_lib.spatial_maps(maps, weights, C), *cuda_lib.spatial_plan(C))
    return out


def fused_spatial_block(x, ctx, lns, attn1, attn2, ff, *, heads, scale, text_len=77, eps=1e-5, operands=None,
                        plan=None):
    """Kernel 11: the whole spatial BasicTransformerBlock. x [BF, N, C]; ctx
    [clips, L, Dc] per clip (BF = clips * frames); returns [BF, N, C]. On the
    card :func:`spatial_launch` (the context K/V and q|k|v GEMMs, then one
    launch of ``ds_spatial_block``, or at fp32 of ``ds_spatial_block_f32``
    at the query tile ``plan``), reading ``operands`` (from
    :func:`pack_spatial_block`; packed here when None) and their TMA maps."""
    dt = cuda_lib.check_dtypes("K11", x)
    if not cuda_lib.use_kernel(x, ctx):
        return spatial_block_plain(x, ctx, lns, attn1, attn2, ff, heads=heads, scale=scale, text_len=text_len,
                                   eps=eps)
    BF, N, C = x.shape
    clips, L, Dc = ctx.shape
    has_img = len(attn2) == 7
    refuse_unless("11", spatial_block_ok(N, C, C, heads, Dc) and C == heads * 64 and BF % clips == 0
                  and (not has_img or 0 < text_len < L), f"x {tuple(x.shape)} ctx {tuple(ctx.shape)} with {heads} heads")
    cuda_lib.check_operand("x", x, dt)
    op = operands or pack_spatial_block(lns, attn1, attn2, ff, dtype=dt)
    check_spatial_operands(op, C, Dc, has_img, dt)
    out = spatial_launch(x, ctx, op, None, op.maps, heads=heads, scale=scale, text_len=text_len, eps=eps, plan=plan)
    fused_spatial_block.launches += 1
    return out


fused_spatial_block.launches = 0
