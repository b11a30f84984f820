"""Kernel 10: the whole temporal BasicTransformerBlock in one launch.

Counterpart of ``dynamicscaler_tpu/ops/fused_block.py``
``fused_temporal_block`` (Pallas ``_temporal_block_call``): LN1 -> 16-frame
self-attention -> + x, LN2 -> 16-frame self-attention -> + x, LN3 -> GEGLU
FF -> + x, over x [rows, 16, C]. Weights are in torch ``Linear`` layout
``[out, in]``.

On the card the block runs as ``csrc/block.cu::ds_temporal_block``: one
thread block owns two 16-frame rows and keeps them in shared memory through
all three sub-blocks (see the note there for what bounds it). The plain
version is the three sub-blocks' plain versions in sequence (K1, K1, K4),
which hold the TPU kernel's rounding points. The wrapper counts its kernel
launches in ``fused_temporal_block.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamicscaler_tpu_torch.ops import cuda_lib
from dynamicscaler_tpu_torch.ops.fused_temporal import (
    AttnOperands,
    FFOperands,
    ln_attention_plain,
    ln_geglu_plain,
    pack_ln_attention,
    pack_ln_geglu,
)


class BlockOperands(NamedTuple):
    """Kernel operands of one block: the two attention sub-blocks' (as K1
    packs them, but with the q, k and v rows of each head of 64 together)
    and the feed-forward's (as K4 packs them)."""

    attn1: AttnOperands
    attn2: AttnOperands
    ff: FFOperands


def _rows_by_head(op: AttnOperands) -> AttnOperands:
    """q|k|v weight rows [3C, C] -> rows ordered (head, q|k|v, 64)."""
    C = op.w_in.shape[1]
    w = op.w_in.reshape(3, C // 64, 64, C).transpose(0, 1).reshape(3 * C, C).contiguous()
    return op._replace(w_in=w)


def pack_temporal_block(lns, attn1, attn2, ff, *, dtype) -> BlockOperands:
    s1, b1, s2, b2, s3, b3 = lns
    return BlockOperands(_rows_by_head(pack_ln_attention(s1, b1, *attn1, dtype=dtype)),
                         _rows_by_head(pack_ln_attention(s2, b2, *attn2, dtype=dtype)),
                         pack_ln_geglu(s3, b3, *ff, dtype=dtype))


def temporal_block_plain(x, lns, attn1, attn2, ff, *, heads, scale, eps=1e-5):
    """Plain PyTorch version of kernel 10. x [R, F, C]; lns (s1, b1, s2, b2,
    s3, b3); attn1/attn2 (wq, wk, wv, wo, bo); ff (w1, b1, w2, b2)."""
    s1, b1, s2, b2, s3, b3 = lns
    x = ln_attention_plain(x, s1, b1, *attn1, heads=heads, scale=scale, eps=eps)
    x = ln_attention_plain(x, s2, b2, *attn2, heads=heads, scale=scale, eps=eps)
    return ln_geglu_plain(x, s3, b3, *ff, eps=eps)


def _check_operands(op: BlockOperands, C: int) -> None:
    for name, a in (("attn1", op.attn1), ("attn2", op.attn2)):
        cuda_lib.check_operand(f"{name} w_qkv", a.w_in, shape=(3 * C, C))
        cuda_lib.check_operand(f"{name} wo", a.wo, shape=(C, C))
        for v in (a.ln_scale, a.ln_bias, a.bo):
            cuda_lib.check_operand(f"{name} vector", v, torch.float32, (C,))
    f = op.ff
    cuda_lib.check_operand("ff w1", f.w1, shape=(8 * C, C))
    cuda_lib.check_operand("ff w2", f.w2, shape=(C, 4 * C))
    cuda_lib.check_operand("ff b1", f.b1, torch.float32, (8 * C,))
    for v in (f.ln_scale, f.ln_bias, f.b2):
        cuda_lib.check_operand("ff vector", v, torch.float32, (C,))


def fused_temporal_block(x, lns, attn1, attn2, ff, *, heads, scale, eps=1e-5, operands=None):
    """Kernel 10: the whole temporal BasicTransformerBlock. x [rows, F, C];
    returns [rows, F, C]. On the card one launch of
    ``ds_temporal_block`` (F = 16, head dim 64, 128 <= C <= 512), reading
    ``operands`` (from :func:`pack_temporal_block`; packed here when None)."""
    if not cuda_lib.use_kernel(x):
        return temporal_block_plain(x, lns, attn1, attn2, ff, heads=heads, scale=scale, eps=eps)
    R, Fn, C = x.shape
    if Fn != 16 or C != heads * 64 or not 128 <= C <= 512:
        raise ValueError(f"kernel 10 takes F=16, head dim 64 and 128 <= C <= 512, got F={Fn} C={C} heads={heads}")
    cuda_lib.check_operand("x", x)
    op = operands or pack_temporal_block(lns, attn1, attn2, ff, dtype=x.dtype)
    _check_operands(op, C)
    out = torch.empty_like(x)
    a1, a2, f = op
    ptrs = [x, out,
            a1.ln_scale, a1.ln_bias, a1.w_in, a1.wo, a1.bo,
            a2.ln_scale, a2.ln_bias, a2.w_in, a2.wo, a2.bo,
            f.ln_scale, f.ln_bias, f.w1, f.b1, f.w2, f.b2]
    cuda_lib.call("ds_temporal_block", cuda_lib.ptr_array(ptrs), R, C, float(scale), float(eps))
    fused_temporal_block.launches += 1
    return out


fused_temporal_block.launches = 0
