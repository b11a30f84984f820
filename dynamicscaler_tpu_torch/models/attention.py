"""Attention stack for the LVDM UNet (PyTorch).

Counterpart of ``dynamicscaler_tpu/models/attention.py`` with VideoCrafter
state_dict names (lvdm/modules/attention.py:43-220). Every attention and
feed-forward sub-block dispatches by SITE to one op:

* self-attention inside a TemporalTransformer (attn1 and, with
  ``temporal_selfatt_only``, attn2) -> K1 ``fused_ln_attention``;
* spatial self-attention (attn1 of a SpatialTransformer) -> K2
  ``fused_ln_spatial_attention``;
* cross-attention (attn2 of a SpatialTransformer) -> K3
  ``fused_ln_cross_attention`` (dual text/image KV with ``to_k_ip``);
* every feed-forward -> K4 ``fused_ln_geglu``;
* a whole temporal block, where the dispatch plan allows ``block`` at its
  width (``fused_temporal.plan_allows``) and its gate admits the shape
  (``fused_block.temporal_block_ok``) -> kernel 10
  ``fused_block.fused_temporal_block``;
* a whole spatial block the same way (``fused_block.spatial_block_ok``) ->
  kernel 11 ``fused_block.fused_spatial_block``, with the context of each
  clip once (of each frame where frames have their own image tokens).

Each op takes its plain PyTorch version for CPU tensors. On the card the
modules hand each op its kernel operands, packed once from their parameters
(``cuda_lib.PackCache``). Sites with a mask (causal temporal attention)
keep plain math here, and so do the sites FreeTraj re-weights
(``CrossAttention._traj_attention``): the JAX package computes that
attention outside any Pallas kernel too. Such a site is chosen because a
``traj`` entry is given, never because a kernel failed. Temporal relative
position (``use_relative_position``; ``relative_position_{k,v}`` tables)
keeps its sites on plain math as well (``CrossAttention._plain_self``), as
the JAX package computes it outside any Pallas kernel
(attention.py:162-178, 211-249): off K1 and off the whole-block kernel 10,
while the block's feed-forward stays on K4.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dynamicscaler_tpu_torch.models.layers import FeedForward, layer_norm
from dynamicscaler_tpu_torch.ops import cuda_lib, fused_block, fused_spatial, fused_temporal
from dynamicscaler_tpu_torch.ops.freetraj import pair_mul
from dynamicscaler_tpu_torch.ops.fused_temporal import mm_f32

SITE_TEMPORAL = "temporal"  # self-attention over frame tokens
SITE_SPATIAL = "spatial"  # self-attention over H*W tokens
SITE_CROSS = "cross"  # attention to the text (+ image) context


class RelativePosition(nn.Module):
    """Learned relative-position embeddings of the temporal attention
    (lvdm/modules/attention.py:21-40): ``embeddings_table`` [2 L + 1, d];
    ``forward(n, m)`` -> [n, m, d], row ``clip(j - i, -L, L) + L`` for
    query i and key j."""

    def __init__(self, num_units: int, max_relative_position: int):
        super().__init__()
        self.max_relative_position = max_relative_position
        self.embeddings_table = nn.Parameter(torch.empty(2 * max_relative_position + 1, num_units))

    def forward(self, length_q: int, length_k: int) -> torch.Tensor:
        L = self.max_relative_position
        dev = self.embeddings_table.device
        dist = torch.arange(length_k, device=dev)[None, :] - torch.arange(length_q, device=dev)[:, None]
        return self.embeddings_table[dist.clamp(-L, L) + L]


class CrossAttention(nn.Module):
    """Self/cross attention with optional dual image-KV and temporal
    relative position (lvdm/modules/attention.py:43-127). ``forward`` runs
    the whole LN -> attention -> out-proj -> +x sub-block."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, img_cross_attention: bool = False,
                 text_context_len: int = 77, relative_position: bool = False,
                 temporal_length: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        self.text_context_len = text_context_len
        self.img_cross_attention = img_cross_attention
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))
        if img_cross_attention:
            self.to_k_ip = nn.Linear(context_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(context_dim, inner, bias=False)
        self.relative_position = relative_position
        if relative_position:
            if temporal_length is None:
                raise ValueError("relative position needs the temporal length")
            self.relative_position_k = RelativePosition(dim_head, temporal_length)
            self.relative_position_v = RelativePosition(dim_head, temporal_length)
        self._operands = cuda_lib.PackCache()

    def forward(self, x, ln: nn.LayerNorm, site: str, context=None, mask=None, traj=None):
        if traj is not None:
            if self.relative_position:
                raise ValueError("FreeTraj with temporal relative position is not supported (as in the JAX package)")
            return self._traj_plain(x, ln, context, mask, traj)
        if mask is not None or self.relative_position:
            return self._plain_self(x, ln, mask)
        out = self.to_out[0]
        args = (ln.weight, ln.bias, self.to_q.weight, self.to_k.weight, self.to_v.weight,
                out.weight, out.bias)
        kw = dict(heads=self.heads, scale=self.scale, eps=ln.eps)
        if site == SITE_CROSS:
            ip = (self.to_k_ip.weight, self.to_v_ip.weight) if self.img_cross_attention else (None, None)
            ops = self._packed(x, fused_spatial.pack_ln_cross_attention, *args, *ip)
            return fused_spatial.fused_ln_cross_attention(
                x, context, *args, *ip, text_len=self.text_context_len, operands=ops, **kw
            )
        if site in (SITE_TEMPORAL, SITE_SPATIAL):
            op = (fused_temporal.fused_ln_attention if site == SITE_TEMPORAL
                  else fused_spatial.fused_ln_spatial_attention)
            return op(x, *args, operands=self._packed(x, fused_temporal.pack_ln_attention, *args), **kw)
        raise ValueError(f"unknown attention site {site!r}")

    def _packed(self, x, pack, *params):
        """The op's kernel operands for a CUDA ``x``, packed once; None on
        the CPU, where the op runs its plain version."""
        if not x.is_cuda:
            return None
        return self._operands.get(lambda: pack(*params, dtype=x.dtype), params, x.dtype)

    def _plain_self(self, x, ln, mask):
        """Self-attention with a mask (causal temporal configs) and/or
        relative position, plain math: fp32 logits q k^T * scale, plus
        with relative position the bias q . table_k[j - i] * scale; masked
        entries at the fp32 minimum; fp32 softmax rounded to the activation
        type; P V, plus with relative position P . table_v[j - i]
        (attention.py:211-249; the JAX package recomputes the same
        probabilities for the second term)."""
        B, N, _ = x.shape
        h, d = self.heads, self.dim_head
        dt = x.dtype
        xn = layer_norm(x, ln.weight, ln.bias, ln.eps)

        def split(t):
            return t.reshape(B, N, h, d).transpose(1, 2)

        q, k, v = (split(mm_f32(xn, lin.weight).to(dt)).float() for lin in (self.to_q, self.to_k, self.to_v))
        logits = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        if self.relative_position:
            k2 = self.relative_position_k(N, N).to(dt).float()  # [N, M, d]
            logits = logits + torch.einsum("bhnd,nmd->bhnm", q, k2) * self.scale
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        p = torch.softmax(logits, dim=-1).to(dt).float()
        o = torch.matmul(p, v)
        if self.relative_position:
            o = o + torch.einsum("bhnm,nmd->bhnd", p, self.relative_position_v(N, N).to(dt).float())
        o = o.to(dt).transpose(1, 2).reshape(B, N, h * d)
        out = self.to_out[0]
        return (mm_f32(o, out.weight) + out.bias.float()).to(dt) + x

    def _traj_plain(self, x, ln, context, mask, traj):
        """The sub-block with FreeTraj re-weighted attention, plain math as
        the JAX package's unfused path (attention.py:223-275): LN, q/k/v
        in the activation type, :meth:`_traj_attention`, then the image
        keys' attention where the module has them, out-proj + bias, + x."""
        B, N, _ = x.shape
        h, d = self.heads, self.dim_head
        dt = x.dtype
        xn = layer_norm(x, ln.weight, ln.bias, ln.eps)
        ctx = xn if context is None else context.to(dt)
        use_img = self.img_cross_attention and context is not None
        ctx_txt = ctx[:, :self.text_context_len] if use_img else ctx

        def split(t):
            return t.reshape(B, t.shape[1], h, d).transpose(1, 2)

        q = split(mm_f32(xn, self.to_q.weight).to(dt))
        out = self._traj_attention(q, split(mm_f32(ctx_txt, self.to_k.weight).to(dt)),
                                   split(mm_f32(ctx_txt, self.to_v.weight).to(dt)), mask, traj)
        if use_img:
            ctx_img = ctx[:, self.text_context_len:]
            k_ip, v_ip = (split(mm_f32(ctx_img, lin.weight).to(dt)) for lin in (self.to_k_ip, self.to_v_ip))
            p = torch.softmax(torch.matmul(q.float(), k_ip.float().transpose(-1, -2)) * self.scale, dim=-1)
            out = out + torch.matmul(p.to(dt), v_ip)  # image_cross_attention_scale 1.0
        o = out.transpose(1, 2).reshape(B, N, h * d)
        lin = self.to_out[0]
        return (mm_f32(o, lin.weight) + lin.bias.float()).to(dt) + x

    def _traj_attention(self, q, k, v, mask, traj):
        """FreeTraj re-weighted attention over [B, heads, N, d], as the JAX
        package's ``CrossAttention._traj_attention`` (attention.py:72-116;
        reference attention_freetraj.py:178-230 temporal, :319-389 spatial
        self and cross): products in the activation type, fp32 logits.
        ``traj`` for self-attention is {fg [B, N] 0/1, active [B] bool}: at
        active rows the logits are multiplied by :func:`pair_mul` of fg. For
        cross-attention it also holds fg_tok [M] bool and wadd [B, N]: at
        active rows the logits of in-box queries and of the target word's
        columns are floored to the fp32 minimum, and after the softmax the
        bump wadd is added at the target word's columns without
        renormalising."""
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * self.scale
        act = traj["active"][:, None, None, None]
        lowest = torch.finfo(torch.float32).min
        if "fg_tok" not in traj:
            mul = pair_mul(traj["fg"].float())
            logits = torch.where(act, logits * mul[:, None], logits)
            if mask is not None:
                logits = logits.masked_fill(~mask, lowest)
            probs = torch.softmax(logits, dim=-1)
        else:
            tok = traj["fg_tok"][None, None, None, :]
            blocked = act & ((traj["fg"] > 0.5)[:, None, :, None] | tok)
            logits = logits.masked_fill(blocked, lowest)
            if mask is not None:
                logits = logits.masked_fill(~mask, lowest)
            probs = torch.softmax(logits, dim=-1)
            wadd = traj["wadd"].float()[:, None, :, None] * tok
            probs = probs + torch.where(act, wadd, 0.0)
        return torch.matmul(probs.to(v.dtype), v)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn (or a second self-attn) -> GEGLU FF, each with
    a pre-LayerNorm and a residual (lvdm/modules/attention.py:187-220).
    ``temporal`` selects the sites: a temporal block's attn1 and attn2 are
    both frame self-attention (K1); a spatial block's are K2 and K3. A
    temporal block without a mask or relative position runs whole as
    kernel 10, a spatial block with a context whole as kernel 11, where the
    plan allows ``block`` at its width and the kernel's gate admits the
    shape. ``relative_position`` (temporal blocks) gives both attentions
    their tables (attention.py:288-296)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 img_cross_attention: bool = False, text_context_len: int = 77,
                 temporal: bool = False, relative_position: bool = False,
                 temporal_length: Optional[int] = None):
        super().__init__()
        self.temporal = temporal
        self.relative_position = relative_position
        rel = dict(relative_position=relative_position, temporal_length=temporal_length)
        self.attn1 = CrossAttention(dim, None, heads, dim_head, **rel)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(
            dim, None if temporal else context_dim, heads, dim_head,
            img_cross_attention=img_cross_attention and not temporal,
            text_context_len=text_context_len, **rel,
        )
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.dim = dim
        self._operands = cuda_lib.PackCache()

    def weights(self):
        """(lns, attn1, attn2, ff): the block's parameters as the whole-block
        and whole-transformer ops take them (attn2 with the image K/V
        weights where it has them)."""
        lns = tuple(p for n in (self.norm1, self.norm2, self.norm3) for p in (n.weight, n.bias))

        def attn(a):
            out = a.to_out[0]
            ws = (a.to_q.weight, a.to_k.weight, a.to_v.weight, out.weight, out.bias)
            return ws + ((a.to_k_ip.weight, a.to_v_ip.weight) if a.img_cross_attention else ())
        ff = self.ff
        return lns, attn(self.attn1), attn(self.attn2), (ff.net[0].proj.weight, ff.net[0].proj.bias,
                                                        ff.net[2].weight, ff.net[2].bias)

    def forward(self, x, context=None, mask=None, num_frames: int = 1, traj=None):
        """x [B, N, dim]; context [B, L, D], the same rows for each run of
        ``num_frames`` samples (spatial blocks: a clip's frames, or 1 where
        each frame has its own image tokens). ``traj``
        ({"self": ..., "cross": ...}, FreeTraj's per-site factors): attn1
        takes ``traj["self"]`` and attn2 ``traj["cross"]``, so a temporal
        block's second frame self-attention, whose entry is None, stays on
        K1 (attention.py:350-352); a block with either entry skips the
        whole-block kernels (attention.py:320-326)."""
        heads = self.attn1.heads
        inner = heads * self.attn1.dim_head
        side = "t" if self.temporal else "s"
        t_self, t_cross = (traj or {}).get("self"), (traj or {}).get("cross")
        if (mask is None and t_self is None and t_cross is None and not self.relative_position
                and fused_temporal.plan_allows("block", side, self.dim, x.dtype)):
            if self.temporal and fused_block.temporal_block_ok(x.shape[1], inner, self.dim, heads):
                return self._whole(x, fused_block.fused_temporal_block, fused_block.pack_temporal_block)
            if (not self.temporal and context is not None
                    and fused_block.spatial_block_ok(x.shape[1], inner, self.dim, heads, context.shape[-1])):
                return self._whole(x, fused_block.fused_spatial_block, fused_block.pack_spatial_block,
                                   context[::num_frames], text_len=self.attn2.text_context_len)
        if self.temporal:
            x = self.attn1(x, self.norm1, SITE_TEMPORAL, mask=mask, traj=t_self)
            x = self.attn2(x, self.norm2, SITE_TEMPORAL, mask=mask, traj=t_cross)
        else:
            x = self.attn1(x, self.norm1, SITE_SPATIAL, traj=t_self)
            x = self.attn2(x, self.norm2, SITE_CROSS, context=context, traj=t_cross)
        return self.ff(x, self.norm3)

    def _whole(self, x, op, pack, *ctx, **kw):
        """The whole block as kernel 10 or 11 (``op``), its operands packed
        once on the card."""
        w = self.weights()
        ops = None
        if x.is_cuda:
            params = [p for group in w for p in group]
            ops = self._operands.get(lambda: pack(*w, dtype=x.dtype), params, x.dtype)
        return op(x, *ctx, *w, heads=self.attn1.heads, scale=self.attn1.scale, eps=self.norm1.eps, operands=ops,
                  **kw)
