"""The x-transformer stack in PyTorch (reference: lvdm/modules/x_transformer.py).

Counterpart of ``dynamicscaler_tpu/models/x_transformer.py``: lucidrains'
x-transformers as the reference vendors them (Attention :214,
AttentionLayers :369, Encoder :540, TransformerWrapper :547), imported by no
shipped config. The modules carry the reference's state_dict names, so a
reference state dict loads with ``load_state_dict``: per layer
``layers.{i}.0`` the norm (nothing under rezero), ``layers.{i}.1`` the block
(``.1.fn`` under rezero for attention, ``.1.g`` its gain, and under macaron
for the feed-forward), ``layers.{i}.2`` the residual (``.2.gru`` when
gated); the attention's ``to_q`` / ``to_k`` / ``to_v``, ``to_out`` (``to_out.0``
with ``on_attn``), ``pre_softmax_proj`` / ``post_softmax_proj``, ``mem_k`` /
``mem_v``; the feed-forward's ``net.0.0`` (or ``net.0.proj`` with GEGLU) and
``net.2``; the wrapper's ``token_emb``, ``pos_emb.emb``, ``project_emb``,
``memory_tokens``, ``norm`` and ``to_logits``.

Tokens are [B, N, D]; attention is einsum over heads with its softmax in
fp32, plain PyTorch, as the JAX twin is plain XLA. Inference only (dropout
off). The knobs are the JAX twin's: causal, talking_heads, sparse_topk,
num_mem_kv, on_attn, position_infused_attn, use_scalenorm / use_rmsnorm /
use_rezero, pre_norm / post-norm, gate_residual, macaron (the feed-forward
scaled by 0.5: the reference's own macaron crashes), sandwich_coef,
par_ratio, custom_layers, cross_attend / only_cross, residual_attn /
cross_residual_attn, memory tokens, tie_embedding, mems. ``use_entmax15``
raises ``NotImplementedError``, as the reference does (:230-231). The public
modules take their ``dtype`` and ``device``: the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamicscaler_tpu_torch.models.layers import layer_norm, place

DEFAULT_DIM_HEAD = 64


# ---------------------------------------------------------------------------
# positional embeddings
# ---------------------------------------------------------------------------


class AbsolutePositionalEmbedding(nn.Module):
    """Learned absolute positions (x_transformer.py:24-35): ``emb`` an
    ``nn.Embedding(max_seq_len, dim)``; ``forward(n)`` -> [1, n, dim]."""

    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.emb = nn.Embedding(max_seq_len, dim)

    def forward(self, n: int) -> torch.Tensor:
        return self.emb.weight[None, :n]


def fixed_positional_embedding(dim: int, n: int, offset: int = 0, dtype=torch.float32,
                               device=None) -> torch.Tensor:
    """Parameter-free sinusoids (x_transformer.py:38-48): [1, n, dim], sin
    then cos, positions ``offset`` .. ``offset + n - 1``."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(n, dtype=torch.float32, device=device) + offset
    sinusoid = torch.einsum("i,j->ij", t, inv_freq)
    return torch.cat([torch.sin(sinusoid), torch.cos(sinusoid)], dim=-1)[None].to(dtype)


# ---------------------------------------------------------------------------
# norms / residuals
# ---------------------------------------------------------------------------


def _l2_norm(x, g, dim: int, eps: float):
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * dim ** -0.5
    return x / norm.clamp_min(eps) * g


class ScaleNorm(nn.Module):
    """L2 scale norm with one gain ``g`` (x_transformer.py:138-147)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return _l2_norm(x, self.g, self.dim, self.eps)


class RMSNorm(nn.Module):
    """L2 norm with a gain ``g`` a channel (x_transformer.py:150-159)."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return _l2_norm(x, self.g, self.dim, self.eps)


class _LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm(dim)`` (eps 1e-5) with the JAX twin's statistics
    (fp32 fast variance, ``models/layers.layer_norm``)."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class GRUGating(nn.Module):
    """GRU-cell gated residual (x_transformer.py:167-180): ``gru`` an
    ``nn.GRUCell(dim, dim)`` with input ``x`` and hidden state
    ``residual``, its cell written out (gates r, z, n in the rows of
    ``weight_ih`` / ``weight_hh`` in that order)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gru = nn.GRUCell(dim, dim)

    def forward(self, x, residual):
        g = self.gru
        i_r, i_z, i_n = F.linear(x, g.weight_ih, g.bias_ih).chunk(3, dim=-1)
        h_r, h_z, h_n = F.linear(residual, g.weight_hh, g.bias_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * residual


class _Residual(nn.Module):
    """The reference's parameter-free ``Residual``."""

    def forward(self, x, residual):
        return x + residual


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------


class _GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        v, gate = self.proj(x).chunk(2, dim=-1)
        return v * F.gelu(gate)


class FeedForward(nn.Module):
    """Linear + GELU (erf), or GEGLU with ``glu``, then Linear
    (x_transformer.py:183-211): ``net.0.0`` or ``net.0.proj``, ``net.2``."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4, glu: bool = False):
        super().__init__()
        inner = int(dim * mult)
        project_in = _GEGLU(dim, inner) if glu else nn.Sequential(nn.Linear(dim, inner), nn.GELU())
        self.net = nn.Sequential(project_in, nn.Dropout(0.0), nn.Linear(inner, dim_out if dim_out is not None else dim))

    def forward(self, x):
        return self.net(x)


class _Scale(nn.Module):
    """The reference's ``Scale(value, fn)`` around the macaron
    feed-forward (parameter-free, ``.fn``), scaling the output as the JAX
    twin does (the reference's forward, x_transformer.py:122-124, unpacks a
    tensor and crashes)."""

    def __init__(self, value: float, fn: nn.Module):
        super().__init__()
        self.value, self.fn = value, fn

    def forward(self, x):
        return self.fn(x) * self.value


class _Rezero(nn.Module):
    """The reference's ``Rezero(fn)``: the attention's output times the
    gain ``g`` (zero at init)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))

    def forward(self, x, **kwargs):
        out, inter = self.fn(x, **kwargs)
        return out * self.g, inter


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def keep_topk(dots: torch.Tensor, k: int, mask_value: float) -> torch.Tensor:
    """Sparse top-k: every logit not below the k-th largest of its row
    survives (ties too); the rest get ``mask_value``."""
    vk = torch.topk(dots, k, dim=-1).values[..., -1:]
    return dots.masked_fill(dots < vk, mask_value)


class Attention(nn.Module):
    """Full-option einsum attention (x_transformer.py:214-366). Returns
    ``(out, pre_softmax_attn)``: the logits after ``prev_attn`` is added and
    before talking heads and masks, which residual attention feeds to the
    next layer of the same kind."""

    def __init__(self, dim: int, dim_head: int = DEFAULT_DIM_HEAD, heads: int = 8, causal: bool = False,
                 talking_heads: bool = False, sparse_topk: Optional[int] = None, num_mem_kv: int = 0,
                 on_attn: bool = False, use_entmax15: bool = False):
        super().__init__()
        if use_entmax15:
            raise NotImplementedError("entmax15 is unimplemented upstream (x_transformer.py:230-231)")
        self.dim, self.dim_head, self.heads = dim, dim_head, heads
        self.causal, self.talking_heads = causal, talking_heads
        self.sparse_topk, self.num_mem_kv = sparse_topk, num_mem_kv
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        if talking_heads:
            self.pre_softmax_proj = nn.Parameter(torch.randn(heads, heads))
            self.post_softmax_proj = nn.Parameter(torch.randn(heads, heads))
        if num_mem_kv > 0:
            self.mem_k = nn.Parameter(torch.randn(heads, num_mem_kv, dim_head))
            self.mem_v = nn.Parameter(torch.randn(heads, num_mem_kv, dim_head))
        self.to_out = nn.Sequential(nn.Linear(inner, dim * 2), nn.GLU()) if on_attn else nn.Linear(inner, dim)

    def forward(self, x, context=None, mask=None, context_mask=None, pia_offset_emb: bool = False,
                prev_attn=None, mem=None) -> Tuple[torch.Tensor, torch.Tensor]:
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        kv_input = context if context is not None else x
        q_input, k_input, v_input = x, kv_input, kv_input
        if mem is not None:  # shortformer cached memory (:287-289)
            k_input = torch.cat([mem, k_input], dim=-2)
            v_input = torch.cat([mem, v_input], dim=-2)
        if pia_offset_emb:  # position-infused attention (:291-295)
            offset = k_input.shape[-2] - q_input.shape[-2]
            q_input = q_input + fixed_positional_embedding(self.dim, q_input.shape[-2], offset, q_input.dtype,
                                                           x.device)
            k_input = k_input + fixed_positional_embedding(self.dim, k_input.shape[-2], 0, k_input.dtype, x.device)

        def split_heads(t):
            return t.reshape(t.shape[0], t.shape[1], h, dh).transpose(1, 2)

        q, k, v = split_heads(self.to_q(q_input)), split_heads(self.to_k(k_input)), split_heads(self.to_v(v_input))

        input_mask = None
        if mask is not None or context_mask is not None:
            q_mask = mask if mask is not None else torch.ones((b, n), dtype=torch.bool, device=x.device)
            k_mask = q_mask if context is None else context_mask
            if k_mask is None:
                k_mask = torch.ones((b, k.shape[-2]), dtype=torch.bool, device=x.device)
            input_mask = q_mask[:, None, :, None] & k_mask[:, None, None, :]

        if self.num_mem_kv > 0:  # learned memory KV (:311-316)
            k = torch.cat([self.mem_k.expand(b, -1, -1, -1), k], dim=-2)
            v = torch.cat([self.mem_v.expand(b, -1, -1, -1), v], dim=-2)
            if input_mask is not None:
                input_mask = F.pad(input_mask, (self.num_mem_kv, 0), value=True)

        dots = torch.einsum("bhid,bhjd->bhij", q, k) * dh ** -0.5
        mask_value = -torch.finfo(dots.dtype).max
        if prev_attn is not None:  # residual attention (:321-322)
            dots = dots + prev_attn
        pre_softmax_attn = dots  # before talking heads and masks (:324)

        if self.talking_heads:
            dots = torch.einsum("bhij,hk->bkij", dots, self.pre_softmax_proj)
        if input_mask is not None:
            dots = dots.masked_fill(~input_mask, mask_value)
        if self.causal:  # the causal mask padded on the left for mems (:337-343)
            i, j = dots.shape[-2:]
            r = torch.arange(i, device=x.device)
            cm = F.pad(r[:, None] < r[None, :], (j - i, 0), value=False)
            dots = dots.masked_fill(cm, mask_value)
        if self.sparse_topk is not None and self.sparse_topk < dots.shape[-1]:
            dots = keep_topk(dots, self.sparse_topk, mask_value)

        attn = torch.softmax(dots.float(), dim=-1).to(dots.dtype)
        if self.talking_heads:
            attn = torch.einsum("bhij,hk->bkij", attn, self.post_softmax_proj)
        out = torch.einsum("bhij,bhjd->bhid", attn, v).transpose(1, 2).reshape(b, n, h * dh)
        return self.to_out(out), pre_softmax_attn


# ---------------------------------------------------------------------------
# layer stack
# ---------------------------------------------------------------------------


def _resolve_layer_types(depth: int, cross_attend: bool, only_cross: bool, macaron: bool,
                         custom_layers: Optional[Sequence[str]], par_ratio: Optional[int],
                         sandwich_coef: Optional[int]) -> Tuple[str, ...]:
    """The layer layout (x_transformer.py:427-457): "a" self-attention, "c"
    cross-attention, "f" feed-forward."""
    if cross_attend and not only_cross:
        default_block: Tuple[str, ...] = ("a", "c", "f")
    elif cross_attend and only_cross:
        default_block = ("c", "f")
    else:
        default_block = ("a", "f")
    if macaron:
        default_block = ("f",) + default_block

    if custom_layers is not None:
        return tuple(custom_layers)
    if par_ratio is not None:
        par_depth = depth * len(default_block)
        if not 1 < par_ratio <= par_depth:
            raise ValueError("par ratio out of range")
        default_block = tuple(t for t in default_block if t != "f")
        par_attn = par_depth // par_ratio
        depth_cut = par_depth * 2 // 3
        par_width = (depth_cut + depth_cut // par_attn) // par_attn
        if len(default_block) > par_width:
            raise ValueError("default block too large for par_ratio")
        par_block = default_block + ("f",) * (par_width - len(default_block))
        par_head = par_block * par_attn
        return par_head + ("f",) * (par_depth - len(par_head))
    if sandwich_coef is not None:
        if not 0 < sandwich_coef <= depth:
            raise ValueError("sandwich coefficient out of range")
        return ("a",) * sandwich_coef + default_block * (depth - sandwich_coef) + ("f",) * sandwich_coef
    return default_block * depth


class AttentionLayers(nn.Module):
    """Configurable pre- / post-norm transformer stack
    (x_transformer.py:369-537). ``attn_kwargs`` are :class:`Attention`'s
    options, ``ff_kwargs`` :class:`FeedForward`'s."""

    def __init__(self, dim: int, depth: int, heads: int = 8, causal: bool = False, cross_attend: bool = False,
                 only_cross: bool = False, use_scalenorm: bool = False, use_rmsnorm: bool = False,
                 use_rezero: bool = False, position_infused_attn: bool = False,
                 custom_layers: Optional[Tuple[str, ...]] = None, sandwich_coef: Optional[int] = None,
                 par_ratio: Optional[int] = None, residual_attn: bool = False, cross_residual_attn: bool = False,
                 macaron: bool = False, pre_norm: bool = True, gate_residual: bool = False,
                 attn_kwargs: Optional[dict] = None, ff_kwargs: Optional[dict] = None,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        attn_kwargs, ff_kwargs = attn_kwargs or {}, ff_kwargs or {}
        self.dim, self.depth = dim, depth
        self.causal, self.pre_norm, self.macaron = causal, pre_norm, macaron
        self.use_rezero, self.gate_residual = use_rezero, gate_residual
        self.residual_attn, self.cross_residual_attn = residual_attn, cross_residual_attn
        self.has_pos_emb = position_infused_attn
        self.layer_types = _resolve_layer_types(depth, cross_attend, only_cross, macaron, custom_layers,
                                                par_ratio, sandwich_coef)
        self.layers = nn.ModuleList()
        for lt in self.layer_types:
            if use_rezero:
                norm = nn.Identity()
            elif use_rmsnorm:
                norm = RMSNorm(dim)
            elif use_scalenorm:
                norm = ScaleNorm(dim)
            else:
                norm = _LayerNorm(dim, eps=1e-5)
            if lt in ("a", "c"):
                block = Attention(dim, heads=heads, causal=causal and lt == "a", **attn_kwargs)
                if use_rezero:  # Rezero wraps attention only (:495-496)
                    block = _Rezero(block)
            else:
                block = FeedForward(dim, **ff_kwargs)
                if macaron:
                    block = _Scale(0.5, block)
            residual = GRUGating(dim) if gate_residual else _Residual()
            self.layers.append(nn.ModuleList([norm, block, residual]))
        place(self, device, dtype)

    def forward(self, x, context=None, mask=None, context_mask=None,
                mems: Optional[Sequence[Optional[torch.Tensor]]] = None, return_hiddens: bool = False):
        num_attn = sum(1 for t in self.layer_types if t == "a")
        mems = list(mems) if mems is not None else [None] * num_attn
        hiddens = []
        prev_attn = prev_cross_attn = None
        last = len(self.layer_types) - 1
        for ind, (lt, (norm, block, residual_fn)) in enumerate(zip(self.layer_types, self.layers)):
            if lt == "a":
                hiddens.append(x)
                layer_mem = mems.pop(0)
            residual = x
            if self.pre_norm:
                x = norm(x)
            if lt == "a":
                out, inter = block(x, mask=mask, pia_offset_emb=self.has_pos_emb, prev_attn=prev_attn,
                                   mem=layer_mem)
            elif lt == "c":
                out, inter = block(x, context=context, mask=mask, context_mask=context_mask,
                                   prev_attn=prev_cross_attn)
            else:
                out = block(x)
            x = residual_fn(out, residual)
            if lt == "a" and self.residual_attn:
                prev_attn = inter
            elif lt == "c" and self.cross_residual_attn:
                prev_cross_attn = inter
            if not self.pre_norm and ind != last:
                x = norm(x)
        return (x, hiddens) if return_hiddens else x


class Encoder(AttentionLayers):
    """Non-causal ``AttentionLayers`` (x_transformer.py:540-543)."""

    def __init__(self, *args, **kwargs):
        if kwargs.get("causal", False):
            raise ValueError("cannot set causality on encoder")
        super().__init__(*args, **kwargs)


class TransformerWrapper(nn.Module):
    """Token embedding, the stack of ``attn_layers_cfg`` (the keyword
    arguments of :class:`AttentionLayers`), a final LayerNorm and the logits
    head (x_transformer.py:547-640). ``return_embeddings`` returns the
    normalised tokens; ``tie_embedding`` takes the logits against
    ``token_emb``."""

    def __init__(self, num_tokens: int, max_seq_len: int, attn_layers_cfg: dict, emb_dim: Optional[int] = None,
                 num_memory_tokens: int = 0, tie_embedding: bool = False, use_pos_emb: bool = True,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.attn_layers = AttentionLayers(**attn_layers_cfg, dtype=dtype, device=None)
        dim = self.attn_layers.dim
        emb_dim = emb_dim if emb_dim is not None else dim
        self.num_memory_tokens, self.tie_embedding = num_memory_tokens, tie_embedding
        self.token_emb = nn.Embedding(num_tokens, emb_dim)
        if use_pos_emb and not self.attn_layers.has_pos_emb:
            self.pos_emb = AbsolutePositionalEmbedding(emb_dim, max_seq_len)
        if emb_dim != dim:
            self.project_emb = nn.Linear(emb_dim, dim)
        if num_memory_tokens > 0:
            self.memory_tokens = nn.Parameter(torch.randn(num_memory_tokens, dim))
        self.norm = _LayerNorm(dim, eps=1e-5)
        if not tie_embedding:
            self.to_logits = nn.Linear(dim, num_tokens)
        place(self, device, dtype)

    def forward(self, tokens, return_embeddings: bool = False, mask=None,
                mems: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        b, n = tokens.shape
        x = self.token_emb(tokens)
        if hasattr(self, "pos_emb"):
            x = x + self.pos_emb(n)
        if hasattr(self, "project_emb"):
            x = self.project_emb(x)
        if self.num_memory_tokens > 0:
            x = torch.cat([self.memory_tokens.expand(b, -1, -1), x], dim=1)
            if mask is not None:
                mask = F.pad(mask, (self.num_memory_tokens, 0), value=True)
        x, _ = self.attn_layers(x, mask=mask, mems=mems, return_hiddens=True)
        x = self.norm(x)[:, self.num_memory_tokens:]
        if return_embeddings:
            return x
        if self.tie_embedding:
            return x @ self.token_emb.weight.t()
        return self.to_logits(x)
