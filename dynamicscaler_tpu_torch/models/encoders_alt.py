"""Alternate text encoders: HF CLIP, T5 v1.1, the pair, and the small
conditioning modules, in PyTorch.

Counterpart of ``dynamicscaler_tpu/models/encoders_alt.py``: the reference's
unused-but-present encoders (lvdm/modules/encoders/condition.py)
``FrozenCLIPEmbedder`` (:89-135), ``FrozenT5Embedder`` (:57-86),
``FrozenCLIPT5Encoder`` (:377-392), ``IdentityEncoder`` (:18-21) and
``ClassEmbedder`` (:23-47). No shipped config builds them. The towers take
token ids [B, L]: tokenising is a host step with the user's own vocabulary.

The modules carry ``transformers``' own state_dict names, so the state dict
of a ``CLIPTextModel`` (``text_model.*``) or a ``T5EncoderModel``
(``shared.weight`` and ``encoder.embed_tokens.weight``, the same tied
table; ``encoder.block.{i}.layer.*``) loads with ``load_state_dict``. The
port does not import ``transformers``. Numerics as the JAX twin's:

* HF CLIP text: pre-LN causal transformer, QuickGELU ``x * sigmoid(1.702
  x)``, final LayerNorm; ``pooled`` takes the token at ``argmax(tokens)``
  (the EOT id is the largest of the vocabulary); ``hidden`` with
  ``layer_idx`` returns the hidden state before the final LayerNorm: the
  input of block ``layer_idx`` (index ``layers``: the last block's output).
* T5 v1.1: RMSNorm with fp32 statistics and no mean subtracted, the
  relative-position bucket bias from block 0's table shared by every
  block, UNSCALED logits (T5 folds 1/sqrt(d) into its initialisation),
  gated tanh-GELU feed-forward (``wi_0`` gate, ``wi_1`` value), no bias
  anywhere, a final RMSNorm.

Softmax in fp32 everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynamicscaler_tpu_torch.models.clip import quick_gelu


@dataclasses.dataclass(frozen=True)
class HFCLIPTextConfig:
    """transformers CLIPTextConfig subset (openai/clip-vit-large-patch14,
    condition.py:98)."""

    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_width: int = 3072
    context_length: int = 77
    layer: str = "last"  # last | pooled | hidden (condition.py:91-95)
    layer_idx: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class T5Config:
    """transformers T5Config subset (google/t5-v1_1-large, condition.py:60)."""

    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


@dataclasses.dataclass(frozen=True)
class ClassEmbedderConfig:
    embed_dim: int = 512
    n_classes: int = 1000  # the last class is the unconditional one


def _softmax_attend(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 softmax of [B, H, N, M] logits, rounded to v's type, @ v."""
    return torch.matmul(torch.softmax(logits.float(), dim=-1).to(v.dtype), v)


# ---------------------------------------------------------------------------
# HF CLIP text (FrozenCLIPEmbedder)
# ---------------------------------------------------------------------------


class _CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, h, mask):
        B, N, W = h.shape
        d = W // self.heads

        def split(t):
            return t.reshape(B, N, self.heads, d).transpose(1, 2)

        q = split(self.q_proj(h)) * d ** -0.5
        logits = torch.matmul(q, split(self.k_proj(h)).transpose(-1, -2)) + mask
        o = _softmax_attend(logits, split(self.v_proj(h)))
        return self.out_proj(o.transpose(1, 2).reshape(B, N, W))


class _CLIPMLP(nn.Module):
    def __init__(self, width: int, mlp_width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, mlp_width)
        self.fc2 = nn.Linear(mlp_width, width)

    def forward(self, h):
        return self.fc2(quick_gelu(self.fc1(h)))


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: HFCLIPTextConfig):
        super().__init__()
        self.self_attn = _CLIPAttention(cfg.width, cfg.heads)
        self.layer_norm1 = nn.LayerNorm(cfg.width)
        self.mlp = _CLIPMLP(cfg.width, cfg.mlp_width)
        self.layer_norm2 = nn.LayerNorm(cfg.width)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class HFCLIPTextEncoder(nn.Module):
    """FrozenCLIPEmbedder (condition.py:89-135): tokens [B, L] -> [B, L,
    width] (``last``), [B, 1, width] (``pooled``) or the hidden state of
    ``layer_idx`` (``hidden``)."""

    def __init__(self, cfg: HFCLIPTextConfig):
        super().__init__()
        if cfg.layer not in ("last", "pooled", "hidden"):
            raise ValueError(f"layer {cfg.layer!r}: last, pooled or hidden")
        if cfg.layer == "hidden" and (cfg.layer_idx is None or abs(cfg.layer_idx) > cfg.layers):
            raise ValueError(f"hidden needs a layer_idx within +-{cfg.layers}, got {cfg.layer_idx}")
        self.cfg = cfg
        self.text_model = nn.Module()
        self.text_model.embeddings = nn.Module()
        self.text_model.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.text_model.embeddings.position_embedding = nn.Embedding(cfg.context_length, cfg.width)
        self.text_model.encoder = nn.Module()
        self.text_model.encoder.layers = nn.ModuleList([_CLIPLayer(cfg) for _ in range(cfg.layers)])
        self.text_model.final_layer_norm = nn.LayerNorm(cfg.width)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg, tm = self.cfg, self.text_model
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=tm.final_layer_norm.weight.device)
        L = tokens.shape[1]
        emb = tm.embeddings
        x = emb.token_embedding(tokens) + emb.position_embedding.weight[:L]
        mask = torch.full((L, L), torch.finfo(torch.float32).min, device=x.device).triu(1).to(x.dtype)
        # transformers' hidden_states[i] is the input of block i; index
        # ``layers`` is the last block's output, before the final LayerNorm
        want = cfg.layer_idx % (cfg.layers + 1) if cfg.layer == "hidden" else None
        hidden = x
        for i, layer in enumerate(tm.encoder.layers):
            if want == i:
                hidden = x
            x = layer(x, mask)
        if want == cfg.layers:
            hidden = x
        if cfg.layer == "hidden":
            return hidden
        x = tm.final_layer_norm(x)
        if cfg.layer == "last":
            return x
        eot = tokens.argmax(dim=-1)  # the EOT id is the largest of the vocabulary
        return x[torch.arange(x.shape[0], device=x.device), eot][:, None]


# ---------------------------------------------------------------------------
# T5 v1.1 encoder (FrozenT5Embedder)
# ---------------------------------------------------------------------------


def _t5_relative_position_bucket(relative_position: np.ndarray, num_buckets: int,
                                 max_distance: int) -> np.ndarray:
    """Bidirectional bucketing (transformers ``T5Attention._relative_position_bucket``):
    half the buckets by sign, half of each linear for small distances,
    log-spaced beyond."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return ret + np.where(is_small, n, large)


def t5_position_bucket_table(L: int, cfg: T5Config) -> np.ndarray:
    """[L, L] bucket ids of key j - query i, on the host."""
    ctx = np.arange(L)[:, None]
    mem = np.arange(L)[None, :]
    return _t5_relative_position_bucket(mem - ctx, cfg.relative_attention_num_buckets,
                                        cfg.relative_attention_max_distance)


class T5RMSNorm(nn.Module):
    """``weight * x / sqrt(mean(x^2) + eps)`` with fp32 statistics, no mean
    subtracted."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return y.to(x.dtype) * self.weight.to(x.dtype)


class _T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias_table:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)

    def forward(self, h, position_bias):
        B, L, _ = h.shape

        def split(t):
            return t.reshape(B, L, self.heads, self.d_kv).transpose(1, 2)

        # no 1 / sqrt(d_kv): T5 folds the scale into its initialisation
        logits = torch.matmul(split(self.q(h)), split(self.k(h)).transpose(-1, -2)) + position_bias
        o = _softmax_attend(logits, split(self.v(h)))
        return self.o(o.transpose(1, 2).reshape(B, L, -1))


class _T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        self.SelfAttention = _T5Attention(cfg, has_bias_table)
        self.layer_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, position_bias):
        return x + self.SelfAttention(self.layer_norm(x), position_bias)


class _T5DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class _T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _T5DenseGatedGelu(cfg)
        self.layer_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class _T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        self.layer = nn.ModuleList([_T5LayerSelfAttention(cfg, has_bias_table), _T5LayerFF(cfg)])

    def forward(self, x, position_bias):
        return self.layer[1](self.layer[0](x, position_bias))


class T5TextEncoder(nn.Module):
    """FrozenT5Embedder (condition.py:57-86): the encoder stack of
    ``T5EncoderModel``, tokens [B, L] -> ``last_hidden_state`` [B, L,
    d_model]. ``shared`` and ``encoder.embed_tokens`` are one table, as in
    transformers."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = nn.Module()
        self.encoder.embed_tokens = self.shared
        self.encoder.block = nn.ModuleList([_T5Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.encoder.final_layer_norm = T5RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        enc = self.encoder
        table = enc.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=table.device)
        x = enc.embed_tokens(tokens)
        buckets = torch.as_tensor(t5_position_bucket_table(tokens.shape[1], self.cfg), device=table.device)
        # [1, heads, L, L] from block 0's table, shared by every block
        position_bias = table[buckets].permute(2, 0, 1)[None].to(x.dtype)
        for blk in enc.block:
            x = blk(x, position_bias)
        return enc.final_layer_norm(x)


class CLIPT5TextEncoder(nn.Module):
    """FrozenCLIPT5Encoder (condition.py:377-392): both towers on their own
    tokens of one prompt, returning ``(clip_tokens_z, t5_tokens_z)``
    (state_dict ``clip.*`` and ``t5.*``)."""

    def __init__(self, clip_cfg: HFCLIPTextConfig = HFCLIPTextConfig(), t5_cfg: T5Config = T5Config()):
        super().__init__()
        self.clip = HFCLIPTextEncoder(clip_cfg)
        self.t5 = T5TextEncoder(t5_cfg)

    def forward(self, clip_tokens, t5_tokens):
        return self.clip(clip_tokens), self.t5(t5_tokens)


class IdentityEncoder:
    """condition.py:18-21: pass-through conditioning."""

    def encode(self, x):
        return x


class ClassEmbedder(nn.Module):
    """condition.py:23-47: class-label conditioning with unconditional-
    guidance dropout: with probability ``ucg_rate`` a label becomes the
    reserved last class. The labels dropped are ``drop`` [B] bool when given
    (a test hands in the JAX draw), else a Bernoulli draw from
    ``generator``; with neither, or ``disable_dropout``, none is."""

    def __init__(self, cfg: ClassEmbedderConfig, ucg_rate: float = 0.1):
        super().__init__()
        self.cfg = cfg
        self.ucg_rate = ucg_rate
        self.embedding = nn.Embedding(cfg.n_classes, cfg.embed_dim)

    def forward(self, labels, generator: torch.Generator = None, drop: torch.Tensor = None,
                disable_dropout: bool = False) -> torch.Tensor:
        c = torch.as_tensor(labels, dtype=torch.long, device=self.embedding.weight.device)
        if self.ucg_rate > 0.0 and not disable_dropout and (generator is not None or drop is not None):
            if drop is None:
                drop = torch.bernoulli(torch.full(c.shape, self.ucg_rate, device=generator.device),
                                       generator=generator) > 0
            c = torch.where(torch.as_tensor(drop, device=c.device), self.cfg.n_classes - 1, c)
        return self.embedding(c)[:, None, :]  # [B, 1, D], a cross-attention token

    @staticmethod
    def unconditional_labels(cfg: ClassEmbedderConfig, batch: int, device="cpu") -> torch.Tensor:
        """condition.py:44-47 ``get_unconditional_conditioning``."""
        return torch.full((batch,), cfg.n_classes - 1, dtype=torch.long, device=device)

