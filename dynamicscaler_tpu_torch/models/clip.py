"""OpenCLIP ViT-H/14 text tower in PyTorch (penultimate layer).

Counterpart of ``dynamicscaler_tpu/models/clip.py::CLIPTextEncoder``
(lvdm/modules/encoders/condition.py:174-235): token + positional embedding,
causal pre-LN transformer stopped one block early, then ``ln_final``; the
full 77-token sequence is returned. OpenCLIP state_dict names
(``transformer.resblocks.{i}.attn.in_proj_weight`` ...). With
``penultimate`` only the blocks that run are built: drop the unused last
block's keys (and ``text_projection``/``logit_scale``) of an OpenCLIP
checkpoint before loading it.
Attention is PyTorch's SDPA (no repository kernel at this site).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dynamicscaler_tpu_torch.config import CLIPTextConfig
from dynamicscaler_tpu_torch.ops.attention import attention


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(width)
        self.attn = nn.MultiheadAttention(width, heads, batch_first=True)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, 4 * width))
        self.mlp.add_module("gelu", nn.GELU())
        self.mlp.add_module("c_proj", nn.Linear(4 * width, width))

    def _attn(self, x):
        B, N, W = x.shape
        d = W // self.heads
        qkv = F.linear(x, self.attn.in_proj_weight, self.attn.in_proj_bias)
        q, k, v = (t.reshape(B, N, self.heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        o = attention(q, k, v, d ** -0.5, causal=True).transpose(1, 2).reshape(B, N, W)
        return self.attn.out_proj(o)

    def forward(self, x):
        x = x + self._attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        n_blocks = cfg.layers - (1 if cfg.penultimate else 0)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(cfg.width, cfg.heads) for _ in range(n_blocks)]
        )
        self.ln_final = nn.LayerNorm(cfg.width)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, 77] int -> [B, 77, width]."""
        x = self.token_embedding(tokens) + self.positional_embedding
        for blk in self.transformer.resblocks:
            x = blk(x)
        return self.ln_final(x)
