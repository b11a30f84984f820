"""Image-token projectors for i2v conditioning: ``ImageProjModel`` and the
perceiver ``Resampler`` (CLIP ViT-H image tokens -> i2v context tokens).

Counterpart of ``dynamicscaler_tpu/models/resampler.py``.
``ImageProjModel`` (ip_resampler.py:7-21) is a linear map of a pooled image
embedding to ``num_tokens`` context tokens, then LayerNorm (names ``proj``,
``norm``). ``Resampler`` (ip_resampler.py:45-135): ``proj_in`` to ``dim``, then
``depth`` x (perceiver attention of the learned queries over [x ; queries],
+ residual; LayerNorm -> GELU MLP, + residual), ``proj_out`` and
``norm_out``. VideoCrafter ``image_proj_model.*`` state_dict names
(``layers.{d}.0`` the attention, ``layers.{d}.1`` the MLP). LayerNorm eps
1e-5, exact (erf) GELU; attention is PyTorch's SDPA (stock JAX in the JAX
package too).
"""

from __future__ import annotations

import torch
from torch import nn

from dynamicscaler_tpu_torch.config import ResamplerConfig
from dynamicscaler_tpu_torch.ops.attention import attention


class ImageProjModel(nn.Module):
    """[B, clip_embeddings_dim] -> [B, num_tokens, cross_attention_dim]."""

    def __init__(self, cross_attention_dim: int = 1024, clip_embeddings_dim: int = 1024, num_tokens: int = 4):
        super().__init__()
        self.cross_attention_dim = cross_attention_dim
        self.num_tokens = num_tokens
        self.proj = nn.Linear(clip_embeddings_dim, num_tokens * cross_attention_dim)
        self.norm = nn.LayerNorm(cross_attention_dim)

    def forward(self, image_embeds):
        return self.norm(self.proj(image_embeds).reshape(-1, self.num_tokens, self.cross_attention_dim))


class PerceiverAttention(nn.Module):
    """ip_resampler.py:45-91: the latents attend over [x ; latents]; q and k
    are each scaled by dim_head^-1/4, i.e. the logits by dim_head^-1/2."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        x = self.norm1(x)
        latents = self.norm2(latents)
        B, L, _ = latents.shape

        def split(t):
            return t.reshape(B, t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        q = split(self.to_q(latents))
        k, v = (split(t) for t in self.to_kv(torch.cat([x, latents], dim=1)).chunk(2, dim=-1))
        out = attention(q, k, v, self.dim_head ** -0.5).transpose(1, 2).reshape(B, L, -1)
        return self.to_out(out)


def _perceiver_ff(dim: int, mult: int) -> nn.Sequential:
    """ip_resampler.py:24-31 FeedForward (names ``0`` norm, ``1`` fc1, ``3`` fc2)."""
    return nn.Sequential(nn.LayerNorm(dim), nn.Linear(dim, dim * mult, bias=False), nn.GELU(),
                         nn.Linear(dim * mult, dim, bias=False))


class Resampler(nn.Module):
    def __init__(self, cfg: ResamplerConfig):
        super().__init__()
        self.cfg = cfg
        # DynamiCrafter's video_length multiplies the queries (ip_resampler.py:
        # num_queries * video_length): the same [1, tokens, dim] parameter
        self.latents = nn.Parameter(torch.empty(1, cfg.tokens, cfg.dim))
        self.proj_in = nn.Linear(cfg.embedding_dim, cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.output_dim)
        self.norm_out = nn.LayerNorm(cfg.output_dim)
        self.layers = nn.ModuleList([
            nn.ModuleList([PerceiverAttention(cfg.dim, cfg.dim_head, cfg.heads),
                           _perceiver_ff(cfg.dim, cfg.ff_mult)])
            for _ in range(cfg.depth)
        ])

    def forward(self, x):
        """x [B, T, embedding_dim] -> [B, num_queries x video_length, output_dim]."""
        latents = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return self.norm_out(self.proj_out(latents))
