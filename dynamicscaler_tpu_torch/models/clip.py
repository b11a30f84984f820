"""OpenCLIP ViT-H/14 text and vision towers in PyTorch.

Counterparts of ``dynamicscaler_tpu/models/clip.py``:

* ``CLIPTextEncoder`` (lvdm/modules/encoders/condition.py:174-235): token +
  positional embedding, causal pre-LN transformer stopped one block early,
  then ``ln_final``; the full 77-token sequence is returned. With
  ``penultimate`` only the blocks that run are built: drop the unused last
  block's keys (and ``text_projection``/``logit_scale``) of an OpenCLIP
  checkpoint before loading it.
* ``CLIPVisionEncoder`` (condition.py:298-374, ``FrozenOpenCLIPImageEmbedderV2``):
  bias-free patch conv + class token + positional embedding, ``ln_pre``, the
  full transformer; all 257 tokens are returned, without ``ln_post`` or the
  projection (drop those two keys of an OpenCLIP ``visual.*`` checkpoint).
  Input is :func:`clip_preprocess`'s output.
* ``CLIPVisionPooled``: the same tower, then the class token through
  ``ln_post`` and ``@ proj`` (open_clip ``model.visual``, OpenAI clip
  ``encode_image``); ``OpenCLIPImageEmbedderPooled`` (condition.py:238-295)
  and ``ClipImageEmbedder`` (condition.py:136-171, the QuickGELU tower)
  preprocess, pool and apply :func:`ucg_dropout`.

OpenCLIP state_dict names (``transformer.resblocks.{i}.attn.in_proj_weight``
...). LayerNorm eps 1e-5, exact (erf) GELU (LAION ViT-H). Attention is
PyTorch's SDPA (the JAX package's is stock JAX here too: no repository kernel
at these sites). ``quick_gelu`` swaps the MLPs' GELU for OpenAI CLIP's
``x * sigmoid(1.702 x)``; the state_dict is the same either way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dynamicscaler_tpu_torch.config import CLIPTextConfig, CLIPVisionConfig
from dynamicscaler_tpu_torch.ops.attention import attention

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[-1, 1] NHWC images -> CLIP-normalised ``image_size``^2 NHWC, fp32.

    Antialiased bicubic resize with half-pixel centres and a = -0.5, which
    is what ``jax.image.resize(..., "bicubic")`` computes (the reference's
    kornia resize is the same up to align_corners)."""
    x = F.interpolate(images.float().permute(0, 3, 1, 2), size=(image_size, image_size),
                      mode="bicubic", antialias=True, align_corners=False).permute(0, 2, 3, 1)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation, ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    """:func:`quick_gelu` as a module."""

    def forward(self, x):
        return quick_gelu(x)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = True, quick_gelu: bool = False):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.ln_1 = nn.LayerNorm(width)
        self.attn = nn.MultiheadAttention(width, heads, batch_first=True)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, 4 * width))
        self.mlp.add_module("gelu", QuickGELU() if quick_gelu else nn.GELU())
        self.mlp.add_module("c_proj", nn.Linear(4 * width, width))

    def _attn(self, x):
        B, N, W = x.shape
        d = W // self.heads
        qkv = F.linear(x, self.attn.in_proj_weight, self.attn.in_proj_bias)
        q, k, v = (t.reshape(B, N, self.heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        o = attention(q, k, v, d ** -0.5, causal=self.causal).transpose(1, 2).reshape(B, N, W)
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


class CLIPVisionEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, quick_gelu: bool = False):
        super().__init__()
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, cfg.width))
        self.ln_pre = nn.LayerNorm(cfg.width)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(cfg.width, cfg.heads, causal=False, quick_gelu=quick_gelu)
             for _ in range(cfg.layers)]
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """CLIP-normalised [B, S, S, 3] -> [B, grid^2 + 1, width]."""
        dt = self.conv1.weight.dtype
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), self.conv1.weight, stride=self.cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, grid^2, width], row-major patches
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        for blk in self.transformer.resblocks:
            x = blk(x)
        return x


class CLIPVisionPooled(CLIPVisionEncoder):
    """Pooled, projected CLIP image embedding: the tower's class token ->
    ``ln_post`` -> ``@ proj`` -> [B, output_dim]. The ``visual.*`` names of
    both pooled embedders (conv1 ... ln_post, proj)."""

    def __init__(self, cfg: CLIPVisionConfig, quick_gelu: bool = False):
        super().__init__(cfg, quick_gelu)
        self.ln_post = nn.LayerNorm(cfg.width)
        self.proj = nn.Parameter(torch.empty(cfg.width, cfg.output_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """CLIP-normalised [B, S, S, 3] -> [B, output_dim]."""
        return self.ln_post(super().forward(images)[:, 0]) @ self.proj


def ucg_dropout(z: torch.Tensor, ucg_rate: float, generator: torch.Generator = None, keep: torch.Tensor = None,
                no_dropout: bool = False) -> torch.Tensor:
    """Unconditional-guidance dropout (condition.py:169-170, :284-285): a
    batch row of ``z`` is zeroed with probability ``ucg_rate``. The rows
    kept are ``keep`` [B] when given (a test hands in the JAX draw), else a
    Bernoulli draw from ``generator``; with neither, or ``no_dropout``, or
    a rate <= 0, ``z`` is returned as it is (the reference's
    ``no_dropout=True``)."""
    if ucg_rate <= 0.0 or no_dropout or (generator is None and keep is None):
        return z
    if keep is None:
        keep = torch.bernoulli(torch.full((z.shape[0],), 1.0 - ucg_rate, device=generator.device),
                               generator=generator)
    keep = torch.as_tensor(keep, device=z.device)
    return z * keep.reshape(-1, *([1] * (z.ndim - 1))).to(z.dtype)


class OpenCLIPImageEmbedderPooled(nn.Module):
    """``FrozenOpenCLIPImageEmbedder`` (condition.py:238-295): [-1, 1] NHWC
    images -> :func:`clip_preprocess` -> :class:`CLIPVisionPooled`
    (``model``) -> :func:`ucg_dropout`."""

    def __init__(self, cfg: CLIPVisionConfig, ucg_rate: float = 0.0, quick_gelu: bool = False):
        super().__init__()
        self.cfg = cfg
        self.ucg_rate = ucg_rate
        self.model = CLIPVisionPooled(cfg, quick_gelu)

    def forward(self, images: torch.Tensor, generator: torch.Generator = None, keep: torch.Tensor = None,
                no_dropout: bool = False) -> torch.Tensor:
        z = self.model(clip_preprocess(images, self.cfg.image_size))
        return ucg_dropout(z, self.ucg_rate, generator, keep, no_dropout)


class ClipImageEmbedder(OpenCLIPImageEmbedderPooled):
    """``ClipImageEmbedder`` (condition.py:136-171): OpenAI CLIP's
    ``encode_image`` (the QuickGELU tower) with the same preprocess and
    dropout."""

    def __init__(self, cfg: CLIPVisionConfig, ucg_rate: float = 0.0):
        super().__init__(cfg, ucg_rate, quick_gelu=True)
