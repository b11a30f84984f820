"""SD KL-VAE (2D autoencoder) in PyTorch, NHWC at its public functions.

Counterpart of ``dynamicscaler_tpu/models/vae.py`` with the reference's
state_dict names (lvdm/modules/networks/ae_modules.py:26-563,
lvdm/models/autoencoder.py:13-127): encoder with right/bottom-padded
stride-2 downsampling, mid res-attn-res, double-z Gaussian moments;
decoder with nearest x2 upsampling. GroupNorm(32) eps 1e-6 throughout,
swish. Video frames ride the batch axis.
"""

from __future__ import annotations

from typing import Optional

import math

import torch
import torch.nn.functional as F
from torch import nn

from dynamicscaler_tpu_torch.config import VAEConfig
from dynamicscaler_tpu_torch.models.unet3d import conv2d_nhwc
from dynamicscaler_tpu_torch.ops import fused_twrap
from dynamicscaler_tpu_torch.ops.attention import attention


def _gn(x, norm: nn.GroupNorm, act: bool = True):
    # VAE GroupNorm eps 1e-6 (ae_modules.py:19-23)
    return fused_twrap.gn_silu(x, norm.weight, norm.bias, eps=1e-6, act=act)


def _norm(c):
    return nn.GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = _norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _norm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = conv2d_nhwc(_gn(x, self.norm1), self.conv1)
        h = conv2d_nhwc(_gn(h, self.norm2), self.conv2)
        if hasattr(self, "nin_shortcut"):
            x = conv2d_nhwc(x, self.nin_shortcut)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full self-attention over H*W (ae_modules.py:26-87)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _norm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        B, H, W, C = x.shape
        h = _gn(x, self.norm, act=False)
        q, k, v = (conv2d_nhwc(h, m).reshape(B, 1, H * W, C) for m in (self.q, self.k, self.v))
        out = attention(q, k, v, C ** -0.5)[:, 0].reshape(B, H, W, C)
        return x + conv2d_nhwc(out, self.proj_out)


class Downsample2D(nn.Module):
    """Stride-2 conv after a (0, 1, 0, 1) pad (ae_modules.py:102-107)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return conv2d_nhwc(F.pad(x, (0, 0, 0, 1, 0, 1)), self.conv)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return conv2d_nhwc(x, self.conv)


def _level():
    m = nn.Module()
    m.block = nn.ModuleList()
    m.attn = nn.ModuleList()
    return m


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    """ae_modules.py:364-463. [B, H, W, 3] in [-1, 1] -> [B, H/8, W/8, 2z]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        self.down = nn.ModuleList()
        block_in = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            lvl = _level()
            for _ in range(cfg.num_res_blocks):
                lvl.block.append(ResnetBlock(block_in, cfg.ch * mult))
                block_in = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                lvl.downsample = Downsample2D(block_in)
            self.down.append(lvl)
        self.mid = _Mid(block_in)
        self.norm_out = _norm(block_in)
        zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(block_in, zc, 3, padding=1)

    def forward(self, x):
        h = conv2d_nhwc(x, self.conv_in)
        for i, lvl in enumerate(self.down):
            for blk in lvl.block:
                h = blk(h)
            if i != len(self.down) - 1:
                h = lvl.downsample(h)
        h = self.mid(h)
        return conv2d_nhwc(_gn(h, self.norm_out), self.conv_out)


class Decoder(nn.Module):
    """ae_modules.py:466-563. [B, h, w, z] -> [B, 8h, 8w, 3]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        up = []
        for i in reversed(range(len(cfg.ch_mult))):
            lvl = _level()
            block_out = cfg.ch * cfg.ch_mult[i]
            for _ in range(cfg.num_res_blocks + 1):
                lvl.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
            if i != 0:
                lvl.upsample = Upsample2D(block_in)
            up.insert(0, lvl)  # up[i] is level i, as in the reference
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(conv2d_nhwc(z, self.conv_in))
        for i in reversed(range(len(self.up))):
            for blk in self.up[i].block:
                h = blk(h)
            if i != 0:
                h = self.up[i].upsample(h)
        return conv2d_nhwc(_gn(h, self.norm_out), self.conv_out)


class DiagonalGaussianDistribution:
    """Diagonal Gaussian over NHWC moments (lvdm/distributions.py:24-65);
    the channel split is on the last axis."""

    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        self.parameters = parameters
        self.mean, logvar = parameters.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.deterministic = deterministic
        if deterministic:
            self.std = self.var = torch.zeros_like(self.mean)
        else:
            self.std = torch.exp(0.5 * self.logvar)
            self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None, noise=None) -> torch.Tensor:
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def _dims(self):
        return tuple(range(1, self.mean.ndim))

    def kl(self, other: "DiagonalGaussianDistribution" = None) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], dtype=self.mean.dtype, device=self.mean.device)
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=self._dims())
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var + self.var / other.var - 1.0
            - self.logvar + other.logvar,
            dim=self._dims(),
        )

    def nll(self, sample: torch.Tensor, dims=None) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], dtype=self.mean.dtype, device=self.mean.device)
        d = tuple(dims) if dims is not None else self._dims()
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar + (sample - self.mean) ** 2 / self.var, dim=d
        )


class IdentityFirstStage:
    """Pass-through first stage (lvdm/models/autoencoder.py:202-219), for
    configs that diffuse in pixel space: encode and decode return their
    input."""

    def encode(self, x, *args, **kwargs):
        return x

    def decode(self, x, *args, **kwargs):
        return x


class AutoencoderKL(nn.Module):
    """Encoder + Decoder + quant convs. ``encode`` returns the scaled latent
    (mode, or a sample when a generator or noise is given); ``decode``
    divides the scale back out."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        dz = 2 if cfg.double_z else 1
        self.quant_conv = nn.Conv2d(dz * cfg.z_channels, dz * cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def encode_moments(self, x):
        return conv2d_nhwc(self.encoder(x), self.quant_conv)

    def encode(self, x, generator: Optional[torch.Generator] = None, noise=None):
        post = DiagonalGaussianDistribution(self.encode_moments(x))
        z = post.sample(generator, noise) if (generator is not None or noise is not None) else post.mode()
        return z * self.cfg.scale_factor

    def decode(self, z):
        return self.decoder(conv2d_nhwc(z / self.cfg.scale_factor, self.post_quant_conv))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.decode(self.encode(x, generator))
