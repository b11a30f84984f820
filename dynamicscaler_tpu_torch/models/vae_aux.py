"""The auxiliary ae_modules classes in PyTorch, NHWC at their public functions.

Counterpart of ``dynamicscaler_tpu/models/vae_aux.py``: every class of
``lvdm/modules/networks/ae_modules.py`` that no shipped config builds (the
live encoder and decoder are ``models/vae.py``):

* ``Model`` (ae_modules.py:212-361): the DDPM 2D UNet with timestep MLP,
  skip connections and attention at the resolutions named;
* ``SimpleDecoder`` (:581-614), ``UpsampleDecoder`` (:617-662);
* ``LatentRescaler`` (:665-699): res / attn / res around a nearest rescale
  (``F.interpolate``'s floor index, :func:`torch_nearest_resize`);
* ``MergedRescaleEncoder`` (:702-718), ``MergedRescaleDecoder`` (:721-735),
  ``Upsampler`` (:738-754): the live ``Encoder`` / ``Decoder`` with a
  ``LatentRescaler``;
* :func:`resize_2d`, the fixed-mode ``Resize`` (:757-777; the learned branch
  raises, as upstream);
* ``LinAttnBlock`` (:20-23): ``LinearAttention`` at one head of C;
* ``FirstStagePostProcessor`` (:780-845) without its frozen first-stage
  encode: the caller passes ``z_fs``.

The modules carry the reference's state_dict names, so a reference state
dict loads with ``load_state_dict``, except the ``temb_proj`` weights of
``FirstStagePostProcessor``'s blocks, which the reference builds and its
forward never reads: they are dropped there, as the JAX converter drops
them (``convert_first_stage_post``). Inference only (dropout elided).

Every GroupNorm of 32 groups goes through the VAE's own norm,
``models/vae.py::_gn``: kernel 9 (``fused_twrap.gn_silu``) on the card, its
plain version on the CPU; ``FirstStagePostProcessor.proj_norm`` has C // 2
groups, which kernel 9 does not take, and runs the plain fold. The rest is
plain PyTorch, as the JAX twin is plain XLA. Each public class takes its
``dtype`` (bf16 or fp32) and its ``device``: the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynamicscaler_tpu_torch.config import VAEConfig
from dynamicscaler_tpu_torch.models.layers import place
from dynamicscaler_tpu_torch.models.unet3d import conv2d_nhwc
from dynamicscaler_tpu_torch.models.vae import (AttnBlock, Decoder, Downsample2D, Encoder, ResnetBlock,
                                                Upsample2D, _gn, _norm)
from dynamicscaler_tpu_torch.ops.fused_twrap import gn_silu_plain, group_norm_fold_plain
from dynamicscaler_tpu_torch.ops.resize import resize_video_latent


def ddpm_timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """ae_modules.py:129-150: sin first, then cos, a ``half - 1`` divisor,
    a zero column for odd ``dim``; fp32 [B, dim]. Not the UNet's embedding
    (``models/layers.timestep_embedding``: cos first, ``half`` divisor)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device) * -emb)
    args = timesteps.float()[:, None] * freqs[None]
    out = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(out, (0, 1)) if dim % 2 else out


def torch_nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``F.interpolate(mode='nearest', size=...)`` on NHWC: source index
    ``floor(dst * in / out)`` on each axis, in integers."""
    H, W = x.shape[1], x.shape[2]
    hi = torch.arange(out_h, device=x.device) * H // out_h
    wi = torch.arange(out_w, device=x.device) * W // out_w
    return x[:, hi[:, None], wi[None, :]]


class ResnetBlockT(ResnetBlock):
    """ae_modules.py:151-209: the VAE's ResnetBlock with the timestep
    projection ``temb_proj`` (``temb_channels`` > 0), added after
    ``conv1`` as ``temb_proj(silu(temb))``. Without ``temb`` it is the VAE
    block."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int = 0):
        super().__init__(in_channels, out_channels)
        if temb_channels:
            self.temb_proj = nn.Linear(temb_channels, out_channels)

    def forward(self, x, temb: Optional[torch.Tensor] = None):
        if temb is None:
            return super().forward(x)
        h = conv2d_nhwc(_gn(x, self.norm1), self.conv1)
        h = h + self.temb_proj(F.silu(temb))[:, None, None, :]
        h = conv2d_nhwc(_gn(h, self.norm2), self.conv2)
        if hasattr(self, "nin_shortcut"):
            x = conv2d_nhwc(x, self.nin_shortcut)
        return x + h


class LinAttnBlock(nn.Module):
    """attention.py:406-422 ``LinearAttention`` at heads 1, dim_head C
    (ae_modules.py:20-23): ``to_qkv`` without bias; a softmax over the
    token axis of k in fp32; ``context = kᵀ v``, ``out = context · q``,
    unscaled; ``to_out``. No norm and no residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.to_qkv = nn.Conv2d(channels, 3 * channels, 1, bias=False)
        self.to_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        B, H, W, C = x.shape
        q, k, v = conv2d_nhwc(x, self.to_qkv).reshape(B, H * W, 3 * C).chunk(3, dim=-1)
        k = torch.softmax(k.float(), dim=1).to(q.dtype)
        context = torch.einsum("bnd,bne->bde", k, v)
        out = torch.einsum("bde,bnd->bne", context, q).reshape(B, H, W, C)
        return conv2d_nhwc(out, self.to_out)


@dataclasses.dataclass(frozen=True)
class AuxModelConfig:
    """ae_modules.py:212-234 constructor surface (dropout elided;
    ``use_linear_attn`` folds into ``attn_type``)."""

    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 8)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    in_channels: int = 3
    resolution: int = 256
    use_timestep: bool = True
    attn_type: str = "vanilla"  # vanilla | linear | none


def _make_attn(attn_type: str, channels: int) -> nn.Module:
    """ae_modules.py:80-87 make_attn."""
    if attn_type == "vanilla":
        return AttnBlock(channels)
    if attn_type == "linear":
        return LinAttnBlock(channels)
    if attn_type == "none":
        return nn.Identity()
    raise ValueError(f"attn_type {attn_type!r}: one of vanilla, linear, none")


def _level() -> nn.Module:
    m = nn.Module()
    m.block = nn.ModuleList()
    m.attn = nn.ModuleList()
    return m


class Model(nn.Module):
    """The DDPM 2D UNet (ae_modules.py:212-361): ``x`` [B, H, W, C] (with
    ``context`` concatenated on the channel axis first), timesteps ``t``
    [B] when ``cfg.use_timestep`` -> [B, H, W, out_ch]. ``up.{i}`` is level
    i, though the up path runs the levels in reverse."""

    def __init__(self, cfg: AuxModelConfig, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.cfg = cfg
        temb_ch = 4 * cfg.ch if cfg.use_timestep else 0
        if cfg.use_timestep:
            self.temb = nn.Module()
            self.temb.dense = nn.ModuleList([nn.Linear(cfg.ch, temb_ch), nn.Linear(temb_ch, temb_ch)])
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        n = len(cfg.ch_mult)
        res = cfg.resolution
        skips = [cfg.ch]  # the channels of each entry of the forward's skip stack
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            lvl = _level()
            for _ in range(cfg.num_res_blocks):
                lvl.block.append(ResnetBlockT(skips[-1], cfg.ch * mult, temb_ch))
                if res in cfg.attn_resolutions:
                    lvl.attn.append(_make_attn(cfg.attn_type, cfg.ch * mult))
                skips.append(cfg.ch * mult)
            if i != n - 1:
                lvl.downsample = Downsample2D(skips[-1])
                skips.append(skips[-1])
                res //= 2
            self.down.append(lvl)
        block_in = skips[-1]
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlockT(block_in, block_in, temb_ch)
        self.mid.attn_1 = _make_attn(cfg.attn_type, block_in)
        self.mid.block_2 = ResnetBlockT(block_in, block_in, temb_ch)
        up = []
        for i in reversed(range(n)):
            lvl = _level()
            block_out = cfg.ch * cfg.ch_mult[i]
            for _ in range(cfg.num_res_blocks + 1):
                lvl.block.append(ResnetBlockT(block_in + skips.pop(), block_out, temb_ch))
                block_in = block_out
                if res in cfg.attn_resolutions:
                    lvl.attn.append(_make_attn(cfg.attn_type, block_in))
            if i != 0:
                lvl.upsample = Upsample2D(block_in)
                res *= 2
            up.insert(0, lvl)
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)
        place(self, device, dtype)

    def forward(self, x, t: Optional[torch.Tensor] = None, context: Optional[torch.Tensor] = None):
        cfg, dt = self.cfg, self.conv_in.weight.dtype
        if context is not None:
            x = torch.cat([x, context], dim=-1)
        x = x.to(dt)
        temb = None
        if cfg.use_timestep:
            if t is None:
                raise ValueError("Model with use_timestep needs the timesteps t")
            d0, d1 = self.temb.dense
            temb = d1(F.silu(d0(ddpm_timestep_embedding(t, cfg.ch).to(dt))))
        hs = [conv2d_nhwc(x, self.conv_in)]
        for i, lvl in enumerate(self.down):
            for b, blk in enumerate(lvl.block):
                h = blk(hs[-1], temb)
                if len(lvl.attn):
                    h = lvl.attn[b](h)
                hs.append(h)
            if i != len(self.down) - 1:
                hs.append(lvl.downsample(hs[-1]))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(hs[-1], temb)), temb)
        for i in reversed(range(len(self.up))):
            lvl = self.up[i]
            for b, blk in enumerate(lvl.block):
                h = blk(torch.cat([h, hs.pop()], dim=-1), temb)
                if len(lvl.attn):
                    h = lvl.attn[b](h)
            if i != 0:
                h = lvl.upsample(h)
        return conv2d_nhwc(_gn(h, self.norm_out), self.conv_out)


class SimpleDecoder(nn.Module):
    """ae_modules.py:581-614, names ``model.0``-``model.5``: 1x1 conv,
    res(C -> 2C), res(-> 4C), res(-> 2C), 1x1 conv to C, x2 upsample, then
    GroupNorm / swish / ``conv_out``."""

    def __init__(self, in_channels: int, out_channels: int, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        C = in_channels
        self.model = nn.ModuleList([
            nn.Conv2d(C, C, 1), ResnetBlockT(C, 2 * C), ResnetBlockT(2 * C, 4 * C), ResnetBlockT(4 * C, 2 * C),
            nn.Conv2d(2 * C, C, 1), Upsample2D(C),
        ])
        self.norm_out = _norm(C)
        self.conv_out = nn.Conv2d(C, out_channels, 3, padding=1)
        place(self, device, dtype)

    def forward(self, x):
        x = x.to(self.conv_out.weight.dtype)
        for i, layer in enumerate(self.model):
            x = conv2d_nhwc(x, layer) if isinstance(layer, nn.Conv2d) else layer(x)
        return conv2d_nhwc(_gn(x, self.norm_out), self.conv_out)


class UpsampleDecoder(nn.Module):
    """ae_modules.py:617-662: per level ``num_res_blocks + 1`` ResNet blocks
    (``res_blocks.{i}.{b}``) and a x2 upsample between levels
    (``upsample_blocks.{i}``), then GroupNorm / swish / ``conv_out``."""

    def __init__(self, in_channels: int, out_channels: int, ch: int, num_res_blocks: int,
                 ch_mult: Tuple[int, ...] = (2, 2), *, dtype=torch.float32, device="cuda"):
        super().__init__()
        block_in = in_channels
        self.res_blocks = nn.ModuleList()
        self.upsample_blocks = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            blocks = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlockT(block_in, ch * mult))
                block_in = ch * mult
            self.res_blocks.append(blocks)
            if i != len(ch_mult) - 1:
                self.upsample_blocks.append(Upsample2D(block_in))
        self.norm_out = _norm(block_in)
        self.conv_out = nn.Conv2d(block_in, out_channels, 3, padding=1)
        place(self, device, dtype)

    def forward(self, x):
        h = x.to(self.conv_out.weight.dtype)
        for i, blocks in enumerate(self.res_blocks):
            for blk in blocks:
                h = blk(h)
            if i != len(self.res_blocks) - 1:
                h = self.upsample_blocks[i](h)
        return conv2d_nhwc(_gn(h, self.norm_out), self.conv_out)


class LatentRescaler(nn.Module):
    """ae_modules.py:665-699: ``conv_in`` -> ``depth`` ResNet blocks
    (``res_block1.{i}``) -> nearest rescale to ``round(H * factor)`` ->
    ``attn`` -> ``depth`` blocks (``res_block2.{i}``) -> 1x1 ``conv_out``."""

    def __init__(self, factor: float, in_channels: int, mid_channels: int, out_channels: int, depth: int = 2,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.factor = factor
        self.conv_in = nn.Conv2d(in_channels, mid_channels, 3, padding=1)
        self.res_block1 = nn.ModuleList([ResnetBlockT(mid_channels, mid_channels) for _ in range(depth)])
        self.attn = AttnBlock(mid_channels)
        self.res_block2 = nn.ModuleList([ResnetBlockT(mid_channels, mid_channels) for _ in range(depth)])
        self.conv_out = nn.Conv2d(mid_channels, out_channels, 1)
        place(self, device, dtype)

    def forward(self, x):
        x = conv2d_nhwc(x.to(self.conv_in.weight.dtype), self.conv_in)
        for blk in self.res_block1:
            x = blk(x)
        x = torch_nearest_resize(x, int(round(x.shape[1] * self.factor)), int(round(x.shape[2] * self.factor)))
        x = self.attn(x)
        for blk in self.res_block2:
            x = blk(x)
        return conv2d_nhwc(x, self.conv_out)


class MergedRescaleEncoder(nn.Module):
    """ae_modules.py:702-718: the live ``Encoder`` (z = ch * ch_mult[-1],
    one z) and a ``LatentRescaler`` to ``out_ch``; names ``encoder.*`` and
    ``rescaler.*``."""

    def __init__(self, cfg: VAEConfig, out_ch: int, rescale_factor: float = 1.0, rescale_module_depth: int = 1,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        inter = cfg.ch * cfg.ch_mult[-1]
        self.encoder = Encoder(dataclasses.replace(cfg, z_channels=inter, double_z=False))
        self.rescaler = LatentRescaler(rescale_factor, inter, inter, out_ch, depth=rescale_module_depth,
                                       dtype=dtype, device=None)
        place(self, device, dtype)

    def forward(self, x):
        return self.rescaler(self.encoder(x.to(self.encoder.conv_in.weight.dtype)))


class MergedRescaleDecoder(nn.Module):
    """ae_modules.py:721-735: a ``LatentRescaler`` from ``cfg.z_channels``
    to z * ch_mult[-1], then the live ``Decoder``; names ``rescaler.*`` and
    ``decoder.*``."""

    def __init__(self, cfg: VAEConfig, rescale_factor: float = 1.0, rescale_module_depth: int = 1,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        tmp = cfg.z_channels * cfg.ch_mult[-1]
        self.rescaler = LatentRescaler(rescale_factor, cfg.z_channels, tmp, tmp, depth=rescale_module_depth,
                                       dtype=dtype, device=None)
        self.decoder = Decoder(dataclasses.replace(cfg, z_channels=tmp))
        place(self, device, dtype)

    def forward(self, z):
        return self.decoder(self.rescaler(z))


class Upsampler(nn.Module):
    """ae_modules.py:738-754: a ``LatentRescaler`` (factor 1 + out % in,
    depth 2) and a ``Decoder`` of log2(out / in) + 1 levels of ``ch_mult``;
    names ``rescaler.*`` and ``decoder.*``."""

    def __init__(self, in_size: int, out_size: int, in_channels: int, out_channels: int, ch_mult: int = 2,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        if out_size < in_size:
            raise ValueError(f"Upsampler: out_size {out_size} < in_size {in_size}")
        num_blocks = int(np.log2(out_size // in_size)) + 1
        factor_up = 1.0 + (out_size % in_size)
        self.rescaler = LatentRescaler(factor_up, in_channels, 2 * in_channels, in_channels, depth=2,
                                       dtype=dtype, device=None)
        self.decoder = Decoder(VAEConfig(z_channels=in_channels, ch=in_channels,
                                         ch_mult=tuple(ch_mult for _ in range(num_blocks)), num_res_blocks=2,
                                         out_ch=out_channels))
        place(self, device, dtype)

    def forward(self, x):
        return self.decoder(self.rescaler(x))


def resize_2d(x: torch.Tensor, scale_factor: float, mode: str = "bilinear", learned: bool = False) -> torch.Tensor:
    """ae_modules.py:757-777 ``Resize``: NHWC resized by ``scale_factor``
    to ``round(H * scale_factor)``. ``nearest`` is :func:`torch_nearest_resize`;
    every other mode is ``jax.image.resize(..., "linear")``, which widens its
    triangle kernel when it shrinks (``ops/resize.py``; ``F.interpolate``
    agrees with it only when enlarging). The learned branch raises, as
    upstream (:764)."""
    if learned:
        raise NotImplementedError("learned resize is unimplemented upstream (ae_modules.py:764)")
    if scale_factor == 1.0:
        return x
    out = (int(round(x.shape[1] * scale_factor)), int(round(x.shape[2] * scale_factor)))
    if mode == "nearest":
        return torch_nearest_resize(x, *out)
    return resize_video_latent(x[:, None], *out, mode="linear")[:, 0]


class FirstStagePostProcessor(nn.Module):
    """ae_modules.py:780-845 without the frozen first-stage encode: the
    caller passes ``z_fs`` [B, H, W, in_channels], the first stage's
    posterior mode. ``proj_norm`` has ``in_channels // 2`` groups (:801),
    which kernel 9 does not take: it runs the plain fold. Each level is a
    ResNet block (``model.{i}``; the reference's unused ``temb_proj`` weights
    are not built) and a 2x2 stride-2 average pool (:811, :90-108).
    ``do_reshape`` returns [B, H * W, D]."""

    def __init__(self, ch_mult: Tuple[int, ...], in_channels: int, n_channels: int, do_reshape: bool = False,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.do_reshape = do_reshape
        self.proj_norm = nn.GroupNorm(in_channels // 2, in_channels, eps=1e-6)
        self.proj = nn.Conv2d(in_channels, n_channels, 3, padding=1)
        blocks, ch_in = [], n_channels
        for m in ch_mult:
            blocks.append(ResnetBlockT(ch_in, m * n_channels))
            ch_in = m * n_channels
        self.model = nn.ModuleList(blocks)
        place(self, device, dtype)

    def forward(self, z_fs):
        z = z_fs.to(self.proj.weight.dtype)
        pn = self.proj_norm
        mul, add = group_norm_fold_plain(z, pn.weight, pn.bias, pn.num_groups, pn.eps)
        z = F.silu(conv2d_nhwc(gn_silu_plain(z, mul, add, act=False), self.proj))
        for blk in self.model:
            z = F.avg_pool2d(blk(z).permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1).contiguous()
        if self.do_reshape:
            B, H, W, D = z.shape
            z = z.reshape(B, H * W, D)
        return z
