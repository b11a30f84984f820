"""Plain fp32 PyTorch networks of the VideoCrafter bundle: the 3D UNet, the
OpenCLIP ViT-H/14 text and vision towers, the image Resampler and the KL-VAE.

The benchmark's frozen reference. It follows the published VideoCrafter
modules (lvdm/modules/networks/openaimodel3d.py, lvdm/modules/attention.py,
lvdm/modules/encoders/condition.py and ip_resampler.py,
lvdm/modules/networks/ae_modules.py) with their state_dict names, in plain
``torch`` operations on NCHW tensors, and imports nothing of the program
under test. Departures from the published code, each one the program's:

* the i2v cross-attention takes the image tokens as a second key segment
  with a softmax of its own, the two outputs summed (scale 1.0);
* the CLIP towers return the whole token sequence (the text one stopped
  one block early, the vision one without ``ln_post``);
* the zero-initialised output layers get the weights the benchmark gives
  them.

Attention is computed in row chunks so that one call's logits stay under
``ATTN_CHUNK_BYTES``; every product is fp32 (the caller switches TF32 off).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

ATTN_CHUNK_BYTES = 1 << 30


def attention(q, k, v, scale: float, causal: bool = False):
    """softmax(q k^T * scale) v over [B, H, N, d] x [B, H, M, d], in chunks
    of the B * H rows."""
    B, H, N, d = q.shape
    M = k.shape[2]
    q, k, v = (t.reshape(B * H, t.shape[2], d) for t in (q, k, v))
    rows = max(1, ATTN_CHUNK_BYTES // max(1, N * M * 4))
    mask = None
    if causal:
        mask = torch.ones(N, M, dtype=torch.bool, device=q.device).tril()
    outs = []
    for i in range(0, B * H, rows):
        logits = torch.matmul(q[i:i + rows], k[i:i + rows].transpose(1, 2)) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        outs.append(torch.matmul(torch.softmax(logits, dim=-1), v[i:i + rows]))
    return torch.cat(outs).reshape(B, H, N, d)


def split_heads(t, heads):
    B, N, C = t.shape
    return t.reshape(B, N, heads, C // heads).transpose(1, 2)


def merge_heads(t):
    B, H, N, d = t.shape
    return t.transpose(1, 2).reshape(B, N, H * d)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def timestep_embedding(t, dim: int, max_period: int = 10000):
    """[cos, sin] sinusoidal embedding (openaimodel3d.py)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim=None, heads=8, dim_head=64, img_cross_attention=False,
                 text_context_len=77):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.scale = heads, dim_head ** -0.5
        self.text_context_len = text_context_len
        self.img_cross_attention = img_cross_attention
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))
        if img_cross_attention:
            self.to_k_ip = nn.Linear(context_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(context_dim, inner, bias=False)

    def forward(self, x, context=None):
        h = self.heads
        q = split_heads(self.to_q(x), h)
        ctx = x if context is None else context
        if self.img_cross_attention:
            txt, img = ctx[:, :self.text_context_len], ctx[:, self.text_context_len:]
            out = attention(q, split_heads(self.to_k(txt), h), split_heads(self.to_v(txt), h), self.scale)
            out = out + attention(q, split_heads(self.to_k_ip(img), h), split_heads(self.to_v_ip(img), h),
                                  self.scale)
        else:
            out = attention(q, split_heads(self.to_k(ctx), h), split_heads(self.to_v(ctx), h), self.scale)
        return self.to_out(merge_heads(out))


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0), nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim=None, img_cross_attention=False,
                 text_context_len=77, temporal=False):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, None if temporal else context_dim, heads, dim_head,
                                    img_cross_attention=img_cross_attention and not temporal,
                                    text_context_len=text_context_len)
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(dim), nn.LayerNorm(dim), nn.LayerNorm(dim)
        self.temporal = temporal

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), None if self.temporal else context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm per frame -> proj_in -> block over H*W tokens -> proj_out + x."""

    def __init__(self, channels, heads, dim_head, context_dim, img_cross_attention, text_context_len):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            inner, heads, dim_head, context_dim, img_cross_attention, text_context_len)])
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context):
        BF, C, H, W = x.shape
        h = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for blk in self.transformer_blocks:
            h = blk(h, context)
        return self.proj_out(h).transpose(1, 2).reshape(BF, C, H, W) + x


class TemporalTransformer(nn.Module):
    """GroupNorm over each clip -> proj_in -> block over the F tokens of
    every (b, h, w) -> proj_out + x. ``use_linear=False`` holds proj_in and
    proj_out as 1x1 Conv1d weights (the ``init_attn`` of 512 inner)."""

    def __init__(self, channels, heads, dim_head, use_linear=True):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        if use_linear:
            self.proj_in, self.proj_out = nn.Linear(channels, inner), nn.Linear(inner, channels)
        else:
            self.proj_in, self.proj_out = nn.Conv1d(channels, inner, 1), nn.Conv1d(inner, channels, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(inner, heads, dim_head, temporal=True)])

    @staticmethod
    def _proj(m, t):
        return m(t) if isinstance(m, nn.Linear) else m(t.transpose(1, 2)).transpose(1, 2)

    def forward(self, x, frames):
        BF, C, H, W = x.shape
        B = BF // frames
        x5 = x.reshape(B, frames, C, H, W).transpose(1, 2)  # [B, C, F, H, W]
        t = self.norm(x5).permute(0, 3, 4, 2, 1).reshape(B * H * W, frames, C)
        h = self._proj(self.proj_in, t)
        for blk in self.transformer_blocks:
            h = blk(h)
        h = self._proj(self.proj_out, h).reshape(B, H, W, frames, C).permute(0, 3, 4, 1, 2)
        return h.reshape(BF, C, H, W) + x


class TemporalConvBlock(nn.Module):
    """4 x (GroupNorm over the clip -> SiLU -> Conv3d (3, 1, 1)) + x."""

    def __init__(self, channels):
        super().__init__()

        def conv():
            return nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))

        self.conv1 = nn.Sequential(nn.GroupNorm(32, channels), nn.SiLU(), conv())
        self.conv2 = nn.Sequential(nn.GroupNorm(32, channels), nn.SiLU(), nn.Dropout(0.0), conv())
        self.conv3 = nn.Sequential(nn.GroupNorm(32, channels), nn.SiLU(), nn.Dropout(0.0), conv())
        self.conv4 = nn.Sequential(nn.GroupNorm(32, channels), nn.SiLU(), nn.Dropout(0.0), conv())

    def forward(self, x):  # [B, C, F, H, W]
        identity = x
        for seq in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = seq(x)
        return x + identity


class ResBlock(nn.Module):
    def __init__(self, channels, emb_channels, out_channels, temporal_conv=True):
        super().__init__()
        self.in_layers = nn.Sequential(nn.GroupNorm(32, channels), nn.SiLU(),
                                       nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, out_channels), nn.SiLU(), nn.Dropout(0.0),
                                        nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (nn.Identity() if channels == out_channels
                                else nn.Conv2d(channels, out_channels, 1))
        if temporal_conv:
            self.temopral_conv = TemporalConvBlock(out_channels)  # the published spelling

    def forward(self, x, emb, frames):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        h = self.skip_connection(x) + self.out_layers(h)
        if hasattr(self, "temopral_conv"):
            BF, C, H, W = h.shape
            h5 = self.temopral_conv(h.reshape(BF // frames, frames, C, H, W).transpose(1, 2))
            h = h5.transpose(1, 2).reshape(BF, C, H, W)
        return h


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def unet_plan(cfg):
    """(input_blocks, middle, output_blocks): per block a list of (kind,
    channels, in_channels) in the published construction order."""
    mc = cfg.model_channels
    ch, ds = mc, 1
    ins = [[("conv_in", mc, cfg.in_channels)]]
    chans = [mc]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            specs = [("res", mult * mc, ch)]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                specs += [("spatial", ch, ch), ("temporal", ch, ch)]
            ins.append(specs)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            ins.append([("down", ch, ch)])
            chans.append(ch)
            ds *= 2
    mid = [("res", ch, ch), ("spatial", ch, ch), ("temporal", ch, ch), ("res", ch, ch)]
    outs = []
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            skip = chans.pop()
            specs = [("res", mc * mult, ch + skip)]
            ch = mc * mult
            if ds in cfg.attention_resolutions:
                specs += [("spatial", ch, ch), ("temporal", ch, ch)]
            if level and i == cfg.num_res_blocks:
                specs.append(("up", ch, ch))
                ds //= 2
            outs.append(specs)
    return ins, mid, outs


class UNet(nn.Module):
    """The VideoCrafter 3D UNet (openaimodel3d.py:312-708) for the shipped
    configs: linear transformer projections, temporal convs, temporal
    self-attention only, no relative position, no causal mask, fps
    conditioning, addition attention. ``forward`` takes and returns [B, F,
    H, W, C] fp32."""

    def __init__(self, cfg):
        super().__init__()
        for flag, want in (("use_relative_position", False), ("use_causal_attention", False),
                           ("temporal_selfatt_only", True), ("use_linear", True), ("temporal_conv", True),
                           ("temporal_attention", True), ("addition_attention", True), ("fps_cond", True),
                           ("transformer_depth", 1)):
            if getattr(cfg, flag) != want:
                raise ValueError(f"the reference UNet covers {flag}={want} only")
        self.cfg = cfg
        mc = cfg.model_channels
        self.time_embed = nn.Sequential(nn.Linear(mc, 4 * mc), nn.SiLU(), nn.Linear(4 * mc, 4 * mc))
        self.fps_embedding = nn.Sequential(nn.Linear(mc, 4 * mc), nn.SiLU(), nn.Linear(4 * mc, 4 * mc))
        ins, mid, outs = unet_plan(cfg)
        self.input_blocks = nn.ModuleList([nn.ModuleList([self._make(*s) for s in b]) for b in ins])
        self.init_attn = nn.Sequential(TemporalTransformer(mc, 8, cfg.num_head_channels, use_linear=False))
        self.middle_block = nn.ModuleList([self._make(*s) for s in mid])
        self.output_blocks = nn.ModuleList([nn.ModuleList([self._make(*s) for s in b]) for b in outs])
        self.out = nn.Sequential(nn.GroupNorm(32, mc), nn.SiLU(), nn.Conv2d(mc, cfg.out_channels, 3, padding=1))

    def _make(self, kind, ch, in_ch):
        cfg = self.cfg
        heads = ch // cfg.num_head_channels
        if kind == "conv_in":
            return nn.Conv2d(in_ch, ch, 3, padding=1)
        if kind == "res":
            return ResBlock(in_ch, 4 * cfg.model_channels, ch)
        if kind == "spatial":
            return SpatialTransformer(ch, heads, cfg.num_head_channels, cfg.context_dim, cfg.use_image_attention,
                                      cfg.text_context_len)
        if kind == "temporal":
            return TemporalTransformer(ch, heads, cfg.num_head_channels)
        return Downsample(ch) if kind == "down" else Upsample(ch)

    @staticmethod
    def _run(layers, h, emb, ctx, frames):
        for layer in layers:
            if isinstance(layer, ResBlock):
                h = layer(h, emb, frames)
            elif isinstance(layer, SpatialTransformer):
                h = layer(h, ctx)
            elif isinstance(layer, TemporalTransformer):
                h = layer(h, frames)
            else:
                h = layer(h)
        return h

    def forward(self, x, t, context, fps):
        """x [B, F, H, W, C]; t [B] timesteps; context [B, L, D]; fps int."""
        B, Fn, H, W, C = x.shape
        mc = self.cfg.model_channels
        t_f = t.reshape(B).repeat_interleave(Fn)
        emb = self.time_embed(timestep_embedding(t_f, mc))
        emb = emb + self.fps_embedding(timestep_embedding(torch.full_like(t_f, fps, dtype=torch.float32), mc))
        ctx = context.repeat_interleave(Fn, dim=0)
        h = x.permute(0, 1, 4, 2, 3).reshape(B * Fn, C, H, W)
        hs = []
        for i, layers in enumerate(self.input_blocks):
            h = self._run(layers, h, emb, ctx, Fn)
            if i == 0:
                h = self.init_attn[0](h, Fn)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, ctx, Fn)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb, ctx, Fn)
        y = self.out(h)
        return y.reshape(B, Fn, -1, H, W).permute(0, 1, 3, 4, 2)


# ---------------------------------------------------------------------------
# CLIP towers and the Resampler
# ---------------------------------------------------------------------------

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(images, size: int):
    """[-1, 1] [B, H, W, 3] -> CLIP-normalised [B, 3, size, size]:
    antialiased bicubic resize (half-pixel centres), then the CLIP mean and
    std."""
    x = F.interpolate(images.float().permute(0, 3, 1, 2), size=(size, size), mode="bicubic", antialias=True,
                      align_corners=False)
    mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
    return ((x + 1.0) / 2.0 - mean) / std


class _MHA(nn.Module):
    """OpenCLIP's ``nn.MultiheadAttention`` parameters, applied plainly."""

    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, causal):
        q, k, v = (split_heads(t, self.heads) for t in F.linear(x, self.in_proj_weight,
                                                              self.in_proj_bias).chunk(3, dim=-1))
        d = q.shape[-1]
        return self.out_proj(merge_heads(attention(q, k, v, d ** -0.5, causal)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads, causal):
        super().__init__()
        self.causal = causal
        self.ln_1 = nn.LayerNorm(width)
        self.attn = _MHA(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, 4 * width))
        self.mlp.add_module("gelu", nn.GELU())
        self.mlp.add_module("c_proj", nn.Linear(4 * width, width))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x), self.causal)
        return x + self.mlp(self.ln_2(x))


class CLIPText(nn.Module):
    """Token + positional embedding, the causal tower stopped one block
    early (the penultimate layer), ``ln_final``; all 77 tokens out."""

    def __init__(self, cfg):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList([ResidualAttentionBlock(cfg.width, cfg.heads, True)
                                                    for _ in range(cfg.layers - 1)])
        self.ln_final = nn.LayerNorm(cfg.width)

    def forward(self, tokens):
        x = self.token_embedding(tokens) + self.positional_embedding
        for blk in self.transformer.resblocks:
            x = blk(x)
        return self.ln_final(x)


class CLIPVision(nn.Module):
    """Patch conv, class token, positional embedding, ``ln_pre``, the full
    tower; every token out (FrozenOpenCLIPImageEmbedderV2)."""

    def __init__(self, cfg):
        super().__init__()
        self.patch = cfg.patch_size
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, cfg.width))
        self.ln_pre = nn.LayerNorm(cfg.width)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList([ResidualAttentionBlock(cfg.width, cfg.heads, False)
                                                    for _ in range(cfg.layers)])

    def forward(self, x):  # [B, 3, S, S]
        x = self.conv1(x).flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(x.shape[0], 1, -1), x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        for blk in self.transformer.resblocks:
            x = blk(x)
        return x


class PerceiverAttention(nn.Module):
    def __init__(self, dim, dim_head, heads):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.norm1, self.norm2 = nn.LayerNorm(dim), nn.LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        x, latents = self.norm1(x), self.norm2(latents)
        q = split_heads(self.to_q(latents), self.heads)
        k, v = (split_heads(t, self.heads) for t in self.to_kv(torch.cat([x, latents], dim=1)).chunk(2, dim=-1))
        return self.to_out(merge_heads(attention(q, k, v, self.dim_head ** -0.5)))


class Resampler(nn.Module):
    """The 16-query perceiver of ip_resampler.py:93-135."""

    def __init__(self, cfg):
        super().__init__()
        self.latents = nn.Parameter(torch.empty(1, cfg.num_queries, cfg.dim))
        self.proj_in = nn.Linear(cfg.embedding_dim, cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.output_dim)
        self.norm_out = nn.LayerNorm(cfg.output_dim)
        self.layers = nn.ModuleList([nn.ModuleList([
            PerceiverAttention(cfg.dim, cfg.dim_head, cfg.heads),
            nn.Sequential(nn.LayerNorm(cfg.dim), nn.Linear(cfg.dim, cfg.dim * cfg.ff_mult, bias=False), nn.GELU(),
                          nn.Linear(cfg.dim * cfg.ff_mult, cfg.dim, bias=False))]) for _ in range(cfg.depth)])

    def forward(self, x):
        latents = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return self.norm_out(self.proj_out(latents))


# ---------------------------------------------------------------------------
# KL-VAE
# ---------------------------------------------------------------------------


def _gn(c):
    return nn.GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = _gn(cin), nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = _gn(cout), nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class AttnBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = _gn(c)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(c, c, 1) for _ in range(4))

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (m(h).flatten(2).transpose(1, 2)[:, None] for m in (self.q, self.k, self.v))
        out = attention(q, k, v, C ** -0.5)[:, 0].transpose(1, 2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class _Mid(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = ResnetBlock(c, c), AttnBlock(c), ResnetBlock(c, c)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


def _level():
    m = nn.Module()
    m.block, m.attn = nn.ModuleList(), nn.ModuleList()
    return m


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        self.down = nn.ModuleList()
        cin = cfg.ch
        for i, mult in enumerate(cfg.ch_mult):
            lvl = _level()
            for _ in range(cfg.num_res_blocks):
                lvl.block.append(ResnetBlock(cin, cfg.ch * mult))
                cin = cfg.ch * mult
            if i != len(cfg.ch_mult) - 1:
                lvl.downsample = nn.Module()
                lvl.downsample.conv = nn.Conv2d(cin, cin, 3, stride=2, padding=0)
            self.down.append(lvl)
        self.mid = _Mid(cin)
        self.norm_out = _gn(cin)
        self.conv_out = nn.Conv2d(cin, 2 * cfg.z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for i, lvl in enumerate(self.down):
            for blk in lvl.block:
                h = blk(h)
            if i != len(self.down) - 1:
                h = lvl.downsample.conv(F.pad(h, (0, 1, 0, 1)))  # right / bottom pad, stride 2
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        cin = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, cin, 3, padding=1)
        self.mid = _Mid(cin)
        up = []
        for i in reversed(range(len(cfg.ch_mult))):
            lvl = _level()
            for _ in range(cfg.num_res_blocks + 1):
                lvl.block.append(ResnetBlock(cin, cfg.ch * cfg.ch_mult[i]))
                cin = cfg.ch * cfg.ch_mult[i]
            if i != 0:
                lvl.upsample = Upsample(cin)
            up.insert(0, lvl)
        self.up = nn.ModuleList(up)
        self.norm_out = _gn(cin)
        self.conv_out = nn.Conv2d(cin, cfg.out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for i in reversed(range(len(self.up))):
            for blk in self.up[i].block:
                h = blk(h)
            if i != 0:
                h = self.up[i].upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.scale_factor = cfg.scale_factor
        self.encoder, self.decoder = Encoder(cfg), Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def encode(self, x):
        """[B, H, W, 3] in [-1, 1] -> the scaled posterior mode [B, h, w, z]."""
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return moments.chunk(2, dim=1)[0].permute(0, 2, 3, 1) * self.scale_factor

    def decode(self, z):
        """[B, h, w, z] scaled latents -> [B, H, W, 3]."""
        z = z.permute(0, 3, 1, 2) / self.scale_factor
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------


def namespace(d):
    return None if d is None else SimpleNamespace(**d)


def build(cfg: dict, device="meta"):
    """The components of a configuration file's ``model`` dict as
    {name: module} on ``device``, fp32, uninitialised."""
    with torch.device(device):
        mods = {"unet": UNet(namespace(cfg["unet"])), "vae": AutoencoderKL(namespace(cfg["vae"])),
                "clip_text": CLIPText(namespace(cfg["clip_text"]))}
        if cfg.get("clip_vision"):
            mods["clip_vision"] = CLIPVision(namespace(cfg["clip_vision"]))
            mods["resampler"] = Resampler(namespace(cfg["resampler"]))
    return mods
