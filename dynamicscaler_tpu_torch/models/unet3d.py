"""VideoCrafter 3D UNet in PyTorch.

Counterpart of ``dynamicscaler_tpu/models/unet3d.py`` with the reference's
state_dict names (lvdm/modules/networks/openaimodel3d.py:312-708), so a
VideoCrafter checkpoint loads with ``load_state_dict``. Public layout is the
JAX one: latents ``[B, F, H, W, C]``; spatial layers run on ``[(B F), H, W, C]``
and temporal layers on ``[(B H W), F, C]``. Convolutions are
``F.conv2d``/``F.conv3d`` on channels-last views of those tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dynamicscaler_tpu_torch.config import UNetConfig
from dynamicscaler_tpu_torch.models.attention import BasicTransformerBlock
from dynamicscaler_tpu_torch.models.layers import MLPEmbed, timestep_embedding
from dynamicscaler_tpu_torch.ops import cuda_lib, fused_mega, fused_temporal, fused_twrap
from dynamicscaler_tpu_torch.ops import freetraj as freetraj_ops


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One sub-layer of an encoder/decoder block; ``torch_path`` is its
    state_dict prefix (under ``model.diffusion_model.``)."""

    name: str
    kind: str  # res | spatial | temporal | down | up | conv_in
    channels: int
    torch_path: str
    extra: dict = dataclasses.field(default_factory=dict)


def unet_layout(cfg: UNetConfig) -> Tuple[List[List[BlockSpec]], List[List[BlockSpec]], List[BlockSpec], List[int]]:
    """(input_blocks, output_blocks, middle_block, skip_channels) in
    construction order (openaimodel3d.py:418-649); same as the JAX one."""
    ch = cfg.model_channels
    ds = 1
    input_blocks = [[BlockSpec("in0_conv", "conv_in", ch, "input_blocks.0.0")]]
    input_chans = [ch]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            i = len(input_blocks)
            specs = [BlockSpec(f"in{i}_res", "res", mult * cfg.model_channels,
                               f"input_blocks.{i}.0", {"in_ch": ch})]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                specs.append(BlockSpec(f"in{i}_spatial", "spatial", ch, f"input_blocks.{i}.1"))
                if cfg.temporal_attention:
                    specs.append(BlockSpec(f"in{i}_temporal", "temporal", ch, f"input_blocks.{i}.2"))
            input_blocks.append(specs)
            input_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            i = len(input_blocks)
            input_blocks.append([BlockSpec(f"in{i}_down", "down", ch, f"input_blocks.{i}.0")])
            input_chans.append(ch)
            ds *= 2

    middle = [
        BlockSpec("mid_res0", "res", ch, "middle_block.0", {"in_ch": ch}),
        BlockSpec("mid_spatial", "spatial", ch, "middle_block.1"),
    ]
    mid_idx = 2
    if cfg.temporal_attention:
        middle.append(BlockSpec("mid_temporal", "temporal", ch, "middle_block.2"))
        mid_idx = 3
    middle.append(BlockSpec("mid_res1", "res", ch, f"middle_block.{mid_idx}", {"in_ch": ch}))

    output_blocks: List[List[BlockSpec]] = []
    skip_chans: List[int] = []
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            skip_chans.append(ich)
            oi = len(output_blocks)
            specs = [BlockSpec(f"out{oi}_res", "res", cfg.model_channels * mult,
                               f"output_blocks.{oi}.0", {"in_ch": ch + ich})]
            ch = cfg.model_channels * mult
            j = 1
            if ds in cfg.attention_resolutions:
                specs.append(BlockSpec(f"out{oi}_spatial", "spatial", ch, f"output_blocks.{oi}.{j}"))
                j += 1
                if cfg.temporal_attention:
                    specs.append(BlockSpec(f"out{oi}_temporal", "temporal", ch, f"output_blocks.{oi}.{j}"))
                    j += 1
            if level and i == cfg.num_res_blocks:
                specs.append(BlockSpec(f"out{oi}_up", "up", ch, f"output_blocks.{oi}.{j}"))
                ds //= 2
            output_blocks.append(specs)
    return input_blocks, output_blocks, middle, skip_chans


def gn_silu_calls(cfg: UNetConfig, batch: int, frames: int, H: int, W: int) -> List[Tuple[int, int, int]]:
    """(samples, rows a sample, channels) of every ``fused_twrap.gn_silu``
    call of one forward of ``batch`` clips of ``frames`` frames at an H x W
    latent, in the order the forward makes them: per ResBlock the input and
    the output norm per frame (batch * frames samples of H * W rows), then
    the temporal conv block's four norms per clip (batch samples of frames *
    H * W rows); the out norm last."""
    ins, outs, mid, _ = unet_layout(cfg)
    size = [H, W]
    calls = []
    for specs in (*ins, mid, *outs):
        for sp in specs:
            if sp.kind == "down":
                size = [(n + 1) // 2 for n in size]
            elif sp.kind == "up":
                size = [2 * n for n in size]
            elif sp.kind == "res":
                hw = size[0] * size[1]
                calls += [(batch * frames, hw, sp.extra["in_ch"]), (batch * frames, hw, sp.channels)]
                if cfg.temporal_conv:
                    calls += [(batch, frames * hw, sp.channels)] * 4
    calls.append((batch * frames, H * W, cfg.model_channels))
    return calls


def freetraj_spatial(traj, shape, num_frames: int):
    """FreeTraj's factors for a SpatialTransformer at [(B F), H, W, C]
    (unet3d.py:142-171): {"self": {fg, active} or None, "cross": {fg,
    active, fg_tok, wadd} or None}, gated per frame by ``traj.active``; None
    when neither spatial class is on. Rows follow the (B F) batch."""
    if traj is None or not (traj.self_attn or traj.cross_attn):
        return None
    BF, H, W, _ = shape
    B = BF // num_frames
    fg = freetraj_ops.fg_map(traj.paths, H, W).reshape(num_frames, H * W).repeat(B, 1)  # [(B F), N]
    active = traj.active.reshape(BF)
    d = {"self": None, "cross": None}
    if traj.self_attn:
        d["self"] = {"fg": fg, "active": active}
    if traj.cross_attn:
        wadd = freetraj_ops.cross_weight_map(traj.paths, H, W, traj.fg_tok.sum()).reshape(num_frames, H * W)
        d["cross"] = {"fg": fg, "active": active, "fg_tok": traj.fg_tok, "wadd": wadd.repeat(B, 1)}
    return d


def freetraj_temporal(traj, shape, num_frames: int):
    """FreeTraj's factors for a TemporalTransformer (unet3d.py:174-191):
    tokens are frames and the batch is (B H W) row-major, the row order of
    kernel 5's head (``fused_twrap.head_temporal``); fg says whether the box
    covers the row's position at each frame. Ungated by the timestep, as in
    the reference (attention_freetraj.py:178). attn2 gets no entry."""
    if traj is None or not traj.temporal_attn:
        return None
    BF, H, W, _ = shape
    B = BF // num_frames
    fgm = freetraj_ops.fg_map(traj.paths, H, W)  # [F, H, W]
    fg = fgm.permute(1, 2, 0).reshape(H * W, num_frames).repeat(B, 1)  # [(B H W), F]
    active = torch.ones(B * H * W, dtype=torch.bool, device=fg.device)
    return {"self": {"fg": fg, "active": active}, "cross": None}


# state_dict suffixes the reference zero-initialises (lvdm/basics.py:19
# zero_module): ResBlock out conv, last temporal conv, transformer proj_out,
# UNet out conv (dynamicscaler_tpu/models/unet3d.py:221, 255, 298, 368, 502)
ZERO_INIT_SUFFIXES = (
    "out_layers.3.weight", "out_layers.3.bias",
    "temopral_conv.conv4.3.weight", "temopral_conv.conv4.3.bias",
    "proj_out.weight", "proj_out.bias",
)
ZERO_INIT_NAMES = ("out.2.weight", "out.2.bias")


def is_zero_init(name: str) -> bool:
    return name in ZERO_INIT_NAMES or name.endswith(ZERO_INIT_SUFFIXES)


def conv2d_nhwc(x, conv: nn.Conv2d):
    """Conv2d on an NHWC tensor through its channels-last NCHW view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3d_ndhwc(x, conv: nn.Conv3d):
    """Conv3d on a [B, F, H, W, C] tensor through its channels-last view."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight, conv.bias, conv.stride, conv.padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()


class TemporalConvBlock(nn.Module):
    """4x (GN -> SiLU -> Conv3d(3,1,1)) + residual, last conv zero-init
    (openaimodel3d.py:257-309). Input [B, F, H, W, C]; the GroupNorm
    statistics of each clip span ALL its frames (the JAX twin feeds
    [B, F, H, W, C], unet3d.py:231-232), eps 1e-5."""

    def __init__(self, channels: int):
        super().__init__()

        def conv():
            return nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))

        self.conv1 = nn.Sequential(nn.GroupNorm(32, channels), nn.SiLU(), conv())
        self.conv2 = nn.Sequential(nn.GroupNorm(32, channels), nn.SiLU(), nn.Dropout(0.0), conv())
        self.conv3 = nn.Sequential(nn.GroupNorm(32, channels), nn.SiLU(), nn.Dropout(0.0), conv())
        self.conv4 = nn.Sequential(nn.GroupNorm(32, channels), nn.SiLU(), nn.Dropout(0.0), conv())

    def forward(self, x):
        identity = x
        for seq in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = fused_twrap.gn_silu(x, seq[0].weight, seq[0].bias, eps=1e-5)
            x = conv3d_ndhwc(x, seq[-1])
        return x + identity


class ResBlock(nn.Module):
    """GN -> SiLU -> Conv3x3 + time-emb + GN -> SiLU -> zero Conv3x3 + skip,
    then the temporal conv block (openaimodel3d.py:115-254). GroupNorm
    statistics per frame, eps 1e-5."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_temporal_conv: bool = True):
        super().__init__()
        self.in_layers = nn.Sequential(
            nn.GroupNorm(32, channels), nn.SiLU(), nn.Conv2d(channels, out_channels, 3, padding=1)
        )
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            nn.GroupNorm(32, out_channels), nn.SiLU(), nn.Dropout(0.0),
            nn.Conv2d(out_channels, out_channels, 3, padding=1),
        )
        self.skip_connection = (
            nn.Identity() if channels == out_channels else nn.Conv2d(channels, out_channels, 1)
        )
        self.use_temporal_conv = use_temporal_conv
        if use_temporal_conv:
            self.temopral_conv = TemporalConvBlock(out_channels)  # reference spelling

    def forward(self, x, emb, num_frames: int):
        h = fused_twrap.gn_silu(x, self.in_layers[0].weight, self.in_layers[0].bias, eps=1e-5)
        h = conv2d_nhwc(h, self.in_layers[2])
        emb_out = self.emb_layers[1](F.silu(emb))
        h = h + emb_out[:, None, None, :]
        h = fused_twrap.gn_silu(h, self.out_layers[0].weight, self.out_layers[0].bias, eps=1e-5)
        h = conv2d_nhwc(h, self.out_layers[3])
        if isinstance(self.skip_connection, nn.Conv2d):
            x = conv2d_nhwc(x, self.skip_connection)
        h = x + h
        if self.use_temporal_conv:
            BF, H, W, C = h.shape
            h = self.temopral_conv(h.reshape(BF // num_frames, num_frames, H, W, C))
            h = h.reshape(BF, H, W, C)
        return h


def _wrapper_operands(module, x):
    """(w_in, b_in, w_out, b_out) of a transformer wrapper's proj_in and
    proj_out, weights as [out, in]; on the card packed once per module
    (``fused_twrap.pack_wrapper``: activation-type weights, fp32 biases)."""
    params = (module.proj_in.weight, module.proj_in.bias, module.proj_out.weight, module.proj_out.bias)
    if not x.is_cuda:
        w_in, b_in, w_out, b_out = params
        return w_in.reshape(w_in.shape[0], -1), b_in, w_out.reshape(w_out.shape[0], -1), b_out
    return module._operands.get(lambda: fused_twrap.pack_wrapper(*params, dtype=x.dtype), params, x.dtype)


def _whole_transformer(module, x, op, pack, *ctx, **kw):
    """The whole transformer ``module`` (depth 1) as kernel 12 or 13
    (``op``, after the GroupNorm statistics pass), its operands packed once
    on the card. GroupNorm eps 1e-6 in the transformer wrappers
    (fused_twrap.py:311, 347)."""
    blk = module.transformer_blocks[0]
    lns, a1, a2, ff = blk.weights()
    w_in, b_in, w_out, b_out = (module.proj_in.weight, module.proj_in.bias, module.proj_out.weight,
                                module.proj_out.bias)
    ops = None
    if x.is_cuda:
        params = [w_in, b_in, w_out, b_out, *lns, *a1, *a2, *ff]
        ops = module._mega_operands.get(
            lambda: pack(w_in, b_in, lns, a1, a2, ff, w_out, b_out, dtype=x.dtype), params, x.dtype)
    return op(x, *ctx, module.norm.weight, module.norm.bias, w_in, b_in, lns, a1, a2, ff, w_out, b_out,
              heads=blk.attn1.heads, scale=blk.attn1.scale, gn_eps=1e-6, eps=blk.norm1.eps, operands=ops, **kw)


class SpatialTransformer(nn.Module):
    """GN -> proj_in -> transformer over H*W tokens -> proj_out + residual
    (lvdm/modules/attention.py:223-278, use_linear=True). At depth 1 with a
    context, where the dispatch plan allows ``mega`` at its channels and
    kernel 13's gate admits the shape (``fused_mega.spatial_ok``), the whole
    transformer runs as kernel 13 (``fused_mega.spatial_transformer``); else
    the wrapper head and tail (kernels 7, 8) around the block."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: int = None, img_cross_attention: bool = False,
                 text_context_len: int = 77):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, context_dim=context_dim,
                                  img_cross_attention=img_cross_attention,
                                  text_context_len=text_context_len)
            for _ in range(depth)
        ])
        self.proj_out = nn.Linear(inner, channels)
        self._operands = cuda_lib.PackCache()
        self._mega_operands = cuda_lib.PackCache()

    def forward(self, x, context, num_frames: int = 1, traj=None):
        """x [(B F), H, W, C]; context [(B F), L, D], the same rows for each
        run of ``num_frames`` samples (a clip's frames; 1 where each frame
        has its own image tokens); ``traj`` FreeTraj's factors
        (:func:`freetraj_spatial`), which keep the transformer off kernel 13
        (unet3d.py:301-305)."""
        BF, H, W, C = x.shape
        blk = self.transformer_blocks[0]
        heads = blk.attn1.heads
        if (len(self.transformer_blocks) == 1 and context is not None and traj is None
                and fused_temporal.plan_allows("mega", "s", C, x.dtype)
                and fused_mega.spatial_ok(H * W, C, heads * blk.attn1.dim_head, heads, context.shape[-1])):
            return _whole_transformer(self, x, fused_mega.spatial_transformer, fused_mega.pack_spatial_mega,
                                      context[::num_frames], text_len=blk.attn2.text_context_len)
        w_in, b_in, w_out, b_out = _wrapper_operands(self, x)
        # GroupNorm eps 1e-6 in the transformer wrappers (fused_twrap.py:347)
        h = fused_twrap.gn_proj_in_spatial(x, self.norm.weight, self.norm.bias, w_in, b_in, eps=1e-6)
        for blk in self.transformer_blocks:
            h = blk(h, context=context, num_frames=num_frames, traj=traj)
        return fused_twrap.tail_spatial(h, x, w_out, b_out)


class TemporalTransformer(nn.Module):
    """GN -> proj_in -> transformer over F tokens per (b, h, w) -> proj_out
    + residual (lvdm/modules/attention.py:281-373). Input [(B F), H, W, C].
    ``use_linear=False`` stores proj_in/proj_out as Conv1d(k=1) (the
    reference's ``init_attn``); the compute is the same product. At depth 1
    without a causal mask, where the dispatch plan allows ``mega`` at its
    width and kernel 12's gate admits the shape (``fused_mega.temporal_ok``:
    inner == C, so never the 512-wide init_attn), the whole transformer runs
    as kernel 12 (``fused_mega.temporal_transformer``); else the wrapper head
    and tail (kernels 5, 6) around the block. ``relative_position`` keeps
    the transformer off kernel 12 (unet3d.py:380-386) and its blocks off
    kernel 10 and K1 (plain attention with the tables, K4 feed-forward)."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 use_linear: bool = True, causal_attention: bool = False,
                 only_self_att: bool = True, relative_position: bool = False,
                 temporal_length: int = 16):
        super().__init__()
        if not only_self_att:
            raise NotImplementedError("cross-attn temporal transformer unused by shipped configs")
        inner = heads * dim_head
        self.causal_attention = causal_attention
        self.relative_position = relative_position
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        if use_linear:
            self.proj_in = nn.Linear(channels, inner)
            self.proj_out = nn.Linear(inner, channels)
        else:
            self.proj_in = nn.Conv1d(channels, inner, 1)
            self.proj_out = nn.Conv1d(inner, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, temporal=True, relative_position=relative_position,
                                  temporal_length=temporal_length)
            for _ in range(depth)
        ])
        self._operands = cuda_lib.PackCache()
        self._mega_operands = cuda_lib.PackCache()

    def forward(self, x, num_frames: int, traj=None):
        """x [(B F), H, W, C]; ``traj`` FreeTraj's factors
        (:func:`freetraj_temporal`), which keep the transformer off kernel
        12 (unet3d.py:380-386)."""
        BF, H, W, C = x.shape
        Fn = num_frames
        x5 = x.reshape(BF // Fn, Fn, H, W, C)
        blk = self.transformer_blocks[0]
        heads = blk.attn1.heads
        if (len(self.transformer_blocks) == 1 and not self.causal_attention and traj is None
                and not self.relative_position and fused_temporal.plan_allows("mega", "t", C, x.dtype)
                and fused_mega.temporal_ok(Fn, C, heads * blk.attn1.dim_head, heads)):
            return _whole_transformer(self, x5, fused_mega.temporal_transformer,
                                      fused_mega.pack_temporal_mega).reshape(BF, H, W, C)
        w_in, b_in, w_out, b_out = _wrapper_operands(self, x)
        # GroupNorm eps 1e-6 over each clip (fused_twrap.py:311)
        h = fused_twrap.gn_proj_in_temporal(x5, self.norm.weight, self.norm.bias, w_in, b_in, eps=1e-6)
        mask = None
        if self.causal_attention:
            mask = torch.tril(torch.ones((1, 1, Fn, Fn), dtype=torch.bool, device=x.device))
        for blk in self.transformer_blocks:
            h = blk(h, mask=mask, traj=traj)
        return fused_twrap.tail_temporal(h, x5, w_out, b_out).reshape(BF, H, W, C)


class Downsample(nn.Module):
    """Conv stride 2 (openaimodel3d.py:48-79); state_dict name ``op``."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return conv2d_nhwc(x, self.op)


class Upsample(nn.Module):
    """Nearest x2 + conv 3x3 (openaimodel3d.py:82-112)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return conv2d_nhwc(x, self.conv)


class UNet3D(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        in_specs, out_specs, mid_specs, _ = unet_layout(cfg)
        self._in_specs, self._out_specs, self._mid_specs = in_specs, out_specs, mid_specs
        mc = cfg.model_channels
        self.time_embed = MLPEmbed(mc, mc * 4)
        if cfg.fps_cond:
            self.fps_embedding = MLPEmbed(mc, mc * 4)
        self.input_blocks = nn.ModuleList([nn.ModuleList([self._make(s) for s in sp]) for sp in in_specs])
        if cfg.addition_attention:
            # 8 heads x 64 = 512 wide on 320 channels (unet3d.py:487-495)
            self.init_attn = nn.Sequential(TemporalTransformer(
                mc, 8, cfg.num_head_channels, use_linear=False,
                causal_attention=cfg.use_causal_attention, only_self_att=cfg.temporal_selfatt_only,
                relative_position=cfg.use_relative_position, temporal_length=cfg.temporal_length,
            ))
        self.middle_block = nn.ModuleList([self._make(s) for s in mid_specs])
        self.output_blocks = nn.ModuleList([nn.ModuleList([self._make(s) for s in sp]) for sp in out_specs])
        self.out = nn.Sequential(nn.GroupNorm(32, mc), nn.SiLU(), nn.Conv2d(mc, cfg.out_channels, 3, padding=1))

    def _make(self, spec: BlockSpec) -> nn.Module:
        cfg = self.cfg
        heads = spec.channels // cfg.num_head_channels
        if spec.kind == "conv_in":
            return nn.Conv2d(cfg.in_channels, cfg.model_channels, 3, padding=1)
        if spec.kind == "res":
            return ResBlock(spec.extra["in_ch"], cfg.model_channels * 4, spec.channels,
                            use_temporal_conv=cfg.temporal_conv)
        if spec.kind == "spatial":
            return SpatialTransformer(
                spec.channels, heads, cfg.num_head_channels, depth=cfg.transformer_depth,
                context_dim=cfg.context_dim, img_cross_attention=cfg.use_image_attention,
                text_context_len=cfg.text_context_len,
            )
        if spec.kind == "temporal":
            return TemporalTransformer(
                spec.channels, heads, cfg.num_head_channels, depth=cfg.transformer_depth,
                use_linear=cfg.use_linear, causal_attention=cfg.use_causal_attention,
                only_self_att=cfg.temporal_selfatt_only,
                relative_position=cfg.use_relative_position, temporal_length=cfg.temporal_length,
            )
        if spec.kind == "down":
            return Downsample(spec.channels)
        if spec.kind == "up":
            return Upsample(spec.channels)
        raise ValueError(spec.kind)

    def _run_specs(self, specs, layers, h, emb, context, Fn, ctx_run, traj=None, no_temporal_attn=False):
        """``ctx_run``: the (B F) rows that share one context
        (:meth:`frame_context`)."""
        for spec, layer in zip(specs, layers):
            if spec.kind == "conv_in":
                h = conv2d_nhwc(h, layer)
            elif spec.kind in ("down", "up"):
                h = layer(h)
            elif spec.kind == "res":
                h = layer(h, emb, Fn)
            elif spec.kind == "spatial":
                h = layer(h, context, ctx_run, traj=freetraj_spatial(traj, h.shape, Fn))
            elif spec.kind == "temporal" and not no_temporal_attn:
                h = layer(h, Fn, traj=freetraj_temporal(traj, h.shape, Fn))
        return h

    def frame_context(self, context, Fn: int):
        """The (B F) rows' context of a clip context [B, L, D] and the run
        of rows that share one: the clip's context on each of its frames
        (unet3d.py:548), a run of Fn; with ``image_tokens_per_frame`` n
        (DynamiCrafter, openaimodel3d.py forward) the text tokens on each
        frame and frame f's image tokens [f n, f n + n) after them, a run
        of 1, so that the whole-block kernels 11 and 13, which project a
        run's context K/V once, take every frame's own."""
        cfg = self.cfg
        n = cfg.image_tokens_per_frame
        if not n:
            return context.repeat_interleave(Fn, dim=0), Fn
        B, L, D = context.shape
        Lt = cfg.text_context_len
        if L != Lt + Fn * n:
            raise ValueError(f"context of {L} tokens: {Lt} text and {n} image tokens for each of {Fn} frames "
                             f"make {Lt + Fn * n}")
        txt = context[:, :Lt].repeat_interleave(Fn, dim=0)
        return torch.cat([txt, context[:, Lt:].reshape(B * Fn, n, D)], dim=1), 1

    def forward(self, x, timesteps, context, fps=16, no_temporal_attn=False, traj=None):
        """The model output: eps, or v under a v-parameterised config. x
        [B, F, H, W, in_channels] (with hybrid conditioning the noisy
        latent's channels, then the joined image latent's); timesteps [B]
        (whole clip) or [B, F] (per frame); context [B, L, context_dim];
        fps scalar or [B] (DynamiCrafter's frame stride ``fs``);
        ``no_temporal_attn`` skips every temporal transformer and init_attn
        (the legacy sampler's temporal-guidance probe); ``traj`` an
        ``ops.freetraj.FreeTraj`` (trajectory control, with ``active``
        [B, F]). Returns fp32 [B, F, H, W, out_channels]."""
        cfg = self.cfg
        B, Fn, H, W, C = x.shape
        dt = self.out[2].weight.dtype
        dev = x.device
        timesteps = torch.as_tensor(timesteps, device=dev)
        t_flat = timesteps.reshape(B * Fn) if timesteps.ndim == 2 else timesteps.repeat_interleave(Fn)
        emb = self.time_embed(timestep_embedding(t_flat, cfg.model_channels).to(dt))
        if cfg.fps_cond:
            fps_t = torch.as_tensor(fps, dtype=torch.float32, device=dev).broadcast_to((B,))
            emb = emb + self.fps_embedding(
                timestep_embedding(fps_t.repeat_interleave(Fn), cfg.model_channels).to(dt)
            )
        if C != cfg.in_channels:
            raise ValueError(f"x has {C} channels, the UNet takes {cfg.in_channels}"
                             + (" (the noisy latent's and the joined image latent's)" if cfg.concat_channels else ""))
        # the context rides the (B F) batch
        ctx, run = self.frame_context(context, Fn)
        ctx = ctx.to(dt)
        h = x.reshape(B * Fn, H, W, C).to(dt)

        hs = []
        for i, (specs, layers) in enumerate(zip(self._in_specs, self.input_blocks)):
            h = self._run_specs(specs, layers, h, emb, ctx, Fn, run, traj, no_temporal_attn)
            if i == 0 and cfg.addition_attention and not no_temporal_attn:
                h = self.init_attn[0](h, Fn, traj=freetraj_temporal(traj, h.shape, Fn))
            hs.append(h)
        h = self._run_specs(self._mid_specs, self.middle_block, h, emb, ctx, Fn, run, traj, no_temporal_attn)
        for specs, layers in zip(self._out_specs, self.output_blocks):
            h = torch.cat([h, hs.pop()], dim=-1)
            h = self._run_specs(specs, layers, h, emb, ctx, Fn, run, traj, no_temporal_attn)

        h = fused_twrap.gn_silu(h, self.out[0].weight, self.out[0].bias, eps=1e-5)
        y = conv2d_nhwc(h, self.out[2]).float()
        return y.reshape(B, Fn, H, W, cfg.out_channels)
