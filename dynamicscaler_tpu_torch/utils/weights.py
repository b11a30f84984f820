"""JAX parameter trees -> the port's VideoCrafter-named state_dicts.

The inverse of ``dynamicscaler_tpu/utils/weights.py`` ``convert_unet``,
``convert_vae``, ``convert_clip_text``, ``convert_clip_vision``,
``convert_clip_vision_pooled``, ``convert_resampler``,
``convert_hf_clip_text``, ``convert_t5_encoder``, the ``convert_aux_*``
converters of the auxiliary ae_modules classes (``convert_aux_model``,
``convert_simple_decoder``, ``convert_upsample_decoder``,
``convert_latent_rescaler``, ``convert_merged_rescale_encoder`` /
``_decoder``, ``convert_upsampler``, ``convert_first_stage_post``) and the
x-transformer's ``convert_attention_layers`` /
``convert_transformer_wrapper`` (and of the ``ImageProjModel`` tree): each ``from_jax_*`` takes the JAX
package's parameter tree (nested dicts of numpy arrays, with or without the
top ``"params"`` level) and returns a ``{name: torch.Tensor}`` state_dict
for the port's module. Layout changes:

  flax Dense kernel [in, out]            -> Linear weight [out, in]
  flax Conv kernel [kh, kw, in, out]     -> Conv2d weight [out, in, kh, kw]
  flax Conv kernel [kt, kh, kw, in, out] -> Conv3d weight [out, in, kt, kh, kw]
  Dense kernel of a Conv1d(k=1) proj     -> Conv1d weight [out, in, 1]
  (the ``init_attn`` proj_in/proj_out, use_linear=False)

Because the names are VideoCrafter's, a real checkpoint loads into the
port's modules directly with ``load_state_dict``:
``load_videocrafter_checkpoint`` reads one and splits it per component.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dynamicscaler_tpu_torch.config import (
    CLIPTextConfig,
    CLIPVisionConfig,
    ModelConfig,
    ResamplerConfig,
    UNetConfig,
    VAEConfig,
)
from dynamicscaler_tpu_torch.models.unet3d import unet_layout


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Out(dict):
    def lin(self, p, tree):
        self[p + ".weight"] = _t(np.asarray(tree["kernel"]).T)
        if "bias" in tree:
            self[p + ".bias"] = _t(tree["bias"])

    def conv2d(self, p, tree):
        self[p + ".weight"] = _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in tree:
            self[p + ".bias"] = _t(tree["bias"])

    def conv3d(self, p, tree):
        self[p + ".weight"] = _t(np.asarray(tree["kernel"]).transpose(4, 3, 0, 1, 2))
        self[p + ".bias"] = _t(tree["bias"])

    def conv1d(self, p, tree):
        self[p + ".weight"] = _t(np.asarray(tree["kernel"]).T[:, :, None])
        self[p + ".bias"] = _t(tree["bias"])

    def norm(self, p, tree):
        self[p + ".weight"] = _t(tree["scale"])
        self[p + ".bias"] = _t(tree["bias"])

    def gn32(self, p, tree):
        self.norm(p, tree["GroupNorm_0"])


def _params(tree):
    return tree["params"] if "params" in tree else tree


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def _attention(out: _Out, p, tree):
    for name in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip"):
        if name in tree:
            out.lin(f"{p}.{name}", tree[name])
    out.lin(p + ".to_out.0", tree["to_out"])
    for kv in ("k", "v"):  # temporal relative position (use_relative_position)
        if f"rel_pos_{kv}" in tree:
            out[f"{p}.relative_position_{kv}.embeddings_table"] = _t(tree[f"rel_pos_{kv}"])


def _transformer(out: _Out, p, tree, depth: int, proj):
    out.gn32(p + ".norm", tree["norm"])
    proj(p + ".proj_in", tree["proj_in"])
    proj(p + ".proj_out", tree["proj_out"])
    for d in range(depth):
        b, bt = f"{p}.transformer_blocks.{d}", tree[f"block{d}"]
        _attention(out, b + ".attn1", bt["attn1"])
        _attention(out, b + ".attn2", bt["attn2"])
        for n in ("norm1", "norm2", "norm3"):
            out.norm(f"{b}.{n}", bt[n])
        out.lin(b + ".ff.net.0.proj", bt["ff"]["geglu"]["proj"])
        out.lin(b + ".ff.net.2", bt["ff"]["out"])


def _res(out: _Out, p, tree):
    out.gn32(p + ".in_layers.0", tree["in_norm"])
    out.conv2d(p + ".in_layers.2", tree["in_conv"])
    out.lin(p + ".emb_layers.1", tree["emb_proj"])
    out.gn32(p + ".out_layers.0", tree["out_norm"])
    out.conv2d(p + ".out_layers.3", tree["out_conv"])
    if "skip_conv" in tree:
        out.conv2d(p + ".skip_connection", tree["skip_conv"])
    if "temporal_conv" in tree:
        tc = tree["temporal_conv"]
        # Sequential indices: conv1 -> (0 GN, 2 Conv); conv2..4 -> (0 GN, 3 Conv)
        for i, conv_idx in zip(range(1, 5), (2, 3, 3, 3)):
            out.gn32(f"{p}.temopral_conv.conv{i}.0", tc[f"norm{i}"])
            out.conv3d(f"{p}.temopral_conv.conv{i}.{conv_idx}", tc[f"conv{i}"])


def from_jax_unet(tree: Dict[str, Any], cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX UNet3D params -> the port's UNet3D state_dict (inverse of
    ``convert_unet``)."""
    p = _params(tree)
    out = _Out()
    out.lin("time_embed.0", p["time_embed"]["fc1"])
    out.lin("time_embed.2", p["time_embed"]["fc2"])
    if cfg.fps_cond:
        out.lin("fps_embedding.0", p["fps_embed"]["fc1"])
        out.lin("fps_embedding.2", p["fps_embed"]["fc2"])
    if cfg.addition_attention:
        _transformer(out, "init_attn.0", p["init_attn"], cfg.transformer_depth, out.conv1d)
    temporal_proj = out.lin if cfg.use_linear else out.conv1d
    in_specs, out_specs, mid_specs, _ = unet_layout(cfg)
    for specs in list(in_specs) + list(out_specs) + [mid_specs]:
        for s in specs:
            t, tp = p[s.name], s.torch_path
            if s.kind == "conv_in":
                out.conv2d(tp, t)
            elif s.kind == "res":
                _res(out, tp, t)
            elif s.kind == "spatial":
                _transformer(out, tp, t, cfg.transformer_depth, out.lin)
            elif s.kind == "temporal":
                _transformer(out, tp, t, cfg.transformer_depth, temporal_proj)
            elif s.kind == "down":
                out.conv2d(tp + ".op", t["conv"])
            elif s.kind == "up":
                out.conv2d(tp + ".conv", t["conv"])
    out.gn32("out.0", p["out_norm"])
    out.conv2d("out.2", p["out_conv"])
    return dict(out)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _resnet(out: _Out, p, tree):
    out.norm(p + ".norm1", tree["norm1"])
    out.conv2d(p + ".conv1", tree["conv1"])
    out.norm(p + ".norm2", tree["norm2"])
    out.conv2d(p + ".conv2", tree["conv2"])
    if "nin_shortcut" in tree:
        out.conv2d(p + ".nin_shortcut", tree["nin_shortcut"])


def _vae_attn(out: _Out, p, tree):
    out.norm(p + ".norm", tree["norm"])
    for n in ("q", "k", "v", "proj_out"):
        out.conv2d(f"{p}.{n}", tree[n])


def _mid(out: _Out, pre, tree):
    _resnet(out, pre + ".mid.block_1", tree["mid_block_1"])
    _vae_attn(out, pre + ".mid.attn_1", tree["mid_attn_1"])
    _resnet(out, pre + ".mid.block_2", tree["mid_block_2"])


def _vae_encoder(out: _Out, pre, enc, cfg: VAEConfig):
    out.conv2d(pre + ".conv_in", enc["conv_in"])
    for i in range(len(cfg.ch_mult)):
        for b in range(cfg.num_res_blocks):
            _resnet(out, f"{pre}.down.{i}.block.{b}", enc[f"down{i}_block{b}"])
        if i != len(cfg.ch_mult) - 1:
            out.conv2d(f"{pre}.down.{i}.downsample.conv", enc[f"down{i}_downsample"]["conv"])
    _mid(out, pre, enc)
    out.norm(pre + ".norm_out", enc["norm_out"])
    out.conv2d(pre + ".conv_out", enc["conv_out"])


def _vae_decoder(out: _Out, pre, dec, cfg: VAEConfig):
    out.conv2d(pre + ".conv_in", dec["conv_in"])
    _mid(out, pre, dec)
    for i in range(len(cfg.ch_mult)):
        for b in range(cfg.num_res_blocks + 1):
            _resnet(out, f"{pre}.up.{i}.block.{b}", dec[f"up{i}_block{b}"])
        if i != 0:
            out.conv2d(f"{pre}.up.{i}.upsample.conv", dec[f"up{i}_upsample"]["conv"])
    out.norm(pre + ".norm_out", dec["norm_out"])
    out.conv2d(pre + ".conv_out", dec["conv_out"])


def from_jax_vae(tree: Dict[str, Any], cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL params -> the port's state_dict (inverse of
    ``convert_vae``)."""
    p = _params(tree)
    out = _Out()
    _vae_encoder(out, "encoder", p["encoder"], cfg)
    _vae_decoder(out, "decoder", p["decoder"], cfg)
    out.conv2d("quant_conv", p["quant_conv"])
    out.conv2d("post_quant_conv", p["post_quant_conv"])
    return dict(out)


# ---------------------------------------------------------------------------
# Auxiliary ae_modules classes (models/vae_aux.py)
# ---------------------------------------------------------------------------


def _resnet_t(out: _Out, p, tree):
    """A ResNet block with its ``temb_proj`` where the JAX tree has one (a
    block called with a timestep embedding)."""
    _resnet(out, p, tree)
    if "temb_proj" in tree:
        out.lin(p + ".temb_proj", tree["temb_proj"])


def _lin_attn(out: _Out, p, tree):
    out.conv2d(p + ".to_qkv", tree["to_qkv"])
    out.conv2d(p + ".to_out", tree["to_out"])


def from_jax_aux_model(tree: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX vae_aux.Model params -> the port's ``Model`` state_dict (inverse
    of ``convert_aux_model``; ``cfg`` an ``AuxModelConfig``; attn_type
    "none" has no attention parameters)."""
    p = _params(tree)
    out = _Out()
    attn = {"vanilla": _vae_attn, "linear": _lin_attn}.get(cfg.attn_type)
    if cfg.use_timestep:
        out.lin("temb.dense.0", p["temb_dense0"])
        out.lin("temb.dense.1", p["temb_dense1"])
    out.conv2d("conv_in", p["conv_in"])
    n, res = len(cfg.ch_mult), cfg.resolution
    for i in range(n):
        for b in range(cfg.num_res_blocks):
            _resnet_t(out, f"down.{i}.block.{b}", p[f"down{i}_block{b}"])
            if res in cfg.attn_resolutions and attn:
                attn(out, f"down.{i}.attn.{b}", p[f"down{i}_attn{b}"])
        if i != n - 1:
            out.conv2d(f"down.{i}.downsample.conv", p[f"down{i}_downsample"]["conv"])
            res //= 2
    _resnet_t(out, "mid.block_1", p["mid_block_1"])
    if attn:
        attn(out, "mid.attn_1", p["mid_attn_1"])
    _resnet_t(out, "mid.block_2", p["mid_block_2"])
    for i in reversed(range(n)):
        for b in range(cfg.num_res_blocks + 1):
            _resnet_t(out, f"up.{i}.block.{b}", p[f"up{i}_block{b}"])
            if res in cfg.attn_resolutions and attn:
                attn(out, f"up.{i}.attn.{b}", p[f"up{i}_attn{b}"])
        if i != 0:
            out.conv2d(f"up.{i}.upsample.conv", p[f"up{i}_upsample"]["conv"])
            res *= 2
    out.norm("norm_out", p["norm_out"])
    out.conv2d("conv_out", p["conv_out"])
    return dict(out)


def from_jax_simple_decoder(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX SimpleDecoder params -> names ``model.0``-``model.5`` (inverse of
    ``convert_simple_decoder``)."""
    p = _params(tree)
    out = _Out()
    out.conv2d("model.0", p["conv0"])
    for i in (1, 2, 3):
        _resnet(out, f"model.{i}", p[f"res{i}"])
    out.conv2d("model.4", p["conv4"])
    out.conv2d("model.5.conv", p["upsample"]["conv"])
    out.norm("norm_out", p["norm_out"])
    out.conv2d("conv_out", p["conv_out"])
    return dict(out)


def from_jax_upsample_decoder(tree: Dict[str, Any], ch_mult, num_res_blocks: int) -> Dict[str, torch.Tensor]:
    """JAX UpsampleDecoder params -> names ``res_blocks.{i}.{b}``,
    ``upsample_blocks.{i}`` (inverse of ``convert_upsample_decoder``)."""
    p = _params(tree)
    out = _Out()
    for i in range(len(ch_mult)):
        for b in range(num_res_blocks + 1):
            _resnet(out, f"res_blocks.{i}.{b}", p[f"res{i}_{b}"])
        if i != len(ch_mult) - 1:
            out.conv2d(f"upsample_blocks.{i}.conv", p[f"upsample{i}"]["conv"])
    out.norm("norm_out", p["norm_out"])
    out.conv2d("conv_out", p["conv_out"])
    return dict(out)


def _latent_rescaler(out: _Out, pre, p, depth: int):
    out.conv2d(pre + "conv_in", p["conv_in"])
    _vae_attn(out, pre + "attn", p["attn"])
    out.conv2d(pre + "conv_out", p["conv_out"])
    for i in range(depth):
        _resnet(out, f"{pre}res_block1.{i}", p[f"res1_{i}"])
        _resnet(out, f"{pre}res_block2.{i}", p[f"res2_{i}"])


def from_jax_latent_rescaler(tree: Dict[str, Any], depth: int = 2) -> Dict[str, torch.Tensor]:
    """JAX LatentRescaler params -> the port's names (inverse of
    ``convert_latent_rescaler``)."""
    out = _Out()
    _latent_rescaler(out, "", _params(tree), depth)
    return dict(out)


def from_jax_merged_rescale_encoder(tree: Dict[str, Any], cfg: VAEConfig, depth: int = 1) -> Dict[str, torch.Tensor]:
    """JAX MergedRescaleEncoder params -> ``encoder.*`` / ``rescaler.*``
    (inverse of ``convert_merged_rescale_encoder``)."""
    p = _params(tree)
    out = _Out()
    _vae_encoder(out, "encoder", p["encoder"], cfg)
    _latent_rescaler(out, "rescaler.", p["rescaler"], depth)
    return dict(out)


def from_jax_merged_rescale_decoder(tree: Dict[str, Any], cfg: VAEConfig, depth: int = 1) -> Dict[str, torch.Tensor]:
    """JAX MergedRescaleDecoder params -> ``rescaler.*`` / ``decoder.*``
    (inverse of ``convert_merged_rescale_decoder``)."""
    p = _params(tree)
    out = _Out()
    _latent_rescaler(out, "rescaler.", p["rescaler"], depth)
    _vae_decoder(out, "decoder", p["decoder"], cfg)
    return dict(out)


def from_jax_upsampler(tree: Dict[str, Any], cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """JAX Upsampler params -> ``rescaler.*`` (depth 2) / ``decoder.*``
    (inverse of ``convert_upsampler``; ``cfg`` the decoder's)."""
    p = _params(tree)
    out = _Out()
    _latent_rescaler(out, "rescaler.", p["rescaler"], 2)
    _vae_decoder(out, "decoder", p["decoder"], cfg)
    return dict(out)


def from_jax_first_stage_post(tree: Dict[str, Any], ch_mult) -> Dict[str, torch.Tensor]:
    """JAX FirstStagePostProcessor params -> ``proj_norm``, ``proj``,
    ``model.{i}`` (inverse of ``convert_first_stage_post``; no
    ``temb_proj``: the forward never reads it)."""
    p = _params(tree)
    out = _Out()
    out.norm("proj_norm", p["proj_norm"])
    out.conv2d("proj", p["proj"])
    for i in range(len(ch_mult)):
        _resnet(out, f"model.{i}", p[f"block{i}"])
    return dict(out)


# ---------------------------------------------------------------------------
# x-transformer (models/x_transformer.py)
# ---------------------------------------------------------------------------


def _x_attention(out: _Out, p, tree):
    for n in ("to_q", "to_k", "to_v"):
        out.lin(f"{p}.{n}", tree[n])
    on_attn = np.shape(tree["to_out"]["kernel"])[1] == 2 * np.shape(tree["to_q"]["kernel"])[0]
    out.lin(p + (".to_out.0" if on_attn else ".to_out"), tree["to_out"])
    for n in ("pre_softmax_proj", "post_softmax_proj", "mem_k", "mem_v"):
        if n in tree:
            out[f"{p}.{n}"] = _t(tree[n])


def _x_layers(out: _Out, pf, p, macaron: bool):
    n = sum(1 for k in p if k.startswith(("attn_", "ff_")))
    for i in range(n):
        base = f"{pf}layers.{i}"
        t = p.get(f"norm_{i}")
        if t is None and i == n - 1 and "norm_0" in p:
            # post-norm never reads the last layer's norm, so the JAX tree has
            # none; the reference builds it: an identity one of its kind
            t = {k: (np.zeros_like if k == "bias" else np.ones_like)(np.asarray(v)) for k, v in p["norm_0"].items()}
        if t is not None:  # none under rezero
            if "g" in t:
                out[base + ".0.g"] = _t(t["g"])
            else:
                out.norm(base + ".0", t)
        if f"attn_{i}" in p:
            rezero = f"rezero_g_{i}" in p
            _x_attention(out, base + (".1.fn" if rezero else ".1"), p[f"attn_{i}"])
            if rezero:
                out[base + ".1.g"] = _t(p[f"rezero_g_{i}"])
        else:
            ff, inner = p[f"ff_{i}"], base + (".1.fn" if macaron else ".1")
            glu = np.shape(ff["proj_in"]["kernel"])[1] == 2 * np.shape(ff["proj_out"]["kernel"])[0]
            out.lin(inner + (".net.0.proj" if glu else ".net.0.0"), ff["proj_in"])
            out.lin(inner + ".net.2", ff["proj_out"])
        if f"gru_{i}" in p:
            for k, v in p[f"gru_{i}"].items():
                out[f"{base}.2.gru.{k}"] = _t(v)


def from_jax_x_transformer(tree: Dict[str, Any], macaron: bool = False) -> Dict[str, torch.Tensor]:
    """JAX AttentionLayers or TransformerWrapper params -> the port's
    state_dict (inverse of ``convert_attention_layers`` /
    ``convert_transformer_wrapper``). The tree tells the rest: a wrapper by
    its ``token_emb``, rezero by its gains, the norm by its leaves, GEGLU by
    ``proj_in``'s width (twice ``proj_out``'s input), ``on_attn`` by
    ``to_out``'s (twice the model's); ``macaron`` puts every feed-forward
    under ``.1.fn``, as the reference's ``Scale`` does. Two parameters the
    JAX forward never creates: a post-norm stack's last norm, which no
    forward reads, is written as an identity norm (the reference builds
    it); ``to_logits`` of a wrapper only ever called with
    ``return_embeddings`` is absent from the tree and from the result."""
    p = _params(tree)
    out = _Out()
    if "token_emb" not in p:
        _x_layers(out, "", p, macaron)
        return dict(out)
    out["token_emb.weight"] = _t(p["token_emb"])
    if "pos_emb" in p:
        out["pos_emb.emb.weight"] = _t(p["pos_emb"]["emb"])
    if "project_emb" in p:
        out.lin("project_emb", p["project_emb"])
    if "memory_tokens" in p:
        out["memory_tokens"] = _t(p["memory_tokens"])
    out.norm("norm", p["norm"])
    if "to_logits" in p:
        out.lin("to_logits", p["to_logits"])
    _x_layers(out, "attn_layers.", p["attn_layers"], macaron)
    return dict(out)


# ---------------------------------------------------------------------------
# CLIP text
# ---------------------------------------------------------------------------


def _clip_block(out: _Out, b, bt):
    out.norm(b + ".ln_1", bt["ln_1"])
    out.norm(b + ".ln_2", bt["ln_2"])
    out[b + ".attn.in_proj_weight"] = _t(np.asarray(bt["attn"]["in_proj"]["kernel"]).T)
    out[b + ".attn.in_proj_bias"] = _t(bt["attn"]["in_proj"]["bias"])
    out.lin(b + ".attn.out_proj", bt["attn"]["out_proj"])
    out.lin(b + ".mlp.c_fc", bt["mlp_fc"])
    out.lin(b + ".mlp.c_proj", bt["mlp_proj"])


def from_jax_clip_text(tree: Dict[str, Any], cfg: CLIPTextConfig) -> Dict[str, torch.Tensor]:
    """JAX CLIPTextEncoder params -> the port's OpenCLIP-named state_dict
    (inverse of ``convert_clip_text``; the blocks that run)."""
    p = _params(tree)
    out = _Out()
    out["token_embedding.weight"] = _t(p["token_embedding"])
    out["positional_embedding"] = _t(p["positional_embedding"])
    out.norm("ln_final", p["ln_final"])
    for i in range(cfg.layers - (1 if cfg.penultimate else 0)):
        _clip_block(out, f"transformer.resblocks.{i}", p[f"resblock{i}"])
    return dict(out)


def from_jax_clip_vision(tree: Dict[str, Any], cfg: CLIPVisionConfig) -> Dict[str, torch.Tensor]:
    """JAX CLIPVisionEncoder params -> the port's OpenCLIP ``visual.*``-named
    state_dict (inverse of ``convert_clip_vision``)."""
    p = _params(tree)
    out = _Out()
    out.conv2d("conv1", p["patch_embed"])
    out["class_embedding"] = _t(p["class_embedding"])
    out["positional_embedding"] = _t(p["positional_embedding"])
    out.norm("ln_pre", p["ln_pre"])
    for i in range(cfg.layers):
        _clip_block(out, f"transformer.resblocks.{i}", p[f"resblock{i}"])
    return dict(out)


def from_jax_clip_vision_pooled(tree: Dict[str, Any], cfg: CLIPVisionConfig) -> Dict[str, torch.Tensor]:
    """JAX CLIPVisionPooled params -> the port's ``visual.*``-named
    state_dict of ``CLIPVisionPooled`` (inverse of
    ``convert_clip_vision_pooled``: the tower, ``ln_post``, ``proj``)."""
    p = _params(tree)
    out = _Out(from_jax_clip_vision(p["tower"], cfg))
    out.norm("ln_post", p["ln_post"])
    out["proj"] = _t(p["proj"])
    return dict(out)


def from_jax_image_proj(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ImageProjModel params -> the port's ``proj`` / ``norm`` names."""
    p = _params(tree)
    out = _Out()
    out.lin("proj", p["proj"])
    out.norm("norm", p["norm"])
    return dict(out)


def from_jax_resampler(tree: Dict[str, Any], cfg: ResamplerConfig) -> Dict[str, torch.Tensor]:
    """JAX Resampler params -> the port's ``image_proj_model.*``-named
    state_dict (inverse of ``convert_resampler``)."""
    p = _params(tree)
    out = _Out()
    out["latents"] = _t(p["latents"])
    out.lin("proj_in", p["proj_in"])
    out.lin("proj_out", p["proj_out"])
    out.norm("norm_out", p["norm_out"])
    for d in range(cfg.depth):
        a, f = p[f"attn{d}"], p[f"ff{d}"]
        out.norm(f"layers.{d}.0.norm1", a["norm1"])
        out.norm(f"layers.{d}.0.norm2", a["norm2"])
        for n in ("to_q", "to_kv", "to_out"):
            out.lin(f"layers.{d}.0.{n}", a[n])
        out.norm(f"layers.{d}.1.0", f["norm"])
        out.lin(f"layers.{d}.1.1", f["fc1"])
        out.lin(f"layers.{d}.1.3", f["fc2"])
    return dict(out)


# ---------------------------------------------------------------------------
# Alternate text encoders (models/encoders_alt.py)
# ---------------------------------------------------------------------------


def from_jax_hf_clip_text(tree: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX HFCLIPTextEncoder params -> a transformers ``CLIPTextModel``-named
    state_dict (``text_model.*``; inverse of ``convert_hf_clip_text``)."""
    p = _params(tree)
    out = _Out()
    r = "text_model."
    out[r + "embeddings.token_embedding.weight"] = _t(p["token_embedding"])
    out[r + "embeddings.position_embedding.weight"] = _t(p["positional_embedding"])
    out.norm(r + "final_layer_norm", p["ln_final"])
    for i in range(cfg.layers):
        b, bt = f"{r}encoder.layers.{i}.", p[f"block{i}"]
        out.norm(b + "layer_norm1", bt["ln_1"])
        out.norm(b + "layer_norm2", bt["ln_2"])
        for n in ("q", "k", "v", "out"):
            out.lin(f"{b}self_attn.{n}_proj", bt[n])
        out.lin(b + "mlp.fc1", bt["mlp_fc"])
        out.lin(b + "mlp.fc2", bt["mlp_proj"])
    return dict(out)


def from_jax_t5(tree: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """JAX T5TextEncoder params -> a transformers ``T5EncoderModel``-named
    state_dict (inverse of ``convert_t5_encoder``): the embedding under
    both of its tied names, the bias table in block 0's attention."""
    p = _params(tree)
    out = _Out()
    emb = _t(p["token_embedding"])
    out["shared.weight"] = emb
    out["encoder.embed_tokens.weight"] = emb
    out["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = _t(p["relative_attention_bias"])
    out["encoder.final_layer_norm.weight"] = _t(p["ln_final"]["weight"])
    for i in range(cfg.num_layers):
        b, bt = f"encoder.block.{i}.layer.", p[f"block{i}"]
        out[b + "0.layer_norm.weight"] = _t(bt["ln_attn"]["weight"])
        out[b + "1.layer_norm.weight"] = _t(bt["ln_ff"]["weight"])
        for n in ("q", "k", "v", "o"):
            out.lin(f"{b}0.SelfAttention.{n}", bt[n])
        for n in ("wi_0", "wi_1", "wo"):
            out.lin(f"{b}1.DenseReluDense.{n}", bt[n])
    return dict(out)


# ---------------------------------------------------------------------------
# Whole-checkpoint loader
# ---------------------------------------------------------------------------

# component -> its key prefix in a VideoCrafter checkpoint
COMPONENT_PREFIXES = {
    "unet": "model.diffusion_model.",
    "vae": "first_stage_model.",
    "clip_text": "cond_stage_model.model.",
    "clip_vision": "embedder.model.visual.",
    "resampler": "image_proj_model.",
}


class EmaFallbackDict(dict):
    """UNet state_dict view with the EMA shadows as fallback (reference
    lvdm/ema.py:5-23). LitEma names a shadow after the wrapped parameter
    with the dots stripped (``model_ema.diffusion_modelinput_blocks00weight``);
    a key the primary dict lacks resolves through its shadow, and with
    ``prefer_ema`` the shadow wins even where the primary exists (the
    reference's ``ema_scope`` at inference, ddpm3d.py:167-180). The loader
    looks up each key of the module's own ``state_dict``, so iteration over
    this view (the primaries only) is never needed."""

    def __init__(self, primary: Dict[str, Any], shadow: Dict[str, Any],
                 prefix: str = "diffusion_model.", prefer_ema: bool = False):
        super().__init__(primary)
        self._shadow = shadow
        self._prefix = prefix
        self._prefer = prefer_ema

    def _sname(self, key: str) -> str:
        return (self._prefix + key).replace(".", "")

    def __getitem__(self, key):
        s = self._sname(key)
        if (self._prefer or not super().__contains__(key)) and s in self._shadow:
            return self._shadow[s]
        return super().__getitem__(key)

    def __contains__(self, key):
        return super().__contains__(key) or self._sname(key) in self._shadow

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default


def extract_ema_shadow(raw: Dict[str, Any]) -> Dict[str, Any]:
    """``model_ema.*`` shadow buffers (minus LitEma's decay/num_updates)."""
    return {
        k[len("model_ema."):]: v
        for k, v in raw.items()
        if k.startswith("model_ema.") and k not in ("model_ema.decay", "model_ema.num_updates")
    }


def split_state_dict(sd: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """A full VideoCrafter checkpoint -> per-component dicts, prefixes
    stripped (:data:`COMPONENT_PREFIXES`)."""
    out: Dict[str, Dict[str, Any]] = {k: {} for k in COMPONENT_PREFIXES}
    for key, val in sd.items():
        for comp, pref in COMPONENT_PREFIXES.items():
            if key.startswith(pref):
                out[comp][key[len(pref):]] = val
                break
    return out


def load_videocrafter_checkpoint(path: str, config: ModelConfig, prefer_ema: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """A VideoCrafter ``.ckpt`` -> ``{component: state_dict}`` for
    :meth:`LatentVideoDiffusion.load_state_dicts`, each holding exactly the
    keys of that component's module for ``config``. Handles the Lightning
    ``state_dict`` nesting, DeepSpeed's ``module.`` prefix
    (scripts/evaluation/funcs.py:88-104) and the UNet's EMA shadows as
    fallback, or preferred with ``prefer_ema`` (lvdm/ema.py; only the UNet
    is EMA'd). No tensor is converted: the port's names are VideoCrafter's.
    A key the module needs and the file lacks raises, naming it and the
    component; keys under a component's prefix that its module lacks (such
    as CLIP's ``logit_scale``) are ignored and counted in one printed line.

    ``torch.load`` runs with ``weights_only=False`` (Lightning pickles more
    than tensors: load only trusted files) and ``map_location="cpu"``: the
    whole file, fp32 in VideoCrafter's checkpoints (5.8 GB for the 1.44B
    UNet alone), lives in host memory, and the returned tensors are its own,
    uncopied. ``load_state_dicts`` copies them into the fp32 modules of
    ``LatentVideoDiffusion.build`` on their device and casts there, so a
    bundle built on the card holds its fp32 copy there until the cast."""
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion

    raw = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in raw:
        raw = raw["state_dict"]
    elif "module" in raw:  # DeepSpeed
        raw = {k[len("module."):]: v for k, v in raw["module"].items()}
    parts = split_state_dict(raw)
    shadow = extract_ema_shadow(raw)
    if shadow:
        parts["unet"] = EmaFallbackDict(parts["unet"], shadow, prefer_ema=prefer_ema)
    out, ignored = {}, {}
    for name, module in LatentVideoDiffusion.build(config, "meta").components():
        sd, keys = parts[name], list(module.state_dict())
        missing = [k for k in keys if k not in sd]
        if missing:
            raise KeyError(f"{path}: the {name} weights lack {len(missing)} of {len(keys)} keys, first "
                           f"{COMPONENT_PREFIXES[name]}{missing[0]}")
        out[name] = {k: sd[k] for k in keys}
        ignored[name] = len(set(dict.keys(sd)) - set(keys))
    print(f"[load_videocrafter_checkpoint] {path}: loaded " + ", ".join(f"{n} {len(v)}" for n, v in out.items())
          + " keys; ignored keys the modules lack: " + ", ".join(f"{n} {k}" for n, k in ignored.items()),
          flush=True)
    return out


def perturb_zero_params(module: torch.nn.Module, generator: torch.Generator, scale: float = 0.02):
    """Give every all-zero parameter small seeded random values. The
    reference zero-initialises its output layers, which makes a random-init
    forward comparison vacuous at those outputs."""
    with torch.no_grad():
        for q in module.parameters():
            if bool((q == 0).all()):
                noise = torch.randn(q.shape, generator=generator, device=generator.device)
                q.add_((noise * scale).to(q.device, q.dtype))
