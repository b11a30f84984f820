"""Model / pipeline configuration (mirror of ``dynamicscaler_tpu/config.py``).

Plain frozen dataclasses; the presets reproduce the two shipped VideoCrafter
configs (configs/inference_t2v_512_v2.0.yaml, inference_i2v_512_v1.0.yaml)
and DynamiCrafter's 1024 image-to-video model
(configs/inference_1024_v1.0.yaml of github.com/Doubiiu/DynamiCrafter),
which the JAX package does not have: hybrid conditioning (the image latent
joined to the noisy latent as input channels), image tokens per frame and
v-prediction on a zero-terminal-SNR schedule. The defaults of the fields it
adds keep the VideoCrafter presets as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """VideoCrafter 3D UNet (lvdm/modules/networks/openaimodel3d.py:312)."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    use_linear: bool = True
    temporal_conv: bool = True
    temporal_attention: bool = True
    temporal_selfatt_only: bool = True
    use_relative_position: bool = False
    use_causal_attention: bool = False
    use_image_attention: bool = False  # dual text+image cross-attn (i2v)
    temporal_length: int = 16
    addition_attention: bool = True
    fps_cond: bool = True
    text_context_len: int = 77
    # image tokens each frame takes from the context (DynamiCrafter: 16 of the
    # Resampler's 16 x 16, frame f tokens [16 f, 16 f + 16) after the text);
    # 0: every frame takes all of them (VideoCrafter)
    image_tokens_per_frame: int = 0

    @property
    def concat_channels(self) -> int:
        """Input channels joined to the noisy latent (DynamiCrafter's
        ``conditioning_key: hybrid``: the image latent); 0 without."""
        return self.in_channels - self.out_channels


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """SD KL-VAE (lvdm/modules/networks/ae_modules.py:364,466)."""

    z_channels: int = 4
    embed_dim: int = 4
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    attn_resolutions: Tuple[int, ...] = ()
    double_z: bool = True
    scale_factor: float = 0.18215

    @property
    def spatial_scale(self) -> int:
        """Image->latent downsample factor (2 per level transition)."""
        return 2 ** (len(self.ch_mult) - 1)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """OpenCLIP ViT-H/14 text tower, penultimate layer
    (lvdm/modules/encoders/condition.py:174-235)."""

    vocab_size: int = 49408
    width: int = 1024
    layers: int = 24
    heads: int = 16
    context_length: int = 77
    penultimate: bool = True


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """OpenCLIP ViT-H/14 vision tower, full token sequence output."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    output_tokens: int = 257
    output_dim: int = 1024


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """Perceiver image-token projector (lvdm/modules/encoders/ip_resampler.py:93)."""

    dim: int = 1024
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280
    output_dim: int = 1024
    ff_mult: int = 4
    # DynamiCrafter's ``video_length``: num_queries x video_length learned
    # queries, so as many tokens a crop
    video_length: int = 1

    @property
    def tokens(self) -> int:
        return self.num_queries * self.video_length


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Schedule parameters (ddpm3d.py register_schedule + use_scale)."""

    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012
    beta_schedule: str = "linear"
    use_scale: bool = True
    scale_a: float = 1.0
    scale_b: float = 0.7
    mid_step: int = 400
    scale_factor: float = 0.18215
    uncond_type: str = "empty_seq"
    # what the UNet predicts: "eps" (VideoCrafter) or "v" (DynamiCrafter)
    parameterization: str = "eps"
    # betas rescaled to a zero terminal SNR (DynamiCrafter's rescale_betas_zero_snr)
    rescale_betas_zero_snr: bool = False
    # DDIM timestep selection: "uniform" or "uniform_trailing"
    timestep_spacing: str = "uniform"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    clip_text: CLIPTextConfig = CLIPTextConfig()
    clip_vision: Optional[CLIPVisionConfig] = None
    resampler: Optional[ResamplerConfig] = None
    diffusion: DiffusionConfig = DiffusionConfig()
    # compute dtype of the UNet/VAE/CLIP forwards; weights are stored in it
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]


def videocrafter2_t2v(dtype: str = "bfloat16") -> ModelConfig:
    """configs/inference_t2v_512_v2.0.yaml equivalent."""
    return ModelConfig(
        unet=UNetConfig(use_image_attention=False),
        clip_vision=None,
        resampler=None,
        dtype=dtype,
    )


def videocrafter_i2v(dtype: str = "bfloat16") -> ModelConfig:
    """configs/inference_i2v_512_v1.0.yaml equivalent (16-query Resampler,
    full-token CLIP vision)."""
    return ModelConfig(
        unet=UNetConfig(use_image_attention=True),
        clip_vision=CLIPVisionConfig(),
        resampler=ResamplerConfig(),
        dtype=dtype,
    )


def dynamicrafter_i2v_1024(dtype: str = "bfloat16") -> ModelConfig:
    """configs/inference_1024_v1.0.yaml of DynamiCrafter: 8 input channels
    (4 noisy, 4 of the image latent), 16 image tokens per frame from a
    16 x 16-query Resampler, v-prediction with zero-terminal-SNR betas and
    trailing DDIM timesteps, frame stride 10 on the fps embedding, windows
    of 576 x 1024."""
    return ModelConfig(
        unet=UNetConfig(in_channels=8, use_image_attention=True, image_tokens_per_frame=16),
        clip_vision=CLIPVisionConfig(),
        resampler=ResamplerConfig(video_length=16),
        diffusion=DiffusionConfig(scale_b=0.3, parameterization="v", rescale_betas_zero_snr=True,
                                  timestep_spacing="uniform_trailing"),
        dtype=dtype,
    )


# the presets by the names the CLIs take
PRESETS = {"videocrafter_i2v_512": videocrafter_i2v, "dynamicrafter_1024": dynamicrafter_i2v_1024}


def tiny_test_config(img_attention: bool = True) -> ModelConfig:
    """Miniature ModelConfig for fast CPU tests (same topology, tiny dims);
    identical to ``dynamicscaler_tpu.models.lvdm.tiny_test_config``."""
    return ModelConfig(
        unet=UNetConfig(
            model_channels=32,
            num_head_channels=16,
            context_dim=32,
            channel_mult=(1, 2),
            num_res_blocks=1,
            attention_resolutions=(1, 2),
            temporal_length=4,
            use_image_attention=img_attention,
        ),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        clip_text=CLIPTextConfig(vocab_size=512, width=32, layers=2, heads=2),
        clip_vision=CLIPVisionConfig(
            image_size=32, patch_size=16, width=32, layers=2, heads=2, output_tokens=5
        )
        if img_attention
        else None,
        resampler=ResamplerConfig(
            dim=32, depth=1, dim_head=8, heads=2, num_queries=4, embedding_dim=32, output_dim=32
        )
        if img_attention
        else None,
        dtype="float32",
    )


def tiny_dynamicrafter_config() -> ModelConfig:
    """The tiny test topology as DynamiCrafter: 8 input channels, 2 image
    tokens for each of 4 frames, v-prediction on the zero-SNR trailing
    schedule, fp32."""
    cfg = tiny_test_config(img_attention=True)
    return dataclasses.replace(
        cfg,
        unet=dataclasses.replace(cfg.unet, in_channels=8, image_tokens_per_frame=2),
        resampler=dataclasses.replace(cfg.resampler, num_queries=2, video_length=4),
        diffusion=DiffusionConfig(scale_b=0.3, parameterization="v", rescale_betas_zero_snr=True,
                                  timestep_spacing="uniform_trailing"),
    )
