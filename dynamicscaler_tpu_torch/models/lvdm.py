"""LatentVideoDiffusion: the frozen t2v model bundle (UNet + VAE + CLIP text).

Counterpart of ``dynamicscaler_tpu/models/lvdm.py`` (reference
lvdm/models/ddpm3d.py:327-693). Modules live on one ``device`` with their
weights stored in the config's compute dtype; every apply method runs
without autograd. Video VAE encode/decode batches frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from dynamicscaler_tpu_torch.config import ModelConfig, tiny_test_config  # noqa: F401 (re-export)
from dynamicscaler_tpu_torch.models.clip import CLIPTextEncoder
from dynamicscaler_tpu_torch.models.unet3d import UNet3D, is_zero_init
from dynamicscaler_tpu_torch.models.vae import AutoencoderKL


def init_module_random(module: nn.Module, generator: torch.Generator, zero_init=lambda n: False):
    """Seeded random weights in place: Linear/Conv weights N(0, 1/fan_in)
    (lecun normal, as the JAX init), biases 0, norm scales 1, embeddings
    N(0, 0.02) / positional N(0, 0.01); parameters named by ``zero_init``
    are 0, as the reference initialises them."""
    dev = generator.device
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if zero_init(name) or leaf in ("bias", "in_proj_bias"):
                p.zero_()
            elif p.ndim == 1:  # GroupNorm / LayerNorm scales
                p.fill_(1.0)
            elif "positional_embedding" in name:
                p.copy_(torch.randn(p.shape, generator=generator, device=dev) * 0.01)
            elif "token_embedding" in name:
                p.copy_(torch.randn(p.shape, generator=generator, device=dev) * 0.02)
            else:
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=generator, device=dev) / math.sqrt(fan_in))


class LatentVideoDiffusion:
    """Frozen t2v model bundle: ``unet``, ``vae``, ``text_encoder`` modules,
    a host ``tokenizer`` (texts -> [B, 77] int), on ``device``."""

    def __init__(self, config: ModelConfig, unet: UNet3D, vae: AutoencoderKL,
                 text_encoder: CLIPTextEncoder, tokenizer=None):
        if config.clip_vision is not None or config.resampler is not None:
            raise NotImplementedError("the i2v bundle (CLIP vision, resampler) is not ported yet")
        self.config = config
        self.unet = unet.eval()
        self.vae = vae.eval()
        self.text_encoder = text_encoder.eval()
        self.tokenizer = tokenizer
        self.image_encoder = None

    @property
    def device(self) -> torch.device:
        return self.unet.out[2].weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.config.torch_dtype

    # -- constructors -------------------------------------------------------

    @classmethod
    def build(cls, config: ModelConfig, device="meta", tokenizer=None) -> "LatentVideoDiffusion":
        """Modules with uninitialised fp32 storage on ``device`` (``meta``
        allocates nothing: parameter counting)."""
        with torch.device(device):
            return cls(config, UNet3D(config.unet), AutoencoderKL(config.vae),
                       CLIPTextEncoder(config.clip_text), tokenizer)

    @classmethod
    def init_random(cls, config: ModelConfig, generator: torch.Generator, device=None,
                    tokenizer=None) -> "LatentVideoDiffusion":
        """Seeded random weights (development without a checkpoint), stored
        in the config's compute dtype on ``device`` (default: the
        generator's device)."""
        device = torch.device(device if device is not None else generator.device)
        model = cls.build(config, "meta", tokenizer)
        for mod, zero in ((model.unet, is_zero_init), (model.vae, lambda n: False),
                          (model.text_encoder, lambda n: False)):
            mod.to_empty(device=device)
            init_module_random(mod, generator, zero)
            mod.to(config.torch_dtype)
        return model

    def load_state_dicts(self, unet=None, vae=None, clip_text=None):
        """Load per-component state_dicts (VideoCrafter names, prefixes
        stripped; fp32 storage from ``build``) and cast them to the compute
        dtype."""
        for mod, sd in ((self.unet, unet), (self.vae, vae), (self.text_encoder, clip_text)):
            if sd is not None:
                mod.load_state_dict(sd)
                mod.to(self.dtype)
        return self

    # -- apply methods --------------------------------------------------------

    @torch.inference_mode()
    def apply_unet(self, x, t, context, fps=16):
        """eps prediction (fp32). x [B, F, H, W, C]; t [B] or [B, F];
        context [B, L, D]."""
        return self.unet(x, t, context, fps)

    @torch.inference_mode()
    def apply_unet_microbatched(self, x, t_scalar, context, fps=16, microbatch: int = 0):
        """The window batch through the UNet in ``microbatch`` chunks (0 or
        >= batch: one call). ``t_scalar`` is one timestep for every item."""
        n = x.shape[0]
        t = torch.full((n,), int(t_scalar), dtype=torch.long, device=x.device)
        if not microbatch or n <= microbatch:
            return self.apply_unet(x, t, context, fps)
        return torch.cat([
            self.apply_unet(x[i:i + microbatch], t[i:i + microbatch], context[i:i + microbatch], fps)
            for i in range(0, n, microbatch)
        ])

    @torch.inference_mode()
    def encode_text_tokens(self, tokens):
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        return self.text_encoder(tokens)

    def encode_text(self, texts):
        """Tokenize on the host + encode (reference get_learned_conditioning)."""
        if self.tokenizer is None:
            raise ValueError("no tokenizer configured")
        return self.encode_text_tokens(self.tokenizer(texts))

    @torch.inference_mode()
    def decode_video(self, latents):
        """[B, F, h, w, zc] scaled latents -> fp32 [B, F, 8h, 8w, 3]."""
        B, Fn, h, w, zc = latents.shape
        x = self.vae.decode(latents.reshape(B * Fn, h, w, zc).to(self.dtype))
        return x.float().reshape(B, Fn, *x.shape[1:])

    def decode_video_chunked(self, latents, frame_chunk: int = 1):
        """Memory-bounded decode, ``frame_chunk`` frames at a time."""
        Fn = latents.shape[1]
        return torch.cat(
            [self.decode_video(latents[:, f0:f0 + frame_chunk]) for f0 in range(0, Fn, frame_chunk)],
            dim=1,
        )
