"""LatentVideoDiffusion: the frozen model bundle (UNet + VAE + CLIP text, and
for i2v the CLIP vision tower and the Resampler).

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
from dynamicscaler_tpu_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder, clip_preprocess
from dynamicscaler_tpu_torch.models.resampler import Resampler
from dynamicscaler_tpu_torch.models.unet3d import UNet3D, is_zero_init
from dynamicscaler_tpu_torch.models.vae import AutoencoderKL
from dynamicscaler_tpu_torch.parallel.mesh import apply_sharded
from dynamicscaler_tpu_torch.utils.timing import span


def init_module_random(module: nn.Module, generator: torch.Generator, zero_init=lambda n: False):
    """Seeded random weights in place: Linear/Conv weights N(0, 1/fan_in)
    (lecun normal, as the JAX init), biases 0, norm scales 1, embeddings
    N(0, 0.02) / positional N(0, 0.01); parameters named by ``zero_init``
    are 0, as the reference initialises them. The CLIP class token is
    N(0, 0.02) and the Resampler queries N(0, 1/dim), as the JAX init."""
    dev = generator.device
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if zero_init(name) or leaf in ("bias", "in_proj_bias"):
                p.zero_()
            elif leaf == "class_embedding":
                p.copy_(torch.randn(p.shape, generator=generator, device=dev) * 0.02)
            elif leaf == "latents":
                p.copy_(torch.randn(p.shape, generator=generator, device=dev) / math.sqrt(p.shape[-1]))
            elif p.ndim == 1:  # GroupNorm / LayerNorm scales
                p.fill_(1.0)
            elif "positional_embedding" in name:
                p.copy_(torch.randn(p.shape, generator=generator, device=dev) * 0.01)
            elif "token_embedding" in name:
                p.copy_(torch.randn(p.shape, generator=generator, device=dev) * 0.02)
            else:
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=generator, device=dev) / math.sqrt(fan_in))


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


class LatentVideoDiffusion:
    """Frozen model bundle: ``unet``, ``vae``, ``text_encoder`` and, for an
    i2v config, ``image_encoder`` (CLIP vision) and ``resampler`` modules
    (else None); a host ``tokenizer`` (texts -> [B, 77] int); on
    ``device``."""

    def __init__(self, config: ModelConfig, unet: UNet3D, vae: AutoencoderKL,
                 text_encoder: CLIPTextEncoder, image_encoder: CLIPVisionEncoder = None,
                 resampler: Resampler = None, tokenizer=None):
        if (image_encoder is None) != (config.clip_vision is None) or \
                (resampler is None) != (config.resampler is None):
            raise ValueError("the image encoder and resampler must match the config's i2v parts")
        self.config = config
        self.unet = unet.eval()
        self.vae = vae.eval()
        self.text_encoder = text_encoder.eval()
        self.image_encoder = None if image_encoder is None else image_encoder.eval()
        self.resampler = None if resampler is None else resampler.eval()
        self.tokenizer = tokenizer

    def components(self):
        """(name, module) of every component the bundle holds."""
        mods = [("unet", self.unet), ("vae", self.vae), ("clip_text", self.text_encoder),
                ("clip_vision", self.image_encoder), ("resampler", self.resampler)]
        return [(n, m) for n, m in mods if m is not None]

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
            return cls(
                config, UNet3D(config.unet), AutoencoderKL(config.vae),
                CLIPTextEncoder(config.clip_text),
                CLIPVisionEncoder(config.clip_vision) if config.clip_vision else None,
                Resampler(config.resampler) if config.resampler else None,
                tokenizer,
            )

    @classmethod
    def init_random(cls, config: ModelConfig, generator: torch.Generator, device="cuda",
                    tokenizer=None) -> "LatentVideoDiffusion":
        """Seeded random weights (development without a checkpoint), stored
        in the config's compute dtype on ``device``: the card unless the
        caller asks for another device. ``generator`` must live on that
        device."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("init_random builds on the CUDA card by default and none is "
                               "available: pass device='cpu' to build on the CPU")
        if not _same_device(torch.device(generator.device), device):
            raise ValueError(f"generator on {generator.device} cannot fill weights on {device}")
        model = cls.build(config, "meta", tokenizer)
        for name, mod in model.components():
            mod.to_empty(device=device)
            init_module_random(mod, generator, is_zero_init if name == "unet" else lambda n: False)
            mod.to(config.torch_dtype)
        return model

    @classmethod
    def init_constant(cls, config: ModelConfig, value: float = 0.01, device="cuda",
                      tokenizer=None) -> "LatentVideoDiffusion":
        """Every parameter set to ``value`` in the config's compute dtype on
        ``device`` (the card unless the caller asks for another): the
        full-size bundle without assets or host random numbers, for
        measuring the whole pipeline. Built on ``meta``, allocated on the
        device in the compute dtype, then filled."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("init_constant builds on the CUDA card by default and none is "
                               "available: pass device='cpu' to build on the CPU")
        model = cls.build(config, "meta", tokenizer)
        with torch.no_grad():
            for _, mod in model.components():
                mod.to(config.torch_dtype).to_empty(device=device)
                for p in mod.parameters():
                    p.fill_(value)
        return model

    def load_state_dicts(self, unet=None, vae=None, clip_text=None, clip_vision=None,
                         resampler=None):
        """Load per-component state_dicts (VideoCrafter names, prefixes
        stripped; fp32 storage from ``build``) and cast them to the compute
        dtype."""
        given = dict(unet=unet, vae=vae, clip_text=clip_text, clip_vision=clip_vision,
                     resampler=resampler)
        held = dict(self.components())
        for name, sd in given.items():
            if sd is None:
                continue
            if name not in held:
                raise ValueError(f"this bundle has no {name} (t2v config)")
            held[name].load_state_dict(sd)
            held[name].to(self.dtype)
        return self

    # -- apply methods --------------------------------------------------------

    @torch.inference_mode()
    def apply_unet(self, x, t, context, fps=16, no_temporal_attn=False, traj=None):
        """eps prediction (fp32). x [B, F, H, W, C]; t [B] or [B, F];
        context [B, L, D]; ``no_temporal_attn`` skips the temporal
        transformers (the legacy sampler's temporal-guidance probe,
        samplers/ddim.py:228-231); ``traj`` FreeTraj's state
        (``ops.freetraj``)."""
        return self.unet(x, t, context, fps, no_temporal_attn, traj=traj)

    @torch.inference_mode()
    def apply_unet_microbatched(self, x, t_scalar, context, fps=16, microbatch: int = 0, mesh=None):
        """The window batch through the UNet in ``microbatch`` chunks (0 or
        >= batch: one call). ``t_scalar`` is one timestep for every item.
        With a ``mesh`` (``parallel.mesh``) this rank runs its share and the
        ranks gather the whole batch's eps."""
        if mesh is not None:
            def share(xs, cs):
                return self._unet_rows(xs, t_scalar, cs, fps, microbatch)
            return apply_sharded(mesh, share, x, context, microbatch, self.config.unet.out_channels)
        return self._unet_rows(x, t_scalar, context, fps, microbatch)

    def _unet_rows(self, x, t_scalar, context, fps, microbatch):
        """This card's rows of the window batch, a ``unet`` span."""
        n = x.shape[0]
        mb = microbatch if microbatch and n > microbatch else n
        with span("unet", x.device, forwards=-(-n // max(mb, 1)), rows=n):
            t = torch.full((n,), int(t_scalar), dtype=torch.long, device=x.device)
            if mb == n:
                return self.apply_unet(x, t, context, fps)
            return torch.cat([
                self.apply_unet(x[i:i + mb], t[i:i + mb], context[i:i + mb], fps) for i in range(0, n, mb)
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
    def encode_image_cond(self, images, microbatch: int = 32):
        """[-1, 1] NHWC image(s) [B, H, W, 3] -> [B, num_queries, output_dim]
        Resampler tokens (ddpm3d.py:689-693: embedder -> image_proj_model),
        in chunks of ``microbatch`` images (bounded activation memory)."""
        if self.image_encoder is None:
            raise ValueError("this bundle has no image encoder (t2v config)")
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        images = images.to(self.device, torch.float32)
        size = self.config.clip_vision.image_size
        return torch.cat([
            self.resampler(self.image_encoder(clip_preprocess(images[i:i + microbatch], size)))
            for i in range(0, images.shape[0], microbatch)
        ])

    @torch.inference_mode()
    def encode_video(self, video, generator=None, noise=None):
        """[B, F, H, W, 3] in [-1, 1] -> scaled fp32 latents [B, F, h, w, zc]
        (the posterior mode, or a sample with ``generator`` or ``noise``).
        Frames ride the VAE batch."""
        B, Fn, H, W, C = video.shape
        flat = video.reshape(B * Fn, H, W, C).to(self.dtype)
        z = self.vae.encode(flat, generator, noise).float()
        return z.reshape(B, Fn, *z.shape[1:])

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
