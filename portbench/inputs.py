"""Everything a run hands the program and the reference alike, made from the
seed: the weights of each component, the tokenizer, the panorama image, the
prompts and every noise draw."""

from __future__ import annotations

import math
import re
import zlib

import numpy as np
import torch

CONTEXT_LENGTH = 77

# state_dict names the published UNet zero-initialises (lvdm/basics.py
# zero_module): they get small random values, as every bias of the UNet, so
# that no output of the comparison is identically zero
UNET_SMALL_SUFFIXES = ("out_layers.3.weight", "temopral_conv.conv4.3.weight", "proj_out.weight", "bias")
UNET_SMALL_NAMES = ("out.2.weight",)
SMALL_STD = 0.02


def derive_seed(*parts) -> int:
    """A 63-bit seed from the run's seed and any names or numbers."""
    words = [p if isinstance(p, int) else zlib.crc32(str(p).encode()) for p in parts]
    return int(np.random.SeedSequence([w % (1 << 63) for w in words]).generate_state(1, np.uint64)[0] >> 1)


def generator(device, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(*parts))


def _std(component: str, name: str, p: torch.Tensor):
    """The standard deviation of a parameter, or a constant (0 or 1) it is
    filled with: N(0, 1/fan_in) weights (lecun normal), norm scales 1;
    the UNet's biases and zero-initialised layers N(0, 0.02^2); elsewhere
    biases 0, the CLIP class token and token embedding N(0, 0.02^2), the
    positional embeddings N(0, 0.01^2), the Resampler queries N(0, 1/dim)."""
    leaf = name.rsplit(".", 1)[-1]
    if component == "unet":
        if name in UNET_SMALL_NAMES or name.endswith(UNET_SMALL_SUFFIXES):
            return SMALL_STD
        if p.ndim == 1:
            return "one"
    else:
        if leaf in ("bias", "in_proj_bias"):
            return "zero"
        if leaf == "class_embedding" or "token_embedding" in name:
            return 0.02
        if leaf == "latents":
            return 1.0 / math.sqrt(p.shape[-1])
        if p.ndim == 1:
            return "one"
        if "positional_embedding" in name:
            return 0.01
    return 1.0 / math.sqrt(math.prod(p.shape[1:]))


@torch.no_grad()
def make_weights(mods: dict, seed: int, dtype, device) -> dict:
    """{component: state_dict} of seeded random weights in ``dtype`` on
    ``device``, for the (meta) reference modules ``mods``: one normal draw
    a component from a generator on the device, cut into the parameters and
    scaled."""
    out = {}
    for comp, mod in mods.items():
        params = list(mod.named_parameters())
        stds = [_std(comp, n, p) for n, p in params]
        total = sum(p.numel() for (_, p), s in zip(params, stds) if not isinstance(s, str))
        draw = torch.randn(total, generator=generator(device, seed, "weights", comp), device=device, dtype=dtype)
        sd, at = {}, 0
        for (name, p), s in zip(params, stds):
            if s == "zero":
                sd[name] = torch.zeros(p.shape, dtype=dtype, device=device)
            elif s == "one":
                sd[name] = torch.ones(p.shape, dtype=dtype, device=device)
            else:
                sd[name] = draw[at:at + p.numel()].view(p.shape).mul_(s)
                at += p.numel()
        out[comp] = sd
    return out


def _clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class HashTokenizer:
    """The benchmark's tokenizer of prompts: words map to ids by CRC-32
    between a start and an end token, zero-padded to 77 (no BPE vocabulary
    is in the repository; random weights need none)."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.sot, self.eot = vocab_size - 2, vocab_size - 1

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            words = [w for w in _clean(text).lower().split(" ") if w]
            ids = [self.sot] + [zlib.crc32(w.encode()) % (self.vocab_size - 2) for w in words][:context_length - 2]
            ids.append(self.eot)
            out[i, :len(ids)] = ids
        return out


def panorama(seed: int, request: int, height: int, width: int, device) -> torch.Tensor:
    """An [height, width, 3] image in [-1, 1]: smooth colour fields at three
    scales, wrapped in longitude, and fine grain."""
    g = generator(device, seed, "panorama", request)
    img = torch.zeros(1, 3, height, width, device=device)
    for cells, amp in ((4, 0.6), (16, 0.3), (64, 0.15)):
        coarse = torch.randn(1, 3, cells, 2 * cells, generator=g, device=device)
        coarse = torch.cat([coarse, coarse[..., :1]], dim=-1)  # the seam matches
        img += amp * torch.nn.functional.interpolate(coarse, size=(height, width + width // (2 * cells)),
                                                     mode="bilinear", align_corners=True)[..., :width]
    img += 0.05 * torch.randn(img.shape, generator=g, device=device)
    return torch.tanh(img[0].permute(1, 2, 0)).contiguous()


class Noise:
    """The sampler's named noise draws of one request: draw ``name`` is the
    same numbers in every call, made on ``device`` from the run's seed."""

    def __init__(self, seed: int, request: int, device):
        self.seed, self.request, self.device = seed, request, device

    def __call__(self, name: str, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=generator(self.device, self.seed, "noise", self.request, name),
                           device=self.device)
