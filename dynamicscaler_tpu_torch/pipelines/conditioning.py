"""Conditioning: text / image context assembly and the CFG uncond context.

Counterpart of ``dynamicscaler_tpu/pipelines/conditioning.py``
(scripts/evaluation/funcs.py:19-35, utils/multi_prompt_utils.py:1-8), with
both uncond types: ``empty_seq`` (the shipped configs', the default) and
``zero_embed``.
"""

from __future__ import annotations

import warnings
from typing import Dict, Sequence

import torch

from dynamicscaler_tpu_torch.utils.timing import span


def select_prompt_by_factor(prompt_dict: Dict[float, str], factor: float) -> str:
    """The prompt of the smallest sorted key >= ``factor`` (else the last)."""
    if not 0.0 <= factor <= 1.0:
        raise ValueError(f"select_prompt factor {factor} not legal")
    keys = sorted(prompt_dict)
    return prompt_dict[next((k for k in keys if factor <= k), keys[-1])]


def encode_texts_cached(model, texts: Sequence[str], cache: dict):
    """Batch-encode the unique uncached prompts once; return [len(texts), 77, D]."""
    missing = [t for t in dict.fromkeys(texts) if t not in cache]
    if missing:
        embs = model.encode_text(list(missing))
        for i, t in enumerate(missing):
            cache[t] = embs[i]
    return torch.stack([cache[t] for t in texts])


def build_uncond_context(model, batch: int = 1, with_image: bool = None, image_hw=None,
                         uncond_type: str = "empty_seq", cond_like: torch.Tensor = None):
    """CFG uncond context: a text part, plus, for an i2v bundle, the image
    tokens of a zero image. The reference feeds that zero image at the
    *latent* resolution (h, w) (i2v_sphere_panorama_pipeline.py:111-137);
    default (40, 64). The text part is, by ``uncond_type``:

    * ``empty_seq`` (both shipped configs, ddpm3d.py:338): the embedding of
      the empty prompt;
    * ``zero_embed``: zeros shaped like the text part of the cond context
      ``cond_like`` [B, L, D] (its first ``text_context_len`` tokens). The
      reference zeroes the whole image+text context and appends the
      zero-image tokens after it (funcs.py:24-34), 16 tokens more than the
      cond context; this zeroes the text part only, as the JAX package
      does, so the CFG pair stays one batch, and warns on an
      image-conditioned bundle."""
    if with_image is None:
        with_image = model.image_encoder is not None
    if uncond_type == "zero_embed":
        if with_image:
            warnings.warn(
                "zero_embed uncond on an image-conditioned model: this zeroes only the text part and keeps the "
                "CFG pair batchable; the reference (funcs.py:24-34) zeroes the full cond embedding and appends "
                "zero-image tokens (uncond gets 16 extra tokens). Both shipped configs use empty_seq: verify "
                "parity before using zero_embed with real image-conditioned weights.",
                stacklevel=2,
            )
        if cond_like is None:
            raise ValueError("zero_embed needs the cond context (cond_like) for its shape")
        text_len = model.config.unet.text_context_len
        uc_text = torch.zeros((batch, min(text_len, cond_like.shape[1]), *cond_like.shape[2:]),
                              dtype=cond_like.dtype, device=cond_like.device)
    elif uncond_type == "empty_seq":
        with span("request.text", prompts=batch):
            uc_text = model.encode_text([""] * batch)
    else:
        raise ValueError(f"uncond_type {uncond_type!r}: empty_seq or zero_embed")
    if not with_image:
        return uc_text
    h, w = image_hw if image_hw is not None else (40, 64)
    with span("request.image", crops=batch, tokens=batch * model.config.resampler.tokens):
        uc_img = model.encode_image_cond(torch.zeros((batch, h, w, 3)))
    return cat_text_image(uc_text, uc_img)


def cat_text_image(text_emb: torch.Tensor, img_emb: torch.Tensor) -> torch.Tensor:
    """i2v context = [text tokens ; image tokens] (split again at the text
    length inside the dual cross-attention)."""
    return torch.cat([text_emb, img_emb.to(text_emb.dtype)], dim=1)
