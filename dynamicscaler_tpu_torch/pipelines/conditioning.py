"""Conditioning: text / image context assembly and the CFG uncond context.

Counterpart of ``dynamicscaler_tpu/pipelines/conditioning.py``
(scripts/evaluation/funcs.py:19-35, utils/multi_prompt_utils.py:1-8). Only
the shipped configs' ``empty_seq`` uncond type is ported.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


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


def build_uncond_context(model, batch: int = 1, with_image: bool = None, image_hw=None):
    """CFG uncond context (``empty_seq``): the embedding of the empty prompt,
    plus, for an i2v bundle, the image tokens of a zero image. The reference
    feeds that zero image at the *latent* resolution (h, w)
    (i2v_sphere_panorama_pipeline.py:111-137); default (40, 64)."""
    if with_image is None:
        with_image = model.image_encoder is not None
    uc_text = model.encode_text([""] * batch)
    if not with_image:
        return uc_text
    h, w = image_hw if image_hw is not None else (40, 64)
    uc_img = model.encode_image_cond(torch.zeros((batch, h, w, 3)))
    return cat_text_image(uc_text, uc_img)


def cat_text_image(text_emb: torch.Tensor, img_emb: torch.Tensor) -> torch.Tensor:
    """i2v context = [text tokens ; image tokens] (split again at the text
    length inside the dual cross-attention)."""
    return torch.cat([text_emb, img_emb.to(text_emb.dtype)], dim=1)
