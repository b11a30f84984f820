"""Conditioning: text context and the CFG uncond context.

Counterpart of ``dynamicscaler_tpu/pipelines/conditioning.py``
(scripts/evaluation/funcs.py:19-35). The image half of the i2v uncond
context comes with the i2v slice.
"""

from __future__ import annotations

from typing import Sequence

import torch


def encode_texts_cached(model, texts: Sequence[str], cache: dict):
    """Batch-encode the unique uncached prompts once; return [len(texts), 77, D]."""
    missing = [t for t in dict.fromkeys(texts) if t not in cache]
    if missing:
        embs = model.encode_text(list(missing))
        for i, t in enumerate(missing):
            cache[t] = embs[i]
    return torch.stack([cache[t] for t in texts])


def build_uncond_context(model, batch: int = 1, with_image: bool = None):
    """CFG uncond context of the shipped configs (``empty_seq``): the
    embedding of the empty prompt."""
    if with_image is None:
        with_image = model.image_encoder is not None
    if with_image:
        raise NotImplementedError("image-conditioned uncond context: the i2v bundle is not ported yet")
    return model.encode_text([""] * batch)
