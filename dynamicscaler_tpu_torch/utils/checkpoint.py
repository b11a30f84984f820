"""A cache of the converted checkpoint next to the checkpoint file.

Counterpart of ``dynamicscaler_tpu/utils/checkpoint.py`` (``save_params``,
``load_params``, ``load_or_convert``). The JAX package caches its converted
parameter tree with orbax; here the cache holds
``load_videocrafter_checkpoint``'s ``{component: state_dict}`` in one file
written by ``torch.save`` and read by ``torch.load(weights_only=True)``:
tensors only, unlike the Lightning pickle of the checkpoint itself, so a
later launch skips both the unpickling of the whole file and the split by
component. Stage latents are ``.npy`` files (``utils/io.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from dynamicscaler_tpu_torch.utils import weights

# the cache's name beside the checkpoint: <ckpt_path><CACHE_SUFFIX>
CACHE_SUFFIX = ".torch_state_dicts.pt"


def save_params(state_dicts: Dict[str, Dict[str, torch.Tensor]], path: str) -> None:
    """Write ``{component: state_dict}`` to ``path`` (through a temporary
    file in the same directory, renamed when whole)."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save({c: dict(sd) for c, sd in state_dicts.items()}, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_params(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """Read a cache written by :func:`save_params` (tensors only), on the CPU."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def load_or_convert(ckpt_path: str, config, cache_path: Optional[str] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """``load_videocrafter_checkpoint(ckpt_path, config)``'s state dicts:
    from the cache ``cache_path`` (default ``ckpt_path + CACHE_SUFFIX``)
    when it exists, else from the checkpoint, then written to the cache.
    A failed cache write is not fatal: one line is printed and the state
    dicts are returned uncached."""
    cache = cache_path or ckpt_path + CACHE_SUFFIX
    if os.path.isfile(cache):
        return load_params(cache)
    state_dicts = weights.load_videocrafter_checkpoint(ckpt_path, config)
    try:
        save_params(state_dicts, cache)
    except Exception as e:  # a cache failure is not fatal
        print(f"[checkpoint] cache write failed ({e}); continuing uncached", flush=True)
    return state_dicts
