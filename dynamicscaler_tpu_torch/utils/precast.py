"""Pre-encoded latents: image files -> video latent tensors.

Counterpart of ``dynamicscaler_tpu/utils/precast.py`` (reference
utils/precast_latent_utils.py:13-65): one image's latent, a folder's images
sorted by their trailing window index, and a list of images stacked along
the frame axis, encoded through the bundle's VAE in one call.
"""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np
import torch

from dynamicscaler_tpu_torch.utils.io import load_image


def get_img_list_from_folder(folder: str, exts=(".png", ".jpg", ".jpeg")) -> List[str]:
    """Image paths sorted by the trailing ``_N`` window index of the name
    (precast_latent_utils.py:13-21, 42-46)."""

    def sort_key(name):
        m = re.search(r"(\d+)(?=\.\w+$)", name)
        return int(m.group(1)) if m else 0

    return [os.path.join(folder, f) for f in sorted(os.listdir(folder), key=sort_key) if f.lower().endswith(exts)]


def encode_image_to_latent(model, image_path: str, height: int, width: int) -> torch.Tensor:
    """One image -> its scaled latent [1, 1, h, w, zc] (precast:34-40)."""
    img = torch.from_numpy(load_image(image_path, height, width))
    return model.encode_video(img[None, None].to(model.device))


def encode_images_list_to_latent_tensor(model, image_paths: List[str], height: int, width: int) -> torch.Tensor:
    """Images -> their frame-stacked latent [1, N, h, w, zc], the VAE run
    once over all of them (precast:48-65 loops an image at a time)."""
    imgs = np.stack([load_image(p, height, width) for p in image_paths])
    return model.encode_video(torch.from_numpy(imgs)[None].to(model.device)) if imgs.ndim == 4 else None


def encode_folder_to_latent_tensor(model, folder: str, height: int, width: int) -> torch.Tensor:
    return encode_images_list_to_latent_tensor(model, get_img_list_from_folder(folder), height, width)
