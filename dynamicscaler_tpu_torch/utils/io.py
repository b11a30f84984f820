"""Host-side image, video and latent files of the CLI.

Counterpart of the parts of ``dynamicscaler_tpu/utils/io.py`` that
``cli/gen_pano_360.py`` and ``cli/sample.py`` use (reference utils/tensor_utils.py:7-16 for the
image load, utils/loop_merge_utils.py for the mp4 save). PIL and imageio
are optional: each is imported inside the function that uses it, so the
module imports without them, and every writer prints one line naming the
writer it used. These choices concern host files only, never the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def load_image(path: str, height: int, width: int, norm_to_1: bool = True) -> np.ndarray:
    """An image file as float32 [height, width, 3], in [-1, 1] when
    ``norm_to_1``: decoded and resized by PIL with BILINEAR, as the JAX
    package does."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB").resize((width, height), Image.BILINEAR), np.float32)
    if norm_to_1:
        arr = (arr / 255.0 - 0.5) * 2
    return arr


def to_uint8_frames(video: np.ndarray) -> np.ndarray:
    """[F, H, W, 3] float in [-1, 1] -> uint8 (no-op if already uint8)."""
    if video.dtype == np.uint8:
        return video
    v = np.clip(video, -1.0, 1.0)
    return ((v + 1.0) / 2.0 * 255.0).astype(np.uint8)


def to_uint8_device(video: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 on the tensor's own device (a quarter of the bytes
    to read back: a 16-frame 2048x1024 clip is 400 MB in fp32)."""
    v = video.clamp(-1.0, 1.0)
    return ((v + 1.0) / 2.0 * 255.0).to(torch.uint8)


def save_video(video, output_path: str, output_name: str, fps: int = 16) -> str:
    """[F, H, W, 3] frames (uint8, or float in [-1, 1]) -> a video file in
    ``output_path``; returns its path. The first writer that works, as the
    JAX package orders them: ``<name>.mp4`` through imageio; else the MJPEG
    AVI ``<name>.avi`` with lossless PNG frames in ``<name>_frames/``
    (PIL). With neither library it raises an ImportError naming both."""
    os.makedirs(output_path, exist_ok=True)
    frames = to_uint8_frames(np.asarray(video))
    try:
        import imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        path = os.path.join(output_path, f"{output_name}.mp4")
        try:
            imageio.mimsave(path, list(frames), fps=fps)
            print(f"[save_video] {path}: mp4 through imageio", flush=True)
            return path
        except (ValueError, RuntimeError, OSError) as e:  # imageio without an ffmpeg or pyav backend
            print(f"[save_video] no mp4 backend in imageio ({str(e).splitlines()[0]})", flush=True)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"save_video: writing {output_name} needs imageio (with an mp4 backend) or PIL, and "
                          "neither is installed") from e
    from concurrent.futures import ThreadPoolExecutor

    from dynamicscaler_tpu_torch.utils.avi import write_mjpeg_avi

    path = write_mjpeg_avi(os.path.join(output_path, f"{output_name}.avi"), list(frames), fps=fps)
    frames_dir = os.path.join(output_path, f"{output_name}_frames")
    os.makedirs(frames_dir, exist_ok=True)

    def write(i):
        Image.fromarray(frames[i]).save(os.path.join(frames_dir, f"{i:04d}.png"), compress_level=1)

    # PIL releases the GIL while it encodes
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, range(len(frames))))
    print(f"[save_video] {path}: MJPEG AVI and PNG frames in {frames_dir} through PIL", flush=True)
    return path


def save_latent(latent, path: str) -> None:
    """A stage's latent as ``.npy`` (the resume file of the CLI's
    ``--predenoised_*`` flags)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if torch.is_tensor(latent):
        latent = latent.detach().cpu().numpy()
    np.save(path, np.asarray(latent))


def load_latent(path: str) -> np.ndarray:
    return np.load(path)
