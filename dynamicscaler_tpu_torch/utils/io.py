"""Host-side image, video and latent files of the CLI.

Counterpart of ``dynamicscaler_tpu/utils/io.py`` less its device-side
JAX helpers (reference utils/tensor_utils.py:7-16 for the image load,
scripts/evaluation/funcs.py:118-167 for the video loads,
utils/loop_merge_utils.py for the mp4 save). PIL and imageio
are optional: each is imported inside the function that uses it, so the
module imports without them, and every writer prints one line naming the
writer it used. These choices concern host files only, never the device.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

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


def _resized(frame: np.ndarray, height: int, width: int) -> np.ndarray:
    """A uint8 RGB frame resized by PIL with BILINEAR, as float32 in [-1, 1]."""
    from PIL import Image

    img = Image.fromarray(frame).convert("RGB").resize((width, height), Image.BILINEAR)
    return (np.asarray(img, np.float32) / 255.0 - 0.5) * 2


def load_first_frame(path: str, height: int, width: int) -> np.ndarray:
    """The first frame of a video file, or an image, as float32 [height,
    width, 3] in [-1, 1] (the reference's decord branch of
    ``load_image_batch``, scripts/evaluation/funcs.py:156-167). An image
    goes through :func:`load_image`; an MJPEG AVI decodes natively
    (``utils/avi.read_mjpeg_avi``); any other container, or an AVI that
    does not decode so, through imageio, which needs an ffmpeg or pyav
    backend: without one it raises a RuntimeError naming it."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".mp4", ".avi", ".mov", ".webm", ".mkv"):
        return load_image(path, height, width)
    if ext == ".avi":
        try:
            from dynamicscaler_tpu_torch.utils.avi import read_mjpeg_avi

            return _resized(read_mjpeg_avi(path)[0][0], height, width)
        except Exception:
            pass  # not an MJPEG AVI: imageio's turn
    try:
        import imageio.v3 as iio

        frame = iio.imread(path, index=0)
    except Exception as e:
        raise RuntimeError(f"reading video conditioning {path!r} requires an imageio video backend (ffmpeg or "
                           f"pyav), unavailable here: {e}") from e
    return _resized(np.asarray(frame), height, width)


def _read_video_frames(path: str):
    """Every frame of a video file as (uint8 [T, H, W, 3], fps): an MJPEG
    AVI natively, any other container (or an AVI that does not decode so)
    through imageio, which needs an ffmpeg or pyav backend."""
    if os.path.splitext(path)[1].lower() == ".avi":
        try:
            from dynamicscaler_tpu_torch.utils.avi import read_mjpeg_avi

            return read_mjpeg_avi(path)
        except Exception:
            pass  # not an MJPEG AVI: imageio's turn
    try:
        import imageio.v3 as iio

        frames = np.asarray(iio.imread(path))
        fps = float(iio.immeta(path).get("fps", 8))
    except Exception as e:
        raise RuntimeError(f"reading video {path!r} requires an imageio video backend (ffmpeg or pyav), "
                           f"unavailable here: {e}") from e
    return frames, fps


def load_video_batch(filepath_list, frame_stride: int, video_size=(256, 256), video_frames: int = 16):
    """Clips of ``video_frames`` frames, every ``frame_stride``-th (the
    reference's ``load_video_batch``, scripts/evaluation/funcs.py:118-155):
    ``video_frames=-1`` takes every frame at stride 1; a clip too short is
    padded by repeating its last frame; frames resized to ``video_size``
    (h, w) with BILINEAR. Returns ``(float32 [B, F, h, w, 3] in [-1, 1],
    [int(fps / stride) per video])``."""
    assert frame_stride > 0, "valid frame stride should be a positive integer"
    batch, fps_list = [], []
    h, w = video_size
    for path in filepath_list:
        frames, fps = _read_video_frames(path)
        total = frames.shape[0]
        fs, required = (1, total) if video_frames < 0 else (frame_stride, video_frames)
        take = min(required, (total - 1) // fs + 1)
        clip = np.stack([_resized(frames[fs * i], h, w) for i in range(take)])
        if take < required:  # repeat the last frame (funcs.py:146-149)
            clip = np.concatenate([clip, np.repeat(clip[-1:], required - take, axis=0)])
        batch.append(clip)
        fps_list.append(int(fps / fs))
    return np.stack(batch), fps_list


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


def save_video(video, output_path: str, output_name: str, fps: int = 16, save_mp4: bool = True,
               save_gif: bool = False, gif_max_width: int = 1024) -> Optional[str]:
    """[F, H, W, 3] frames (uint8, or float in [-1, 1]) -> files in
    ``output_path``. With ``save_mp4`` a video file, the first writer that
    works, as the JAX package orders them: ``<name>.mp4`` through imageio;
    else the MJPEG AVI ``<name>.avi`` with lossless PNG frames in
    ``<name>_frames/`` (PIL); with neither library it raises an ImportError
    naming both. With ``save_gif`` also ``<name>.gif`` (PIL): frames wider
    than ``gif_max_width`` scaled down, each quantized with FASTOCTREE on a
    thread pool, ``int(1000 / fps)`` ms a frame, looping. Returns the video
    file's path, else the GIF's, else None."""
    os.makedirs(output_path, exist_ok=True)
    frames = to_uint8_frames(np.asarray(video))
    saved = _write_video(frames, output_path, output_name, fps) if save_mp4 else None
    if save_gif:
        gif = _write_gif(frames, os.path.join(output_path, f"{output_name}.gif"), fps, gif_max_width)
        saved = saved or gif
    return saved


def _write_video(frames: np.ndarray, output_path: str, output_name: str, fps: int) -> str:
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


def _write_gif(frames: np.ndarray, path: str, fps: int, max_width: int) -> str:
    from PIL import Image

    def prep(frame):
        im = Image.fromarray(frame)
        if im.width > max_width:
            im = im.resize((max_width, int(im.height * max_width / im.width)), Image.BILINEAR)
        # FASTOCTREE is linear in the pixels; MEDIANCUT histograms every colour
        return im.quantize(colors=256, method=Image.FASTOCTREE)

    with ThreadPoolExecutor(max_workers=8) as pool:
        gif = list(pool.map(prep, frames))
    gif[0].save(path, save_all=True, append_images=gif[1:], duration=int(1000.0 / fps), loop=0)
    print(f"[save_video] {path}: GIF through PIL", flush=True)
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
