"""The PyTorch port's host video I/O (``utils/io.py``) against the JAX
package's, on the CPU.

* ``load_first_frame``: a PNG equal to ``load_image``'s and to JAX's; an
  MJPEG AVI's first frame equal to JAX's (the native decode); a stub
  ``.mp4`` refused with the error naming imageio and its backend.
* ``load_video_batch`` equal to JAX's at stride 1 and 2, with
  ``video_frames=-1`` and on a clip too short (the last frame repeated),
  with the fps lists.
* ``save_video(save_gif=True)``: the GIF's frame count, width capped at
  ``gif_max_width``, frame duration and loop, byte-equal to JAX's GIF; the
  returned path (the video file's, else the GIF's).
"""

import os

import numpy as np
import pytest
from PIL import Image

from dynamicscaler_tpu.utils import io as jio
from dynamicscaler_tpu_torch.utils import io
from dynamicscaler_tpu_torch.utils.avi import write_mjpeg_avi


def _frames(n, h=48, w=64, seed=0):
    """Smooth seeded uint8 frames that differ from each other (JPEG keeps
    them distinct)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    out = []
    for i in range(n):
        ph = rng.uniform(0, 6, 3)
        img = np.stack([np.sin(6 * xx + 3 * yy + p + i) for p in ph], -1)
        out.append(((img + 1) * 127.5).astype(np.uint8))
    return np.stack(out)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 7-frame MJPEG AVI at 8 fps."""
    path = str(tmp_path_factory.mktemp("clip") / "clip.avi")
    write_mjpeg_avi(path, list(_frames(7)), fps=8, quality=95)
    return path


def test_load_first_frame_image(tmp_path):
    p = str(tmp_path / "c.png")
    Image.fromarray(_frames(1, 20, 30)[0]).save(p)
    got = io.load_first_frame(p, 16, 24)
    np.testing.assert_array_equal(got, io.load_image(p, 16, 24))
    np.testing.assert_array_equal(got, jio.load_first_frame(p, 16, 24))


def test_load_first_frame_avi_matches_jax(clip):
    got = io.load_first_frame(clip, 24, 40)
    assert got.shape == (24, 40, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.load_first_frame(clip, 24, 40))
    # the first frame, not another
    first = (np.asarray(Image.fromarray(_frames(7)[0]).resize((40, 24), Image.BILINEAR), np.float32) / 255 - 0.5) * 2
    assert np.abs(got - first).mean() < 0.05


def test_load_first_frame_stub_mp4_names_the_backend(tmp_path):
    v = tmp_path / "c.mp4"
    v.write_bytes(b"\x00\x00\x00\x18ftypmp42")  # a container header and nothing else
    with pytest.raises(RuntimeError, match="imageio") as e:
        io.load_first_frame(str(v), 8, 8)
    assert "backend" in str(e.value)


@pytest.mark.parametrize("stride,size,frames", [(1, (48, 64), 4), (2, (24, 32), 3), (3, (48, 64), -1),
                                                (2, (48, 64), 6)])
def test_load_video_batch_matches_jax(clip, stride, size, frames):
    """Stride 1 and 2; ``video_frames=-1`` (every frame, stride 1 whatever
    was passed); 6 frames at stride 2 of 7 (4 valid, the last repeated)."""
    got, fps = io.load_video_batch([clip, clip], frame_stride=stride, video_size=size, video_frames=frames)
    want, jfps = jio.load_video_batch([clip, clip], frame_stride=stride, video_size=size, video_frames=frames)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert fps == jfps == [8 // (1 if frames < 0 else stride)] * 2
    n = 7 if frames < 0 else frames
    assert got.shape == (2, n) + size + (3,)
    if (stride, frames) == (2, 6):
        np.testing.assert_array_equal(got[0, 4], got[0, 3])
        np.testing.assert_array_equal(got[0, 5], got[0, 3])


def test_save_video_gif(tmp_path):
    video = (_frames(5, 24, 80, seed=3).astype(np.float32) / 127.5) - 1.0
    path = io.save_video(video, str(tmp_path / "port"), "clip", fps=8, save_mp4=False, save_gif=True,
                         gif_max_width=64)
    assert path == str(tmp_path / "port" / "clip.gif")
    jpath = jio.save_video(video, str(tmp_path / "jax"), "clip", fps=8, save_mp4=False, save_gif=True,
                           gif_max_width=64)
    with Image.open(path) as im:
        assert (im.n_frames, im.size) == (5, (64, 19))
        # int(1000 / fps) ms a frame, which a GIF stores in hundredths of a second
        assert im.info["duration"] == int(1000 / 8) // 10 * 10 and im.info["loop"] == 0
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    # a narrow clip keeps its width; with the video file the path is the video's
    out = io.save_video(video[:, :, :40], str(tmp_path / "both"), "clip", fps=6, save_gif=True)
    assert out == str(tmp_path / "both" / "clip.avi")  # no mp4 backend here: the AVI + PNG writer
    with Image.open(tmp_path / "both" / "clip.gif") as im:
        assert (im.n_frames, im.size) == (5, (40, 24))
    assert io.save_video(video, str(tmp_path / "none"), "clip", save_mp4=False) is None
