"""Dependency-free MJPEG-AVI video writer and reader.

Counterpart of ``dynamicscaler_tpu/utils/avi.py``, the same container
byte for byte. The reference writes mp4 through imageio-ffmpeg
(utils/loop_merge_utils.py:35); where no ffmpeg or pyav backend is
installed, MJPEG inside a RIFF AVI container needs only a JPEG encoder
(PIL) and struct packing. Every mainstream player decodes it and each frame
is a full-quality JPEG. PIL is imported only by the JPEG encode and the
reader.

Container layout (msdn AVI RIFF spec):

    RIFF('AVI '
      LIST('hdrl' avih LIST('strl' strh strf))
      LIST('movi' '00dc' <jpeg> ...)
      'idx1' <index entries>)
"""

from __future__ import annotations

import io
import struct
from typing import Sequence

import numpy as np

AVIF_HASINDEX = 0x00000010
AVIIF_KEYFRAME = 0x00000010


def _jpeg(frame: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_mjpeg_avi(
    path: str,
    frames: Sequence[np.ndarray],
    fps: int = 8,
    quality: int = 92,
) -> str:
    """Write uint8 RGB frames ``[H, W, 3]`` as an MJPEG AVI. Returns path."""
    frames = [np.ascontiguousarray(f) for f in frames]
    assert frames, "no frames"
    h, w = frames[0].shape[:2]
    assert all(f.shape[:2] == (h, w) for f in frames), "inconsistent frame sizes"
    assert frames[0].dtype == np.uint8, frames[0].dtype

    # PIL's JPEG encoder releases the GIL; pool the per-frame encodes
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=8) as pool:
        jpegs = list(pool.map(lambda f: _jpeg(f, quality), frames))
    max_size = max(len(j) for j in jpegs)

    avih = _chunk(
        b"avih",
        struct.pack(
            "<14I",
            int(1e6 / fps),  # dwMicroSecPerFrame
            max_size * fps,  # dwMaxBytesPerSec
            0,  # dwPaddingGranularity
            AVIF_HASINDEX,  # dwFlags
            len(jpegs),  # dwTotalFrames
            0,  # dwInitialFrames
            1,  # dwStreams
            max_size,  # dwSuggestedBufferSize
            w,
            h,
            0, 0, 0, 0,  # dwReserved
        ),
    )
    strh = _chunk(
        b"strh",
        b"vids"
        + b"MJPG"
        + struct.pack(
            "<10I4H",
            0,  # dwFlags
            0,  # wPriority + wLanguage (packed as one dword here)
            0,  # dwInitialFrames
            1,  # dwScale
            fps,  # dwRate
            0,  # dwStart
            len(jpegs),  # dwLength
            max_size,  # dwSuggestedBufferSize
            0xFFFFFFFF,  # dwQuality (-1: default)
            0,  # dwSampleSize
            0, 0, w, h,  # rcFrame
        ),
    )
    strf = _chunk(
        b"strf",
        struct.pack(
            "<I2i2H2I2i2I",
            40,  # biSize
            w,
            h,
            1,  # biPlanes
            24,  # biBitCount
            struct.unpack("<I", b"MJPG")[0],  # biCompression
            w * h * 3,  # biSizeImage
            0, 0, 0, 0,
        ),
    )
    hdrl = _list(b"hdrl", avih + _list(b"strl", strh + strf))

    movi_chunks = []
    index = []
    offset = 4  # relative to the start of the 'movi' fourcc
    for j in jpegs:
        c = _chunk(b"00dc", j)
        movi_chunks.append(c)
        index.append(struct.pack("<4s3I", b"00dc", AVIIF_KEYFRAME, offset, len(j)))
        offset += len(c)
    movi = _list(b"movi", b"".join(movi_chunks))
    idx1 = _chunk(b"idx1", b"".join(index))

    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def read_mjpeg_avi(path: str):
    """Decode an MJPEG AVI into (frames ``[F, H, W, 3]`` uint8, fps).

    The read half of :func:`write_mjpeg_avi`: a RIFF chunk walk (not tied
    to this writer's exact layout) collecting ``..dc``/``..db`` stream
    chunks and decoding each JPEG with PIL; no ffmpeg or pyav needed."""
    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI ", "not an AVI"
    (riff_size,) = struct.unpack("<I", data[4:8])

    jpegs = []

    def walk(pos: int, end: int):
        while pos + 8 <= end:
            fourcc = data[pos : pos + 4]
            (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
            payload = pos + 8
            if fourcc == b"LIST":
                walk(payload + 4, payload + size)
            elif fourcc[2:4] in (b"dc", b"db"):
                jpegs.append(data[payload : payload + size])
            pos = payload + size + (size & 1)

    walk(12, 8 + riff_size)
    assert jpegs, "no video stream chunks found"
    frames = np.stack(
        [np.asarray(Image.open(io.BytesIO(j)).convert("RGB")) for j in jpegs]
    )
    info = read_avi_info(path)
    return frames, info["fps"]


def read_avi_info(path: str) -> dict:
    """Minimal RIFF walk for tests/inspection: frame count, size, fps."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI ", "not an AVI"
    # avih payload sits at a fixed offset given our writer's layout; find it
    # robustly by scanning for the chunk id instead
    i = data.index(b"avih")
    us_per_frame, _, _, flags, total = struct.unpack("<5I", data[i + 8 : i + 28])
    # avih fields after dwTotalFrames: dwInitialFrames, dwStreams,
    # dwSuggestedBufferSize, dwWidth, dwHeight
    _, _, _, w, h = struct.unpack("<5I", data[i + 28 : i + 48])
    j = data.rindex(b"idx1")
    (idx_size,) = struct.unpack("<I", data[j + 4 : j + 8])
    return {
        "frames": total,
        "fps": round(1e6 / us_per_frame),
        "width": w,
        "height": h,
        "has_index": bool(flags & AVIF_HASINDEX),
        "index_entries": idx_size // 16,
    }
