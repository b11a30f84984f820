"""Tiled VAE encode and ring-aware (wrap-padded) decode.

Counterpart of ``dynamicscaler_tpu/pipelines/tiled_vae.py``:

* ``tiled_vae_encode``: 4x4 tiles, each grown by a 32-latent overlap
  (clamped to the image), encoded, cropped back to its tile and
  count-averaged (i2v_sphere_panorama_pipeline.py:498-563);
* ``ring_aware_decode``: the latent width is wrap-padded by w / 16 on each
  side so the seam column sees its ring neighbourhood, decoded, cropped
  (:974-991); ``w_tiles > 1`` decodes the ring in tiles, each with its own
  wrap halo.
"""

from __future__ import annotations

import torch

from dynamicscaler_tpu_torch.utils.timing import span


def tiled_vae_encode(model, image, h_tiles: int = 4, w_tiles: int = 4,
                     overlap_latent: int = 32) -> torch.Tensor:
    """[H, W, 3] or [B, H, W, 3] image in [-1, 1] -> [B, 1, H/vs, W/vs, zc]
    fp32 (a one-frame video latent, the posterior mode per tile)."""
    with span("request.static", model.device, tiles=h_tiles * w_tiles):
        return _tiled_encode(model, image, h_tiles, w_tiles, overlap_latent)


def _tiled_encode(model, image, h_tiles, w_tiles, overlap_latent):
    image = torch.as_tensor(image, dtype=torch.float32, device=model.device)
    if image.ndim == 3:
        image = image[None]
    B, H, W, _ = image.shape
    vs = model.config.vae.spatial_scale
    Hl, Wl = H // vs, W // vs
    tile_h_l, tile_w_l = Hl // h_tiles, Wl // w_tiles
    tile_h, tile_w = tile_h_l * vs, tile_w_l * vs
    ov = overlap_latent * vs
    accum = torch.zeros((B, Hl, Wl, model.config.vae.z_channels), device=image.device)
    count = torch.zeros((B, Hl, Wl, 1), device=image.device)
    for i in range(h_tiles):
        for j in range(w_tiles):
            hs, he = i * tile_h, (i + 1) * tile_h
            ws, we = j * tile_w, (j + 1) * tile_w
            hso, heo = max(hs - ov, 0), min(he + ov, H)
            wso, weo = max(ws - ov, 0), min(we + ov, W)
            z = model.encode_video(image[:, None, hso:heo, wso:weo])[:, 0]
            top, left = (hs - hso) // vs, (ws - wso) // vs
            bot, right = z.shape[1] - (heo - he) // vs, z.shape[2] - (weo - we) // vs
            rows = slice(i * tile_h_l, (i + 1) * tile_h_l)
            cols = slice(j * tile_w_l, (j + 1) * tile_w_l)
            accum[:, rows, cols] += z[:, top:bot, left:right]
            count[:, rows, cols] += 1.0
    return (accum / count.clamp(min=1.0))[:, None]


def ring_aware_decode(model, latent: torch.Tensor, halo_chunks: int = 16, frame_chunk: int = 1,
                      w_tiles: int = 1) -> torch.Tensor:
    """[B, F, h, w, zc] W-ring latent -> fp32 [B, F, 8h, 8w, 3], decoded
    ``frame_chunk`` frames at a time with a wrap halo of ``w // halo_chunks``
    latent columns on each side."""
    w = latent.shape[3]
    halo = w // halo_chunks
    vs = model.config.vae.spatial_scale
    if w % w_tiles:
        raise ValueError(f"latent width {w} does not split into {w_tiles} tiles")
    tw = w // w_tiles
    outs = []
    for ti in range(w_tiles):
        cols = (torch.arange(tw + 2 * halo, device=latent.device) + ti * tw - halo) % w
        video = model.decode_video_chunked(latent[:, :, :, cols], frame_chunk=frame_chunk)
        outs.append(video[:, :, :, halo * vs: video.shape[3] - halo * vs])
    return torch.cat(outs, dim=3)
