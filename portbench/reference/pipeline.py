"""Plain reference of the samplers' arithmetic: the DDIM tables and update,
the sphere view maps and the planar ring windows, the within-step blends,
the tiled VAE encode, the CFG conditioning and one DDIM step of each
sampler.

The benchmark's frozen reference: it follows the published DynamicScaler
pipelines (i2v_sphere_panorama_pipeline.py, t2v_normal_pipeline.py,
utils/panorama_tensor_utils.py, utils/shift_window_utils.py,
lvdm/models/utils_diffusion.py) and imports nothing of the program under
test. The step functions take a step's state as the program held it (the
latent, the denoised buffer, the clean static latent) and the noise the
benchmark drew, and return the reference's next state; the UNet's eps come
from a callable, so a check can hand in the program's eps rows or the
reference's own.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import nets

# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------


class Schedule:
    """Linear-beta DDPM tables and a uniform DDIM sub-schedule, eta 0
    (float64 on the host, float32 on ``device``)."""

    def __init__(self, steps: int, diffusion: dict, device):
        T = diffusion["timesteps"]
        betas = np.linspace(diffusion["linear_start"] ** 0.5, diffusion["linear_end"] ** 0.5, T,
                            dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        ts = np.linspace(0, T - 1, steps).round().astype(np.int64)
        self.steps = steps
        self.timesteps = ts
        self.acp = torch.as_tensor(acp.astype(np.float32), device=device)
        a = acp[ts]
        a_prev = np.asarray([acp[0]] + acp[ts[:-1]].tolist())
        self.alphas = torch.as_tensor(a.astype(np.float32), device=device)
        self.alphas_prev = torch.as_tensor(a_prev.astype(np.float32), device=device)
        self.sqrt_one_minus = torch.as_tensor(np.sqrt(1.0 - a).astype(np.float32), device=device)

    def ddim(self, x, eps, index: int):
        """(x_prev, pred_x0) of one eta-0 DDIM update at table ``index``."""
        pred_x0 = (x - self.sqrt_one_minus[index] * eps) / torch.sqrt(self.alphas[index])
        a_prev = self.alphas_prev[index]
        return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * eps, pred_x0

    def re_noise(self, x, step_a: int, step_b: int, noise):
        """q(x_b | x_a) between two DDIM table indices."""
        ratio = torch.clamp(self.acp[int(self.timesteps[step_b])] / self.acp[int(self.timesteps[step_a])], 0.0, 1.0)
        return torch.sqrt(ratio) * x + torch.sqrt(1.0 - ratio) * noise


def mix_with_mask(a, b, mask, ratio: float):
    """Outside ``mask`` a; inside (1 - ratio) a + ratio b."""
    return a * (1.0 - mask) + (a * (1.0 - ratio) + b * ratio) * mask


def cfg_eps(eps_rows, n: int, guidance: float):
    """CFG over rows packed [cond (n) ; uncond (n)]."""
    return eps_rows[n:] + guidance * (eps_rows[:n] - eps_rows[n:])


# ---------------------------------------------------------------------------
# sphere geometry (panorama_tensor_utils.py:154-245)
# ---------------------------------------------------------------------------


def uv_grid(fov, theta, phi, vw, vh, ph, pw):
    """Pano pixel coordinates (u, v) [vh, vw] float32 of a pinhole view."""
    f32 = np.float32
    fov_r, th_r, ph_r = (np.deg2rad(np.asarray(a, dtype=f32)) for a in (fov, theta, phi))
    f = 0.5 * vw / np.tan(fov_r / 2)
    x = np.linspace(-vw / 2, vw / 2 - 1, vw, dtype=f32)
    y = np.linspace(-vh / 2, vh / 2 - 1, vh, dtype=f32)
    yv, xv = np.meshgrid(y, x, indexing="ij")
    xyz = np.stack([xv, yv, np.full_like(xv, f)], axis=-1)
    xyz = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    cp, sp, ct, st = np.cos(ph_r), np.sin(ph_r), np.cos(th_r), np.sin(th_r)
    rot = (np.array([[ct, 0, st], [0, 1, 0], [-st, 0, ct]], dtype=f32)
           @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], dtype=f32)).astype(f32)
    r = (xyz.reshape(-1, 3) @ rot.T).reshape(vh, vw, 3)
    lon = (np.arctan2(r[..., 0], r[..., 2]) + 2 * np.pi) % (2 * np.pi)
    lat = np.arcsin(np.clip(r[..., 1], -1.0, 1.0))
    return (lon / (2 * np.pi) * (pw - 1)).astype(f32), ((lat + np.pi / 2) / np.pi * (ph - 1)).astype(f32)


def view_maps(fov, theta, phi, vh, vw, ph, pw):
    """(gather [vh*vw] long, valid [vh*vw] bool, scatter [vh*vw] long with
    ph*pw marking a dropped pixel) of one view: nearest floor sampling,
    longitude wrapped and latitude clamped on the gather."""
    u, v = uv_grid(fov, theta, phi, vw, vh, ph, pw)
    u0, v0 = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    gather = np.clip(v0, 0, ph - 1) * pw + u0 % pw
    valid = (u >= 0) & (u < pw) & (v >= 0) & (v < ph)
    scatter = np.where(valid & (u0 >= 0) & (u0 < pw) & (v0 >= 0) & (v0 < ph), v0 * pw + u0, ph * pw)
    return gather.reshape(-1), valid.reshape(-1), scatter.reshape(-1)


def phase_views(phi_theta: Dict[float, Sequence[float]], step: int, loop_step_theta: int, fov: float):
    """(phi, theta) of every view at a step: the thetas turn by
    fov // loop_step_theta degrees a step."""
    off = (step % loop_step_theta) * (fov // loop_step_theta)
    return [(phi, th + off) for phi, ths in phi_theta.items() for th in ths]


def frame_origins(step, total_f, frames, overlap, loop_step_frame, dock):
    """Frame-window origins of a step (i2v_sphere_panorama_pipeline.py:256-318)."""
    if total_f == frames:
        return [0]
    n = math.ceil((total_f // frames - 1) / (1 - overlap)) + 1
    begin = (step % loop_step_frame) * max(int(overlap * frames / loop_step_frame), 1)
    stride = int(frames * (1 - overlap))
    out = []
    for idx in (["start", *range(n), "end"] if dock else list(range(n))):
        if idx in ("start", "end"):
            if begin == 0:
                continue
            f0 = 0 if idx == "start" else total_f - frames
        else:
            f0 = (begin + idx * stride) % total_f
        if dock and f0 + frames > total_f:
            continue
        out.append(f0)
    return out


# ---------------------------------------------------------------------------
# one sphere step (i2v_sphere_panorama_pipeline.py:279-471, overlap "last")
# ---------------------------------------------------------------------------


def sphere_step(sched: Schedule, state: dict, noise: Callable, eps_fn: Callable, p: dict, step: int,
                index: int, last: bool, round_state=lambda t: t):
    """The reference's DDIM step of the sphere sampler from ``state``
    ({"latent" [1, F, EH, EW, C], "denoised", "static" [1, 1, EH, EW, C]}).
    ``eps_fn(x_rows, ctx_ids)`` gives the UNet eps of the CFG-packed rows
    (views in pair order; ids index the views). Returns (latent, denoised,
    x_rows): the new state and the UNet's input rows."""
    lat = state["latent"]
    _, Fn, EH, EW, C = lat.shape
    frames = p["frames"]
    vh, vw = p["height"] // p["vs"], p["width"] // p["vs"]
    views = phase_views(p["phi_theta"], step, p["loop_step_theta"], p["view_fov"])
    maps = [view_maps(p["view_fov"], th, phi, vh, vw, EH, EW) for phi, th in views]
    origins = frame_origins(step, p["total_f"], frames, p["overlap_f"][step], p["loop_step_frame"], p["dock_at_f"])
    pairs = [(f0, v) for f0 in origins for v in range(len(views))]
    dev = lat.device
    flat = lat[0].reshape(Fn, EH * EW, C)
    cov = torch.zeros(Fn, EH * EW, device=dev)
    wins, masks = [], []
    for f0, v in pairs:
        g, valid, s = (torch.as_tensor(a, device=dev) for a in maps[v])
        fi = (f0 + torch.arange(frames, device=dev)) % Fn
        wins.append(flat[fi][:, g] * valid.float()[None, :, None])
        masks.append(cov[fi][:, g] * valid.float()[None, :])
        keep = s[s < EH * EW]
        cov[fi[:, None], keep[None, :]] = 1.0
    n = len(pairs)
    wins = torch.stack(wins).reshape(n, frames, vh, vw, C)
    masks = torch.stack(masks).reshape(n, frames, vh, vw, 1)
    prev = wins
    renoise = 0.0 if last else p["renoise_ratio"]
    if renoise:
        noised = sched.re_noise(wins, max(index - 1, 0), index, noise(f"renoise:{step}", wins.shape))
        wins = mix_with_mask(wins, noised, masks, renoise)
    x_rows = torch.cat([wins, wins])
    eps = cfg_eps(eps_fn(x_rows, [v for _, v in pairs]), n, p["guidance"])
    new, den = sched.ddim(wins, eps, index)
    merge = 0.0 if last else p["merge_prev"][step]
    new = round_state(mix_with_mask(new, prev, masks, merge))
    den = round_state(den)
    if p["paste_on_static"] and not last:
        clean = state["static"].expand(1, Fn, EH, EW, C)
        target = sched.re_noise(clean, 0, index, noise(f"static:{step}", clean.shape))
    else:
        target = lat.clone()
    denoised = state["denoised"].clone()
    tflat, dflat = target.view(1, Fn * EH * EW, C), denoised.view(1, Fn * EH * EW, C)
    for k, (f0, v) in enumerate(pairs):  # pair order; of duplicate targets the last view pixel wins
        s = maps[v][2]
        tgt, first_from_end = np.unique(s[::-1], return_index=True)
        src = s.size - 1 - first_from_end
        ok = tgt < EH * EW
        src, tgt = (torch.as_tensor(a[ok], device=dev) for a in (src, tgt))
        fi = (f0 + torch.arange(frames, device=dev)) % Fn
        idx = (fi[:, None] * (EH * EW) + tgt[None, :]).reshape(-1)
        tflat[0, idx] = new[k].reshape(frames, vh * vw, C)[:, src].reshape(-1, C)
        dflat[0, idx] = den[k].reshape(frames, vh * vw, C)[:, src].reshape(-1, C)
    return round_state(target), round_state(denoised), x_rows


def sphere_contexts(p: dict, step: int):
    """(prompt, (fov, theta, phi)) of every view of a step's phase."""
    views = phase_views(p["phi_theta"], step, p["loop_step_theta"], p["view_fov"])
    return [(p["phi_prompt"].get(phi, p["prompt"]), (p["view_fov"], th, phi)) for phi, th in views]


def view_crops(image, specs, h, w):
    """Nearest perspective crops [n, h, w, 3] of an [EH, EW, 3] panorama."""
    EH, EW = image.shape[:2]
    flat = image.reshape(-1, 3)
    out = []
    for fov, th, phi in specs:
        g, valid, _ = (torch.as_tensor(a, device=image.device) for a in view_maps(fov, th, phi, h, w, EH, EW))
        out.append((flat[g] * valid.float()[:, None]).reshape(h, w, 3))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# one planar ring step (t2v_normal_pipeline.py:214-570, overlap "last")
# ---------------------------------------------------------------------------


def grid_origins(step: int, p: dict):
    """(f0, h0, w0) of every window at a step: integer grid, the offsets of
    each axis (step % loop_step) * (window // loop_step), f outer, then w,
    then h."""
    win = (p["frames"], p["height"] // p["vs"], p["width"] // p["vs"])
    n = (p["num_windows_f"], p["num_windows_h"], p["num_windows_w"])
    off = [(step % p["loop_step"]) * (s // p["loop_step"]) if k > 1 else 0 for s, k in zip(win, n)]
    fs, hs, ws = ([o + i * s for i in range(k)] for o, s, k in zip(off, win, n))
    return [(f0, h0, w0) for f0 in fs for w0 in ws for h0 in hs]


def ring_index(shape, origin, sizes, device):
    _, Fn, H, W, _ = shape
    return tuple((o + torch.arange(s, device=device)) % d for o, s, d in zip(origin, sizes, (Fn, H, W)))


def fractional_origins(step: int, p: dict):
    """(f0, h0, w0) of every window at a step of the i2v planar sampler
    (i2v_sphere_panorama_pipeline.py:732-768): the overlap follows from the
    total size and the window count, the origins move by whole latents a
    step with period ``loop_step``, w outer, then h, inside each frame
    window."""
    vs = p["vs"]
    wh, ww = p["height"] // vs, p["width"] // vs
    th, tw = p["total_h"] // vs, p["total_w"] // vs
    steps, offsets = [], []
    for total, win, n in ((th, wh, p["num_windows_h"]), (tw, ww, p["num_windows_w"])):
        overlap = 0.0 if n == 1 else 1 - (total / win - 1) / (n - 1)
        steps.append(win * (1 - overlap))
        offsets.append(0 if n == 1 else int((1 - overlap) * win * vs / p["loop_step"]) // vs)
    phase = step % p["loop_step"]
    hw = [(phase * offsets[0] + round(hi * steps[0]), phase * offsets[1] + round(wi * steps[1]))
          for wi in range(p["num_windows_w"]) for hi in range(p["num_windows_h"])]
    fs = frame_origins(step, p["total_f"], p["frames"], p["overlap_f"][step], p["loop_step_frame"], p["dock_at_f"])
    return [(f0, h0, w0) for f0 in fs for h0, w0 in hw]


def ring_crop(image, top: int, left: int, h: int, w: int):
    """Wrap-around [h, w, 3] crop of an [H, W, 3] image."""
    H, W = image.shape[:2]
    rows = (top + torch.arange(h, device=image.device)) % H
    cols = (left + torch.arange(w, device=image.device)) % W
    return image[rows[:, None], cols[None, :]]


def ring_decode(vae, latent, halo_chunks: int = 16):
    """[n, h, w, z] W-ring latents -> [n, H, W, 3]: the width wrap-padded by
    w // ``halo_chunks`` latents a side, decoded, the halo cropped
    (i2v_sphere_panorama_pipeline.py:974-991)."""
    w = latent.shape[2]
    halo = w // halo_chunks
    cols = (torch.arange(w + 2 * halo, device=latent.device) - halo) % w
    video = vae.decode(latent[:, :, cols])
    vs = video.shape[2] // (w + 2 * halo)
    return video[:, :, halo * vs: video.shape[2] - halo * vs]


def planar_step(sched: Schedule, state: dict, noise: Callable, eps_fn: Callable, p: dict, step: int,
                index: int, last: bool, origins, round_state=lambda t: t):
    """The reference's DDIM step of the planar ring sampler from ``state``
    ({"latent" [1, F, H, W, C], "denoised"}) over the windows at
    ``origins`` (f0, h0, w0); ``eps_fn(x_rows, ids)`` as in
    :func:`sphere_step` (ids index the windows). Returns (latent, denoised,
    x_rows)."""
    lat = state["latent"]
    dev = lat.device
    sizes = (p["frames"], p["height"] // p["vs"], p["width"] // p["vs"])
    cov = torch.zeros(lat.shape[:-1] + (1,), device=dev)
    wins, masks = [], []
    for o in origins:
        fi, hi, wi = ring_index(lat.shape, o, sizes, dev)
        sel = (slice(None), fi[:, None, None], hi[None, :, None], wi[None, None, :])
        wins.append(lat[sel])
        masks.append(cov[sel].clone())
        cov[sel] = 1.0
    n = len(origins)
    wins, masks = torch.cat(wins), torch.cat(masks)
    prev = wins
    renoise = 0.0 if last else p["renoise_ratio"]
    if renoise:
        noised = sched.re_noise(wins, max(index - 1, 0), index, noise(f"renoise:{step}", wins.shape))
        wins = mix_with_mask(wins, noised, masks, renoise)
    x_rows = torch.cat([wins, wins])
    eps = cfg_eps(eps_fn(x_rows, list(range(n))), n, p["guidance"])
    new, den = sched.ddim(wins, eps, index)
    merge = 0.0 if last or p.get("merge_prev") is None else p["merge_prev"][step]
    new = round_state(mix_with_mask(new, prev, masks, merge))
    den = round_state(den)
    latent, denoised = lat.clone(), state["denoised"].clone()
    for k, o in enumerate(origins):  # window order, the last write wins
        fi, hi, wi = ring_index(lat.shape, o, sizes, dev)
        sel = (slice(None), fi[:, None, None], hi[None, :, None], wi[None, None, :])
        latent[sel] = new[k:k + 1]
        denoised[sel] = den[k:k + 1]
    return round_state(latent), round_state(denoised), x_rows


# ---------------------------------------------------------------------------
# encoders around the UNet
# ---------------------------------------------------------------------------


def tiled_encode(vae, image, vs: int, tiles: int = 4, overlap_latent: int = 32):
    """[H, W, 3] -> [1, 1, H/vs, W/vs, z] (``vs`` the VAE's downsampling):
    tiles x tiles tiles, each grown by ``overlap_latent`` latents (clamped
    to the image), encoded, cropped back and count-averaged
    (i2v_sphere_panorama_pipeline.py:498-563)."""
    H, W = image.shape[:2]
    Hl, Wl = H // vs, W // vs
    th_l, tw_l = Hl // tiles, Wl // tiles
    th, tw, ov = th_l * vs, tw_l * vs, overlap_latent * vs
    acc = torch.zeros(Hl, Wl, vae.encoder.conv_out.out_channels // 2, device=image.device)
    cnt = torch.zeros(Hl, Wl, 1, device=image.device)
    for i in range(tiles):
        for j in range(tiles):
            hs, he, ws, we = i * th, (i + 1) * th, j * tw, (j + 1) * tw
            hso, heo, wso, weo = max(hs - ov, 0), min(he + ov, H), max(ws - ov, 0), min(we + ov, W)
            z = vae.encode(image[None, hso:heo, wso:weo])[0]
            top, left = (hs - hso) // vs, (ws - wso) // vs
            bot, right = z.shape[0] - (heo - he) // vs, z.shape[1] - (weo - we) // vs
            acc[i * th_l:(i + 1) * th_l, j * tw_l:(j + 1) * tw_l] += z[top:bot, left:right]
            cnt[i * th_l:(i + 1) * th_l, j * tw_l:(j + 1) * tw_l] += 1.0
    return (acc / cnt.clamp(min=1.0))[None, None]


class Conditioner:
    """Contexts of prompts and view crops: CLIP text (penultimate layer),
    and for i2v the Resampler tokens of the CLIP vision tokens appended;
    the CFG uncond is the empty prompt with the tokens of a zero image at
    the latent resolution."""

    def __init__(self, mods: dict, tokenizer, cfg: dict):
        self.mods, self.tokenizer, self.cfg = mods, tokenizer, cfg

    def text(self, prompts: List[str]):
        dev = next(self.mods["clip_text"].parameters()).device
        return self.mods["clip_text"](torch.as_tensor(self.tokenizer(prompts), dtype=torch.long, device=dev))

    def image(self, images):
        size = self.cfg["clip_vision"]["image_size"]
        return self.mods["resampler"](self.mods["clip_vision"](nets.clip_preprocess(images, size)))

    def context(self, prompts, crops=None):
        t = self.text(prompts)
        return t if crops is None else torch.cat([t, self.image(crops)], dim=1)

    def uncond(self, latent_hw: Tuple[int, int]):
        t = self.text([""])
        if "clip_vision" not in self.mods:
            return t
        dev = t.device
        return torch.cat([t, self.image(torch.zeros((1, *latent_hw, 3), device=dev))], dim=1)
