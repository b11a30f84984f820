"""Spherical (equirectangular) panorama shift-window sampler, stage 1 of the
360-degree pipeline (PyTorch).

Counterpart of ``dynamicscaler_tpu/pipelines/sphere.py``
(``VC2_Pipeline_I2V_SpherePano.basic_sample_shift_shpere_panorama``,
i2v_sphere_panorama_pipeline.py:32-496, and the t2v variant,
t2v_sphere_panorama_pipeline.py:24-316):

* the (phi, theta) view set of a step depends only on its phase
  ``step % loop_step_theta``, so every phase's projection maps (gather,
  validity, scatter plans) and every view's conditioning (per-phi prompt +
  the image tokens of the view's perspective crop of the panorama) are made
  up front: one batched text encode and one image encode, in chunks, over
  all phases' views;
* one DDIM step (``pipelines/window_step.py`` over :class:`_Views`)
  runs every (frame window, view) pair as one CFG-packed UNet batch in
  ``unet_microbatch`` chunks (``last``, ``average``; split over the ranks
  of a ``mesh``), or pair by pair (``sequential``).

Every noise draw takes ``noise_fn`` when given (``ops.ddim.draw_noise``),
else the ``generator``. Names: ``init``, ``skip``, ``renoise:{step}`` (the
whole window batch in ``last`` / ``average``), ``pair:{step}:{k}`` (pair k
in ``sequential``) and ``static:{step}`` (the re-noised static panorama).
The JAX package's seq-slab layout of the latent (a TPU memory layout; the
latent stays whole on every rank), step-program cache, step timers and
warm-up programs are not ported; ``LOOP_STATS`` keeps the loop's steady
s/step.

A model with hybrid conditioning (DynamiCrafter) joins the clean panorama
latent to its input: every pair's row takes the view's gather of it,
repeated over the frames (cond and uncond rows alike);
``guidance_rescale`` rescales the guided output and a v-parameterised
schedule converts it in the DDIM step, as in ``pipelines/planar.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamicscaler_tpu_torch.core.windows import frame_window_origins, sphere_phase_views
from dynamicscaler_tpu_torch.ops.blend import normalize_accumulated
from dynamicscaler_tpu_torch.ops.ddim import draw_noise, re_noise, re_noise_per_frame
from dynamicscaler_tpu_torch.ops.resize import resize_video_latent
from dynamicscaler_tpu_torch.ops.ring import wrap_slice_indices
from dynamicscaler_tpu_torch.ops.sphere import (
    ScatterPlan,
    add_view_nearest,
    make_sphere_views,
    plan_scatter,
    set_view_nearest,
)
from dynamicscaler_tpu_torch.pipelines.conditioning import build_uncond_context, cat_text_image, encode_texts_cached
from dynamicscaler_tpu_torch.pipelines.t2v import make_schedule_for_model
from dynamicscaler_tpu_torch.pipelines.tiled_vae import tiled_vae_encode
from dynamicscaler_tpu_torch.pipelines.window_step import check_overlap_mode, join, window_step
from dynamicscaler_tpu_torch.utils.timing import LoopStats, Marker, request, span

# steady s/step of the most recent sampler loop, read by cli/gen_pano_360.py
LOOP_STATS = LoopStats()

# ---------------------------------------------------------------------------
# host-side precomputation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhaseMaps:
    """One phase's view maps at one view resolution, on the device: gather
    and scatter indices [Nv, h, w] long, validity [Nv, h, w] float, and
    each view's :class:`ScatterPlan`."""

    gather: torch.Tensor
    valid: torch.Tensor
    scatter: torch.Tensor
    plans: Tuple[ScatterPlan, ...]


def _phase_view_maps(phase_views: Dict[int, List[Tuple[float, float]]], view_fov: float, lat_h: int,
                     lat_w: int, eq_lat_h: int, eq_lat_w: int, phi_fov_dict: Optional[Dict[float, float]] = None,
                     device=None) -> Dict[int, PhaseMaps]:
    """Per phase: the latent-space maps of its views; ``phi_fov_dict``
    overrides the FOV per phi row (t2v_sphere_panorama_pipeline.py:189-192)."""
    out = {}
    for phase, views in phase_views.items():
        svs = make_sphere_views([((phi_fov_dict or {}).get(phi, view_fov), theta, phi) for phi, theta in views],
                                lat_h, lat_w, eq_lat_h, eq_lat_w)
        scatter = np.stack([v.scatter_idx for v in svs])
        out[phase] = PhaseMaps(
            gather=torch.as_tensor(np.stack([v.gather_idx for v in svs]), dtype=torch.long, device=device),
            valid=torch.as_tensor(np.stack([v.valid for v in svs]), dtype=torch.float32, device=device),
            scatter=torch.as_tensor(scatter, dtype=torch.long, device=device),
            plans=tuple(plan_scatter(s, eq_lat_h * eq_lat_w, device) for s in scatter),
        )
    return out


def sphere_earlier_masks(scatter_idx: np.ndarray, f_origins: Sequence[int], frames: int, total_f: int,
                         eq_pixels: int, gather_idx: np.ndarray = None,
                         gather_valid: np.ndarray = None) -> np.ndarray:
    """Host oracle of the within-step earlier-pair coverage mask of every
    (frame window, view) pair (the reference's ``denoised_mask``,
    i2v_sphere_panorama_pipeline.py:345-365): coverage is WRITTEN with each
    pair's scatter footprint (``scatter_idx`` [Nv, hs, ws], ``eq_pixels``
    invalid) and READ through the native-resolution gather maps (default:
    the scatter maps). Returns [pairs, frames, h, w, 1] float32."""
    Nv = scatter_idx.shape[0]
    if gather_idx is None:
        gather_idx = scatter_idx
        gather_valid = scatter_idx < eq_pixels
    h, w = gather_idx.shape[1:]
    pairs = [(f0, v) for f0 in f_origins for v in range(Nv)]
    cov = np.zeros((total_f, eq_pixels), bool)
    masks = np.zeros((len(pairs), frames, h, w, 1), np.float32)
    for k, (f0, v) in enumerate(pairs):
        fi = (np.arange(frames) + f0) % total_f
        gidx = gather_idx[v].reshape(-1).clip(0)
        gval = gather_valid[v].reshape(-1)
        m = cov[np.ix_(fi, np.minimum(gidx, eq_pixels - 1))]
        masks[k, ..., 0] = (m & gval[None, :]).reshape(frames, h, w)
        sidx = scatter_idx[v]
        cov[np.ix_(fi, np.unique(sidx[sidx < eq_pixels]))] = True
    return masks


def device_sphere_masks(mask_gather_idx: torch.Tensor, mask_valid: torch.Tensor, scatter_idx: torch.Tensor,
                        pair_view: Sequence[int], pair_f: Sequence[int], frames: int, total_f: int,
                        eq_pixels: int) -> torch.Tensor:
    """On-device twin of :func:`sphere_earlier_masks`: ``mask_gather_idx``
    and ``mask_valid`` [Nv, h, w] (native resolution), ``scatter_idx`` [Nv,
    hs, ws] (the write footprint, ``eq_pixels`` invalid). Returns [pairs,
    frames, h, w, 1] float32."""
    dev = mask_gather_idx.device
    mh, mw = mask_gather_idx.shape[1:]
    cov = torch.zeros((total_f, eq_pixels), dtype=torch.float32, device=dev)
    masks = []
    for v, f0 in zip(pair_view, pair_f):
        fi = wrap_slice_indices(f0, frames, total_f, dev)
        gi = mask_gather_idx[v].reshape(-1).clamp(max=eq_pixels - 1)
        masks.append(cov[fi][:, gi] * mask_valid[v].reshape(1, -1))
        si = scatter_idx[v].reshape(-1)
        cov[fi[:, None], si[si < eq_pixels][None, :]] = 1.0
    return torch.stack(masks).reshape(len(masks), frames, mh, mw, 1)


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SphereStep:
    """What one DDIM step of the sphere loop needs besides the state."""

    t: int
    index: int
    pair_view: Tuple[int, ...]
    pair_f: Tuple[int, ...]
    context: torch.Tensor  # [pairs, L, D]
    renoise_ratio: float
    merge_prev_ratio: float
    paste: bool
    step: int  # the loop step, which names its noise draws


class _Sampler:
    """The options of one sampler call that do not change from step to
    step, and its step."""

    def __init__(self, model, schedule, frames, guidance_scale, fps, overlap_mode, unet_microbatch, get_scale,
                 set_scale, generator, noise_fn, mesh=None, guidance_rescale: float = 0.0):
        self.model, self.schedule, self.frames = model, schedule, frames
        self.guidance_scale, self.fps, self.overlap_mode = guidance_scale, fps, overlap_mode
        self.unet_microbatch, self.get_scale, self.set_scale = unet_microbatch, get_scale, set_scale
        self.generator, self.noise_fn, self.mesh = generator, noise_fn, mesh
        self.guidance_rescale = guidance_rescale

    def step(self, latent, denoised, static_clean, maps, native, set_maps, uncond, sp: SphereStep):
        """One DDIM step; returns the new (latent, denoised). ``latent``
        [1, F, EH, EW, C]; ``maps`` / ``native`` / ``set_maps`` the phase's
        maps at the get, native and set resolutions."""
        with span("step", latent.device, pairs=len(sp.pair_view)):
            views = _Views(self, latent, denoised, static_clean, maps, native, set_maps, sp)
            window_step(self, views, sp, uncond)
            return views.target, views.denoised


class _Views:
    """The (frame window, view) pairs of one sphere step: gathered at the
    get scale and resized to the native one; masked where earlier pairs'
    set footprints cover them; resized to the set scale and scattered in
    pair order (the last write wins) or averaged, onto the latent or, with
    ``sp.paste``, onto the clean panorama re-noised to the step's level. A
    ``sequential`` pair reads the latent as the pairs before it wrote it
    and writes both the latent and the paste target
    (i2v_sphere_panorama_pipeline.py:279-471), in one UNet call."""

    def __init__(self, s, latent, denoised, static_clean, maps, native, set_maps, sp):
        self.s, self.latent, self.denoised, self.static_clean = s, latent, denoised, static_clean
        self.maps, self.native, self.set_maps, self.sp = maps, native, set_maps, sp
        self.pairs = list(zip(sp.pair_view, sp.pair_f))
        self.n, self.frames, self.masked = len(self.pairs), s.frames, True
        _, self.F, EH, EW, _ = latent.shape
        self.eq = EH * EW  # equirect latent pixels
        self.microbatch = 0 if s.overlap_mode == "sequential" else s.unet_microbatch
        # the write target; in sequential mode the running coverage [F, EH * EW] and the frames of the pair
        self.target = self.cov = self.fi = None

    def begin(self):
        with span("step.scatter"):  # the paste target's draw comes before the pairs'
            self.target = self._target()
        self.cov = torch.zeros((self.F, self.eq), dtype=torch.float32, device=self.latent.device)

    def _target(self):
        if not self.sp.paste:
            return self.latent
        clean = self.static_clean.expand(*self.latent.shape[:2], *self.static_clean.shape[2:])
        noise = self._draw(clean.shape, f"static:{self.sp.step}")
        return re_noise(self.s.schedule, clean, 0, self.sp.index, noise=noise)

    def _draw(self, shape, name):
        return draw_noise(shape, self.s.model.device, self.s.generator, self.s.noise_fn, name)

    def _stack(self, latent, pairs):
        """The (view, frame origin) ``pairs`` of ``latent`` [1, F, EH, EW, C],
        invalid pixels zeroed, at the native resolution."""
        F, C = latent.shape[1], latent.shape[-1]
        flat, m, g = latent[0].reshape(F, -1, C), self.maps, self.s.get_scale
        wins = torch.stack([flat[wrap_slice_indices(f0, self.frames, F, flat.device)][:, m.gather[v].reshape(-1)]
                            * m.valid[v].reshape(1, -1, 1) for v, f0 in pairs])
        wins = wins.reshape(-1, self.frames, *m.gather.shape[1:], C)
        return wins if g == 1 else resize_video_latent(wins, wins.shape[2] // g, wins.shape[3] // g, mode="nearest")

    def gather(self, rows):
        return self._stack(self.latent, self.pairs[rows])

    def masks(self, rows):
        native = self.native
        if self.cov is None:
            return device_sphere_masks(native.gather, native.valid, self.set_maps.scatter, self.sp.pair_view,
                                       self.sp.pair_f, self.frames, self.F, self.eq)
        (v, f0), = self.pairs[rows]
        self.fi = wrap_slice_indices(f0, self.frames, self.F, self.latent.device)
        m = self.cov[self.fi][:, native.gather[v].reshape(-1).clamp(max=self.eq - 1)] * native.valid[v].reshape(1, -1)
        return m.reshape(1, self.frames, *native.gather.shape[1:], 1)

    def contexts(self, rows):
        return self.sp.context[rows]

    def noise(self, shape, rows):
        step = self.sp.step
        return self._draw(shape, f"renoise:{step}" if self.cov is None else f"pair:{step}:{rows.start}")

    def joined(self, x, rows):
        """``x`` with each pair's view of the clean panorama latent joined,
        repeated over the frames (hybrid conditioning)."""
        if not self.s.model.config.unet.concat_channels:
            return x
        return join(x, lambda: self._stack(self.static_clean, [(v, 0) for v in self.sp.pair_view[rows]]))

    def to_set(self, *ts):
        s = self.s.set_scale
        return ts if s == 1 else tuple(resize_video_latent(t, t.shape[2] * s, t.shape[3] * s, mode="nearest")
                                       for t in ts)

    def scatter(self, rows, new, den):
        plans, scatter = self.set_maps.plans, self.set_maps.scatter
        if self.target is None:
            self.target = self._target()
        target, denoised = self.target, self.denoised
        if self.s.overlap_mode == "average":
            acc, dacc = torch.zeros_like(target), torch.zeros_like(target)
            cnt = torch.zeros(target.shape[:-1] + (1,), dtype=target.dtype, device=target.device)
            dcnt = torch.zeros_like(cnt)  # the same counts again
            for k, (v, f0) in enumerate(self.pairs):
                add_view_nearest(acc, cnt, new[k:k + 1], scatter[v], frame_origin=f0)
                add_view_nearest(dacc, dcnt, den[k:k + 1], scatter[v], frame_origin=f0)
            self.target = normalize_accumulated(acc, cnt, target)
            self.denoised = normalize_accumulated(dacc, cnt, denoised)
            return
        for k, (v, f0) in enumerate(self.pairs[rows]):  # pair order: the last write wins
            if self.cov is not None and target is not self.latent:
                set_view_nearest(self.latent, new[k:k + 1], plans[v], frame_origin=f0)
            set_view_nearest(target, new[k:k + 1], plans[v], frame_origin=f0)
            set_view_nearest(denoised, den[k:k + 1], plans[v], frame_origin=f0)
            if self.cov is not None:  # the pair's set footprint, which the later pairs' masks read
                self.cov[self.fi[:, None], plans[v].tgt[None, :]] = 1.0


# ---------------------------------------------------------------------------
# conditioning
# ---------------------------------------------------------------------------


# view crops made and encoded at a time (the CLI's 440 crops of 320x512 are
# 865 MB in fp32 at once)
CROP_CHUNK = 64


def _view_contexts(model, prompt, pano_image, phase_views, view_fov, phi_prompt_dict, phi_fov_dict, height,
                   width, use_image_cond):
    """The all-phases context bank [V, L, D] and, per phase, the bank rows
    of its views: one text encode of the unique per-phi prompts and one
    image encode of every view's perspective crop of the panorama (the crop
    at the full view resolution, i2v_sphere_panorama_pipeline.py:367-376),
    gathered on the model's device and encoded ``CROP_CHUNK`` crops at a
    time."""
    phase_gid, prompts, specs = {}, [], []
    for phase, views in phase_views.items():
        phase_gid[phase] = np.arange(len(prompts), len(prompts) + len(views))
        prompts += [(phi_prompt_dict or {}).get(phi, prompt) for phi, _ in views]
        specs += [((phi_fov_dict or {}).get(phi, view_fov), theta, phi) for phi, theta in views]
    with span("request.text", prompts=len(set(prompts))):
        text = encode_texts_cached(model, prompts, {})
    if not use_image_cond:
        return text, phase_gid
    eq_h, eq_w = pano_image.shape[:2]
    dev = model.device
    with span("request.image", crops=len(specs), tokens=len(specs) * model.config.resampler.tokens):
        flat = torch.as_tensor(pano_image, device=dev).reshape(-1, 3)
        embs = []
        for i in range(0, len(specs), CROP_CHUNK):
            svs = make_sphere_views(specs[i:i + CROP_CHUNK], height, width, eq_h, eq_w)
            idx = torch.as_tensor(np.stack([sv.gather_idx for sv in svs]), dtype=torch.long, device=dev)
            valid = torch.as_tensor(np.stack([sv.valid for sv in svs]), device=dev)
            crops = flat[idx.reshape(-1)].reshape(len(svs), height, width, 3) * valid[..., None]
            embs.append(model.encode_image_cond(crops))
        return cat_text_image(text, torch.cat(embs)), phase_gid


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


@request
def sample_shift_sphere_panorama(
    model,
    prompt: str,
    pano_image,  # [eq_h, eq_w, 3] in [-1, 1]
    equirect_width: int,
    equirect_height: int,
    phi_theta_dict: Dict[float, Sequence[float]],
    view_fov: float = 120,
    loop_step_theta: int = 10,
    phi_prompt_dict: Optional[Dict[float, str]] = None,
    phi_fov_dict: Optional[Dict[float, float]] = None,
    total_f: Optional[int] = None,
    dock_at_f: bool = False,
    overlap_ratio_list_f: Optional[Sequence[float]] = None,
    loop_step_frame: Optional[int] = None,
    height: int = 320,
    width: int = 512,
    frames: int = 16,
    fps: int = 16,
    guidance_scale: float = 7.5,
    num_inference_steps: int = 48,
    denoise_to_step: Optional[int] = None,
    paste_on_static: bool = True,
    merge_renoised_overlap_latent_ratio: Optional[float] = 1.0,
    merge_prev_denoised_ratio_list: Optional[Sequence[float]] = None,
    use_skip_time: bool = False,
    skip_time_step_idx: Optional[int] = None,
    progressive_skip: bool = False,
    init_sphere_latent=None,
    downsample_factor_before_vae_decode: Optional[float] = None,
    view_get_scale_factor: int = 1,
    view_set_scale_factor: int = 1,
    overlap_mode: str = "last",
    unet_microbatch: int = 8,
    use_image_cond: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
    noise_fn=None,
    decode: bool = False,
    mesh=None,
    guidance_rescale: float = 0.0,
):
    """Sphere panorama shift-window sampling. Returns (video or None, final
    latent, denoised latent), each ``[1, total_f, eq_h / vs, eq_w / vs, C]``
    (divided by ``downsample_factor_before_vae_decode`` when given).
    ``use_image_cond`` defaults to whether the model has an image encoder
    (i2v); the t2v variant is the same algorithm with text-only
    conditioning. ``denoise_to_step`` stops after that many steps (the CLI
    runs 15 of 48). ``mesh`` splits each step's window batch over its ranks
    (``parallel.mesh``)."""
    if equirect_width != 2 * equirect_height:
        raise ValueError("equirect requires W = 2H")
    check_overlap_mode(overlap_mode)
    dev = model.device
    sched = make_schedule_for_model(model, num_inference_steps)
    vs = model.config.vae.spatial_scale
    lat_h, lat_w = height // vs, width // vs
    eq_lat_h, eq_lat_w = equirect_height // vs, equirect_width // vs
    total_f = total_f or frames
    S = num_inference_steps
    C = model.config.unet.out_channels
    if use_image_cond is None:
        use_image_cond = model.image_encoder is not None
    if torch.is_tensor(pano_image):
        pano_image = pano_image.detach().cpu().numpy()
    pano_image = np.asarray(pano_image, np.float32)

    # per-phase view maps: gather at the get scale, scatter at the set scale
    # (i2v_sphere_panorama_pipeline.py:330-343,422-435), coverage read at
    # the native window resolution
    phase_views = sphere_phase_views(phi_theta_dict, loop_step_theta, view_fov)

    def maps_at(scale):
        return _phase_view_maps(phase_views, view_fov, lat_h * scale, lat_w * scale, eq_lat_h, eq_lat_w,
                                phi_fov_dict, dev)
    tm = Marker("sphere")
    with span("request.maps", views=sum(len(v) for v in phase_views.values())):
        maps = maps_at(view_get_scale_factor)
        native = maps if view_get_scale_factor == 1 else maps_at(1)
        set_maps = maps if view_set_scale_factor == view_get_scale_factor else maps_at(view_set_scale_factor)
    tm.mark("maps")

    ctx_bank, phase_gid = _view_contexts(model, prompt, pano_image, phase_views, view_fov, phi_prompt_dict,
                                         phi_fov_dict, height, width, use_image_cond)
    tm.mark("phase conditioning (CLIP)")
    uncond = build_uncond_context(model, with_image=use_image_cond, image_hw=(lat_h, lat_w))

    # the clean static pano latent, encoded once
    if paste_on_static or use_skip_time or model.config.unet.concat_channels:
        static_clean = tiled_vae_encode(model, pano_image)
    else:
        static_clean = torch.zeros((1, 1, eq_lat_h, eq_lat_w, C), device=dev)

    skip = int(skip_time_step_idx or 0)
    shape = (1, total_f, eq_lat_h, eq_lat_w, C)
    with span("request.init"):
        if init_sphere_latent is not None:
            latent = torch.as_tensor(init_sphere_latent, dtype=torch.float32, device=dev).clone()
        elif not use_skip_time:
            latent = draw_noise(shape, dev, generator, noise_fn, "init")
        else:
            clean = static_clean.repeat(1, total_f, 1, 1, 1)
            noise = draw_noise(clean.shape, dev, generator, noise_fn, "skip")
            if progressive_skip:
                steps_b = np.full((total_f,), S - 1, np.int64)
                for frame_idx, pskip in enumerate(reversed(range(skip))):
                    steps_b[frame_idx] = S - pskip - 1
                noised = re_noise_per_frame(sched, clean, torch.from_numpy(steps_b), noise=noise)
                sel = (torch.arange(total_f, device=dev) < skip)[None, :, None, None, None]
                latent = torch.where(sel, noised, draw_noise(shape, dev, generator, noise_fn, "init"))
            else:
                latent = re_noise(sched, clean, 0, S - 1, noise=noise)
    tm.mark("static encode + init latent")

    steps_eff = S - (skip if use_skip_time and not progressive_skip else 0)
    if denoise_to_step is not None:
        steps_eff = min(steps_eff, denoise_to_step)
    ratios_f = overlap_ratio_list_f if overlap_ratio_list_f is not None else [0.5] * S
    ddim_ts = sched.ddim_timesteps.cpu().numpy()
    sampler = _Sampler(model, sched, frames, guidance_scale, fps, overlap_mode, unet_microbatch,
                       view_get_scale_factor, view_set_scale_factor, generator, noise_fn, mesh, guidance_rescale)

    denoised = torch.zeros_like(latent)
    tm.reset_lap()
    LOOP_STATS.start(steps_eff)
    for i in range(steps_eff):
        # the step's plan is made as the loop reaches it
        with span("request.plan", steps=1):
            # with skip the table index keeps counting from the truncated top
            index = (S - (skip if use_skip_time and not progressive_skip else 0)) - 1 - i
            phase = i % loop_step_theta
            f_origins = frame_window_origins(i, total_f, frames, ratios_f[i], loop_step_frame, dock_at_f)
            Nv = len(phase_views[phase])
            ids = np.concatenate([phase_gid[phase]] * len(f_origins))
            last = i == steps_eff - 1
            sp = SphereStep(
                t=int(ddim_ts[index]), index=index,
                pair_view=tuple(v for _ in f_origins for v in range(Nv)),
                pair_f=tuple(f0 for f0 in f_origins for _ in range(Nv)),
                context=ctx_bank[torch.as_tensor(ids, dtype=torch.long, device=ctx_bank.device)],
                renoise_ratio=float(merge_renoised_overlap_latent_ratio)
                if merge_renoised_overlap_latent_ratio is not None and not last else 0.0,
                merge_prev_ratio=float(merge_prev_denoised_ratio_list[i])
                if merge_prev_denoised_ratio_list is not None and not last else 0.0,
                paste=bool(paste_on_static and not last),
                step=i,
            )
        latent, denoised = sampler.step(latent, denoised, static_clean, maps[phase], native[phase],
                                        set_maps[phase], uncond, sp)
        tm.lap(f"step {i}/{steps_eff} phase={phase}")
        if i == 0:
            LOOP_STATS.mark_first(latent)
    LOOP_STATS.finish(latent)

    out_latent, out_denoised = latent, denoised
    if downsample_factor_before_vae_decode and downsample_factor_before_vae_decode != 1:
        th = int(eq_lat_h // downsample_factor_before_vae_decode)
        tw = int(eq_lat_w // downsample_factor_before_vae_decode)
        out_latent = resize_video_latent(out_latent, th, tw, mode="nearest")
        out_denoised = resize_video_latent(out_denoised, th, tw, mode="nearest")
    video = None
    if decode:
        with span("request.decode", frames=out_denoised.shape[1]):
            video = model.decode_video_chunked(out_denoised)
    return video, out_latent, out_denoised
