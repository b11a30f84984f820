"""Text-to-video pipelines (VideoCrafter2 t2v), PyTorch.

Counterpart of ``dynamicscaler_tpu/pipelines/t2v.py``:
``basic_sample`` is single-window DDIM with CFG
(t2v_normal_pipeline.py:70-212), ``freetraj_sample`` the same with FreeTraj
trajectory control; ``sample_shift_multi_windows`` is the
planar integer-grid shift-window sampler (t2v_normal_pipeline.py:214-570) on
:class:`PlanarShiftWindowEngine`: prompt -> CLIP text -> ring shift-window
DDIM with CFG -> VAE decode, optionally from a pre-denoised single-window
clip (``use_pre_denoise``). Every noise draw takes ``noise_fn`` when given
(see ``ops.ddim.draw_noise``; names ``init``, ``pre_denoise_init``,
``pre_denoise``, ``pre:{step}`` and the engine's ``renoise:*``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dynamicscaler_tpu_torch.core.windows import IntegerGrid
from dynamicscaler_tpu_torch.ops import freetraj as freetraj_ops
from dynamicscaler_tpu_torch.ops.blend import checkerboard_mix
from dynamicscaler_tpu_torch.ops.ddim import DDIMSchedule, ddim_step, draw_noise, guided, make_ddim_schedule, re_noise
from dynamicscaler_tpu_torch.ops.resize import resize_video_latent
from dynamicscaler_tpu_torch.pipelines.conditioning import build_uncond_context
from dynamicscaler_tpu_torch.pipelines.planar import PlanarShiftWindowEngine, step_plan
from dynamicscaler_tpu_torch.utils.timing import request, span


def make_schedule_for_model(model, num_steps: int) -> DDIMSchedule:
    """The model's DDIM schedule: its betas (rescaled to a zero terminal
    SNR where it asks), its timestep spacing and its parameterization."""
    d = model.config.diffusion
    return make_ddim_schedule(
        num_steps, d.timesteps, beta_schedule=d.beta_schedule, linear_start=d.linear_start,
        linear_end=d.linear_end, discretize=d.timestep_spacing, use_scale=d.use_scale, scale_a=d.scale_a,
        scale_b=d.scale_b, mid_step=d.mid_step, device=model.device,
        rescale_betas_zero_snr=d.rescale_betas_zero_snr, parameterization=d.parameterization,
    )


def refuse_concat(model, sampler: str) -> None:
    """A text-to-video sampler has no image to join to the noisy latent."""
    if model.config.unet.concat_channels:
        raise ValueError(f"{sampler}: the model joins an image latent to its input (hybrid conditioning); "
                         "sample it with the image-to-video samplers")


def basic_sample_loop(model, sched: DDIMSchedule, latent, context, uncond, guidance_scale: float,
                      fps: int, num_skip: int = 0, traj: Optional[freetraj_ops.FreeTraj] = None,
                      traj_thres: float = 600.0, concat=None, guidance_rescale: float = 0.0):
    """Single-window DDIM with CFG packed into one batch-2 UNet call per
    step, over the last ``S - num_skip`` steps of the table. With ``traj``
    (FreeTraj) each step re-gates it from its timestep: spatial masking
    while t > ``traj_thres``, temporal re-weighting always (t2v.py:
    129-168). ``concat`` [1, F, h, w, c] is joined to both rows' input
    (hybrid conditioning); ``guidance_rescale`` as in ``ops.ddim.guided``.
    Returns (latent, denoised)."""
    S = sched.num_ddim_steps
    Fn = latent.shape[1]
    ctx2 = torch.cat([context, uncond])
    den = None
    for i in range(S - num_skip):
        index = S - 1 - i - num_skip
        t2 = torch.full((2,), int(sched.ddim_timesteps[index]), device=latent.device)
        tr = None if traj is None else freetraj_ops.gate_active(traj, t2, traj_thres, 2, Fn)
        x = latent if concat is None else torch.cat([latent, concat], dim=-1)
        eps = model.apply_unet(torch.cat([x, x]), t2, ctx2, fps, traj=tr)
        eps = guided(eps[:1], eps[1:], guidance_scale, guidance_rescale)
        latent, den = ddim_step(sched, latent, eps, torch.full((Fn,), index))
    return latent, den


def basic_sample(model, prompt: str, height: int = 320, width: int = 512, frames: int = 16,
                 fps: int = 16, guidance_scale: float = 7.5, num_inference_steps: int = 48,
                 generator: Optional[torch.Generator] = None, latents=None,
                 skip_time_step_idx: Optional[int] = None, decode: bool = True, noise_fn=None):
    """Single-window t2v generation. Returns (video or None, denoised
    latent [1, F, h, w, C])."""
    if model.config.unet.use_image_attention:
        raise ValueError("basic_sample is the t2v path; use the i2v pipelines for image cond")
    refuse_concat(model, "t2v.basic_sample")
    sched = make_schedule_for_model(model, num_inference_steps)
    vs = model.config.vae.spatial_scale
    h, w = height // vs, width // vs
    context = model.encode_text([prompt])
    uncond = build_uncond_context(model, with_image=False)
    if latents is None:
        if skip_time_step_idx:
            raise ValueError("skip_time_step_idx requires a prepared latent")
        latents = draw_noise((1, frames, h, w, model.config.unet.out_channels), model.device, generator,
                             noise_fn, "init")
    latents = torch.as_tensor(latents, dtype=torch.float32, device=model.device)
    _, den = basic_sample_loop(model, sched, latents, context, uncond, guidance_scale, fps,
                               int(skip_time_step_idx or 0))
    video = model.decode_video(den) if decode else None
    return video, den


def freetraj_sample(model, prompt: str, traj_keyframes: Sequence[Sequence[float]],
                    traj_token_ids: Optional[Sequence[int]] = None, traj_thres: float = 600.0,
                    traj_classes: Tuple[bool, bool, bool] = (True, True, True), height: int = 320,
                    width: int = 512, frames: int = 16, fps: int = 16, guidance_scale: float = 7.5,
                    num_inference_steps: int = 48, generator: Optional[torch.Generator] = None,
                    decode: bool = True, noise_fn=None):
    """Single-window t2v with FreeTraj trajectory control (t2v.py:155-235;
    ``ops/freetraj.py`` for the semantics). ``traj_keyframes``: rows (frame
    index or fraction, h0, h1, w0, w1), the foreground box path in fractions
    of the video extent; ``traj_token_ids``: the target word's prompt token
    positions (default [2]); ``traj_classes``: (temporal_attn, self_attn,
    cross_attn). The init latent is the draw ``init``. Returns (video or
    None, denoised latent [1, F, h, w, C])."""
    if model.config.unet.use_image_attention:
        raise ValueError("freetraj_sample is a t2v path; i2v conditioning unsupported")
    refuse_concat(model, "freetraj_sample")
    sched = make_schedule_for_model(model, num_inference_steps)
    vs = model.config.vae.spatial_scale
    h, w = height // vs, width // vs
    context = model.encode_text([prompt])
    uncond = build_uncond_context(model, with_image=False)
    traj = freetraj_ops.make_freetraj(
        traj_keyframes, frames, text_len=model.config.unet.text_context_len, fg_token_ids=traj_token_ids,
        batch=2,  # CFG-packed (cond, uncond)
        temporal_attn=traj_classes[0], self_attn=traj_classes[1], cross_attn=traj_classes[2], device=model.device,
    )
    latents = draw_noise((1, frames, h, w, model.config.unet.out_channels), model.device, generator, noise_fn,
                         "init")
    _, den = basic_sample_loop(model, sched, latents, context, uncond, guidance_scale, fps, traj=traj,
                               traj_thres=traj_thres)
    video = model.decode_video(den) if decode else None
    return video, den


def shuffle_init_frame_order(total_f: int, frames: int, stride: int, rng: np.random.Generator) -> np.ndarray:
    """The frame order of ``random_shuffle_init_frame_stride``
    (t2v_normal_pipeline.py:328-337): from the first frame past the first
    window on, each group of ``stride`` frames takes the frames one window
    earlier (as already reordered), shuffled by ``rng``. The reference's
    indexing shuffles the H axis by accident; this shuffles frames, the
    documented intent, as the JAX package does. Returns [total_f] indices
    into the frame axis."""
    order = np.arange(total_f)
    for start in range(frames, total_f, stride):
        n = min(stride, total_f - start)
        src = order[start - frames:start - frames + n].copy()
        rng.shuffle(src)
        order[start:start + n] = src
    return order


@request
def sample_shift_multi_windows(
    model,
    prompt: str,
    num_windows_f: int = 1,
    num_windows_h: int = 1,
    num_windows_w: int = 1,
    height: int = 320,
    width: int = 512,
    frames: int = 16,
    fps: int = 16,
    guidance_scale: float = 7.5,
    num_inference_steps: int = 48,
    loop_step: Optional[int] = None,
    dock_at_h: bool = False,
    shift_jump_odd: Tuple[bool, bool, bool] = (False, False, False),
    docking: Tuple[bool, bool, bool] = (False, False, False),  # (f, h, w)
    docking_step_range: Optional[Sequence[int]] = None,
    merge_renoised_overlap_latent_ratio: Optional[float] = 1.0,
    merge_prev_denoised_ratio_list: Optional[Sequence[float]] = None,
    merge_predenoise_ratio_list: Optional[Sequence[float]] = None,
    sparse_add_residual: bool = True,
    random_shuffle_init_frame_stride: int = 0,
    init_panorama_latent: Optional[torch.Tensor] = None,
    clear_pre_denoised_latent: Optional[torch.Tensor] = None,
    use_pre_denoise: bool = False,
    overlap_mode: str = "last",
    unet_microbatch: int = 8,
    generator: Optional[torch.Generator] = None,
    noise_fn=None,
    decode: bool = True,
    mesh=None,
):
    """Planar integer-grid shift-window t2v: the global latent is
    ``num_windows_*`` times the native window in each axis, and every DDIM
    step denoises all windows, with cyclically shifting origins, as one
    CFG-packed UNet batch. Returns (video [1, F, H, W, 3] or None, denoised
    latent). For large panoramas pass ``decode=False`` and decode with
    ``model.decode_video_chunked`` to bound the VAE's memory.

    ``use_pre_denoise``: generate a single-window clip first (or take
    ``clear_pre_denoised_latent``), upsample its latent (bicubic) to the
    global size, tile it over the frame windows and re-noise it as the
    initial latent (t2v_normal_pipeline.py:348-403); with
    ``merge_predenoise_ratio_list`` every step re-anchors the latent to the
    re-noised residual, on a checkerboard with ``sparse_add_residual``
    (:445-468). ``mesh`` splits each step's window batch over its ranks
    (``parallel.mesh``; the single-window pre-denoise runs whole).

    ``random_shuffle_init_frame_stride`` > 0 reorders the initial noise's
    frames past the first window (:func:`shuffle_init_frame_order`) with a
    numpy generator seeded from a draw of ``generator`` (the JAX package
    seeds it from its init key, which cannot be reproduced here: a test
    hands both the same order)."""
    refuse_concat(model, "t2v.sample_shift_multi_windows")
    sched = make_schedule_for_model(model, num_inference_steps)
    vs = model.config.vae.spatial_scale
    wh, ww = height // vs, width // vs
    grid = IntegerGrid(
        win_f=frames, win_h=wh, win_w=ww,
        num_windows_f=num_windows_f, num_windows_h=num_windows_h, num_windows_w=num_windows_w,
        loop_step=loop_step or num_inference_steps, dock_at_h=dock_at_h,
        shift_jump_odd_f=shift_jump_odd[0], shift_jump_odd_h=shift_jump_odd[1],
        shift_jump_odd_w=shift_jump_odd[2],
        docking_f=docking[0], docking_h=docking[1], docking_w=docking[2],
        docking_step_range=None if docking_step_range is None else tuple(docking_step_range),
    )
    with span("request.text", prompts=1):
        context = model.encode_text([prompt])
    uncond = build_uncond_context(model, with_image=False)

    S = sched.num_ddim_steps
    dev = model.device
    shape = (1, grid.total_f, grid.total_h, grid.total_w, model.config.unet.out_channels)
    residual = None
    with span("request.init"):
        if init_panorama_latent is not None:
            latent = torch.as_tensor(init_panorama_latent, dtype=torch.float32, device=dev)
        elif use_pre_denoise:
            small = clear_pre_denoised_latent
            if small is None:
                init = draw_noise((1, frames, wh, ww, shape[-1]), dev, generator, noise_fn, "pre_denoise_init")
                _, small = basic_sample(model, prompt, height=height, width=width, frames=frames, fps=fps,
                                        guidance_scale=guidance_scale, num_inference_steps=num_inference_steps,
                                        latents=init, decode=False)
            big = resize_video_latent(torch.as_tensor(small, dtype=torch.float32, device=dev),
                                      grid.total_h, grid.total_w, mode="bicubic")
            residual = big.repeat(1, num_windows_f, 1, 1, 1)[:, :grid.total_f]
            latent = re_noise(sched, residual, 0, S - 1,
                              noise=draw_noise(residual.shape, dev, generator, noise_fn, "pre_denoise"))
        else:
            latent = draw_noise(shape, dev, generator, noise_fn, "init")
            if random_shuffle_init_frame_stride > 0:
                gdev = generator.device if generator is not None else "cpu"
                seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator, device=gdev))
                order = shuffle_init_frame_order(grid.total_f, frames, random_shuffle_init_frame_stride,
                                                 np.random.default_rng(seed))
                latent = latent[:, torch.as_tensor(order, device=dev)]

    pre_step = None
    if residual is not None and merge_predenoise_ratio_list is not None:
        def pre_step(lat, i):
            # per-step residual re-anchoring (t2v_normal_pipeline.py:445-468)
            ratio = float(merge_predenoise_ratio_list[i])
            noise = draw_noise(residual.shape, dev, generator, noise_fn, f"pre:{i}")
            noised = re_noise(sched, residual, 0, S - 1 - i, noise=noise)
            if sparse_add_residual:
                return checkerboard_mix(lat, noised, ratio, i)
            return lat * ratio + noised * (1.0 - ratio)

    with span("request.plan", steps=S):
        plan = step_plan(sched, S, grid.step_origins, lambda i, origins: (context, None),
                         merge_renoised_overlap_latent_ratio, merge_prev_denoised_ratio_list)
    engine = PlanarShiftWindowEngine(model, sched, (frames, wh, ww), guidance_scale=guidance_scale,
                                     fps=fps, overlap_mode=overlap_mode,
                                     unet_microbatch=unet_microbatch, mesh=mesh)
    latent, denoised = engine.run(latent, plan, uncond, generator, pre_step=pre_step, noise_fn=noise_fn)
    video = None
    if decode:
        with span("request.decode", frames=denoised.shape[1]):
            video = model.decode_video(denoised)
    return video, denoised
