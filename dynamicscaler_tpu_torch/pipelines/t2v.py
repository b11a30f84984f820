"""Text-to-video pipelines (VideoCrafter2 t2v), PyTorch.

Counterpart of ``dynamicscaler_tpu/pipelines/t2v.py``:
``basic_sample`` is single-window DDIM with CFG
(t2v_normal_pipeline.py:70-212); ``sample_shift_multi_windows`` is the
planar integer-grid shift-window sampler (t2v_normal_pipeline.py:214-570) on
:class:`PlanarShiftWindowEngine`: prompt -> CLIP text -> ring shift-window
DDIM with CFG -> VAE decode.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamicscaler_tpu_torch.core.windows import IntegerGrid
from dynamicscaler_tpu_torch.ops.ddim import DDIMSchedule, ddim_step, make_ddim_schedule
from dynamicscaler_tpu_torch.pipelines.conditioning import build_uncond_context
from dynamicscaler_tpu_torch.pipelines.planar import PlanarShiftWindowEngine, StepPlan


def make_schedule_for_model(model, num_steps: int) -> DDIMSchedule:
    d = model.config.diffusion
    return make_ddim_schedule(
        num_steps, d.timesteps, beta_schedule=d.beta_schedule, linear_start=d.linear_start,
        linear_end=d.linear_end, use_scale=d.use_scale, scale_a=d.scale_a, scale_b=d.scale_b,
        mid_step=d.mid_step, device=model.device,
    )


def basic_sample(model, prompt: str, height: int = 320, width: int = 512, frames: int = 16,
                 fps: int = 16, guidance_scale: float = 7.5, num_inference_steps: int = 48,
                 generator: Optional[torch.Generator] = None, latents=None,
                 skip_time_step_idx: Optional[int] = None, decode: bool = True):
    """Single-window t2v generation. Returns (video or None, denoised
    latent [1, F, h, w, C])."""
    if model.config.unet.use_image_attention:
        raise ValueError("basic_sample is the t2v path; use the i2v pipelines for image cond")
    sched = make_schedule_for_model(model, num_inference_steps)
    vs = model.config.vae.spatial_scale
    h, w = height // vs, width // vs
    context = model.encode_text([prompt])
    uncond = build_uncond_context(model, with_image=False)
    if latents is None:
        if skip_time_step_idx:
            raise ValueError("skip_time_step_idx requires a prepared latent")
        latents = torch.randn((1, frames, h, w, model.config.unet.in_channels),
                              generator=generator, device=model.device)
    S = sched.num_ddim_steps
    ctx2 = torch.cat([context, uncond])
    lat = latents
    den = None
    for i in range(S - int(skip_time_step_idx or 0)):
        index = S - 1 - i - int(skip_time_step_idx or 0)
        t = int(sched.ddim_timesteps[index])
        eps = model.apply_unet(torch.cat([lat, lat]), torch.full((2,), t, device=lat.device), ctx2, fps)
        eps = eps[1:] + guidance_scale * (eps[:1] - eps[1:])
        lat, den = ddim_step(sched, lat, eps, torch.full((lat.shape[1],), index))
    video = model.decode_video(den) if decode else None
    return video, den


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
    init_panorama_latent: Optional[torch.Tensor] = None,
    use_pre_denoise: bool = False,
    overlap_mode: str = "last",
    unet_microbatch: int = 8,
    generator: Optional[torch.Generator] = None,
    decode: bool = True,
):
    """Planar integer-grid shift-window t2v: the global latent is
    ``num_windows_*`` times the native window in each axis, and every DDIM
    step denoises all windows, with cyclically shifting origins, as one
    CFG-packed UNet batch. Returns (video [1, F, H, W, 3] or None, denoised
    latent). For large panoramas pass ``decode=False`` and decode with
    ``model.decode_video_chunked`` to bound the VAE's memory."""
    if use_pre_denoise:
        raise NotImplementedError(
            "use_pre_denoise needs ops/resize.py (bicubic latent upsampling), which the port "
            "has not brought over yet"
        )
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
    context = model.encode_text([prompt])
    uncond = build_uncond_context(model, with_image=False)

    if init_panorama_latent is None:
        latent = torch.randn((1, grid.total_f, grid.total_h, grid.total_w, model.config.unet.in_channels),
                             generator=generator, device=model.device)
    else:
        latent = torch.as_tensor(init_panorama_latent, dtype=torch.float32, device=model.device)

    S = sched.num_ddim_steps
    ddim_ts = sched.ddim_timesteps.cpu().numpy()
    plan: List[StepPlan] = []
    for i in range(S):
        last = i == S - 1
        plan.append(StepPlan(
            t=int(ddim_ts[S - 1 - i]),
            index=S - 1 - i,
            origins=np.asarray(grid.step_origins(i), np.int64),
            context=context,
            renoise_ratio=None if last else merge_renoised_overlap_latent_ratio,
            merge_prev_ratio=None if last or merge_prev_denoised_ratio_list is None
            else float(merge_prev_denoised_ratio_list[i]),
        ))
    engine = PlanarShiftWindowEngine(model, sched, (frames, wh, ww), guidance_scale=guidance_scale,
                                     fps=fps, overlap_mode=overlap_mode,
                                     unet_microbatch=unet_microbatch)
    latent, denoised = engine.run(latent, plan, uncond, generator)
    video = model.decode_video(denoised) if decode else None
    return video, denoised
