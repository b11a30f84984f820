"""FIFO diagonal denoising: streaming video of any length (PyTorch).

Counterpart of ``dynamicscaler_tpu/pipelines/fifo.py`` (FIFO-Diffusion on
the reference's per-frame DDIM scheduler, pipeline/scheduler.py:61-96, and
T2V-Turbo's ``fifo_step``, d_scheduler.py:465-545). A queue of ``frames``
latents sits at staggered timesteps, front cleanest. Each iteration runs
ONE CFG-packed batch-2 UNet forward with the queue's per-frame timesteps
``[2, F]`` (the time embedding rides the (B F) batch), steps every slot,
emits the now-clean front frame, shifts the queue and appends fresh noise at
the back: one UNet forward per output frame. The JAX package scans the loop
on the device; here it is a Python loop over the output frames.

Every draw takes ``noise_fn`` under a stable name (``ops.ddim.draw_noise``):
``init`` the base latent, ``stagger`` the noise that staggers it, and per
iteration i ``fresh:{i}`` the appended slot and, for the LCM loop,
``step:{i}`` the step's noise.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamicscaler_tpu_torch.ops.ddim import ddim_step, draw_noise, re_noise_per_frame
from dynamicscaler_tpu_torch.ops.lcm import fifo_timestep_vectors, lcm_add_noise, lcm_step, make_lcm_schedule
from dynamicscaler_tpu_torch.pipelines.conditioning import build_uncond_context
from dynamicscaler_tpu_torch.pipelines.t2v import make_schedule_for_model, refuse_concat


def _fifo_loop(model, queue, t_frames, step, ctx2, guidance_scale, fps, num_out_frames, generator, noise_fn):
    """The queue loop: per iteration one batch-2 forward at the per-frame
    timesteps, ``step(queue, eps, i) -> (stepped, denoised)``, the front
    frame out, the queue shifted with fresh noise at the back. Returns the
    output frames [1, N, h, w, C]."""
    t2 = t_frames[None].expand(2, -1)
    out = []
    for i in range(num_out_frames):
        eps = model.apply_unet(torch.cat([queue, queue]), t2, ctx2, fps)
        eps = eps[1:] + guidance_scale * (eps[:1] - eps[1:])
        stepped, denoised = step(queue, eps, i)
        out.append(denoised[:, 0])
        fresh = draw_noise(queue[:, :1].shape, queue.device, generator, noise_fn, f"fresh:{i}")
        queue = torch.cat([stepped[:, 1:], fresh], dim=1)
    return torch.stack(out, dim=1)


def fifo_sample(model, prompt: str, num_output_frames: int, height: int = 320, width: int = 512,
                frames: Optional[int] = None, fps: int = 16, guidance_scale: float = 7.5,
                generator: Optional[torch.Generator] = None, base_latent=None, decode: bool = True,
                scheduler: str = "ddim", noise_fn=None):
    """A stream of ``num_output_frames`` frames by FIFO diagonal denoising.
    The queue depth ``frames`` is the number of scheduler steps each frame
    gets. ``scheduler``: ``ddim`` (VideoCrafter models) or ``lcm``
    (T2V-Turbo distilled models, ``fifo_step`` semantics). Returns (video
    or None, latent frames [1, N, h, w, C])."""
    if scheduler not in ("ddim", "lcm"):
        raise ValueError(f"scheduler {scheduler!r}: ddim or lcm")
    refuse_concat(model, "fifo_sample")
    frames = frames or model.config.unet.temporal_length
    vs = model.config.vae.spatial_scale
    h, w = height // vs, width // vs
    dev = model.device

    context = model.encode_text([prompt])
    uncond = build_uncond_context(model, with_image=False)
    ctx2 = torch.cat([context, uncond])
    if base_latent is None:
        base = draw_noise((1, frames, h, w, model.config.unet.out_channels), dev, generator, noise_fn, "init")
    else:
        base = torch.as_tensor(base_latent, dtype=torch.float32, device=dev)
    stagger = draw_noise(base.shape, dev, generator, noise_fn, "stagger")

    if scheduler == "lcm":
        sched = make_lcm_schedule(num_inference_steps=frames, device=dev)
        t_frames, prev_frames = fifo_timestep_vectors(sched)
        # slot j noised to its own LCM timestep, front cleanest
        queue = lcm_add_noise(sched, base, t_frames, noise=stagger)

        def step(q, eps, i):
            noise = draw_noise(q.shape, dev, generator, noise_fn, f"step:{i}")
            return lcm_step(sched, q, eps, t_frames, prev_frames, noise=noise)
    else:
        sched = make_schedule_for_model(model, frames)  # S == queue depth
        indices = torch.arange(frames, device=dev)
        t_frames = sched.ddim_timesteps[indices]
        # frame j re-noised to DDIM index j, front cleanest
        queue = re_noise_per_frame(sched, base, indices, noise=stagger)

        def step(q, eps, i):
            return ddim_step(sched, q, eps, indices)

    frames_out = _fifo_loop(model, queue, t_frames, step, ctx2, guidance_scale, fps, num_output_frames,
                            generator, noise_fn)
    video = model.decode_video(frames_out) if decode else None
    return video, frames_out
