"""Traffic kind ``planar_stage``: stage 2 (or 3) of the panorama CLI, one
request after another. A request is
``pipelines/i2v.py::sample_shift_multi_windows`` as ``cli/gen_pano_360.py``
calls it (skip-time from the stage's initial latent, decode included), on a
panorama image and an initial latent made from the seed; its noise draws
come from the benchmark by name.

The check follows the program step by step from its own state, as
``t2v_multiwin`` does: the initial latent (exactly the benchmark's), one
step drawn from the seed (the eps of a seeded sample of windows against the
reference's UNet with the reference's own contexts of the windows' ring
crops; the next latent and denoised buffer against the reference's step),
and the ring decode of a seeded sample of frames of the first request that
ended in the window."""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.check import max_abs, rel_l2, step_numbers, vae_scale
from portbench.reference import pipeline
from portbench.traffic import t2v_multiwin


def _shapes(p: dict, vs: int, channels: int):
    return (1, p["total_f"], p["total_h"] // vs, p["total_w"] // vs, channels)


class Driver(t2v_multiwin.Driver):
    def warm(self):
        """The ring decode's shape (one frame): the first request's first
        step warms the rest."""
        from dynamicscaler_tpu_torch.pipelines.tiled_vae import ring_aware_decode

        shape = _shapes(self.p, self.model.config.vae.spatial_scale, self.model.config.unet.in_channels)
        if self.p["decode"]:
            ring_aware_decode(self.model, torch.zeros((1, 1) + shape[2:], device=self.device))

    def request(self, r: int, window):
        from dynamicscaler_tpu_torch.pipelines import i2v

        p, vs = self.p, self.model.config.vae.spatial_scale
        noise = inputs.Noise(self.seed, r, self.device)
        pano = inputs.panorama(self.seed, r, p["total_h"], p["total_w"], self.device)
        init = noise("init_panorama", _shapes(p, vs, self.model.config.unet.in_channels))
        video, denoised = i2v.sample_shift_multi_windows(
            self.model, p["prompt"], pano, total_w=p["total_w"], total_h=p["total_h"], total_f=p["total_f"],
            num_windows_w=p["num_windows_w"], num_windows_h=p["num_windows_h"], loop_step=p["loop_step"],
            height=p["height"], width=p["width"], frames=p["frames"], fps=p["fps"], guidance_scale=p["guidance"],
            num_inference_steps=p["num_inference_steps"], dock_at_f=p["dock_at_f"], overlap_ratio_list_f=p["overlap_f"],
            loop_step_frame=p["loop_step_frame"], merge_renoised_overlap_latent_ratio=p["renoise_ratio"],
            merge_prev_denoised_ratio_list=p["merge_prev"], init_panorama_latent=init, use_skip_time=True,
            skip_time_step_idx=p["skip_time_step_idx"], progressive_skip=False, overlap_mode=p["overlap_mode"],
            unet_microbatch=p["unet_microbatch"], noise_fn=noise, decode=p["decode"])
        return self.sample_frames(r, video, denoised)


def check(spec, ref, captured: dict, output, seed: int, low=None) -> dict:
    """The cell's numbers (see the module docstring); with ``low`` the
    control takes the program's place, from the first step's state."""
    vs = vae_scale(spec)
    p = dict(spec.mix, vs=vs)
    dev = ref.device
    S = p["num_inference_steps"]
    steps = S - p["skip_time_step_idx"]
    sched = pipeline.Schedule(S, spec.config["model"]["diffusion"], dev)
    noise = inputs.Noise(seed, 0, dev)
    init = noise("init_panorama", _shapes(p, vs, spec.config["model"]["unet"]["in_channels"]))
    pano = inputs.panorama(seed, 0, p["total_h"], p["total_w"], dev)
    wh, ww = p["height"] // vs, p["width"] // vs

    def contexts(conditioner, origins):
        crops = torch.stack([pipeline.ring_crop(pano, h0 * vs, w0 * vs, p["height"], p["width"])
                             for _, h0, w0 in origins])
        return torch.cat([conditioner.context([p["prompt"]], crops[i:i + 1]) for i in range(len(origins))])

    if low is None:
        cap = captured["step"]
        prog_init = captured["start"]["latent"]
        step, index, t = cap["step"], cap["index"], cap["t"]
        state = {k: cap[k].float() for k in ("latent", "denoised")}
        prog_eps, prog_out = cap["eps"], (cap["latent_out"], cap["denoised_out"])
        video = output
    else:  # the control, from the initial latent
        low_cond = pipeline.Conditioner(low.mods, low.tokenizer, spec.config["model"])
        prog_init = low.round_state(init)
        step, index = 0, steps - 1
        t = int(sched.timesteps[index])
        state = {"latent": prog_init, "denoised": torch.zeros_like(prog_init)}
        origins = pipeline.fractional_origins(step, p)
        kept = {}

        def low_eps(x, ids):
            ctx = torch.cat([contexts(low_cond, origins), low_cond.uncond((wh, ww)).expand(len(ids), -1, -1)])
            kept["eps"] = low.unet(x, t, ctx, p["fps"], p["unet_microbatch"])
            return kept["eps"]
        out_l, out_d, _ = pipeline.planar_step(sched, state, noise, low_eps, p, step, index, step == steps - 1,
                                               origins, low.round_state)
        prog_eps, prog_out = kept["eps"], (out_l, out_d)
        frames = [0, p["total_f"] - 1]
        video = {"frames": frames, "denoised": out_d[:, frames],
                 "video": low.round_state(pipeline.ring_decode(low.mods["vae"], out_d[0, frames]))[None]}

    origins = pipeline.fractional_origins(step, p)
    numbers = {"init": max_abs(prog_init, init)}
    cond = pipeline.Conditioner(ref.mods, ref.tokenizer, spec.config["model"])
    numbers.update(step_numbers(
        ref, lambda eps_fn: pipeline.planar_step(sched, state, noise, eps_fn, p, step, index, step == steps - 1,
                                                 origins),
        state, prog_eps, prog_out,
        lambda pick: torch.cat([contexts(cond, [origins[k] for k in pick]),
                                cond.uncond((wh, ww)).expand(len(pick), -1, -1)]),
        t, p, seed, p["check_windows"]))
    if p["decode"]:
        want = pipeline.ring_decode(ref.mods["vae"], video["denoised"][0].float())
        numbers["video"] = rel_l2(video["video"][0].float(), want)
    return numbers
