"""Traffic kind ``dc_planar_stage``: DynamiCrafter's hybrid-conditioned model
on stage 2 of the panorama CLI, one request after another. A request is
``pipelines/i2v.py::sample_shift_multi_windows`` as ``planar_stage`` calls
it, with the guidance rescale, from seeded noise over every DDIM step (no
skip-time), the ring decode included; the latent is the VAE's ``embed_dim``
wide, the UNet's input that and the concat's.

The check follows the program step by step from its own state, with the
reference of ``reference/dynamicrafter.py``: the initial latent (exactly the
benchmark's), the panorama's clean latent (``static``, the concat's source,
against the reference's tiled encode), one step drawn from the seed (the
model's output of a seeded sample of windows, cond and uncond rows, named
``eps`` as in every cell though it is v here, against the reference's UNet
on the reference's joined rows with its own per-frame contexts; the next
latent and denoised buffer against the reference's v step with the rescale),
and the frame-by-frame ring decode of a seeded sample of frames of the
first request to end."""

from __future__ import annotations

import contextlib

import torch

from portbench import inputs
from portbench.check import max_abs, rel_l2, step_numbers, vae_scale
from portbench.reference import dynamicrafter as dc
from portbench.reference import pipeline
from portbench.traffic import planar_stage


def _shape(p: dict, vs: int, channels: int):
    return (1, p["total_f"], p["total_h"] // vs, p["total_w"] // vs, channels)


class Driver(planar_stage.Driver):
    def _latent_shape(self):
        return _shape(self.p, self.model.config.vae.spatial_scale, self.model.config.vae.embed_dim)

    def warm(self):
        """The ring decode's shape (one frame): the first request's first
        step warms the rest."""
        from dynamicscaler_tpu_torch.pipelines.tiled_vae import ring_aware_decode

        if self.p["decode"]:
            ring_aware_decode(self.model, torch.zeros((1, 1) + self._latent_shape()[2:], device=self.device))

    @contextlib.contextmanager
    def installed(self, window):
        from dynamicscaler_tpu_torch.pipelines import planar

        orig = planar.PlanarShiftWindowEngine.step

        def step(engine, latent, denoised, sp, uncond_context, generator=None, noise_fn=None, name="renoise"):
            window.step_begin(lambda: {"latent": latent.clone(), "denoised": denoised.clone(), "index": sp.index,
                                       "t": sp.t, "step": int(name.split(":")[1]), "static": engine.concat})
            orig(engine, latent, denoised, sp, uncond_context, generator, noise_fn, name)
            window.step_end(lambda: {"latent_out": latent.clone(), "denoised_out": denoised.clone()})
        planar.PlanarShiftWindowEngine.step = step
        try:
            yield
        finally:
            planar.PlanarShiftWindowEngine.step = orig

    def request(self, r: int, window):
        from dynamicscaler_tpu_torch.pipelines import i2v

        p = self.p
        noise = inputs.Noise(self.seed, r, self.device)
        pano = inputs.panorama(self.seed, r, p["total_h"], p["total_w"], self.device)
        video, denoised = i2v.sample_shift_multi_windows(
            self.model, p["prompt"], pano, total_w=p["total_w"], total_h=p["total_h"], total_f=p["total_f"],
            num_windows_w=p["num_windows_w"], num_windows_h=p["num_windows_h"], loop_step=p["loop_step"],
            height=p["height"], width=p["width"], frames=p["frames"], fps=p["fps"], guidance_scale=p["guidance"],
            num_inference_steps=p["num_inference_steps"], dock_at_f=p["dock_at_f"], overlap_ratio_list_f=p["overlap_f"],
            loop_step_frame=p["loop_step_frame"], merge_renoised_overlap_latent_ratio=p["renoise_ratio"],
            merge_prev_denoised_ratio_list=p["merge_prev"], init_panorama_latent=noise("init_panorama",
                                                                                       self._latent_shape()),
            overlap_mode=p["overlap_mode"], unet_microbatch=p["unet_microbatch"], noise_fn=noise, decode=p["decode"],
            guidance_rescale=p["guidance_rescale"])
        return self.sample_frames(r, video, denoised)


def check(spec, ref, captured: dict, output, seed: int, low=None) -> dict:
    """The cell's numbers (see the module docstring); with ``low`` the
    control takes the program's place, from the first step's state."""
    vs = vae_scale(spec)
    p = dict(spec.mix, vs=vs)
    model_cfg = spec.config["model"]
    dev = ref.device
    S = p["num_inference_steps"]
    sched = dc.Schedule(S, model_cfg["diffusion"], dev)
    noise = inputs.Noise(seed, 0, dev)
    init = noise("init_panorama", _shape(p, vs, model_cfg["vae"]["embed_dim"]))
    pano = inputs.panorama(seed, 0, p["total_h"], p["total_w"], dev)
    wh, ww = p["height"] // vs, p["width"] // vs
    dc.per_frame(ref.mods["unet"])
    static = pipeline.tiled_encode(ref.mods["vae"], pano, vs)

    def contexts(conditioner, origins):
        crops = torch.stack([pipeline.ring_crop(pano, h0 * vs, w0 * vs, p["height"], p["width"])
                             for _, h0, w0 in origins])
        return torch.cat([conditioner.context([p["prompt"]], crops[i:i + 1]) for i in range(len(origins))])

    if low is None:
        start, cap = captured["start"], captured["step"]
        prog_init, prog_static = start["latent"], start["static"]
        step, index, t = cap["step"], cap["index"], cap["t"]
        state = {k: cap[k].float() for k in ("latent", "denoised", "static")}
        prog_eps, prog_out = cap["eps"], (cap["latent_out"], cap["denoised_out"])
        video = output
    else:  # the control, from the initial latent
        dc.per_frame(low.mods["unet"])
        low_cond = pipeline.Conditioner(low.mods, low.tokenizer, model_cfg)
        prog_init = low.round_state(init)
        prog_static = low.round_state(pipeline.tiled_encode(low.mods["vae"], pano, vs))
        step, index = 0, S - 1
        t = int(sched.timesteps[index])
        state = {"latent": prog_init, "denoised": torch.zeros_like(prog_init), "static": prog_static}
        origins = pipeline.fractional_origins(step, p)
        kept = {}

        def low_eps(x, ids):
            ctx = torch.cat([contexts(low_cond, origins), low_cond.uncond((wh, ww)).expand(len(ids), -1, -1)])
            kept["eps"] = low.unet(x, t, ctx, p["fps"], p["unet_microbatch"])
            return kept["eps"]
        out_l, out_d, _ = dc.planar_step(sched, state, noise, low_eps, p, step, index, step == S - 1, origins,
                                         low.round_state)
        prog_eps, prog_out = kept["eps"], (out_l, out_d)
        frames = [0, p["total_f"] - 1]
        video = {"frames": frames, "denoised": out_d[:, frames],
                 "video": low.round_state(dc.ring_decode_frames(low.mods["vae"], out_d[0, frames]))[None]}

    origins = pipeline.fractional_origins(step, p)
    numbers = {"init": max_abs(prog_init, init), "static": rel_l2(prog_static, static)}
    cond = pipeline.Conditioner(ref.mods, ref.tokenizer, model_cfg)
    numbers.update(step_numbers(
        ref, lambda eps_fn: dc.planar_step(sched, state, noise, eps_fn, p, step, index, step == S - 1, origins),
        state, prog_eps, prog_out,
        lambda pick: torch.cat([contexts(cond, [origins[k] for k in pick]),
                                cond.uncond((wh, ww)).expand(len(pick), -1, -1)]),
        t, p, seed, p["check_windows"]))
    if p["decode"]:
        want = dc.ring_decode_frames(ref.mods["vae"], video["denoised"][0].float())
        numbers["video"] = rel_l2(video["video"][0].float(), want)
    return numbers
