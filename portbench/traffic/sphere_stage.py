"""Traffic kind ``sphere_stage``: stage 1 of the panorama CLI, one request
after another. A request is ``pipelines/sphere.py::sample_shift_sphere_panorama``
at the mix's geometry on a panorama made from the seed, as
``cli/gen_pano_360.py`` calls it (``decode=False``); its noise draws come
from the benchmark by name.

The check follows the program step by step from its own state: the first
step's input (the initial latent, exactly the benchmark's draw; the clean
static latent of the tiled encode, against the reference's encode), then
one step drawn from the seed: the eps of a seeded sample of views, cond and
uncond rows, against the reference's UNet on the reference's gather of the
program's latent with the reference's own contexts; and the program's next
latent and denoised buffer against the reference's step from the program's
state and eps."""

from __future__ import annotations

import contextlib

import torch

from portbench import inputs
from portbench.check import max_abs, rel_l2, step_numbers, vae_scale
from portbench.reference import pipeline


def params(mix: dict, vs: int) -> dict:
    """The mix with its per-phi maps keyed by float phi, in file order, and
    the VAE's downsampling ``vs``."""
    p = dict(mix, vs=vs)
    p["phi_theta"] = {float(k): v for k, v in mix["phi_theta"].items()}
    p["phi_prompt"] = {float(k): v for k, v in mix["phi_prompt"].items()}
    return p


class Driver:
    needs_output = False  # the check reads no request's output

    def __init__(self, model, mix: dict, seed: int, device):
        self.model, self.p, self.seed, self.device = model, params(mix, model.config.vae.spatial_scale), seed, device

    def warm(self):
        """The first request's first step warms every shape the window uses."""

    @contextlib.contextmanager
    def installed(self, window):
        from dynamicscaler_tpu_torch.pipelines import sphere

        orig = sphere._Sampler.step

        def step(sampler, latent, denoised, static_clean, maps, native, set_maps, uncond, sp):
            window.step_begin(lambda: {"latent": latent.clone(), "denoised": denoised.clone(),
                                       "static": static_clean, "step": sp.step, "index": sp.index, "t": sp.t})
            out = orig(sampler, latent, denoised, static_clean, maps, native, set_maps, uncond, sp)
            window.step_end(lambda: {"latent_out": out[0].clone(), "denoised_out": out[1].clone()})
            return out
        sphere._Sampler.step = step
        try:
            yield
        finally:
            sphere._Sampler.step = orig

    def request(self, r: int, window):
        from dynamicscaler_tpu_torch.pipelines import sphere

        p = self.p
        pano = inputs.panorama(self.seed, r, p["equirect_height"], p["equirect_width"], self.device)
        sphere.sample_shift_sphere_panorama(
            self.model, p["prompt"], pano, equirect_width=p["equirect_width"], equirect_height=p["equirect_height"],
            phi_theta_dict=p["phi_theta"], phi_prompt_dict=p["phi_prompt"], view_fov=p["view_fov"],
            loop_step_theta=p["loop_step_theta"], denoise_to_step=p["denoise_to_step"],
            paste_on_static=p["paste_on_static"], merge_renoised_overlap_latent_ratio=p["renoise_ratio"],
            unet_microbatch=p["unet_microbatch"], height=p["height"], width=p["width"], frames=p["frames"],
            fps=p["fps"], guidance_scale=p["guidance"], num_inference_steps=p["num_inference_steps"],
            total_f=p["total_f"], dock_at_f=p["dock_at_f"], overlap_ratio_list_f=p["overlap_f"],
            loop_step_frame=p["loop_step_frame"], merge_prev_denoised_ratio_list=p["merge_prev"],
            overlap_mode=p["overlap_mode"], noise_fn=inputs.Noise(self.seed, r, self.device), decode=False)

    @staticmethod
    def keep(outputs):
        return None


def check(spec, ref, captured: dict, output, seed: int, low=None) -> dict:
    """The cell's numbers (see the module docstring); with ``low`` the
    control takes the program's place, from the first step's state."""
    vs = vae_scale(spec)
    p = params(spec.mix, vs)
    dev = ref.device
    sched = pipeline.Schedule(p["num_inference_steps"], spec.config["model"]["diffusion"], dev)
    noise = inputs.Noise(seed, 0, dev)
    pano = inputs.panorama(seed, 0, p["equirect_height"], p["equirect_width"], dev)
    shape = (1, p["total_f"], p["equirect_height"] // vs, p["equirect_width"] // vs,
             spec.config["model"]["unet"]["in_channels"])
    init = noise("init", shape)
    static = pipeline.tiled_encode(ref.mods["vae"], pano, vs)
    cond = pipeline.Conditioner(ref.mods, ref.tokenizer, spec.config["model"])
    last_step = p["denoise_to_step"] - 1

    if low is None:
        start, cap = captured["start"], captured["step"]
        prog_init, prog_static = start["latent"], start["static"]
        step, index, t = cap["step"], cap["index"], cap["t"]
        state = {k: cap[k].float() for k in ("latent", "denoised", "static")}
        prog_eps, prog_out = cap["eps"], (cap["latent_out"], cap["denoised_out"])
    else:  # the control, from the initial latent
        low_cond = pipeline.Conditioner(low.mods, low.tokenizer, spec.config["model"])
        prog_init = low.round_state(init)
        prog_static = low.round_state(pipeline.tiled_encode(low.mods["vae"], pano, vs))
        step, index = 0, p["num_inference_steps"] - 1
        t = int(sched.timesteps[index])
        state = {"latent": prog_init, "denoised": torch.zeros_like(prog_init), "static": prog_static}
        ctx_low = _contexts(low_cond, p, pano, step)

        def low_eps(x, ids):
            n = len(ids)
            ctx = torch.cat([ctx_low[ids], low_cond.uncond((p["height"] // vs, p["width"] // vs)).expand(n, -1, -1)])
            return low.unet(x, t, ctx, p["fps"], p["unet_microbatch"])
        captured_eps = {}

        def low_eps_kept(x, ids):
            captured_eps["eps"] = low_eps(x, ids)
            return captured_eps["eps"]
        out_l, out_d, _ = pipeline.sphere_step(sched, state, noise, low_eps_kept, p, step, index, step == last_step,
                                               low.round_state)
        prog_eps, prog_out = captured_eps["eps"], (out_l, out_d)

    numbers = {"init": max_abs(prog_init, init), "static": rel_l2(prog_static, static)}
    uncond = cond.uncond((p["height"] // vs, p["width"] // vs))
    n_views = len(pipeline.sphere_contexts(p, step))  # a pair's view: its index modulo the views
    numbers.update(step_numbers(
        ref, lambda eps_fn: pipeline.sphere_step(sched, state, noise, eps_fn, p, step, index, step == last_step),
        state, prog_eps, prog_out,
        lambda pick: torch.cat([_contexts(cond, p, pano, step, [k % n_views for k in pick]),
                                uncond.expand(len(pick), -1, -1)]),
        t, p, seed, p["check_views"]))
    return numbers


def _contexts(cond, p, pano, step, which=None):
    """Contexts [V, L, D] of the views ``which`` (default all) of a step's
    phase: the view's prompt and the image tokens of its crop."""
    views = pipeline.sphere_contexts(p, step)
    which = range(len(views)) if which is None else which
    out = []
    for v in which:
        prompt, spec = views[v]
        crops = pipeline.view_crops(pano, [spec], p["height"], p["width"]) if "clip_vision" in cond.mods else None
        out.append(cond.context([prompt], crops))
    return torch.cat(out)
