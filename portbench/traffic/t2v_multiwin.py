"""Traffic kind ``t2v_multiwin``: the planar ring shift-window t2v sampler,
one request after another. A request is
``pipelines/t2v.py::sample_shift_multi_windows`` with a prompt the seed
picks from the mix, the mix's window counts and the function's defaults
otherwise (the decode included); its noise draws come from the benchmark
by name.

The check follows the program step by step from its own state: the initial
latent (exactly the benchmark's draw), then one step drawn from the seed
(the eps of a seeded sample of windows, cond and uncond rows, against the
reference's UNet on the reference's gather of the program's latent with the
reference's own contexts; the program's next latent and denoised buffer
against the reference's step from the program's state and eps), and the
decode of a seeded sample of frames of the first request that ended in
the window (or of the one in flight at its end, run on to its end untimed),
from the program's denoised latent."""

from __future__ import annotations

import contextlib

import torch

from portbench import inputs
from portbench.check import max_abs, rel_l2, step_numbers, vae_scale
from portbench.reference import pipeline


def pick_prompt(mix: dict, seed: int, r: int) -> str:
    """The prompt of request ``r``: one of the mix's, picked by the seed."""
    return mix["prompts"][inputs.derive_seed(seed, "prompt", r) % len(mix["prompts"])]


class Driver:
    def __init__(self, model, mix: dict, seed: int, device):
        self.model, self.p, self.seed, self.device = model, mix, seed, device
        self.needs_output = mix["decode"]  # the check reads a finished request's video

    def _latent_shape(self):
        p, vs = self.p, self.model.config.vae.spatial_scale
        return (1, p["frames"] * p["num_windows_f"], p["height"] // vs * p["num_windows_h"],
                p["width"] // vs * p["num_windows_w"], self.model.config.unet.in_channels)

    def warm(self):
        """The decode's shape: the first request's first step warms the rest."""
        if self.p["decode"]:
            self.model.decode_video(torch.zeros(self._latent_shape(), device=self.device))

    @contextlib.contextmanager
    def installed(self, window):
        from dynamicscaler_tpu_torch.pipelines import planar

        orig = planar.PlanarShiftWindowEngine.step

        def step(engine, latent, denoised, sp, uncond_context, generator=None, noise_fn=None, name="renoise"):
            window.step_begin(lambda: {"latent": latent.clone(), "denoised": denoised.clone(), "index": sp.index,
                                       "t": sp.t, "step": int(name.split(":")[1])})
            orig(engine, latent, denoised, sp, uncond_context, generator, noise_fn, name)
            window.step_end(lambda: {"latent_out": latent.clone(), "denoised_out": denoised.clone()})
        planar.PlanarShiftWindowEngine.step = step
        try:
            yield
        finally:
            planar.PlanarShiftWindowEngine.step = orig

    def request(self, r: int, window):
        from dynamicscaler_tpu_torch.pipelines import t2v

        p = self.p
        video, denoised = t2v.sample_shift_multi_windows(
            self.model, pick_prompt(p, self.seed, r), num_windows_f=p["num_windows_f"],
            num_windows_h=p["num_windows_h"], num_windows_w=p["num_windows_w"], height=p["height"], width=p["width"], frames=p["frames"], fps=p["fps"],
            guidance_scale=p["guidance"], num_inference_steps=p["num_inference_steps"], loop_step=p["loop_step"],
            merge_renoised_overlap_latent_ratio=p["renoise_ratio"], overlap_mode=p["overlap_mode"],
            unet_microbatch=p["unet_microbatch"], noise_fn=inputs.Noise(self.seed, r, self.device),
            decode=p["decode"])
        return self.sample_frames(r, video, denoised)

    def sample_frames(self, r: int, video, denoised):
        """What the check keeps of a finished request: a seeded sample of
        its video frames and their denoised latents."""
        if video is None:
            return None
        g = torch.Generator().manual_seed(inputs.derive_seed(self.seed, "frames", r))
        frames = sorted(torch.randperm(video.shape[1], generator=g)[:self.p["check_frames"]].tolist())
        return {"request": r, "frames": frames, "video": video[:, frames].clone(),
                "denoised": denoised[:, frames].clone()}

    @staticmethod
    def keep(outputs):
        done = [o for o in outputs if o is not None]
        return done[0] if done else None


def check(spec, ref, captured: dict, output, seed: int, low=None) -> dict:
    """The cell's numbers (see the module docstring); with ``low`` the
    control takes the program's place, from the first step's state."""
    vs = vae_scale(spec)
    p = dict(spec.mix, vs=vs)
    dev = ref.device
    S = p["num_inference_steps"]
    sched = pipeline.Schedule(S, spec.config["model"]["diffusion"], dev)
    noise = inputs.Noise(seed, 0, dev)
    shape = (1, p["frames"] * p["num_windows_f"], p["height"] // vs * p["num_windows_h"],
             p["width"] // vs * p["num_windows_w"], spec.config["model"]["unet"]["in_channels"])
    init = noise("init", shape)
    prompt = pick_prompt(p, seed, 0)
    cond = pipeline.Conditioner(ref.mods, ref.tokenizer, spec.config["model"])

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
        step, index = 0, S - 1
        t = int(sched.timesteps[index])
        state = {"latent": prog_init, "denoised": torch.zeros_like(prog_init)}
        kept = {}

        def low_eps(x, ids):
            n = len(ids)
            ctx = torch.cat([low_cond.context([prompt]).expand(n, -1, -1), low_cond.uncond(None).expand(n, -1, -1)])
            kept["eps"] = low.unet(x, t, ctx, p["fps"], p["unet_microbatch"])
            return kept["eps"]
        out_l, out_d, _ = pipeline.planar_step(sched, state, noise, low_eps, p, step, index, step == S - 1,
                                               pipeline.grid_origins(step, p), low.round_state)
        prog_eps, prog_out = kept["eps"], (out_l, out_d)
        frames = [0, shape[1] - 1]
        video = {"frames": frames, "denoised": out_d[:, frames],
                 "video": torch.stack([low.round_state(low.mods["vae"].decode(out_d[0, f:f + 1]))[0]
                                       for f in frames])[None]}

    numbers = {"init": max_abs(prog_init, init)}
    numbers.update(step_numbers(
        ref, lambda eps_fn: pipeline.planar_step(sched, state, noise, eps_fn, p, step, index, step == S - 1,
                                                 pipeline.grid_origins(step, p)),
        state, prog_eps, prog_out,
        lambda pick: torch.cat([cond.context([prompt]).expand(len(pick), -1, -1),
                                cond.uncond(None).expand(len(pick), -1, -1)]),
        t, p, seed, p["check_windows"]))
    if p["decode"]:
        want = torch.cat([ref.mods["vae"].decode(video["denoised"][0, i:i + 1].float())
                          for i in range(len(video["frames"]))])
        numbers["video"] = rel_l2(video["video"][0].float(), want)
    return numbers
