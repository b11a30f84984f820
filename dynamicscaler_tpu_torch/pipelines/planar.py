"""Planar shift-window denoising engine (PyTorch).

Counterpart of ``dynamicscaler_tpu/pipelines/planar.py``: one DDIM step
over N overlapping ring windows gathers the windows from the global latent
as a batch, runs the UNet once on the ``2N`` CFG-packed batch and scatters
the results back. Overlap modes:

* ``last`` (default): windows read the step-start snapshot; the
  order-dependent blends use earlier-window coverage masks and the scatter
  is ordered (last write wins);
* ``average``: weighted scatter-average over overlaps, order-free;
* ``sequential``: exact reference ordering, window k+1 reads window k's
  writes (N UNet calls per step).

With a ``mesh`` (``parallel.mesh``) the ``last`` and ``average`` modes split
each step's CFG-packed batch over the ranks and gather the eps; every rank
then blends and scatters the whole batch, so all hold the same latent. The
``sequential`` mode has one window a UNet call and its order is the point:
every rank runs it whole, as one card does. The global latent and the
denoised buffer are updated IN PLACE each step (the JAX engine donates them
instead). The trace cache and warm-only paths of the JAX engine are not
ported. Every re-noise draw can be injected
through ``noise_fn`` under the name ``renoise:{step}`` (``renoise:{step}:{k}``
per window in ``sequential`` mode).

A model with hybrid conditioning (DynamiCrafter) takes ``concat``, the
clean latent of the whole panorama [1, 1, H, W, c]: each UNet row gets its
window's crop of it, cut at the window's (h0, w0) with the same ring wrap
as the noisy gather and repeated over the frames, joined after the noisy
channels (cond and uncond rows alike). Re-noise, DDIM and the scatter touch
the noisy channels only. ``guidance_rescale`` rescales the guided output
(``ops.ddim.guided``); a v-parameterised schedule converts it in the DDIM
step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamicscaler_tpu_torch.ops.blend import mix_with_mask, normalize_accumulated
from dynamicscaler_tpu_torch.ops.ddim import DDIMSchedule, ddim_step, draw_noise, guided, re_noise
from dynamicscaler_tpu_torch.ops.ring import add_ring_window, get_ring_window, set_ring_window
from dynamicscaler_tpu_torch.utils.timing import LoopStats, Marker, report, span

# steady s/step of the most recent run() loop, read by cli/gen_pano_360.py
LOOP_STATS = LoopStats()


def earlier_coverage_masks(origins: Sequence[Tuple[int, int, int]], sizes: Tuple[int, int, int],
                           dims: Tuple[int, int, int], device="cuda") -> torch.Tensor:
    """masks[k] = 1 where windows before k in this step covered window k's
    footprint (the reference's within-step ``denoised_mask`` as window k
    sees it, i2v_sphere_panorama_pipeline.py:858-871), every axis wrapping
    around the latent's ``dims`` (F, H, W): :func:`device_earlier_masks` on
    a latent of those dims. Returns [N, f, h, w, 1] float32 on ``device``:
    the card unless the caller asks for the CPU."""
    return device_earlier_masks(origins, sizes, torch.zeros((1, *dims, 1), device=device))


def device_earlier_masks(origins, sizes, latent) -> torch.Tensor:
    """masks[k] = 1 where window k's footprint was already covered by
    windows < k in this step (the reference's within-step denoised mask),
    built on the latent's device -> [N, f, h, w, 1]."""
    fs, hs, ws = sizes
    cov = torch.zeros(latent.shape[:-1] + (1,), dtype=torch.float32, device=latent.device)
    ones = torch.ones((1, fs, hs, ws, 1), dtype=torch.float32, device=latent.device)
    masks = []
    for origin in origins:
        masks.append(get_ring_window(cov, tuple(origin), sizes)[0])
        set_ring_window(cov, ones, tuple(origin))
    return torch.stack(masks)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Host-precomputed data for one DDIM step of the window loop."""

    t: int  # DDPM timestep fed to the UNet
    index: int  # DDIM table index (total_steps - i - 1)
    origins: np.ndarray  # [N, 3] (f0, h0, w0)
    context: torch.Tensor  # [N_base, L, D], N_base divides N; or a bank (ctx_idx)
    renoise_ratio: Optional[float]
    merge_prev_ratio: Optional[float]
    # [N] rows of ``context`` (an all-phases context bank) that the windows take
    ctx_idx: Optional[np.ndarray] = None


class PlanarShiftWindowEngine:
    def __init__(self, model, schedule: DDIMSchedule, window_sizes: Tuple[int, int, int],
                 guidance_scale: float = 7.5, fps: int = 16, overlap_mode: str = "last",
                 unet_microbatch: int = 8, mesh=None, concat: Optional[torch.Tensor] = None,
                 guidance_rescale: float = 0.0):
        if overlap_mode not in ("last", "average", "sequential"):
            raise ValueError(f"overlap_mode {overlap_mode!r}")
        want = model.config.unet.concat_channels
        have = 0 if concat is None else concat.shape[-1]
        if have != want:
            raise ValueError(f"the UNet joins {want} latent channels to its input, the engine was given {have}")
        self.model = model
        self.schedule = schedule
        self.window_sizes = window_sizes
        self.guidance_scale = guidance_scale
        self.fps = fps
        self.overlap_mode = overlap_mode
        self.unet_microbatch = unet_microbatch
        self.mesh = mesh
        self.concat = concat
        self.guidance_rescale = guidance_rescale

    def run(self, latent: torch.Tensor, plan: Sequence[StepPlan], uncond_context: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            pre_step: Optional[Callable] = None, noise_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full window-denoise loop over ``plan``. Returns
        ``(latent, denoised)``; the caller's ``latent`` is not modified.
        ``pre_step(latent, i)`` may replace the latent before step i."""
        latent = latent.clone()
        denoised = torch.zeros_like(latent)
        tm = Marker("planar")
        LOOP_STATS.start(len(plan))
        for i, sp in enumerate(plan):
            if pre_step is not None:
                latent = pre_step(latent, i)
            self.step(latent, denoised, sp, uncond_context, generator, noise_fn, f"renoise:{i}")
            tm.lap(f"step {i}/{len(plan)} N={len(sp.origins)}")
            if i == 0:
                LOOP_STATS.mark_first(latent)
        LOOP_STATS.finish(latent)
        report()
        return latent, denoised

    def _cfg_pack(self, wins, ctx, uncond):
        """The UNet batch and its contexts: cond rows then uncond rows."""
        if self.guidance_scale == 1.0:
            return wins, ctx
        n = wins.shape[0]
        return torch.cat([wins, wins]), torch.cat([ctx, uncond.expand((n,) + tuple(uncond.shape[1:]))])

    def _joined(self, x, origins):
        """The UNet rows ``x`` (the windows at ``origins``, then again as
        uncond rows) with each window's crop of the concat latent joined;
        ``x`` itself without one."""
        if self.concat is None:
            return x
        f, h, w = self.window_sizes
        with span("step.concat", rows=x.shape[0]):
            crops = torch.cat([get_ring_window(self.concat, (0, int(h0), int(w0)), (1, h, w))
                               for _, h0, w0 in origins]).expand(-1, f, -1, -1, -1)
            return torch.cat([x, crops.repeat(x.shape[0] // crops.shape[0], 1, 1, 1, 1)], dim=-1)

    def _cfg_update(self, wins, eps, sp: StepPlan):
        """The CFG combine of the model's output ``eps`` (with the guidance
        rescale) and the DDIM step of ``wins`` -> (x_prev, pred_x0); a
        ``step.rescale`` span where either the rescale or a v conversion
        runs."""
        g = self.guidance_scale
        n = wins.shape[0]
        frame_idx = torch.full((self.window_sizes[0],), sp.index, dtype=torch.long)
        converts = self.guidance_rescale or self.schedule.parameterization == "v"
        with span("step.rescale", rows=n) if converts else contextlib.nullcontext():
            if g != 1.0:
                eps = guided(eps[:n], eps[n:], g, self.guidance_rescale)
            return ddim_step(self.schedule, wins, eps, frame_idx)

    def _renoise(self, wins, sp: StepPlan, generator, noise_fn, name):
        ratio = sp.renoise_ratio or 0.0
        if ratio == 0.0:  # a 0-ratio mix is the identity: draw no noise
            return wins, ratio
        noise = draw_noise(wins.shape, wins.device, generator, noise_fn, name)
        return re_noise(self.schedule, wins, max(sp.index - 1, 0), sp.index, noise=noise), ratio

    @staticmethod
    def _contexts(sp: StepPlan, n: int):
        """The step's [n, L, D] window contexts: its rows of the bank, or
        its contexts repeated over the windows."""
        ctx = sp.context
        if sp.ctx_idx is not None:
            return ctx[torch.as_tensor(np.asarray(sp.ctx_idx), dtype=torch.long, device=ctx.device)]
        if ctx.shape[0] != n:
            return ctx.repeat(n // ctx.shape[0], 1, 1)
        return ctx

    def step(self, latent, denoised, sp: StepPlan, uncond_context, generator=None, noise_fn=None,
             name: str = "renoise"):
        """One DDIM step over all windows of ``sp``; updates ``latent`` and
        ``denoised`` in place."""
        origins = [tuple(int(v) for v in o) for o in np.asarray(sp.origins)]
        with span("step", latent.device, windows=len(origins)):
            if self.overlap_mode == "sequential":
                self._step_sequential(latent, denoised, sp, origins, uncond_context, generator, noise_fn, name)
            else:
                self._step_batched(latent, denoised, sp, origins, uncond_context, generator, noise_fn, name)

    def _step_sequential(self, latent, denoised, sp: StepPlan, origins, uncond_context, generator, noise_fn,
                         name):
        sizes = self.window_sizes
        merge_ratio = sp.merge_prev_ratio or 0.0
        with span("step.renoise"):
            ctx = self._contexts(sp, len(origins))
        mask_global = torch.zeros_like(latent)
        for k, origin in enumerate(origins):
            with span("step.gather"):
                win = get_ring_window(latent, origin, sizes)
            with span("step.masks"):
                mask_win = get_ring_window(mask_global, origin, sizes)
            prev = win
            with span("step.renoise"):
                noised, ratio = self._renoise(win, sp, generator, noise_fn, f"{name}:{k}")
                win = mix_with_mask(win, noised, mask_win, ratio)
                x, cc = self._cfg_pack(win, ctx[k:k + 1], uncond_context)
            x = self._joined(x, [origin])
            eps = self.model.apply_unet_microbatched(x, sp.t, cc, self.fps, self.unet_microbatch)
            with span("step.update"):
                new, den_w = self._cfg_update(win, eps, sp)
                new = mix_with_mask(new, prev, mask_win, merge_ratio)
            with span("step.scatter"):
                set_ring_window(latent, new, origin)
                set_ring_window(denoised, den_w, origin)
                set_ring_window(mask_global, torch.ones_like(new), origin)

    def _step_batched(self, latent, denoised, sp: StepPlan, origins, uncond_context, generator, noise_fn, name):
        sizes = self.window_sizes
        merge_ratio = sp.merge_prev_ratio or 0.0
        with span("step.gather"):
            wins = torch.cat([get_ring_window(latent, o, sizes) for o in origins])
        prev = wins
        earlier = None
        if self.overlap_mode == "last":
            with span("step.masks"):
                earlier = device_earlier_masks(origins, sizes, latent)
        with span("step.renoise"):
            if self.overlap_mode == "last":
                noised, ratio = self._renoise(wins, sp, generator, noise_fn, name)
                wins = mix_with_mask(wins, noised, earlier, ratio)
            x, cc = self._cfg_pack(wins, self._contexts(sp, len(origins)), uncond_context)
        x = self._joined(x, origins)
        eps = self.model.apply_unet_microbatched(x, sp.t, cc, self.fps, self.unet_microbatch, self.mesh)
        with span("step.update"):
            new, den = self._cfg_update(wins, eps, sp)
            if self.overlap_mode != "average":
                new = mix_with_mask(new, prev, earlier, merge_ratio)

        with span("step.scatter"):
            if self.overlap_mode == "average":
                accum = torch.zeros_like(latent)
                count = torch.zeros(latent.shape[:-1] + (1,), dtype=latent.dtype, device=latent.device)
                dac = torch.zeros_like(latent)
                for k, origin in enumerate(origins):
                    add_ring_window(accum, new[k:k + 1], origin)
                    add_ring_window(count, torch.ones_like(new[k:k + 1, ..., :1]), origin)
                    add_ring_window(dac, den[k:k + 1], origin)
                latent.copy_(normalize_accumulated(accum, count, latent))
                denoised.copy_(normalize_accumulated(dac, count, denoised))
                return
            for k, origin in enumerate(origins):  # ordered scatter, last write wins
                set_ring_window(latent, new[k:k + 1], origin)
                set_ring_window(denoised, den[k:k + 1], origin)
