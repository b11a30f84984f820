"""Planar shift-window denoising engine (PyTorch).

Counterpart of ``dynamicscaler_tpu/pipelines/planar.py``: one DDIM step
over N overlapping ring windows gathers the windows from the global latent
as a batch, runs the UNet once on the ``2N`` CFG-packed batch and scatters
the results back (``pipelines/window_step.py`` runs the step; this module
is its ring geometry). Overlap modes:

* ``last`` (default): windows read the step-start snapshot; the
  order-dependent blends use earlier-window coverage masks and the scatter
  is ordered (last write wins);
* ``average``: weighted scatter-average over overlaps, order-free;
* ``sequential``: exact reference ordering, window k+1 reads window k's
  writes (N UNet calls per step, whole on every rank of a ``mesh``).

The global latent and the denoised buffer are updated IN PLACE each step
(the JAX engine donates them instead). The trace cache and warm-only paths
of the JAX engine are not ported. Every re-noise draw can be injected
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

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamicscaler_tpu_torch.ops.blend import normalize_accumulated
from dynamicscaler_tpu_torch.ops.ddim import DDIMSchedule, draw_noise
from dynamicscaler_tpu_torch.ops.ring import add_ring_window, get_ring_window, set_ring_window
from dynamicscaler_tpu_torch.pipelines.window_step import check_overlap_mode, join, window_step
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


def step_plan(sched, steps_eff: int, origins_of, context_of, renoise_ratio, merge_prev_list):
    """StepPlans of the last ``steps_eff`` DDIM steps; ``origins_of(i)`` and
    ``context_of(i, origins)`` -> (context, ctx_idx) give each step's windows
    and conditioning."""
    ddim_ts = sched.ddim_timesteps.cpu().numpy()
    plan = []
    for i in range(steps_eff):
        index = steps_eff - 1 - i
        origins = origins_of(i)
        context, ctx_idx = context_of(i, origins)
        last = i == steps_eff - 1
        plan.append(StepPlan(
            t=int(ddim_ts[index]), index=index, origins=np.asarray(origins, np.int64),
            context=context, ctx_idx=ctx_idx,
            renoise_ratio=None if last or renoise_ratio is None else float(renoise_ratio),
            merge_prev_ratio=None if last or merge_prev_list is None else float(merge_prev_list[i]),
        ))
    return plan


class PlanarShiftWindowEngine:
    def __init__(self, model, schedule: DDIMSchedule, window_sizes: Tuple[int, int, int],
                 guidance_scale: float = 7.5, fps: int = 16, overlap_mode: str = "last",
                 unet_microbatch: int = 8, mesh=None, concat: Optional[torch.Tensor] = None,
                 guidance_rescale: float = 0.0):
        check_overlap_mode(overlap_mode)
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

    def _joined(self, x, origins):
        """The UNet rows ``x`` (the windows at ``origins``, then again as
        uncond rows) with each window's crop of the concat latent joined;
        ``x`` itself without one."""
        if self.concat is None:
            return x
        f, h, w = self.window_sizes
        return join(x, lambda: torch.cat([get_ring_window(self.concat, (0, int(h0), int(w0)), (1, h, w))
                                          for _, h0, w0 in origins]).expand(-1, f, -1, -1, -1))

    def step(self, latent, denoised, sp: StepPlan, uncond_context, generator=None, noise_fn=None,
             name: str = "renoise"):
        """One DDIM step over all windows of ``sp``; updates ``latent`` and
        ``denoised`` in place."""
        origins = [tuple(int(v) for v in o) for o in np.asarray(sp.origins)]
        with span("step", latent.device, windows=len(origins)):
            window_step(self, _RingWindows(self, latent, denoised, sp, origins, generator, noise_fn, name), sp,
                        uncond_context)


class _RingWindows:
    """The ring windows of one planar step: masked by the earlier windows'
    coverage (not under ``average``), scattered in order (the last write
    wins) or accumulated and normalised (``average``); a ``sequential``
    window reads the latent as the windows before it wrote it."""

    def __init__(self, engine, latent, denoised, sp, origins, generator, noise_fn, name):
        self.engine, self.latent, self.denoised, self.sp, self.origins = engine, latent, denoised, sp, origins
        self.generator, self.noise_fn, self.name = generator, noise_fn, name
        self.n, self.masked, self.microbatch = len(origins), engine.overlap_mode != "average", engine.unet_microbatch
        self.ctx = self.cov = None  # set in sequential mode

    def begin(self):
        with span("step.renoise"):
            self.ctx = self._contexts()
        self.cov = torch.zeros_like(self.latent)

    def _contexts(self):
        """The step's [n, L, D] window contexts: its rows of the bank, or
        its contexts repeated over the windows."""
        ctx, idx = self.sp.context, self.sp.ctx_idx
        if idx is not None:
            return ctx[torch.as_tensor(np.asarray(idx), dtype=torch.long, device=ctx.device)]
        return ctx if ctx.shape[0] == self.n else ctx.repeat(self.n // ctx.shape[0], 1, 1)

    def gather(self, rows):
        return torch.cat([get_ring_window(self.latent, o, self.engine.window_sizes) for o in self.origins[rows]])

    def masks(self, rows):
        if self.cov is None:
            return device_earlier_masks(self.origins, self.engine.window_sizes, self.latent)
        return get_ring_window(self.cov, self.origins[rows.start], self.engine.window_sizes)

    def contexts(self, rows):
        return (self._contexts() if self.ctx is None else self.ctx)[rows]

    def noise(self, shape, rows):
        name = self.name if self.cov is None else f"{self.name}:{rows.start}"
        return draw_noise(shape, self.latent.device, self.generator, self.noise_fn, name)

    def joined(self, x, rows):
        return self.engine._joined(x, self.origins[rows])

    def to_set(self, new, den):
        return new, den

    def scatter(self, rows, new, den):
        latent, denoised, origins = self.latent, self.denoised, self.origins[rows]
        if self.engine.overlap_mode == "average":
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
            if self.cov is not None:  # the window's footprint, which the later windows' masks read
                set_ring_window(self.cov, torch.ones_like(new[k:k + 1]), origin)
