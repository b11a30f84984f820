"""One DDIM step of a window sampler, over any window geometry (PyTorch).

The planar engine (``pipelines/planar.py``, ring windows) and the sphere
sampler (``pipelines/sphere.py``, views of an equirect latent) both step
through :func:`window_step`: gather, earlier-window masks, re-noise, CFG
pack, concat join, UNet, CFG combine and DDIM update, merge with the
previous latent, scatter; each under its ``step.*`` span. The windows go
as one batch (``last``, ``average``; split over the ranks of a ``mesh``)
or one at a time, each reading the writes of those before it
(``sequential``, whole on every rank). The geometry is a per-step object:
``n`` windows, ``microbatch`` UNet rows a call, ``masked`` (no masks: no
re-noise and no merge), ``begin()`` before the first window of a
sequential step, and ``gather``, ``masks``, ``contexts``, ``noise``,
``joined``, ``to_set`` and ``scatter`` of a slice ``rows`` of its windows.
"""

from __future__ import annotations

import contextlib

import torch

from dynamicscaler_tpu_torch.ops.blend import mix_with_mask
from dynamicscaler_tpu_torch.ops.ddim import ddim_step, guided, re_noise
from dynamicscaler_tpu_torch.utils.timing import span


def check_overlap_mode(mode: str) -> None:
    if mode not in ("last", "average", "sequential"):
        raise ValueError(f"overlap_mode {mode!r}")


def cfg_pack(wins, ctx, uncond, guidance):
    """The UNet batch and its contexts: cond rows then uncond rows; the
    rows alone at guidance 1."""
    if guidance == 1.0:
        return wins, ctx
    n = wins.shape[0]
    return torch.cat([wins, wins]), torch.cat([ctx, uncond.expand((n,) + tuple(uncond.shape[1:]))])


def cfg_update(sched, wins, eps, index, guidance, rescale):
    """The CFG combine of the model's output ``eps`` (with the guidance
    rescale) and the DDIM step of ``wins`` at table index ``index`` ->
    (x_prev, pred_x0); a ``step.rescale`` span where either the rescale or
    a v conversion runs. The frame index is a host tensor."""
    n = wins.shape[0]
    frame_idx = torch.full((wins.shape[1],), index, dtype=torch.long)
    converts = rescale or sched.parameterization == "v"
    with span("step.rescale", rows=n) if converts else contextlib.nullcontext():
        if guidance != 1.0:
            eps = guided(eps[:n], eps[n:], guidance, rescale)
        return ddim_step(sched, wins, eps, frame_idx)


def renoise(sched, wins, index, ratio, mask, draw):
    """``wins`` re-noised from DDIM step ``index - 1`` to ``index`` with
    the noise ``draw(shape)``, mixed in by ``ratio`` where ``mask`` is set;
    a 0 ratio is the identity and draws no noise."""
    if ratio == 0.0:
        return wins
    noised = re_noise(sched, wins, max(index - 1, 0), index, noise=draw(wins.shape))
    return mix_with_mask(wins, noised, mask, ratio)


def join(x, crops):
    """The UNet rows ``x`` with ``crops()`` [windows, f, h, w, c] joined
    after their channels, repeated over the CFG rows; a ``step.concat``
    span."""
    with span("step.concat", rows=x.shape[0]):
        c = crops()
        return torch.cat([x, c.repeat(x.shape[0] // c.shape[0], 1, 1, 1, 1)], dim=-1)


def window_step(sampler, geom, sp, uncond):
    """One DDIM step of ``sampler`` over the windows of ``geom`` at the
    step ``sp`` (``t``, ``index``, ``renoise_ratio``, ``merge_prev_ratio``);
    ``uncond`` [1, L, D] the uncond context."""
    seq = sampler.overlap_mode == "sequential"
    if seq:
        geom.begin()
    for rows in [slice(k, k + 1) for k in range(geom.n)] if seq else [slice(None)]:
        with span("step.gather"):
            wins = geom.gather(rows)
        masks = None
        if geom.masked:
            with span("step.masks"):
                masks = geom.masks(rows)
        prev = wins
        with span("step.renoise"):
            if masks is not None:
                wins = renoise(sampler.schedule, wins, sp.index, sp.renoise_ratio or 0.0, masks,
                               lambda shape: geom.noise(shape, rows))
            x, ctx = cfg_pack(wins, geom.contexts(rows), uncond[:1] if seq else uncond, sampler.guidance_scale)
        x = geom.joined(x, rows)
        eps = sampler.model.apply_unet_microbatched(x, sp.t, ctx, sampler.fps, geom.microbatch,
                                                    None if seq else sampler.mesh)
        with span("step.update"):
            new, den = cfg_update(sampler.schedule, wins, eps, sp.index, sampler.guidance_scale,
                                  sampler.guidance_rescale)
            if masks is not None:
                new = mix_with_mask(new, prev, masks, sp.merge_prev_ratio or 0.0)
            new, den = geom.to_set(new, den)
        with span("step.scatter"):
            geom.scatter(rows, new, den)
