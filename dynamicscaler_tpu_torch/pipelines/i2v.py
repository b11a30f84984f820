"""Image-to-video planar shift-window samplers (PyTorch).

Counterpart of ``dynamicscaler_tpu/pipelines/i2v.py``: the stage-2 (1x) and
stage-3 (2x upscale) sampler of the 360-degree pipeline
(``VC2_Pipeline_I2V_SpherePano.basic_sample_shift_multi_windows``,
i2v_sphere_panorama_pipeline.py:565-998), its integer-grid variant
(i2v_normal_pipeline.py:69-426) and single-window ``basic_sample``:

* a window grid with fractional overlap derived from the total size, cyclic
  per-step offsets, frame ring windows with docking;
* per-window conditioning = text (multi-prompt by window height) + the
  Resampler tokens of the matching wrap-around crop of the panorama image.
  Window offsets cycle with ``loop_step``, so every phase's conditioning is
  one batched text encode and one batched image encode up front, and each
  step takes its rows of that bank (``StepPlan.ctx_idx``);
* optional skip-time init from the tiled VAE encode of the image;
* the ring-aware wrap-padded VAE decode.

A model with hybrid conditioning (DynamiCrafter, ``unet.concat_channels``)
also takes the image latent joined to its input: the tiled VAE encode of
the whole panorama, made once a request (the skip-time init reuses it), of
which every window row takes its crop (``PlanarShiftWindowEngine``'s
``concat``); where DynamiCrafter encodes the conditioning image itself,
the windows here take the crop of the panorama's encode, which differs
within the encoder's receptive field of the crop's edges. The single-window
``basic_sample`` joins the conditioning image's own encode. The ring decode
goes frame by frame, as DynamiCrafter's ``perframe_ae``.

Every noise draw takes ``noise_fn`` when given (``ops.ddim.draw_noise``;
names ``init``, ``skip`` and the engine's ``renoise:*``), else the
``generator``. ``mesh`` (``parallel.mesh``) splits each step's window batch
over its ranks. The JAX package's conditioning memo, step timers and
warm-only paths are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamicscaler_tpu_torch.core.windows import IntegerGrid, PlanarGrid, frame_window_origins
from dynamicscaler_tpu_torch.ops.ddim import draw_noise, re_noise, re_noise_per_frame
from dynamicscaler_tpu_torch.pipelines.conditioning import (
    build_uncond_context,
    cat_text_image,
    encode_texts_cached,
    select_prompt_by_factor,
)
from dynamicscaler_tpu_torch.pipelines.planar import PlanarShiftWindowEngine, step_plan
from dynamicscaler_tpu_torch.pipelines.t2v import basic_sample_loop, make_schedule_for_model
from dynamicscaler_tpu_torch.pipelines.tiled_vae import ring_aware_decode, tiled_vae_encode
from dynamicscaler_tpu_torch.utils.timing import Marker, request, span


def ring_crop_image(image: np.ndarray, top: int, left: int, h: int, w: int) -> np.ndarray:
    """Wrap-around crop of a [H, W, 3] image (RingImageTensor semantics,
    shift_window_utils.py:232-265)."""
    H, W = image.shape[:2]
    return image[np.ix_((np.arange(h) + top) % H, (np.arange(w) + left) % W)]


def _host_image(image) -> np.ndarray:
    if torch.is_tensor(image):
        image = image.detach().cpu().numpy()
    return np.asarray(image, np.float32)


def window_image_contexts(model, origins_hw, pano_image: np.ndarray, prompt: str,
                          window_multi_prompt_dict, view_height: int, view_width: int,
                          total_h_img: int, text_cache: dict) -> torch.Tensor:
    """[N, L, D] context for latent window origins (h0, w0): text (chosen
    by the window's lower edge with ``window_multi_prompt_dict``) + the
    Resampler tokens of the wrap-around image crop of each window, in one
    text encode (unique prompts) and one image encode."""
    vs = model.config.vae.spatial_scale
    corners = [(h0 * vs, w0 * vs) for h0, w0 in origins_hw]
    prompts = [select_prompt_by_factor(window_multi_prompt_dict, min(1.0, (top + view_height) / total_h_img))
               if window_multi_prompt_dict else prompt for top, _ in corners]
    with span("request.text", prompts=len(set(prompts))):
        text_embs = encode_texts_cached(model, prompts, text_cache)
    if model.image_encoder is None:  # t2v bundle on the planar grid: text only
        return text_embs
    with span("request.image", crops=len(corners), tokens=len(corners) * model.config.resampler.tokens):
        crops = np.stack([ring_crop_image(pano_image, top, left, view_height, view_width) for top, left in corners])
        return cat_text_image(text_embs, model.encode_image_cond(crops))


def _phase_contexts(model, grid: PlanarGrid, pano_image, prompt, window_multi_prompt_dict,
                    view_height, view_width, text_cache) -> Tuple[torch.Tensor, List[np.ndarray]]:
    """The all-phases context bank [V, L, D] and, per phase, the rows of its
    windows: every phase's windows in one batched encode."""
    per_phase = [grid.step_origins(p) for p in range(grid.loop_step)]
    bank = window_image_contexts(
        model, [o for origins in per_phase for o in origins], pano_image, prompt,
        window_multi_prompt_dict, view_height, view_width,
        grid.total_h * model.config.vae.spatial_scale, text_cache,
    )
    starts = np.cumsum([0] + [len(o) for o in per_phase])
    return bank, [np.arange(starts[p], starts[p + 1]) for p in range(grid.loop_step)]


def _init_latent(model, sched, shape, pano_image, use_skip_time: bool, skip: int,
                 progressive_skip: bool, generator, noise_fn, static=None) -> torch.Tensor:
    """Pure noise, or with ``use_skip_time`` the tiled VAE encode of the
    image (``static`` where the caller has it) repeated over the frames and
    re-noised: to the last DDIM step for every frame, or with
    ``progressive_skip`` frame f < skip to step S - skip + f (the other
    frames stay noise)."""
    dev = model.device
    S = sched.num_ddim_steps
    total_f = shape[1]
    latent = None
    if not use_skip_time or progressive_skip:
        latent = draw_noise(shape, dev, generator, noise_fn, "init")
    if not use_skip_time:
        return latent
    clean = (tiled_vae_encode(model, pano_image) if static is None else static).repeat(1, total_f, 1, 1, 1)
    noise = draw_noise(clean.shape, dev, generator, noise_fn, "skip")
    if not progressive_skip:
        return re_noise(sched, clean, 0, S - 1, noise=noise)
    steps_b = np.full((total_f,), S - 1, np.int64)
    for frame_idx, pskip in enumerate(reversed(range(skip))):
        steps_b[frame_idx] = S - pskip - 1
    noised = re_noise_per_frame(sched, clean, torch.from_numpy(steps_b), noise=noise)
    sel = (torch.arange(total_f, device=dev) < skip)[None, :, None, None, None]
    return torch.where(sel, noised, latent)


def concat_latent(model, image) -> Optional[torch.Tensor]:
    """The latent a hybrid-conditioned model joins to its input: the tiled
    VAE encode of ``image`` [H, W, 3] -> [1, 1, H/vs, W/vs, c]; None for a
    model without."""
    if not model.config.unet.concat_channels:
        return None
    return tiled_vae_encode(model, image)


def basic_sample(model, prompt: str, cond_image, height: int = 320, width: int = 512,
                 frames: int = 16, fps: int = 16, guidance_scale: float = 7.5,
                 num_inference_steps: int = 48, generator: Optional[torch.Generator] = None,
                 latents=None, decode: bool = True, noise_fn=None, guidance_rescale: float = 0.0):
    """Single-window i2v generation, the batch-eval i2v path
    (scripts/evaluation/inference.py:107-122): context = [text ; image
    tokens of ``cond_image`` [H, W, 3] in [-1, 1]], uncond = [empty text ;
    zero-image tokens at the image's size]; a hybrid-conditioned model also
    joins the image's encode, repeated over the frames, to both rows
    (DynamiCrafter's ``image_guided_synthesis``). Returns (video or None,
    denoised latent [1, F, h, w, C])."""
    sched = make_schedule_for_model(model, num_inference_steps)
    vs = model.config.vae.spatial_scale
    cond_image = _host_image(cond_image)
    context = cat_text_image(model.encode_text([prompt]), model.encode_image_cond(cond_image[None]))
    uncond = build_uncond_context(model, with_image=True, image_hw=cond_image.shape[:2])
    if latents is None:
        latents = draw_noise((1, frames, height // vs, width // vs, model.config.unet.out_channels),
                             model.device, generator, noise_fn, "init")
    latents = torch.as_tensor(latents, dtype=torch.float32, device=model.device)
    concat = None
    if model.config.unet.concat_channels:
        concat = model.encode_video(torch.as_tensor(cond_image, device=model.device)[None, None])
        concat = concat.expand(-1, latents.shape[1], -1, -1, -1)
    _, den = basic_sample_loop(model, sched, latents, context, uncond, guidance_scale, fps, concat=concat,
                               guidance_rescale=guidance_rescale)
    video = model.decode_video(den) if decode else None
    return video, den


@request
def sample_shift_multi_windows(
    model,
    prompt: str,
    pano_image,  # [total_h, total_w, 3] in [-1, 1]
    total_w: int,
    total_h: int,
    total_f: int,
    num_windows_w: int,
    num_windows_h: int,
    loop_step: int,
    height: int = 320,
    width: int = 512,
    frames: int = 16,
    fps: int = 16,
    guidance_scale: float = 7.5,
    num_inference_steps: int = 48,
    begin_index_offset: int = 0,
    dock_at_f: bool = False,
    overlap_ratio_list_f: Optional[Sequence[float]] = None,
    loop_step_frame: Optional[int] = None,
    merge_renoised_overlap_latent_ratio: Optional[float] = 1.0,
    merge_prev_denoised_ratio_list: Optional[Sequence[float]] = None,
    window_multi_prompt_dict: Optional[Dict[float, str]] = None,
    init_panorama_latent=None,
    use_skip_time: bool = False,
    skip_time_step_idx: Optional[int] = None,
    progressive_skip: bool = False,
    overlap_mode: str = "last",
    unet_microbatch: int = 8,
    generator: Optional[torch.Generator] = None,
    noise_fn=None,
    decode: bool = True,
    mesh=None,
    guidance_rescale: float = 0.0,
):
    """Planar ring multi-window i2v sampling. Sizes in image pixels
    (``total_*``); windows are the model's native ``height x width``.
    ``guidance_rescale`` as in ``ops.ddim.guided`` (DynamiCrafter's
    published sampling: 0.7). Returns (video [1, F, total_h, total_w, 3] or
    None, denoised latent [1, F, th, tw, C])."""
    sched = make_schedule_for_model(model, num_inference_steps)
    vs = model.config.vae.spatial_scale
    wh, ww = height // vs, width // vs
    th, tw = total_h // vs, total_w // vs
    grid = PlanarGrid(total_h=th, total_w=tw, win_h=wh, win_w=ww, num_windows_h=num_windows_h,
                      num_windows_w=num_windows_w, loop_step=loop_step, vae_scale=vs)
    pano_image = _host_image(pano_image)
    tm = Marker("i2v")
    bank, phase_ids = _phase_contexts(model, grid, pano_image, prompt, window_multi_prompt_dict,
                                      height, width, {})
    tm.mark("phase conditioning (CLIP)")
    uncond = build_uncond_context(model, with_image=model.image_encoder is not None, image_hw=(wh, ww))

    S = num_inference_steps
    skip = int(skip_time_step_idx or 0)
    static = concat_latent(model, pano_image)
    with span("request.init"):
        if init_panorama_latent is None:
            latent = _init_latent(model, sched, (1, total_f, th, tw, model.config.unet.out_channels),
                                  pano_image, use_skip_time, skip, progressive_skip, generator, noise_fn, static)
        else:
            latent = torch.as_tensor(init_panorama_latent, dtype=torch.float32, device=model.device)
    tm.mark("init latent")

    ratios_f = overlap_ratio_list_f if overlap_ratio_list_f is not None else [0.25] * S
    steps_eff = S - (skip if use_skip_time and not progressive_skip else 0)

    def origins_of(i):
        f_origins = frame_window_origins(i, total_f, frames, ratios_f[i], loop_step_frame, dock_at_f)
        return [(f0, h0, w0) for f0 in f_origins for (h0, w0) in grid.step_origins(i, begin_index_offset)]

    def context_of(i, origins):
        ids = phase_ids[(i + begin_index_offset) % loop_step]
        return bank, np.concatenate([ids] * (len(origins) // len(ids)))

    with span("request.plan", steps=steps_eff):
        plan = step_plan(sched, steps_eff, origins_of, context_of, merge_renoised_overlap_latent_ratio,
                         merge_prev_denoised_ratio_list)
    tm.mark("plan built")
    engine = PlanarShiftWindowEngine(model, sched, (frames, wh, ww), guidance_scale=guidance_scale,
                                     fps=fps, overlap_mode=overlap_mode, unet_microbatch=unet_microbatch,
                                     mesh=mesh, concat=static, guidance_rescale=guidance_rescale)
    latent, denoised = engine.run(latent, plan, uncond, generator, noise_fn=noise_fn)
    tm.mark("denoise loop")
    video = None
    if decode:
        # a >= 4K equirect frame decoded whole would not fit in memory: tile the ring
        with span("request.decode", frames=denoised.shape[1]):
            video = ring_aware_decode(model, denoised, w_tiles=max(1, tw // 256))
    tm.mark("ring decode")
    return video, denoised


def sample_shift_multi_windows_integer(
    model,
    prompt: str,
    pano_image,  # [num_h * height, num_w * width, 3] in [-1, 1]
    num_windows_w: int = 1,
    num_windows_h: int = 1,
    num_windows_f: int = 1,
    loop_step: Optional[int] = None,
    height: int = 320,
    width: int = 512,
    frames: int = 16,
    fps: int = 16,
    guidance_scale: float = 7.5,
    num_inference_steps: int = 48,
    dock_at_h: bool = False,
    merge_renoised_overlap_latent_ratio: float = 1.0,
    merge_prev_denoised_ratio_list=None,
    init_panorama_latent=None,
    use_skip_time: bool = False,
    skip_time_step_idx=None,
    progressive_skip: bool = False,
    overlap_mode: str = "last",
    unet_microbatch: int = 8,
    generator: Optional[torch.Generator] = None,
    noise_fn=None,
    decode: bool = True,
    mesh=None,
    guidance_rescale: float = 0.0,
):
    """Integer-grid i2v multi-window sampler (i2v_normal_pipeline.py:69-426,
    the ``cli/sample.py`` entry): total = window x num_windows per axis,
    whole-window step offsets, optional H docking, per-window image
    conditioning from the crops of ``pano_image`` (and their crops of its
    encode under hybrid conditioning)."""
    sched = make_schedule_for_model(model, num_inference_steps)
    vs = model.config.vae.spatial_scale
    wh, ww = height // vs, width // vs
    grid = IntegerGrid(win_f=frames, win_h=wh, win_w=ww, num_windows_f=num_windows_f,
                       num_windows_h=num_windows_h, num_windows_w=num_windows_w,
                       loop_step=loop_step or num_inference_steps, dock_at_h=dock_at_h)
    th, tw = grid.total_h, grid.total_w
    pano_image = _host_image(pano_image)
    if pano_image.shape[:2] != (th * vs, tw * vs):
        raise ValueError(f"pano image {pano_image.shape} != total {(th * vs, tw * vs)}")
    text_cache: dict = {}
    ctx_cache: dict = {}
    uncond = build_uncond_context(model, image_hw=(wh, ww))

    S = num_inference_steps
    skip = int(skip_time_step_idx or 0)
    static = concat_latent(model, pano_image)
    if init_panorama_latent is None:
        latent = _init_latent(model, sched, (1, grid.total_f, th, tw, model.config.unet.out_channels),
                              pano_image, use_skip_time, skip, progressive_skip, generator, noise_fn, static)
    else:
        latent = torch.as_tensor(init_panorama_latent, dtype=torch.float32, device=model.device)

    def context_of(i, origins):
        hw = tuple((h0, w0) for (_, h0, w0) in origins)
        if hw not in ctx_cache:
            ctx_cache[hw] = window_image_contexts(model, hw, pano_image, prompt, None, height, width,
                                                  th * vs, text_cache)
        return ctx_cache[hw], None

    steps_eff = S - (skip if use_skip_time and not progressive_skip else 0)
    plan = step_plan(sched, steps_eff, grid.step_origins, context_of,
                     merge_renoised_overlap_latent_ratio, merge_prev_denoised_ratio_list)
    engine = PlanarShiftWindowEngine(model, sched, (frames, wh, ww), guidance_scale=guidance_scale,
                                     fps=fps, overlap_mode=overlap_mode, unet_microbatch=unet_microbatch,
                                     mesh=mesh, concat=static, guidance_rescale=guidance_rescale)
    latent, denoised = engine.run(latent, plan, uncond, generator, noise_fn=noise_fn)
    video = ring_aware_decode(model, denoised, w_tiles=max(1, tw // 256)) if decode else None
    return video, denoised
