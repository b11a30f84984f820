"""DDIM / DDPM schedule math (PyTorch).

Counterpart of ``dynamicscaler_tpu/ops/ddim.py``: tables built in float64
numpy on the host and stored as float32 tensors in a :class:`DDIMSchedule`;
``ddim_step`` takes a per-frame DDIM index vector. A schedule made for a
v-parameterised model (DynamiCrafter: ``parameterization="v"``, betas
rescaled to a zero terminal SNR, trailing timesteps) converts the model's v
to eps and x0 in every step that takes it. Noise is explicit: pass
``noise=`` (tests inject the same numbers into both twins) or a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule table (float64), lvdm/models/utils_diffusion.py:31."""
    if schedule == "linear":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep, dtype=np.float64) ** 2
    if schedule == "cosine":
        ts = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(ts / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown")


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Betas whose last alphas_cumprod is 0 (Lin et al. 2023, "Common
    diffusion noise schedules and sample steps are flawed", Algorithm 1;
    DynamiCrafter lvdm/models/ddpm3d.py ``rescale_zero_terminal_snr``):
    sqrt(alphas_cumprod) shifted to end at 0 and scaled to keep its first
    value."""
    sqrt_acp = np.sqrt(np.cumprod(1.0 - betas, axis=0))
    first, last = sqrt_acp[0].copy(), sqrt_acp[-1].copy()
    sqrt_acp = (sqrt_acp - last) * (first / (first - last))
    acp = sqrt_acp ** 2
    return 1.0 - np.concatenate([acp[:1], acp[1:] / acp[:-1]])


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        discretize: str = "uniform") -> np.ndarray:
    """DDIM sub-schedule timestep selection (utils_diffusion.py:56), and
    DynamiCrafter's ``uniform_trailing``: every T / S-th timestep counted
    down from the last, so the first DDIM step is at T - 1."""
    if discretize == "uniform":
        return np.linspace(0, num_ddpm_timesteps - 1, num_ddim_timesteps).round().astype(np.int64)
    if discretize == "uniform_trailing":
        c = num_ddpm_timesteps / num_ddim_timesteps
        ts = np.flip(np.round(np.arange(num_ddpm_timesteps, 0, -c))).astype(np.int64) - 1
        if ts.shape[0] != num_ddim_timesteps:
            raise ValueError(f"uniform_trailing gives {ts.shape[0]} timesteps for {num_ddim_timesteps} steps")
        return ts
    if discretize == "quad":
        return (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2).astype(int) + 1
    raise NotImplementedError(f"ddim discretization '{discretize}' unknown")


def make_scale_arr(num_timesteps: int, scale_a: float = 1.0, scale_b: float = 0.3,
                   mid_step: int = 400, fix_scale_bug: bool = False) -> np.ndarray:
    """VideoCrafter latent-scale array (ddpm3d.py:362-376), with the
    reference's over-long flat tail unless ``fix_scale_bug``."""
    scale_step = num_timesteps - mid_step if fix_scale_bug else num_timesteps
    arr = np.concatenate([np.linspace(scale_a, scale_b, mid_step, dtype=np.float64),
                          np.full(scale_step, scale_b, dtype=np.float64)])
    return arr[:num_timesteps] if fix_scale_bug else arr


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Schedule tables: DDPM tables have length T, DDIM tables length S."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    ddim_timesteps: torch.Tensor  # int64, ascending
    ddim_alphas: torch.Tensor
    ddim_alphas_prev: torch.Tensor
    ddim_sqrt_one_minus_alphas: torch.Tensor
    ddim_sigmas: torch.Tensor
    scale_arr: torch.Tensor  # VideoCrafter use_scale array (all ones if unused)
    use_scale: bool = False
    num_ddpm_timesteps: int = 1000
    num_ddim_steps: int = 50
    eta: float = 0.0
    parameterization: str = "eps"  # what the model predicts: "eps" or "v"


def make_ddim_schedule(num_ddim_steps: int, num_ddpm_timesteps: int = 1000,
                       beta_schedule: str = "linear", linear_start: float = 0.00085,
                       linear_end: float = 0.012, eta: float = 0.0, discretize: str = "uniform",
                       use_scale: bool = False, scale_a: float = 1.0, scale_b: float = 0.3,
                       mid_step: int = 400, given_alphas_cumprod: Optional[np.ndarray] = None,
                       device=None, rescale_betas_zero_snr: bool = False,
                       parameterization: str = "eps") -> DDIMSchedule:
    """Full schedule (host float64 -> float32 tensors on ``device``)."""
    if parameterization not in ("eps", "v"):
        raise ValueError(f"parameterization {parameterization!r}: eps or v")
    if given_alphas_cumprod is not None:
        alphas_cumprod = np.asarray(given_alphas_cumprod, dtype=np.float64)
        betas = 1.0 - alphas_cumprod / np.append(1.0, alphas_cumprod[:-1])
        num_ddpm_timesteps = alphas_cumprod.shape[0]
    else:
        betas = make_beta_schedule(beta_schedule, num_ddpm_timesteps, linear_start, linear_end)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    ddim_ts = make_ddim_timesteps(num_ddim_steps, num_ddpm_timesteps, discretize)
    ddim_alphas = alphas_cumprod[ddim_ts]
    ddim_alphas_prev = np.asarray([alphas_cumprod[0]] + alphas_cumprod[ddim_ts[:-1]].tolist())
    ddim_sigmas = eta * np.sqrt(
        (1 - ddim_alphas_prev) / (1 - ddim_alphas) * (1 - ddim_alphas / ddim_alphas_prev)
    )
    scale_arr = (
        make_scale_arr(num_ddpm_timesteps, scale_a=scale_a, scale_b=scale_b, mid_step=mid_step)
        if use_scale else np.ones(num_ddpm_timesteps, dtype=np.float64)
    )

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return DDIMSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        ddim_timesteps=torch.as_tensor(ddim_ts, dtype=torch.long, device=device),
        ddim_alphas=f32(ddim_alphas),
        ddim_alphas_prev=f32(ddim_alphas_prev),
        ddim_sqrt_one_minus_alphas=f32(np.sqrt(1.0 - ddim_alphas)),
        ddim_sigmas=f32(ddim_sigmas),
        scale_arr=f32(scale_arr),
        use_scale=use_scale,
        num_ddpm_timesteps=int(num_ddpm_timesteps),
        num_ddim_steps=int(num_ddim_steps),
        eta=float(eta),
        parameterization=parameterization,
    )


def _index(table: torch.Tensor, idx) -> torch.Tensor:
    return table[torch.as_tensor(idx, dtype=torch.long, device=table.device)]


def _per_frame(table, indices, ndim: int, frame_axis: int):
    shape = [1] * ndim
    shape[frame_axis] = -1
    return _index(table, indices).reshape(shape)


def _noise_like(x, generator, noise):
    if noise is not None:
        return torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


def draw_noise(shape, device, generator: Optional[torch.Generator] = None, noise_fn=None,
               name: str = "") -> torch.Tensor:
    """Standard-normal fp32 noise of ``shape``: ``noise_fn(name, shape)`` when
    given (every draw of a sampler can be injected from outside under its
    name, so a test hands two implementations the same numbers), else drawn
    from ``generator``."""
    if noise_fn is not None:
        return torch.as_tensor(noise_fn(name, tuple(shape)), dtype=torch.float32, device=device)
    return torch.randn(tuple(shape), generator=generator, device=device)


def x0_and_eps(schedule: DDIMSchedule, x, model_out, indices, frame_axis: int = 1):
    """(pred_x0, eps) of the model's output at per-frame DDIM indices: for
    eps, x0 = (x - sqrt(1 - a_t) eps) / sqrt(a_t); for v (ddpm3d.py
    ``predict_start_from_z_and_v``, ``predict_eps_from_z_and_v``), at the
    DDPM tables' sqrt(alphas_cumprod[t]) and sqrt(1 - alphas_cumprod[t]),
    x0 = sqrt(acp) x - sqrt(1 - acp) v and eps = sqrt(acp) v + sqrt(1 - acp)
    x, which hold at a zero terminal SNR too."""
    nd = x.ndim
    if schedule.parameterization == "v":
        ts = schedule.ddim_timesteps
        sac = _per_frame(schedule.sqrt_alphas_cumprod[ts], indices, nd, frame_axis)
        somac = _per_frame(schedule.sqrt_one_minus_alphas_cumprod[ts], indices, nd, frame_axis)
        return sac * x - somac * model_out, sac * model_out + somac * x
    a_t = _per_frame(schedule.ddim_alphas, indices, nd, frame_axis)
    sqrt_omat = _per_frame(schedule.ddim_sqrt_one_minus_alphas, indices, nd, frame_axis)
    return (x - sqrt_omat * model_out) / torch.sqrt(a_t), model_out


def ddim_step(schedule: DDIMSchedule, x, noise_pred, indices,
              generator: Optional[torch.Generator] = None, frame_axis: int = 1,
              noise=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DDIM update with a per-frame DDIM index vector ``indices`` [F]
    of the model's output ``noise_pred`` (eps, or v under a v schedule).
    Returns ``(x_prev, pred_x0)``. With eta 0 it draws no noise."""
    nd = x.ndim
    a_prev = _per_frame(schedule.ddim_alphas_prev, indices, nd, frame_axis)
    sigma_t = _per_frame(schedule.ddim_sigmas, indices, nd, frame_axis)
    pred_x0, noise_pred = x0_and_eps(schedule, x, noise_pred, indices, frame_axis)
    dir_xt = torch.sqrt(1.0 - a_prev - sigma_t ** 2) * noise_pred
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if schedule.eta > 0 and (generator is not None or noise is not None):
        x_prev = x_prev + sigma_t * _noise_like(x, generator, noise)
    return x_prev, pred_x0


def re_noise(schedule: DDIMSchedule, x_a, step_a, step_b,
             generator: Optional[torch.Generator] = None, noise=None):
    """Closed-form jump q(x_b | x_a) between two DDIM steps
    (pipeline/scheduler.py:98-110); ``step_a < step_b`` adds noise."""
    acp_a = _index(schedule.alphas_cumprod, _index(schedule.ddim_timesteps, step_a))
    acp_b = _index(schedule.alphas_cumprod, _index(schedule.ddim_timesteps, step_b))
    ratio = torch.clamp(acp_b / acp_a, 0.0, 1.0)
    return torch.sqrt(ratio) * x_a + torch.sqrt(1.0 - ratio) * _noise_like(x_a, generator, noise)


def re_noise_per_frame(schedule: DDIMSchedule, x_a, steps_b,
                       generator: Optional[torch.Generator] = None, step_a: int = 0,
                       frame_axis: int = 1, noise=None):
    """Re-noise each frame to its own DDIM step (progressive skip-noise init)."""
    shape = [1] * x_a.ndim
    shape[frame_axis] = -1
    acp_a = _index(schedule.alphas_cumprod, _index(schedule.ddim_timesteps, step_a))
    acp_b = _index(schedule.alphas_cumprod, _index(schedule.ddim_timesteps, steps_b))
    ratio = torch.clamp(acp_b / acp_a, 0.0, 1.0)
    return (torch.sqrt(ratio).reshape(shape) * x_a
            + torch.sqrt(1.0 - ratio).reshape(shape) * _noise_like(x_a, generator, noise))


# ---------------------------------------------------------------------------
# the legacy DDIMSampler surface (lvdm/models/samplers/ddim.py), the batch-eval
# path's: the use_scale step, the CFG variants, temporal guidance, encode
# ---------------------------------------------------------------------------


def _draw_like(x, generator, noise_fn, name: str, noise=None) -> torch.Tensor:
    if noise is not None:
        return torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    return draw_noise(x.shape, x.device, generator, noise_fn, name).to(x.dtype)


def ddim_scale_tables(schedule: DDIMSchedule) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ddim_scale_arr, ddim_scale_arr_prev) of the legacy ``use_scale``
    step (lvdm/models/samplers/ddim.py:42-47): the DDPM scale array at the
    DDIM timesteps, and the same shifted by one step."""
    sc = schedule.scale_arr[schedule.ddim_timesteps]
    sc_prev = torch.cat([schedule.scale_arr[:1], schedule.scale_arr[schedule.ddim_timesteps[:-1]]])
    return sc, sc_prev


def ddim_step_scaled(schedule: DDIMSchedule, x, noise_pred, indices,
                     generator: Optional[torch.Generator] = None, frame_axis: int = 1,
                     noise_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The legacy DDIMSampler step with VideoCrafter's ``use_scale``
    correction (lvdm/models/samplers/ddim.py:267-272): pred_x0 un-scaled by
    scale_t and re-scaled by scale_{t_prev} in x_prev. With
    ``use_scale=False`` it is :func:`ddim_step`. ``indices`` is a per-frame
    DDIM index vector [F]. With eta > 0 and a ``generator`` or ``noise_fn``
    it adds sigma_t times the draw ``step``. Returns ``(x_prev, pred_x0)``."""
    nd = x.ndim
    a_prev = _per_frame(schedule.ddim_alphas_prev, indices, nd, frame_axis)
    sigma_t = _per_frame(schedule.ddim_sigmas, indices, nd, frame_axis)
    pred_x0, noise_pred = x0_and_eps(schedule, x, noise_pred, indices, frame_axis)
    dir_xt = torch.sqrt(1.0 - a_prev - sigma_t ** 2) * noise_pred
    if schedule.use_scale:
        sc, sc_prev = ddim_scale_tables(schedule)
        pred_x0 = pred_x0 / _per_frame(sc, indices, nd, frame_axis)
        x_prev = torch.sqrt(a_prev) * _per_frame(sc_prev, indices, nd, frame_axis) * pred_x0 + dir_xt
    else:
        x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if schedule.eta > 0 and (generator is not None or noise_fn is not None):
        x_prev = x_prev + sigma_t * _draw_like(x, generator, noise_fn, "step")
    return x_prev, pred_x0


def guided(cond, uncond, guidance_scale: float, rescale: float = 0.0):
    """Classifier-free guidance of the model's output, cond and uncond rows
    [n, ...], with the guidance rescale of DynamiCrafter's sampler
    (samplers/ddim.py ``rescale_noise_cfg``, Lin et al. 2023 section 3.4):
    rescale phi * out * std(cond) / std(out) + (1 - phi) * out, each std
    over a row's elements (unbiased, as ``torch.std``); a constant row
    (std 0, as from a model whose output layer is still zero) is left
    unscaled. All on the card: it reads nothing back."""
    out = uncond + guidance_scale * (cond - uncond)
    if rescale:
        dims = tuple(range(1, out.ndim))
        sd = out.std(dim=dims, keepdim=True)
        ratio = torch.where(sd > 0, cond.std(dim=dims, keepdim=True) / sd, 1.0)
        out = rescale * (out * ratio) + (1.0 - rescale) * out
    return out


def cfg_combine(eps_cond, eps_uncond, guidance_scale: float, uc_type: Optional[str] = None):
    """Classifier-free guidance, with the legacy sampler's two other
    formulas (lvdm/models/samplers/ddim.py:217-226)."""
    if uc_type is None:
        return eps_uncond + guidance_scale * (eps_cond - eps_uncond)
    if uc_type == "cfg_original":
        return eps_cond + guidance_scale * (eps_cond - eps_uncond)
    if uc_type == "cfg_ours":
        return eps_cond + guidance_scale * (eps_uncond - eps_cond)
    raise NotImplementedError(f"uc_type '{uc_type}' unknown")


def temporal_guidance_combine(eps, eps_temporal, eps_no_temporal, scale: float):
    """The ``conditional_guidance_scale_temporal`` term
    (lvdm/models/samplers/ddim.py:228-231): eps pushed along the difference
    between the predictions with and without temporal attention (the UNet's
    ``no_temporal_attn``, which the reference's UNet swallows)."""
    return eps + scale * (eps_temporal - eps_no_temporal)


def _at_t(table: torch.Tensor, t, ndim: int) -> torch.Tensor:
    """``table[t]``: a scalar, or for a per-batch ``t`` [B] a [B, 1, ...] column."""
    t = torch.as_tensor(t, dtype=torch.long, device=table.device)
    return table[t].reshape((-1,) + (1,) * (ndim - 1)) if t.ndim else table[t]


def stochastic_encode(schedule: DDIMSchedule, x0, t, generator: Optional[torch.Generator] = None, noise=None,
                      use_original_steps: bool = False, noise_fn=None):
    """x0 noised to DDIM step index ``t`` (lvdm/models/samplers/ddim.py:
    330-348), or to the raw DDPM timestep ``t`` with
    ``use_original_steps``; ``t`` a scalar or per batch [B]. ``noise``, else
    the draw ``encode``."""
    if use_original_steps:
        sac, somac = schedule.sqrt_alphas_cumprod, schedule.sqrt_one_minus_alphas_cumprod
    else:
        sac, somac = torch.sqrt(schedule.ddim_alphas), schedule.ddim_sqrt_one_minus_alphas
    eps = _draw_like(x0, generator, noise_fn, "encode", noise)
    return _at_t(sac, t, x0.ndim) * x0 + _at_t(somac, t, x0.ndim) * eps


def q_sample(schedule: DDIMSchedule, x_start, t, generator: Optional[torch.Generator] = None, noise=None,
             noise_fn=None):
    """Forward diffusion q(x_t | x_0) at DDPM timestep ``t``, with
    VideoCrafter's ``use_scale`` latent scaling (lvdm/models/ddpm3d.py:
    411-420). ``noise``, else the draw ``q_sample``."""
    eps = _draw_like(x_start, generator, noise_fn, "q_sample", noise)
    t = torch.as_tensor(t, dtype=torch.long, device=schedule.sqrt_alphas_cumprod.device)
    sac = schedule.sqrt_alphas_cumprod[t]
    if schedule.use_scale:
        sac = sac * schedule.scale_arr[t]
    return sac * x_start + schedule.sqrt_one_minus_alphas_cumprod[t] * eps
