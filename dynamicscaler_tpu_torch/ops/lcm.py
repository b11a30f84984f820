"""LCM / T2V-Turbo scheduler as plain tensor functions (PyTorch).

Counterpart of ``dynamicscaler_tpu/ops/lcm.py`` (reference
pipeline/d_scheduler.py: 55-125 beta schedules and the zero-terminal-SNR
rescale, 322-366 LCM timestep spacing and boundary-condition scalings,
368-463 ``step``, 465-545 the per-frame ``fifo_step``, 550-601
``add_noise``). Tables are built in float64 numpy on the host and stored as
float32 tensors on ``device``. ``lcm_step`` takes per-frame (timestep,
previous timestep) vectors, so FIFO diagonal denoising is one call a step.
Every noise draw takes ``noise=`` (a test hands both twins the same
numbers) or a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dynamicscaler_tpu_torch.ops.ddim import _noise_like


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Zero terminal SNR (arXiv 2305.08891, Alg. 1; d_scheduler.py:95-125)."""
    alphas = 1.0 - betas
    abs_sqrt = np.sqrt(np.cumprod(alphas))
    a0, aT = abs_sqrt[0], abs_sqrt[-1]
    abs_sqrt = (abs_sqrt - aT) * a0 / (a0 - aT)
    abar = abs_sqrt ** 2
    alphas = np.concatenate([abar[:1], abar[1:] / abar[:-1]])
    return 1.0 - alphas


@dataclasses.dataclass(frozen=True)
class LCMSchedule:
    alphas_cumprod: torch.Tensor  # [T] float32
    timesteps: torch.Tensor  # [S] int64, DESCENDING (LCM inference order)
    final_alpha_cumprod: torch.Tensor  # scalar float32
    num_inference_steps: int = 4
    prediction_type: str = "epsilon"
    sigma_data: float = 0.5


def make_lcm_schedule(num_inference_steps: int, lcm_origin_steps: int = 50, num_train_timesteps: int = 1000,
                      linear_start: float = 0.00085, linear_end: float = 0.012,
                      rescale_betas_zero_snr_flag: bool = False, set_alpha_to_one: bool = True,
                      prediction_type: str = "epsilon", device=None) -> LCMSchedule:
    """scaled_linear betas + LCM linear-spacing timesteps
    (d_scheduler.py:200-212, 322-356)."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, num_train_timesteps, dtype=np.float64) ** 2
    if rescale_betas_zero_snr_flag:
        betas = rescale_zero_terminal_snr(betas)
    alphas_cumprod = np.cumprod(1.0 - betas)
    final = 1.0 if set_alpha_to_one else alphas_cumprod[0]

    c = num_train_timesteps // lcm_origin_steps
    lcm_origin = np.arange(1, lcm_origin_steps + 1) * c - 1
    skip = max(len(lcm_origin) // num_inference_steps, 1)
    timesteps = lcm_origin[::-skip][:num_inference_steps]
    return LCMSchedule(
        alphas_cumprod=torch.as_tensor(np.asarray(alphas_cumprod, np.float32), device=device),
        timesteps=torch.tensor(timesteps.tolist(), dtype=torch.long, device=device),
        final_alpha_cumprod=torch.as_tensor(np.float32(final), device=device),
        num_inference_steps=int(num_inference_steps),
        prediction_type=prediction_type,
    )


def boundary_scalings(t, sigma_data: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """LCM boundary-condition scalings (d_scheduler.py:360-366)."""
    t = torch.as_tensor(t).float()
    c_skip = sigma_data ** 2 / ((t / 0.1) ** 2 + sigma_data ** 2)
    c_out = (t / 0.1) / torch.sqrt((t / 0.1) ** 2 + sigma_data ** 2)
    return c_skip, c_out


def lcm_step(schedule: LCMSchedule, sample, model_output, timesteps, prev_timesteps,
             generator: Optional[torch.Generator] = None, noise=None,
             frame_axis: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LCM update, vectorised over per-frame timesteps (the
    ``fifo_step`` generalisation; identical vectors give plain ``step``).
    ``timesteps`` [F] the current DDPM timestep per frame,
    ``prev_timesteps`` [F] the next (less noisy) one; a negative previous
    timestep takes ``final_alpha_cumprod``. With one inference step it adds
    no noise. Returns (prev_sample, denoised)."""
    shape = [1] * sample.ndim
    shape[frame_axis] = -1
    acp = schedule.alphas_cumprod
    ts = torch.as_tensor(timesteps, dtype=torch.long, device=acp.device)
    prev = torch.as_tensor(prev_timesteps, dtype=torch.long, device=acp.device)
    a_t = acp[ts].reshape(shape)
    a_prev = torch.where(prev >= 0, acp[prev.clamp_min(0)], schedule.final_alpha_cumprod).reshape(shape)
    b_t, b_prev = 1.0 - a_t, 1.0 - a_prev

    if schedule.prediction_type == "epsilon":
        pred_x0 = (sample - torch.sqrt(b_t) * model_output) / torch.sqrt(a_t)
    elif schedule.prediction_type == "sample":
        pred_x0 = model_output
    elif schedule.prediction_type == "v_prediction":
        pred_x0 = torch.sqrt(a_t) * sample - torch.sqrt(b_t) * model_output
    else:
        raise ValueError(schedule.prediction_type)

    c_skip, c_out = boundary_scalings(ts, schedule.sigma_data)
    denoised = c_out.reshape(shape) * pred_x0 + c_skip.reshape(shape) * sample
    if schedule.num_inference_steps > 1:
        prev_sample = torch.sqrt(a_prev) * denoised + torch.sqrt(b_prev) * _noise_like(sample, generator, noise)
    else:
        prev_sample = denoised
    return prev_sample, denoised


def fifo_timestep_vectors(schedule: LCMSchedule) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-queue-slot (timestep, previous timestep) vectors of FIFO diagonal
    denoising, ``fifo_step``'s index mapping (d_scheduler.py:485-495): the
    queue runs front (cleanest) to back, the ASCENDING timesteps; slot i's
    previous timestep is slot i-1's, and the front slot keeps its own."""
    t_asc = schedule.timesteps.flip(0)
    return t_asc, torch.cat([t_asc[:1], t_asc[:-1]])


def lcm_add_noise(schedule: LCMSchedule, original, timesteps, generator: Optional[torch.Generator] = None,
                  noise=None, frame_axis: int = 1) -> torch.Tensor:
    """q(x_t | x_0) with a scalar or per-frame timesteps
    (d_scheduler.py:550-583)."""
    noise = _noise_like(original, generator, noise)
    acp = schedule.alphas_cumprod
    ts = torch.as_tensor(timesteps, dtype=torch.long, device=acp.device)
    sac, soc = torch.sqrt(acp[ts]), torch.sqrt(1.0 - acp[ts])
    if ts.ndim:
        shape = [1] * original.ndim
        shape[frame_axis] = -1
        sac, soc = sac.reshape(shape), soc.reshape(shape)
    return sac * original + soc * noise
