"""Plain reference of DynamiCrafter 1024 on the planar panorama ring: the UNet
with image tokens per frame, the hybrid concat, the zero-terminal-SNR
trailing schedule, the v-prediction DDIM step with guidance rescale, one
planar step with each window's concat latent, and the frame-by-frame ring
decode.

Part of the benchmark's frozen reference, fp32 (the caller switches TF32
off). It follows the published DynamiCrafter code (lvdm/modules/networks/
openaimodel3d.py ``forward``, lvdm/models/ddpm3d.py ``DiffusionWrapper``
with ``conditioning_key: hybrid``, ``rescale_zero_terminal_snr``,
``predict_start_from_z_and_v``, ``predict_eps_from_z_and_v``,
lvdm/models/samplers/ddim.py with ``rescale_noise_cfg``,
lvdm/models/utils_diffusion.py ``uniform_trailing``), reuses ``nets`` and
``pipeline`` unchanged and imports nothing of the program under test.

Departures from DynamiCrafter, each one the program's too:

* the concat latent of a window is its crop of the VAE encode of the whole
  panorama (``pipeline.tiled_encode``), cut at the window's origin with
  the ring wrap of the noisy gather; DynamiCrafter encodes the conditioning
  image itself, and the two differ within the encoder's receptive field of
  the crop's edges;
* the step is DynamicScaler's planar step (re-noise of the overlaps, the
  merge with the previous latent, the ordered scatter), so the
  ``use_dynamic_rescale`` factor of DynamiCrafter's own sampler, which that
  step does not take for VideoCrafter's ``use_scale`` either, is not
  applied;
* the Resampler's 16 queries x ``video_length`` 16 are one count of 256 in
  the configuration (``nets.Resampler`` reads a single count): the same
  [1, 256, 1024] parameter and the same computation.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from portbench.reference import nets, pipeline


class UNet(nets.UNet):
    """The UNet of ``nets`` with DynamiCrafter's context: the 77 text tokens
    on every frame and frame f's ``image_tokens_per_frame`` image tokens
    after them. Its input has the noisy latent's channels, then the
    concat's; its output is v."""

    def forward(self, x, t, context, fps):
        """x [B, F, H, W, C]; t [B]; context [B, 77 + F n, D]; fps int."""
        B, Fn, H, W, C = x.shape
        mc = self.cfg.model_channels
        n, Lt = self.cfg.image_tokens_per_frame, self.cfg.text_context_len
        t_f = t.reshape(B).repeat_interleave(Fn)
        emb = self.time_embed(nets.timestep_embedding(t_f, mc))
        emb = emb + self.fps_embedding(nets.timestep_embedding(torch.full_like(t_f, fps, dtype=torch.float32), mc))
        txt = context[:, :Lt].repeat_interleave(Fn, dim=0)
        ctx = torch.cat([txt, context[:, Lt:].reshape(B * Fn, n, context.shape[-1])], dim=1)
        h = x.permute(0, 1, 4, 2, 3).reshape(B * Fn, C, H, W)
        hs = []
        for i, layers in enumerate(self.input_blocks):
            h = self._run(layers, h, emb, ctx, Fn)
            if i == 0:
                h = self.init_attn[0](h, Fn)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, ctx, Fn)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb, ctx, Fn)
        y = self.out(h)
        return y.reshape(B, Fn, -1, H, W).permute(0, 1, 3, 4, 2)


def per_frame(unet: nets.UNet) -> UNet:
    """``unet`` (built by ``nets.build``) as this UNet: the same module and
    parameters, this forward."""
    unet.__class__ = UNet
    return unet


class Schedule:
    """Linear betas rescaled to a zero terminal SNR, DDIM timesteps
    ``uniform_trailing``, eta 0, a v-predicting model (float64 on the
    host, float32 on ``device``); the interface of ``pipeline.Schedule``."""

    def __init__(self, steps: int, diffusion: dict, device):
        T = diffusion["timesteps"]
        betas = np.linspace(diffusion["linear_start"] ** 0.5, diffusion["linear_end"] ** 0.5, T,
                            dtype=np.float64) ** 2
        sq = np.sqrt(np.cumprod(1.0 - betas))
        sq = (sq - sq[-1]) * (sq[0] / (sq[0] - sq[-1]))
        acp = sq ** 2  # the rescaled alphas_cumprod: the last is 0
        ts = np.flip(np.round(np.arange(T, 0, -T / steps))).astype(np.int64) - 1
        if ts.shape[0] != steps:
            raise ValueError(f"uniform_trailing gives {ts.shape[0]} timesteps for {steps} steps")
        self.steps, self.timesteps = steps, ts

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.acp = f32(acp)
        self.alphas_prev = f32([acp[0]] + acp[ts[:-1]].tolist())
        self.sqrt_acp, self.sqrt_one_minus_acp = f32(np.sqrt(acp)), f32(np.sqrt(1.0 - acp))

    def ddim(self, x, v, index: int):
        """(x_prev, pred_x0) of one eta-0 DDIM update at table ``index`` from
        the model's v: x0 = sqrt(acp_t) x - sqrt(1 - acp_t) v, eps =
        sqrt(acp_t) v + sqrt(1 - acp_t) x."""
        t = int(self.timesteps[index])
        a, b = self.sqrt_acp[t], self.sqrt_one_minus_acp[t]
        pred_x0, eps = a * x - b * v, a * v + b * x
        a_prev = self.alphas_prev[index]
        return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * eps, pred_x0

    def re_noise(self, x, step_a: int, step_b: int, noise):
        """q(x_b | x_a) between two DDIM table indices."""
        ratio = torch.clamp(self.acp[int(self.timesteps[step_b])] / self.acp[int(self.timesteps[step_a])], 0.0, 1.0)
        return torch.sqrt(ratio) * x + torch.sqrt(1.0 - ratio) * noise


def guided(rows, n: int, guidance: float, rescale: float):
    """CFG over rows packed [cond (n) ; uncond (n)], then the guidance
    rescale: phi out std(cond) / std(out) + (1 - phi) out, each std over
    one row's elements (``torch.std``, unbiased)."""
    out = pipeline.cfg_eps(rows, n, guidance)
    cond = rows[:n]
    dims = tuple(range(1, out.ndim))
    rescaled = out * (cond.std(dim=dims, keepdim=True) / out.std(dim=dims, keepdim=True))
    return rescale * rescaled + (1.0 - rescale) * out


def concat_rows(static, origins, sizes, copies: int = 2):
    """The concat latent of each window: its crop of ``static`` [1, 1, H,
    W, c] at (h0, w0), ring-wrapped, repeated over the window's frames; the
    whole stack ``copies`` times (cond rows, then uncond rows)."""
    f, h, w = sizes
    _, _, H, W, _ = static.shape
    dev = static.device
    crops = []
    for _, h0, w0 in origins:
        hi, wi = (h0 + torch.arange(h, device=dev)) % H, (w0 + torch.arange(w, device=dev)) % W
        crops.append(static[0, 0][hi[:, None], wi[None, :]])
    crops = torch.stack(crops)[:, None].expand(-1, f, -1, -1, -1)
    return torch.cat([crops] * copies)


def planar_step(sched: Schedule, state: dict, noise: Callable, eps_fn: Callable, p: dict, step: int,
                index: int, last: bool, origins, round_state=lambda t: t):
    """The reference's DDIM step of the planar ring sampler from ``state``
    ({"latent" [1, F, H, W, 4], "denoised", "static" [1, 1, H, W, 4]}) over
    the windows at ``origins``, each UNet row the window's noisy latent
    joined by its concat latent; ``eps_fn(x_rows, ids)`` gives the UNet's v
    of the CFG-packed rows. Returns (latent, denoised, x_rows)."""
    lat = state["latent"]
    dev = lat.device
    sizes = (p["frames"], p["height"] // p["vs"], p["width"] // p["vs"])
    cov = torch.zeros(lat.shape[:-1] + (1,), device=dev)
    wins, masks = [], []
    for o in origins:
        fi, hi, wi = pipeline.ring_index(lat.shape, o, sizes, dev)
        sel = (slice(None), fi[:, None, None], hi[None, :, None], wi[None, None, :])
        wins.append(lat[sel])
        masks.append(cov[sel].clone())
        cov[sel] = 1.0
    n = len(origins)
    wins, masks = torch.cat(wins), torch.cat(masks)
    prev = wins
    renoise = 0.0 if last else p["renoise_ratio"]
    if renoise:
        noised = sched.re_noise(wins, max(index - 1, 0), index, noise(f"renoise:{step}", wins.shape))
        wins = pipeline.mix_with_mask(wins, noised, masks, renoise)
    x_rows = torch.cat([torch.cat([wins, wins]), concat_rows(state["static"], origins, sizes)], dim=-1)
    v = guided(eps_fn(x_rows, list(range(n))), n, p["guidance"], p["guidance_rescale"])
    new, den = sched.ddim(wins, v, index)
    merge = 0.0 if last or p.get("merge_prev") is None else p["merge_prev"][step]
    new = round_state(pipeline.mix_with_mask(new, prev, masks, merge))
    den = round_state(den)
    latent, denoised = lat.clone(), state["denoised"].clone()
    for k, o in enumerate(origins):  # window order, the last write wins
        fi, hi, wi = pipeline.ring_index(lat.shape, o, sizes, dev)
        sel = (slice(None), fi[:, None, None], hi[None, :, None], wi[None, None, :])
        latent[sel] = new[k:k + 1]
        denoised[sel] = den[k:k + 1]
    return round_state(latent), round_state(denoised), x_rows


def ring_decode_frames(vae, latent):
    """[n, h, w, z] W-ring latents -> [n, H, W, 3], one frame a decode
    (``perframe_ae``), each as ``pipeline.ring_decode``."""
    return torch.cat([pipeline.ring_decode(vae, latent[i:i + 1]) for i in range(latent.shape[0])])
