"""The comparison that decides ``correct``: the frozen reference, fp32 with TF32
off, rebuilt from the seed's weights after the program is freed, judges what
the timed path produced. Each number is compared with its limit from
``limits/<workload>.json``; the traffic driver of the cell says which
numbers there are and how each is read.

With ``control`` the reference computed in fp8 (``reference/lowp.py``)
takes the program's place: it produces the outputs that the fp32 reference
then judges by the same numbers.
"""

from __future__ import annotations

import contextlib

import torch

from portbench import harness, inputs
from portbench.reference import lowp, nets


def rel_l2(got, want, base=None) -> float:
    """||got - want|| / ||base|| (``base`` defaults to ``want``), in fp64."""
    got, want = got.double(), want.double()
    base = want if base is None else base.double()
    return float((got - want).norm() / base.norm().clamp(min=1e-30))


def eps_or_zeros(eps, x):
    """The program's eps rows for the rows ``x``; zeros where its step ran
    no UNet (a fault)."""
    return torch.zeros_like(x) if eps is None else eps.float()


def step_numbers(ref, step_fn, state: dict, prog_eps, prog_out, contexts, t: int, p: dict, seed: int,
                 n_pick: int) -> dict:
    """``state`` and ``eps`` of one step. ``step_fn(eps_fn)`` is the
    reference's step from the program's ``state`` with the program's eps,
    returning (latent, denoised, x_rows); ``contexts(pick)`` the
    reference's contexts of the picked windows' cond rows then their uncond
    rows; ``n_pick`` windows are drawn from the seed."""
    lat_ref, den_ref, x_rows = step_fn(lambda x, ids: eps_or_zeros(prog_eps, x))
    numbers = {"state": max(rel_l2(prog_out[0], lat_ref, lat_ref - state["latent"]),
                            rel_l2(prog_out[1], den_ref, den_ref - state["denoised"]))}
    n = x_rows.shape[0] // 2
    pick = torch.randperm(n, generator=torch.Generator().manual_seed(inputs.derive_seed(seed, "rows")))[:n_pick]
    rows = pick.tolist() + [n + k for k in pick.tolist()]
    ref_eps = ref.unet(x_rows[rows], t, contexts(pick.tolist()), p["fps"], p["unet_microbatch"])
    numbers["eps"] = (max(rel_l2(prog_eps[r].float(), ref_eps[i]) for i, r in enumerate(rows))
                      if prog_eps is not None else float("inf"))
    return numbers


def vae_scale(spec) -> int:
    """The VAE's downsampling: 2 per level transition."""
    return 2 ** (len(spec.config["model"]["vae"]["ch_mult"]) - 1)


def max_abs(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


@contextlib.contextmanager
def fp32_math():
    """TF32 off for matrix products and convolutions, as a plain fp32
    reference needs on the card."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class Reference:
    """The reference modules of a cell at its seed's weights, fp32 on
    ``device``; with ``fp8`` the control's."""

    def __init__(self, spec, seed: int, device, fp8: bool = False):
        self.spec, self.device = spec, device
        model = spec.config["model"]
        mods = nets.build(model)
        weights = inputs.make_weights(mods, seed, harness.served_dtype(spec, device), device)
        self.mods = {}
        for name, mod in mods.items():
            mod.to_empty(device=device)
            mod.load_state_dict({k: v.float() for k, v in weights.pop(name).items()})
            self.mods[name] = (lowp.to_fp8(mod) if fp8 else mod).eval()
        self.round_state = lowp.round_fp8 if fp8 else (lambda t: t)
        self.tokenizer = inputs.HashTokenizer(harness.vocab(spec))

    def unet(self, x, t: int, ctx, fps: int, chunk: int = 8):
        """eps of rows x [n, F, h, w, C] at timestep t, ``chunk`` rows a call."""
        tt = torch.full((chunk,), t, device=self.device, dtype=torch.long)
        return torch.cat([self.mods["unet"](x[i:i + chunk], tt[:x[i:i + chunk].shape[0]], ctx[i:i + chunk], fps)
                          for i in range(0, x.shape[0], chunk)])


@torch.no_grad()
def judge(spec, driver_mod, captured: dict, output, seed: int, device, control: bool = False) -> list:
    """[{"name", "value", "limit"}] of the cell's numbers."""
    with fp32_math():
        ref = Reference(spec, seed, device)
        low = Reference(spec, seed, device, fp8=True) if control else None
        numbers = driver_mod.check(spec, ref, captured, output, seed, low)
    return [{"name": k, "value": v, "limit": spec.limits[k]} for k, v in numbers.items()]
