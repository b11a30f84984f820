"""Where the constant ``--dev_full_random`` bundle stops being finite.

    python3 chip_nonfinite.py            # one CUDA card, no arguments

Builds the CUDA kernels and the full-size i2v bundle with every parameter
0.01 (``cli.gen_pano_360.build_model`` with ``--dev_full_random true``, the
bundle the CLI and the port's planned benchmark use), then runs stage 1's
first step at the CLI's geometry (``chip_smoke.SPHERE_KW``: 2048x1024
equirect, 44 views, UNet batch 88 as 11 forwards of 8; the CLI's synthetic
panorama) three times: fp32 through the kernels, fp32 through the plain
versions (``cuda_lib.plain_kernels``) and bf16 through the kernels. Each run
watches, in call order, the output of every module of the bundle and of
every kernel wrapper (``chip_smoke.KERNELS``) and prints the first that
holds a value that is not finite: its name, its inputs' finiteness and
largest magnitude; and the largest magnitude at the output of each
top-level UNet block in the step's first UNet forward, and the finite share
of the step's latent. In the two kernel runs each kernel call of the
first UNet forward is also held against its plain version on the same
inputs (rel L2 by kernel; for K9 with the largest |mean| / std of a
GroupNorm group of its input). Ends with one JSON line of the three runs.
Exits 1 without a CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np
import torch

WATCHED_UNET_BLOCKS = ("time_embed", "input_blocks.", "init_attn", "middle_block", "output_blocks.", "out")


def _tensors(v):
    if torch.is_tensor(v):
        return [v]
    if isinstance(v, (tuple, list)):
        return [t for e in v for t in _tensors(e)]
    return []


def _finite(ts) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts if t.is_floating_point())


def _max_abs(ts) -> float:
    vals = [float(t.detach().float().abs().max()) for t in ts if t.is_floating_point() and t.numel()]
    return max(vals) if vals else 0.0


class _Watch:
    """The first non-finite output of a run, the UNet blocks' largest
    output magnitudes in its first UNet forward and, with ``compare``, each
    kernel call of that forward against its plain version on the same
    inputs."""

    def __init__(self, compare=False):
        self.first = None
        self.unet_calls = 0
        self.blocks = []
        self.compare = compare
        self.comparing = False
        self.calls = []  # (kernel, rel L2 against plain, |mean| / std of the input's worst group)

    def check(self, name, kind, inputs, output):
        if self.first is not None:
            return
        outs = _tensors(output)
        if _finite(outs):
            return
        ins = _tensors(inputs)
        self.first = {"name": name, "kind": kind, "unet_call": self.unet_calls, "inputs_finite": _finite(ins),
                      "max_abs_input": _max_abs(ins),
                      "nonfinite_share": float(1 - torch.isfinite(outs[0].float()).float().mean())}


class _Wrapped:
    """Stands in for a kernel wrapper: checks its output, keeps its
    attributes (the launch counters) on the wrapper."""

    def __init__(self, k, fn, watch):
        object.__setattr__(self, "_w", (k, fn, watch))

    def __call__(self, *a, **kw):
        k, fn, watch = self._w
        out = fn(*a, **kw)
        watch.check(k, "kernel wrapper", a, out)
        if watch.compare and watch.unet_calls == 1 and not watch.comparing:
            from dynamicscaler_tpu_torch.ops import cuda_lib

            watch.comparing = True
            try:
                with cuda_lib.plain_kernels():
                    ref = fn(*a, **kw)
            finally:
                watch.comparing = False
            o, r = _tensors(out)[0].double(), _tensors(ref)[0].double()
            watch.calls.append((k, float((o - r).norm() / r.norm()), _group_ratio(a[0]) if k == "K9" else None))
        return out

    def __getattr__(self, name):
        return getattr(self._w[1], name)

    def __setattr__(self, name, value):
        setattr(self._w[1], name, value)


def _group_ratio(x, groups=32) -> float:
    """The largest |mean| / std over the (sample, group) GroupNorm groups
    of ``x`` [B, ..., C], in fp64: how far the fast variance E[x^2] -
    mean^2 cancels."""
    xf = x.double().reshape(x.shape[0], -1, groups, x.shape[-1] // groups)
    mean, std = xf.mean(dim=(1, 3)), xf.std(dim=(1, 3))
    return float((mean.abs() / std.clamp_min(1e-300)).max())


def _hooks(model, watch):
    handles = []

    def pre(mod, args):
        watch.unet_calls += 1

    handles.append(model.unet.register_forward_pre_hook(pre))
    for comp, module in model.components():
        for name, m in module.named_modules():
            full = f"{comp}.{name}" if name else comp

            def hook(mod, args, out, full=full, comp=comp, name=name):
                watch.check(full, type(mod).__name__, args, out)
                if comp == "unet" and watch.unet_calls == 1 and name.count(".") <= 2 and \
                        name.startswith(WATCHED_UNET_BLOCKS):
                    watch.blocks.append((name, _max_abs(_tensors(out))))
            handles.append(m.register_forward_hook(hook))
    return handles


def _run(model, label, plain, pano, compare=False):
    import chip_smoke
    from dynamicscaler_tpu_torch.ops import cuda_lib
    from dynamicscaler_tpu_torch.pipelines import sphere

    watch = _Watch(compare)
    handles = _hooks(model, watch)
    saved = []
    for k, (fn, *_) in chip_smoke.KERNELS.items():
        mod = sys.modules[fn.__module__]
        saved.append((mod, fn.__name__, getattr(mod, fn.__name__)))
        setattr(mod, fn.__name__, _Wrapped(k, fn, watch))
    t0 = time.perf_counter()
    try:
        with cuda_lib.plain_kernels() if plain else contextlib.nullcontext():
            _, latent, denoised = sphere.sample_shift_sphere_panorama(
                model, chip_smoke.CLI_PROMPT, pano, denoise_to_step=1,
                generator=torch.Generator(device=model.device).manual_seed(17), **chip_smoke.SPHERE_KW)
        torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        for h in handles:
            h.remove()
    share = float(torch.isfinite(latent).float().mean())
    first = watch.first
    print(f"{label}: stage 1 step 0 in {time.perf_counter() - t0:.1f} s, {watch.unet_calls} UNet forwards; latent "
          f"{tuple(latent.shape)} finite share {share:.6f}, denoised {float(torch.isfinite(denoised).float().mean()):.6f}",
          flush=True)
    print(f"{label}: first UNet forward, largest |output| by block: "
          + ", ".join(f"{n} {v:.3e}" for n, v in watch.blocks), flush=True)
    if first is None:
        print(f"{label}: no module or kernel output held a non-finite value", flush=True)
    else:
        print(f"{label}: first non-finite output: {first['name']} ({first['kind']}) in UNet forward "
              f"{first['unet_call']}, {first['nonfinite_share']:.4f} of it not finite; its inputs finite "
              f"{first['inputs_finite']}, largest |input| {first['max_abs_input']:.4e}", flush=True)
    out = {"run": label, "latent_finite_share": share, "first_nonfinite": first,
           "first_forward_block_max_abs": dict(watch.blocks)}
    if compare:
        worst = {}
        for k, rel, ratio in watch.calls:
            w = worst.setdefault(k, {"calls": 0, "max_rel_l2": 0.0, "over_1e-4": 0})
            w["calls"] += 1
            w["max_rel_l2"] = max(w["max_rel_l2"], rel)
            w["over_1e-4"] += rel > 1e-4
        print(f"{label}: the first UNet forward's kernel calls against their plain versions on the same inputs "
              "(calls, largest rel L2, calls over 1e-4): "
              + ", ".join(f"{k} {w['calls']} {w['max_rel_l2']:.2e} {w['over_1e-4']}" for k, w in worst.items()),
              flush=True)
        k9 = sorted((r for r in watch.calls if r[0] == "K9"), key=lambda r: -r[1])[:5]
        print(f"{label}: K9's five worst calls (rel L2, largest |mean| / std of a group of its input): "
              + ", ".join(f"{rel:.2e} {ratio:.3e}" for _, rel, ratio in k9), flush=True)
        out["kernels_against_plain"] = worst
        out["k9_worst"] = [[rel, ratio] for _, rel, ratio in k9]
    return out


def _synthetic_pano(h, w):
    """The CLI's ``--dev_full_random`` panorama (gen_pano_360.py), in [-1, 1]."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx % 256, yy % 256, (xx + yy) % 256], -1).astype(np.float32)
    return img / 127.5 - 1.0


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(1)
    import subprocess

    from dynamicscaler_tpu_torch.cli import gen_pano_360 as cli
    from dynamicscaler_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_lib.build()
    cuda_lib.library()
    pano = _synthetic_pano(1024, 2048)
    results = []
    for dtype, label, plain in (("float32", "fp32 kernels", False), ("float32", "fp32 plain", True),
                                ("bfloat16", "bf16 kernels", False)):
        model = cli.build_model(cli.VArgs.from_args(["--dev_full_random", "true", "--dtype", dtype]))
        results.append(_run(model, label, plain, pano, compare=not plain))
        del model
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "runs": results}), flush=True)


if __name__ == "__main__":
    main()
