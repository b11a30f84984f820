"""On-card smoke run of the PyTorch port (``dynamicscaler_tpu_torch``).

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases, in order, one result line each (any failure exits non-zero):

1. card and build: ``nvidia-smi`` name and power limit; build the CUDA
   kernels of ``dynamicscaler_tpu_torch/csrc`` (nvcc, sm_90a).
2. each kernel (K1-K4, K3 in its t2v and i2v variants) against its plain
   PyTorch version, bf16, at every full-width UNet shape for window batch 2
   (one CFG pair, 16 frames, 40x64 latent): max abs error against the stated
   tolerance, kernel and plain times (CUDA events).
3. one full-width VideoCrafter2 t2v UNet forward (seeded random bf16
   weights, zero-initialised layers perturbed) through the kernels and
   through the plain versions: relative error, times, launch counts.
4. the main path: after a one-step warm-up request, two prompts through
   ``pipelines.t2v.sample_shift_multi_windows`` (2 windows of 320x512, a
   320x1024x16 panorama, 4 DDIM steps, CFG 7.5, frame-chunked VAE decode);
   the launch counters are zeroed just before and read just after.

Then one JSON line of kernel records, and last the device JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from dynamicscaler_tpu_torch.ops import cuda_lib, fused_spatial, fused_temporal

# name -> (wrapper, description, CUDA source, TPU kernel it replaces)
KERNELS = {
    "K1": (fused_temporal.fused_ln_attention, "fused_ln_attention (temporal LN-attention)",
           "dynamicscaler_tpu_torch/csrc/attention.cu", "dynamicscaler_tpu/ops/fused_temporal.py:267"),
    "K2": (fused_spatial.fused_ln_spatial_attention,
           "fused_ln_spatial_attention (spatial LN-self-attention)",
           "dynamicscaler_tpu_torch/csrc/attention.cu", "dynamicscaler_tpu/ops/fused_spatial.py:156"),
    "K3": (fused_spatial.fused_ln_cross_attention, "fused_ln_cross_attention (LN-cross-attention)",
           "dynamicscaler_tpu_torch/csrc/attention.cu", "dynamicscaler_tpu/ops/fused_spatial.py:337"),
    "K4": (fused_temporal.fused_ln_geglu, "fused_ln_geglu (LN+GEGLU feed-forward)",
           "dynamicscaler_tpu_torch/csrc/gemm.cu", "dynamicscaler_tpu/ops/fused_temporal.py:350"),
}

# bf16 tolerances of kernel vs plain: both round q/k/v, probabilities and
# outputs to bf16 at the same points but accumulate in other orders, so a
# few outputs may land one or two bf16 ulps apart (2^-7 relative each).
# TOL_REL bounds the worst element against max|plain|; TOL_BRANCH_REL_L2
# bounds the L2 error against the sub-block's own output (plain - x), which
# the residual x would otherwise hide.
TOL_REL = 0.03
TOL_BRANCH_REL_L2 = 0.02
# relative L2 error of one full UNet forward, kernels vs plain, in bf16
TOL_UNET_REL_L2 = 0.05
EXPECTED_PER_FORWARD = {"K1": 34, "K2": 16, "K3": 16, "K4": 33}
DEV = torch.device("cuda:0")


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _reset_launches() -> None:
    for fn, *_ in KERNELS.values():
        fn.launches = 0


def _launches() -> dict:
    return {k: fn.launches for k, (fn, *_) in KERNELS.items()}


def main() -> None:
    if not torch.cuda.is_available():
        _fail("no CUDA device: the port's smoke run needs an NVIDIA GPU")
    # fp32 products of the plain versions stay fp32 (no TF32) on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: card and build -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.build(verbose=True)
    cuda_lib.library()
    print(f"phase 1 ok: built {lib.relative_to(cuda_lib.REPO_ROOT)} in {time.perf_counter() - t0:.1f} s "
          f"on {torch.cuda.get_device_name(0)} [{smi}]", flush=True)

    records = _phase_kernels()
    model = _random_model()
    _phase_unet(model)
    launches = _phase_sampler(model, steps=4)

    kernels = [
        {"name": f"{k} {desc}", "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], **records[k]}
        for k, (_, desc, src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_cases():
    """(op, calls per full-width forward, description, args, kwargs, packed
    kernel operands) at every main-path shape of the 40x64x16 latent,
    window batch 2."""
    g = torch.Generator(device=DEV).manual_seed(1)
    bf = torch.bfloat16

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=DEV) * s

    def w(o, i):
        return (rn(o, i) / i ** 0.5).to(bf)

    def ln(C):
        return 1.0 + rn(C, s=0.1), rn(C, s=0.1)

    B2F = 2 * 16  # window batch 2 (one CFG pair) x 16 frames
    for calls, R, C in ((10, 5120, 320), (2, 5120, 512), (10, 1280, 640), (10, 320, 1280), (2, 80, 1280)):
        x = rn(R, 16, C).to(bf)
        a = (x, *ln(C), w(C, C), w(C, C), w(C, C), w(C, C), rn(C, s=0.1))
        yield "K1", calls, f"x[{R},16,{C}]", a, dict(heads=C // 64, scale=0.125), \
            fused_temporal.pack_ln_attention(*a[1:], dtype=bf)
    for calls, N, C in ((5, 2560, 320), (5, 640, 640), (5, 160, 1280), (1, 40, 1280)):
        kw = dict(heads=C // 64, scale=0.125)
        x = rn(B2F, N, C).to(bf)
        a = (x, *ln(C), w(C, C), w(C, C), w(C, C), w(C, C), rn(C, s=0.1))
        yield "K2", calls, f"x[{B2F},{N},{C}]", a, kw, fused_temporal.pack_ln_attention(*a[1:], dtype=bf)
        ctx = rn(B2F, 77, 1024).to(bf)
        a = (x, ctx, *ln(C), w(C, C), w(C, 1024), w(C, 1024), w(C, C), rn(C, s=0.1))
        yield "K3", calls, f"x[{B2F},{N},{C}] ctx[{B2F},77,1024] t2v", a, kw, \
            fused_spatial.pack_ln_cross_attention(*a[2:], dtype=bf)
        ctx_i = rn(B2F, 93, 1024).to(bf)
        a = (x, ctx_i, *ln(C), w(C, C), w(C, 1024), w(C, 1024), w(C, C), rn(C, s=0.1),
             w(C, 1024), w(C, 1024))
        yield "K3", 0, f"x[{B2F},{N},{C}] ctx[{B2F},77+16,1024] i2v", a, dict(kw, text_len=77), \
            fused_spatial.pack_ln_cross_attention(*a[2:], dtype=bf)
    for calls, T, C in ((10, 81920, 320), (1, 81920, 512), (10, 20480, 640), (10, 5120, 1280), (2, 1280, 1280)):
        x = rn(T, C).to(bf)
        a = (x, *ln(C), w(8 * C, C), rn(8 * C, s=0.1), w(C, 4 * C), rn(C, s=0.1))
        yield "K4", calls, f"x[{T},{C}]", a, {}, fused_temporal.pack_ln_geglu(*a[1:], dtype=bf)


def _phase_kernels():
    """Phase 2: every kernel against its plain version. Returns, per op,
    the largest error and the kernel and plain ms summed over one forward."""
    records = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in KERNELS}
    bad = []
    for k, calls, desc, a, kw, ops in _kernel_cases():
        fn = KERNELS[k][0]
        got = fn(*a, **kw, operands=ops)
        with cuda_lib.plain_kernels():
            ref = fn(*a, **kw)
        torch.cuda.synchronize()
        diff = got.float() - ref.float()
        err = float(diff.abs().max())
        tol = TOL_REL * max(1.0, float(ref.float().abs().max()))
        branch_rel = float(diff.norm() / (ref.float() - a[0].float()).norm())
        finite = bool(torch.isfinite(got).all())
        ms = _time_ms(lambda: fn(*a, **kw, operands=ops), 10)
        with cuda_lib.plain_kernels():
            plain_ms = _time_ms(lambda: fn(*a, **kw), 3)
        ok = finite and err <= tol and branch_rel <= TOL_BRANCH_REL_L2
        print(f"phase 2 {k} {desc}: max_abs_err {err:.5f} (tol {tol:.5f}) branch rel_l2 "
              f"{branch_rel:.5f} (tol {TOL_BRANCH_REL_L2}) kernel {ms:.3f} ms "
              f"plain {plain_ms:.3f} ms x{calls}/fwd {'ok' if ok else 'FAIL'}", flush=True)
        r = records[k]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += calls * ms
        r["plain_ms"] += calls * plain_ms
        if not ok:
            bad.append(f"{k} {desc}")
        del got, ref, diff, a, ops
    torch.cuda.empty_cache()
    if bad:
        _fail(f"kernel disagrees with its plain version: {bad}")
    print("phase 2 ok: " + ", ".join(
        f"{k} {r['ms']:.2f} ms/fwd (plain {r['plain_ms']:.2f})" for k, r in records.items()), flush=True)
    return records


def _random_model():
    from dynamicscaler_tpu_torch.config import videocrafter2_t2v
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
    from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer
    from dynamicscaler_tpu_torch.utils.weights import perturb_zero_params

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = LatentVideoDiffusion.init_random(videocrafter2_t2v("bfloat16"), gen, DEV,
                                             tokenizer=HashTokenizer())
    # without this the zero-initialised output layers make eps identically 0
    perturb_zero_params(model.unet, gen)
    print(f"model: random bf16 weights in {time.perf_counter() - t0:.1f} s", flush=True)
    return model


def _phase_unet(model):
    """Phase 3: one full-width UNet forward, kernels vs plain."""
    g = torch.Generator(device=DEV).manual_seed(7)
    x = torch.randn((2, 16, 40, 64, 4), generator=g, device=DEV)
    ctx = torch.randn((2, 77, 1024), generator=g, device=DEV)
    t = torch.tensor([500, 500], device=DEV)

    def fwd():
        return model.apply_unet(x, t, ctx, 16)

    _reset_launches()
    got = fwd()
    torch.cuda.synchronize()
    counts = _launches()
    with cuda_lib.plain_kernels():
        ref = fwd()
    torch.cuda.synchronize()
    rel = float((got - ref).norm() / ref.norm())
    finite = bool(torch.isfinite(got).all())

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fwd()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    ms = timed(3)
    with cuda_lib.plain_kernels():
        plain_ms = timed(2)
    print(f"phase 3: UNet fwd batch 2 [2,16,40,64,4]: rel_l2 {rel:.5f} (tol {TOL_UNET_REL_L2}) "
          f"|eps| mean {float(ref.abs().mean()):.4f} kernels {ms:.1f} ms plain {plain_ms:.1f} ms "
          f"launches {counts}", flush=True)
    if not finite or rel > TOL_UNET_REL_L2:
        _fail(f"UNet kernel path disagrees with the plain path: rel_l2 {rel} finite {finite}")
    if counts != EXPECTED_PER_FORWARD:
        _fail(f"launch counts {counts} != {EXPECTED_PER_FORWARD}")
    _profile_forward(fwd, ms)
    print("phase 3 ok", flush=True)


def _profile_forward(fwd, wall_ms):
    """Device time of one kernel-path forward by CUDA kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in rows) / 1e3
    if total <= 0:
        print("phase 3 profile: no device time recorded (profiler saw no CUDA activity)", flush=True)
        return
    groups = {}
    for e in rows:
        n = e.key.lower()
        key = ("ds_gemm (K1-K4 projections)" if "ln_gemm_kernel" in n
               else "ds_flash_attn (K2, K3)" if "flash_attn_kernel" in n
               else "ds_temporal_attn (K1)" if "temporal_attn_kernel" in n
               else "conv (cuDNN)" if any(s in n for s in ("conv", "cudnn", "fprop", "implicit"))
               else "gemm (cuBLAS: proj_in/out, time emb)" if any(s in n for s in ("gemm", "cutlass"))
               else "elementwise/reduce (GN, casts, cat)")
        groups[key] = groups.get(key, 0.0) + e.self_device_time_total / 1e3
    parts = ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.0f}%)"
                      for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
    print(f"phase 3 profile: device busy {total:.1f} ms of {wall_ms:.1f} ms wall "
          f"(idle share {max(0.0, 1 - total / wall_ms):.2f}); {parts}", flush=True)


def _phase_sampler(model, steps):
    """Phase 4: a one-step warm-up request, then two requests through the
    shift-window sampler, timed warm."""
    from dynamicscaler_tpu_torch.pipelines import t2v

    gen = torch.Generator(device=DEV).manual_seed(11)

    def request(prompt, n_steps):
        """One request; returns (video, sampling s/step, decode s)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, den = t2v.sample_shift_multi_windows(
            model, prompt, num_windows_w=2, height=320, width=512, frames=16, fps=16,
            guidance_scale=7.5, num_inference_steps=n_steps, loop_step=n_steps, generator=gen,
            decode=False,
        )
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        video = model.decode_video_chunked(den, frame_chunk=4)
        torch.cuda.synchronize()
        return video, (t1 - t0) / n_steps, time.perf_counter() - t1

    _, cold, cold_decode = request("warm-up", 1)
    prompts = ["a snowy mountain village at dusk, panorama", "waves rolling onto a tropical beach, panorama"]
    _reset_launches()
    timings = []
    for p in prompts:
        video, per_step, decode_s = request(p, steps)
        shape = tuple(video.shape)
        finite = bool(torch.isfinite(video).all())
        print(f"phase 4: request {p!r}: video {shape} finite {finite} |video| mean "
              f"{float(video.abs().mean()):.4f} sampling {per_step:.3f} s/step "
              f"decode {decode_s:.2f} s", flush=True)
        if shape != (1, 16, 320, 1024, 3) or not finite:
            _fail(f"bad video {shape} finite={finite}")
        timings.append(per_step)
        del video
    launches = _launches()
    print(f"phase 4 ok: {len(prompts)} warm requests, {sum(timings) / len(timings):.3f} s/step mean "
          f"(cold one-step warm-up request {cold:.3f} s/step, decode {cold_decode:.2f} s), "
          f"kernel launches {launches}", flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        _fail(f"kernels never launched on the main path: {missing}")
    return launches


if __name__ == "__main__":
    main()
