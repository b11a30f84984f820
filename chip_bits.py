"""Bit-equality of the port's kernels with another tree's, on one card.

Runs seeded calls whose output bits a change may be meant to keep: bf16 K9
(``fused_twrap.gn_silu``, output and folded vectors) on each of its routes,
bf16 TA (``fused_temporal.temporal_attention``) at F 16, 8 and 32,
``cuda_lib.gn_plan`` at 2-byte elements over every K9 call of the batch-8
i2v forward, and kernels 10 and 12 in fp32 (``fused_block.
fused_temporal_block``, ``fused_mega.temporal_mega``). Prints one line
``BITS {json}``, a sha256 prefix a case. With ``--against DIR`` it runs the
same calls again on DIR's package (a checkout of another commit, for
example unpacked by ``git archive`` under ``build/``), each tree building
its own kernels, prints each case EQUAL or DIFFERENT, and exits 1 if any
differ::

    python3 chip_bits.py
    python3 chip_bits.py --against build/parent

Needs a CUDA card; exits 2 without one.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

# (B, M, C, eps, SiLU): bf16 K9 on the cluster route (C 320, 1920 and 1280
# at batch 8, the VAE's decode frame without SiLU) and the split route (the
# temporal-conv norm and the VAE's largest frame)
K9_CASES = [(128, 2560, 320, 1e-5, True), (8, 40960, 320, 1e-5, True), (32, 160, 1920, 1e-5, True),
            (1, 589824, 128, 1e-6, True), (1, 3072, 512, 1e-6, False), (8, 640, 1280, 1e-5, True)]
# (rows, F, C): bf16 TA at t640 and t1280, and at F 8 and 32
TA_CASES = [(5120, 16, 640), (1280, 16, 1280), (5120, 8, 320), (640, 32, 320)]
# kernel 12 at t320 and t640 (40x64 and 20x32 latents, batch 8), kernel 10
# at t1280's 10x16 tokens
BLOCK_CASES = [("K12", (8, 16, 40, 64), 320), ("K10", (8 * 160, 16), 1280), ("K12", (8, 16, 20, 32), 640)]


def _hashes():
    """The cases' sha256 prefixes on the package that ``sys.path`` finds."""
    import torch
    from dynamicscaler_tpu_torch.config import videocrafter_i2v
    from dynamicscaler_tpu_torch.models.unet3d import gn_silu_calls
    from dynamicscaler_tpu_torch.ops import cuda_lib, fused_block, fused_mega, fused_temporal, fused_twrap

    out = {}
    g = torch.Generator(device="cuda").manual_seed(1234)

    def rn(*shape, s=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dt)

    def h(t):
        torch.cuda.synchronize()
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]

    bf = torch.bfloat16
    for B, M, C, eps, act in K9_CASES:
        x, s, b = rn(B, M, C, s=2.0, dt=bf) + 0.5, (1.0 + rn(C, s=0.1)).to(bf), rn(C, s=0.1, dt=bf)
        y, (mul, add) = fused_twrap.gn_silu(x, s, b, eps=eps, act=act, vectors=True)
        out[f"K9 bf16 {B}x{M}x{C} {cuda_lib.gn_plan(B, M, C, 32, 2).route}"] = " ".join(map(h, (y, mul, add)))
    for R, Fn, C in TA_CASES:
        qkv = rn(R, Fn, 3 * C, dt=bf)
        out[f"TA bf16 {R}x{Fn}x{C}"] = h(fused_temporal.temporal_attention(qkv, heads=C // 64, scale=0.125))
    calls = sorted(set(gn_silu_calls(videocrafter_i2v("bfloat16").unet, 8, 16, 40, 64)))
    plans = json.dumps([list(cuda_lib.gn_plan(*c, 32, 2)) for c in calls])
    out["gn_plan elem 2"] = hashlib.sha256(plans.encode()).hexdigest()[:16]
    for k, shape, C in BLOCK_CASES:
        heads = C // 64

        def w(n_out, n_in):
            return rn(n_out, n_in, s=n_in ** -0.5)
        lns = tuple(1.0 + rn(C, s=0.1) if i % 2 == 0 else rn(C, s=0.1) for i in range(6))
        a1, a2 = ((w(C, C), w(C, C), w(C, C), w(C, C), rn(C, s=0.1)) for _ in range(2))
        ff = (w(8 * C, C), rn(8 * C, s=0.1), w(C, 4 * C), rn(C, s=0.1))
        x = rn(*shape, C)
        if k == "K12":
            mul, add = 1.0 + rn(shape[0], C, s=0.1), rn(shape[0], C, s=0.1)
            wi, bi, wo, bo = w(C, C), rn(C, s=0.1), w(C, C), rn(C, s=0.1)
            y = fused_mega.temporal_mega(x, mul, add, wi, bi, lns, a1, a2, ff, wo, bo, heads=heads, scale=0.125)
        else:
            y = fused_block.fused_temporal_block(x, lns, a1, a2, ff, heads=heads, scale=0.125)
        out[f"{k}.f32 {list(x.shape)}"] = h(y)
    return out


def _run_in(tree):
    """The cases' hashes on ``tree``'s package, in a process of its own."""
    env = {**os.environ, "PYTHONPATH": str(tree)}
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree", str(tree)], cwd=tree, env=env,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("BITS ")]
    if proc.returncode or not lines:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"chip_bits: the run on {tree} failed (exit {proc.returncode})")
    return json.loads(lines[-1][5:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another tree's root: compare its bits with this tree's")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # the tree whose package a child process imports
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_bits: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
        print("BITS " + json.dumps(_hashes()), flush=True)
        return
    here = Path(__file__).resolve().parent
    mine = _run_in(here)
    print("BITS " + json.dumps(mine), flush=True)
    if not args.against:
        return
    other = _run_in(Path(args.against).resolve())
    same = True
    for key in mine:
        eq = other.get(key) == mine[key]
        same = same and eq
        print(f"bits {key}: {args.against} {other.get(key)} this tree {mine[key]} {'EQUAL' if eq else 'DIFFERENT'}")
    print("ALL EQUAL" if same and set(other) == set(mine) else "SOME DIFFER", flush=True)
    sys.exit(0 if same and set(other) == set(mine) else 1)


if __name__ == "__main__":
    main()
