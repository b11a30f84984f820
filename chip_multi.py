"""The panorama CLI's window batch over several H100s (``parallel/mesh.py``).

    python3 chip_multi.py            # a machine with 2 or more CUDA cards

The multi-card check of ``cli/gen_pano_360.py --data_parallel_devices N``
(one NCCL rank a card); ``chip_smoke.py`` runs on one card and sees the mesh
only at world size 1. It refuses to run on fewer than 2 cards. Every run is
at the CLI's geometry (2048x1024 stage 1 with 44 views, 2x2 then 4x4
windows of 320x512, 16 frames, CFG 7.5, UNet microbatch 8) with the steps
cut to a 12-step table (4 stage-1 steps, 8 a planar stage).

1. The entry point: ``gen_pano_360.py --dev_full_random true`` in bf16 on
   1, 2 and 4 cards (as many as the machine has), as a user runs it (the
   CLI builds the kernels and spawns its ranks). Each stage's s/step (rank
   0's wall clock, the collectives included), speedup over 1 card, and the
   ms a step in the window batch's collectives (rank 0's batch broadcast,
   the eps gathered; CUDA events on rank 0, so the wait for the slowest
   rank is in them) with their share of a step. The constant bundle (every parameter
   0.01) is for timing: the share of finite values in its latents is
   printed, not compared.
2. The bits, on the seeded random bundle (``chip_smoke.py``'s draws, zero
   layers perturbed), built in each rank and made equal by
   ``mesh.replicate``; the ranks started by ``mesh.launch`` as the CLI
   starts them, each running ``gen_pano_360.run``. One card twice without a
   mesh, each run in a process of its own: whether the whole run (the
   kernels, cuDNN, cuBLAS and SDPA under CLIP) gives the same bits from
   process to process at these shapes. Then 2 and 4 cards, each stage
   latent against the first 1-card run's: bit for bit where every share is
   whole microbatches (stage 1: 88 rows, 11 microbatches) and the two
   1-card processes agreed; else within phase 2's forward gate (rel L2
   0.05 in bf16).
   Stage 2's batch (8 rows, one microbatch) is cut into runs of rows, so
   its latent, and so stage 3's input, differ from one card's: stage 3 is
   also run alone at each N from the 1-card run's stage-1 and stage-2
   latents, where its 32 rows (4 microbatches) split whole. Stage 2 alone
   in fp32 (the fp32 bundle of the same draws) on 1 card and on the most
   cards, within 1e-4.

The last line is a JSON object with ``ok``, the card's name and the card
count. The runs' outputs go to a temporary directory, removed at the end;
each run's own output is printed after a ``---`` line naming it.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LATENTS = {"sphere": "sphere_SW_latent.npy", "planar_1x": "basic_SW_latent.npy", "upscale": "denoised_latent2x.npy"}
ARGV = ["--dev_full_random", "true", "--num_inference_steps", "12", "--denoise_to_step", "4", "--merge_prev_step", "4"]
GATE = {"bfloat16": 0.05, "float32": 1e-4}  # rel L2, chip_smoke phase 2's and phase 10's forward gates
RUN_TIMEOUT_S = 900


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    sys.exit(1)


def cli(out_root: str, name: str, n: int) -> dict:
    """``gen_pano_360.py --dev_full_random true`` at ``n`` ranks in a
    process of its own; its e2e.json and output directory."""
    argv = [sys.executable, "-m", "dynamicscaler_tpu_torch.cli.gen_pano_360", *ARGV, "--output_dir", out_root,
            "--project_name", name, "--data_parallel_devices", str(n)]
    t0 = time.perf_counter()
    run = subprocess.run(argv, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=RUN_TIMEOUT_S)
    say(f"--- {name}: {' '.join(argv[1:])}\n{run.stdout}")
    if run.returncode != 0:
        fail(f"{name}: exit {run.returncode}\n{run.stderr[-3000:]}")
    r = dict(dir=os.path.join(out_root, name), n=n)
    with open(os.path.join(r["dir"], "e2e.json")) as f:
        r["e2e"] = json.load(f)
    finite = {s: float(np.isfinite(latent(r, s)).mean()) for s in LATENTS}
    say(f"{name}: {time.perf_counter() - t0:.1f} s of command time; "
        + ", ".join(f"{k} {v:.2f} s wall" for k, v in r["e2e"]["stages_sec"].items())
        + f"; finite share of the stage latents {finite}")
    return r


def random_bundle(dtype: str):
    """The full-width i2v bundle with chip_smoke.py's seeded random weights
    on this process's card."""
    from dynamicscaler_tpu_torch.config import videocrafter_i2v
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
    from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer
    from dynamicscaler_tpu_torch.utils.weights import perturb_zero_params

    gen = torch.Generator(device="cuda").manual_seed(2)
    model = LatentVideoDiffusion.init_random(videocrafter_i2v(dtype), gen, tokenizer=HashTokenizer())
    perturb_zero_params(model.unet, gen)
    return model


def _bits_rank(rank: int, n: int, jobs, out_root: str) -> None:
    """One rank of ``n`` (a spawned process on ``cuda:<rank>``): each job
    ``(name, argv)`` through ``gen_pano_360.run`` on the seeded random
    bundle of its ``--dtype``, on the mesh of all ranks (none at 1)."""
    from dynamicscaler_tpu_torch.cli import gen_pano_360 as cli_mod
    from dynamicscaler_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh() if n > 1 else None
    models = {}
    for name, argv in jobs:
        vargs = cli_mod.VArgs.from_args([*ARGV, *argv, "--output_dir", out_root, "--project_name", name,
                                         "--data_parallel_devices", str(n)])
        if vargs.dtype not in models:
            models.clear()
            torch.cuda.empty_cache()
            models[vargs.dtype] = random_bundle(vargs.dtype)
        cli_mod.run(vargs, _model=models[vargs.dtype], mesh=mesh)


def bits_runs(out_root: str, n: int, jobs) -> dict:
    """``jobs`` on the seeded random bundle at ``n`` ranks; name -> run."""
    from dynamicscaler_tpu_torch.parallel.mesh import launch

    t0 = time.perf_counter()
    launch(_bits_rank, n, args=(n, jobs, out_root), device_type="cuda", timeout=RUN_TIMEOUT_S)
    runs = {}
    for name, _ in jobs:
        runs[name] = dict(dir=os.path.join(out_root, name), n=n)
        with open(os.path.join(runs[name]["dir"], "e2e.json")) as f:
            runs[name]["e2e"] = json.load(f)
    say(f"seeded random bundle on {n} card{'s' * (n > 1)}: {', '.join(runs)} in {time.perf_counter() - t0:.1f} s "
        "of command time")
    return runs


def latent(run: dict, stage: str) -> np.ndarray:
    return np.load(os.path.join(run["dir"], LATENTS[stage]))


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def compare(where: str, got: np.ndarray, ref: np.ndarray, exact: bool, gate: float) -> bool:
    same = same_bits(got, ref)
    err = float(np.linalg.norm((got - ref).ravel()) / max(np.linalg.norm(ref.ravel()), 1e-30))
    finite = bool(np.isfinite(got).all() and np.isfinite(ref).all())
    ok = finite and (same if exact else err <= gate)
    say(f"  {where}: {'bit-identical' if same else 'differs'}, rel L2 {err:.3e}, finite {finite} "
        f"({'must be bit for bit' if exact else f'gate {gate}'}) -> {'ok' if ok else 'FAILED'}")
    return ok


def timing_table(title: str, by_n: dict) -> None:
    say(f"{title}: s/step (steady, rank 0 wall clock, collectives included), speedup over 1 card, collectives a "
        "step:")
    for stage in LATENTS:
        one = by_n[1]["e2e"]["steady_sec_per_step"].get(stage)
        if one is None:
            continue
        cells = []
        for n, r in by_n.items():
            e2e = r["e2e"]
            sps = e2e["steady_sec_per_step"][stage]
            cell = f"{n} card{'s' * (n > 1)} {sps:.4f} s/step ({one / sps:.2f}x)"
            if n > 1:
                g_ms = 1e3 * e2e["gather_sec"][stage] / e2e["gathers"][stage]
                cell += f", collectives {g_ms:.2f} ms a step ({g_ms / 1e3 / sps:.1%})"
            cells.append(cell)
        say(f"  {stage}: " + "; ".join(cells))


def main() -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        fail(f"chip_multi.py needs 2 or more CUDA cards, one NCCL rank a card; this machine has {n}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for line in smi:
        say(line)
    count = torch.cuda.device_count()
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}, {count} cards")
    from dynamicscaler_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.build()  # once: the ranks and the CLI's processes load it
    say(f"kernel library built in {time.perf_counter() - t0:.1f} s")
    ns = [n for n in (2, 4) if n <= count]
    top = max(ns)
    tmp = tempfile.mkdtemp(prefix="chip_multi_")
    ok = True
    try:
        timing_table("1. gen_pano_360.py --dev_full_random true, bf16",
                     {n: cli(tmp, f"entry_n{n}", n) for n in (1, *ns)})

        say("2. bits on the seeded random bundle")
        one = bits_runs(tmp, 1, [("bf16_n1", []),
                                 ("fp32_stage2_n1", ["--dtype", "float32", "--do_upscale", "false",
                                                     "--predenoised_SP_latent_path",
                                                     os.path.join(tmp, "bf16_n1", LATENTS["sphere"])])])
        one.update(bits_runs(tmp, 1, [("bf16_n1_again", [])]))
        ref = one["bf16_n1"]
        det = {s: same_bits(latent(one["bf16_n1_again"], s), latent(ref, s)) for s in LATENTS}
        finite = all(np.isfinite(latent(ref, s)).all() for s in LATENTS)
        deterministic = all(det.values())
        say(f"1 card in two processes (bf16): stage latents bit-identical {det}, finite {finite} -> the run is "
            f"{'reproducible' if deterministic else 'NOT reproducible'} from process to process at these shapes")
        ok &= finite
        by_n = {1: ref}
        for n in ns:
            jobs = [(f"bf16_n{n}", []),
                    (f"bf16_n{n}_stage3", ["--predenoised_SP_latent_path", os.path.join(ref["dir"], LATENTS["sphere"]),
                                           "--predenoised_SW_1x_latent_path",
                                           os.path.join(ref["dir"], LATENTS["planar_1x"])])]
            if n == top:
                jobs.append((f"fp32_stage2_n{n}", ["--dtype", "float32", "--do_upscale", "false",
                                                   "--predenoised_SP_latent_path",
                                                   os.path.join(ref["dir"], LATENTS["sphere"])]))
            runs = bits_runs(tmp, n, jobs)
            by_n[n] = runs[f"bf16_n{n}"]
            say(f"bf16 at {n} cards against 1 card:")
            ok &= compare("stage 1 (whole microbatches)", latent(by_n[n], "sphere"), latent(ref, "sphere"),
                          deterministic, GATE["bfloat16"])
            ok &= compare("stage 2 (rows split)", latent(by_n[n], "planar_1x"), latent(ref, "planar_1x"), False,
                          GATE["bfloat16"])
            ok &= compare("stage 3 (after stage 2's split)", latent(by_n[n], "upscale"), latent(ref, "upscale"),
                          False, GATE["bfloat16"])
            ok &= compare("stage 3 alone from the 1-card stage-2 latent (whole microbatches)",
                          latent(runs[f"bf16_n{n}_stage3"], "upscale"), latent(ref, "upscale"), deterministic,
                          GATE["bfloat16"])
            if n == top:
                say(f"fp32 stage 2 at {n} cards against 1 card:")
                f32 = {1: one["fp32_stage2_n1"], n: runs[f"fp32_stage2_n{n}"]}
                ok &= compare("stage 2 (rows split)", latent(f32[n], "planar_1x"), latent(f32[1], "planar_1x"),
                              False, GATE["float32"])
        timing_table("2. seeded random bundle, bf16", by_n)
        timing_table("2. seeded random bundle, fp32 stage 2 alone", f32)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not ok:
        fail("a stage latent disagreed with the 1-card run or was not finite")
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
