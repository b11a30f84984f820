"""Batch evaluation over a prompt list (PyTorch), sharded across processes.

Counterpart of ``dynamicscaler_tpu/cli/batch_eval.py`` (the reference's
scripts/evaluation/inference.py:42-130 with its DDP prompt-sharding
wrapper, ddp_wrapper.py:8-46): each process generates its slice
``prompts[rank::world]``, one single-window clip a prompt, on its card
``cuda:{rank % device_count}``:

    python -m dynamicscaler_tpu_torch.cli.batch_eval --prompt_file prompts.txt \\
        --ckpt_path t2v.ckpt --bpe_path bpe_simple_vocab_16e6.txt.gz
    python -m dynamicscaler_tpu_torch.cli.batch_eval --mode i2v --cond_input conds/ --prompt_file ...
    python -m dynamicscaler_tpu_torch.cli.batch_eval --prompt_file prompts.txt --dev_tiny

Several ranks meet through ``parallel/dist.py`` (``--coordinator
host:port --num_processes N --process_id r``, or the ``DSCALER_*``
environment), with a barrier before and after the prompts; ``--rank`` /
``--world_size`` override the group's. ``--dev_tiny`` runs the tiny random
fp32 model on the CPU at 32x32, 4 frames, 4 steps. The model runs on the
card in bf16, or in fp32 with ``--dtype float32`` (TF32 off); any other
``--dtype`` on the card is refused at startup.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import torch

COND_EXTS = ("png", "jpg", "jpeg", "mp4", "avi", "mov", "webm")


def parse_args(argv=None):
    from dynamicscaler_tpu_torch.parallel.dist import add_distributed_flags

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--prompt_file", type=str, required=True, help="text file, one prompt per line")
    p.add_argument("--mode", type=str, default="t2v", choices=("t2v", "i2v"),
                   help="i2v pairs each prompt with a cond image from --cond_input (sorted; inference.py:80-85)")
    p.add_argument("--cond_input", type=str, default="",
                   help="dir of per-prompt cond images (png/jpg), sorted by name like the reference's get_filelist")
    p.add_argument("--ckpt_path", type=str, default="")
    p.add_argument("--bpe_path", type=str, default="")
    p.add_argument("--output_dir", type=str, default="./results/batch")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--num_inference_steps", type=int, default=48)
    p.add_argument("--guidance_scale", type=float, default=12.0)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--dev_tiny", action="store_true")
    # manual rank override (defaults to the process group's rank / size)
    p.add_argument("--rank", type=int, default=-1)
    p.add_argument("--world_size", type=int, default=-1)
    add_distributed_flags(p)
    return p.parse_args(argv)


def cond_files(cond_input: str, n_prompts: int):
    """The conditioning files of ``--mode i2v``, sorted, one a prompt:
    images, and videos whose first frame conditions the clip
    (funcs.py:129-167)."""
    paths = sorted(p for ext in COND_EXTS for p in glob.glob(os.path.join(cond_input, f"*.{ext}")))
    if len(paths) != n_prompts:
        raise ValueError(f"cond inputs ({len(paths)}) != prompts ({n_prompts}) (inference.py:82 requires 1:1)")
    return paths


def build_model(args, rank: int):
    """The bundle of ``cli/sample.py::build_model``: ``--dev_tiny`` the tiny
    random fp32 model on the CPU (i2v parts for ``--mode i2v``); else the
    checkpoint ``--ckpt_path`` (VideoCrafter2 t2v, or VideoCrafter i2v for
    ``--mode i2v``) with the CLIP BPE file ``--bpe_path``, on the rank's
    card, made the current device first."""
    from dynamicscaler_tpu_torch.cli import sample

    if not args.dev_tiny and torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    return sample.build_model(args)


def main(args, _model=None, _noise=None):
    """Generate this rank's shard of the prompts, one video each in
    ``--output_dir`` as ``r{rank}_{i:04d}_{prompt}``; returns their paths.
    ``_model`` replaces :func:`build_model`'s bundle. Prompt ``i``'s noise
    comes from a generator on the model's device seeded from ``(--seed,
    rank * 100003 + i)`` (``gen_pano_360.site_seed``), or from
    ``_noise(rank * 100003 + i)``, a sampler ``noise_fn`` (tests hand it the
    JAX CLI's draws)."""
    from dynamicscaler_tpu_torch.cli.gen_pano_360 import check_dtype, setup_precision, site_seed
    from dynamicscaler_tpu_torch.parallel.dist import (barrier, destroy_distributed, initialize_from_args,
                                                       process_count, process_index)
    from dynamicscaler_tpu_torch.pipelines import i2v, t2v
    from dynamicscaler_tpu_torch.utils.io import load_first_frame, save_video, to_uint8_device

    check_dtype(args.dtype, args.dev_tiny)
    setup_precision(args.dtype, args.dev_tiny)
    coordinated = initialize_from_args(args)
    try:
        rank = args.rank if args.rank >= 0 else process_index()
        world = args.world_size if args.world_size > 0 else process_count()
        if coordinated:
            barrier("batch_eval_start")  # every rank reached the group
        with open(args.prompt_file) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
        shard = prompts[rank::world]  # the reference shards by index slice too
        print(f"[batch_eval] rank {rank}/{world}: {len(shard)}/{len(prompts)} prompts", flush=True)
        conds = cond_files(args.cond_input, len(prompts))[rank::world] if args.mode == "i2v" else None

        if args.dev_tiny:
            args.height = args.width = 32
            args.frames, args.num_inference_steps = 4, 4
        model = _model if _model is not None else build_model(args, rank)
        common = dict(height=args.height, width=args.width, frames=args.frames, fps=args.fps,
                      guidance_scale=args.guidance_scale, num_inference_steps=args.num_inference_steps)
        os.makedirs(args.output_dir, exist_ok=True)
        t0, paths = time.time(), []
        for i, prompt in enumerate(shard):
            site = rank * 100003 + i
            noise = {"noise_fn": _noise(site)} if _noise is not None else {
                "generator": torch.Generator(device=model.device).manual_seed(site_seed(args.seed, site))}
            if args.mode == "i2v":
                cond = load_first_frame(conds[i], args.height, args.width)
                video, _ = i2v.basic_sample(model, prompt, cond, **common, **noise)
            else:
                video, _ = t2v.basic_sample(model, prompt, **common, **noise)
            name = f"r{rank}_{i:04d}_" + "".join(c if c.isalnum() else "_" for c in prompt[:40])
            paths.append(save_video(to_uint8_device(video[0]).cpu().numpy(), args.output_dir, name, fps=args.fps))
            print(f"[batch_eval] {i + 1}/{len(shard)} '{prompt[:50]}' ({time.time() - t0:.1f}s elapsed)",
                  flush=True)
        print(f"[batch_eval] rank {rank} done in {time.time() - t0:.1f}s", flush=True)
        if coordinated:
            barrier("batch_eval_done")
        return paths
    finally:
        if coordinated:
            destroy_distributed()


if __name__ == "__main__":
    main(parse_args())
