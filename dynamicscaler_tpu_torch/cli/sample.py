"""Single-clip sampling CLI (PyTorch): t2v, i2v, FIFO streaming, FreeTraj.

Counterpart of ``dynamicscaler_tpu/cli/sample.py``, with its flags and
defaults (the reference's gradio t2v / i2v demos, scripts/gradio/
t2v_test.py and i2v_test.py, as a CLI, plus FIFO streaming and FreeTraj):

    python -m dynamicscaler_tpu_torch.cli.sample --mode t2v --prompt "a black swan" \\
        --ckpt_path t2v.ckpt --bpe_path bpe_simple_vocab_16e6.txt.gz
    python -m dynamicscaler_tpu_torch.cli.sample --mode i2v --prompt "..." --image input.png \\
        --ckpt_path i2v.ckpt --bpe_path bpe_simple_vocab_16e6.txt.gz
    python -m dynamicscaler_tpu_torch.cli.sample --mode fifo --prompt "..." --num_frames 128 \\
        --ckpt_path t2v.ckpt --bpe_path bpe_simple_vocab_16e6.txt.gz
    python -m dynamicscaler_tpu_torch.cli.sample --mode freetraj --prompt "a red car" \\
        --traj "0:0.3-0.7:0.0-0.4;1:0.3-0.7:0.6-1.0" --ckpt_path t2v.ckpt --bpe_path bpe_simple_vocab_16e6.txt.gz
    python -m dynamicscaler_tpu_torch.cli.sample --mode t2v --prompt "a black swan" --dev_tiny

The model (VideoCrafter2 t2v, or VideoCrafter i2v for ``--mode i2v``) runs
on the CUDA card in bf16, or in fp32 with ``--dtype float32`` (TF32 off);
``--dev_tiny`` runs the tiny random fp32 model on the CPU. Any other
``--dtype`` on the card is refused at startup.
"""

from __future__ import annotations

import argparse
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["t2v", "i2v", "fifo", "freetraj"], default="t2v")
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--image", type=str, default="", help="cond image (i2v)")
    p.add_argument("--ckpt_path", type=str, default="")
    p.add_argument("--bpe_path", type=str, default="")
    p.add_argument("--output_dir", type=str, default="./results/sample")
    p.add_argument("--name", type=str, default="")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--num_frames", type=int, default=64, help="fifo output length")
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--num_inference_steps", type=int, default=48)
    p.add_argument("--guidance_scale", type=float, default=12.0)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--dev_tiny", action="store_true")
    p.add_argument("--traj", type=str, default="",
                   help="FreeTraj keyframes 'f:h0-h1:w0-w1;...', f a frame index or 0..1 fraction, box "
                   "coordinates fractions of the video extent")
    p.add_argument("--traj_token_ids", type=str, default="",
                   help="comma list of prompt token positions of the target word (default 2: the first "
                   "content token)")
    p.add_argument("--traj_thres", type=float, default=600.0,
                   help="spatial trajectory masking applies while t > thres")
    return p.parse_args(argv)


def parse_traj_spec(spec: str):
    """'f:h0-h1:w0-w1;...' -> keyframe rows (f, h0, h1, w0, w1)."""
    rows = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        f, hs, ws = part.split(":")
        h0, h1 = (float(v) for v in hs.split("-"))
        w0, w1 = (float(v) for v in ws.split("-"))
        rows.append((float(f), h0, h1, w0, w1))
    if not rows:
        raise ValueError(f"empty --traj spec {spec!r}")
    return rows


def build_model(args):
    """The bundle of the mode: ``--dev_tiny`` the tiny random fp32 model on
    the CPU (i2v parts for ``--mode i2v``), shrinking the geometry to it as
    the JAX CLI does; else the checkpoint ``--ckpt_path`` for VideoCrafter2
    t2v, or VideoCrafter i2v for ``--mode i2v``, with the CLIP BPE file
    ``--bpe_path``, on the card, its converted state dicts cached beside it
    (``utils.checkpoint.load_or_convert``, as the JAX CLI caches its tree)."""
    from dynamicscaler_tpu_torch.cli.gen_pano_360 import load_bundle
    from dynamicscaler_tpu_torch.config import tiny_test_config, videocrafter2_t2v, videocrafter_i2v
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
    from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer

    i2v = args.mode == "i2v"
    if args.dev_tiny:
        return LatentVideoDiffusion.init_random(
            tiny_test_config(img_attention=i2v), torch.Generator().manual_seed(args.seed % (2**31)),
            device="cpu", tokenizer=HashTokenizer(512),
        )
    config = videocrafter_i2v(dtype=args.dtype) if i2v else videocrafter2_t2v(dtype=args.dtype)
    return load_bundle(args.ckpt_path, args.bpe_path, config, cached=True)


def main(args, _model=None, _noise=None):
    """Generate one clip in ``args.mode`` and write it with ``save_video``;
    returns the video's path. ``_model`` replaces :func:`build_model`'s
    bundle; ``_noise`` is the sampler's ``noise_fn(name, shape)`` (tests
    hand it the JAX CLI's draws), else a generator seeded with ``--seed``
    on the model's device draws them."""
    from dynamicscaler_tpu_torch.cli.gen_pano_360 import check_dtype, setup_precision
    from dynamicscaler_tpu_torch.utils.io import load_image, save_video, to_uint8_device

    check_dtype(args.dtype, args.dev_tiny)
    setup_precision(args.dtype, args.dev_tiny)
    if args.mode == "freetraj" and not args.traj:
        raise ValueError("--traj keyframe spec required for freetraj mode")
    if args.mode == "i2v" and not args.image:
        raise ValueError("--image required for i2v")
    t0 = time.time()
    if args.dev_tiny:
        args.height = args.width = 32
        args.frames, args.num_inference_steps = 4, 4
        args.num_frames = min(args.num_frames, 8)
    model = _model if _model is not None else build_model(args)
    generator = None if _noise is not None else torch.Generator(device=model.device).manual_seed(args.seed)
    common = dict(height=args.height, width=args.width, fps=args.fps, guidance_scale=args.guidance_scale,
                  generator=generator, noise_fn=_noise)

    if args.mode == "t2v":
        from dynamicscaler_tpu_torch.pipelines import t2v

        video, _ = t2v.basic_sample(model, args.prompt, frames=args.frames,
                                    num_inference_steps=args.num_inference_steps, **common)
    elif args.mode == "freetraj":
        from dynamicscaler_tpu_torch.pipelines import t2v

        token_ids = [int(v) for v in args.traj_token_ids.split(",") if v] if args.traj_token_ids else None
        video, _ = t2v.freetraj_sample(
            model, args.prompt, traj_keyframes=parse_traj_spec(args.traj), traj_token_ids=token_ids,
            traj_thres=args.traj_thres, frames=args.frames, num_inference_steps=args.num_inference_steps,
            **common,
        )
    elif args.mode == "fifo":
        from dynamicscaler_tpu_torch.pipelines import fifo

        video, _ = fifo.fifo_sample(model, args.prompt, num_output_frames=args.num_frames, frames=args.frames,
                                    **common)
    else:  # i2v: one window, the 1x1x1 integer grid
        from dynamicscaler_tpu_torch.pipelines import i2v

        image = load_image(args.image, args.height, args.width)
        video, _ = i2v.sample_shift_multi_windows_integer(
            model, args.prompt, image, num_windows_w=1, num_windows_h=1, num_windows_f=1,
            loop_step=args.num_inference_steps, frames=args.frames,
            num_inference_steps=args.num_inference_steps, **common,
        )

    name = args.name or "".join(c if c.isalnum() else "_" for c in args.prompt[:40])
    out = save_video(to_uint8_device(video[0]).cpu().numpy(), args.output_dir, name, fps=args.fps)
    print(f"[sample] {args.mode} done in {time.time() - t0:.1f}s -> {out}", flush=True)
    return out


if __name__ == "__main__":
    main(parse_args())
