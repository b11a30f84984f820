"""360-degree panorama video generation CLI (PyTorch), the ``gen_pano_360.py``
entry point.

Counterpart of ``dynamicscaler_tpu/cli/gen_pano_360.py``: the same flags
and three-stage orchestration (reference gen_pano_360.py:22-128 ``VArgs``,
:130-396 ``main``):

  1. sphere panorama shift-window denoise at 2x equirect (15 of 48 steps),
  2. nearest-downsample to 1x, planar 2x2 shift-window denoise (skip 15),
  3. bicubic-upsample x2, re-noise, planar 4x4 shift-window denoise,

with the stage latents written as .npy (resume through the
``--predenoised_*`` flags), the videos written on threads, and each stage's
wall seconds and steady s/step in ``<out_dir>/e2e.json``.

    python -m dynamicscaler_tpu_torch.cli.gen_pano_360 --ckpt_path model.ckpt --bpe_path bpe.txt.gz \\
        --pano_image_path pano.png
    python -m dynamicscaler_tpu_torch.cli.gen_pano_360 --dev_full_random true   # full size, no assets
    python -m dynamicscaler_tpu_torch.cli.gen_pano_360 --dev_full_random true --data_parallel_devices 4
    python -m dynamicscaler_tpu_torch.cli.gen_pano_360 --dev_tiny true --pano_image_path pano.png

``--model`` names the preset (``config.PRESETS``): ``videocrafter_i2v_512``
(the default) or ``dynamicrafter_1024``, DynamiCrafter's 1024 model, whose
checkpoint has the same names (``--ckpt_path``). For the latter the flags
the user does not give take DynamiCrafter's published values
(``MODEL_DEFAULTS``: 576 x 1024 windows on a 2048 x 1024 panorama, frame
stride 10 on ``--fps``, ``--guidance_rescale`` 0.7); its hybrid
conditioning joins the panorama's latent to every view and window row.

The model runs on the CUDA card in bf16 (``--dtype bfloat16``, the
default) or fp32 (``--dtype float32``: the fp32 kernels, with TF32 switched
off for cuDNN's convolutions and PyTorch's matrix products);
``--dev_tiny`` runs the tiny fp32 model on the CPU.
``--data_parallel_devices N`` (N > 1) starts N ranks, one process a card
on ``cuda:0`` ... ``cuda:N-1`` in an NCCL group (``parallel/mesh.py``; under
``--dev_tiny`` N gloo processes on the CPU): every rank builds the model,
rank 0's weights are broadcast, and every DDIM step's window batch is split
over the ranks (the sequential overlap mode runs whole on each). Rank 0
alone writes the outputs and prints the stage timings, whose steady s/step
includes the gather. Refused at startup: any other ``--dtype`` on the card
and more ranks than the machine has cards. The JAX CLI's warm-start flags
(``aot_warm``, ``warm_probe``, ``repeat_warm``, ``resident_pass``) exist
only for its TPU server and XLA compiles and are not flags here.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

DEFAULT_PHI_PROMPT = {
    90: "Clear light blue sky",
    75: "Clear light blue sky",
    60: "Clear light blue sky",
    45: "Massive green blue ocean wave, dynamic ocean spray, breaking waves",
    0: "Massive green blue ocean wave, dynamic ocean spray, breaking waves",
    -45: "green blue ocean with waves and swirling foam patterns",
    -60: "green blue ocean with waves",
    -75: "green blue ocean water",
    -90: "green blue ocean water",
}


# the flags a preset sets where the command line does not give them
MODEL_DEFAULTS = {
    "dynamicrafter_1024": dict(height=576, width=1024, fps=10, equirect_width=2048, equirect_height=1024,
                               guidance_rescale=0.7),
}


@dataclasses.dataclass
class VArgs:
    """CLI flags (reference gen_pano_360.py:22-85; one flag per field)."""

    seed: int = 2333333
    prompt: str = "Massive green blue ocean wave, dynamic ocean spray, breaking waves"
    pano_image_path: str = "./input/pano.png"
    phi_prompt_json: str = ""  # optional JSON {phi: prompt}

    total_f: int = 16
    do_upscale: bool = True
    upscale_factor: int = 2

    phi_num: int = 6
    view_fov: int = 120
    denoise_to_step: int = 15
    skip_time_step: int = -1
    loop_step_theta: int = 10
    predenoised_SP_latent_path: str = ""
    predenoised_SW_1x_latent_path: str = ""
    dock_at_f: bool = True
    loop_step_frame: int = 8
    skip_1x: bool = False
    loop_step_hw: int = 16
    merge_renoised_overlap_latent_ratio: float = 1.0
    merge_denoised: bool = True
    max_merge_denoised_overlap_latent_ratio: float = 0.5
    merge_prev_step: int = 20

    num_inference_steps: int = 48
    height: int = 320
    width: int = 512
    fps: int = 8
    guidance_scale: float = 7.5
    equirect_width: int = 1024
    equirect_height: int = 512
    num_windows_hw_2: int = 2
    # optional per-axis overrides for stage 2/3 window counts (0 = use hw_2)
    num_windows_w_2: int = 0
    num_windows_h_2: int = 0

    ckpt_path: str = "./videocrafter_models/i2v_512_v1/model.ckpt"
    bpe_path: str = ""
    output_dir: str = "./results"
    project_name: str = ""
    overlap_mode: str = "last"
    unet_microbatch: int = 8
    view_get_scale_factor: int = 1
    view_set_scale_factor: int = 1
    # split every step's window batch over this many cards, one rank a card (0 or 1: one process)
    data_parallel_devices: int = 0
    dtype: str = "bfloat16"
    save_latents: bool = True
    profile_dir: str = ""  # write a torch.profiler Chrome trace of stage 1 here
    dev_tiny: bool = False  # tiny random fp32 model on the CPU, no assets (smoke/testing)
    dev_full_random: bool = False  # full-size constant-weight model on the card, no assets
    # the port's own flags: the preset (config.PRESETS) and the guidance rescale of its samplers
    model: str = "videocrafter_i2v_512"
    guidance_rescale: float = 0.0

    @classmethod
    def from_args(cls, argv=None) -> "VArgs":
        parser = argparse.ArgumentParser(description=__doc__)
        for f in dataclasses.fields(cls):
            if f.type in ("bool", bool):
                parser.add_argument(
                    f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                    default=f.default,
                )
            else:
                parser.add_argument(f"--{f.name}", type=type(f.default), default=f.default)
        vals = vars(parser.parse_args(argv))
        given = {a[2:].split("=")[0] for a in (sys.argv[1:] if argv is None else argv) if a.startswith("--")}
        for name, value in MODEL_DEFAULTS.get(vals["model"], {}).items():
            if name not in given:
                vals[name] = value
        return cls(**vals)


def check_flags(vargs: VArgs) -> None:
    """Refuse at startup what the port cannot run, each with its reason."""
    from dynamicscaler_tpu_torch.config import PRESETS

    if vargs.model not in PRESETS:
        raise ValueError(f"--model {vargs.model}: one of {', '.join(PRESETS)}")
    n = vargs.data_parallel_devices
    if n > 1 and not vargs.dev_tiny and n > torch.cuda.device_count():
        raise ValueError(f"--data_parallel_devices {n}: one rank a CUDA card needs {n} cards; found "
                         f"{torch.cuda.device_count()} (--dev_tiny runs the ranks on the CPU)")
    check_dtype(vargs.dtype, vargs.dev_tiny)


def check_dtype(dtype: str, dev_tiny: bool) -> None:
    """Refuse a ``--dtype`` the card's kernels do not take (every CLI of
    the port)."""
    if not dev_tiny and dtype not in ("bfloat16", "float32"):
        raise ValueError(f"--dtype {dtype}: the model runs on the CUDA card, whose kernels take float32 or "
                         "bfloat16 only (--dev_tiny runs the tiny float32 model on the CPU)")


def setup_precision(dtype: str, dev_tiny: bool) -> None:
    """The process-wide math settings of a run on the card (every CLI of the
    port, at startup): ``float32`` switches TF32 off, for cuDNN's
    convolutions and PyTorch's matrix products alike, so an fp32 run
    multiplies in fp32 everywhere (PyTorch runs fp32 convolutions in TF32
    by default), and says so; a bf16 run, and ``--dev_tiny`` on the CPU,
    keep PyTorch's settings."""
    if dtype == "float32" and not dev_tiny:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print("[setup] --dtype float32: TF32 off (torch.backends.cudnn.allow_tf32 = False, "
              "torch.backends.cuda.matmul.allow_tf32 = False)", flush=True)


def build_model(vargs: VArgs):
    """The bundle the flags name, of the preset ``--model``:
    ``--dev_tiny`` the tiny random fp32 model of its topology on the CPU;
    ``--dev_full_random`` the full-size bundle with every parameter 0.01 on
    the card; else the checkpoint ``--ckpt_path`` with the CLIP BPE
    vocabulary ``--bpe_path``, on the card."""
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
    from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer

    if vargs.dev_tiny:
        return LatentVideoDiffusion.init_random(
            model_config(vargs.model, tiny=True), torch.Generator().manual_seed(vargs.seed % (2**31)),
            device="cpu", tokenizer=HashTokenizer(512),
        )
    if vargs.dev_full_random:
        return LatentVideoDiffusion.init_constant(model_config(vargs.model, vargs.dtype),
                                                  tokenizer=HashTokenizer(49408))
    return load_bundle(vargs.ckpt_path, vargs.bpe_path, model_config(vargs.model, vargs.dtype))


def model_config(name: str, dtype: str = "bfloat16", tiny: bool = False):
    """The preset ``name`` of ``config.PRESETS`` in ``dtype``; with ``tiny``
    the tiny fp32 test model of its topology."""
    from dynamicscaler_tpu_torch import config

    if tiny:
        return config.tiny_dynamicrafter_config() if name == "dynamicrafter_1024" else config.tiny_test_config(True)
    return config.PRESETS[name](dtype)


def load_bundle(ckpt_path: str, bpe_path: str, config, cached: bool = False):
    """The VideoCrafter checkpoint ``ckpt_path`` for ``config`` with the CLIP
    BPE vocabulary ``bpe_path``, on the card (both CLIPs). ``cached``
    reads the converted state dicts through ``utils.checkpoint.load_or_convert``
    (a cache file beside the checkpoint, written on first use), as the
    single-clip CLI does."""
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
    from dynamicscaler_tpu_torch.utils.checkpoint import load_or_convert
    from dynamicscaler_tpu_torch.utils.tokenizer import load_tokenizer
    from dynamicscaler_tpu_torch.utils.weights import load_videocrafter_checkpoint

    if not torch.cuda.is_available():
        raise RuntimeError("the model runs on the CUDA card and none is available (--dev_tiny runs on the CPU)")
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"checkpoint not found: {ckpt_path}")
    tokenizer = load_tokenizer(bpe_path or None)
    state_dicts = (load_or_convert if cached else load_videocrafter_checkpoint)(ckpt_path, config)
    return LatentVideoDiffusion.build(config, "cuda", tokenizer).load_state_dicts(**state_dicts)


def site_seed(seed: int, site: int) -> int:
    """The seed of the generator at one noise draw site: 1 stage 1, 2 stage
    2, 3 the re-noise before stage 3, 4 stage 3 (the JAX CLI's fold-in
    indices of its key)."""
    return int(np.random.SeedSequence([seed % (2**31), site]).generate_state(1)[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _stage1_profile(profile_dir: str, device: torch.device):
    """A torch.profiler trace of the block, written as a Chrome trace into
    ``profile_dir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
        _sync(device)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "stage1_trace.json")
    prof.export_chrome_trace(path)
    print(f"[stage1] profiler trace -> {path}", flush=True)


def main(vargs: VArgs, _model=None, _noise=None):
    """Run the three stages; returns the output directory. ``_model``
    replaces :func:`build_model`'s bundle. ``_noise`` (tests only) maps a
    draw site (see :func:`site_seed`) to a ``noise_fn(name, shape)`` that
    replaces that site's generator: the samplers' ``noise_fn``, and for
    site 3 the re-noise drawn under the name ``re_noise``. With
    ``--data_parallel_devices`` N > 1 it builds the kernels, starts the N
    ranks (:func:`_mesh_rank`) and returns when every rank has finished;
    ``_model`` and ``_noise`` are then refused (each rank builds its own)."""
    check_flags(vargs)
    n = vargs.data_parallel_devices
    if n <= 1:
        return run(vargs, _model, _noise)
    if _model is not None or _noise is not None:
        raise ValueError("_model and _noise hand objects to one process; the ranks build their own")
    from dynamicscaler_tpu_torch.parallel.mesh import launch

    # one output directory for every rank, named here
    vargs = dataclasses.replace(vargs, project_name=vargs.project_name or time.strftime("pano-%Y%m%d-%H%M%S"))
    if not vargs.dev_tiny:
        from dynamicscaler_tpu_torch.ops import cuda_lib

        cuda_lib.build()  # once, before the ranks start: N nvcc runs would race into build/
    launch(_mesh_rank, n, args=(vargs,), device_type="cpu" if vargs.dev_tiny else "cuda")
    return os.path.join(vargs.output_dir, vargs.project_name)


def _mesh_rank(rank: int, vargs: VArgs) -> None:
    """One rank of a ``--data_parallel_devices`` run (``parallel.mesh.launch``
    joined it to the group and set its card)."""
    from dynamicscaler_tpu_torch.parallel.mesh import make_mesh

    run(vargs, mesh=make_mesh(n_data=vargs.data_parallel_devices))


def run(vargs: VArgs, _model=None, _noise=None, mesh=None):
    """The three stages in this process (:func:`main`'s one-process run, or
    one rank of ``mesh``), on flags :func:`main` has checked; returns the
    output directory."""
    from dynamicscaler_tpu_torch.ops.ddim import draw_noise, re_noise
    from dynamicscaler_tpu_torch.ops.resize import resize_video_latent
    from dynamicscaler_tpu_torch.parallel.mesh import replicate
    from dynamicscaler_tpu_torch.pipelines import i2v, planar, sphere
    from dynamicscaler_tpu_torch.pipelines.t2v import make_schedule_for_model
    from dynamicscaler_tpu_torch.utils.io import load_image, load_latent, save_latent, save_video, to_uint8_device

    setup_precision(vargs.dtype, vargs.dev_tiny)
    writes = mesh is None or mesh.rank == 0  # rank 0 alone writes and reports
    log = print if writes else (lambda *a, **kw: None)
    t_start = time.time()
    stage_secs = {}  # wall seconds per stage
    stage_steady = {}  # steady s/step per stage (LOOP_STATS)
    if vargs.dev_tiny:
        # shrink all geometry to the tiny model (smoke/orchestration test)
        vargs = dataclasses.replace(
            vargs,
            height=16, width=16, total_f=4,
            equirect_width=64, equirect_height=32,
            num_inference_steps=4, denoise_to_step=3,
            loop_step_theta=2, loop_step_hw=2, loop_step_frame=2,
            phi_num=3, view_fov=110, merge_prev_step=2,
            upscale_factor=2, num_windows_w_2=4, num_windows_h_2=2,
        )
    model = _model if _model is not None else build_model(vargs)
    dev = model.device
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"[setup] {model.config.dtype} model on {dev} ({device_name}) at {time.time() - t_start:.1f}s",
        flush=True)
    if mesh is not None:
        replicate(model, mesh)
        log(f"[mesh] window batch split over {mesh.size} ranks ({mesh.n_data} x {mesh.n_seq}), one process a "
            f"{'card' if dev.type == 'cuda' else 'CPU rank'}, rank 0's weights broadcast", flush=True)
    vs = model.config.vae.spatial_scale

    out_dir = os.path.join(vargs.output_dir, vargs.project_name or time.strftime("pano-%Y%m%d-%H%M%S"))
    if writes:
        os.makedirs(out_dir, exist_ok=True)
    if vargs.dev_full_random and not os.path.exists(vargs.pano_image_path):
        path = os.path.join(out_dir, "synthetic_pano.png")
        if writes:
            from PIL import Image

            h0, w0 = vargs.equirect_height, vargs.equirect_width
            yy, xx = np.mgrid[0:h0, 0:w0]
            img = np.stack([xx % 256, yy % 256, (xx + yy) % 256], -1).astype(np.uint8)
            Image.fromarray(img).save(path)
        if mesh is not None:
            mesh.barrier()  # the other ranks read rank 0's file
        vargs = dataclasses.replace(vargs, pano_image_path=path)
    if writes:
        with open(os.path.join(out_dir, "args.json"), "w") as f:
            json.dump(dataclasses.asdict(vargs), f, indent=2)

    def noise_source(site):
        """(generator, noise_fn) of one draw site."""
        if _noise is not None:
            return None, _noise(site)
        return torch.Generator(device=dev).manual_seed(site_seed(vargs.seed, site)), None

    # view grid (gen_pano_360.py:444-455)
    thetas = [360 * t // vargs.phi_num for t in range(vargs.phi_num)]
    phi_theta_dict = {
        90: [0], -90: [0],
        75: thetas, -75: thetas, 60: thetas, -60: thetas,
        45: thetas, -45: thetas, 0: thetas,
    }
    phi_prompt_dict = (
        {float(k): v for k, v in json.loads(vargs.phi_prompt_json).items()}
        if vargs.phi_prompt_json
        else {float(k): v for k, v in DEFAULT_PHI_PROMPT.items()}
    )

    S = vargs.num_inference_steps
    # per-step frame-overlap schedules (gen_pano_360.py:477-485)
    ov_org = [0.75, 0.5]
    overlap_list_f = [ov_org[i * len(ov_org) // S] for i in range(S)]
    merge_prev_list = (
        [
            vargs.max_merge_denoised_overlap_latent_ratio * (1 - t / vargs.merge_prev_step)
            for t in range(vargs.merge_prev_step)
        ]
        + [0.0] * (S - vargs.merge_prev_step)
        if vargs.merge_denoised
        else None
    )

    use_skip = vargs.skip_time_step >= 0
    skip_idx = max(vargs.skip_time_step, 0)

    eq_w, eq_h = vargs.equirect_width, vargs.equirect_height
    nw_w2 = vargs.num_windows_w_2 or vargs.num_windows_hw_2
    nw_h2 = vargs.num_windows_h_2 or vargs.num_windows_hw_2
    sphere_scale = vargs.upscale_factor if vargs.skip_1x else 2
    frames = 4 if vargs.dev_tiny else 16
    common = dict(
        height=vargs.height,
        width=vargs.width,
        frames=frames,
        fps=vargs.fps,
        guidance_scale=vargs.guidance_scale,
        num_inference_steps=S,
        total_f=vargs.total_f,
        dock_at_f=vargs.dock_at_f,
        overlap_ratio_list_f=overlap_list_f,
        loop_step_frame=vargs.loop_step_frame,
        merge_prev_denoised_ratio_list=merge_prev_list,
        overlap_mode=vargs.overlap_mode,
        guidance_rescale=vargs.guidance_rescale,
    )
    planar_kw = dict(
        loop_step=vargs.loop_step_hw,
        use_skip_time=True,
        skip_time_step_idx=vargs.denoise_to_step,
        progressive_skip=False,
        merge_renoised_overlap_latent_ratio=vargs.merge_renoised_overlap_latent_ratio,
        unet_microbatch=vargs.unet_microbatch,
        decode=writes,  # the other ranks write no video
        mesh=mesh,
        **common,
    )
    # per stage on a mesh: (window batches, seconds in their collectives: rank 0's inputs broadcast, the eps
    # gathered)
    stage_gather = {}

    def gathered(stage):
        if mesh is not None:
            stage_gather[stage] = mesh.take_gather_seconds()

    # ---- STAGE 1: sphere panorama (gen_pano_360.py:227-272) ---------------
    t_stage = time.time()
    if vargs.predenoised_SP_latent_path:
        log(f"[stage1] loading sphere latent from {vargs.predenoised_SP_latent_path}", flush=True)
        sphere_latent = torch.as_tensor(load_latent(vargs.predenoised_SP_latent_path), dtype=torch.float32,
                                        device=dev)
    else:
        pano_big = load_image(vargs.pano_image_path, eq_h * sphere_scale, eq_w * sphere_scale)
        log(f"[stage1] sphere pano denoise at {eq_w * sphere_scale}x{eq_h * sphere_scale}", flush=True)
        generator, noise_fn = noise_source(1)
        with _stage1_profile(vargs.profile_dir, dev) if vargs.profile_dir and writes else contextlib.nullcontext():
            _, sphere_latent, _ = sphere.sample_shift_sphere_panorama(
                model,
                vargs.prompt,
                pano_big,
                equirect_width=eq_w * sphere_scale,
                equirect_height=eq_h * sphere_scale,
                phi_theta_dict=phi_theta_dict,
                phi_prompt_dict=phi_prompt_dict,
                view_fov=vargs.view_fov,
                loop_step_theta=vargs.loop_step_theta,
                denoise_to_step=vargs.denoise_to_step,
                paste_on_static=True,
                view_get_scale_factor=vargs.view_get_scale_factor,
                view_set_scale_factor=vargs.view_set_scale_factor,
                merge_renoised_overlap_latent_ratio=vargs.merge_renoised_overlap_latent_ratio,
                use_skip_time=use_skip,
                skip_time_step_idx=skip_idx,
                progressive_skip=use_skip,
                unet_microbatch=vargs.unet_microbatch,
                generator=generator,
                noise_fn=noise_fn,
                mesh=mesh,
                **common,
            )
        if vargs.save_latents and writes:
            save_latent(sphere_latent, os.path.join(out_dir, "sphere_SW_latent.npy"))
        _sync(dev)
        stage_secs["sphere"] = time.time() - t_stage
        stage_steady["sphere"] = sphere.LOOP_STATS.steady_sec_per_step
        gathered("sphere")
    log(f"[stage1] done at {time.time() - t_start:.1f}s; latent {tuple(sphere_latent.shape)}", flush=True)

    pano_1x = load_image(vargs.pano_image_path, eq_h, eq_w)
    # the videos are encoded and written on threads while the next stage runs
    with ThreadPoolExecutor(max_workers=2, thread_name_prefix="save-video") as writer:
        saves = []

        # ---- STAGE 2: planar 1x (gen_pano_360.py:287-329) ------------------
        basic_latent = None
        t_stage = time.time()
        if not vargs.skip_1x:
            if vargs.predenoised_SW_1x_latent_path:
                log(f"[stage2] loading 1x latent from {vargs.predenoised_SW_1x_latent_path}", flush=True)
                basic_latent = torch.as_tensor(load_latent(vargs.predenoised_SW_1x_latent_path),
                                               dtype=torch.float32, device=dev)
            else:
                init_1x = resize_video_latent(sphere_latent, eq_h // vs, eq_w // vs, mode="nearest")
                log(f"[stage2] planar 1x denoise at {eq_w}x{eq_h}", flush=True)
                generator, noise_fn = noise_source(2)
                video_1x, basic_latent = i2v.sample_shift_multi_windows(
                    model, vargs.prompt, pano_1x, total_w=eq_w, total_h=eq_h, num_windows_w=nw_w2,
                    num_windows_h=nw_h2, init_panorama_latent=init_1x, generator=generator,
                    noise_fn=noise_fn, **planar_kw,
                )
                if writes:
                    if vargs.save_latents:
                        save_latent(basic_latent, os.path.join(out_dir, "basic_SW_latent.npy"))
                    frames_1x = to_uint8_device(video_1x[0]).cpu().numpy()
                    saves.append(writer.submit(save_video, frames_1x, out_dir, "shift_windows", fps=vargs.fps))
                del video_1x
                stage_secs["planar_1x"] = time.time() - t_stage
                stage_steady["planar_1x"] = planar.LOOP_STATS.steady_sec_per_step
                gathered("planar_1x")
            log(f"[stage2] done at {time.time() - t_start:.1f}s", flush=True)

        # ---- STAGE 3: 2x upscale (gen_pano_360.py:345-392) -----------------
        t_stage = time.time()
        if vargs.do_upscale:
            uf = vargs.upscale_factor
            if vargs.skip_1x:
                mixed = sphere_latent
            else:
                sched = make_schedule_for_model(model, S)
                up = resize_video_latent(basic_latent, eq_h // vs * uf, eq_w // vs * uf, mode="bicubic")
                generator, noise_fn = noise_source(3)
                noise = draw_noise(up.shape, dev, generator, noise_fn, "re_noise")
                mixed = re_noise(sched, up, 0, S - vargs.denoise_to_step, noise=noise)
            pano_2x = load_image(vargs.pano_image_path, eq_h * uf, eq_w * uf)
            log(f"[stage3] planar {uf}x upscale denoise at {eq_w * uf}x{eq_h * uf}", flush=True)
            generator, noise_fn = noise_source(4)
            video_2x, latent_2x = i2v.sample_shift_multi_windows(
                model, vargs.prompt, pano_2x, total_w=eq_w * uf, total_h=eq_h * uf, num_windows_w=nw_w2 * uf,
                num_windows_h=nw_h2 * uf, init_panorama_latent=mixed, generator=generator, noise_fn=noise_fn,
                **planar_kw,
            )
            if writes:
                if vargs.save_latents:
                    save_latent(latent_2x, os.path.join(out_dir, "denoised_latent2x.npy"))
                frames_2x = to_uint8_device(video_2x[0]).cpu().numpy()
                saves.append(writer.submit(save_video, frames_2x, out_dir, "SW_2X", fps=vargs.fps))
            del video_2x
            stage_secs["upscale"] = time.time() - t_stage
            stage_steady["upscale"] = planar.LOOP_STATS.steady_sec_per_step
            gathered("upscale")
            log(f"[stage3] done at {time.time() - t_start:.1f}s", flush=True)
        for s in saves:
            s.result()
    total = time.time() - t_start
    if not writes:
        return out_dir
    for stage, secs in stage_secs.items():
        steady = stage_steady[stage]
        print(f"[gen_pano_360] {stage}: {secs:.2f} s wall, steady "
              + ("not measured (fewer than 2 steps)" if steady is None else f"{steady:.4f} s/step")
              + (f", {stage_gather[stage][0]} window batches, {stage_gather[stage][1]:.4f} s in their collectives "
                 "on rank 0"
                 if stage in stage_gather else ""), flush=True)
    e2e = {
        "device": device_name,
        "stages_sec": stage_secs,
        "steady_sec_per_step": stage_steady,
        "total_sec": total,
        "geometry": f"{eq_w}x{eq_h}x{vargs.total_f}f_steps{S}",
        "measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    if mesh is not None:
        e2e.update(ranks=mesh.size, gather_sec={k: sec for k, (_, sec) in stage_gather.items()},
                   gathers={k: n for k, (n, _) in stage_gather.items()})
    with open(os.path.join(out_dir, "e2e.json"), "w") as f:
        json.dump(e2e, f, indent=2)
    print(f"[gen_pano_360] total {total:.1f}s -> {out_dir}", flush=True)
    return out_dir


if __name__ == "__main__":
    main(VArgs.from_args())
