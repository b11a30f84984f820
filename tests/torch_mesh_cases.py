"""The sampler runs of tests/test_torch_mesh.py, shared by the test process
(one process, no mesh) and the gloo ranks it spawns (``parallel.mesh``).
It imports no JAX: a spawned rank imports this module to unpickle its
target."""

import os

import numpy as np
import torch

from dynamicscaler_tpu_torch.config import tiny_test_config
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.parallel import mesh as mesh_lib
from dynamicscaler_tpu_torch.pipelines import i2v, sphere, t2v
from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer

# the i2v sampler at test_torch_i2v.py's stage-2 geometry: 2x2 windows, 8 CFG rows a step
I2V = dict(total_w=64, total_h=48, num_windows_w=2, num_windows_h=2, loop_step=4, height=32, width=32, frames=4,
           fps=8, num_inference_steps=4, total_f=4, use_skip_time=True, skip_time_step_idx=2, decode=False)
# the t2v planar sampler: 2x2 windows of 16x16 latent, 4 frames, 8 CFG rows a step
T2V = dict(num_windows_h=2, num_windows_w=2, height=32, width=32, frames=4, num_inference_steps=2, loop_step=2,
           decode=False)
# one stage-1 step: 5 views in its phase, one frame window, 10 CFG rows
SPHERE = dict(equirect_width=64, equirect_height=32, phi_theta_dict={0.0: [0.0, 120.0, 240.0], 60.0: [0.0, 180.0]},
              view_fov=110, loop_step_theta=2, total_f=4, height=16, width=16, frames=4, num_inference_steps=3,
              denoise_to_step=1)

# name -> (bundle, sampler, overlap mode, UNet microbatch, sampler arguments over the defaults above)
CASES = {
    "t2v last mb2": ("t2v", "t2v", "last", 2, {}),
    "t2v average mb2": ("t2v", "t2v", "average", 2, {}),
    "t2v sequential mb2": ("t2v", "t2v", "sequential", 2, {}),
    # one window: 2 CFG rows, so at 4 ranks two ranks hold none
    "t2v last one window": ("t2v", "t2v", "last", 8, dict(num_windows_h=1, num_windows_w=1)),
    "i2v last mb2": ("i2v", "i2v", "last", 2, {}),
    "i2v last mb8": ("i2v", "i2v", "last", 8, {}),
    "sphere last mb2": ("i2v", "sphere", "last", 2, {}),
}


def bundle(kind, state_dicts):
    """The tiny bundle ``kind`` ("t2v" / "i2v") on the CPU with these weights."""
    cfg = tiny_test_config(img_attention=kind == "i2v")
    return LatentVideoDiffusion.build(cfg, "cpu", tokenizer=HashTokenizer(512)).load_state_dicts(**state_dicts)


def run_case(models, name, panos, i2v_noise, mesh=None):
    """Case ``name`` on ``models`` ({"t2v": ..., "i2v": ...}) and ``panos``
    ({"i2v": ..., "sphere": ...}); the i2v sampler draws its noise through
    ``i2v_noise(name, shape)``, the others from a seeded CPU generator.
    Returns the denoised latent (the sphere step: its latent and denoised
    latent), as numpy."""
    kind, sampler, mode, mb, over = CASES[name]
    model = models[kind]
    gen = torch.Generator().manual_seed(7)
    if sampler == "t2v":
        out = t2v.sample_shift_multi_windows(model, "a red car", overlap_mode=mode, unet_microbatch=mb,
                                             generator=gen, mesh=mesh, **dict(T2V, **over))[1:]
    elif sampler == "i2v":
        out = i2v.sample_shift_multi_windows(model, "a lake", panos["i2v"], overlap_mode=mode, unet_microbatch=mb,
                                             noise_fn=i2v_noise, mesh=mesh, **I2V)[1:]
    else:
        out = sphere.sample_shift_sphere_panorama(model, "ocean", panos["sphere"], overlap_mode=mode,
                                                  unet_microbatch=mb, generator=gen, mesh=mesh, **SPHERE)[1:]
    return [o.numpy() for o in out]


def rank_main(rank, state_dicts, panos, draws, out_dir):
    """One gloo rank: every case on the mesh of all ranks (the i2v noise
    the ``draws`` the test process recorded by name), each result saved as
    ``<out_dir>/<rank>/<case>.npz``; ``apply_sharded`` on a batch and
    contexts that differ by rank (``inputs.npz``); and a tiny UNet seeded by
    rank, made equal to rank 0's by ``replicate``, saved as ``unet.npz``."""
    mesh = mesh_lib.make_mesh()
    models = {k: mesh_lib.replicate(bundle(k, sd), mesh) for k, sd in state_dicts.items()}
    d = os.path.join(out_dir, str(rank))
    os.makedirs(d)
    for name in CASES:
        np.savez(os.path.join(d, f"{name}.npz"), *run_case(models, name, panos, lambda n, shape: draws[n], mesh))
    # each rank hands apply_sharded its own batch and contexts: the shares are cut from rank 0's
    x = torch.arange(48.0).reshape(6, 2, 4) + 100 * rank
    ctx = torch.arange(18.0).reshape(6, 3) * (rank + 1)
    got = mesh_lib.apply_sharded(mesh, lambda xs, cs: xs * cs.sum(-1)[:, None, None], x, ctx, microbatch=2)
    np.savez(os.path.join(d, "inputs.npz"), got.numpy())
    own = LatentVideoDiffusion.init_random(tiny_test_config(False), torch.Generator().manual_seed(100 + rank),
                                           device="cpu").unet
    flat = [torch.cat([v.flatten().float() for v in own.state_dict().values()]).numpy()]
    mesh_lib.replicate(own, mesh)
    flat.append(torch.cat([v.flatten().float() for v in own.state_dict().values()]).numpy())
    np.savez(os.path.join(d, "unet.npz"), before=flat[0], after=flat[1])


def sleeper(rank, seconds):
    """A rank that outlasts its launch's time limit."""
    import time

    time.sleep(seconds)
