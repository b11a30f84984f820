"""The tiny i2v sampler over several ranks: the counterpart of the JAX
package's ``dryrun_multichip`` (``__graft_entry__.py``).

    python -m dynamicscaler_tpu_torch.parallel.dryrun 4          # 4 gloo ranks on the CPU

It runs ``pipelines.i2v.sample_shift_multi_windows`` at the JAX dryrun's
geometry (4 x 2 windows of 16x16 pixels and 4 frames over a 64x32x4
panorama, loop step 2, 2 steps, decode on) on the tiny i2v model, built on
every rank from one seed and made equal by ``mesh.replicate``, on a mesh of
the JAX dryrun's shape (``n_seq`` 2 where the rank count is even and at
least 4). Every rank checks the shapes and finiteness, and that every rank
holds the same denoised latent bit for bit. The JAX dryrun also checks that
its latent stays W-sharded over ``seq``; here the latent is whole on every
rank by design (``parallel/mesh.py``), so that check has no counterpart.
The ranks run on the CPU: the tiny model's attention heads (16 channels)
are outside the card kernels' gates (head dim 64), so on the card the
multi-rank check is ``chip_multi.py`` at full width.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dynamicscaler_tpu_torch.parallel import mesh as mesh_lib

RANK_TIMEOUT_S = 300.0


def _dryrun_rank(rank: int, n_devices: int) -> None:
    from dynamicscaler_tpu_torch.config import tiny_test_config
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
    from dynamicscaler_tpu_torch.pipelines import i2v
    from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer

    n_seq = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = mesh_lib.make_mesh(n_data=n_devices // n_seq, n_seq=n_seq)
    dev = mesh.device
    model = LatentVideoDiffusion.init_random(tiny_test_config(img_attention=True),
                                             torch.Generator(device=dev).manual_seed(0), device=dev,
                                             tokenizer=HashTokenizer(512))
    mesh_lib.replicate(model, mesh)
    pano = np.zeros((32, 64, 3), np.float32)
    video, den = i2v.sample_shift_multi_windows(
        model, "dryrun", pano, total_w=64, total_h=32, total_f=4, num_windows_w=4, num_windows_h=2, loop_step=2,
        height=16, width=16, frames=4, num_inference_steps=2, mesh=mesh,
        generator=torch.Generator(device=dev).manual_seed(1), decode=True,
    )
    if tuple(den.shape) != (1, 4, 16, 32, 4) or tuple(video.shape) != (1, 4, 32, 64, 3):
        raise AssertionError(f"rank {rank}: denoised {tuple(den.shape)}, video {tuple(video.shape)}")
    if not (bool(torch.isfinite(den).all()) and bool(torch.isfinite(video).all())):
        raise AssertionError(f"rank {rank}: non-finite output in the multi-rank dryrun")
    every = den.new_empty((mesh.size * den.shape[0],) + tuple(den.shape[1:]))
    mesh.all_gather(every, den.contiguous())
    differ = [r for r in range(mesh.size) if not torch.equal(every[r:r + 1], den)]
    if differ:
        raise AssertionError(f"rank {rank}: the denoised latent of ranks {differ} differs from this rank's")
    if rank == 0:
        print(f"dryrun_multichip ok: mesh={{'data': {mesh.n_data}, 'seq': {mesh.n_seq}}} on {dev.type}, "
              f"denoised {tuple(den.shape)} equal on {mesh.size} ranks, video {tuple(video.shape)}", flush=True)


def dryrun_multichip(n_devices: int) -> None:
    """The tiny i2v sampler over ``n_devices`` gloo ranks on the CPU. Raises
    if a rank fails a check or the ranks outlast :data:`RANK_TIMEOUT_S`."""
    mesh_lib.launch(_dryrun_rank, n_devices, args=(n_devices,), device_type="cpu", timeout=RANK_TIMEOUT_S)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("n_devices", type=int)
    dryrun_multichip(parser.parse_args().n_devices)
