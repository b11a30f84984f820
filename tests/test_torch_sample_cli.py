"""The PyTorch port's single-clip CLI (``cli/sample.py``) against the JAX
package's, on the CPU.

* ``parse_args`` defaults and parsing equal to the JAX CLI's;
  ``parse_traj_spec`` equal to JAX's, and an empty spec refused.
* Each mode on ``--dev_tiny`` (the tiny random fp32 model, 32x32, 4 frames,
  4 steps; FIFO 8 output frames) writing its video through ``save_video``.
* The t2v and FIFO latents of ``main`` against the JAX CLI's: both CLIs
  run the tiny t2v twin bundle (the JAX CLI's ``init_random`` returns the
  JAX twin), the port handed the JAX draws of ``--seed`` through
  ``main(..., _noise=)``; each sampler's latent is read where ``main``
  calls it, within ``close_fp32_chain``.
* The startup refusals: ``--dtype float32`` on the card, ``freetraj``
  without ``--traj``, ``i2v`` without ``--image``.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dynamicscaler_tpu.cli import sample as jsample
from dynamicscaler_tpu.models.lvdm import LatentVideoDiffusion as JLVDM
from dynamicscaler_tpu.pipelines import fifo as jfifo
from dynamicscaler_tpu.pipelines import t2v as jt2v
from dynamicscaler_tpu_torch.cli import sample
from dynamicscaler_tpu_torch.pipelines import fifo, t2v
from dynamicscaler_tpu_torch.utils.avi import read_avi_info
from test_torch_fifo import fifo_jax_noise
from torch_port_helpers import close_fp32_chain, t2v_twin_models

TRAJ = "0:0.25-0.75:0.0-0.5;1:0.25-0.75:0.5-1.0"


def test_parse_args_match_jax():
    for argv in (["--prompt", "a cat"],
                 ["--prompt", "a cat", "--mode", "fifo", "--num_frames", "12", "--dev_tiny", "--traj", TRAJ,
                  "--traj_thres", "500", "--guidance_scale", "7.5", "--seed", "3"]):
        assert vars(sample.parse_args(argv)) == vars(jsample.parse_args(argv))
    assert vars(sample.parse_args(["--prompt", "x"]))["mode"] == "t2v"


def test_parse_traj_spec_matches_jax():
    for spec in ("0:0.1-0.4:0.2-0.5; 15:0.5-0.8:0.4-0.7", TRAJ + ";"):
        assert sample.parse_traj_spec(spec) == jsample.parse_traj_spec(spec)
    with pytest.raises(ValueError, match="empty"):
        sample.parse_traj_spec(" ; ")


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    img = np.random.default_rng(0).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    path = tmp_path_factory.mktemp("in") / "cond.png"
    Image.fromarray(img).save(path)
    return str(path)


@pytest.mark.parametrize("mode,frames", [("t2v", 4), ("i2v", 4), ("fifo", 8), ("freetraj", 4)])
def test_dev_tiny_mode_writes_its_video(mode, frames, image, tmp_path):
    args = sample.parse_args(["--mode", mode, "--prompt", "a red car", "--dev_tiny", "--traj", TRAJ,
                              "--image", image, "--output_dir", str(tmp_path)])
    path = sample.main(args)
    assert path == str(tmp_path / "a_red_car.avi")  # no mp4 backend here: the AVI + PNG writer
    info = read_avi_info(path)
    assert (info["frames"], info["height"], info["width"], info["fps"]) == (frames, 32, 32, 8)
    assert len(os.listdir(tmp_path / "a_red_car_frames")) == frames


@pytest.mark.parametrize("argv,match", [
    (["--dtype", "float16"], "bfloat16 only"),
    (["--mode", "freetraj", "--dev_tiny"], "--traj"),
    (["--mode", "i2v", "--dev_tiny"], "--image"),
])
def test_main_refuses_at_startup(argv, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        sample.main(sample.parse_args(["--prompt", "x", "--output_dir", str(tmp_path), *argv]))
    assert not os.listdir(tmp_path)


def _capture(monkeypatch, module, name, store):
    """Wrap ``module.name`` (a sampler returning (video, latent)) to keep
    the latent in ``store``."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        video, latent = fn(*a, **kw)
        store.append(np.array(latent))
        return video, latent

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("mode", ["t2v", "fifo"])
def test_main_latents_match_jax(mode, tmp_path, monkeypatch):
    jmodel, tmodel = t2v_twin_models(seed=31)
    seed = 5
    monkeypatch.setenv("DSCALER_NO_COMPILE_CACHE", "1")  # keep the suite's compile cache where conftest put it
    monkeypatch.setattr(JLVDM, "init_random", classmethod(lambda cls, *a, **kw: jmodel))
    jl, tl = [], []
    jmod, tmod, name = (jt2v, t2v, "basic_sample") if mode == "t2v" else (jfifo, fifo, "fifo_sample")
    _capture(monkeypatch, jmod, name, jl)
    _capture(monkeypatch, tmod, name, tl)
    argv = ["--mode", mode, "--prompt", "a sailing boat", "--dev_tiny", "--seed", str(seed)]
    jsample.main(jsample.parse_args(argv + ["--output_dir", str(tmp_path / "jax")]))
    key = jax.random.PRNGKey(seed)
    noise = (lambda n, shape: np.array(jax.random.normal(key, shape))) if mode == "t2v" else \
        fifo_jax_noise(key, "ddim")
    path = sample.main(sample.parse_args(argv + ["--output_dir", str(tmp_path / "port")]), _model=tmodel,
                       _noise=noise)
    assert os.path.exists(path) and len(jl) == len(tl) == 1
    assert tl[0].shape == jl[0].shape == ((1, 4, 16, 16, 4) if mode == "t2v" else (1, 8, 16, 16, 4))
    close_fp32_chain(torch.from_numpy(tl[0]), jl[0])
