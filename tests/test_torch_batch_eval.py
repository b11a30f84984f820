"""The PyTorch port's batch eval (``cli/batch_eval.py``, with
``parallel/dist.py``) against the JAX package's, on the CPU.

* ``parse_args`` (the distributed flags too) equal to JAX's.
* The prompt shard: rank 1 of 2 writes only prompt two.
* ``--mode i2v`` with one PNG and one MJPEG AVI as conditioning files,
  each clip conditioned on ``load_first_frame`` of its file; a count of
  files other than the prompts' refused with JAX's message (a ValueError
  here, JAX's an AssertionError); the card route's refusals (``--dtype``
  other than bfloat16 or float32, no card).
* Without a process group the rank is 0 of 1; a coordinator without the
  rank and the size refused.
* Each prompt's latent against the JAX CLI's on the tiny t2v twin bundle,
  the port handed the JAX ``fold_in(PRNGKey(seed), rank * 100003 + i)``
  draws through ``main(..., _noise=)``, within ``close_fp32_chain``.
* Two coordinated processes on gloo (``--dev_tiny``, the ``DSCALER_*``
  environment), each writing exactly its shard: the counterpart of
  ``tests/test_distributed.py``.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dynamicscaler_tpu.cli import batch_eval as jbatch_eval
from dynamicscaler_tpu.models.lvdm import LatentVideoDiffusion as JLVDM
from dynamicscaler_tpu.pipelines import t2v as jt2v
from dynamicscaler_tpu_torch.cli import batch_eval
from dynamicscaler_tpu_torch.parallel import dist
from dynamicscaler_tpu_torch.pipelines import i2v, t2v
from dynamicscaler_tpu_torch.utils.avi import write_mjpeg_avi
from dynamicscaler_tpu_torch.utils.io import load_first_frame
from torch_port_helpers import close_fp32_chain, t2v_twin_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = "a red fox\nan old clock\na paper boat\n"


def _videos(out):
    return sorted(n for n in os.listdir(out) if n.endswith((".avi", ".mp4")))


def test_parse_args_match_jax():
    for argv in (["--prompt_file", "p.txt"],
                 ["--prompt_file", "p.txt", "--mode", "i2v", "--cond_input", "c", "--rank", "1", "--world_size",
                  "2", "--coordinator", "127.0.0.1:1234", "--num_processes", "2", "--process_id", "1",
                  "--dev_tiny", "--seed", "9", "--guidance_scale", "7.5"]):
        assert vars(batch_eval.parse_args(argv)) == vars(jbatch_eval.parse_args(argv))


def test_no_group_is_rank_0_of_1(monkeypatch):
    for k in ("DSCALER_COORDINATOR", "DSCALER_NUM_PROCESSES", "DSCALER_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.initialize_distributed()
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    dist.barrier("alone")  # no group: returns at once
    monkeypatch.setenv("DSCALER_COORDINATOR", "127.0.0.1:1")  # a coordinator without the rank and the size
    with pytest.raises(ValueError, match="--num_processes and --process_id"):
        dist.initialize_distributed()


def test_rank_1_of_2_writes_prompt_two(tmp_path):
    pf = tmp_path / "prompts.txt"
    pf.write_text(PROMPTS)
    out = tmp_path / "o"
    paths = batch_eval.main(batch_eval.parse_args(["--prompt_file", str(pf), "--dev_tiny", "--output_dir",
                                                   str(out), "--rank", "1", "--world_size", "2"]))
    assert _videos(out) == ["r1_0000_an_old_clock.avi"]  # no mp4 backend here: the AVI + PNG writer
    assert paths == [str(out / "r1_0000_an_old_clock.avi")]


def _conds(tmp_path, n_png=1, n_avi=1):
    cond = tmp_path / "cond"
    cond.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n_png):
        Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(cond / f"a{i}.png")
    for i in range(n_avi):
        frames = [rng.integers(0, 256, (24, 40, 3), dtype=np.uint8) for _ in range(3)]
        write_mjpeg_avi(str(cond / f"b{i}.avi"), frames, fps=8)
    return cond


def test_i2v_mode_pairs_sorted_cond_files(tmp_path, monkeypatch):
    pf = tmp_path / "prompts.txt"
    pf.write_text("alpha\nbeta\n")
    cond = _conds(tmp_path)
    seen = []
    fn = i2v.basic_sample

    def wrapped(model, prompt, cond_image, **kw):
        seen.append((prompt, np.array(cond_image)))
        return fn(model, prompt, cond_image, **kw)

    monkeypatch.setattr(i2v, "basic_sample", wrapped)
    out = tmp_path / "o"
    batch_eval.main(batch_eval.parse_args(["--prompt_file", str(pf), "--dev_tiny", "--mode", "i2v", "--cond_input",
                                           str(cond), "--output_dir", str(out)]))
    assert _videos(out) == ["r0_0000_alpha.avi", "r0_0001_beta.avi"]
    assert [p for p, _ in seen] == ["alpha", "beta"]
    for (_, img), f in zip(seen, ("a0.png", "b0.avi")):
        np.testing.assert_array_equal(img, load_first_frame(str(cond / f), 32, 32))


def test_cond_count_mismatch_refused_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DSCALER_NO_COMPILE_CACHE", "1")  # keep the suite's compile cache where conftest put it
    pf = tmp_path / "prompts.txt"
    pf.write_text(PROMPTS)
    cond = _conds(tmp_path, n_png=1, n_avi=1)
    argv = ["--prompt_file", str(pf), "--dev_tiny", "--mode", "i2v", "--cond_input", str(cond), "--output_dir",
            str(tmp_path / "o")]
    with pytest.raises(ValueError) as ours:
        batch_eval.main(batch_eval.parse_args(argv))
    with pytest.raises(AssertionError) as theirs:
        jbatch_eval.main(jbatch_eval.parse_args(argv))
    assert str(ours.value) == str(theirs.value) == "cond inputs (2) != prompts (3) (inference.py:82 requires 1:1)"
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("argv,error,match", [
    (["--dtype", "float16"], ValueError, "bfloat16 only"),
    (["--ckpt_path", "t2v.ckpt"], RuntimeError, "CUDA card"),
])
def test_card_route_refusals(argv, error, match, tmp_path, monkeypatch):
    """Without ``--dev_tiny`` the bundle goes on the rank's card:
    ``--dtype`` other than bfloat16 or float32 is refused at startup, and so
    is a machine without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pf = tmp_path / "prompts.txt"
    pf.write_text(PROMPTS)
    with pytest.raises(error, match=match):
        batch_eval.main(batch_eval.parse_args(["--prompt_file", str(pf), "--output_dir", str(tmp_path / "o"),
                                               *argv]))
    assert not os.path.exists(tmp_path / "o")


def test_latents_match_jax(tmp_path, monkeypatch):
    """Rank 1 of 2 over four prompts: prompts 1 and 3, fold-in sites 100003
    and 100004."""
    monkeypatch.setenv("DSCALER_NO_COMPILE_CACHE", "1")
    jmodel, tmodel = t2v_twin_models(seed=51)
    monkeypatch.setattr(JLVDM, "init_random", classmethod(lambda cls, *a, **kw: jmodel))
    jl, tl = [], []
    for mod, store in ((jt2v, jl), (t2v, tl)):
        fn = mod.basic_sample

        def wrapped(*a, fn=fn, store=store, **kw):
            video, latent = fn(*a, **kw)
            store.append(np.array(latent))
            return video, latent

        monkeypatch.setattr(mod, "basic_sample", wrapped)
    pf = tmp_path / "prompts.txt"
    pf.write_text("one\ntwo\nthree\nfour\n")
    seed = 4
    argv = ["--prompt_file", str(pf), "--dev_tiny", "--rank", "1", "--world_size", "2", "--seed", str(seed)]
    jbatch_eval.main(jbatch_eval.parse_args(argv + ["--output_dir", str(tmp_path / "jax")]))
    sites = []

    def noise(site):
        sites.append(site)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), site)
        return lambda name, shape: np.array(jax.random.normal(key, shape))

    batch_eval.main(batch_eval.parse_args(argv + ["--output_dir", str(tmp_path / "port")]), _model=tmodel,
                    _noise=noise)
    assert sites == [100003, 100004]
    assert _videos(tmp_path / "port") == ["r1_0000_two.avi", "r1_0001_four.avi"]
    assert len(jl) == len(tl) == 2
    for got, ref in zip(tl, jl):
        assert got.shape == ref.shape == (1, 4, 16, 16, 4)
        close_fp32_chain(torch.from_numpy(got), ref)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_coordinated_gloo_processes(tmp_path):
    pf = tmp_path / "prompts.txt"
    pf.write_text(PROMPTS)
    out = tmp_path / "out"
    port = _free_port()
    procs = []
    for pid in (0, 1):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", DSCALER_COORDINATOR=f"127.0.0.1:{port}",
                   DSCALER_NUM_PROCESSES="2", DSCALER_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamicscaler_tpu_torch.cli.batch_eval", "--prompt_file", str(pf),
             "--dev_tiny", "--output_dir", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        ))
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{log}"
    # the ranks came from the process group, not from flags
    assert "rank 0/2: 2/3 prompts" in logs[0] and "rank 1/2: 1/3 prompts" in logs[1], logs
    assert _videos(out) == ["r0_0000_a_red_fox.avi", "r0_0001_a_paper_boat.avi", "r1_0000_an_old_clock.avi"]
