"""Whole runs of each cell at the program's tiny sizes on the CPU, past the
harness's look for a card: the sound program is correct; each fault the
cells can have, planted underneath the timed path, and the fp8 control
come out not correct. The command itself refuses to run without a card."""

import contextlib
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import control, harness
from portbench.tests.tiny import tiny_spec

CELLS = ["i2v_sphere_2k", "t2v_loop_wide", "i2v_planar_1x"]
SEED = 2 ** 31 + 12345


def run(cell, fault=None):
    t0 = time.perf_counter()
    return harness.run_cell(cell, SEED, 0.5, False, t0, device="cpu", spec=tiny_spec(cell), fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in harness.Spec(cell).end_to_end} and r["attempted"] >= 1
    assert {m.split(".")[0] for m in r["metrics"]} == {"step_s", "setup_s"}


@contextlib.contextmanager
def unchanged_state(model):
    """Every DDIM step returns its state unchanged."""
    from dynamicscaler_tpu_torch.pipelines import planar, sphere

    s, p = sphere._Sampler.step, planar.PlanarShiftWindowEngine.step
    sphere._Sampler.step = lambda self, latent, denoised, *a: (latent.clone(), denoised.clone())
    planar.PlanarShiftWindowEngine.step = lambda self, *a, **kw: None
    try:
        yield
    finally:
        sphere._Sampler.step, planar.PlanarShiftWindowEngine.step = s, p


@contextlib.contextmanager
def eps_fault(model, how):
    real = model.apply_unet_microbatched

    def broken(x, *a, **kw):
        if how == "half":  # half of the batch left out: its rows keep zero eps
            n = x.shape[0] // 2
            eps = real(x[:n], *a[:1], a[1][:n], *a[2:], **kw)
            return torch.cat([eps, torch.zeros_like(eps)])
        return real(x, *a, **kw) * 1.5  # every eps altered where it is produced
    model.apply_unet_microbatched = broken
    try:
        yield
    finally:
        del model.apply_unet_microbatched


FAULTS = {"unchanged_state": unchanged_state,
          "half_batch": lambda m: eps_fault(m, "half"),
          "altered_eps": lambda m: eps_fault(m, "altered")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    r = run(cell, FAULTS[fault])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_number(cell):
    checks = control.readings(cell, SEED, torch.device("cpu"), tiny_spec(cell))
    assert any(c["value"] > c["limit"] for c in checks), checks


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT,
                         timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
