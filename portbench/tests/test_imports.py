"""What a run loads: no JAX and no JAX package (top-level names compared
whole, so the port's ``dynamicscaler_tpu_torch`` passes), and a reference
that loads nothing of the program."""

import json
import subprocess
import sys

from portbench import harness

FORBIDDEN = ["jax", "jaxlib", "flax", "dynamicscaler_tpu"]


def loaded_by(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = ("import portbench.run, portbench.harness, portbench.check, portbench.control, portbench.trace\n"
            "from portbench import harness\n"
            "for w in [w['name'] for w in harness.load_json(harness.ROOT / 'BENCHMARK.json')['workloads']]:\n"
            "    s = harness.Spec(w); s.driver(); [s.reader(m['name']) for m in s.per_layer]\n"
            "from dynamicscaler_tpu_torch.pipelines import sphere, t2v, planar\n"
            "from dynamicscaler_tpu_torch.models import lvdm\n")
    mods = loaded_by(code)
    assert "dynamicscaler_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded_by("import portbench.reference.nets, portbench.reference.pipeline, portbench.reference.lowp, "
                     "portbench.flops, portbench.inputs")
    assert not mods & {"dynamicscaler_tpu_torch", *FORBIDDEN}


def test_jax_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dynamicscaler_tpu_torchx", sys)
    assert harness.jax_modules() == [] or set(harness.jax_modules()) <= set(FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.jax_modules()
