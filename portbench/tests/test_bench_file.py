"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, traffic mix, driver, metric reader and limit file by
the names in it."""

import importlib
import json
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_names_and_units():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[key]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[key]}) == len(BENCH[key])


@pytest.mark.parametrize("cell", CELLS)
def test_harness_finds_every_part(cell):
    spec = harness.Spec(cell, BENCH)
    assert spec.config["name"] == spec.workload["config"]
    assert hasattr(spec.driver(), "Driver") and hasattr(spec.driver(), "check")
    for m in spec.per_layer:
        assert callable(spec.reader(m["name"]).read)
    assert spec.end_to_end and spec.per_layer
    conf = {c["name"]: c for c in BENCH["configs"]}[spec.workload["config"]]
    assert harness.load_json(harness.ROOT / conf["file"]) == spec.config
    assert set(spec.limits) >= {"init", "eps", "state"}


def test_every_metric_has_a_reader_and_every_cell_its_metrics():
    for m in BENCH["per_layer"]:
        importlib.import_module(f"portbench.metrics.{m['name'].split('.')[0]}")
    for cell in CELLS:
        spec = harness.Spec(cell, BENCH)
        reported = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert all(m["moves"] in reported for m in spec.per_layer)
