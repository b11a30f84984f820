"""One run of one benchmark cell: build the program from the seed, warm it up,
drive the cell's traffic through the measured window, read the metrics,
then judge what the timed path produced against the frozen reference.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own that this module finds by the name in
``BENCHMARK.json``:

* ``configs/<config>.json``: the configuration as it is run;
* ``mixes/<traffic>.json``: the traffic mix, a ``kind`` and its parameters,
  read by the driver ``traffic/<kind>.py``;
* ``metrics/<name>.py``: the reader of a per-layer metric;
* ``limits/<workload>.json``: the limit of each number the check compares.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

import torch

from portbench import flops, inputs
from portbench.reference import nets

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "dynamicscaler_tpu")


class StopWindow(Exception):
    """Raised at the first step boundary after the window's length."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """A cell as ``BENCHMARK.json`` and the files it names give it."""

    def __init__(self, workload: str, bench: dict = None, config: dict = None, mix: dict = None):
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
        self.workload = cells[workload]
        self.name = workload
        self.chips = self.workload["chips"]
        self.config = config or load_json(HERE / "configs" / f"{self.workload['config']}.json")
        self.mix = mix or load_json(HERE / "mixes" / f"{self.workload['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{workload}.json")

        def here(m):
            return "workloads" not in m or workload in m["workloads"]
        self.end_to_end = [m for m in bench["end_to_end"] if here(m)]
        self.per_layer = [m for m in bench["per_layer"] if here(m)]

    def driver(self):
        return importlib.import_module(f"portbench.traffic.{self.mix['kind']}")

    def reader(self, metric: str):
        """The reader of a per-layer metric: ``metrics/<name>.py``, where a
        name's part after its first dot names the cells it is split for."""
        return importlib.import_module(f"portbench.metrics.{metric.split('.')[0]}")


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------


def port_model(spec: Spec, weights: dict, device, tokenizer):
    """The program's model bundle at the configuration, holding ``weights``."""
    from dynamicscaler_tpu_torch import config as pc
    from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion

    m = spec.config["model"]

    def t(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    cfg = pc.ModelConfig(
        unet=pc.UNetConfig(**t(m["unet"])), vae=pc.VAEConfig(**t(m["vae"])),
        clip_text=pc.CLIPTextConfig(**m["clip_text"]),
        clip_vision=pc.CLIPVisionConfig(**m["clip_vision"]) if m.get("clip_vision") else None,
        resampler=pc.ResamplerConfig(**m["resampler"]) if m.get("resampler") else None,
        diffusion=pc.DiffusionConfig(**m["diffusion"]), dtype=spec.config["dtype"])
    model = LatentVideoDiffusion.build(cfg, "meta", tokenizer)
    for name, mod in model.components():
        mod.to(cfg.torch_dtype).to_empty(device=device)
        mod.load_state_dict(weights[name])
    return model


def served_dtype(spec: Spec, device):
    """The configuration's dtype; on the CPU (tests) fp32, as the program's
    plain paths run there."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[spec.config["dtype"]] if device.type == "cuda" \
        else torch.float32


def vocab(spec: Spec) -> int:
    return spec.config["model"]["clip_text"]["vocab_size"]


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


class Window:
    """The measured window's clock and what happens at each step boundary:
    the first step of the first request warms up and ends set-up, the
    window ends at the first step boundary after ``seconds``; the check's
    captures; in a traced run CUDA events around every step and UNet
    module, and the profiler over ``trace_steps`` steps."""

    def __init__(self, seconds, t0, device, check_step: int, trace: bool, trace_from: int, trace_steps: int):
        self.seconds, self.t0, self.device = seconds, t0, device
        self.check_step = check_step
        self.trace, self.trace_from, self.trace_steps = trace, trace_from, trace_steps
        self.request, self.req_step = 0, -1
        self.start = None  # perf_counter at the window's start
        self.steps = 0  # steps completed inside the window
        self.forwards = []  # batch of each UNet forward in the window
        self.captured = {}  # "start": the first step's state; "step": the check step's
        self._capturing, self._cap = None, None
        self.eps = None
        self.step_events, self.spans, self._open = [], {}, {}
        self.prof, self.prof_window = None, None
        self.end = None
        # set while the cell's check still needs a request's output: the
        # request in flight at the window's end then runs to its end, untimed
        self.finish_request = False

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def open(self) -> bool:
        return self.start is not None and self.end is None

    def new_request(self, r: int):
        self.request, self.req_step = r, -1

    # step boundaries -----------------------------------------------------

    def step_begin(self, state_fn):
        self.req_step += 1
        first = self.request == 0 and self.req_step == 0
        if first:
            self._capturing = "start"
        elif self.request == 0 and "step" not in self.captured:
            self._capturing = "step"
        else:
            self._capturing = None
        if self._capturing:
            self._cap = dict(state_fn(), req_step=self.req_step)
        if self.open and self.trace:
            if self.steps == self.trace_from:
                self._start_profiler()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.step_events.append([ev, None, []])

    def step_end(self, out_fn):
        if self._capturing:
            self._cap.update(out_fn(), eps=self.eps)
            if self._capturing == "start" or self.req_step >= self.check_step:
                self.captured[self._capturing] = self._cap
            else:
                self.captured["last"] = self._cap
            self._capturing, self._cap, self.eps = None, None, None
        if self.start is None:
            self.sync()
            self.start = time.perf_counter()
            return
        if self.end is not None:
            return
        self.steps += 1
        if self.trace:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.step_events[-1][1] = ev
            if self.prof is not None and self.steps == self.trace_from + self.trace_steps:
                self._stop_profiler()
        if time.perf_counter() - self.start >= self.seconds:
            if not self.finish_request:
                raise StopWindow
            self.close()

    def close(self):
        if self.end is None:
            self.sync()
            self.end = time.perf_counter()
        if self.prof is not None:
            self._stop_profiler()
        if "step" not in self.captured and "last" in self.captured:
            self.captured["step"] = self.captured.pop("last")

    @property
    def setup_s(self) -> float:
        return self.start - self.t0

    @property
    def wall_s(self) -> float:
        return self.end - self.start

    # the UNet ----------------------------------------------------------------

    def unet_eps(self, eps):
        if self._capturing:
            self.eps = eps if self.eps is None else torch.cat([self.eps, eps])

    def forward_pre(self, mod, args, kwargs=None):
        if self.open:
            self.forwards.append(int(args[0].shape[0]))

    def span_pre(self, mod, args):
        if self.open:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[id(mod)] = ev

    def span_post(self, mod, args, out):
        ev0 = self._open.pop(id(mod), None)
        if ev0 is None:
            return
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        name = type(mod).__name__
        self.spans.setdefault(name, []).append((ev0, ev1))
        if name == "UNet3D" and self.step_events:
            self.step_events[-1][2].append((ev0, ev1))

    # the profiler ----------------------------------------------------------

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.prof_window = [time.perf_counter(), None]

    def _stop_profiler(self):
        self.sync()
        self.prof_window[1] = time.perf_counter()
        self.prof.stop()
        self.prof_window.append(self.prof)
        self.prof = None


@contextlib.contextmanager
def instrument(model, window: Window, trace: bool):
    """Count the UNet's forwards; record the eps the window's capture
    steps produce; in a traced run, CUDA events around the UNet and its
    module classes."""
    handles = [model.unet.register_forward_pre_hook(window.forward_pre)]
    if trace:
        for m in model.unet.modules():
            if type(m).__name__ in (*flops.CLASSES, "UNet3D"):
                handles += [m.register_forward_pre_hook(window.span_pre), m.register_forward_hook(window.span_post)]
    apply = model.apply_unet_microbatched

    def apply_unet_microbatched(*a, **kw):
        eps = apply(*a, **kw)
        window.unet_eps(eps)
        return eps
    before = model.__dict__.get("apply_unet_microbatched")
    model.apply_unet_microbatched = apply_unet_microbatched
    try:
        yield
    finally:
        if before is None:
            del model.apply_unet_microbatched
        else:
            model.apply_unet_microbatched = before
        for h in handles:
            h.remove()


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


class Readings:
    """What the per-layer readers read: the window's times, counts, spans
    and trace, and the cell's operation counts."""

    def __init__(self, spec: Spec, window: Window, chips: int):
        self.spec, self.window, self.chips = spec, window, chips
        self.steps, self.wall_s = window.steps, window.wall_s
        self.forwards = window.forwards
        self.peak_flops = spec.config["peak_tflops"] * 1e12
        self.peak_bytes = spec.config["peak_bytes_per_s"]
        self.span_s = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3 for k, v in window.spans.items()}
        self.unet_ms = [a.elapsed_time(b) for a, b in window.spans.get("UNet3D", [])]
        self.step_ms = [(s.elapsed_time(e), sum(a.elapsed_time(b) for a, b in fw))
                        for s, e, fw in window.step_events if e is not None]
        self.trace = None
        if window.prof_window and len(window.prof_window) == 3:
            from portbench import trace as trace_mod
            t0, t1, prof = window.prof_window
            self.trace = trace_mod.read(prof, t1 - t0)

    def counts(self, batch: int) -> dict:
        m = self.spec.config["model"]
        g = self.spec.mix["unet_shape"]
        return flops.count_unet(m["unet"], batch, g["frames"], g["h"], g["w"], g["ctx_len"],
                                peak_flops=self.peak_flops, peak_bytes=self.peak_bytes)


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t0: float, device=None, spec: Spec = None,
             fault=None) -> dict:
    """One run; returns the result line's object (``checks`` last). ``spec``
    and ``device`` default to BENCHMARK.json's cell on the card; the CPU
    tests hand in a small one. ``fault(model)`` (tests), a context manager,
    breaks the timed path underneath the harness's instruments."""
    spec = spec or Spec(workload)
    device = torch.device(device or "cuda")
    dtype = served_dtype(spec, device)
    driver_mod = spec.driver()
    tokenizer = inputs.HashTokenizer(vocab(spec))
    mods = nets.build(spec.config["model"])
    weights = inputs.make_weights(mods, seed, dtype, device)
    model = port_model(spec, weights, device, tokenizer)
    del weights
    driver = driver_mod.Driver(model, spec.mix, seed, device)
    mix = spec.mix
    lo, hi = mix["check_steps"]
    window = Window(seconds, t0, device, lo + inputs.derive_seed(seed, "check step") % (hi - lo + 1), trace,
                    mix.get("trace_from", 1), mix.get("trace_steps", 1))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    requests, outputs = 0, []
    with fault(model) if fault else contextlib.nullcontext(), instrument(model, window, trace), \
            driver.installed(window):
        driver.warm()
        try:
            while window.end is None:
                window.finish_request = driver.needs_output and not any(o is not None for o in outputs)
                window.new_request(requests)
                outputs.append(driver.request(requests, window))
                requests += 1
        except StopWindow:
            pass
    window.close()
    result = {"attempted": window.steps, "failed": 0}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    readings = Readings(spec, window, spec.chips)
    if trace:
        metrics = {}
        for m in spec.per_layer:
            v = spec.reader(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"step_s": window.wall_s / max(window.steps, 1), "setup_s": window.setup_s}
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]} for m in spec.end_to_end}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": spec.chips, "memory_peak_bytes": peak}
    if trace and readings.trace is not None:
        dev_info["busy_s"] = readings.trace["busy_s"]
        dev_info["window_s"] = readings.trace["window_s"]
    breakdown = readings.trace["breakdown"] if trace and readings.trace is not None else None
    captured = window.captured
    last_output = driver.keep(outputs)
    del model, driver, outputs, window, readings
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from portbench import check

    checks = check.judge(spec, driver_mod, captured, last_output, seed, device)
    result = {"correct": all(c["value"] <= c["limit"] for c in checks), **result, "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def jax_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(JAX_NAMES))
