"""Run one benchmark cell once on the CUDA cards of this machine.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The last line of standard output is the
result as one JSON object; the last lines of standard error are the numbers
the check compared, each beside its limit. With ``--trace 0`` the metrics
are the cell's end-to-end ones, with ``--trace 1`` its per-layer ones. Exits
non-zero, printing no result, without enough CUDA cards, or if JAX or the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's caches at fixed paths inside the checkout (its kernel
    # library builds into build/ there by itself)
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda-cache"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton-cache"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    spec = harness.Spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {spec.chips} CUDA card(s), this machine has {n}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {harness.power_limit()}", file=sys.stderr, flush=True)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T0, spec=spec)
    loaded = harness.jax_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for c in result["checks"]:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
