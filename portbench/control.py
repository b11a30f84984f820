"""The check's control: the reference computed in fp8 takes the program's place,
and the fp32 reference judges it by the cell's numbers. Each number must
come out above its limit on at least one of them; the readings set the
upper end of each limit.

    python3 portbench/control.py --workload NAME --seeds 11 12 13

prints one JSON line a seed: the control's readings beside the limits.
The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seed: int, device, spec=None) -> list:
    """[{"name", "value", "limit"}] of the control at ``seed``."""
    from portbench import check, harness

    spec = spec or harness.Spec(workload)
    return check.judge(spec, spec.driver(), None, None, seed, device, control=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = readings(args.workload, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0,
                          "fails": any(c["value"] > c["limit"] for c in checks), "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
