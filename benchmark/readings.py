"""The readings that the limits of ``benchmark/limits/`` are set from: one
cell's compared numbers on many seeds in one process (which pays the
imports and the kernels' load once), of the program as it runs, or with
``--control`` of the control, the program one precision down (TF32 on for
fp32 products), or with ``--fault`` of the program with a fault planted
(``harness/faults.py``); ``correct`` must come out false for both.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds <s>
        [--control | --fault <name>]

On the card only; one JSON line a seed with its checks and end-to-end
metrics, and a summary line with each number's largest and smallest
reading. The benchmark's own runs never run this.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark.harness.faults import FAULTS, plant  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS), help="plant this fault in the program")
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.core import run_cell
    from benchmark.harness.spec import resolve

    if not torch.cuda.is_available():
        print("readings are taken on a CUDA card", file=sys.stderr)
        return 2
    cell = resolve(ROOT, args.workload)
    if args.fault:
        plant(args.fault)
    seen: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        result, lines = run_cell(cell, seed, args.seconds, False, "cuda", t0,
                                 control=args.control, out=lambda line: print(line, flush=True))
        for name, c in result["checks"].items():
            seen.setdefault(name, []).append(c["value"])
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "correct": result["correct"],
                          "checks": result["checks"], "metrics": result["metrics"],
                          "seconds": time.time() - t0}), flush=True)
    print(json.dumps({"workload": cell.name, "control": args.control, "fault": args.fault,
                      "largest": {k: max(v) for k, v in seen.items()},
                      "smallest": {k: min(v) for k, v in seen.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
