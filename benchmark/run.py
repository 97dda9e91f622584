"""The benchmark of ``stgx_torch`` on one NVIDIA H100: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its files are found by name (``benchmark/harness/spec.py``). The run makes
its inputs and weights from ``--seed``, sets the program up, measures for
``--seconds`` (``--trace 1``: with the profiler over a slice of the window,
reporting the per-layer metrics instead of the end-to-end ones), checks
what the window produced against the plain reference, and prints one JSON
object as the last line of its standard output. The numbers compared, each
beside its limit, end the standard error and the JSON object's ``checks``.

It exits with 2, printing no result, where CUDA is absent or has fewer
cards than the cell asks for, and with 3 where the process holds a module
of JAX, Flax or the JAX package ``stgx`` once the window has closed.
"""

import time

T0 = time.time()  # setup_s counts from here: the interpreter has just started

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness.core import forbidden_modules, run_cell
    from benchmark.harness.spec import resolve

    cell = resolve(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0,
                             out=lambda line: print(line, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"the process holds forbidden modules: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
