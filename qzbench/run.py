"""Run one cell of the benchmark of ``qatzip_tpu_torch``.

    python3 qzbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result, one JSON object; the numbers that decided ``correct`` are the last
lines of standard error.  Exits 2 with no result when the machine lacks
the cards the cell asks for, 3 when a module of JAX or of the JAX package
was loaded, and 1 on any other error.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        from qzbench import harness

        cell = harness.load_cell(args.workload, ROOT)
        result, checks = harness.run_cell(cell, args.seed, args.seconds,
                                          bool(args.trace), T_PROCESS)
    except Exception as exc:  # noqa: BLE001  (the run's one boundary)
        traceback.print_exc()
        kind = type(exc).__name__
        print(f"no result: {kind}: {exc}", file=sys.stderr)
        return 2 if kind == "NoDevice" else 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"no result: loaded {bad}, modules the run may not load",
              file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
