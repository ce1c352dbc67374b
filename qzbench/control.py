"""The control: the plain reference in the program's place, with one of the
configuration's guarantees broken, through a whole run of a cell.  The
check that decides ``correct`` has to refuse it.

    python3 qzbench/control.py --workload <name> --seeds 1 2 3 [--seconds S]

Each seed is a run of its own in this process, at the cell's own sizes on
the card; a line a seed gives ``correct`` (it has to be false) and the
numbers compared.  The compress control writes the reference's stream with
every chunk's checksum left at 0; the decompress control returns the
original without its last chunk.  ``serve_control`` is also what the tests
use, on the CPU, at small sizes.
"""
import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def serve_control(cell, device=None):
    """A stand-in for the program: (direction, client, src) -> result."""
    ref = cell.reference
    chunk = int(cell.config["chunk_bytes"])
    cache: dict = {}

    def serve(direction, client, src):
        if client not in cache:
            original = (bytes(src) if direction == "compress"
                        else ref.read(src, device))
            cache[client] = ref.control(original, chunk, direction, device)
        return types.SimpleNamespace(rc=0, data=cache[client],
                                     consumed=len(src), ext_rc=0)

    return serve


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    from qzbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        result, _ = harness.run_cell(
            cell, seed, args.seconds, False, time.perf_counter(),
            serve=serve_control(cell, None))
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
