"""Run cells of the benchmark one after another and gather their results.

    python3 qzbench/sweep.py --out DIR --cells A B --seeds 11 12 13 \\
        [--seconds S] [--trace 0 1] [--tail N] [--probe]

Each run is ``qzbench/run.py`` in a process of its own, one at a time.
Every run's result line, exit code and the end of its standard error go
to ``DIR/sweep.jsonl``; one summary line a run is printed, and for each
cell and metric with three runs or more the median and the quartile
spread (``qzbench/stats.spread``).  ``--seconds`` defaults to
``run_seconds`` of BENCHMARK.json.

``--probe`` reads the host's speed just before each run, in this process
and on one thread, with fixed work: zlib level 1 over 16 MB of the corpus
(MB/s), a 256 MB memory copy (GB/s) and a Python loop (loops/s); with the
card's clocks, power and throttle reasons from ``nvidia-smi`` and the mean
``cpu MHz`` of /proc/cpuinfo.  At the end it gives, for each cell and
metric, the correlation of the metric with each probe over the runs.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from qzbench import stats  # noqa: E402

SMI = ("clocks.sm,clocks.mem,power.draw,temperature.gpu,"
       "clocks_throttle_reasons.active")


def host_probe(data: bytes, np) -> dict:
    """The host's speed now, on fixed work on this thread."""
    import zlib

    t = time.perf_counter()
    zlib.compress(data, 1)
    out = {"zlib_mb_s": len(data) / (time.perf_counter() - t) / 1e6}
    a = np.ones(256 << 20, np.uint8)
    b = np.empty_like(a)
    np.copyto(b, a)
    t = time.perf_counter()
    for _ in range(4):
        np.copyto(b, a)
    out["copy_gb_s"] = 4 * a.nbytes / (time.perf_counter() - t) / 1e9
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i & 7
    out["py_loops_s"] = 1e6 / (time.perf_counter() - t)
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        out["cpu_mhz"] = sum(mhz) / len(mhz) if mhz else None
    except (OSError, ValueError):
        out["cpu_mhz"] = None
    try:
        p = subprocess.run(["nvidia-smi", f"--query-gpu={SMI}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        out["smi"] = p.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["smi"] = None
    return out


def _corr(xs, ys):
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sx = sum((x - mx) ** 2 for x in xs) ** 0.5
    sy = sum((y - my) ** 2 for y in ys) ** 0.5
    if not sx or not sy:
        return None
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / (sx * sy)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", nargs="+", type=int, default=[0])
    ap.add_argument("--tail", type=int, default=12)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    probe_data = np = None
    if args.probe:
        import numpy as np

        from qzbench import corpus

        probe_data = corpus.build(1, 0, 16 << 20)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    os.makedirs(args.out, exist_ok=True)
    log = os.path.join(args.out, "sweep.jsonl")
    got: dict = {}
    for cell in args.cells:
        for trace in args.trace:
            for seed in args.seeds:
                cmd = [sys.executable, os.path.join(ROOT, "qzbench", "run.py"),
                       "--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)]
                probe = host_probe(probe_data, np) if args.probe else None
                t0 = time.perf_counter()
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   cwd=ROOT)
                wall = time.perf_counter() - t0
                lines = p.stdout.strip().splitlines()
                try:
                    res = json.loads(lines[-1]) if lines else None
                except ValueError:
                    res = None
                rec = {"cell": cell, "seed": seed, "trace": trace,
                       "seconds": seconds,
                       "rc": p.returncode, "wall_s": wall, "result": res,
                       "probe": probe,
                       "stderr": p.stderr.splitlines()[-args.tail:]}
                with open(log, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                ms = {k: v["value"] for k, v in
                      (res or {}).get("metrics", {}).items()}
                print(f"{cell} seed {seed} trace {trace}: rc {p.returncode}"
                      f", {wall:.1f} s, correct "
                      f"{(res or {}).get('correct')}, attempted "
                      f"{(res or {}).get('attempted')}, {ms}"
                      + (f", probe {probe}" if probe else ""), flush=True)
                if res is None or p.returncode:
                    print("\n".join(p.stderr.splitlines()[-args.tail:]),
                          flush=True)
                for k, v in ms.items():
                    got.setdefault((cell, trace, k), []).append((v, probe))
    for (cell, trace, k), pairs in sorted(got.items()):
        vals = [v for v, _ in pairs]
        if len(vals) >= 3:
            print(f"spread {cell} trace {trace} {k}: median "
                  f"{statistics.median(vals)!r}, spread "
                  f"{stats.spread(vals)!r}, n {len(vals)}, values {vals}")
        if len(vals) >= 3 and args.probe:
            corr = {q: _corr(vals, [pr[q] for _, pr in pairs])
                    for q in ("zlib_mb_s", "copy_gb_s", "py_loops_s")}
            print(f"probe correlation {cell} trace {trace} {k}: {corr}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
