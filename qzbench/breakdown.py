"""The traced run's breakdown: where the device's time went, and what the
host was doing while the device stood idle.

``device_ops``: the ten device operations that took most time in the
window, by every record the profiler kept.
``idle_gaps``: the device's idle time in the window, summed by what the
host had open at each gap's middle (the innermost benchmark span of every
client thread, joined by "+"; "no span open" between requests), the ten
largest.
"""
from __future__ import annotations

import sys

from qzbench import stats

NAME = 100      # characters of a device operation's name kept

# spans the breakdown names idle time by, beside the metrics' own: each
# host layer between a request and the device
SPANS = {
    "staging": "qatzip_tpu_torch.ops.device_codecs:_stage_chunks",
    "mf": "qatzip_tpu_torch.ops.match_finder:find_candidates",
    "gather": "qatzip_tpu_torch.parallel.shard:gather",
    "assemble": "qatzip_tpu_torch.ops.device_codecs:_map_chunks",
    "inflate_batch": "qatzip_tpu_torch.ops.deflate_decode:inflate_batch",
    "lz4_batch": "qatzip_tpu_torch.ops.lz4_decode:decode_blocks",
}


def _ops(run) -> dict:
    by: dict = {}
    for name, s, e, _ in run.timeline.ops:
        by[name] = by.get(name, 0.0) + (e - s)
    return by


def _intervals(run) -> list:
    return [(s, e) for _, s, e, _ in run.timeline.ops]


def _idle_by_host(run) -> dict:
    # one sweep in time order: span opens and closes, and each gap's middle
    points = []
    for tid, name, s, t in run.timeline.host:
        points.append((s, 1, tid, name))
        points.append((t, 0, tid, name))
    for g0, g1 in stats.gaps(_intervals(run), 0.0, run.timeline.window):
        points.append(((g0 + g1) / 2, 2, g1 - g0, None))
    points.sort(key=lambda p: (p[0], p[1]))
    open_: dict = {}
    by: dict = {}
    for _, kind, a, name in points:
        if kind == 1:
            open_.setdefault(a, []).append(name)
        elif kind == 0:
            stack = open_.get(a, [])
            if name in stack:
                # the latest-opened span of that name closes
                del stack[len(stack) - 1 - stack[::-1].index(name)]
        else:
            inner = {st[-1] for st in open_.values() if st}
            key = "+".join(sorted(inner)) or "no span open"
            by[key] = by.get(key, 0.0) + a
    return by


def build(run) -> dict:
    top = sorted(_ops(run).items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(_idle_by_host(run).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:NAME], v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


def kernel_launches() -> dict:
    """``launches`` of every ``Kernel`` of the program's loaded modules."""
    from qatzip_tpu_torch.ops import _build

    out = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith("qatzip_tpu_torch."):
            continue
        for v in vars(mod).values():
            if isinstance(v, _build.Kernel):
                out[v.symbol] = v.launches
    return out


def report(run, launches0: dict, log) -> None:
    """Counts that say how far the trace can be trusted."""
    now = kernel_launches()
    counters = {k: now[k] - launches0.get(k, 0) for k in now
                if now[k] != launches0.get(k, 0)}
    tl = run.timeline
    prof = len(tl.port_ops())
    pr = sum(e - s for _, s, e, _ in tl.port_ops())
    print(f"trace: the program's launches: Kernel.launches {counters} "
          f"(sum {run.counted}), recorded at launch {len(run.launches)}, "
          f"the profiler's records {prof} ({pr:.6f} s; its port kernels "
          f"{sorted({o[0][:60] for o in tl.port_ops()})}); "
          + ("they agree" if run.launches_match() else
             "they differ, so no per-layer device metric is read"),
          file=log)
    print(f"trace: {len(tl.ops)} device records", file=log)
    spans = {k: len(v) for k, v in run.spans.items()}
    print(f"trace: spans {spans}; profiler window {tl.window:.4f} s, "
          f"busy {run.busy_s():.6f} s; device records tied to a span "
          f"{tl.linked}; {tl.diag}", file=log)
