"""The program's own spans and set-up record, for the metric readers.

``qatzip_tpu_torch`` records a request's spans while ``torch.profiler``
records (the traced run), and its set-up phases always: ``qz_trace_spans``
and ``qz_trace_setup``, both on the host's ``perf_counter`` clock, which
the run's requests are timed on too.  The program is imported when a
function here is called, never when this module is loaded (the readers
load before a run sets the program's environment).  Each function returns
None where the program keeps no such record: an older program, which a
traced run of the parent commit measures.
"""
from __future__ import annotations

SLACK_S = 1e-3      # a program request starts and ends inside the client's


def seconds(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e9


def request_trees(run) -> dict | None:
    """request id -> the spans of each program request that ran inside
    one of the window's requests; None where there is none."""
    try:
        from qatzip_tpu_torch import qz_trace_spans
    except ImportError:
        return None
    if not run.requests:
        return None
    lo = min(r.start for r in run.requests) - SLACK_S
    hi = max(r.end for r in run.requests) + SLACK_S
    spans = qz_trace_spans()
    inside = {s["request"] for s in spans if s["name"] == "request"
              and s["start_ns"] / 1e9 >= lo and s["end_ns"] / 1e9 <= hi}
    trees: dict = {}
    for s in spans:
        if s["request"] in inside:
            trees.setdefault(s["request"], []).append(s)
    return trees or None


def per_request_ms(run, name: str, having: str | None = None):
    """The mean, over the window's program requests (those with a span
    ``having``, where given), of a request's summed seconds in spans
    ``name``, in ms."""
    trees = request_trees(run)
    if trees is None:
        return None
    picked = [t for t in trees.values()
              if having is None or any(s["name"] == having for s in t)]
    if not picked:
        return None
    return 1e3 * sum(seconds(s) for t in picked for s in t
                     if s["name"] == name) / len(picked)


def setup_s(names) -> float | None:
    """Seconds of the process's set-up phases named in ``names``, summed;
    None where the program keeps no set-up record."""
    try:
        from qatzip_tpu_torch import qz_trace_setup
    except ImportError:
        return None
    return sum(seconds(p) for p in qz_trace_setup() if p["name"] in names)
