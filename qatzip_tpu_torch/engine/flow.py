"""Flow-counter checker: the application-level race detector (a copy of
qatzip_tpu/engine/flow.py).

The reference gives every in-flight buffer four monotonic counters
(src1/src2/sink1/sink2, src/qatzip_internal.h:155-171); the completion
callback asserts their legal ordering and logs "FLOW ERROR" on violation
(src/qatzip.c:209-243), and buffer reuse requires all four equal
(:402-437).  The device pipeline has no shared DMA buffers to race on, but
the same invariant matters: every chunk planned for a request must be
submitted to exactly one backend, produce exactly one result, and be
reassembled in submission order.

``FlowTracker`` counts the four stages per request and globally;
``check()`` asserts stage equality at request end (logging FLOW ERROR and
returning False on violation so the engine can fail the request rather
than emit silently corrupt output).  ``dump()`` is the qatzip_counter.c
analog (dumpAllCounters, src/qatzip_counter.c:56-82).
"""
from __future__ import annotations

import threading

from qatzip_tpu_torch.utils.logging import QZ_ERROR


class FlowTracker:
    STAGES = ("planned", "submitted", "completed", "reassembled")

    def __init__(self):
        self._lock = threading.Lock()
        self.totals = {s: 0 for s in self.STAGES}
        self.flow_errors = 0
        self.requests = 0

    def request(self) -> "_RequestFlow":
        return _RequestFlow(self)

    def dump(self) -> dict:
        """Counter dump (the qzip `dumpAllCounters` analog)."""
        with self._lock:
            out = dict(self.totals)
            out["flow_errors"] = self.flow_errors
            out["requests"] = self.requests
            return out


class _RequestFlow:
    """Per-request counter quad."""

    def __init__(self, tracker: FlowTracker):
        self._t = tracker
        self.counts = {s: 0 for s in FlowTracker.STAGES}

    def add(self, stage: str, n: int = 1) -> None:
        self.counts[stage] += n
        with self._t._lock:
            self._t.totals[stage] += n

    def reconcile(self) -> None:
        """Equalize this request's stage counts (to their max) after an
        *intentional* truncation — dest_limit stop or stream-end stop — so
        that planned-but-skipped chunks don't read as dropped.  Races still
        surface: a genuinely lost chunk makes 'completed' lag 'submitted'
        before any truncation decision, which check() would have seen on
        the non-truncated path."""
        m = max(self.counts.values())
        with self._t._lock:
            for s, n in self.counts.items():
                self._t.totals[s] += m - n
        self.counts = {s: m for s in FlowTracker.STAGES}

    def abort(self) -> None:
        """Void this request: unwind its stage counts from the global
        totals.  Used on intentional early exits (QZ_BUF_ERROR, whole-batch
        failure) so the global balance only reflects completed requests —
        the reference likewise resets a buffer's counter quad before reuse
        (src/qatzip.c:402-437) rather than leaving dangling counts."""
        with self._t._lock:
            for s, n in self.counts.items():
                self._t.totals[s] -= n
        self.counts = {s: 0 for s in FlowTracker.STAGES}

    def check(self, context: str = "") -> bool:
        """Assert all four stages saw the same chunk count (the legal
        counter ordering at buffer-reuse time, reference
        src/qatzip.c:402-437).  Logs FLOW ERROR and returns False on
        violation."""
        with self._t._lock:
            self._t.requests += 1
        vals = set(self.counts.values())
        if len(vals) == 1:
            return True
        with self._t._lock:
            self._t.flow_errors += 1
        QZ_ERROR("FLOW ERROR%s: %s",
                 f" ({context})" if context else "", self.counts)
        return False


flow = FlowTracker()
