"""Flow-counter checker: the application-level race detector (a copy of
qatzip_tpu/engine/flow.py), and the port's request-scoped spans.

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

Spans.  Each request record (``_RequestFlow``, one a compress or
decompress request) has an id.  At its start the request decides whether
it is traced: while ``torch.profiler`` records in this process, or after
``FlowTracker.tracing`` was set (``api.qz_trace``).  A traced request
holds its spans, and ``tls.rec`` points at it on its thread while it runs,
so that the layers below open spans on it: each span has a name, its
request's id, its index in the request and its parent's, the thread, the
host's clock (``time.perf_counter_ns``) at open and close, the thread's CPU
time between them, one value, and two counts summed into the enclosing
spans, so that a request's own are on its ``request`` span: the launches
of the port's kernels made inside it, and the streams its inflate batches
(or the blocks its LZ4 batches) failed over to the CPU
(``failover_lanes``).  While the profiler records, each span is also a
``record_function`` range ``qz.<name>``, on the profiler's clock beside
the device's records.  Untraced, ``tls.rec`` is None and a site costs one
attribute read and a test.  A finished request's spans go to a buffer of
at most ``SPAN_CAP``; past it they are counted in ``spans_dropped``.

Set-up phases (the import, the native codec's build-or-load, the engine's
bring-up, the kernel library's build-or-load, each kernel's first launch)
happen once a process and are always recorded, in ``FlowTracker.setup``.
"""
from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time

from qatzip_tpu_torch.utils.logging import QZ_ERROR

SPAN_CAP = 65536


class _Local(threading.local):
    rec = None      # the traced request running on this thread, or None


tls = _Local()


def now() -> tuple[int, int]:
    """The host's clock and the thread's CPU time, in ns: a span's start."""
    return time.perf_counter_ns(), time.thread_time_ns()


def _profiler():
    """torch's autograd profiler module while it records, else None."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof if prof is not None and prof._is_profiler_enabled else None


class Span:
    __slots__ = ("name", "request", "index", "parent", "thread", "start_ns",
                 "end_ns", "cpu_ns", "value", "launches", "failover_lanes",
                 "_range")

    def __init__(self, name, request, index, parent, since, value=None):
        self.name, self.request, self.index, self.parent = (
            name, request, index, parent)
        self.thread = threading.get_native_id()
        self.start_ns, self.cpu_ns = since
        self.end_ns = None
        self.value = value
        self.launches = 0
        self.failover_lanes = 0
        self._range = None

    def end(self, value=None) -> None:
        self.end_ns, cpu = now()
        self.cpu_ns = cpu - self.cpu_ns
        if value is not None:
            self.value = value

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__
                if k != "_range"}


class FlowTracker:
    STAGES = ("planned", "submitted", "completed", "reassembled")

    def __init__(self):
        self._lock = threading.Lock()
        self.totals = {s: 0 for s in self.STAGES}
        self.flow_errors = 0
        self.requests = 0
        self.tracing = False        # every request traced (api.qz_trace)
        self.spans: list[Span] = []
        self.spans_dropped = 0
        self.setup: list[Span] = []
        self._ids = itertools.count(1)

    def request(self) -> "_RequestFlow":
        prof = _profiler()
        return _RequestFlow(self, next(self._ids),
                            self.tracing or prof is not None, prof)

    def dump(self) -> dict:
        """Counter dump (the qzip `dumpAllCounters` analog)."""
        with self._lock:
            out = dict(self.totals)
            out["flow_errors"] = self.flow_errors
            out["requests"] = self.requests
            return out

    def record_setup(self, name: str, since: tuple[int, int],
                     value=None) -> None:
        """Record the set-up phase ``name`` that began at ``since``
        (``now()``) and ends now."""
        span = Span(name, None, None, None, since, value)
        span.end()
        with self._lock:
            self.setup.append(span)

    def keep(self, spans: list[Span]) -> None:
        with self._lock:
            room = max(0, SPAN_CAP - len(self.spans))
            self.spans += spans[:room]
            self.spans_dropped += max(0, len(spans) - room)


class _RequestFlow:
    """Per-request counter quad; for a traced request, its spans."""

    def __init__(self, tracker: FlowTracker, rid: int, traced: bool = False,
                 prof=None):
        self._t = tracker
        self.id = rid
        self.counts = {s: 0 for s in FlowTracker.STAGES}
        self.spans: list[Span] | None = [] if traced else None
        self._prof = prof           # ranges on the profiler while it records
        self._open: list[Span] = []

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

    # -- spans (a traced request only) --------------------------------------
    def open(self, name: str, value=None) -> Span:
        """Open span ``name`` inside the innermost open one."""
        parent = self._open[-1].index if self._open else -1
        span = Span(name, self.id, len(self.spans), parent, now(), value)
        if self._prof is not None:
            span._range = self._prof.record_function("qz." + name)
            span._range.__enter__()
        self.spans.append(span)
        self._open.append(span)
        return span

    def close(self, span: Span, value=None) -> None:
        """Close ``span``, and any span opened inside it and left open.  A
        span ends after its profiler range does: the range's exit, as its
        enter, counts in the span, so that spans opened one after another
        leave no gap between them where the exit waited for the
        interpreter lock."""
        if span.end_ns is not None:     # closed with an enclosing span
            return
        while self._open:
            top = self._open.pop()
            if top._range is not None:
                top._range.__exit__(None, None, None)
                top._range = None
            top.end(value if top is span else None)
            if self._open:
                self._open[-1].launches += top.launches
                self._open[-1].failover_lanes += top.failover_lanes
            if top is span:
                break

    def launch(self, symbol: str, fn, args) -> int:
        """Launch kernel ``symbol`` (``fn(*args)``) inside the open span,
        counted on it; in a ``qz.launch.<symbol>`` range while the profiler
        records."""
        if self._open:
            self._open[-1].launches += 1
        if self._prof is None:
            return fn(*args)
        with self._prof.record_function("qz.launch." + symbol):
            return fn(*args)

    @contextlib.contextmanager
    def traced(self, value):
        """Run the request inside its ``request`` span (``value``: its input
        bytes), with ``tls.rec`` pointing at it; keep its spans after."""
        root = self.open("request", value)
        prev, tls.rec = tls.rec, self
        try:
            yield root
        finally:
            self.close(root)
            tls.rec = prev
            self._t.keep(self.spans)


flow = FlowTracker()
