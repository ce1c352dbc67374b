"""The traced run's spans and device timeline (``--trace 1``).

The program carries no spans yet, so the benchmark puts its own around the
module attributes that its per-layer metrics name (each metric's reader
declares them in ``SPANS``): a wrapper records the host's clock on entry
and exit, the thread, and a value the reader asks for, and opens a
``torch.profiler.record_function`` range of the span's name so that the
profiler can tie the device work launched inside to the span.

Device time comes from ``torch.profiler`` (CUPTI), recording every
thread's ops: each device record of torch's is tied to the span open
around the op that launched it.  The program's own kernels
(``ops/_build.Kernel``, launched through ctypes, under no torch op) are
recorded at launch, in order under a lock, each with the span open on its
thread; the profiler's records of them take their spans from the launches
in order, since the one stream runs them in the order they were made.
Where the profiler's count of them differs from the launches (it was seen
to drop records on short passes), no device metric is read
(``harness.Run.device_ops``).
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import re
import threading
import time

_PORT_KERNEL = re.compile(r"\bqz_\w+")


class Span:
    """A span: its name, its thread, the host's clock at entry and exit,
    and the value its reader asked for."""

    __slots__ = ("name", "thread", "start", "end", "value")

    def __init__(self, name, start):
        self.name, self.start = name, start
        self.thread = threading.get_native_id()
        self.end = self.value = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Tracer:
    """Spans around named module attributes and timed kernel launches.

    ``specs``: span name -> (``"module:attr"``, value function or None),
    the value function taking (args, kwargs, result)."""

    def __init__(self, specs: dict, torch_mod, on_card: bool = True):
        self.specs = specs
        self.on_card = on_card
        self.torch = torch_mod
        self.spans: list[Span] = []
        self.launches: list = []     # (symbol, span) of each launch, in order
        self._tls = threading.local()
        self._launch_lock = threading.Lock()
        self._undo: list = []
        self.perf_zero = 0.0

    # -- the host's spans -------------------------------------------------
    def open_spans(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def region(self, name: str):
        """A span around a block: the host's clock, the thread's stack of
        open spans, and a profiler range ``qzb.<name>``.  Yields the span,
        which is recorded on exit."""
        stack = self.open_spans()
        stack.append(name)
        span = Span(name, time.perf_counter())
        try:
            with self.torch.profiler.record_function("qzb." + name):
                yield span
        finally:
            span.end = time.perf_counter()
            stack.pop()
            self.spans.append(span)

    def span(self, name: str, fn, value_fn=None):
        """``fn`` wrapped in a span; ``value_fn(args, kwargs, result)`` gives
        the span's value."""
        region = self.region

        def wrapped(*args, **kwargs):
            with region(name) as span:
                result = fn(*args, **kwargs)
                if value_fn is not None:
                    span.value = value_fn(args, kwargs, result)
            return result

        wrapped.__wrapped__ = fn
        return wrapped

    def install(self) -> None:
        for name, (target, value_fn) in self.specs.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            setattr(mod, attr, self.span(name, orig, value_fn))
            self._undo.append((mod, attr, orig))
        if not self.on_card:
            return       # the plain kernels launch nothing to time
        from qatzip_tpu_torch.ops import _build

        launches, lock = self.launches, self._launch_lock
        call = _build.Kernel.__call__
        stack_of = self.open_spans

        def recorded(kernel, *args):
            stack = stack_of()
            with lock:
                call(kernel, *args)
                launches.append((kernel.symbol,
                                 stack[-1] if stack else None))

        _build.Kernel.__call__ = recorded
        self._undo.append((_build.Kernel, "__call__", call))

    def zero(self) -> None:
        """Start the window's timeline: call at the window's start, inside
        its ``qzb.window`` range."""
        self.perf_zero = time.perf_counter()
        with self._launch_lock:
            del self.launches[:]

    def uninstall(self) -> None:
        while self._undo:
            obj, attr, orig = self._undo.pop()
            setattr(obj, attr, orig)


def _call(ev, name, default=None):
    f = getattr(ev, name, None)
    if f is None:
        return default
    try:
        return f()
    except (RuntimeError, TypeError):
        return default


def _innermost(ranges, s):
    """The name of the latest-opened range of ``ranges`` (sorted (start,
    end, name)) that holds time ``s``: spans nest, so the innermost."""
    if not ranges:
        return None
    i = bisect.bisect_right(ranges, (s, float("inf"), ""))
    while i > 0:
        i -= 1
        _, rt, name = ranges[i]
        if rt >= s:
            return name
    return None


class DeviceTimeline:
    """The profiler's records reduced to what the readers need.

    ``ops``: (name, start s, end s, span or None) of each device record
    (kernels, copies and sets; not the profiler's own annotations), on the
    window's timeline (0 = the ``qzb.window`` marker's start, where the
    tracer's ``zero`` was taken); ``host``: (thread, name, start s, end s)
    of each benchmark span on the same timeline; ``window``: the marker's
    length in seconds.

    A device record belongs to the span open around the torch op that
    launched it: the profiler links the record to the op, and the op lies
    inside a ``qzb.<span>`` range on its thread (the profiler records every
    thread's ops where this torch can, ``profile_all_threads``)."""

    def __init__(self, prof, torch_mod, tracer):
        DT = torch_mod.autograd.DeviceType
        events = prof.profiler.kineto_results.events()
        cpu, dev = [], []
        for e in events:
            if _call(e, "device_type") != DT.CUDA:
                cpu.append(e)
            elif not (e.name().startswith("qzb.")
                      or _call(e, "is_user_annotation", False)):
                dev.append(e)
        marks = [e for e in cpu if e.name() == "qzb.window"]
        if not marks:
            raise RuntimeError("the profiler kept no window marker")
        t0 = marks[0].start_ns()
        self.window = (marks[0].end_ns() - t0) / 1e9
        self.host = [(sp.thread, sp.name, sp.start - tracer.perf_zero,
                      sp.end - tracer.perf_zero) for sp in tracer.spans]
        # each profiled thread's qzb.<span> ranges
        ranges: dict = {}
        for e in cpu:
            name = e.name()
            if name.startswith("qzb.") and name != "qzb.window":
                ranges.setdefault(_call(e, "start_thread_id"), []).append(
                    ((e.start_ns() - t0) / 1e9, (e.end_ns() - t0) / 1e9,
                     name[4:]))
        for r in ranges.values():
            r.sort()
        # the span around each torch op, by the op's correlation id
        by_op: dict = {}
        for e in cpu:
            corr = _call(e, "correlation_id", 0)
            if corr:
                span = _innermost(ranges.get(_call(e, "start_thread_id")),
                                  (e.start_ns() - t0) / 1e9)
                if span is not None:
                    by_op[corr] = span
        self.ops = []
        self.linked = 0
        for e in dev:
            span = by_op.get(_call(e, "linked_correlation_id", 0))
            self.linked += span is not None
            s = (e.start_ns() - t0) / 1e9
            self.ops.append((e.name(), s, s + _call(e, "duration_ns", 0) / 1e9,
                             span))
        self.diag = {"cpu_records": len(cpu), "profiled_threads": len(ranges),
                     "profiled_ranges": sum(len(r) for r in ranges.values())}

    def port_ops(self) -> list:
        return [o for o in self.ops if _PORT_KERNEL.search(o[0])]

    def torch_ops(self) -> list:
        return [o for o in self.ops if not _PORT_KERNEL.search(o[0])]
