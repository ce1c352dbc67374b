"""Device instance pool: cross-session multiplexing and admission control
(a copy of the pool of qatzip_tpu/engine/instances.py).

The reference multiplexes N threads onto M hardware instances with a
spin-lock grab, a capability filter, and a round-robin hint
(qzGrabInstance, src/qatzip.c:363-437), shuffling instances across PCIe
devices for load balance (:796-808).  The device analog: each device accepts a
bounded number of concurrently dispatching sessions — beyond that, its
launch queue serializes anyway while Python-side submitters pile up
unbounded.  This pool bounds concurrent device entries to
OVERSUB × num_devices (the reference's over-subscription model,
README.md:65-66), hands out instance slots round-robin, and lets callers
fall back to the CPU path instead of blocking when the pool is saturated
(the qzGrabInstance-failure → SW route of src/qatzip.c:1963-1975).

Usage: the context manager ``pool.instance(timeout)`` of the module's
``pool`` (the one the GPU backend grabs from), which yields None when the
pool is saturated.  ``grab_wait_ns`` sums the time grabs waited for a slot;
a traced request (engine/flow.py) has a ``pool.grab`` span for each wait.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

from qatzip_tpu_torch.engine.flow import tls

OVERSUB = int(os.environ.get("QATZIP_TPU_OVERSUB", "2"))


class InstancePool:
    def __init__(self, num_devices: int = 1, oversub: int = OVERSUB):
        self.num_devices = max(1, num_devices)
        self.slots = self.num_devices * max(1, oversub)
        self._sem = threading.BoundedSemaphore(self.slots)
        self._lock = threading.Lock()
        self._rr = 0
        self.grabs = 0
        self.busy_rejects = 0
        self.grab_wait_ns = 0

    def resize(self, num_devices: int) -> None:
        with self._lock:
            self.num_devices = max(1, num_devices)
            self.slots = self.num_devices * max(1, OVERSUB)
            self._sem = threading.BoundedSemaphore(self.slots)

    def grab(self, timeout: float | None = 0.0) -> int | None:
        """Acquire an instance slot; returns the round-robin device index
        or None when the pool is saturated (caller routes to SW)."""
        rec = tls.rec
        span = rec.open("pool.grab") if rec is not None else None
        t0 = time.perf_counter_ns()
        ok = self._sem.acquire(timeout=timeout) if timeout \
            else self._sem.acquire(blocking=False)
        waited = time.perf_counter_ns() - t0
        if span is not None:
            rec.close(span)
        if not ok:
            with self._lock:
                self.busy_rejects += 1
                self.grab_wait_ns += waited
            return None
        with self._lock:
            self.grabs += 1
            self.grab_wait_ns += waited
            idx = self._rr % self.num_devices
            self._rr += 1
        return idx

    def release(self, idx: int | None) -> None:
        if idx is None:
            return
        try:
            self._sem.release()
        except ValueError:  # pragma: no cover - double release guard
            pass

    @contextlib.contextmanager
    def instance(self, timeout: float | None = 0.0):
        idx = self.grab(timeout)
        try:
            yield idx
        finally:
            self.release(idx)

    def stats(self) -> dict:
        with self._lock:
            return {"slots": self.slots, "grabs": self.grabs,
                    "busy_rejects": self.busy_rejects}


pool = InstancePool()
