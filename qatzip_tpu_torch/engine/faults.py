"""First-class fault injection for the device backend (a copy of
qatzip_tpu/engine/faults.py).

The reference declares compile-gated simulated-HW-error hooks in its
session params (`ERR_INJECTION` linked list of CpaDcRqResults to be
returned instead of real ones — include/qatzip.h:494-498); no injector
ships in-tree.  This module implements the idea for real: registered
faults fire at named sites inside the port's device codec adapters
(ops/device_codecs.py), driving the health/breaker/failover machinery
through its production code paths without monkeypatching.

Sites (mirroring where the reference's HW path can fail):
  "submit"   — the device dispatch raises before any work is queued
               (cpaDcCompressData2 returning CPA_STATUS_FAIL,
               src/qatzip.c:1542-1566) -> whole-batch CPU reroute;
  "death"    — the result materialization raises (device died mid-batch;
               dcCallback error respond, src/qatzip.c:1677) -> per-batch
               CPU failover after submission;
  "poison"   — device output is corrupted in place (simulated DMA/memory
               fault).  For compress candidates this must be HARMLESS
               (the native parser verifies every candidate by byte
               compare); for decompress it must be DETECTED (checksum/
               size verification, QZ_DATA_ERROR or SW retry);
  "checksum" — the device-computed chunk checksum is wrong while the
               payload is good (simulated checksum-engine fault;
               decompOutCheckSum analog, src/qatzip_utils.c:1350-1427).

Usage (tests, chaos tooling):
    from qatzip_tpu_torch.engine import faults
    faults.inject_error("submit", nth=2, direction="compress")
    ... run requests ...
    faults.clear()
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import torch


class InjectedFault(RuntimeError):
    """Raised at a fault site; treated by the engine exactly like a real
    device failure (health.record_failure + CPU reroute)."""


# The errors a device batch fails over to the CPU on: an injected fault and
# a card out of memory.  Any other error reaches the caller, where the
# reference reroutes every exception: a kernel that cannot be built or
# launched (KernelError), one that faulted on the card (a CUDA error, raised
# at the next synchronisation) or a fault of the port's own code would
# otherwise hide behind the CPU's right bytes.
FAILOVER = (InjectedFault, torch.OutOfMemoryError)


@dataclass
class _Fault:
    kind: str
    nth: int = 1          # fire on the nth matching event (1-based)
    direction: str | None = None   # "compress" / "decompress" / None = both
    count: int = 1        # how many consecutive firings (-1 = forever)
    seen: int = field(default=0, init=False)
    fired: int = field(default=0, init=False)


_lock = threading.Lock()
_faults: list[_Fault] = []


def inject_error(kind: str, nth: int = 1, direction: str | None = None,
                 count: int = 1) -> None:
    """Arm a fault: the ``nth`` event at site ``kind`` (optionally filtered
    by direction) fails, for ``count`` consecutive events (-1 = until
    cleared).  The reference's ERR_INJECTION list is per-session; here the
    injector is process-global because the device (like the ASIC) is a
    process-wide resource."""
    if kind not in ("submit", "death", "poison", "checksum"):
        raise ValueError(f"unknown fault kind {kind!r}")
    with _lock:
        _faults.append(_Fault(kind, nth, direction, count))


def clear() -> None:
    with _lock:
        _faults.clear()


def armed() -> bool:
    return bool(_faults)


def should_fire(kind: str, direction: str) -> bool:
    """Called by the device codec at each site.  Counts the event and
    reports whether an armed fault covers it."""
    if not _faults:
        return False
    with _lock:
        fire = False
        for f in _faults:
            if f.kind != kind:
                continue
            if f.direction is not None and f.direction != direction:
                continue
            f.seen += 1
            if f.seen >= f.nth and (f.count < 0 or f.fired < f.count):
                f.fired += 1
                fire = True
        _faults[:] = [f for f in _faults
                      if f.count < 0 or f.fired < f.count or f.seen < f.nth]
        return fire


def check(kind: str, direction: str) -> None:
    """Raise InjectedFault if an armed fault covers this event."""
    if should_fire(kind, direction):
        raise InjectedFault(f"injected {kind} fault ({direction})")
