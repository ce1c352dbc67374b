"""Memory API of the port: qz_malloc / qz_free / qz_mem_find_addr (a copy
of qatzip_tpu/memory.py).

Plays the role of the reference's pinned-memory manager + address page
table (src/qatzip_mem.c:169-226, src/qatzip_page_table.h:122-167).  On QAT
the point of qzMalloc is DMA-able memory the ASIC can read directly; the
registry classifies any buffer as pinned/not-pinned in O(1), the page
table's job, and ``qz_get_status`` reads its totals.

Buffers are ``bytearray``-backed (writable, zero-copy viewable via
``memoryview``), as in the reference: they are not page-locked for the
card.  NUMA placement is not meaningful from Python; the ``numa`` argument
is accepted for signature parity and recorded.
"""
from __future__ import annotations

import threading

QZ_MEM_PINNED = 1   # PINNED_MEM analog
QZ_MEM_COMMON = 0   # COMMON_MEM analog

_registry: dict[int, tuple[bytearray, int, int]] = {}
_lock = threading.Lock()


def qz_malloc(sz: int, numa: int = 0, force_pinned: int = QZ_MEM_PINNED):
    """qzMalloc analog (reference src/qatzip_mem.c:169-224).

    Returns a writable ``bytearray`` of ``sz`` bytes registered in the
    address table, or ``None`` on bad size (the reference returns NULL).
    """
    if sz is None or sz < 0:
        return None
    buf = bytearray(sz)
    with _lock:
        _registry[id(buf)] = (buf, int(numa), int(bool(force_pinned)))
    return buf


def qz_free(buf) -> None:
    """qzFree analog: unregister and release.  Unknown buffers are ignored
    (the reference frees plain-malloc pointers the same way)."""
    if buf is None:
        return
    with _lock:
        _registry.pop(id(buf), None)


def qz_mem_find_addr(buf) -> int:
    """qzMemFindAddr analog (reference src/qatzip_page_table.h:167):
    1 when ``buf`` was allocated by :func:`qz_malloc` and is pinned,
    else 0."""
    if buf is None:
        return 0
    with _lock:
        ent = _registry.get(id(buf))
    return 1 if ent is not None and ent[2] else 0


def registered_count() -> int:
    """Introspection helper for qz_get_status memory accounting."""
    with _lock:
        return len(_registry)


def registered_bytes() -> int:
    with _lock:
        return sum(len(b) for b, _, _ in _registry.values())


__all__ = ["qz_malloc", "qz_free", "qz_mem_find_addr",
           "QZ_MEM_PINNED", "QZ_MEM_COMMON",
           "registered_count", "registered_bytes"]
