"""Memory accounting of the port: the registry that ``qz_get_status``
reads, copied from qatzip_tpu/memory.py.

The reference fills it from ``qz_malloc`` (its qzMalloc analog,
src/qatzip_mem.c:169-224); the port has no ``qz_malloc`` yet (ROADMAP
queue 1 item 7), so its registry stays empty and ``qz_get_status`` reports
no pinned memory.
"""
from __future__ import annotations

import threading

_registry: dict[int, tuple[bytearray, int, int]] = {}
_lock = threading.Lock()


def registered_count() -> int:
    """Introspection helper for qz_get_status memory accounting."""
    with _lock:
        return len(_registry)


def registered_bytes() -> int:
    with _lock:
        return sum(len(b) for b, _, _ in _registry.values())
