"""Leveled logger of the port, a copy of qatzip_tpu/utils/logging.py.

Mirrors the reference logger semantics (qzSetLogLevel, 8 levels NONE->TEST;
include/qatzip.h:944-990, impl src/qatzip_utils.c:185-249): timestamped
file:line messages, errors to stderr, the rest to stdout.
"""
from __future__ import annotations

import inspect
import os
import sys
import threading
import time

from qatzip_tpu_torch.constants import QzLogLevel

_lock = threading.Lock()
_level = QzLogLevel(int(os.environ.get("QATZIP_TPU_LOG_LEVEL", QzLogLevel.LOG_ERROR)))


def set_log_level(level: int) -> int:
    """qzSetLogLevel analog; returns QZ_OK(0) or QZ_PARAMS(-1)."""
    global _level
    try:
        lvl = QzLogLevel(level)
    except ValueError:
        return -1
    with _lock:
        _level = lvl
    return 0


def get_log_level() -> QzLogLevel:
    return _level


def _log(level: QzLogLevel, tag: str, fmt: str, *args) -> None:
    if level > _level:
        return
    frame = inspect.currentframe().f_back.f_back
    loc = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
    ts = time.strftime("%H:%M:%S", time.localtime())
    msg = fmt % args if args else fmt
    stream = sys.stderr if level == QzLogLevel.LOG_ERROR else sys.stdout
    print(f"[{ts}] [{tag}] [{loc}] {msg}", file=stream)


def QZ_ERROR(fmt: str, *args) -> None:
    _log(QzLogLevel.LOG_ERROR, "ERROR", fmt, *args)


def QZ_WARN(fmt: str, *args) -> None:
    _log(QzLogLevel.LOG_WARNING, "WARN", fmt, *args)


def QZ_INFO(fmt: str, *args) -> None:
    _log(QzLogLevel.LOG_INFO, "INFO", fmt, *args)


def QZ_DEBUG(fmt: str, *args) -> None:
    _log(QzLogLevel.LOG_DEBUG1, "DEBUG", fmt, *args)
