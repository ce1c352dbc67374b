"""Device routing policy of the port: may the device take a request?

Port of ``device_allowed`` from qatzip_tpu/engine/devcal.py, with the same
environment names and record keys.  In order of precedence:

  1. env QATZIP_TPU_DEVICE = "1"/"force"/"on"/"true" (always use the device
     when capable) or "0"/"off"/"false" (never) — the operator override;
  2. a saved calibration record (env QATZIP_TPU_DEVCAL_PATH, default
     ``$XDG_CACHE_HOME/qatzip_tpu_torch/devcal.json``): the device takes a
     direction only where it measured faster (``comp_device_wins``,
     ``decomp_device_wins``);
  3. no record: the CPU path.

Measuring the record on the H100 (``calibrate``) is not ported yet
(ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import json
import os

from qatzip_tpu_torch.constants import QzDirection

_CAL_ENV = "QATZIP_TPU_DEVCAL_PATH"
_FORCE_ENV = "QATZIP_TPU_DEVICE"
_cache: dict | None = None
_cache_path: str | None = None


def _cal_path() -> str:
    p = os.environ.get(_CAL_ENV)
    if p:
        return p
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "qatzip_tpu_torch", "devcal.json")


def _load() -> dict:
    global _cache, _cache_path
    path = _cal_path()
    if _cache is not None and _cache_path == path:
        return _cache
    try:
        with open(path) as f:
            _cache = json.load(f)
    except (OSError, ValueError):
        _cache = {}
    _cache_path = path
    return _cache


def device_allowed(direction) -> bool:
    """Is the device path allowed for this direction under current policy?"""
    force = os.environ.get(_FORCE_ENV, "").lower()
    if force in ("1", "force", "on", "true"):
        return True
    if force in ("0", "off", "false"):
        return False
    cal = _load()
    comp = bool(cal.get("comp_device_wins", False))
    decomp = bool(cal.get("decomp_device_wins", False))
    if direction == QzDirection.QZ_DIR_COMPRESS:
        return comp
    if direction == QzDirection.QZ_DIR_DECOMPRESS:
        return decomp
    return comp and decomp
