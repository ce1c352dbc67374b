"""Device routing policy of the port: may the device take a request?

Port of qatzip_tpu/engine/devcal.py, with the same environment names and
record keys.  In order of precedence:

  1. env QATZIP_TPU_DEVICE = "1"/"force"/"on"/"true" (always use the device
     when capable) or "0"/"off"/"false" (never) — the operator override;
  2. a saved calibration record (written by :func:`calibrate`; env
     QATZIP_TPU_DEVCAL_PATH, default
     ``$XDG_CACHE_HOME/qatzip_tpu_torch/devcal.json``, the port's own, so a
     record the JAX package measured on another host is never read): the
     device takes a direction only where it measured faster
     (``comp_device_wins``, ``decomp_device_wins``), and compress takes the
     packed candidate format where it measured faster (``pack_wins``,
     ops/device_codecs.py);
  3. no record: the CPU path.  With QATZIP_TPU_AUTOCAL=1 the first such
     decision starts one calibration in the background.
"""
from __future__ import annotations

import json
import os
import threading
import time

from qatzip_tpu_torch.constants import QzDirection
from qatzip_tpu_torch.utils.logging import QZ_ERROR

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


def invalidate() -> None:
    global _cache
    _cache = None


_autocal_started = False
_autocal_lock = threading.Lock()


def _maybe_autocalibrate() -> None:
    """Cold start: with no record the device is never used, so a fresh
    install runs on the CPU until someone calls :func:`calibrate`.  With
    QATZIP_TPU_AUTOCAL=1 the first no-record routing decision starts ONE
    calibration on a daemon thread (a small sample); requests keep going to
    the CPU until the record lands, so none waits for the kernels' build.
    Off by default: calibration builds the kernels, which surprises
    short-lived processes."""
    global _autocal_started
    if _autocal_started or os.environ.get("QATZIP_TPU_AUTOCAL", "") != "1":
        return
    with _autocal_lock:
        if _autocal_started:   # two first requests racing: one calibration
            return
        _autocal_started = True

    def run():
        try:
            calibrate(sample_bytes=2 << 20, save=True)
        except Exception as exc:  # noqa: BLE001  (no caller to raise to)
            QZ_ERROR("background calibration failed, routing stays on the "
                     "CPU: %r", exc)

    threading.Thread(target=run, name="qz-autocal", daemon=True).start()


def device_allowed(direction) -> bool:
    """Is the device path allowed for this direction under current policy?"""
    force = os.environ.get(_FORCE_ENV, "").lower()
    if force in ("1", "force", "on", "true"):
        return True
    if force in ("0", "off", "false"):
        return False
    cal = _load()
    if not cal:
        _maybe_autocalibrate()
        return False
    comp = bool(cal.get("comp_device_wins", False))
    decomp = bool(cal.get("decomp_device_wins", False))
    if direction == QzDirection.QZ_DIR_COMPRESS:
        return comp
    if direction == QzDirection.QZ_DIR_DECOMPRESS:
        return decomp
    return comp and decomp


def calibrate(sample_bytes: int = 8 << 20, level: int = 1, save: bool = True,
              device=None) -> dict:
    """Measure device against CPU throughput on this host and save the
    routing record; returns it.  ``device`` defaults to ``cuda:0``.

    gzip-ext at ``level`` and the default 64 KB chunks, on a sample of
    random words: the CPU funnel's compress and decompress; the device
    codec's compress in the raw and the packed candidate format (the faster
    becomes ``dev_comp_gbps`` and sets ``pack_wins``) and its decompress,
    end to end; then device compute alone: the captured inflate rounds
    replayed (``dev_decomp_compute_gbps``) and the match finder at the L1
    point, depth 16 and stride 2 (``dev_comp_compute_gbps``), timed with
    CUDA events.  A device that cannot run the codec leaves
    ``device_error`` (or ``compute_probe_error``) in the record and 0 GB/s,
    so routing stays on the CPU; a kernel that cannot be built or launched
    raises :class:`KernelError`, and a kernel that faulted on the card its
    CUDA error.  Expensive on first use (the kernels' build): call it
    explicitly, never from the request path."""
    import numpy as np
    import torch

    from qatzip_tpu_torch.constants import DataFormatInternal, QzHuffmanHdr
    from qatzip_tpu_torch.engine.cpu_backend import CpuBackend
    from qatzip_tpu_torch.engine.health import health
    from qatzip_tpu_torch.ops._build import KernelError
    from qatzip_tpu_torch.session import InternalParams

    device = (torch.device("cuda", 0) if device is None
              else torch.device(device))
    # 8 MB / 128 chunks: one full compress batch and one inflate round
    rng = np.random.default_rng(0)
    words = [rng.integers(0, 256, rng.integers(3, 9), dtype=np.uint8)
             for _ in range(64)]
    stream = np.concatenate([words[i] for i in
                             rng.integers(0, 64, sample_bytes // 4)])
    data = stream[:sample_bytes].tobytes()

    p = InternalParams()
    p.comp_lvl = level
    p.data_fmt = DataFormatInternal.DEFLATE_GZIP_EXT
    p.huffman_hdr = QzHuffmanHdr.QZ_DYNAMIC_HDR
    n = p.hw_buff_sz
    chunks = [data[i:i + n] for i in range(0, len(data), n)]

    cpu = CpuBackend()
    rec: dict = {"sample_bytes": sample_bytes, "level": level,
                 "device": str(device), "ts": time.time()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn, *args, on_device=False):
        fn(*args)  # warm (the kernels' build)
        if on_device:
            sync()
        t0 = time.perf_counter()
        out = fn(*args)
        if on_device:
            sync()
        return out, sample_bytes / max(time.perf_counter() - t0, 1e-9) / 1e9

    comp_cpu, rec["cpu_comp_gbps"] = timed(cpu.compress_chunks, chunks, p)
    payloads = [c.payload for c in comp_cpu]
    hints = [len(c) for c in chunks]
    _, rec["cpu_decomp_gbps"] = timed(cpu.decompress_chunks, payloads,
                                      hints, p)
    try:
        from qatzip_tpu_torch.ops import inflate_kernel as K
        from qatzip_tpu_torch.ops.device_codecs import DeflateDeviceCodec

        torch.empty(1, device=device)   # no such device: device_error
        codec = DeflateDeviceCodec()
        failures0 = health.total_failures
        # measure both candidate D2H formats; the faster one becomes the
        # recorded default for this host (ops/device_codecs.py policy)
        prior_pack = os.environ.get("QATZIP_TPU_PACK")
        os.environ["QATZIP_TPU_PACK"] = "0"
        try:
            _, rec["dev_comp_gbps"] = timed(codec.compress_chunks, chunks, p,
                                            device, on_device=True)
            os.environ["QATZIP_TPU_PACK"] = "1"
            _, rec["dev_comp_packed_gbps"] = timed(
                codec.compress_chunks, chunks, p, device, on_device=True)
        finally:
            if prior_pack is None:
                os.environ.pop("QATZIP_TPU_PACK", None)
            else:
                os.environ["QATZIP_TPU_PACK"] = prior_pack
        rec["dev_comp_raw_gbps"] = rec["dev_comp_gbps"]
        rec["pack_wins"] = (rec["dev_comp_packed_gbps"]
                            > rec["dev_comp_gbps"])
        if rec["pack_wins"]:
            rec["dev_comp_gbps"] = rec["dev_comp_packed_gbps"]
        # decompress: end to end, then the inflate kernel alone (the
        # captured rounds replayed, timed on the device)
        _, rec["dev_decomp_gbps"] = timed(codec.decompress_chunks, payloads,
                                          hints, p, device, on_device=True)
        calls: list = []
        K._capture = calls
        try:
            codec.decompress_chunks(payloads, hints, p, device)
        finally:
            K._capture = None
        if calls:
            rec["dev_decomp_compute_gbps"] = sample_bytes / max(
                K.timed_replay(calls, reps=3), 1e-9) / 1e9
        if health.total_failures != failures0:
            # a batch that failed over ran on the CPU: the numbers above
            # are not the device's
            raise RuntimeError(f"{health.total_failures - failures0} device "
                               f"batches failed over to the CPU")
    except (KernelError, torch.AcceleratorError):
        raise
    except Exception as exc:  # no usable device -> CPU-only
        rec["device_error"] = repr(exc)
        rec["dev_comp_gbps"] = 0.0
        rec["dev_decomp_gbps"] = 0.0
    # device compute alone: the match finder at the L1 point (stride 2,
    # depth 16, ops/device_codecs.py), timed on the device
    try:
        from qatzip_tpu_torch.ops import match_finder as mf

        arr = np.zeros((len(chunks), n + 8), np.uint8)
        lens = np.zeros((len(chunks),), np.int32)
        for i, c in enumerate(chunks):
            arr[i, :len(c)] = np.frombuffer(c, np.uint8)
            lens[i] = len(c)
        dj = torch.from_numpy(arr).to(device)
        lj = torch.from_numpy(lens).to(device)
        mf.find_candidates(dj, lj, depth=16, stride=2)   # warm
        reps = 5
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            stream_ = torch.cuda.current_stream(device)
            start.record(stream_)
            for _ in range(reps):
                mf.find_candidates(dj, lj, depth=16, stride=2)
            stop.record(stream_)
            sync()
            secs = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                mf.find_candidates(dj, lj, depth=16, stride=2)
            secs = time.perf_counter() - t0
        rec["dev_comp_compute_gbps"] = sample_bytes * reps / secs / 1e9
    except (KernelError, torch.AcceleratorError):
        raise
    except Exception as exc:
        rec["compute_probe_error"] = repr(exc)[:160]
        rec["dev_comp_compute_gbps"] = 0.0
    rec["comp_device_wins"] = rec["dev_comp_gbps"] > rec["cpu_comp_gbps"]
    rec["decomp_device_wins"] = (rec["dev_decomp_gbps"]
                                 > rec["cpu_decomp_gbps"])
    if save:
        path = _cal_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        invalidate()
    return rec
