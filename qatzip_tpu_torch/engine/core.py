"""Core engine of the port: init, backend routing, and the compress and
decompress funnels.

Port of qatzip_tpu/engine/core.py (the role of src/qatzip.c in QATzip):
device bring-up, per-request chunking, ordered reassembly, software
failover, sticky force-SW mode and the latency-sensitive-mode router.  The
engine state, result type, framing walk (``_parse_member``) and the other
host-only helpers are copies of the reference's.

Bring-up finds the first CUDA device through torch.  Without one, init
reports QZ_NO_HW and every request runs on the shared ``CpuBackend`` with
QZ_SW_EXECUTION_MASK set: the reference's labelled software path.  A
device request fails over to the CPU on an injected fault or a card out
of memory (``faults.FAILOVER``) and on nothing else: a kernel that cannot
be built or launched, or that faults on the card, raises.  A chunk the
device failed over that the host decoder refuses ends the request with
QZ_DATA_ERROR, with no CPU rerun.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zlib

import torch

from qatzip_tpu_torch import constants as C
from qatzip_tpu_torch.constants import DataFormatInternal, QzDirection
from qatzip_tpu_torch.engine import devcal, faults, framing
from qatzip_tpu_torch.engine.backend import Backend, RefusedStream
from qatzip_tpu_torch.engine.cpu_backend import CpuBackend
from qatzip_tpu_torch.engine.flow import flow, now
from qatzip_tpu_torch.engine.gpu_backend import GpuBackend
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.formats import gzip_fmt, lz4_fmt, zlib_fmt
from qatzip_tpu_torch.session import InternalParams, QzSession
from qatzip_tpu_torch.utils import checksum as ck
from qatzip_tpu_torch.utils.logging import QZ_ERROR, QZ_WARN

try:  # native whole-request funnel (qatzip_tpu_torch/native/qzbatch.cpp)
    from qatzip_tpu_torch.native import qzcore as _native
except ImportError:  # pragma: no cover - native build optional
    _native = None

# wire-format codes shared with the native batch funnel (qzbatch.cpp enum Fmt)
_BATCH_FMT_CODE = {
    DataFormatInternal.DEFLATE_4B: 0,
    DataFormatInternal.DEFLATE_GZIP: 1,
    DataFormatInternal.DEFLATE_GZIP_EXT: 2,
    DataFormatInternal.DEFLATE_RAW: 3,
    DataFormatInternal.DEFLATE_ZLIB: 4,
}

__all__ = ["OpResult", "_parse_member", "choose_backend", "compress_ext",
           "decompress_ext", "engine", "qz_init_engine", "qz_close_engine"]


# ---------------------------------------------------------------------------
# Engine state (analog of the processData_T global, reference
# src/qatzip_internal.h:210-236) and init (qzInit, src/qatzip.c:630-840)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EngineState:
    initialized: bool = False
    init_status: int = C.QZ_NONE
    hw_present: bool = False
    device_kind: str = ""
    num_devices: int = 0
    cpu_backend: CpuBackend = dataclasses.field(default_factory=CpuBackend)
    hw_backend: Backend | None = None
    # counters (analog of per-thread HW/SW counters, src/qatzip_utils.c:55-183)
    hw_requests: int = 0
    sw_requests: int = 0


_engine = EngineState()
_engine_lock = threading.Lock()


def _discover_hw(device: torch.device | None
                 ) -> tuple[bool, str, int, Backend | None]:
    """Device discovery: the qzInit device-scan analog.

    Returns (present, device_kind, num_devices, backend).  Set
    QATZIP_TPU_FORCE_SW=1 to simulate a machine without an accelerator.
    """
    if os.environ.get("QATZIP_TPU_FORCE_SW", "0") == "1":
        return False, "", 0, None
    backend = GpuBackend.create(device)
    if backend is None:
        return False, "", 0, None
    return True, backend.device_kind, backend.num_devices, backend


def engine() -> EngineState:
    return _engine


def qz_init_engine(sw_backup: int = C.QZ_SW_BACKUP_DEFAULT,
                   device: torch.device | None = None) -> int:
    """Global bring-up on ``device`` (None: the first CUDA device, if any).
    Returns QZ_OK / QZ_DUPLICATE / QZ_NO_HW / QZ_NOSW_NO_HW following the
    reference's BACKOUT semantics (src/qatzip.c:554-565)."""
    with _engine_lock:
        if _engine.initialized:
            return C.QZ_DUPLICATE
        since = now()
        present, kind, ndev, backend = _discover_hw(device)
        _engine.hw_present = present
        _engine.device_kind = kind
        _engine.num_devices = ndev
        _engine.hw_backend = backend
        _engine.initialized = True
        if present:
            _engine.init_status = C.QZ_OK
            # active device heartbeat (opt-in via QATZIP_TPU_HEARTBEAT_S;
            # the reference's PollingHeartBeat thread, src/qatzip.c:267-280)
            health.start_heartbeat(backend.device)
        elif C.qz_sw_backup_enabled(sw_backup) or C.qz_sw_only(sw_backup):
            _engine.init_status = C.QZ_NO_HW
        else:
            _engine.init_status = C.QZ_NOSW_NO_HW
        flow.record_setup("setup.engine", since)
        return _engine.init_status


def qz_close_engine() -> int:
    with _engine_lock:
        _engine.initialized = False
        _engine.init_status = C.QZ_NONE
        _engine.hw_backend = None
        return C.QZ_OK


def ensure_init(sess: QzSession) -> int:
    """Transparent auto-init (reference include/qatzip.h:117-151)."""
    if not _engine.initialized:
        sw = sess.params.sw_backup if sess.params else C.QZ_SW_BACKUP_DEFAULT
        rc = qz_init_engine(sw)
        if rc < 0:
            sess.hw_session_stat = rc
            return rc
    sess.hw_session_stat = (C.QZ_OK if _engine.hw_present else _engine.init_status)
    return C.QZ_OK


# ---------------------------------------------------------------------------
# Routing (SW failover + LSM)
# ---------------------------------------------------------------------------
def _hw_supports(params: InternalParams, direction: QzDirection) -> bool:
    be = _engine.hw_backend
    return be is not None and be.supports(params, direction)


def choose_backend(sess: QzSession, src_len: int,
                   direction: QzDirection) -> tuple[Backend, bool]:
    """Returns (backend, is_sw).  Mirrors the route decisions of
    qzCompressCrcExt (reference src/qatzip.c:1935-1958)."""
    p = sess.params
    if C.qz_sw_only(p.sw_backup) or sess.force_sw:
        return _engine.cpu_backend, True
    if not _engine.hw_present or not _hw_supports(p, direction):
        return _engine.cpu_backend, True
    # heartbeat/breaker: a device with recent consecutive failures is
    # skipped like a dead instance (qzGrabInstance skip, reference
    # src/qatzip.c:389-391; heartbeat check :1514-1522)
    if not health.healthy():
        return _engine.cpu_backend, True
    if (direction == QzDirection.QZ_DIR_COMPRESS
            and src_len < p.input_sz_thrshold):
        return _engine.cpu_backend, True
    if p.is_sensitive_mode:
        # LSM: pick the path with the lower recent average latency
        # (chooseLSMPath, reference src/qatzip.c:287-297).  A path with no
        # samples yet is probed once so the comparison converges (the
        # reference seeds its matrices via the sub-threshold SW requests).
        hw_avg = sess.rrt.average() + sess.ppt.average()
        sw_avg = sess.swt.average()
        if hw_avg == 0:
            return _engine.hw_backend, False
        if sw_avg == 0 or sw_avg < hw_avg:
            return _engine.cpu_backend, True
        return _engine.hw_backend, False
    # Default mode: the device path engages only where a measured
    # calibration (or an explicit operator override) says it beats the CPU
    # path on this host — a badly-attached device must never regress the
    # default API (see engine/devcal.py).
    if not devcal.device_allowed(direction):
        return _engine.cpu_backend, True
    return _engine.hw_backend, False


# ---------------------------------------------------------------------------
# Compress funnel (qzCompressCrcExt analog, reference src/qatzip.c:1874-2097)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class OpResult:
    rc: int = C.QZ_OK
    data: bytes = b""
    consumed: int = 0
    crc: int = 0
    ext_rc: int = 0


def _session_crc_update(kind: str, crc: int, chunk_crc: int, chunk_len: int,
                        first: bool) -> int:
    if kind == "crc32":
        return chunk_crc if first else ck.crc32_combine(crc, chunk_crc, chunk_len)
    if kind == "adler32":
        return chunk_crc if first else ck.adler32_combine(crc, chunk_crc, chunk_len)
    # xxh32 is not combinable from chunk digests; the funnels overwrite the
    # session value with a whole-request digest after reassembly (below)
    return chunk_crc


def _as_view(src) -> memoryview:
    """Zero-copy byte view of any contiguous buffer-protocol object — the
    pinned-buffer fast path (reference decompBufferSetup zero-copy branch,
    src/qatzip_utils.c:1350-1427).  Bytearrays, numpy arrays and
    memoryview slices flow through without a memcpy; only non-buffer
    iterables fall back to a copy."""
    if isinstance(src, memoryview):
        mv = src
    else:
        try:
            mv = memoryview(src)
        except TypeError:
            return memoryview(bytes(src))
    if mv.ndim != 1 or mv.itemsize != 1 or not mv.contiguous:
        try:
            mv = mv.cast("B")
        except TypeError:
            return memoryview(mv.tobytes())
    return mv


def compress_ext(sess: QzSession, src, last: int = 1,
                 dest_limit: int | None = None, crc_init: int = 0) -> OpResult:
    rf = flow.request()
    if rf.spans is None:
        return _compress_ext(rf, sess, src, dest_limit, crc_init)
    src = _as_view(src)
    with rf.traced(len(src)):
        return _compress_ext(rf, sess, src, dest_limit, crc_init)


def _compress_ext(rf, sess: QzSession, src, dest_limit: int | None,
                  crc_init: int) -> OpResult:
    p = sess.params
    src = _as_view(src)
    res = OpResult(crc=crc_init)
    fmt = p.data_fmt
    kind = _engine.cpu_backend.checksum_kind(p)

    if len(src) == 0:
        # empty input still produces a valid empty member (empty-file
        # compressed size contract, reference include/qatzip.h:2044)
        chunks = [b""]
    else:
        chunks = [src[i:i + p.hw_buff_sz] for i in range(0, len(src), p.hw_buff_sz)]

    backend, is_sw = choose_backend(sess, len(src), QzDirection.QZ_DIR_COMPRESS)

    # Native whole-request funnel: chunking, per-chunk deflate on a worker
    # pool, framing, checksums and ordered reassembly all happen in one C
    # call (the reference keeps this loop in C too, src/qatzip.c:1483-1764).
    if (is_sw and _native is not None and dest_limit is None and len(src) > 0
            and fmt in _BATCH_FMT_CODE):
        t0 = time.perf_counter()
        try:
            data, comb = _native.batch_deflate_compress(
                src, p.hw_buff_sz, p.comp_lvl, _BATCH_FMT_CODE[fmt],
                0 if kind == "crc32" else 1)
        except ValueError:
            data = None  # fall through to the generic per-chunk path
        if data is not None:
            nchunks = len(chunks)
            # the native funnel chunks/compresses/reassembles in one C call;
            # record a balanced quad so the flow totals cover this path too
            rf.add("planned", nchunks)
            rf.add("submitted", nchunks)
            rf.add("completed", nchunks)
            rf.add("reassembled", nchunks)
            rf.check("compress-native")
            if p.is_sensitive_mode:
                sess.swt.update((time.perf_counter() - t0) / nchunks / 4)
            _engine.sw_requests += nchunks
            res.ext_rc |= C.QZ_SW_EXECUTION_MASK
            if crc_init == 0:
                res.crc = comb
            elif kind == "crc32":
                res.crc = ck.crc32_combine(crc_init, comb, len(src))
            else:
                res.crc = ck.adler32_combine(crc_init, comb, len(src))
            res.data = data
            res.consumed = len(src)
            with sess.stats_lock:
                sess.total_in += len(src)
                sess.total_out += len(data)
            sess.last_ext_rc = res.ext_rc
            return res

    # the request's flow-counter quad (the race checker; engine/flow.py)
    rf.add("planned", len(chunks))

    t0 = time.perf_counter()
    try:
        rf.add("submitted", len(chunks))
        compressed = backend.compress_chunks(chunks, p)
        rf.add("completed", len(compressed))
        if not is_sw:
            _engine.hw_requests += len(chunks)
    except Exception as exc:
        if isinstance(exc, NotImplementedError) or (
                not is_sw and not isinstance(exc, faults.FAILOVER)):
            # an unported option, and on the device route any error but an
            # injected fault or a card out of memory (a kernel that cannot
            # be built or launched, a CUDA error, a fault of the port's own
            # code), must not pass as a device failure
            raise
        # whole-batch failover (reference src/qatzip.c:2042-2060)
        if not is_sw and C.qz_sw_backup_enabled(p.sw_backup):
            QZ_WARN("HW compress failed (%s); falling back to SW", exc)
            backend, is_sw = _engine.cpu_backend, True
            compressed = backend.compress_chunks(chunks, p)
            rf.add("completed", len(compressed))
        else:
            QZ_ERROR("compress failed: %s", exc)
            rf.abort()
            res.rc = C.QZ_FAIL
            return res
    elapsed = time.perf_counter() - t0
    if p.is_sensitive_mode:
        per_chunk = elapsed / max(1, len(chunks))
        if is_sw:
            # bias regression back to HW (reference src/qatzip_sw.c:916-921)
            sess.swt.update(per_chunk / 4)
        else:
            sess.rrt.update(per_chunk)
    if is_sw:
        _engine.sw_requests += len(chunks)
        res.ext_rc |= C.QZ_SW_EXECUTION_MASK

    out = bytearray()
    consumed = 0
    first = crc_init == 0
    for i, cc in enumerate(compressed):
        member = framing.frame_chunk(fmt, cc.payload, cc.consumed, cc.checksum)
        if dest_limit is not None and len(out) + len(member) > dest_limit:
            if i == 0:
                rf.abort()
                res.rc = C.QZ_BUF_ERROR
                return res
            rf.reconcile()  # truncated by intent
            break
        out += member
        consumed += cc.consumed
        rf.add("reassembled")
        res.crc = _session_crc_update(kind, res.crc, cc.checksum, cc.consumed,
                                      first)
        first = False

    if not rf.check("compress"):
        # stage counts disagree: a backend dropped or duplicated a chunk —
        # fail rather than emit silently corrupt output
        res.rc = C.QZ_FAIL
        return res

    data = bytes(out)

    if kind == "xxh32" and consumed > 0:
        # Whole-request XXH32 over the input: per-chunk digests are not
        # combinable, and a caller treating the session CRC as a
        # whole-stream digest must get exactly that.  crc_init does not
        # carry (XXH32 cannot resume from a bare digest); the streaming API
        # is DEFLATE-only (reference src/qatzip_stream.c:478-484) so no
        # caller chains LZ4 requests.
        res.crc = ck.xxh32(src[:consumed], 0)

    # LZ4S post-processing hook (reference src/qatzip.c:1804-1839, 2071-2081)
    if fmt == DataFormatInternal.LZ4S_BK and p.qzCallback is not None:
        t1 = time.perf_counter()
        try:
            data = p.qzCallback(p.qzCallback_external, bytes(src[:consumed]),
                                data)
        except Exception as exc:
            QZ_ERROR("post-process callback failed: %s", exc)
            res.rc = C.QZ_POST_PROCESS_ERROR
            res.ext_rc |= C.QZ_POST_PROCESS_FAIL_MASK
            return res
        if p.is_sensitive_mode:
            sess.ppt.update((time.perf_counter() - t1) / max(1, len(chunks)))

    res.data = data
    res.consumed = consumed
    with sess.stats_lock:
        sess.total_in += consumed
        sess.total_out += len(data)
    sess.last_ext_rc = res.ext_rc
    return res


# ---------------------------------------------------------------------------
# Decompress funnel (qzDecompressExt analog, reference
# src/qatzip.c:2446-2671; header walk = checkHeader,
# src/qatzip_utils.c:1232-1345)
# ---------------------------------------------------------------------------
def _inflate_stream(buf: memoryview, off: int) -> tuple[bytes, int, bool]:
    """Inflate one raw-deflate stream starting at off; returns
    (data, compressed_len, stream_complete)."""
    do = zlib.decompressobj(-15)
    data = do.decompress(bytes(buf[off:]))
    data += do.flush()
    used = len(buf) - off - len(do.unused_data)
    return data, used, do.eof


def _batch_inflate_fast(rf, sess: QzSession, buf: memoryview,
                        p: InternalParams, kind: str,
                        res: OpResult) -> OpResult | None:
    """Single-native-call decompress of a run of size-framed members.

    Returns a completed OpResult, or None when the request is not eligible
    (inline members, unknown sizes) or the native path reports any error —
    the generic path then re-runs the request and produces the exact
    error/partial-output semantics.
    """
    n = len(buf)
    offs: list[int] = []
    plens: list[int] = []
    hints: list[int] = []
    expected: list[int] = []
    pos = 0
    while pos < n:
        member = _parse_member(buf, pos, p, sess)
        if member is None:
            break
        payload_off, payload_len, hint, expected_ck, total_len, inline = member
        if inline or hint < 0 or total_len < 0:
            return None
        offs.append(payload_off)
        plens.append(payload_len)
        hints.append(hint)
        expected.append(expected_ck if expected_ck is not None else -1)
        pos += total_len
    if not offs:
        return None
    ck_kind = 0 if kind == "crc32" else 1
    t0 = time.perf_counter()
    try:
        data, comb, last_eof = _native.batch_inflate(
            buf, offs, plens, hints, expected, ck_kind)
    except ValueError:
        return None  # corrupt/mismatch: generic path reproduces the error
    if p.is_sensitive_mode:
        sess.swt.update((time.perf_counter() - t0) / len(offs) / 4)
    rf.add("planned", len(offs))
    rf.add("submitted", len(offs))
    rf.add("completed", len(offs))
    rf.add("reassembled", len(offs))
    rf.check("decompress-native")
    _engine.sw_requests += len(offs)
    res.ext_rc |= C.QZ_SW_EXECUTION_MASK
    res.data = data
    res.consumed = pos
    res.crc = comb
    sess.end_of_last_block = last_eof
    with sess.stats_lock:
        sess.total_in += pos
        sess.total_out += len(data)
    sess.last_ext_rc = res.ext_rc
    return res


def decompress_ext(sess: QzSession, src, dest_limit: int | None = None) -> OpResult:
    rf = flow.request()
    if rf.spans is None:
        return _decompress_ext(rf, sess, src, dest_limit)
    src = _as_view(src)
    with rf.traced(len(src)):
        return _decompress_ext(rf, sess, src, dest_limit)


def _decompress_ext(rf, sess: QzSession, src,
                    dest_limit: int | None) -> OpResult:
    p = sess.params
    buf = _as_view(src)
    n = len(buf)
    res = OpResult()
    fmt = p.data_fmt
    kind = _engine.cpu_backend.checksum_kind(p)

    out = bytearray()
    pos = 0
    first = True
    sess.end_of_last_block = False

    backend, is_sw = choose_backend(sess, n, QzDirection.QZ_DIR_DECOMPRESS)
    if is_sw:
        res.ext_rc |= C.QZ_SW_EXECUTION_MASK

    # Native whole-request inflate funnel: when every member's framing
    # reveals its exact output size (gzipext/std-gzip isize), all members
    # inflate in one C call on a worker pool with checksum verification and
    # block-order CRC combination done natively.
    if (is_sw and _native is not None and dest_limit is None
            and not p.stop_decompression_stream_end
            and fmt in (DataFormatInternal.DEFLATE_GZIP,
                        DataFormatInternal.DEFLATE_GZIP_EXT)):
        fast = _batch_inflate_fast(rf, sess, buf, p, kind, res)
        if fast is not None:
            return fast

    # Walk member boundaries in batches; members whose framing reveals the
    # payload span (gzipext/4B/std-gzip/LZ4) are decoded together —
    # mirroring the reference's 32-in-flight chunk submission
    # (src/qatzip.c:1505-1594) — while foreign/raw members whose boundary is
    # only discoverable by inflating decode inline on the host.
    # a traced LZ4 request's member walk is one lz4.walk span [frames]
    lz4_walk = rf.spans is not None and fmt in (DataFormatInternal.LZ4_FH,
                                                DataFormatInternal.LZ4S_BK)
    stop = False
    while pos < n and not stop:
        members: list[tuple] = []
        scan = pos
        walk = rf.open("lz4.walk") if lz4_walk else None
        while scan < n:
            member = _parse_member(buf, scan, p, sess)
            if member is None:
                break
            members.append(member)
            total_len = member[4]
            if member[5] or total_len < 0:  # inline: boundary unknown yet
                break
            scan += total_len
        if walk is not None:
            rf.close(walk, len(members))
        if not members:
            if pos == 0:
                rf.abort()
                res.rc = C.QZ_DATA_ERROR
                return res
            break  # trailing garbage / partial member: stop at boundary
        rf.add("planned", len(members))

        batch = [m for m in members if not m[5]]
        decoded: list = []
        if batch:
            rf.add("submitted", len(batch))
            payloads = [buf[m[0]:m[0] + m[1]] for m in batch]
            hints = [m[2] for m in batch]
            t0 = time.perf_counter()
            try:
                decoded = backend.decompress_chunks(payloads, hints, p)
                # LSM latency matrices update on decompress too, so the
                # router converges in both directions (reference metric
                # update, src/qatzip_utils.c:1556-1612)
                if p.is_sensitive_mode:
                    per_chunk = (time.perf_counter() - t0) / len(batch)
                    if is_sw:
                        sess.swt.update(per_chunk / 4)
                    else:
                        sess.rrt.update(per_chunk)
                if not is_sw:
                    _engine.hw_requests += len(batch)
            except Exception as exc:
                if not is_sw and isinstance(exc, RefusedStream):
                    # corrupt input: a CPU rerun of the batch would refuse
                    # the chunk again (the reference reruns it)
                    QZ_ERROR("decompress refused: %s", exc)
                    rf.abort()
                    res.rc = C.QZ_DATA_ERROR
                    return res
                if isinstance(exc, NotImplementedError) or (
                        not is_sw and not isinstance(exc, faults.FAILOVER)):
                    raise  # see compress_ext
                if not is_sw and C.qz_sw_backup_enabled(p.sw_backup):
                    QZ_WARN("HW decompress failed (%s); falling back to SW",
                            exc)
                    res.ext_rc |= C.QZ_SW_EXECUTION_MASK
                    is_sw = True
                    try:
                        decoded = _engine.cpu_backend.decompress_chunks(
                            payloads, hints, p)
                    except Exception:
                        rf.abort()
                        res.rc = C.QZ_DATA_ERROR
                        return res
                else:
                    rf.abort()
                    res.rc = C.QZ_DATA_ERROR
                    return res
            rf.add("completed", len(decoded))
            if is_sw:
                _engine.sw_requests += len(batch)

        di = 0
        emitted = 0
        for member in members:
            (payload_off, payload_len, hint, expected_ck, total_len,
             inline) = member
            if inline:
                # boundary unknown until inflate: decode on host
                rf.add("submitted")
                data, used, eof = _inflate_stream(buf, payload_off)
                rf.add("completed")
                total_len = (payload_off - pos) + used + framing.footer_sz(fmt) \
                    if fmt in (DataFormatInternal.DEFLATE_GZIP,
                               DataFormatInternal.DEFLATE_GZIP_EXT,
                               DataFormatInternal.DEFLATE_ZLIB) else \
                    (payload_off - pos) + used
                chunk_ck = (ck.crc32(data) if kind == "crc32"
                            else ck.adler32(data) if kind == "adler32"
                            else ck.xxh32(data, 0))
                if fmt in (DataFormatInternal.DEFLATE_GZIP,
                           DataFormatInternal.DEFLATE_GZIP_EXT):
                    fpos = payload_off + used
                    if fpos + 8 <= n:
                        fcrc, fisize = gzip_fmt.parse_std_gzip_footer(buf, fpos)
                        if fcrc != chunk_ck or fisize != (len(data) & 0xFFFFFFFF):
                            rf.abort()
                            res.rc = C.QZ_DATA_ERROR
                            return res
                elif fmt == DataFormatInternal.DEFLATE_ZLIB:
                    fpos = payload_off + used
                    if fpos + 4 <= n:
                        fadl = zlib_fmt.parse_zlib_footer(buf, fpos)
                        if fadl != chunk_ck:
                            rf.abort()
                            res.rc = C.QZ_DATA_ERROR
                            return res
                eos = eof
            else:
                dc = decoded[di]
                di += 1
                data, chunk_ck, eos = dc.data, dc.checksum, dc.end_of_stream
                bad_ck = expected_ck is not None and chunk_ck != expected_ck
                # gzip's ISIZE is mandatory: a decoded size disagreeing with
                # the footer (mod 2^32, per RFC1952) is corruption even when
                # the CRC field collides
                bad_sz = (hint >= 0 and (len(data) & 0xFFFFFFFF) != hint
                          and fmt in (DataFormatInternal.DEFLATE_GZIP,
                                      DataFormatInternal.DEFLATE_GZIP_EXT))
                if bad_ck or bad_sz:
                    if (not first and not eos
                            and payload_off + payload_len
                            + framing.footer_sz(fmt) >= n):
                        # the trailing member is structurally incomplete
                        # (input truncated mid-member): stop at the previous
                        # member boundary — the partial-consume contract,
                        # not a data error
                        stop = True
                        break
                    QZ_ERROR("member mismatch: crc %08x expect %s size %d "
                             "expect %d", chunk_ck, expected_ck, len(data),
                             hint)
                    rf.abort()
                    res.rc = C.QZ_DATA_ERROR
                    return res

            if dest_limit is not None and len(out) + len(data) > dest_limit:
                if first:
                    rf.abort()
                    res.rc = C.QZ_BUF_ERROR
                    return res
                stop = True
                break

            out += data
            pos += total_len
            emitted += 1
            rf.add("reassembled")
            res.crc = _session_crc_update(kind, res.crc, chunk_ck, len(data),
                                          first)
            first = False
            sess.end_of_last_block = eos

            if p.stop_decompression_stream_end and eos:
                stop = True
                break
        if stop:
            # intentional early stop (dest_limit / stream-end): planned
            # members past the stop point are skipped by design, not lost
            rf.reconcile()

    if not rf.check("decompress"):
        res.rc = C.QZ_FAIL
        return res
    res.data = bytes(out)
    if kind == "xxh32" and out:
        # whole-output digest, mirroring the compress-side semantics
        span = rf.open("lz4.checksum") if rf.spans is not None else None
        res.crc = ck.xxh32(res.data, 0)
        if span is not None:
            rf.close(span, len(res.data))
    res.consumed = pos
    with sess.stats_lock:
        sess.total_in += pos
        sess.total_out += len(out)
    sess.last_ext_rc = res.ext_rc
    return res


def _parse_member(buf: memoryview, pos: int, p: InternalParams,
                  sess: QzSession):
    """Parse one member's framing at pos.

    Returns (payload_off, payload_len, out_size_hint, expected_checksum,
    member_total_len, inline_decode) or None when no further member can be
    parsed.  ``inline_decode`` means the member boundary is only discoverable
    by inflating (foreign gzip headers, raw deflate).
    """
    fmt = p.data_fmt
    n = len(buf)
    avail = n - pos

    if fmt == DataFormatInternal.DEFLATE_4B:
        if avail < 4:
            return None
        (blk,) = struct.unpack_from("<I", buf, pos)
        if blk > avail - 4:
            return None
        # oversized chunk forces sticky SW mode (reference
        # src/qatzip_utils.c:1320-1332)
        if blk > C.qz_dest_sz(p.hw_buff_sz):
            sess.force_sw = True
        return (pos + 4, blk, -1, None, 4 + blk, False)

    if fmt in (DataFormatInternal.DEFLATE_GZIP, DataFormatInternal.DEFLATE_GZIP_EXT):
        ext = gzip_fmt.parse_gzipext_header(buf, pos)
        if ext is not None:
            ho = pos + gzip_fmt.GZIPEXT_HEADER_SIZE
            if ext.dest_sz > avail - gzip_fmt.GZIPEXT_HEADER_SIZE:
                return None
            fo = ho + ext.dest_sz
            expected = None
            if fo + 8 <= n:
                fcrc, _ = gzip_fmt.parse_std_gzip_footer(buf, fo)
                expected = fcrc
            if ext.src_sz > p.hw_buff_sz or ext.dest_sz > C.qz_dest_sz(p.hw_buff_sz):
                sess.force_sw = True
            total = gzip_fmt.GZIPEXT_HEADER_SIZE + ext.dest_sz + 8
            return (ho, ext.dest_sz, ext.src_sz, expected, total, False)
        if gzip_fmt.is_std_gzip_header(buf, pos):
            # plain member: find footer by scanning for the next plain header
            foot = gzip_fmt.find_std_gzip_footer(buf, pos, avail)
            ho = pos + gzip_fmt.STD_GZIP_HEADER_SIZE
            plen = foot - ho
            if plen < 0:
                return None
            fcrc, fisize = gzip_fmt.parse_std_gzip_footer(buf, foot)
            if fisize > p.hw_buff_sz or plen > C.qz_dest_sz(p.hw_buff_sz):
                sess.force_sw = True
            return (ho, plen, fisize, fcrc, foot + 8 - pos, False)
        hdr = gzip_fmt.parse_any_gzip_header(buf, pos)
        if hdr is not None:
            # foreign gzip flags: decode inline (the reference forces SW here)
            sess.force_sw = True
            return (pos + hdr[0], -1, -1, None, -1, True)
        return None

    if fmt == DataFormatInternal.DEFLATE_RAW:
        if avail <= 0:
            return None
        return (pos, -1, -1, None, -1, True)

    if fmt == DataFormatInternal.DEFLATE_ZLIB:
        if not zlib_fmt.verify_zlib_header(buf, pos):
            return None
        return (pos + zlib_fmt.STD_ZLIB_HEADER_SIZE, -1, -1, None, -1, True)

    if fmt == DataFormatInternal.LZ4_FH:
        if avail < lz4_fmt.LZ4_HEADER_SIZE:
            return None
        try:
            hlen, hdr = lz4_fmt.parse_lz4_frame_header(buf, pos)
        except ValueError:
            return None
        foot = lz4_fmt.find_lz4_footer(buf, pos, avail)
        if foot is None:
            return None
        expected = struct.unpack_from("<I", buf, foot + 4)[0]
        payload_len = foot - (pos + hlen)
        total = (foot + lz4_fmt.LZ4_FOOTER_SIZE) - pos
        if (hdr.content_size > p.hw_buff_sz
                or payload_len > C.qz_dest_sz(p.hw_buff_sz)):
            sess.force_sw = True
        return (pos + hlen, payload_len, hdr.content_size, expected, total, False)

    if fmt == DataFormatInternal.LZ4S_BK:
        if avail < 4:
            return None
        (blk,) = struct.unpack_from("<I", buf, pos)
        if blk > avail - 4:
            return None
        return (pos + 4, blk, -1, None, 4 + blk, False)

    return None
