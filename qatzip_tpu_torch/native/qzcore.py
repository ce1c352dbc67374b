"""ctypes binding for the port's libqzcore.so (built on demand from the
sources beside it): the part of qatzip_tpu/native/qzcore.py the port calls,
and the port's own ``inflate_headers`` (qzheaders.cpp), ``inflate_regions``
(qzregions.cpp), ``apply_round`` (qzapply.cpp), ``pack_rows`` and
``xxh32_rows`` (qzrows.cpp).
Its build-or-load is the ``setup.native`` phase (engine/flow.py; 1 when it
compiled)."""
from __future__ import annotations

import ctypes

from qatzip_tpu_torch.engine.flow import flow as _flow, now as _now
from qatzip_tpu_torch.native.build import _fresh, build

_since = _now()
_compiled = not _fresh()
_path = build()

_lib = ctypes.CDLL(_path)
_flow.record_setup("setup.native", _since, int(_compiled))

_lib.qz_lz4_compress_block.restype = ctypes.c_int64
_lib.qz_lz4_compress_block.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_int64]
_lib.qz_lz4s_compress_block.restype = ctypes.c_int64
_lib.qz_lz4s_compress_block.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_int]
_lib.qz_lz4_decompress_block.restype = ctypes.c_int64
_lib.qz_lz4_decompress_block.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_int64]
_lib.qz_lz4s_decompress_block.restype = ctypes.c_int64
_lib.qz_lz4s_decompress_block.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_int]
_lib.qz_crc32_combine.restype = ctypes.c_uint32
_lib.qz_crc32_combine.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                  ctypes.c_int64]
_lib.qz_crc32.restype = ctypes.c_uint32
_lib.qz_crc32.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64]
_lib.qz_adler32.restype = ctypes.c_uint32
_lib.qz_adler32.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64]
_lib.qz_adler32_combine.restype = ctypes.c_uint32
_lib.qz_adler32_combine.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                    ctypes.c_int64]
_lib.qz_crc_generic.restype = ctypes.c_uint64
_lib.qz_crc_generic.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_uint64, ctypes.c_uint64,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_uint64]
_lib.qz_deflate_compress.restype = ctypes.c_int64
_lib.qz_deflate_compress.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int]
_lib.qz_deflate_candidates.restype = ctypes.c_int64
_lib.qz_deflate_candidates.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_int]
_lib.qz_deflate_candidates_packed.restype = ctypes.c_int64
_lib.qz_deflate_candidates_packed.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
_lib.qz_inflate.restype = ctypes.c_int64
_lib.qz_inflate.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_void_p, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_int64),
                            ctypes.POINTER(ctypes.c_int32)]
_lib.qz_batch_deflate_compress.restype = ctypes.c_int64
_lib.qz_batch_deflate_compress.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32)]
_lib.qz_batch_inflate.restype = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
_lib.qz_batch_inflate.argtypes = [
    ctypes.c_void_p, _I64P, _I64P, _I64P, _I64P, _I64P,
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32)]
_lib.qz_xxh32.restype = ctypes.c_uint32
_lib.qz_xxh32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
_lib.qz_pack_rows.restype = None
_lib.qz_pack_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
_lib.qz_xxh32_rows.restype = None
_lib.qz_xxh32_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_uint32,
                               ctypes.c_void_p]
_lib.qz_xxh64.restype = ctypes.c_uint64
_lib.qz_xxh64.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
_lib.qz_lz4_candidates.restype = ctypes.c_int64
_lib.qz_lz4_candidates.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_int]
_lib.qz_inflate_regions.restype = ctypes.c_int64
_lib.qz_inflate_regions.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p]
_lib.qz_inflate_headers.restype = ctypes.c_int64
_lib.qz_inflate_headers.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] \
    + [ctypes.c_void_p] * 7
_lib.qz_apply_round.restype = None
_lib.qz_apply_round.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int32, ctypes.c_void_p]
_lib.qz_lz4_assemble.restype = ctypes.c_int64
_lib.qz_lz4_assemble.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int, ctypes.c_int]
_lib.qz_huff_build_batch.restype = ctypes.c_int
_lib.qz_huff_build_batch.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p]


def _addr(data):
    """(c_void_p, length, keepalive) for any contiguous bytes-like object,
    zero-copy whenever the buffer protocol allows it.  This is the pinned-
    buffer fast path of the reference (qzMemFindAddr -> zero-copy DMA,
    src/qatzip_utils.c:1350-1427): qz_malloc buffers, bytearrays, numpy
    arrays and memoryview slices feed the native funnels without a memcpy.
    """
    if isinstance(data, bytes):
        return ctypes.cast(data, ctypes.c_void_p), len(data), data
    mv = data if isinstance(data, memoryview) else memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    if not mv.contiguous:
        b = mv.tobytes()
        return ctypes.cast(b, ctypes.c_void_p), len(b), b
    n = mv.nbytes
    if n == 0:
        return ctypes.c_void_p(0), 0, mv
    if mv.readonly:
        # readonly view over bytes: address the underlying object directly
        obj = getattr(mv, "obj", None)
        if isinstance(obj, bytes) and len(obj) == n:
            return ctypes.cast(obj, ctypes.c_void_p), n, obj
        arr = (ctypes.c_char * n).from_buffer_copy(mv)
        return ctypes.cast(arr, ctypes.c_void_p), n, arr
    arr = (ctypes.c_char * n).from_buffer(mv)
    return ctypes.cast(arr, ctypes.c_void_p), n, (mv, arr)


# thread-local output arena for the batch funnels: reused pages stay
# faulted+cached across calls (the reference's pinned-buffer pool role,
# src/qatzip_mem.c); ctypes.create_string_buffer would zero-fill 30MB+
# per request and fresh np.empty pays page faults inside the C call
import threading

_tls = threading.local()


def _arena(n: int):
    import numpy as np

    buf = getattr(_tls, "buf", None)
    if buf is None or buf.size < n:
        buf = np.empty(max(n, 1 << 20), np.uint8)
        _tls.buf = buf
    return buf


# header/footer sizes by qzbatch.cpp wire-format code (enum Fmt)
_BATCH_HDR = {0: 4, 1: 10, 2: 24, 3: 0, 4: 2}
_BATCH_FTR = {0: 0, 1: 8, 2: 8, 3: 0, 4: 4}


def xxh32(data, seed: int = 0) -> int:
    """Vendored XXH32 (the reference vendors src/xxhash.c)."""
    p, n, keep = _addr(data)
    return _lib.qz_xxh32(p, n, seed & 0xFFFFFFFF)


def _rows(parts):
    """The addresses and lengths of bytes-like ``parts`` as C arrays, and
    what keeps their buffers alive."""
    keep = [_addr(p) for p in parts]
    ptrs = (ctypes.c_void_p * len(keep))(*(k[0].value for k in keep))
    lens = (ctypes.c_int64 * len(keep))(*(k[1] for k in keep))
    return ptrs, lens, keep


def pack_rows(parts, dst) -> None:
    """Copy each of ``parts`` to the start of its row of ``dst``, a
    C-contiguous uint8 numpy array of ``len(parts)`` rows, in one call
    outside the interpreter lock (``qzrows.cpp``)."""
    if (dst.dtype.itemsize != 1 or dst.ndim != 2
            or not dst.flags.c_contiguous or not dst.flags.writeable
            or dst.shape[0] != len(parts)):
        raise ValueError("pack_rows needs a writable C-contiguous uint8 "
                         f"[{len(parts)}, n] array")
    ptrs, lens, keep = _rows(parts)
    if max(lens, default=0) > dst.shape[1]:
        raise ValueError("a part is longer than a row")
    _lib.qz_pack_rows(ptrs, lens, len(parts), dst.ctypes.data, dst.shape[1])


def xxh32_rows(parts, seed: int = 0) -> list[int]:
    """XXH32 of each of ``parts``, in one call outside the interpreter lock
    (``qzrows.cpp``)."""
    ptrs, lens, keep = _rows(parts)
    out = (ctypes.c_uint32 * len(parts))()
    _lib.qz_xxh32_rows(ptrs, lens, len(parts), seed & 0xFFFFFFFF, out)
    return list(out)


def xxh64(data, seed: int = 0) -> int:
    p, n, keep = _addr(data)
    return _lib.qz_xxh64(p, n, seed & 0xFFFFFFFFFFFFFFFF)


def lz4_assemble(data: bytes, rec, mode: int = 0,
                 mini_match: int = 3) -> bytes:
    """Emit an LZ4 (mode 0) / LZ4s (mode 1) block from the device
    encoder's per-position (mlen<<15|dist) records."""
    import numpy as np

    rec = np.ascontiguousarray(rec, np.int32)
    p, dn, keep = _addr(data)
    cap = dn + dn // 255 + 64
    out = _arena(cap)
    n = _lib.qz_lz4_assemble(p, dn,
                             rec.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p), cap,
                             mode, mini_match)
    if n < 0:
        raise ValueError("lz4 assembly failed")
    return out[:n].tobytes()


def lz4_candidates(data, cand_u16, mode: int = 0,
                   mini_match: int = 3) -> bytes:
    """Hybrid LZ4/LZ4s: device candidate distances -> native verify/extend/
    parse/emit (qz_lz4_candidates in qzcore.cpp)."""
    import numpy as np

    p, dn, keep = _addr(data)
    cand = np.ascontiguousarray(cand_u16, np.uint16)
    if cand.size < dn:
        raise ValueError("candidate array shorter than data")
    cap = dn + dn // 255 + 64
    buf = _arena(cap)
    m = _lib.qz_lz4_candidates(p, dn, cand.ctypes.data_as(ctypes.c_void_p),
                               buf.ctypes.data_as(ctypes.c_void_p), cap,
                               mode, mini_match)
    if m < 0:
        raise ValueError("lz4_candidates failed")
    return buf[:m].tobytes()


def lz4_compress_block(data) -> bytes:
    p, dn, keep = _addr(data)
    cap = dn + dn // 255 + 64
    buf = _arena(cap)
    n = _lib.qz_lz4_compress_block(p, dn, buf.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise ValueError("lz4 compress failed")
    return buf[:n].tobytes()


def lz4s_compress_block(data, mini_match: int = 3) -> bytes:
    p, dn, keep = _addr(data)
    cap = dn + dn // 255 + 64
    buf = _arena(cap)
    n = _lib.qz_lz4s_compress_block(p, dn, buf.ctypes.data_as(ctypes.c_void_p), cap, mini_match)
    if n < 0:
        raise ValueError("lz4s compress failed")
    return buf[:n].tobytes()


def lz4_decompress_block(block: bytes, max_out: int) -> bytes:
    # LZ4 frame blocks decode to <= 4MB by spec; 64MB bounds the arena
    cap = min(max_out, 1 << 26) if max_out > 0 else 1 << 26
    buf = _arena(cap)
    p, bn, keep = _addr(block)
    n = _lib.qz_lz4_decompress_block(p, bn, buf.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise ValueError("corrupt lz4 block")
    return buf[:n].tobytes()


def lz4s_decompress_block(block: bytes, max_out: int,
                          mini_match: int = 3) -> bytes:
    cap = min(max_out, 1 << 26) if max_out > 0 else 1 << 26
    buf = _arena(cap)
    p, bn, keep = _addr(block)
    n = _lib.qz_lz4s_decompress_block(p, bn, buf.ctypes.data_as(ctypes.c_void_p), cap, mini_match)
    if n < 0:
        raise ValueError("corrupt lz4s block")
    return buf[:n].tobytes()


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    return _lib.qz_crc32_combine(crc1 & 0xFFFFFFFF, crc2 & 0xFFFFFFFF, len2)


def deflate_compress(data, level: int = 1) -> bytes:
    """Raw-deflate compress (complete stream, BFINAL set)."""
    p, dn, keep = _addr(data)
    cap = dn + (dn >> 3) + 1024
    buf = _arena(cap)
    n = _lib.qz_deflate_compress(p, dn, buf.ctypes.data_as(ctypes.c_void_p), cap, level)
    if n < 0:
        raise ValueError("deflate compress failed")
    return buf[:n].tobytes()


def deflate_candidates(data, cand_u16, level: int = 1) -> bytes:
    """Hybrid deflate: device-found candidate distances -> native verify/
    extend/parse/entropy-code (qz_deflate_candidates in qzdeflate.cpp)."""
    import numpy as np

    p, dn, keep = _addr(data)
    cand = np.ascontiguousarray(cand_u16, np.uint16)
    if cand.size < dn:
        raise ValueError("candidate array shorter than data")
    cap = dn + (dn >> 3) + 1024
    buf = _arena(cap)
    n = _lib.qz_deflate_candidates(p, dn,
                                   cand.ctypes.data_as(ctypes.c_void_p),
                                   buf.ctypes.data_as(ctypes.c_void_p),
                                   cap, level)
    if n < 0:
        raise ValueError("deflate_candidates failed")
    return buf[:n].tobytes()


def deflate_candidates_packed(data, packed_u8, level: int = 1) -> bytes:
    """Hybrid deflate from the PACKED candidate format (0.75 B per input
    byte of D2H instead of 2; see match_finder.find_candidates_packed):
    native unpack + verify/extend/parse/entropy-code in one call."""
    import numpy as np

    p, dn, keep = _addr(data)
    pk = np.ascontiguousarray(packed_u8, np.uint8)
    packed_n = pk.size * 4 // 3  # padded candidate width
    if packed_n < dn:
        raise ValueError("packed candidate array shorter than data")
    cap = dn + (dn >> 3) + 1024
    buf = _arena(cap)
    n = _lib.qz_deflate_candidates_packed(
        p, dn, pk.ctypes.data_as(ctypes.c_void_p), packed_n,
        buf.ctypes.data_as(ctypes.c_void_p), cap, level)
    if n < 0:
        raise ValueError("deflate_candidates_packed failed")
    return buf[:n].tobytes()


def crc32(data, crc: int = 0) -> int:
    p, n, keep = _addr(data)
    return _lib.qz_crc32(crc & 0xFFFFFFFF, p, n)


def adler32(data, adler: int = 1) -> int:
    p, n, keep = _addr(data)
    return _lib.qz_adler32(adler & 0xFFFFFFFF, p, n)


def adler32_combine(a1: int, a2: int, len2: int) -> int:
    return _lib.qz_adler32_combine(a1 & 0xFFFFFFFF, a2 & 0xFFFFFFFF, len2)


def crc_generic(data: bytes, poly: int, init: int, width: int,
                reflect_in: bool, reflect_out: bool, xor_out: int) -> int:
    """Rocksoft-model CRC, width 8..64 (session-configurable CRC32/CRC64)."""
    p, n, keep = _addr(data)
    return _lib.qz_crc_generic(p, n, poly, init, width,
                               int(reflect_in), int(reflect_out), xor_out)


def batch_deflate_compress(data, chunk_sz: int, level: int,
                           fmt_code: int, ck_kind: int) -> tuple[bytes, int]:
    """Whole-request compress: chunk, deflate, frame, checksum, reassemble —
    one native call on a worker pool.  Returns (framed_bytes, combined_crc).
    Accepts any contiguous bytes-like object zero-copy (pinned path).
    """
    p, n, keep = _addr(data)
    nchunks = (n + chunk_sz - 1) // chunk_sz
    slot = (_BATCH_HDR[fmt_code] + _BATCH_FTR[fmt_code]
            + chunk_sz + (chunk_sz >> 3) + 1024)
    cap = nchunks * slot
    buf = _arena(cap)
    crc = ctypes.c_uint32(0)
    total = _lib.qz_batch_deflate_compress(
        p, n, chunk_sz, level, fmt_code, ck_kind,
        buf.ctypes.data_as(ctypes.c_void_p), cap, slot, ctypes.byref(crc))
    if total < 0:
        raise ValueError("batch compress failed")
    return buf[:total].tobytes(), crc.value


def batch_inflate(comp, offs: list[int], plens: list[int],
                  hints: list[int], expected: list[int],
                  ck_kind: int) -> tuple[bytes, int, bool]:
    """Batch-inflate independent members at known output sizes.

    expected[i] < 0 skips that member's checksum verification.  Returns
    (output, combined_crc, last_member_bfinal).  Raises ValueError on any
    corrupt/mismatching member (caller falls back to the generic path).
    """
    nm = len(offs)
    out_offs, acc = [], 0
    for h in hints:
        out_offs.append(acc)
        acc += h
    buf = _arena(acc)
    arr = ctypes.c_int64 * nm
    crc = ctypes.c_uint32(0)
    eof = ctypes.c_int32(0)
    cp, _cn, keep = _addr(comp)
    total = _lib.qz_batch_inflate(cp, arr(*offs), arr(*plens),
                                  arr(*out_offs), arr(*hints), arr(*expected),
                                  nm, ck_kind,
                                  buf.ctypes.data_as(ctypes.c_void_p),
                                  ctypes.byref(crc), ctypes.byref(eof))
    if total < 0:
        raise ValueError(f"batch inflate failed ({total})")
    return buf[:total].tobytes(), crc.value, bool(eof.value)


def inflate(data, max_out: int) -> tuple[bytes, int, bool]:
    """Inflate one raw-deflate stream.

    Returns (output, compressed_bytes_consumed, reached_final_block).
    Raises ValueError on corrupt input, OverflowError when max_out is too
    small (caller may retry with a larger buffer).
    """
    cap = max(max_out, 1)
    buf = _arena(cap)
    used = ctypes.c_int64(0)
    eof = ctypes.c_int32(0)
    p, dn, keep = _addr(data)
    n = _lib.qz_inflate(p, dn, buf.ctypes.data_as(ctypes.c_void_p), cap,
                        ctypes.byref(used), ctypes.byref(eof))
    if n == -2:
        raise OverflowError("inflate output exceeds max_out")
    if n < 0:
        raise ValueError("corrupt deflate stream")
    return buf[:n].tobytes(), used.value, bool(eof.value)


# qz_apply_round's lane statuses: 0, or why the lane failed
APPLY_STATUS = {-1: "window underrun", -2: "token overflow", -3: "bad token",
                -4: "fewer bytes than the count"}
APPLY_KIND = {"": 0, "crc32": 1, "adler32": 2}


def apply_round(tokens_np, addrs, pos, cap, outcnt, ck, kind: str, status):
    """Apply a lockstep round's tokens to every lane in one call that runs
    outside the interpreter lock (``qz_apply_round``, qzapply.cpp): lane l
    writes ``outcnt[l]`` bytes into the buffer at ``addrs[l]`` (``cap[l]``
    bytes long) from its cursor ``pos[l]``, reading its history from the
    same buffer, and advances its running checksum ``ck[l]`` of ``kind``
    ("", "crc32" or "adler32").

    tokens_np: uint32 C-contiguous [nsteps, lanes]; addrs uint64, pos, cap
    and outcnt int64, ck uint32, status int32, each C-contiguous [lanes].
    pos, ck and status are written in place: a lane given a nonzero status
    is left alone; a lane that comes back 0 has its new cursor and
    checksum, any other a key of APPLY_STATUS.  The caller keeps every
    buffer alive and writable for the call.
    """
    import numpy as np

    nsteps, lanes = tokens_np.shape
    want = ((tokens_np, np.uint32), (addrs, np.uint64), (pos, np.int64),
            (cap, np.int64), (outcnt, np.int64), (ck, np.uint32),
            (status, np.int32))
    for a, dt in want:
        if a.dtype != dt or not a.flags.c_contiguous:
            raise ValueError("apply_round needs C-contiguous "
                             f"{np.dtype(dt).name} arrays")
    if any(a.shape != (lanes,) for a, _ in want[1:]):
        raise ValueError(f"apply_round needs [{lanes}] lane arrays")
    _lib.qz_apply_round(tokens_np.ctypes.data, nsteps, lanes,
                        addrs.ctypes.data, pos.ctypes.data, cap.ctypes.data,
                        outcnt.ctypes.data, ck.ctypes.data, APPLY_KIND[kind],
                        status.ctypes.data)


# qz_inflate_headers' lane kinds, and its rejects: the exception the
# reference's parse (qatzip_tpu/ops/deflate_decode.py) raises on the lane
HEADER_STORED, HEADER_STATIC, HEADER_DYNAMIC = 0, 1, 2
HEADER_REJECT = {-1: (EOFError, "deflate stream truncated"),
                 -2: (ValueError, "bad code-length code"),
                 -3: (ValueError, "repeat with no previous length"),
                 -4: (ValueError, "code-length overrun"),
                 -5: (EOFError, "truncated stored block"),
                 -6: (ValueError, "stored block LEN/NLEN mismatch"),
                 -7: (EOFError, "truncated stored block data"),
                 -8: (ValueError, "reserved BTYPE")}
HEADER_ROW = 320   # 288 litlen and 32 distance code lengths at most


def inflate_headers(payloads, pos):
    """Parse the block header at each lane's bit position in one call that
    runs outside the interpreter lock (``qz_inflate_headers``,
    qzheaders.cpp), by the reference's rules.

    payloads: a ``bytes`` a lane, which the caller keeps alive; pos: int64
    C-contiguous [lanes], written in place: a lane that parses moves past
    its header, and past a stored block's data.  Returns (kind, final,
    rows, nll, nd, off, length), each [lanes]: kind int32 a HEADER_ kind
    or a key of HEADER_REJECT; final int32 the block's BFINAL; rows int32
    [lanes, HEADER_ROW] a dynamic block's nll litlen then nd distance code
    lengths (nll -1 on every other lane: ``qz_inflate_regions``' skipped
    lane); off and length int64 a stored block's data in its payload.
    """
    import numpy as np

    n = len(payloads)
    if pos.dtype != np.int64 or not pos.flags.c_contiguous or \
            pos.shape != (n,):
        raise ValueError(f"inflate_headers needs C-contiguous int64 [{n}]")
    if not all(type(p) is bytes for p in payloads):
        raise ValueError("inflate_headers needs a bytes payload a lane")
    addrs = np.array([ctypes.cast(p, ctypes.c_void_p).value
                      for p in payloads], np.uint64)
    nbytes = np.array([len(p) for p in payloads], np.int64)
    rows = np.empty((n, HEADER_ROW), np.int32)
    nll, nd, kind, final = (np.empty(n, np.int32) for _ in range(4))
    off, length = np.empty(n, np.int64), np.empty(n, np.int64)
    _lib.qz_inflate_headers(addrs.ctypes.data, nbytes.ctypes.data,
                            pos.ctypes.data, n, rows.ctypes.data,
                            nll.ctypes.data, nd.ctypes.data, kind.ctypes.data,
                            final.ctypes.data, off.ctypes.data,
                            length.ctypes.data)
    return kind, final, rows, nll, nd, off, length


# qz_inflate_regions' lane statuses: 0, or the ValueError that the
# reference's numpy builder (qatzip_tpu/ops/pallas_inflate.py) raises on
# the lane's lengths
REGION_STATUS = {1: "over-subscribed Huffman code", 2: "subtable overflow",
                 3: "root/sub collision", 4: "code length outside 0..15"}


def inflate_regions(lens, tll, td):
    """Build a lockstep round's packed table regions (ops/inflate.py's
    layout, byte-equal to the reference's numpy region builders) in one
    call that runs outside the interpreter lock.

    lens[i] is lane i's (litlen lengths, distance lengths), or None for a
    lane whose rows the caller fills (a static block).  tll/td: uint32
    C-contiguous [lanes, 512], written in place.  Returns the lanes'
    statuses, int32[lanes]: 0, or a key of REGION_STATUS (that lane's rows
    then hold nothing of use).
    """
    import numpy as np

    n = len(lens)
    for t in (tll, td):
        if (t.dtype != np.uint32 or not t.flags.c_contiguous
                or t.shape != (n, 512)):
            raise ValueError("regions must be uint32 C-contiguous [lanes, 512]")
    nll = np.full(n, -1, np.int32)       # -1: the caller's lane, skipped
    nd = np.zeros(n, np.int32)
    for i, p in enumerate(lens):
        if p is not None:
            nll[i], nd[i] = len(p[0]), len(p[1])
    rows = np.zeros((n, max(int((nll + nd).max(initial=0)), 1)), np.int32)
    for i, p in enumerate(lens):
        if p is not None:
            h = len(p[0])
            rows[i, :h] = p[0]
            rows[i, h:h + len(p[1])] = p[1]
    status = np.zeros(n, np.int32)
    _lib.qz_inflate_regions(rows.ctypes.data, rows.shape[1], nll.ctypes.data,
                            nd.ctypes.data, n, tll.ctypes.data, td.ctypes.data,
                            status.ctypes.data)
    return status


def huff_build_batch(freq_ll, freq_d, blk_len, allow_dynamic: bool,
                     bit_capacity: int, hdr_max: int):
    """Batch true-Huffman + dynamic-header build for the device encoder
    (see qz_huff_build_batch in qzdeflate.cpp).

    freq_ll [B,286] / freq_d [B,30] / blk_len [B] numpy arrays.  Returns
    (mode[B] i32, ll_len[B,286] i32, ll_code[B,286] i32, d_len[B,30] i32,
    d_code[B,30] i32, hdr_vals[B,HMAX] u32, hdr_nbits[B,HMAX] i32,
    est_bits[B] i64).
    """
    import numpy as np

    freq_ll = np.ascontiguousarray(freq_ll, np.uint32)
    freq_d = np.ascontiguousarray(freq_d, np.uint32)
    blk_len = np.ascontiguousarray(blk_len, np.int32)
    B = freq_ll.shape[0]
    mode = np.zeros(B, np.int32)
    ll_len = np.zeros((B, 286), np.int32)
    ll_code = np.zeros((B, 286), np.int32)
    d_len = np.zeros((B, 30), np.int32)
    d_code = np.zeros((B, 30), np.int32)
    hv = np.zeros((B, hdr_max), np.uint32)
    hn = np.zeros((B, hdr_max), np.int32)
    est = np.zeros(B, np.int64)
    rc = _lib.qz_huff_build_batch(
        freq_ll.ctypes.data, freq_d.ctypes.data, blk_len.ctypes.data,
        B, int(allow_dynamic), bit_capacity, hdr_max,
        mode.ctypes.data, ll_len.ctypes.data, ll_code.ctypes.data,
        d_len.ctypes.data, d_code.ctypes.data,
        hv.ctypes.data, hn.ctypes.data, est.ctypes.data)
    if rc != 0:
        raise ValueError("huff_build_batch: header overflow")
    return mode, ll_len, ll_code, d_len, d_code, hv, hn, est
