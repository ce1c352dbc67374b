"""Metadata (block-index) API of the port: random-access compression (a
copy of qatzip_tpu/metadata.py).

The reference *declares* this surface but implements it only on Windows
(qzAllocateMetadata / qzCompressWithMetadataExt / qzMetadataBlock* —
include/qatzip.h:1446-1455, 1747-1754, 2229-2231, 2927-3101; the Linux
build returns QZ_NOT_SUPPORTED).  SURVEY.md marks it as "implement for
real": a per-block index of (offset, size, flags, hash) over the
compressed buffer is the natural random-access format and is exactly what
makes block-parallel decompression possible on a device mesh.

Wire layout produced by :func:`qz_compress_with_metadata_ext`: the dest
buffer is the bare concatenation of per-block payloads (raw deflate
streams, or raw input bytes for incompressible blocks) with **no framing**
— the metadata blob carries all boundaries, so any block can be read or
replaced without touching the others.

Block flags: bit0 = stored (payload is the uncompressed input verbatim),
bit1 = deflate payload.

Unlike the reference, only an injected fault or a card out of memory
(``faults.FAILOVER``) raised by the device backend falls back to the CPU,
as in the engine's funnels (engine/core.py); any other error (a
``KernelError``, a CUDA error, a ``NotImplementedError`` for an unported
option) reaches the caller, and a block the device failed over that zlib
refuses is QZ_DATA_ERROR with no CPU rerun.
"""
from __future__ import annotations

import dataclasses

from qatzip_tpu_torch import constants as C
from qatzip_tpu_torch.constants import DataFormatInternal, QzDirection
from qatzip_tpu_torch.engine import core, faults
from qatzip_tpu_torch.engine.backend import RefusedStream
from qatzip_tpu_torch.engine.core import OpResult
from qatzip_tpu_torch.session import QzSession
from qatzip_tpu_torch.utils import checksum as ck

QZ_METADATA_BLOCK_STORED = 0x1
QZ_METADATA_BLOCK_DEFLATE = 0x2


@dataclasses.dataclass
class _BlockEntry:
    offset: int = 0        # byte offset of the payload in the dest buffer
    size: int = 0          # payload size in bytes
    flags: int = 0
    hash: int = 0          # crc32 (gzip) of the uncompressed block
    src_size: int = 0      # uncompressed block size
    input_crc32: int = 0   # session-configured crc32 of the block input
    output_crc32: int = 0  # ... of the block payload
    input_crc64: int = 0
    output_crc64: int = 0


class QzMetadataBlob:
    """Opaque metadata blob (QzMetadataBlob_T analog)."""

    def __init__(self, data_size: int, hw_buff_sz: int):
        self.data_size = int(data_size)
        self.hw_buff_sz = int(hw_buff_sz)
        n = max(1, (self.data_size + self.hw_buff_sz - 1) // self.hw_buff_sz)
        self.blocks = [_BlockEntry() for _ in range(n)]
        self.valid = 0  # number of populated entries

    @property
    def block_count(self) -> int:
        return len(self.blocks)


def qz_allocate_metadata(data_size: int, hw_buff_sz: int):
    """qzAllocateMetadata analog (reference include/qatzip.h:2229-2231).
    Returns (rc, blob)."""
    if data_size is None or data_size < 0 or not hw_buff_sz or hw_buff_sz <= 0:
        return C.QZ_PARAMS, None
    # block size bounded like the session path (QZ_HW_BUFF_MAX_SZ,
    # reference include/qatzip.h:581-588)
    if hw_buff_sz > C.QZ_HW_BUFF_MAX_SZ:
        return C.QZ_PARAMS, None
    return C.QZ_OK, QzMetadataBlob(data_size, hw_buff_sz)


def qz_free_metadata(metadata) -> int:
    """qzFreeMetadata analog."""
    if metadata is None or not isinstance(metadata, QzMetadataBlob):
        return C.QZ_PARAMS
    metadata.blocks = []
    metadata.valid = 0
    return C.QZ_OK


def _session_crcs(sess: QzSession, data: bytes) -> tuple[int, int]:
    c32 = ck.crc32_configured(data, getattr(sess, "crc32_config", None))
    c64 = ck.crc64(data, getattr(sess, "crc64_config", None))
    return c32, c64


def qz_compress_with_metadata_ext(sess: QzSession, src,
                                  metadata: QzMetadataBlob,
                                  hw_buff_sz_override: int = 0,
                                  comp_thrshold: int = 0) -> OpResult:
    """qzCompressWithMetadataExt analog (include/qatzip.h:1446-1455).

    Compresses ``src`` block-by-block into a frameless payload stream and
    fills ``metadata`` with each block's (offset, size, flags, hash) plus
    session-configured input/output CRC32/CRC64 for the MetadataBlockGetCrc
    readers.  Blocks whose deflate payload reaches ``comp_thrshold`` bytes
    (default: the block's own size — i.e. incompressible) are stored raw.
    """
    from qatzip_tpu_torch.api import _auto_session

    if (not isinstance(sess, QzSession) or src is None
            or not isinstance(metadata, QzMetadataBlob)):
        return OpResult(rc=C.QZ_PARAMS)
    rc = _auto_session(sess)
    if rc < 0:
        return OpResult(rc=rc)
    p = sess.params
    if p.data_fmt not in (DataFormatInternal.DEFLATE_4B,
                          DataFormatInternal.DEFLATE_GZIP,
                          DataFormatInternal.DEFLATE_GZIP_EXT,
                          DataFormatInternal.DEFLATE_RAW,
                          DataFormatInternal.DEFLATE_ZLIB):
        return OpResult(rc=C.QZ_PARAMS)
    src = bytes(src)
    blk_sz = hw_buff_sz_override or metadata.hw_buff_sz
    if blk_sz <= 0 or blk_sz > C.QZ_HW_BUFF_MAX_SZ:
        return OpResult(rc=C.QZ_PARAMS)
    nblocks = max(1, (len(src) + blk_sz - 1) // blk_sz)
    if nblocks > metadata.block_count:
        return OpResult(rc=C.QZ_METADATA_OVERFLOW)

    chunks = ([src[i:i + blk_sz] for i in range(0, len(src), blk_sz)]
              if src else [b""])
    backend, is_sw = core.choose_backend(sess, len(src),
                                         QzDirection.QZ_DIR_COMPRESS)
    try:
        compressed = backend.compress_chunks(chunks, p)
    except Exception as exc:
        if isinstance(exc, NotImplementedError) or (
                not is_sw and not isinstance(exc, faults.FAILOVER)):
            raise
        if not is_sw and C.qz_sw_backup_enabled(p.sw_backup):
            is_sw = True
            compressed = core.engine().cpu_backend.compress_chunks(chunks, p)
        else:
            return OpResult(rc=C.QZ_FAIL)

    out = bytearray()
    res = OpResult()
    if is_sw:
        res.ext_rc |= C.QZ_SW_EXECUTION_MASK
    for i, (chunk, cc) in enumerate(zip(chunks, compressed)):
        ent = metadata.blocks[i]
        limit = comp_thrshold or len(chunk)
        payload = cc.payload
        if len(payload) >= limit and len(chunk) > 0:
            payload = chunk
            ent.flags = QZ_METADATA_BLOCK_STORED
        else:
            ent.flags = QZ_METADATA_BLOCK_DEFLATE
        ent.offset = len(out)
        ent.size = len(payload)
        ent.src_size = len(chunk)
        ent.hash = ck.crc32(chunk)
        ent.input_crc32, ent.input_crc64 = _session_crcs(sess, chunk)
        ent.output_crc32, ent.output_crc64 = _session_crcs(sess, payload)
        out += payload
        res.crc = (ent.hash if i == 0
                   else ck.crc32_combine(res.crc, ent.hash, len(chunk)))
    metadata.valid = len(chunks)
    res.data = bytes(out)
    res.consumed = len(src)
    sess.total_in += len(src)
    sess.total_out += len(out)
    return res


def qz_decompress_with_metadata_ext(sess: QzSession, src,
                                    metadata: QzMetadataBlob,
                                    hw_buff_sz_override: int = 0) -> OpResult:
    """qzDecompressWithMetadataExt analog (include/qatzip.h:1747-1754).

    The metadata index gives every payload's exact span and output size, so
    all deflate blocks decode together in one batch (block-parallel, the
    seq-ordered reassembly of reference src/qatzip.c:1641-1649)."""
    from qatzip_tpu_torch.api import _auto_session

    if (not isinstance(sess, QzSession) or src is None
            or not isinstance(metadata, QzMetadataBlob)
            or metadata.valid == 0):
        return OpResult(rc=C.QZ_PARAMS)
    rc = _auto_session(sess)
    if rc < 0:
        return OpResult(rc=rc)
    p = sess.params
    buf = bytes(src)
    res = OpResult()

    entries = metadata.blocks[: metadata.valid]
    for ent in entries:
        if ent.offset + ent.size > len(buf):
            return OpResult(rc=C.QZ_PARAMS)

    deflate_idx = [i for i, e in enumerate(entries)
                   if e.flags & QZ_METADATA_BLOCK_DEFLATE]
    payloads = [buf[entries[i].offset: entries[i].offset + entries[i].size]
                for i in deflate_idx]
    hints = [entries[i].src_size for i in deflate_idx]
    decoded: dict[int, bytes] = {}
    if payloads:
        backend, is_sw = core.choose_backend(sess, len(buf),
                                             QzDirection.QZ_DIR_DECOMPRESS)
        if is_sw:
            res.ext_rc |= C.QZ_SW_EXECUTION_MASK
        try:
            dcs = backend.decompress_chunks(payloads, hints, p)
        except Exception as exc:
            if not is_sw and isinstance(exc, RefusedStream):
                return OpResult(rc=C.QZ_DATA_ERROR)
            if isinstance(exc, NotImplementedError) or (
                    not is_sw and not isinstance(exc, faults.FAILOVER)):
                raise
            if not is_sw and C.qz_sw_backup_enabled(p.sw_backup):
                res.ext_rc |= C.QZ_SW_EXECUTION_MASK
                dcs = core.engine().cpu_backend.decompress_chunks(
                    payloads, hints, p)
            else:
                return OpResult(rc=C.QZ_DATA_ERROR)
        for i, dc in zip(deflate_idx, dcs):
            decoded[i] = dc.data

    out = bytearray()
    for i, ent in enumerate(entries):
        data = (decoded[i] if i in decoded
                else buf[ent.offset: ent.offset + ent.size])
        if ck.crc32(data) != ent.hash:
            return OpResult(rc=C.QZ_DATA_ERROR)
        res.crc = (ent.hash if i == 0
                   else ck.crc32_combine(res.crc, ent.hash, len(data)))
        out += data
    res.data = bytes(out)
    res.consumed = len(buf)
    sess.total_in += len(buf)
    sess.total_out += len(out)
    return res


def qz_metadata_block_read(block_num: int, metadata: QzMetadataBlob):
    """qzMetadataBlockRead analog (include/qatzip.h:2927-2932).
    Returns (rc, offset, size, flags, hash)."""
    if not isinstance(metadata, QzMetadataBlob):
        return C.QZ_PARAMS, 0, 0, 0, 0
    if block_num < 0 or block_num >= metadata.valid:
        return C.QZ_OUT_OF_RANGE, 0, 0, 0, 0
    e = metadata.blocks[block_num]
    return C.QZ_OK, e.offset, e.size, e.flags, e.hash


def qz_metadata_block_write(block_num: int, metadata: QzMetadataBlob,
                            block_offset: int, block_size: int,
                            block_flags: int, block_hash: int) -> int:
    """qzMetadataBlockWrite analog (include/qatzip.h:2996-3001)."""
    if not isinstance(metadata, QzMetadataBlob):
        return C.QZ_PARAMS
    if block_num < 0 or block_num >= metadata.block_count:
        return C.QZ_OUT_OF_RANGE
    e = metadata.blocks[block_num]
    e.offset, e.size = int(block_offset), int(block_size)
    e.flags, e.hash = int(block_flags), int(block_hash) & 0xFFFFFFFF
    if block_num >= metadata.valid:
        metadata.valid = block_num + 1
    return C.QZ_OK


def qz_metadata_block_get_crc32(block_num: int, metadata: QzMetadataBlob):
    """qzMetadataBlockGetCrc32 analog: (rc, input_crc, output_crc)."""
    if not isinstance(metadata, QzMetadataBlob):
        return C.QZ_PARAMS, 0, 0
    if block_num < 0 or block_num >= metadata.valid:
        return C.QZ_OUT_OF_RANGE, 0, 0
    e = metadata.blocks[block_num]
    return C.QZ_OK, e.input_crc32, e.output_crc32


def qz_metadata_block_get_crc64(block_num: int, metadata: QzMetadataBlob):
    """qzMetadataBlockGetCrc64 analog: (rc, input_crc, output_crc)."""
    if not isinstance(metadata, QzMetadataBlob):
        return C.QZ_PARAMS, 0, 0
    if block_num < 0 or block_num >= metadata.valid:
        return C.QZ_OUT_OF_RANGE, 0, 0
    e = metadata.blocks[block_num]
    return C.QZ_OK, e.input_crc64, e.output_crc64


__all__ = [
    "QzMetadataBlob", "qz_allocate_metadata", "qz_free_metadata",
    "qz_compress_with_metadata_ext", "qz_decompress_with_metadata_ext",
    "qz_metadata_block_read", "qz_metadata_block_write",
    "qz_metadata_block_get_crc32", "qz_metadata_block_get_crc64",
    "QZ_METADATA_BLOCK_STORED", "QZ_METADATA_BLOCK_DEFLATE",
]
