"""CPU backend: the permanent software fallback path (a copy of
qatzip_tpu/engine/cpu_backend.py).

Plays the role of qatzip_sw.c in the reference: byte-compatible output
formats produced with host-only code (zlib for deflate, portable LZ4/LZ4s
codecs).  Used when the device is absent, for sub-threshold inputs, for sticky
force-SW mode, and as the mid-request failover target (reference
src/qatzip_sw.c:697-846).
"""
from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence, TypeVar

from qatzip_tpu_torch.constants import DataFormatInternal
from qatzip_tpu_torch.engine import lz4_block
from qatzip_tpu_torch.engine.backend import Backend, CompressedChunk, DecompressedChunk
from qatzip_tpu_torch.session import InternalParams

try:  # native C++ inner loops (qatzip_tpu_torch/native); optional
    from qatzip_tpu_torch.native import qzcore as _native
except Exception:  # pragma: no cover - native build optional
    _native = None


_T = TypeVar("_T")
_pool: ThreadPoolExecutor | None = None
_POOL_MIN_CHUNKS = 4


def _chunk_pool() -> ThreadPoolExecutor:
    """Shared worker pool: the analog of the reference's N SW instances
    serving threads concurrently (README.md:65-66).  zlib and the native
    codecs release the GIL, so chunk-level parallelism scales with cores."""
    global _pool
    if _pool is None:
        n = int(os.environ.get("QATZIP_TPU_SW_THREADS", "0"))
        if n < 1:
            n = max(2, os.cpu_count() or 2)
        _pool = ThreadPoolExecutor(max_workers=n,
                                   thread_name_prefix="qz-sw")
    return _pool


def _map_chunks(fn: Callable[..., _T], *seqs) -> list[_T]:
    if len(seqs[0]) < _POOL_MIN_CHUNKS:
        return [fn(*args) for args in zip(*seqs)]
    return list(_chunk_pool().map(fn, *seqs))


def _checksum(kind: str, data: bytes) -> int:
    if kind == "crc32":
        return zlib.crc32(data) & 0xFFFFFFFF
    if kind == "adler32":
        return zlib.adler32(data) & 0xFFFFFFFF
    if kind == "xxh32":
        from qatzip_tpu_torch.utils import checksum as _ck
        return _ck.xxh32(data, 0)
    raise ValueError(kind)


def _deflate_compress(chunk: bytes, level: int) -> bytes:
    if _native is not None:
        return _native.deflate_compress(chunk, level)
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(chunk) + co.flush(zlib.Z_FINISH)


def _deflate_decompress(payload: bytes, hint: int) -> tuple[bytes, bool]:
    """Inflate one complete raw-deflate stream; returns (data, eof)."""
    if _native is not None:
        max_out = hint if hint and hint > 0 else max(4 * len(payload), 1 << 16)
        try:
            while True:
                try:
                    data, _used, eof = _native.inflate(payload, max_out)
                    return data, eof
                except OverflowError:
                    max_out *= 4  # unknown output size: grow and retry
        except ValueError:
            # native rejects both corrupt and truncated streams; the zlib
            # path below distinguishes (truncation returns partial data with
            # eof False — feeding the engine's partial-consume contract —
            # while corruption raises)
            pass
    do = zlib.decompressobj(-15)
    data = do.decompress(payload) + do.flush()
    return data, do.eof


def _lz4_compress(chunk: bytes) -> bytes:
    if _native is not None:
        return _native.lz4_compress_block(chunk)
    return lz4_block.lz4_block_compress(chunk)


def _lz4_decompress(payload: bytes, max_out: int) -> bytes:
    if _native is not None:
        return _native.lz4_decompress_block(payload, max_out)
    return lz4_block.lz4_block_decompress(payload, max_out)


def _lz4s_compress(chunk: bytes, mini_match: int) -> bytes:
    if _native is not None:
        return _native.lz4s_compress_block(chunk, mini_match)
    return lz4_block.lz4s_block_compress(chunk, mini_match)


class CpuBackend(Backend):
    name = "cpu"
    is_hw = False

    def compress_chunks(self, chunks: Sequence[bytes],
                        params: InternalParams) -> list[CompressedChunk]:
        fmt = params.data_fmt
        kind = self.checksum_kind(params)
        out: list[CompressedChunk] = []
        if fmt in (DataFormatInternal.DEFLATE_4B, DataFormatInternal.DEFLATE_GZIP,
                   DataFormatInternal.DEFLATE_GZIP_EXT, DataFormatInternal.DEFLATE_RAW,
                   DataFormatInternal.DEFLATE_ZLIB):
            level = params.comp_lvl

            def one(chunk: bytes) -> CompressedChunk:
                payload = _deflate_compress(chunk, level)
                return CompressedChunk(payload, _checksum(kind, chunk),
                                       len(chunk))

            out = _map_chunks(one, chunks)
        elif fmt == DataFormatInternal.LZ4_FH:
            from qatzip_tpu_torch.formats.lz4_fmt import gen_lz4_block_header

            def one(chunk: bytes) -> CompressedChunk:
                payload = _lz4_compress(chunk)
                # stored-block escape: never expand beyond the raw chunk
                if len(payload) >= len(chunk):
                    blk = gen_lz4_block_header(len(chunk), stored=True) + chunk
                else:
                    blk = gen_lz4_block_header(len(payload), stored=False) + payload
                return CompressedChunk(blk, _checksum(kind, chunk), len(chunk))

            out = _map_chunks(one, chunks)
        elif fmt == DataFormatInternal.LZ4S_BK:
            def one(chunk: bytes) -> CompressedChunk:
                payload = _lz4s_compress(chunk, params.lz4s_mini_match)
                return CompressedChunk(payload, _checksum(kind, chunk),
                                       len(chunk))

            out = _map_chunks(one, chunks)
        else:
            raise ValueError(f"unsupported format {fmt}")
        return out

    def decompress_chunks(self, payloads: Sequence[bytes],
                          out_size_hints: Sequence[int],
                          params: InternalParams) -> list[DecompressedChunk]:
        fmt = params.data_fmt
        kind = self.checksum_kind(params)
        out: list[DecompressedChunk] = []
        if fmt in (DataFormatInternal.DEFLATE_4B, DataFormatInternal.DEFLATE_GZIP,
                   DataFormatInternal.DEFLATE_GZIP_EXT, DataFormatInternal.DEFLATE_RAW,
                   DataFormatInternal.DEFLATE_ZLIB):
            def one(payload: bytes, hint: int) -> DecompressedChunk:
                data, eof = _deflate_decompress(payload, hint)
                return DecompressedChunk(data, _checksum(kind, data), eof)

            out = _map_chunks(one, payloads, out_size_hints)
        elif fmt == DataFormatInternal.LZ4_FH:
            # each payload: block header + block data (single block per chunk)
            import struct
            from qatzip_tpu_torch.formats.lz4_fmt import (LZ4_BLK_HEADER_SIZE,
                                                    LZ4_STOREDBLOCK_FLAG)

            def one(payload: bytes, hint: int) -> DecompressedChunk:
                pos = 0
                data = bytearray()
                max_out = hint if hint and hint > 0 else 1 << 31
                while pos + LZ4_BLK_HEADER_SIZE <= len(payload):
                    (word,) = struct.unpack_from("<I", payload, pos)
                    pos += LZ4_BLK_HEADER_SIZE
                    if word == 0:
                        break
                    blk_sz = word & 0x7FFFFFFF
                    blk = payload[pos:pos + blk_sz]
                    pos += blk_sz
                    if word & LZ4_STOREDBLOCK_FLAG:
                        data += blk
                    else:
                        data += _lz4_decompress(bytes(blk), max_out - len(data))
                data = bytes(data)
                return DecompressedChunk(data, _checksum(kind, data))

            out = _map_chunks(one, payloads, out_size_hints)
        elif fmt == DataFormatInternal.LZ4S_BK:
            def one(payload: bytes, hint: int) -> DecompressedChunk:
                max_out = hint if hint and hint > 0 else 1 << 31
                data = lz4_block.lz4s_block_decompress(
                    bytes(payload), max_out, params.lz4s_mini_match)
                return DecompressedChunk(data, _checksum(kind, data))

            out = _map_chunks(one, payloads, out_size_hints)
        else:
            raise ValueError(f"unsupported format {fmt}")
        return out
