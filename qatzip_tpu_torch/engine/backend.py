"""Block-codec backend interface (a copy of qatzip_tpu/engine/backend.py).

The engine splits every request into independent hw_buff_sz chunks (the
reference's request-level parallelism, src/qatzip.c:1505-1594) and hands the
batch to a backend.  Backends:

  * CpuBackend  — zlib / portable LZ4 (the reference's qatzip_sw.c role)
  * GpuBackend  — the port's CUDA kernels (the reference's QAT ASIC role)

A backend works on whole batches so the device path can fuse all chunks of a
request into one device dispatch.
"""
from __future__ import annotations

import abc
from typing import NamedTuple, Sequence

from qatzip_tpu_torch.constants import DataFormatInternal
from qatzip_tpu_torch.session import InternalParams


class CompressedChunk(NamedTuple):
    payload: bytes    # compressed payload (deflate stream / lz4 block bytes)
    checksum: int     # checksum of the uncompressed chunk (crc32/adler32/xxh32)
    consumed: int     # uncompressed bytes consumed


class DecompressedChunk(NamedTuple):
    data: bytes
    checksum: int     # checksum of the decompressed bytes
    end_of_stream: bool = True


class RefusedStream(Exception):
    """A chunk the device failed over that the host decoder then refused:
    corrupt input, which no route decodes."""


class Backend(abc.ABC):
    """A compression engine operating on batches of independent chunks."""

    name = "abstract"
    is_hw = False

    @abc.abstractmethod
    def compress_chunks(self, chunks: Sequence[bytes],
                        params: InternalParams) -> list[CompressedChunk]:
        """Compress each chunk into a standalone payload for params.data_fmt.

        For deflate formats each payload is a complete deflate stream
        (BFINAL set); for LZ4_FH each payload is the block section of one
        frame (block header(s) + block data); for LZ4S_BK each payload is one
        LZ4s block (no header).
        """

    @abc.abstractmethod
    def decompress_chunks(self, payloads: Sequence[bytes],
                          out_size_hints: Sequence[int],
                          params: InternalParams) -> list[DecompressedChunk]:
        """Decompress standalone payloads.  out_size_hints[i] < 0 = unknown."""

    def checksum_kind(self, params: InternalParams) -> str:
        fmt = params.data_fmt
        if fmt == DataFormatInternal.DEFLATE_ZLIB:
            return "adler32"
        if fmt in (DataFormatInternal.LZ4_FH, DataFormatInternal.LZ4S_BK):
            return "xxh32"
        return "crc32"
