"""The plain reference of the LZ4 frame configurations.

``make`` writes the compressed input of a decompress cell: each chunk one
LZ4 frame of one block by the plain compressor of qzbench/lz4plain.py
(stored where it would not shrink), with the content size and the XXH32
content checksum that the program's LZ4 frames carry.  ``read`` is the
check of a compress cell's output: a plain LZ4 frame and block decoder
that checks every header, block and content checksum and content size.
``control`` is the reference in the program's place with one guarantee
broken, for the test that the check fails it: every frame's content
checksum left out (0), or, for decompress, the last chunk's bytes left
out.
"""
from __future__ import annotations

from qzbench import lz4plain


def _chunks(original: bytes, chunk: int) -> list[bytes]:
    return [original[i:i + chunk] for i in range(0, len(original), chunk)]


def make(original: bytes, chunk: int, device=None) -> bytes:
    return lz4plain.write(_chunks(original, chunk), device)


def read(stream, device=None) -> bytes:
    return lz4plain.read_frames(stream, device)


def control(original: bytes, chunk: int, direction: str,
            device=None) -> bytes:
    parts = _chunks(original, chunk)
    if direction == "decompress":
        return b"".join(parts[:-1])
    blocks = lz4plain.compress_blocks(parts, device)
    return b"".join(lz4plain.frame(c, b, 0) for c, b in zip(parts, blocks))
