"""LZ4 / LZ4s blocks at the block decoder's edges, and mutated copies of
good blocks, for holding ``csrc/lz4_block.cu`` (and its host shim) to the
plain version of ``ops/lz4_decode.py``: the CPU tests and chip_smoke.py
take their cases from here."""
from __future__ import annotations

import numpy as np

from qatzip_tpu_torch.engine.lz4_block import (lz4_block_compress,
                                               lz4_block_decompress,
                                               lz4s_block_decompress)

OVERLAP_EXT = 0x50   # the overlap cases' match-length extension byte


def seq(lit: bytes, off: int | None = None, mcode: int = 0,
        lit_ext: bytes = b"", m_ext: bytes = b"") -> bytes:
    """One sequence: its token's literal code (15 with ``lit_ext``, which
    15 literals or more get by default) and match code, literals, offset
    and match-length extension; no offset makes it the terminal one."""
    if len(lit) >= 15 and not lit_ext:
        rest = len(lit) - 15
        lit_ext = b"\xff" * (rest // 255) + bytes([rest % 255])
    lcode = 15 if lit_ext else len(lit)
    out = bytes([lcode << 4 | mcode]) + lit_ext + lit
    return out if off is None else out + off.to_bytes(2, "little") + m_ext


def overlap_literals(off: int) -> bytes:
    return bytes(range(65, 65 + off))


def edge_blocks() -> list:
    """(name, block) cases of the decoder's edges, the same bytes read as
    LZ4 and as LZ4s: zero offsets, offsets before the start, 0xFF runs at
    the cap and one below, zero-length matches, blocks that end after a
    match or are cut short, and overlapping matches at offsets 1-31."""
    ff = b"\xff"
    cases = [
        ("good", b"\x54abcde\x05\x00\x50XYZWQ"),
        ("zero offset", b"\x54abcde\x00\x00\x50XYZWQ"),
        ("offset before start", b"\x14a\x05\x00"),
        ("60000-byte run", lz4_block_compress(b"A" * 60000)),
        ("match run 511", seq(b"a", 1, 15, m_ext=ff * 511 + b"\x07")
         + seq(b"z")),
        ("match run 512", seq(b"a", 1, 15, m_ext=ff * 512 + b"\x07")
         + seq(b"z")),
        ("literal run 512", seq(b"", lit_ext=ff * 512 + b"\x03") + b"x" * 64),
        ("literal run 2", seq(b"q" * 528, 1, 2, lit_ext=ff * 2 + b"\x03")
         + seq(b"z")),
        ("zero-length match, offset 0", seq(b"ab", 0, 0) + seq(b"z")),
        ("zero-length match, offset 0, last", seq(b"ab", 0, 0)),
        ("zero-length match, far offset", seq(b"ab", 65535, 0) + seq(b"z")),
        ("zero-length sequence", seq(b"abc", 1, 0) + seq(b"", 1, 0)
         + seq(b"", 3, 1) + seq(b"z")),
        ("ends after a match", seq(b"abcd", 4, 0)),
        ("ends after a long match", seq(b"abcd", 3, 15, m_ext=b"\x40")),
        ("truncated offset", seq(b"abcd", 4, 0)[:-1]),
        ("truncated match length", seq(b"abcd", 3, 15, m_ext=ff * 3)),
        ("truncated literals", seq(b"abcdefgh")[:-2]),
        ("literals past the end", b"\x90abc"),
        ("empty", b""),
    ]
    for off in range(1, 32):
        cases.append((f"overlap {off}",
                      seq(overlap_literals(off), off, 15,
                          m_ext=bytes([OVERLAP_EXT])) + seq(b"z")))
    return cases


def mutate(blk: bytes, muts) -> bytes:
    """Mutations (kind, at, v) applied in turn: kind 0 flips the byte at
    ``at`` by v, 1 cuts the block there (keeping a byte), 2 zeroes 1-24
    bytes from there, 3 splices a window of 4-63 bytes of the block over
    it; ``at`` is taken modulo the block's length."""
    buf = bytearray(blk)
    for kind, at, v in muts:
        at %= max(len(buf), 1)
        if kind == 0:
            buf[at] ^= v
        elif kind == 1:
            del buf[max(at, 1):]
        elif kind == 2:
            buf[at:at + v % 24 + 1] = bytes(len(buf[at:at + v % 24 + 1]))
        else:
            src = (at * 7 + v) % max(len(buf), 1)
            win = buf[src:src + v % 60 + 4]
            buf[at:at + len(win)] = win
    return bytes(buf)


def random_mutations(rng: np.random.Generator) -> list:
    """1-3 mutations for :func:`mutate`, drawn from ``rng``."""
    return [(int(rng.integers(0, 4)), int(rng.integers(0, 1 << 16)),
             int(rng.integers(1, 256)))
            for _ in range(int(rng.integers(1, 4)))]


def count_sequences(blk: bytes) -> int:
    """The sequences of a well-formed LZ4 or LZ4s block (one grammar), the
    steps a warp of the kernel walks for it."""
    def ext(p: int) -> tuple:
        value = 0
        while True:
            value += blk[p]
            p += 1
            if blk[p - 1] != 255:
                return value, p

    p, n = 0, 0
    while p < len(blk):
        tok = blk[p]
        p += 1
        n += 1
        lit = tok >> 4
        if lit == 15:
            more, p = ext(p)
            lit += more
        p += lit
        if p >= len(blk):
            break
        p += 2
        if tok & 15 == 15:
            p = ext(p)[1]
    return n


def host_decode(blk: bytes, lz4s: bool, base: int, outcap: int):
    """engine/lz4_block's decoder, the oracle of ``decode_blocks``'s callers;
    None where it refuses the block."""
    try:
        if lz4s:
            return lz4s_block_decompress(blk, outcap, base + 1)
        return lz4_block_decompress(blk, outcap)
    except (ValueError, IndexError):
        return None
