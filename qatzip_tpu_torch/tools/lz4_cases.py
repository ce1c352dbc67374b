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


def _ext(v: int) -> bytes:
    """A length extension of value v."""
    return b"\xff" * (v // 255) + bytes([v % 255])


def match(lit: bytes, off: int, mlen: int) -> bytes:
    """A sequence of literals and an LZ4 match of mlen >= 4 bytes."""
    m = mlen - 4
    return seq(lit, off, min(m, 15), m_ext=_ext(m - 15) if m >= 15 else b"")


def sized_block(size: int, seed: int) -> bytes:
    """A well-formed block of exactly ``size`` bytes (>= 64): random short
    literals and matches (offsets within the output so far), then the
    terminal sequence's literals to fill it."""
    rng = np.random.default_rng(seed)
    out, blk = 0, bytearray()
    while len(blk) < size - 600:
        lit = rng.integers(97, 123, int(rng.integers(1, 20)),
                           np.uint8).tobytes()
        mlen = int(rng.integers(4, 40))
        blk += match(lit, int(rng.integers(1, out + len(lit) + 1)), mlen)
        out += len(lit) + mlen
    rest = size - len(blk)
    lit = rest - 1
    while len(seq(b"x" * lit)) > rest:
        lit -= 1
    blk += seq(b"x" * lit)
    return bytes(blk)


def ring_edge_blocks() -> list:
    """(name, block) cases at the kernel's shared-memory edges, well formed
    as LZ4: output past the 64 KB match window, matches at offset 1 and at
    offset 65535 whose source or output crosses the window's edge (one
    ending exactly at MAX_OUT), and blocks that end exactly at an input
    refill's boundary (1, 2, 3 and 4 KB, the ring's size) or a byte past
    it."""
    rng = np.random.default_rng(13)

    def rand(k: int) -> bytes:
        return rng.integers(0, 256, k, np.uint8).tobytes()

    return [
        # output [65535, 68535) from [0, 3000): the step is one byte wide
        ("offset 65535 across the edge",
         match(rand(65535), 65535, 3000) + match(b"ab", 1, 100)
         + seq(b"z")),
        # output [65530, 65550) at offset 1 across the edge
        ("offset 1 across the edge", match(rand(65530), 1, 20) + seq(b"z")),
        # a run of 65530 at offset 1, then source [65535, 65542) at offset
        # 65535 across the edge; the output ends at 131072
        ("offset 65535 source across the edge, output at MAX_OUT",
         match(rand(65535), 1, 65530) + match(b"", 65535, 7)),
        # 120 KB of output through the window, matches at offsets 1 to
        # 40000 after its first wrap
        ("window wrapped", match(rand(300), 7, 40000)
         + match(rand(40), 40000, 50000) + match(b"q", 1, 30000)
         + seq(rand(100))),
    ] + [(f"{k} bytes", sized_block(k, k))
         for k in (1024, 2048, 3072, 4096, 4097, 1023)]


def sequences(blk: bytes, lz4s: bool = False, base: int = 2) -> list:
    """(lit, litlen, off, mlen) of each sequence of a well-formed LZ4 or
    LZ4s block, in order: the records the kernel queues for it."""
    def ext(p: int) -> tuple:
        value = 0
        while True:
            value += blk[p]
            p += 1
            if blk[p - 1] != 255:
                return value, p

    p, out = 0, []
    while p < len(blk):
        tok = blk[p]
        p += 1
        lit = tok >> 4
        if lit == 15:
            more, p = ext(p)
            lit += more
        start, p = p, p + lit
        if p >= len(blk):
            out.append((start, lit, 0, 0))
            break
        off = blk[p] | blk[p + 1] << 8
        p += 2
        m = tok & 15
        if m == 15:
            more, p = ext(p)
            m += more
        out.append((start, lit, off,
                    (m + base if m else 0) if lz4s else m + 4))
    return out


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
    longest chain of headers the kernel's parse warp walks for it."""
    return len(sequences(blk))


def host_decode(blk: bytes, lz4s: bool, base: int, outcap: int):
    """engine/lz4_block's decoder, the oracle of ``decode_blocks``'s callers;
    None where it refuses the block."""
    try:
        if lz4s:
            return lz4s_block_decompress(blk, outcap, base + 1)
        return lz4_block_decompress(blk, outcap)
    except (ValueError, IndexError):
        return None
