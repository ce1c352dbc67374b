"""LZ4 and LZ4s block codecs — portable reference implementation (a copy
of qatzip_tpu/engine/lz4_block.py).

The LZ4 block format follows the public spec (token = (litlen<<4)|matchlen,
15 escapes to extended length bytes, 2-byte LE offsets, min match 4, last 5
bytes are literals, no match may start within 12 bytes of the end).

The LZ4s variant is the QAT sequence format consumed by the zstd
post-processing hook (reference utils/qzstd.c:118-181): min match is 3 or 4,
the token's match-length field stores ``matchlen - (mini_match - 1)`` so 0
means "no match", every non-terminal sequence carries the 2-byte offset even
when the match length is zero, and the terminal sequence is literals-only.

This module is the correctness oracle and CPU fallback; the native C++
extension (qatzip_tpu_torch/native) and the device decoder
(qatzip_tpu_torch/ops/lz4_decode.py) implement the same contracts.
"""
from __future__ import annotations

MINMATCH = 4
MFLIMIT = 12      # no match may start within this many bytes of the end
LASTLITERALS = 5  # last bytes are always literals
MAX_DISTANCE = 65535

_HASH_LOG = 14


def _hash32(v: int) -> int:
    return ((v * 2654435761) & 0xFFFFFFFF) >> (32 - _HASH_LOG)


def _write_length(out: bytearray, length: int) -> None:
    while length >= 255:
        out.append(255)
        length -= 255
    out.append(length)


def lz4_block_compress(data: bytes, acceleration: int = 1) -> bytes:
    """Greedy single-probe LZ4 block compression (level-1 style).

    Produces a valid LZ4 block decodable by any conforming decoder.
    """
    src = bytes(data)
    n = len(src)
    out = bytearray()
    if n == 0:
        return bytes(out)
    if n < MFLIMIT + 1:
        # Too small for any match: all literals.
        _emit_sequence(out, src, 0, n, 0, 0)
        return bytes(out)

    table = {}
    anchor = 0
    pos = 0
    match_limit = n - LASTLITERALS
    mf_limit = n - MFLIMIT
    step = max(1, acceleration)

    while pos <= mf_limit:
        seq = int.from_bytes(src[pos:pos + 4], "little")
        h = _hash32(seq)
        cand = table.get(h, -1)
        table[h] = pos
        if (cand >= 0 and pos - cand <= MAX_DISTANCE
                and src[cand:cand + 4] == src[pos:pos + 4]):
            # extend match forward
            mlen = 4
            while (pos + mlen < match_limit
                   and src[cand + mlen] == src[pos + mlen]):
                mlen += 1
            _emit_sequence(out, src, anchor, pos - anchor, pos - cand, mlen)
            pos += mlen
            anchor = pos
        else:
            pos += step

    # trailing literals
    _emit_sequence(out, src, anchor, n - anchor, 0, 0)
    return bytes(out)


def _emit_sequence(out: bytearray, src: bytes, lit_start: int, lit_len: int,
                   offset: int, match_len: int) -> None:
    """Emit one LZ4 sequence; match_len==0 means terminal literal-only run."""
    ml_code = 0 if match_len == 0 else match_len - MINMATCH
    token_lit = 15 if lit_len >= 15 else lit_len
    token_ml = 15 if ml_code >= 15 else ml_code
    if match_len == 0:
        out.append(token_lit << 4)
        if lit_len >= 15:
            _write_length(out, lit_len - 15)
        out += src[lit_start:lit_start + lit_len]
        return
    out.append((token_lit << 4) | token_ml)
    if lit_len >= 15:
        _write_length(out, lit_len - 15)
    out += src[lit_start:lit_start + lit_len]
    out += offset.to_bytes(2, "little")
    if ml_code >= 15:
        _write_length(out, ml_code - 15)


def lz4_block_decompress(block: bytes, max_out: int,
                         prefix: bytes = b"") -> bytes:
    """Decode one LZ4 block.  Raises ValueError on malformed input.

    ``prefix`` is preceding-frame history for linked-block frames
    (FLG block-indep=0): match offsets may reach up to 64KB back into
    it.  The returned bytes are this block's output only; the prefix is
    read in place (no copies — blocks from independent encoders, like
    this library's own, never reference it)."""
    src = bytes(block)
    n = len(src)
    plen = len(prefix)
    out = bytearray()
    ip = 0
    while ip < n:
        token = src[ip]
        ip += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if ip >= n:
                    raise ValueError("truncated literal length")
                b = src[ip]
                ip += 1
                lit_len += b
                if b != 255:
                    break
        if ip + lit_len > n:
            raise ValueError("truncated literals")
        out += src[ip:ip + lit_len]
        ip += lit_len
        if ip >= n:
            break  # terminal literal-only sequence
        if ip + 2 > n:
            raise ValueError("truncated offset")
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if offset == 0:
            raise ValueError("zero offset")
        mlen = token & 0x0F
        if mlen == 15:
            while True:
                if ip >= n:
                    raise ValueError("truncated match length")
                b = src[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        mlen += MINMATCH
        start = len(out) - offset
        if start < -plen:
            raise ValueError("offset beyond output start")
        for k in range(mlen):  # byte-by-byte: overlapping copies are legal
            p = start + k
            out.append(out[p] if p >= 0 else prefix[plen + p])
        if len(out) > max_out:
            raise ValueError("output exceeds max_out")
    return bytes(out)


# ---------------------------------------------------------------------------
# LZ4s (QAT sequence format)
# ---------------------------------------------------------------------------

def lz4s_block_compress(data: bytes, mini_match: int = 3) -> bytes:
    """Greedy LZ4s sequence encoding with min match 3 or 4.

    Token ML field stores matchlen - (mini_match - 1) (reference
    utils/qzstd.c:57,322-325: LZ4MINMATCH = mini_match == 4 ? 3 : 2).
    """
    if mini_match not in (3, 4):
        raise ValueError("mini_match must be 3 or 4")
    base = mini_match - 1
    src = bytes(data)
    n = len(src)
    out = bytearray()
    if n == 0:
        return bytes(out)
    if n < MFLIMIT + 1:
        _emit_lz4s_sequence(out, src, 0, n, 0, 0, base)
        return bytes(out)

    table = {}
    anchor = 0
    pos = 0
    match_limit = n - LASTLITERALS
    mf_limit = n - MFLIMIT

    while pos <= mf_limit:
        seq = int.from_bytes(src[pos:pos + 4], "little")
        h = _hash32(seq)
        cand = table.get(h, -1)
        table[h] = pos
        if (cand >= 0 and pos - cand <= MAX_DISTANCE
                and src[cand:cand + 4] == src[pos:pos + 4]):
            mlen = 4
            while (pos + mlen < match_limit
                   and src[cand + mlen] == src[pos + mlen]):
                mlen += 1
            _emit_lz4s_sequence(out, src, anchor, pos - anchor, pos - cand,
                                mlen, base)
            pos += mlen
            anchor = pos
        else:
            pos += 1

    _emit_lz4s_sequence(out, src, anchor, n - anchor, 0, 0, base)
    return bytes(out)


def _emit_lz4s_sequence(out: bytearray, src: bytes, lit_start: int,
                        lit_len: int, offset: int, match_len: int,
                        base: int) -> None:
    ml_code = 0 if match_len == 0 else match_len - base
    token_lit = 15 if lit_len >= 15 else lit_len
    token_ml = 15 if ml_code >= 15 else ml_code
    if match_len == 0 and offset == 0:
        # terminal literal-only sequence: token + literals, no offset
        out.append(token_lit << 4)
        if lit_len >= 15:
            _write_length(out, lit_len - 15)
        out += src[lit_start:lit_start + lit_len]
        return
    out.append((token_lit << 4) | token_ml)
    if lit_len >= 15:
        _write_length(out, lit_len - 15)
    out += src[lit_start:lit_start + lit_len]
    out += offset.to_bytes(2, "little")
    if ml_code >= 15:
        _write_length(out, ml_code - 15)


def lz4s_decode_sequences(block: bytes, mini_match: int = 3):
    """Decode an LZ4s block into (lit_len, offset, match_len) triples.

    Direct analog of decLz4Block (reference utils/qzstd.c:118-181).  Also
    returns the literal byte ranges so callers can reconstruct data.
    """
    base = mini_match - 1
    src = bytes(block)
    n = len(src)
    ip = 0
    seqs = []   # (lit_start, lit_len, offset, match_len)
    while ip < n:
        token = src[ip]
        ip += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[ip]
                ip += 1
                lit_len += b
                if b != 255:
                    break
        lit_start = ip
        ip += lit_len
        if ip > n:
            raise ValueError("truncated lz4s literals")
        if ip == n:
            seqs.append((lit_start, lit_len, 0, 0))
            break
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        mlen = token & 0x0F
        if mlen == 15:
            while True:
                b = src[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        if mlen != 0:
            mlen += base
        seqs.append((lit_start, lit_len, offset, mlen))
    return seqs


def lz4s_block_decompress(block: bytes, max_out: int,
                          mini_match: int = 3) -> bytes:
    """Reconstruct raw data from an LZ4s block."""
    src = bytes(block)
    out = bytearray()
    for lit_start, lit_len, offset, mlen in lz4s_decode_sequences(src, mini_match):
        out += src[lit_start:lit_start + lit_len]
        if mlen:
            start = len(out) - offset
            if start < 0:
                raise ValueError("lz4s offset beyond output start")
            for k in range(mlen):
                out.append(out[start + k])
        if len(out) > max_out:
            raise ValueError("lz4s output exceeds max_out")
    return bytes(out)
