"""The native header parse (``qz_inflate_headers``, native/qzheaders.cpp)
against the reference's ``_parse_one_header`` / ``parse_dynamic_header``
(qatzip_tpu/ops/deflate_decode.py).

At every header, the port's parse must give the reference's kind, BFINAL,
code-length rows, end bit and stored bytes where the reference succeeds,
and the exception the reference raises (type and message) where it
rejects.  The headers: every block of zlib streams of the corpus's
segments at levels 1, 6 and 9 under each strategy, and at level 0 (stored
blocks); each of a set of headers cut at every byte and bit-flipped by a
seeded fuzz; and headers built here, for the rejects and the edges of the
code-length code.  Canonical codes never give two symbols one (length,
code), so the reference's dict never has two keys to choose between: the
over-subscribed cases are codes whose later symbols fall past their
length's space, and are unreachable.

``walk_blocks`` finds every block of a stream by the reference's parse,
reading each Huffman block's symbols to its end here; other tests count
blocks with it.  Then ``inflate_batch`` on the CPU device, with every
Python bit reader of the port gone.
"""
import threading
import zlib

import numpy as np
import pytest
import torch

from qatzip_tpu.ops import deflate_decode as rdd
from qatzip_tpu.ops import deflate_tables as RT
from qatzip_tpu_torch.native import qzcore
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.tools.corpus import build_corpus

torch.set_num_threads(1)

CPU = torch.device("cpu")
SEG = 256 << 10
STRATEGIES = {"default": zlib.Z_DEFAULT_STRATEGY, "fixed": zlib.Z_FIXED,
              "huffman_only": zlib.Z_HUFFMAN_ONLY, "rle": zlib.Z_RLE}


def _raw(data: bytes, level: int, strategy: int = zlib.Z_DEFAULT_STRATEGY,
         mem_level: int = 8) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, mem_level, strategy)
    return co.compress(data) + co.flush()


@pytest.fixture(scope="module")
def segments():
    """16 KB of each of the corpus's nine segment classes."""
    corpus = build_corpus(3)[:9 * SEG]
    return [corpus[i * SEG:i * SEG + (16 << 10)] for i in range(9)]


# ---------------------------------------------------------------------------
# The reference's walk over a stream's blocks
# ---------------------------------------------------------------------------
def _decoder(lens):
    codes = RT.canonical_codes(np.asarray(lens, np.int32))
    return {(int(l), int(c)): s for s, (l, c) in enumerate(zip(lens, codes))
            if l}


def _symbol(table, bits, pos):
    code = n = 0
    while (n, code) not in table:
        if n == 15:
            raise ValueError("no symbol in 15 bits")
        code = (code << 1) | bits[pos]
        pos += 1
        n += 1
    return table[(n, code)], pos


def _skip_block(bits, pos, ll, d) -> int:
    """The bit after a Huffman block's end-of-block symbol."""
    dll, ddist = _decoder(ll), _decoder(d)
    while True:
        sym, pos = _symbol(dll, bits, pos)
        if sym == 256:
            return pos
        if sym > 256:
            pos += RT._LENGTH_EXTRA[sym - 257]
            dsym, pos = _symbol(ddist, bits, pos)
            pos += RT._DIST_EXTRA[dsym]


def walk_blocks(payload: bytes) -> list:
    """Every block of a raw deflate stream, in order: (its header's first
    bit, 'stored', 'static' or 'dynamic'), each header parsed by the
    reference's ``_parse_one_header``."""
    s = rdd._Stream(payload, 0, 0)
    bits = np.unpackbits(np.frombuffer(payload, np.uint8),
                         bitorder="little").tolist()
    out = []
    while True:
        start = s.bits.pos
        if rdd._parse_one_header(s) == "huff":
            out.append((start, "static" if s._lens is None else "dynamic"))
            ll, d = ((RT.STATIC_LITLEN_LEN, RT.STATIC_DIST_LEN)
                     if s._lens is None else s._lens)
            s.bits.pos = _skip_block(bits, s.bits.pos, ll, d)
        else:
            out.append((start, "stored"))
        if s.final_block:
            return out


# ---------------------------------------------------------------------------
# Both parses at a header
# ---------------------------------------------------------------------------
def _outcome(s, kind):
    """A parse's result, comparable across the two packages."""
    if isinstance(kind, (EOFError, ValueError)):
        return type(kind), str(kind)
    lens = None
    if kind == "huff" and s._lens is not None:
        assert all(a.dtype == np.int32 for a in s._lens)
        lens = tuple(a.tolist() for a in s._lens)
    out = bytes(s.out) if isinstance(s, rdd._Stream) else s.output()
    return kind, s.final_block, s.done, lens, s.bits.pos, out


def _reference(lanes):
    got = []
    for payload, pos in lanes:
        s = rdd._Stream(payload, 0, 0)
        s.bits.pos = pos
        try:
            kind = rdd._parse_one_header(s)
        except (EOFError, ValueError) as exc:
            kind = exc
        got.append(_outcome(s, kind))
    return got


def _port(lanes):
    """The port's parse over every lane in one call."""
    streams = []
    for i, (payload, pos) in enumerate(lanes):
        s = dd._Stream(payload, 0, i)
        s.bits.pos = pos
        streams.append(s)
    kinds = dd._parse_headers(streams)
    return [_outcome(s, k) for s, k in zip(streams, kinds)]


def _assert_same(lanes):
    assert _port(lanes) == _reference(lanes)


def _corpus_lanes(segments, level, strategy):
    lanes = []
    for seg in segments:
        for mem_level in (1, 8):   # 1: a block every 128 symbols
            payload = _raw(seg, level, strategy, mem_level)
            lanes += [(payload, pos) for pos, _ in walk_blocks(payload)]
    return lanes


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("level", [1, 6, 9])
def test_corpus_headers_same_both_ways(segments, level, strategy):
    lanes = _corpus_lanes(segments, level, STRATEGIES[strategy])
    assert len(lanes) >= 100   # memLevel 1 cuts many blocks
    _assert_same(lanes)


def test_stored_headers_same_both_ways(segments):
    """Level 0: stored blocks of up to 65535 bytes, several a stream, and
    an empty one."""
    lanes = []
    for seg in segments[:3] + [segments[3] * 6, b""]:
        payload = _raw(seg, 0)
        blocks = walk_blocks(payload)
        assert {k for _, k in blocks} == {"stored"}
        lanes += [(payload, pos) for pos, _ in blocks]
    assert len(lanes) >= 7
    _assert_same(lanes)


def _sample_headers(segments):
    """(payload, first bit, end bit) of a few headers of each kind: the
    first dynamic blocks at levels 1 and 9, a later one, a static block and
    stored blocks."""
    out = []
    for payload in (_raw(segments[0], 1), _raw(segments[4], 9),
                    _raw(segments[7], 6, mem_level=1),
                    _raw(segments[2][:64], 9, zlib.Z_FIXED),
                    _raw(segments[5][:300], 0),
                    _raw(segments[1], 1, zlib.Z_HUFFMAN_ONLY, 1)):
        blocks = walk_blocks(payload)
        for pos, _ in blocks[:1] + blocks[len(blocks) // 2:][:1]:
            s = rdd._Stream(payload, 0, 0)
            s.bits.pos = pos
            rdd._parse_one_header(s)
            out.append((payload, pos, s.bits.pos))
    return out


def test_headers_cut_at_each_byte(segments):
    """Each header cut at every byte from its first to the one past its
    end: the reference's EOFError up to the last, then its parse."""
    lanes = []
    for payload, pos, end in _sample_headers(segments):
        for cut in range(pos >> 3, min(len(payload), (end + 7) >> 3) + 1):
            lanes.append((payload[:cut], pos))
    assert len(lanes) >= 300
    _assert_same(lanes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_headers_bit_flips(segments, seed):
    """One to three bits flipped inside each header."""
    rng = np.random.default_rng(seed)
    lanes = []
    for payload, pos, end in _sample_headers(segments):
        for _ in range(60):
            v = bytearray(payload)
            for b in rng.integers(pos, end, int(rng.integers(1, 4))):
                v[b >> 3] ^= 1 << (b & 7)
            lanes.append((bytes(v), pos))
    got = _port(lanes)
    assert got == _reference(lanes)
    assert sum(isinstance(g[0], type) for g in got) >= 20   # rejects
    assert sum(g[0] == "huff" for g in got) >= 20


# ---------------------------------------------------------------------------
# Headers built here
# ---------------------------------------------------------------------------
_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
_EXTRA = {16: 2, 17: 3, 18: 7}


class _Writer:
    """LSB-first bit writer; Huffman codes go MSB first (RFC1951 3.1.1)."""

    def __init__(self):
        self.bits = []

    def put(self, v: int, n: int) -> "_Writer":
        self.bits += [(v >> i) & 1 for i in range(n)]
        return self

    def code(self, c: int, n: int) -> "_Writer":
        self.bits += [(c >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def tobytes(self) -> bytes:
        b = self.bits + [0] * (-len(self.bits) % 8)
        return np.packbits(np.array(b, np.uint8), bitorder="little").tobytes()


def _dynamic(cl, syms, hlit=257, hdist=1, tail=8, hclen=None):
    """A final BTYPE=10 header: the code-length code lengths ``cl`` (a
    dict by symbol), then ``syms``, each a symbol with its extra value
    coded by ``cl``'s canonical code, or a str of raw code bits; then
    ``tail`` zero bytes."""
    lens = np.zeros(19, np.int32)
    for s, l in cl.items():
        lens[s] = l
    hclen = hclen or max(4, max(_ORDER.index(s) for s in cl) + 1)
    w = _Writer().put(1, 1).put(2, 2).put(hlit - 257, 5).put(hdist - 1, 5)
    w.put(hclen - 4, 4)
    for i in range(hclen):
        w.put(int(lens[_ORDER[i]]), 3)
    codes = RT.canonical_codes(lens)
    for item in syms:
        if isinstance(item, str):
            w.bits += [int(c) for c in item]
            continue
        sym, extra = item
        w.code(int(codes[sym]), int(lens[sym]))
        if sym in _EXTRA:
            w.put(extra, _EXTRA[sym])
    return w.tobytes() + bytes(tail)


# a complete code-length code: 8 '0', 0 '10', 16 '110', 18 '111'
_CL = {8: 1, 0: 2, 16: 3, 18: 3}


def _built():
    """(name, payload) of each built case."""
    good = _dynamic(_CL, [(18, 127), (18, 108), (8, 0)])        # 258 lengths
    return [
        ("exact", good),
        ("exact_cut", good[:-9]),
        ("repeat_to_the_end", _dynamic(_CL, [(18, 127), (18, 105), (8, 0),
                                             (16, 0)])),
        ("widest_row", _dynamic({17: 2, 18: 2, 8: 2, 0: 2},
                                [(18, 127), (18, 127), (18, 33)],
                                hlit=288, hdist=32)),
        ("no_previous", _dynamic(_CL, [(16, 1)])),
        ("overrun", _dynamic(_CL, [(18, 127), (18, 127)])),
        ("repeat_past_the_end", _dynamic(_CL, [(18, 127), (18, 107), (8, 0),
                                               (16, 3)])),
        ("zeros_past_the_end", _dynamic({17: 1, 18: 1},
                                        [(18, 127), (18, 108), (17, 7)])),
        ("incomplete", _dynamic({8: 1}, ["0" * 258])),
        ("incomplete_miss", _dynamic({8: 1}, ["0" * 5 + "1"])),
        ("incomplete_miss_short", _dynamic({8: 1}, ["0" * 5 + "1"],
                                           tail=0)),
        ("incomplete_miss_mid", _dynamic({8: 1}, ["0" * 5 + "1"], tail=1)),
        ("oversubscribed", _dynamic({s: 1 for s in range(19)},
                                    ["01" * 129], hclen=19)),
        ("oversubscribed_across", _dynamic({0: 1, 1: 1, 2: 2, 16: 2},
                                           ["10" * 129])),
        ("no_code", _dynamic({}, [], hclen=4)),
        ("hclen_cut", _Writer().put(1, 1).put(2, 2).put(0, 10).put(15, 4)
         .put(5, 3 * 10).tobytes()),
        ("btype3", bytes([0b111, 0])),
        ("btype3_nonfinal", bytes([0b110])),
        ("static", bytes([0b011, 0])),
        ("stored", b"\x00\x03\x00\xfc\xffabc\x03\x00"),
        ("stored_final_empty", b"\x01\x00\x00\xff\xff"),
        ("stored_mismatch", b"\x01\x05\x00\x00\x00hello"),
        ("stored_short", b"\x01\x05\x00\xfa"),
        ("stored_data_short", b"\x01\x05\x00\xfa\xffhell"),
        ("empty", b""),
    ]


def _built_lanes():
    """(name, payload, bit position): each built case at bit 0, a stored
    one at bit 1 too (aligned to the same byte), and a header at each bit
    of a byte's last three."""
    lanes = []
    for name, payload in _built():
        for pos in (0, 1) if name.startswith("stored") else (0,):
            lanes.append((name, payload, pos))
    lanes += [(f"bfinal_at_{pos}", b"\x01", pos) for pos in (5, 6, 7, 8)]
    return lanes


def test_built_headers_same_both_ways():
    lanes = _built_lanes()
    got = _port([(p, pos) for _, p, pos in lanes])
    want = _reference([(p, pos) for _, p, pos in lanes])
    assert got == want
    outcome = {(name, pos): w for (name, _, pos), w in zip(lanes, want)}
    rejects = {name for (name, pos), w in outcome.items()
               if isinstance(w[0], type) and pos == 0}
    assert rejects == {"exact_cut", "no_previous", "overrun",
                       "repeat_past_the_end", "zeros_past_the_end",
                       "incomplete_miss", "incomplete_miss_short",
                       "incomplete_miss_mid", "no_code",
                       "hclen_cut", "btype3", "btype3_nonfinal",
                       "stored_mismatch", "stored_short", "stored_data_short",
                       "empty"}
    assert [outcome[(f"bfinal_at_{p}", p)][0] for p in (5, 6, 7, 8)] == \
        [EOFError] * 4
    assert outcome[("incomplete_miss", 0)] == (ValueError,
                                               "bad code-length code")
    assert outcome[("incomplete_miss_short", 0)][0] is EOFError
    assert outcome[("incomplete_miss_mid", 0)][0] is EOFError   # 16 bits
    assert outcome[("widest_row", 0)][3] == ([0] * 288, [0] * 32)
    assert outcome[("oversubscribed", 0)][3][0][:2] == [0, 1]


def test_one_call_over_mixed_lanes(segments):
    """Every kind of lane above, shuffled into one call: each lane gets its
    own result."""
    lanes = [(p, pos) for _, p, pos in _built_lanes()]
    lanes += _corpus_lanes(segments[:2], 6, zlib.Z_DEFAULT_STRATEGY)
    lanes += [(p[:cut], pos) for p, pos, end in _sample_headers(segments)
              for cut in range(pos >> 3, (end + 7) >> 3, 7)]
    order = np.random.default_rng(7).permutation(len(lanes))
    lanes = [lanes[i] for i in order]
    _assert_same(lanes)


def test_one_lane_raises_what_the_reference_raises():
    """``_parse_one_header`` keeps the reference's signature: a kind, or
    the reference's exception raised."""
    for name, payload in _built():
        s = dd._Stream(payload, 0, 0)
        r = rdd._Stream(payload, 0, 0)
        try:
            want = rdd._parse_one_header(r)
        except (EOFError, ValueError) as exc:
            with pytest.raises(type(exc), match=str(exc)):
                dd._parse_one_header(s)
            continue
        assert _outcome(s, dd._parse_one_header(s)) == _outcome(r, want), name


def test_threads_parse_at_once(segments):
    """Four threads in the parse at once, outside the interpreter lock,
    each get the reference's results."""
    lanes = [(p, pos) for _, p, pos in _built_lanes()]
    lanes += _corpus_lanes(segments[:3], 1, zlib.Z_DEFAULT_STRATEGY)
    want = _reference(lanes)
    errors = []

    def work():
        try:
            for _ in range(20):
                assert _port(lanes) == want
        except AssertionError as exc:   # reported by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors


def test_bad_arrays_refused():
    for payloads, pos in (([b"\x03"], np.zeros(1, np.int32)),
                          ([b"\x03"], np.zeros(2, np.int64)),
                          ([bytearray(b"\x03")], np.zeros(1, np.int64))):
        with pytest.raises(ValueError):
            qzcore.inflate_headers(payloads, pos)


# ---------------------------------------------------------------------------
# inflate_batch without a Python bit reader
# ---------------------------------------------------------------------------
def test_inflate_batch_reads_no_bit_in_python(segments, monkeypatch):
    """The port keeps no Python bit reader or header parser, and the batch
    path does not call the one-lane parse: zlib's bytes, end flags and
    checksums on zlib-L1 and level-0 streams, and the streams whose
    header the reference rejects failed over."""
    assert not hasattr(dd._Bits, "read")
    assert not hasattr(dd, "parse_dynamic_header")

    def refused(s):
        raise AssertionError("inflate_batch parsed a header alone")

    monkeypatch.setattr(dd, "_parse_one_header", refused)
    datas = [segments[0][:6000], segments[3][:3000], segments[6][:2000],
             segments[1][:3500], segments[8][:4000]]
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    flushed = (co.compress(datas[4][:1500]) + co.flush(zlib.Z_FULL_FLUSH)
               + co.compress(datas[4][1500:]) + co.flush())
    payloads = [_raw(datas[0], 1), _raw(datas[1], 1), _raw(datas[2], 0),
                _raw(datas[3], 1, mem_level=1), flushed]
    assert "stored" in {k for _, k in walk_blocks(flushed)}
    good = _raw(segments[2][:4000], 1)
    s = rdd._Stream(good, 0, 0)
    rdd._parse_one_header(s)
    rng = np.random.default_rng(11)
    bad = [bytes([0b111]) + good[1:], good[:20], b"\x01\x05\x00\x00\x00hello"]
    while len(bad) < 6:   # a bit flip in the header that the reference rejects
        v = bytearray(good)
        b = int(rng.integers(3, s.bits.pos))
        v[b >> 3] ^= 1 << (b & 7)
        if isinstance(_reference([(bytes(v), 0)])[0][0], type):
            bad.append(bytes(v))
    for kind, ck in (("crc32", zlib.crc32), ("adler32", zlib.adler32)):
        f0 = dd.failover_lanes
        res = dd.inflate_batch(payloads + bad,
                               [len(d) for d in datas] + [4000] * len(bad),
                               CPU, kind=kind)
        assert res[:len(datas)] == [(d, True, ck(d)) for d in datas]
        assert res[len(datas):] == [None] * len(bad)
        assert dd.failover_lanes - f0 == len(bad)
