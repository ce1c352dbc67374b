"""The native region builder (``qz_inflate_regions``, native/qzregions.cpp)
against the reference's numpy builders (qatzip_tpu/ops/pallas_inflate.py,
at the 9-bit roots the port's layout shares).

Every length set must give the same region bytes as the reference's
``build_ll_region`` / ``build_d_region``, or the same reject: the status's
message is the ValueError the numpy builder raises.  The sets: the corpus's dynamic
blocks at levels 1, 6 and 9, the static lengths, and a seeded fuzz.  A
root/sub collision cannot be built: the over-subscription test rejects
every code that is not prefix-free first, and a prefix-free code never
puts a short code on a long one's root slot.  A subtable overflow needs
more long codes than a stream's 288 symbols (at most about 400 of the 512
sub entries), so its cases, and those that fill the area to its last
entry, are wider sets, which both builders take.

Then ``pack_round``, whose rows must be the reference builders', and
``inflate_batch``: zlib's bytes and checksums, and the ``inflate.tables``
and ``inflate.parse`` spans' counts of the regions built and the Huffman
blocks, against the blocks the reference's parse walks.
"""
import threading
import zlib

import numpy as np
import pytest
import torch

from qatzip_tpu.ops import pallas_inflate as RPI
from qatzip_tpu_torch import api as qt
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.native import qzcore
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.ops import deflate_tables as T
from qatzip_tpu_torch.ops import inflate as PI
from qatzip_tpu_torch.tools.corpus import build_corpus
from tests.test_torch_headers_native import walk_blocks

torch.set_num_threads(1)

CPU = torch.device("cpu")
CHUNK = 64 << 10


def _raw(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


@pytest.fixture(scope="module")
def corpus():
    return build_corpus(3)[:9 * (256 << 10)]   # each segment class once


def _numpy(ll, d):
    """(tll, td) bytes from the reference's numpy builders, or their
    ValueError."""
    try:
        return (RPI.build_ll_region(ll).tobytes(),
                RPI.build_d_region(d).tobytes())
    except ValueError as exc:
        return str(exc)


def _native(sets):
    """The native builder on every set at once: a lane a set."""
    n = len(sets)
    tll = np.zeros((n, PI.CELLS), np.uint32)
    td = np.zeros((n, PI.CELLS), np.uint32)
    status = qzcore.inflate_regions(sets, tll, td)
    return [(tll[i].tobytes(), td[i].tobytes()) if status[i] == 0
            else qzcore.REGION_STATUS[int(status[i])] for i in range(n)]


def _assert_same(sets):
    assert _native(sets) == [_numpy(ll, d) for ll, d in sets]


def _first_blocks(data: bytes, level: int):
    """The code lengths of each 64 KB chunk's first dynamic block."""
    out = []
    for off in range(0, len(data), CHUNK):
        s = dd._Stream(_raw(data[off:off + CHUNK], level), CHUNK, 0)
        if dd._parse_one_header(s) == "huff" and s._lens is not None:
            out.append(s._lens)
    return out


@pytest.mark.parametrize("level", [1, 6, 9])
def test_corpus_blocks_byte_equal(corpus, level):
    sets = _first_blocks(corpus, level)
    assert len(sets) >= 30
    _assert_same(sets)


def test_static_lengths_byte_equal():
    ll, d = T.STATIC_LITLEN_LEN, T.STATIC_DIST_LEN
    want = tuple(r.tobytes() for r in RPI.static_regions())
    assert _native([(ll, d)]) == [want]
    assert tuple(r.tobytes() for r in PI.static_regions()) == want


# ---------------------------------------------------------------------------
# Seeded fuzz
# ---------------------------------------------------------------------------
def _complete(rng, nleaves: int, deep: bool = False) -> list[int]:
    """The lengths of a complete prefix code of ``nleaves`` codes of at
    most 15 bits: split leaves until there are enough, the deepest first
    where ``deep``."""
    leaves = [1, 1]
    while len(leaves) < nleaves:
        open_ = [i for i, l in enumerate(leaves) if l < 15]
        if deep and rng.random() < 0.8:
            top = max(leaves[i] for i in open_)
            open_ = [i for i in open_ if leaves[i] == top]
        i = open_[int(rng.integers(len(open_)))]
        l = leaves.pop(i)
        leaves += [l + 1, l + 1]
    return leaves


def _place(rng, lengths, nsym: int, must=()) -> np.ndarray:
    """The lengths on random symbols of an alphabet of ``nsym`` (those in
    ``must`` among them), the rest 0."""
    lens = np.zeros(nsym, np.int32)
    rest = [s for s in range(nsym) if s not in must]
    syms = list(must) + list(rng.choice(rest, len(lengths) - len(must),
                                        replace=False))
    lens[syms] = rng.permutation(lengths)
    return lens


def _case(kind: str, seed: int):
    rng = np.random.default_rng([seed, len(kind)])
    hlit = int(rng.integers(257, 289))
    hdist = int(rng.integers(1, 33))

    def ll_complete(deep=False, must=(), least=2):
        n = int(rng.integers(max(least, len(must)), hlit + 1))
        return _place(rng, _complete(rng, n, deep), hlit, must)

    def d_complete(must=()):
        n = int(rng.integers(max(2, len(must)), hdist + 1)) if hdist > 1 else 0
        if n < 2:
            return np.zeros(hdist, np.int32)
        return _place(rng, _complete(rng, n), hdist, must)

    if kind == "complete":
        return ll_complete(), d_complete()
    if kind == "incomplete":
        ll, d = ll_complete(), d_complete()
        for lens in (ll, d):
            nz = np.nonzero(lens)[0]
            lens[rng.choice(nz, max(1, len(nz) // 3), replace=False)] = 0
        return ll, d
    if kind == "one_distance_code":
        d = np.zeros(hdist, np.int32)
        d[int(rng.integers(hdist))] = 1
        return ll_complete(), d
    if kind == "hdist1_zero":
        return ll_complete(), np.zeros(1, np.int32)
    if kind == "deep_subtables":
        ll = ll_complete(deep=True, least=128)
        return ll, d_complete()
    if kind in ("sub_full", "sub_overflow"):
        # k subtables of 64 entries (15-bit codes) and 2-entry ones (10-bit
        # codes, two a slot) after two 2-bit codes: 512 sub entries, or 514
        k = int(rng.integers(1, 8))
        m10 = 512 - 64 * k + (2 if kind == "sub_overflow" else 0)
        lengths = [2, 2] + [10] * m10 + [15] * (64 * k)
        return _place(rng, lengths, len(lengths) + 20), d_complete()
    if kind == "oversubscribed":
        # a code one step shorter, or one code more: the Kraft sum passes 1
        ll, d = ll_complete(), d_complete()
        lens = d if rng.random() < 0.5 and (d >= 2).any() else ll
        longer = np.nonzero(lens >= 2)[0]
        if len(longer):
            lens[longer[int(rng.integers(len(longer)))]] -= 1
        else:
            lens[np.nonzero(lens == 0)[0][0]] = 1
        return ll, d
    if kind == "invalid_symbols":
        hlit, hdist = 288, 32
        return ll_complete(must=(286, 287)), d_complete(must=(30, 31))
    raise ValueError(kind)


KINDS = ("complete", "incomplete", "one_distance_code", "hdist1_zero",
         "deep_subtables", "sub_full", "sub_overflow", "oversubscribed",
         "invalid_symbols")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", KINDS)
def test_fuzz_byte_equal_or_same_reject(kind, seed):
    ll, d = _case(kind, seed)
    want = _numpy(ll, d)
    assert _native([(ll, d)]) == [want]
    if kind == "sub_overflow":
        assert want == "subtable overflow"
    elif kind == "oversubscribed":
        assert want == "over-subscribed Huffman code"
    else:
        assert not isinstance(want, str)
    if kind == "deep_subtables":
        root = np.frombuffer(want[0][:1024], np.uint16)
        assert (((root >> 4) & 3) == 3).sum() >= 2    # several subtables
    if kind == "invalid_symbols":
        assert ll[286] and ll[287] and d[30] and d[31]


def test_one_call_many_lanes_leaves_skipped_rows():
    """A call over every fuzz case at once gives each lane its own result;
    a lane given as None keeps the rows and status the caller left."""
    sets = [_case(k, s) for s in range(6) for k in KINDS]
    lanes = sets[:10] + [None] + sets[10:]
    n = len(lanes)
    tll = np.full((n, PI.CELLS), 0xA5A5A5A5, np.uint32)
    td = np.full((n, PI.CELLS), 0x5A5A5A5A, np.uint32)
    status = qzcore.inflate_regions(lanes, tll, td)
    assert status[10] == 0
    assert (tll[10] == 0xA5A5A5A5).all() and (td[10] == 0x5A5A5A5A).all()
    got = [(tll[i].tobytes(), td[i].tobytes()) if status[i] == 0
           else qzcore.REGION_STATUS[int(status[i])]
           for i in range(n) if i != 10]
    assert got == [_numpy(ll, d) for ll, d in sets]


def test_threads_build_at_once(corpus):
    """Four threads in the builder at once, outside the interpreter lock,
    each get the reference builders' bytes."""
    sets = _first_blocks(corpus, 1)
    want = [_numpy(ll, d) for ll, d in sets]
    errors = []

    def work():
        try:
            for _ in range(20):
                assert _native(sets) == want
        except AssertionError as exc:   # reported by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors


# ---------------------------------------------------------------------------
# pack_round and inflate_batch
# ---------------------------------------------------------------------------
def _round_streams(corpus):
    """A round's streams: dynamic blocks, a static block, an over-
    subscribed code and a stream past the per-lane budget."""
    streams = []
    for i, off in enumerate(range(0, 6 * CHUNK, CHUNK)):
        s = dd._Stream(_raw(corpus[off:off + CHUNK], 1 + i), CHUNK, i)
        assert dd._parse_one_header(s) == "huff"
        streams.append(s)
    static = dd._Stream(zlib.compress(b"static" * 20)[2:-4], 120, 6)
    assert dd._parse_one_header(static) == "huff" and static._lens is None
    bad = dd._Stream(b"\x00" * 64, 0, 7)
    lens = np.zeros(258, np.int32)
    lens[:257] = 9
    lens[257] = 1
    bad._lens = (lens, np.full(30, 5, np.int32))
    big = dd._Stream(_raw(corpus[:1 << 20], 6), 1 << 20, 8)
    assert dd._parse_one_header(big) == "huff"
    assert len(big.payload) > 4 * dd._LOCKSTEP_NW[-1]
    return streams[:3] + [static, bad] + streams[3:] + [big]


def test_pack_round_same_both_ways(corpus):
    """``pack_round``'s rows are the reference builders' rows for its live
    streams, and its other arrays lay out each stream from its header."""
    batch = _round_streams(corpus)
    live, inputs = dd.pack_round(batch)
    assert [s.index for s in batch if s.failed] == [7, 8]
    assert [t[0].index for t in live] == [0, 1, 2, 6, 3, 4, 5]
    words, bit0, nbits, tll, td, active, steps = inputs
    want = [RPI.static_regions() if t[0]._lens is None else
            (RPI.build_ll_region(t[0]._lens[0]),
             RPI.build_d_region(t[0]._lens[1])) for t in live]
    assert tll.dtype == td.dtype == np.uint32
    assert np.array_equal(tll, np.stack([w[0] for w in want]))
    assert np.array_equal(td, np.stack([w[1] for w in want]))
    for i, (s, _, byte0, _, _) in enumerate(live):
        pv = np.frombuffer(s.payload, np.uint8)[byte0:]
        row = words[i].view(np.uint8)
        assert (row[:len(pv)] == pv).all() and not row[len(pv):].any()
        assert bit0[i] == s.bits.pos & 7 and nbits[i] == 8 * len(pv)
    assert active.all() and steps in dd._LOCKSTEP_STEPS


def _chunks(corpus, n=4, size=8 << 10):
    """``n`` zlib-L1 streams of ``size`` bytes from the corpus's segments
    (the plain torch decode takes a step a symbol on the CPU)."""
    datas = [corpus[i * (256 << 10):i * (256 << 10) + size]
             for i in range(n)]
    return datas, [_raw(d, 1) for d in datas]


def _blocks(payloads, kinds):
    """The streams' blocks of ``kinds``, counted by the reference's walk
    over them (``walk_blocks``)."""
    return sum(k in kinds for p in payloads for _, k in walk_blocks(p))


def _traced_inflate(payloads, hints, kind):
    """``inflate_batch`` inside a traced request: its results and the
    request's spans, read back through ``qz_trace_spans``."""
    tracing = core.flow.tracing
    qt.qz_trace(True)
    try:
        rec = core.flow.request()
        with rec.traced(0):
            res = dd.inflate_batch(payloads, hints, CPU, kind=kind)
    finally:
        qt.qz_trace(tracing)
    return res, [s for s in qt.qz_trace_spans() if s["request"] == rec.id]


@pytest.mark.parametrize("kind", ["crc32", "adler32"])
def test_inflate_batch_bytes_and_region_counters(corpus, kind):
    """zlib's bytes and checksums, two regions counted a dynamic block on
    the ``inflate.tables`` spans, and a Huffman block on the
    ``inflate.parse`` spans."""
    datas, payloads = _chunks(corpus)
    dynamic = _blocks(payloads, {"dynamic"})
    res, spans = _traced_inflate(payloads, [len(d) for d in datas], kind)
    ck = zlib.crc32 if kind == "crc32" else zlib.adler32
    assert [r[0] for r in res] == datas
    assert [r[2] for r in res] == [ck(d) for d in datas]
    assert dynamic >= len(datas)
    assert sum(s["value"] for s in spans
               if s["name"] == "inflate.tables") == 2 * dynamic
    assert sum(s["value"] for s in spans if s["name"] == "inflate.parse") \
        == _blocks(payloads, {"dynamic", "static"})
