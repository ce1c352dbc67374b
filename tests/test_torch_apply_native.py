"""The native round applier (``qz_apply_round``, native/qzapply.cpp) against
the reference's Python token applier (``_apply_tokens_py`` of
qatzip_tpu/ops/deflate_decode.py).

Every lane of a token matrix must give the bytes ``_apply_tokens_py``
gives on its column and its history window, or fail where it fails: a bad
token, a match shorter than 3, a token past the lane's count, a window
underrun, and a count that differs from the bytes the tokens put out.
The matrices are built from seeded token lists over histories of their
own.  The running CRC-32 and Adler-32 carried by the call must be zlib's
over each stream's whole output, across rounds with stored blocks between
them.

Then ``inflate_batch`` on zlib streams, on the CPU device: the original
bytes, end flags, zlib's checksums and the failed-over streams, the
``inflate.device`` spans' count of the lanes, and four threads at once.
"""
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from qatzip_tpu.ops import deflate_decode as rdd
from qatzip_tpu_torch import api as qt
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.native import qzcore
from qatzip_tpu_torch.ops import deflate_decode as dd
from tests.test_torch_headers_native import walk_blocks

torch.set_num_threads(1)

CPU = torch.device("cpu")
WIN = 32768


def lit(b: int) -> int:
    return 1 | (b << 1)


def pair(b1: int, b2: int) -> int:
    return 1 | (b1 << 1) | 0x200 | (b2 << 10)


def match(length: int, dist: int) -> int:
    return 2 | (length << 2) | ((dist - 1) << 11)


def _out_len(tokens) -> int:
    n = 0
    for t in tokens:
        if t & 1:
            n += 2 if t & 0x200 else 1
        elif t:
            n += (t >> 2) & 0x1FF
    return n


def _random_tokens(rng, history: int, ntok: int) -> list[int]:
    """A valid token list over ``history`` bytes: literals, paired
    literals, and matches of any length and distance the stream allows,
    distance 1 and lengths 3 and 258 among them."""
    out, toks = 0, []
    for _ in range(ntok):
        r = rng.random()
        reach = min(history + out, WIN)
        if r < 0.35 or reach == 0:
            toks.append(lit(int(rng.integers(256))))
            out += 1
        elif r < 0.5:
            toks.append(pair(int(rng.integers(256)), int(rng.integers(256))))
            out += 2
        else:
            length = int(rng.choice([3, 258, int(rng.integers(3, 259)),
                                     int(rng.integers(3, 20))]))
            dist = int(rng.choice([1, reach, int(rng.integers(1, reach + 1))]))
            toks.append(match(length, dist))
            out += length
    return toks


def _fixed_lanes(rng):
    """(history, tokens) lanes, each for one case."""
    hist = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
    return [
        # literals and paired literals, no history
        (b"", [lit(7), pair(1, 2), lit(255), pair(0, 255)]),
        # matches inside the output: distance 1, lengths 3 and 258
        (b"", [lit(9), match(258, 1), lit(1), lit(2), match(3, 2),
               match(258, 261)]),
        # matches into the prior window, the farthest a window allows
        (hist, [match(258, WIN), match(3, 100), lit(4)]),
        # straddling window and output: 5 bytes out, reach back 10 for 20
        (hist[:50], [lit(1), lit(2), lit(3), lit(4), lit(5), match(20, 10),
                     match(258, 55)]),
        # a lane with no tokens
        (hist[:300], []),
        # seeded lanes of different lengths
        (hist[:1000], _random_tokens(rng, 1000, 400)),
        (hist, _random_tokens(rng, len(hist), 50)),
        (b"", _random_tokens(rng, 0, 900)),
    ]


def _matrix(lanes, pad: int = 3):
    """tokens u32[steps, lanes], each lane's list from step 0, zeros after
    it (and ``pad`` steps of zeros past the longest)."""
    steps = max(len(t) for t in lanes) + pad
    m = np.zeros((steps, len(lanes)), np.uint32)
    for i, t in enumerate(lanes):
        m[:len(t), i] = t
    return m


def _python(tokens, histories, counts):
    """Each lane by the reference's _apply_tokens_py: its bytes, or None
    where it raises or puts out other than its count."""
    got = []
    for i, h in enumerate(histories):
        try:
            out = rdd._apply_tokens_py(tokens[:, i], h[-WIN:], counts[i])
        except ValueError:
            got.append(None)
            continue
        got.append(out if len(out) == counts[i] else None)
    return got


def _native(tokens, histories, counts, kind="", slack=0):
    """Every lane in one qz_apply_round call, each in a buffer of its own
    that holds its history: (bytes or None a lane, the checksums)."""
    n = len(histories)
    bufs = [np.zeros(len(h) + max(c, 0) + slack, np.uint8)
            for h, c in zip(histories, counts)]
    for b, h in zip(bufs, histories):
        b[:len(h)] = np.frombuffer(h, np.uint8)
    pos = np.array([len(h) for h in histories], np.int64)
    start = pos.copy()
    ck0 = {"": 0, "crc32": 0, "adler32": 1}[kind]
    ck = np.array([_check(kind, h, ck0) for h in histories], np.uint32)
    status = np.zeros(n, np.int32)
    qzcore.apply_round(tokens, np.array([b.ctypes.data for b in bufs],
                                        np.uint64),
                       pos, np.array([len(b) for b in bufs], np.int64),
                       np.array(counts, np.int64), ck, kind, status)
    got = []
    for i, b in enumerate(bufs):
        if status[i]:
            assert status[i] in qzcore.APPLY_STATUS
            assert pos[i] == start[i]
            got.append(None)
        else:
            assert pos[i] == start[i] + counts[i]
            got.append(b[start[i]:pos[i]].tobytes())
    return got, ck.tolist()


def _check(kind: str, data: bytes, start: int) -> int:
    if kind == "crc32":
        return zlib.crc32(data, start)
    if kind == "adler32":
        return zlib.adler32(data, start)
    return 0


@pytest.mark.parametrize("slack", [0, 64])
@pytest.mark.parametrize("seed", range(4))
def test_round_byte_equal_to_python(seed, slack):
    """Lane for lane the Python applier's bytes, with a buffer that ends at
    the lane's count and one with room past it."""
    rng = np.random.default_rng(seed)
    lanes = _fixed_lanes(rng)
    histories = [h for h, _ in lanes]
    counts = [_out_len(t) for _, t in lanes]
    tokens = _matrix([t for _, t in lanes])
    want = _python(tokens, histories, counts)
    assert None not in want and want[4] == b""
    got, _ = _native(tokens, histories, counts, slack=slack)
    assert got == want


def test_round_many_lanes_byte_equal():
    """Sixty lanes, groups of the call's width and a ragged last one."""
    rng = np.random.default_rng(11)
    histories, lanes = [], []
    for i in range(61):
        h = rng.integers(0, 256, int(rng.integers(0, 3 * WIN)),
                         dtype=np.uint8).tobytes()
        histories.append(h)
        lanes.append(_random_tokens(rng, len(h), int(rng.integers(0, 300))))
    counts = [_out_len(t) for t in lanes]
    tokens = _matrix(lanes)
    assert _native(tokens, histories, counts)[0] == _python(tokens, histories,
                                                            counts)


def _reject_lanes():
    """(name, history, tokens, count) lanes: each reject beside good lanes.
    """
    good = [lit(1), match(10, 1), pair(3, 4)]
    n = _out_len(good)
    return [
        ("good", b"", good, n),
        ("bad_token", b"", [lit(1), 4, lit(2)], 2),
        ("length_under_3", b"ab", [match(2, 1)], 2),
        ("length_over_258", b"ab", [match(259, 1)], 259),
        ("past_count_in_token", b"", good, n - 1),
        ("past_count_later", b"", good + [0, 0, lit(5)], n),
        ("underrun_no_history", b"", [lit(1), match(3, 2)], 4),
        ("underrun_history", b"xyz", [lit(1), match(5, 5)], 6),
        ("fewer_than_count", b"", good, n + 1),
        ("good_after", b"q" * 100, [match(50, 100)] + good, 50 + n),
    ]


def test_rejects_fail_the_same_lanes():
    lanes = _reject_lanes()
    histories = [h for _, h, _, _ in lanes]
    counts = [c for *_, c in lanes]
    tokens = _matrix([t for _, _, t, _ in lanes])
    want = _python(tokens, histories, counts)
    got, _ = _native(tokens, histories, counts)
    assert got == want
    failed = {name for (name, *_), w in zip(lanes, want) if w is None}
    assert failed == {name for name, *_ in lanes} - {"good", "good_after"}


def _streams(histories, kind):
    streams = []
    for i, h in enumerate(histories):
        s = dd._Stream(b"\x00", 0, i, kind=kind)
        s.push(h)
        streams.append(s)
    return streams


def _apply(tokens, histories, counts, kind, rem, err, end_bit):
    """``_apply_round`` on fresh streams: (failed, bytes, checksum, bit
    position) a stream."""
    streams = _streams(histories, kind)
    live = [(s, None, 10 + s.index, r, 0) for s, r in zip(streams, rem)]
    dd._apply_round(live, tokens, err, np.array(counts, np.int32), end_bit)
    return [(s.failed, s.output(), s.crc, s.bits.pos) for s in streams]


@pytest.mark.parametrize("kind", ["", "crc32", "adler32"])
def test_apply_round_same_both_ways(kind):
    """The streams after the round, lane for lane those the reference's
    applier gives: a failed lane keeps the bytes, checksum and bit position
    it had, including the lanes the device failed (``err``, no end bit)
    and a count past what is left."""
    lanes = _reject_lanes()
    histories = [h for _, h, _, _ in lanes]
    counts = [c for *_, c in lanes]
    tokens = _matrix([t for _, _, t, _ in lanes] + [[lit(1)]] * 3)
    histories += [b"", b"", b""]
    counts += [1, 1, 1]
    n = len(histories)
    err = np.zeros(n, bool)
    err[-3] = True
    end_bit = np.arange(n, dtype=np.int32)
    end_bit[-2] = -1
    rem = [max(c, 1) for c in counts]
    rem[-1] = 0
    got = _apply(tokens, histories, counts, kind, rem, err, end_bit)
    start = {"adler32": 1}.get(kind, 0)
    want = []
    for i, (h, out) in enumerate(zip(histories,
                                      _python(tokens, histories, counts))):
        if out is None or err[i] or end_bit[i] < 0 or counts[i] > rem[i]:
            want.append((True, h, _check(kind, h, start) if kind else None,
                         0))
        else:
            want.append((False, h + out,
                         _check(kind, h + out, start) if kind else None,
                         ((10 + i) << 3) + i))
    assert got == want
    names = [name for name, *_ in lanes] + ["err", "no_end", "past_rem"]
    assert [name for name, (failed, *_) in zip(names, got) if not failed] \
        == ["good", "good_after"]


@pytest.mark.parametrize("kind", ["crc32", "adler32"])
def test_running_checksum_over_rounds_and_stored_blocks(kind):
    """Rounds of token lanes with stored blocks pushed between them: the
    running checksum is zlib's over each stream's whole output, and the
    bytes are the pushed parts and each round's lane by the reference's
    applier."""
    rng = np.random.default_rng([5, len(kind)])
    streams = [dd._Stream(b"\x00", 0, i, kind=kind) for i in range(6)]
    want = [b""] * len(streams)
    for _ in range(4):
        for i, s in enumerate(streams):
            if rng.random() < 0.6:
                part = rng.integers(0, 256, int(rng.integers(0, 5000)),
                                    dtype=np.uint8).tobytes()
                s.push(part)
                want[i] += part
        lanes = [_random_tokens(rng, s.n, int(rng.integers(0, 600)))
                 for s in streams]
        counts = [_out_len(t) for t in lanes]
        tokens = _matrix(lanes)
        outs = _python(tokens, want, counts)
        assert None not in outs
        want = [w + o for w, o in zip(want, outs)]
        live = [(s, None, 0, c + 7, 0) for s, c in zip(streams, counts)]
        dd._apply_round(live, tokens, np.zeros(len(lanes), bool),
                        np.array(counts, np.int32),
                        np.zeros(len(lanes), np.int32))
    assert not any(s.failed for s in streams)
    assert [s.output() for s in streams] == want
    for s in streams:
        assert s.crc == _check(kind, s.output(),
                               1 if kind == "adler32" else 0)


def test_round_checksums_equal_zlib():
    """The call's running checksums from a history's checksum on."""
    rng = np.random.default_rng(3)
    lanes = _fixed_lanes(rng)
    histories = [h for h, _ in lanes]
    counts = [_out_len(t) for _, t in lanes]
    tokens = _matrix([t for _, t in lanes])
    for kind, start in (("crc32", 0), ("adler32", 1)):
        got, ck = _native(tokens, histories, counts, kind)
        assert ck == [_check(kind, h + g, start)
                      for h, g in zip(histories, got)]


def test_bad_arrays_refused():
    tokens = _matrix([[lit(1)], [lit(2)]])
    ok = dict(addrs=np.zeros(2, np.uint64), pos=np.zeros(2, np.int64),
              cap=np.zeros(2, np.int64), outcnt=np.ones(2, np.int64),
              ck=np.zeros(2, np.uint32), status=np.zeros(2, np.int32))
    for key, bad in (("pos", np.zeros(2, np.int32)),
                     ("status", np.zeros(3, np.int32))):
        args = dict(ok, **{key: bad})
        with pytest.raises(ValueError):
            qzcore.apply_round(tokens, args["addrs"], args["pos"],
                               args["cap"], args["outcnt"], args["ck"], "",
                               args["status"])


def test_buffer_shorter_than_count_fails_the_lane():
    """A buffer the caller sized short fails its lane, nothing written."""
    tokens = _matrix([[lit(1), lit(2)], [lit(3)]])
    bufs = [np.zeros(1, np.uint8), np.zeros(1, np.uint8)]
    pos = np.zeros(2, np.int64)
    status = np.zeros(2, np.int32)
    qzcore.apply_round(tokens, np.array([b.ctypes.data for b in bufs],
                                        np.uint64),
                       pos, np.ones(2, np.int64), np.array([2, 1], np.int64),
                       np.zeros(2, np.uint32), "", status)
    assert status.tolist() == [-2, 0] and pos.tolist() == [0, 1]
    assert bufs[0][0] == 0 and bufs[1][0] == 3


# ---------------------------------------------------------------------------
# inflate_batch
# ---------------------------------------------------------------------------
def _raw(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def _multi_block(data: bytes, level: int) -> bytes:
    """Blocks ended by a full flush (an empty stored block each), a stored
    block of 300 bytes, then a final part from a fresh compressor."""
    a, b, c = data[:len(data) // 3], data[len(data) // 3:-300], data[-300:]
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    head = co.compress(a) + co.flush(zlib.Z_FULL_FLUSH)
    head += co.compress(b) + co.flush(zlib.Z_FULL_FLUSH)
    stored = b"\x00" + len(c).to_bytes(2, "little") + \
        (len(c) ^ 0xFFFF).to_bytes(2, "little") + c
    return head + stored + _raw(c[::-1], level)


def _batch(corpus_factory, level):
    """(payloads, hints, wanted bytes or None) of a mixed batch."""
    text = corpus_factory(6000, "text")
    rand = corpus_factory(1500, "random")
    multi = text[:3000] + rand[:700] + text[3000:]
    corrupt = bytearray(_raw(text[:4000], level))
    corrupt[len(corrupt) // 2] ^= 0xFF
    cases = [
        (_raw(text[:4000], level), text[:4000]),
        (_multi_block(multi, level), multi + multi[-300:][::-1]),
        (_raw(rand, level), rand),
        (_raw(b"", level), b""),
        (_raw(rand[:900], 0), rand[:900]),                # stored blocks
        (bytes(corrupt), None),
        (_raw(corpus_factory(3000, "iterative"), level),
         corpus_factory(3000, "iterative")),
    ]
    return ([p for p, _ in cases],
            [4000, len(multi) + 300, len(rand), 0, 900, 4000, 3000],
            [w for _, w in cases])


def _counted_blocks(payloads):
    """The index of each stream once a Huffman block, by the reference's
    walk over the streams (``walk_blocks``)."""
    return [i for i, p in enumerate(payloads) for _, k in walk_blocks(p)
            if k != "stored"]


def _run(payloads, hints, kind):
    """``inflate_batch`` inside a traced request: its results, the streams
    failed over and the request's spans, read back through
    ``qz_trace_spans``."""
    f0 = qt.qz_dump_counters()["failover_lanes"]
    tracing = core.flow.tracing
    qt.qz_trace(True)
    try:
        rec = core.flow.request()
        with rec.traced(0):
            res = dd.inflate_batch(payloads, hints, CPU, kind=kind)
    finally:
        qt.qz_trace(tracing)
    spans = [s for s in qt.qz_trace_spans() if s["request"] == rec.id]
    return res, qt.qz_dump_counters()["failover_lanes"] - f0, spans


@pytest.mark.parametrize("kind", [None, "crc32", "adler32"])
@pytest.mark.parametrize("level", [1, 6, 9])
def test_inflate_batch_same_both_ways(corpus_factory, level, kind):
    """The original bytes, end flags and zlib's checksums; a corrupted
    stream failed over or read as zlib reads it."""
    payloads, hints, want = _batch(corpus_factory, level)
    res, failed, _ = _run(payloads, hints, kind)
    assert failed == res.count(None)
    for r, w in zip(res, want):
        if w is None:
            # corrupted: failed over, or zlib's own reading of it
            if r is not None:
                assert r[0] == zlib.decompressobj(-15).decompress(
                    payloads[5])
            continue
        assert r is not None and r[:2] == (w, True)
        ck = {"crc32": zlib.crc32, "adler32": zlib.adler32}.get(kind)
        assert r[2] == (ck(w) if ck else None)


@pytest.mark.parametrize("kind", ["crc32", "adler32"])
def test_apply_counters_count_the_lanes(corpus_factory, kind):
    """On sound streams every Huffman block is a lane on the
    ``inflate.device`` spans and a block on the ``inflate.parse`` spans,
    and none fails over."""
    payloads, hints, want = _batch(corpus_factory, 6)
    keep = [i for i, w in enumerate(want) if w is not None]
    payloads = [payloads[i] for i in keep]
    hints = [hints[i] for i in keep]
    seen = _counted_blocks(payloads)
    res, failed, spans = _run(payloads, hints, kind)
    assert [r[0] for r in res] == [want[i] for i in keep]
    assert seen.count(1) == 3          # the multi-block stream's blocks
    assert failed == 0
    assert sum(s["value"] for s in spans
               if s["name"] == "inflate.device") == len(seen)
    assert sum(s["value"] for s in spans
               if s["name"] == "inflate.parse") == len(seen)


def test_threads_apply_at_once():
    """Four threads in the round call at once, outside the interpreter
    lock, each get the reference applier's bytes."""
    rng = np.random.default_rng(17)
    histories, lanes = [], []
    for _ in range(64):
        h = rng.integers(0, 256, int(rng.integers(0, 2 * WIN)),
                         dtype=np.uint8).tobytes()
        histories.append(h)
        lanes.append(_random_tokens(rng, len(h), int(rng.integers(0, 800))))
    counts = [_out_len(t) for t in lanes]
    tokens = _matrix(lanes)
    want = _python(tokens, histories, counts)
    errors = []

    def work():
        try:
            for _ in range(20):
                assert _native(tokens, histories, counts)[0] == want
        except AssertionError as exc:   # reported by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors


def test_threads_inflate_at_once(corpus_factory):
    """Four threads in inflate_batch at once get the one-thread results."""
    datas = [corpus_factory(1500, "text"), corpus_factory(800, "iterative")]
    payloads = [_raw(d, 1) for d in datas]
    hints = [len(d) for d in datas]
    want = dd.inflate_batch(payloads, hints, CPU, kind="crc32")
    assert [r[0] for r in want] == datas
    got, errors = [], []

    def work():
        try:
            got.append(dd.inflate_batch(payloads, hints, CPU, kind="crc32"))
        except Exception as exc:   # reported by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert got == [want] * 4


def test_threads_count_every_failed_stream():
    """Four threads in inflate_batch at once, on streams that fail (empty,
    a reserved block type, a truncated header): ``failover_lanes`` rises by
    every one of them, none lost to a racing update."""
    payloads = [b"", b"\x07", b"\x05\xff", b""] * 8
    f0 = qt.qz_dump_counters()["failover_lanes"]
    errors = []

    def work():
        try:
            for _ in range(200):
                res = dd.inflate_batch(payloads, [0] * len(payloads), CPU)
                assert res == [None] * len(payloads)
        except Exception as exc:   # reported by the main thread
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert qt.qz_dump_counters()["failover_lanes"] - f0 \
        == 4 * 200 * len(payloads)
