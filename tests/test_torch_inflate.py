"""The port's lockstep inflate (ops/inflate.py) against the reference.

Table regions (``libqzcore``'s ``qz_inflate_regions``) must be byte-equal
to the reference builders'; the port's
plain torch driver must return the reference XLA driver's tokens, err,
outcnt, end_bit and nsteps exactly (both use the 9-bit region layout); and
per lane, outcnt and end_bit must match the reference Pallas driver run in
interpret mode on its own 8/7-bit layout.
"""
import zlib

import numpy as np
import pytest
import torch

from qatzip_tpu.ops import deflate_decode as rdd
from qatzip_tpu.ops import pallas_inflate as RPI
from qatzip_tpu_torch.native import qzcore
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.ops import deflate_tables as T
from qatzip_tpu_torch.ops import inflate as PI

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _raw(data: bytes, level: int, strategy=zlib.Z_DEFAULT_STRATEGY) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(data) + co.flush()


def _round(payloads, NW=4096, max_steps=16384):
    """Lay out one round with one stream per lane, first block of each."""
    streams = []
    for i, p in enumerate(payloads):
        s = rdd._Stream(p, 0, i)
        assert rdd._parse_one_header(s) == "huff"
        streams.append(s)
    B = RPI.LANES
    stream8 = np.zeros((B, NW * 4), np.uint8)
    bit0 = np.zeros(B, np.int32)
    nbits = np.zeros(B, np.int32)
    tll = np.zeros((B, PI.CELLS), np.uint32)
    td = np.zeros((B, PI.CELLS), np.uint32)
    active = np.zeros(B, bool)
    for i, s in enumerate(streams):
        tll[i], td[i] = rdd._lockstep_regions(s, RPI.region_spec(False))
        byte0 = s.bits.pos >> 3
        pv = np.frombuffer(s.payload, np.uint8)[byte0:]
        stream8[i, :len(pv)] = pv
        bit0[i] = s.bits.pos & 7
        nbits[i] = len(pv) * 8
        active[i] = True
    return (stream8.view("<u4"), bit0, nbits, tll, td, active, max_steps)


def _both(inputs):
    ref = RPI.decode_blocks(*inputs, use_pallas=False)
    got = PI.decode_blocks(*inputs, CPU)
    return ref, got


def _port_regions(lens_sets):
    """The port's regions of each (litlen, distance) length set, by one
    ``qz_inflate_regions`` call: (tll, td, status) with a row a set."""
    n = len(lens_sets)
    tll = np.zeros((n, PI.CELLS), np.uint32)
    td = np.zeros((n, PI.CELLS), np.uint32)
    return tll, td, qzcore.inflate_regions(lens_sets, tll, td)


def _assert_equal(ref, got):
    assert got[4] == ref[4]                                   # nsteps
    assert got[0].dtype == np.uint32 and (got[0] == ref[0]).all()
    for k in (1, 2, 3):                                       # err/outcnt/end
        assert (got[k] == np.asarray(ref[k])).all()


def _dynamic_lens(corpus_factory):
    out = []
    for kind, level in (("text", 1), ("text", 9), ("iterative", 6),
                        ("constant", 1)):
        s = rdd._Stream(_raw(corpus_factory(5000, kind), level), 0, 0)
        assert rdd._parse_one_header(s) == "huff"
        if s._lens is not None:
            out.append(s._lens)
    return out


def test_regions_byte_equal_to_reference(corpus_factory):
    ll, d = PI.static_regions()
    rll, rd = RPI.static_regions()
    assert ll.dtype == rll.dtype and ll.tobytes() == rll.tobytes()
    assert d.tobytes() == rd.tobytes()
    lens_sets = _dynamic_lens(corpus_factory)
    assert lens_sets
    tll, td, status = _port_regions(lens_sets)
    assert not status.any()
    for i, (ll_lens, d_lens) in enumerate(lens_sets):
        assert tll[i].tobytes() == RPI.build_ll_region(ll_lens).tobytes()
        assert td[i].tobytes() == RPI.build_d_region(d_lens).tobytes()
    assert (PI.ROOT_BITS, PI.ROOT_BITS, PI.CELLS, PI.CELLS) \
        == RPI.region_spec(False)


def test_region_builders_reject_what_the_reference_rejects():
    lens = np.zeros(286, np.int32)
    lens[:4] = 1  # four 1-bit codes: Kraft violation
    dlens = np.zeros(30, np.int32)
    dlens[:3] = 1
    good_ll, good_d = T.STATIC_LITLEN_LEN[:286], T.STATIC_DIST_LEN[:30]
    with pytest.raises(ValueError):
        RPI.build_ll_region(lens)
    with pytest.raises(ValueError):
        RPI.build_d_region(dlens)
    _, _, status = _port_regions([(lens, good_d), (good_ll, dlens),
                                  (good_ll, good_d)])
    assert status.tolist() == [1, 1, 0]
    assert qzcore.REGION_STATUS[1] == "over-subscribed Huffman code"


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("kind", ["text", "iterative", "constant"])
def test_decode_ref_matches_xla_driver(corpus_factory, kind, level):
    data = corpus_factory(3000, kind)
    ref, got = _both(_round([_raw(data, level)]))
    _assert_equal(ref, got)
    assert not got[1][0]
    assert rdd._apply_tokens_py(got[0][:, 0], b"", int(got[2][0])) == data


def test_outcnt_end_bit_match_pallas_driver_interpret(corpus_factory):
    """The reference Pallas driver (interpret mode, 8/7-bit layout) and the
    port agree per lane on outcnt and end_bit, as test_pallas_inflate
    requires of the two reference drivers."""
    from qatzip_tpu.ops import pallas_inflate_kernel as K

    data = corpus_factory(600, "text")
    payload = _raw(data, 6)
    inputs = _round([payload], NW=1024, max_steps=1024)
    got = PI.decode_blocks(*inputs, CPU)
    s = rdd._Stream(payload, 0, 0)
    rdd._parse_one_header(s)
    spec = RPI.region_spec(True)
    tll = np.zeros((RPI.LANES, spec[2]), np.uint32)
    td = np.zeros((RPI.LANES, spec[3]), np.uint32)
    tll[0], td[0] = rdd._lockstep_regions(s, spec)
    words, bit0, nbits, _, _, active, ms = inputs
    pal = K.decode_pallas(words, bit0, nbits, tll, td, active, ms,
                          interpret=True)
    assert not pal[1][0] and not got[1][0]
    assert int(pal[2][0]) == int(got[2][0]) == len(data)
    assert int(pal[3][0]) == int(got[3][0])


def test_literal_pairing_engages(corpus_factory):
    data = corpus_factory(20000, "text")
    ref, got = _both(_round([_raw(data, 1)]))
    _assert_equal(ref, got)
    lane = got[0][:, 0]
    lits = lane[(lane & 1) == 1]
    paired = int(((lits & 0x200) != 0).sum())
    assert paired > 0, "pairing never engaged on literal-heavy text"
    nmatch = int(((lane & 3) == 2).sum())
    assert got[4] < len(lits) + paired + nmatch + 1  # pairs saved steps
    from qatzip_tpu.native import qzcore as native

    t = np.ascontiguousarray(got[0])
    assert native.apply_tokens(t, 0, b"", 0, int(got[2][0])) == data


def _static_stream(codes_msb_first):
    """BFINAL=1, BTYPE=01 block whose codes are the given (code, length)
    pairs, written MSB-first as RFC1951 packs Huffman codes."""
    bits = [1, 1, 0]                      # BFINAL, BTYPE=01 (LSB first)
    for code, length in codes_msb_first:
        bits += [(code >> (length - 1 - k)) & 1 for k in range(length)]
    bits += [0] * (-len(bits) % 8 + 64)
    return bytes(sum(b << k for k, b in enumerate(bits[i:i + 8]))
                 for i in range(0, len(bits), 8))


def test_invalid_and_corrupt_lanes_error_like_the_reference(corpus_factory):
    data = corpus_factory(4000, "text")
    good = _raw(data, 6)
    corrupt = bytearray(good)
    for i in range(len(corrupt) // 2, len(corrupt) - 4, 5):
        corrupt[i] ^= 0x5A   # past the dynamic header: the codes decode
    # static literal 'A' (code 0x30+0x41, 8 bits), then symbol 286, which
    # owns static code space (11000110) but is invalid in a stream
    invalid = _static_stream([(0x30 + 0x41, 8), (0b11000110, 8)])
    # static literal then EOB (0000000, 7 bits): valid
    tiny = _static_stream([(0x30 + 0x42, 8), (0, 7)])
    inputs = _round([good, bytes(corrupt), invalid, tiny,
                     _raw(corpus_factory(2000, "iterative"), 1)])
    ref, got = _both(inputs)
    _assert_equal(ref, got)
    err = got[1]
    assert not err[0] and err[2] and not err[3] and not err[4]
    assert int(got[2][3]) == 1


def test_oversubscribed_code_fails_the_same_lanes(corpus_factory):
    """A block whose litlen code is over-subscribed: the reference and the
    port both refuse its regions, and the port's round leaves that lane
    out and marks the stream failed (it is then inflated on the CPU)."""
    lens = np.zeros(258, np.int32)
    lens[:257] = 9
    lens[257] = 1                          # far beyond the Kraft sum
    dlens = np.full(30, 5, np.int32)

    def bad_stream():
        s = rdd._Stream(b"\x00" * 64, 0, 0)
        s._lens = (lens, dlens)
        return s

    with pytest.raises(ValueError):
        rdd._lockstep_regions(bad_stream(), RPI.region_spec(False))
    assert dd._round_regions([bad_stream()])[2].tolist() == [False]
    good = rdd._Stream(_raw(corpus_factory(2000, "text"), 6), 0, 1)
    assert rdd._parse_one_header(good) == "huff"
    bad = bad_stream()
    live, inputs = dd.pack_round([bad, good])
    assert bad.failed and not good.failed
    assert [t[0] for t in live] == [good] and inputs is not None


def test_inflate_batch_equals_zlib_and_counts_failover(corpus_factory):
    datas = [corpus_factory(5000, k) for k in ("text", "iterative",
                                               "constant")]
    payloads = [_raw(d, 6) for d in datas] + [b"\x07garbage-stream"]
    hints = [len(d) for d in datas] + [100]
    before = dd.failover_lanes
    res = dd.inflate_batch(payloads, hints, CPU, kind="crc32")
    assert [r[0] for r in res[:3]] == datas
    assert [r[2] for r in res[:3]] == [zlib.crc32(d) for d in datas]
    assert res[3] is None
    assert dd.failover_lanes == before + 1


def test_inflate_batch_width_does_not_change_results(corpus_factory):
    """The codec's inflate at the reference's 128 lanes a launch and at the
    port's width: the same bytes, checksums and failover lanes (a lane's
    result depends on its stream alone, since every round's step bound
    covers its largest hint)."""
    from qatzip_tpu_torch.engine.backend import DecompressedChunk
    from qatzip_tpu_torch.ops import device_codecs as dc
    from qatzip_tpu_torch.session import InternalParams

    kinds = ("text", "iterative", "constant", "random")
    datas = [corpus_factory(60 + 37 * (i % 9), kinds[i % 4])
             for i in range(150)]
    payloads = [_raw(d, 1 + i % 9) for i, d in enumerate(datas)]
    hints = [len(d) for d in datas]
    for i in (4, 76, 140):      # output beyond the hint: CPU inflates it
        hints[i] = len(datas[i]) // 2
    assert dc.DeflateDeviceCodec.LOCKSTEP_BATCH > 128
    outs = []
    for width in (128, dc.DeflateDeviceCodec.LOCKSTEP_BATCH):
        codec = dc.DeflateDeviceCodec()
        codec.LOCKSTEP_BATCH = width
        before = dd.failover_lanes
        outs.append((codec.decompress_chunks(payloads, hints,
                                             InternalParams(), CPU),
                     dd.failover_lanes - before))
    assert outs[0] == outs[1]
    chunks, failed = outs[0]
    assert failed == 3
    assert chunks == [DecompressedChunk(d, zlib.crc32(d), True)
                      for d in datas]
