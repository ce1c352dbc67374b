"""The port's parity engines against the reference, on the CPU device.

The same numpy inputs, made from a seed, go through the JAX function and
its port (plain torch on ``torch.device("cpu")``), and every result must be
exactly equal: the arithmetic codes, lookups and histograms
(ops/codes.py), the device checksums (ops/checksums.py, also against
zlib), the device encoder's K1 arrays (with and without the LZ4 rules), K2
words and bits and ``encode_blocks`` (ops/deflate_encode.py), the API's
bytes with QATZIP_TPU_ENCODER=device, and the speculative decoder's raw
outputs and ``inflate_batch`` results and checksums with
QATZIP_TPU_INFLATE=spec (ops/deflate_decode.py).
"""
import gzip
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu import constants as C
from qatzip_tpu.constants import QzDataFormat
from qatzip_tpu.ops import checksums as rck
from qatzip_tpu.ops import codes as rcodes
from qatzip_tpu.ops import deflate_decode as rdd
from qatzip_tpu.ops import deflate_encode as rde
from qatzip_tpu.ops import deflate_tables as RT
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.ops import checksums as ck
from qatzip_tpu_torch.ops._build import KernelError
from qatzip_tpu_torch.ops import codes
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.ops import deflate_encode as de

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- codes
def test_length_code_equals_reference():
    lens = np.arange(3, 259, dtype=np.int32)
    want = [np.asarray(x) for x in rcodes.length_code(jnp.asarray(lens))]
    got = [x.numpy() for x in codes.length_code(_t(lens))]
    for w, g, tab in zip(want, got, (RT.LENGTH_CODE, RT.LENGTH_EXTRA_BITS,
                                     RT.LENGTH_EXTRA_VAL)):
        assert (g == w).all() and (g == tab[3:259]).all()


def test_dist_code_equals_reference():
    dists = np.arange(1, 32769, dtype=np.int32)
    want = [np.asarray(x) for x in rcodes.dist_code(jnp.asarray(dists))]
    got = [x.numpy() for x in codes.dist_code(_t(dists))]
    for w, g, tab in zip(want, got, (RT.DIST_CODE, RT.DIST_EXTRA_BITS,
                                     RT.DIST_EXTRA_VAL)):
        assert (g == w).all() and (g == tab[1:]).all()


def test_onehot_lookups_equal_reference():
    rng = np.random.default_rng(0)
    tbl = rng.integers(0, 1 << 15, (286, 2)).astype(np.int32)
    idx = rng.integers(0, 286, 1000).astype(np.int32)
    want = np.asarray(rcodes.onehot_lookup(jnp.asarray(idx), jnp.asarray(tbl)))
    got = codes.onehot_lookup(_t(idx), _t(tbl)).numpy()
    assert got.dtype == want.dtype and (got == want).all()
    want1 = np.asarray(rcodes.onehot_lookup1(jnp.asarray(idx),
                                             jnp.asarray(tbl[:, 0])))
    got1 = codes.onehot_lookup1(_t(idx), _t(tbl[:, 0])).numpy()
    assert got1.dtype == want1.dtype and (got1 == want1).all()


def test_onehot_histogram_equals_reference():
    rng = np.random.default_rng(1)
    w = rng.integers(0, 2, 100000).astype(np.int32)
    i2 = rng.integers(0, 286, 100000).astype(np.int32)
    want = np.asarray(rcodes.onehot_histogram(jnp.asarray(i2),
                                              jnp.asarray(w), 286))
    got = codes.onehot_histogram(_t(i2), _t(w), 286).numpy()
    assert (got == want).all()
    assert (got == np.bincount(i2, weights=w, minlength=286)).all()
    # larger integer weights stay exact
    w3 = rng.integers(0, 1000, 100000).astype(np.int32)
    got3 = codes.onehot_histogram(_t(i2), _t(w3), 286).numpy()
    assert (got3 == np.bincount(i2, weights=w3, minlength=286)).all()


@pytest.mark.parametrize("nbins", [286, 30])
def test_hist_onehot_equals_reference(nbins):
    rng = np.random.default_rng(nbins)
    idx = rng.integers(0, nbins, (5, 3000)).astype(np.int32)
    valid = rng.integers(0, 2, (5, 3000)).astype(bool)
    want = np.asarray(rde._hist_onehot(jnp.asarray(idx), jnp.asarray(valid),
                                       nbins))
    got = de._hist_onehot(_t(idx), _t(valid), nbins).numpy()
    assert got.dtype == want.dtype and (got == want).all()


# ------------------------------------------------------------ checksums
N = 1024
_LENGTH_SETS = [[0], [1], [2], [127], [128], [129],
                [0, 1, 2, 3, 5, 8, 13, 21],
                [N, N - 1, 1, 0, N // 2, 777, 3, 64]]


def _ck_batch(lengths, seed=0):
    rng = np.random.default_rng(seed)
    data = np.zeros((len(lengths), N), np.uint8)
    blobs = []
    for i, ln in enumerate(lengths):
        b = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
        data[i, :ln] = np.frombuffer(b, np.uint8)
        blobs.append(b)
    return data, np.asarray(lengths, np.int32), blobs


@pytest.mark.parametrize("lengths", _LENGTH_SETS)
def test_crc32_blocks_equal_reference_and_zlib(lengths):
    data, lens, blobs = _ck_batch(lengths)
    got = ck.crc32_blocks(_t(data), _t(lens), N).numpy()
    assert (got == np.asarray(rck.crc32_blocks(data, lens, N))).all()
    assert [int(g) for g in got] == [zlib.crc32(b) for b in blobs]


@pytest.mark.parametrize("lengths", _LENGTH_SETS)
def test_adler32_blocks_equal_reference_and_zlib(lengths):
    data, lens, blobs = _ck_batch(lengths, seed=1)
    got = ck.adler32_blocks(_t(data), _t(lens), N).numpy()
    assert (got == np.asarray(rck.adler32_blocks(data, lens, N))).all()
    assert [int(g) for g in got] == [zlib.adler32(b) for b in blobs]


def test_checksum_length_sweep():
    """Every length 0..64 and lengths around the word and group widths."""
    lengths = list(range(0, 65)) + [120, 121, 126, 127, 128, 129, 255, 256,
                                    257, 511, 512, 513, 1000, 1023, 1024]
    data, lens, blobs = _ck_batch(lengths, seed=2)
    got_c = ck.crc32_blocks(_t(data), _t(lens), N).numpy()
    got_a = ck.adler32_blocks(_t(data), _t(lens), N).numpy()
    assert (got_c == np.asarray(rck.crc32_blocks(data, lens, N))).all()
    assert (got_a == np.asarray(rck.adler32_blocks(data, lens, N))).all()
    assert [int(g) for g in got_c] == [zlib.crc32(b) for b in blobs]
    assert [int(g) for g in got_a] == [zlib.adler32(b) for b in blobs]


@pytest.mark.parametrize("fn,n", [(ck.crc32_blocks, 1000),
                                  (ck.crc32_blocks, 2),
                                  (ck.adler32_blocks, 1000),
                                  (ck.adler32_blocks, 64),
                                  (ck.crc32_blocks, 1 << 26)])
def test_checksums_refuse_shapes_the_plain_versions_do_not_take(fn, n):
    """CRC32 takes n // 4 a power of 2, Adler-32 n a multiple of 128, both
    below 2^25: other n raise ValueError on every device, before any
    version runs; so do data narrower than n and lengths of another
    shape."""
    data = torch.zeros((2, max(n, 8)), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fn(data, torch.zeros(2, dtype=torch.int32), n)
    with pytest.raises(ValueError):
        fn(data[:, :4], torch.zeros(2, dtype=torch.int32), N)
    with pytest.raises(ValueError):
        fn(torch.zeros((2, N), dtype=torch.uint8),
           torch.zeros(3, dtype=torch.int32), N)


@pytest.mark.parametrize("fn", [ck.crc32_blocks, ck.adler32_blocks])
def test_checksums_raise_for_a_device_without_the_kernel(fn):
    """No quiet fallback: a tensor off the CPU that is not a CUDA tensor
    raises, and the plain version runs only for CPU tensors."""
    data = torch.zeros((2, N), dtype=torch.uint8, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    n0 = ck.KERNEL.launches
    with pytest.raises(KernelError, match="no checksum kernel"):
        fn(data, lens, N)
    fn(torch.zeros((2, N), dtype=torch.uint8),
       torch.zeros(2, dtype=torch.int32), N)
    assert ck.KERNEL.launches == n0


# --------------------------------------------------------- device encoder
BLK = 4096


@pytest.fixture(scope="module")
def enc_batch():
    """The conftest corpora at one 4 KB block each, ragged lengths."""
    import random

    from conftest import make_corpus

    rng = random.Random(0xC0FFEE)
    datas = [make_corpus(rng, BLK, "text"), make_corpus(rng, 3000, "random"),
             make_corpus(rng, BLK, "constant"), make_corpus(rng, 777,
                                                            "iterative"),
             make_corpus(rng, 13, "text"), b""]
    data = np.zeros((len(datas), BLK + 8), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        data[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return datas, data, lens


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("lz4_rules", [False, True])
def test_analyze_blocks_equals_reference(enc_batch, level, lz4_rules):
    _, data, lens = enc_batch
    depth, kwords = de.level_params(level)
    assert (depth, kwords) == rde.level_params(level)
    want = rde.analyze_blocks(jnp.asarray(data), jnp.asarray(lens), depth,
                              kwords, lz4_rules=lz4_rules)
    got = de.analyze_blocks(_t(data), _t(lens), depth, kwords,
                            lz4_rules=lz4_rules)
    for name, w, g in zip(("sel", "take", "mlen", "mdist", "freq_ll",
                           "freq_d"), want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and (g == w).all(), name


def test_pack_blocks_equals_reference(enc_batch):
    """K2 from the same K1 arrays and the same host tables."""
    from qatzip_tpu_torch.native import qzcore as native

    _, data, lens = enc_batch
    depth, kwords = de.level_params(1)
    m_words = de.words_bound(BLK)
    k1 = de.analyze_blocks(_t(data), _t(lens), depth, kwords)
    mode, ll_len, ll_code, d_len, d_code, hv, hn, _ = native.huff_build_batch(
        k1[4].numpy(), k1[5].numpy(), lens, True, 32 * m_words, de.HDR_MAX)
    tables = (hv.astype(np.uint32), hn, ll_len, ll_code, d_len, d_code)
    w_words, w_bits = rde.pack_blocks(
        jnp.asarray(data), *(jnp.asarray(x.numpy()) for x in k1[:4]),
        *(jnp.asarray(t) for t in tables), m_words)
    g_words, g_bits = de.pack_blocks(_t(data), *k1[:4],
                                     *(_t(t.astype(np.int64)) for t in tables),
                                     m_words)
    assert (g_words.numpy() == np.asarray(w_words)).all()
    assert (g_bits.numpy() == np.asarray(w_bits)).all()


@pytest.mark.parametrize("level", [1, 9])
def test_encode_blocks_equals_reference_and_inflates(enc_batch, level):
    datas, data, lens = enc_batch
    depth, kwords = de.level_params(level)
    m_words = de.words_bound(BLK)
    w_words, w_bits, w_mode = rde.encode_blocks(data, lens, depth, kwords,
                                                True, m_words)
    words, bits, mode = de.encode_blocks(data, lens, depth, kwords, True,
                                         m_words, device=CPU)
    assert (words.numpy() == np.asarray(w_words)).all()
    assert (bits.numpy() == np.asarray(w_bits)).all()
    assert (mode == np.asarray(w_mode)).all()
    for i, d in enumerate(datas):
        if mode[i] != de.MODE_STORED:
            payload = words[i].numpy().astype(np.uint32).tobytes()
            assert zlib.decompressobj(-15).decompress(
                payload[:(int(bits[i]) + 7) // 8]) == d


# --------------------------------------------- the API with the parity engines
@pytest.fixture
def cpu_engine(monkeypatch):
    """The port's engine on the CPU device with the device route forced."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    core.qz_close_engine()
    assert qt.qz_init(qt.QzSession(), device=CPU) == C.QZ_OK
    yield core.engine()
    core.qz_close_engine()


_FORMATS = {"gzip": ("deflate", QzDataFormat.QZ_DEFLATE_GZIP),
            "gzip_ext": ("deflate", QzDataFormat.QZ_DEFLATE_GZIP_EXT),
            "raw": ("deflate", QzDataFormat.QZ_DEFLATE_RAW),
            "4b": ("deflate", QzDataFormat.QZ_DEFLATE_4B),
            "zlib": ("zlib", None), "lz4": ("lz4", None),
            "lz4s": ("lz4s", None)}


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("name", list(_FORMATS))
def test_device_encoder_bytes_equal_reference(corpus_factory, monkeypatch,
                                              cpu_engine, name, level):
    monkeypatch.setenv("QATZIP_TPU_ENCODER", "device")
    algo, fmt = _FORMATS[name]
    data = corpus_factory(30_000, "text")
    sw0 = cpu_engine.sw_requests
    failures0 = health.total_failures
    comp = qt.compress(data, algo, fmt=fmt, level=level, hw_buff_sz=BLK)
    assert comp == qatzip_tpu.compress(data, algo, fmt=fmt, level=level,
                                       hw_buff_sz=BLK)
    assert cpu_engine.sw_requests == sw0
    assert health.total_failures == failures0
    assert qt.decompress(comp, algo, fmt=fmt, hw_buff_sz=BLK,
                         sw_only=True) == data
    if name == "gzip":
        assert gzip.decompress(comp) == data


# ---------------------------------------------------- speculative decoder
def _raw(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


@pytest.fixture
def spec(monkeypatch):
    monkeypatch.setenv("QATZIP_TPU_INFLATE", "spec")


def _spec_inputs(payloads):
    """One spec round's inputs for the first Huffman block of each
    payload, as _run_device_round_spec lays them out."""
    streams = [dd._Stream(p, 0, i) for i, p in enumerate(payloads)]
    for s in streams:
        assert dd._parse_one_header(s) == "huff"
    B = len(streams)
    PB = ((max(map(len, payloads)) + 4 + 127) // 128) * 128 + 128
    pay = np.zeros((B, PB), np.uint8)
    bit0 = np.zeros(B, np.int32)
    tll = np.zeros((B, 1 << 15), np.uint32)
    td = np.zeros((B, 1 << 15), np.uint32)
    for i, s in enumerate(streams):
        pay[i, :len(s.payload)] = np.frombuffer(s.payload, np.uint8)
        bit0[i] = s.bits.pos
        tll[i], td[i] = dd._spec_tables(s)
        rtll, rtd = rdd._spec_tables(s)
        assert (tll[i] == rtll).all() and (td[i] == rtd).all()
    return pay, bit0, tll, td, np.zeros((B, 32768), np.uint8), \
        np.zeros(B, np.int32)


def test_spec_kernel_outputs_equal_reference(corpus_factory):
    """out / out_len / end_bit / err of one round, a corrupt lane
    included."""
    datas = [corpus_factory(3000, "text"), corpus_factory(2000, "constant"),
             corpus_factory(1500, "iterative")]
    payloads = [_raw(d, 9) for d in datas]
    bad = bytearray(payloads[0])
    bad[len(bad) // 2] ^= 0xFF
    payloads.append(bytes(bad))
    ins = _spec_inputs(payloads)
    nbits, outcap = 65536, 4096
    want = rdd._decode_kernel(nbits, outcap)(*(jnp.asarray(a) for a in ins))
    got = dd._decode_kernel(nbits, outcap)(
        *(_t(a.astype(np.int64) if a.dtype == np.uint32 else a) for a in ins))
    for name, w, g in zip(("out", "out_len", "end_bit", "err"), want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and (g == w).all(), name
    assert not got[3][:3].any()
    for i, d in enumerate(datas):
        assert got[0][i, :int(got[1][i])].numpy().tobytes() == d


@pytest.mark.parametrize("kind", ["text", "random", "constant", "iterative"])
@pytest.mark.parametrize("size", [1, 1000, 65536])
def test_spec_inflate_batch_equals_reference(corpus_factory, spec, kind,
                                             size):
    data = corpus_factory(size, kind)
    for level in (1, 9):
        payloads = [_raw(data, level)]
        for ckind in (None, "crc32", "adler32"):
            got = dd.inflate_batch(payloads, [len(data)], CPU, kind=ckind)
            assert got == rdd.inflate_batch(payloads, [len(data)],
                                            kind=ckind)
            assert got[0][0] == data and got[0][1] is True
            if ckind == "crc32":
                assert got[0][2] == zlib.crc32(data)
            elif ckind == "adler32":
                assert got[0][2] == zlib.adler32(data)


def test_spec_stored_multiblock_and_empty(corpus_factory, spec):
    """Stored blocks, a full-flush boundary (copies across it through the
    carried window) and an empty stream."""
    stored = corpus_factory(3000, "random")
    text = corpus_factory(50000, "text")
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    flushed = (co.compress(text[:20000]) + co.flush(zlib.Z_FULL_FLUSH)
               + co.compress(text[20000:]) + co.flush())
    payloads = [_raw(stored, 0), flushed, _raw(b"")]
    hints = [len(stored), len(text), 0]
    for ckind in ("crc32", "adler32"):
        got = dd.inflate_batch(payloads, hints, CPU, kind=ckind)
        assert got == rdd.inflate_batch(payloads, hints, kind=ckind)
    assert [g[0] for g in got] == [stored, text, b""]


def test_spec_mixed_corrupt_and_wide_batches(corpus_factory, spec):
    """A mixed batch, a corrupt stream (None or what zlib reads, as the
    reference) and more than eight streams in one call."""
    datas = [corpus_factory(s, k) for s, k in
             [(100, "text"), (65536, "constant"), (5000, "random"),
              (1, "text")]]
    payloads = [_raw(d, 1) for d in datas]
    got = dd.inflate_batch(payloads, [len(d) for d in datas], CPU,
                           kind="crc32")
    assert got == rdd.inflate_batch(payloads, [len(d) for d in datas],
                                    kind="crc32")
    assert [g[0] for g in got] == datas

    data = corpus_factory(20000, "text")
    bad = bytearray(_raw(data, 6))
    bad[len(bad) // 2] ^= 0xFF
    got = dd.inflate_batch([bytes(bad)], [len(data)], CPU)
    assert got == rdd.inflate_batch([bytes(bad)], [len(data)])

    datas = [corpus_factory(2000 + 97 * i, "text") for i in range(11)]
    payloads = [_raw(d, 6) for d in datas]
    got = dd.inflate_batch(payloads, [len(d) for d in datas], CPU,
                           kind="crc32")
    assert got == rdd.inflate_batch(payloads, [len(d) for d in datas],
                                    kind="crc32")
    assert [g[0] for g in got] == datas


def test_spec_decompress_through_api(corpus_factory, spec, cpu_engine):
    """The API's decompress with the speculative engine: every chunk on
    the device route, the device CRC32s accepted by the framing's checks,
    no lane failed over, for the gzip-ext and 4B framings (zlib members
    are inflated on the host, as in the reference)."""
    data = corpus_factory(60_000, "text")
    for fmt in (QzDataFormat.QZ_DEFLATE_GZIP_EXT, QzDataFormat.QZ_DEFLATE_4B):
        comp = qt.compress(data, fmt=fmt, level=1, hw_buff_sz=16384)
        hw0, sw0 = cpu_engine.hw_requests, cpu_engine.sw_requests
        fail0 = dd.failover_lanes
        assert qt.decompress(comp, fmt=fmt, hw_buff_sz=16384) == data
        assert cpu_engine.hw_requests > hw0
        assert cpu_engine.sw_requests == sw0
        assert dd.failover_lanes == fail0
