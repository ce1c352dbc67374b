"""The inputs are the same bytes from the same seed, and differ by client
and by seed."""
import hashlib

import pytest

from qzbench import corpus, gzipext, lz4plain
from qzbench.refs import gzip_ext, lz4_frame

BIG = 2**31 + 4099


def _h(b):
    return hashlib.sha256(b).hexdigest()


def test_corpus_same_seed_same_bytes():
    a = corpus.build(BIG, 0, 600 << 10)
    assert len(a) == 600 << 10
    assert corpus.build(BIG, 0, 600 << 10) == a


def test_corpus_differs_by_client_and_seed():
    a = corpus.build(BIG, 0, 256 << 10)
    assert corpus.build(BIG, 1, 256 << 10) != a
    assert corpus.build(BIG + 1, 0, 256 << 10) != a
    # a negative or huge seed is a seed too
    assert len(corpus.build(-5, 0, 1000)) == 1000
    assert len(corpus.build(2**63 + 1, 0, 1000)) == 1000


def test_corpus_segments_are_the_pinned_generator_s():
    # a test may read the program's generator; the benchmark does not
    import numpy as np

    from qatzip_tpu_torch.tools import corpus as original

    ours = np.frombuffer(corpus.build(BIG, 1, 18 * corpus.SEG_SZ), np.uint8)
    theirs = np.frombuffer(original.build_corpus(5)[:18 * corpus.SEG_SZ],
                           np.uint8)
    # the same tiles, each mutated at 0.5% of its bytes by either side
    assert 0.002 < (ours != theirs).mean() < 0.012


def test_corpus_keeps_the_segment_mix():
    # nine 256 KB segment classes a round, each compressing in its band
    import zlib

    data = corpus.build(7, 3, 9 * corpus.SEG_SZ)
    ratios = [len(s) / len(zlib.compress(s, 1)) for s in
              (data[i:i + corpus.SEG_SZ]
               for i in range(0, len(data), corpus.SEG_SZ))]
    assert len(ratios) == 9
    assert 1.8 < len(data) / sum(len(data) / r for r in ratios) * 9 < 2.6


@pytest.mark.parametrize("ref", [gzip_ext, lz4_frame])
def test_compressed_input_same_seed_same_bytes(ref):
    data = corpus.build(BIG, 2, 200 << 10)
    a = ref.make(data, 65536)
    assert _h(ref.make(data, 65536)) == _h(a)
    assert ref.read(a) == data


def test_gzip_input_is_zlib_level_1():
    data = corpus.build(3, 0, 100 << 10)
    stream = gzip_ext.make(data, 65536)
    first = gzipext.member(data[:65536], gzipext.deflate_l1(data[:65536]))
    assert stream.startswith(first)


def test_lz4_input_is_one_frame_a_chunk():
    data = corpus.build(3, 0, 130 << 10)
    stream = lz4_frame.make(data, 65536)
    assert stream.count(lz4plain.MAGIC.to_bytes(4, "little")) >= 3
    assert lz4plain.read_frames(stream) == data
