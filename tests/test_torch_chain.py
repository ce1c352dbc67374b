"""The chain walk of the parity engines (qatzip_tpu_torch/ops/chain.py).

``chain_walk_ref`` holds the loops that the device encoder's greedy parse
and the speculative decoder's symbol chain ran (the reference's two
``lax.scan`` walks); here it is held against an independent sequential walk
(from 0, follow f until n) on seeded random maps, maps of steps of 1, maps
that jump to n everywhere, and the maps the engines really build: a K1
batch of the conftest corpora and a speculative round of their zlib
streams.  ``chain_walk`` runs it for CPU tensors and raises for a device
without the kernel.  The kernel's own logic (csrc/chain.cuh) is held
against ``chain_walk_ref`` in tests/test_torch_csrc_host.py, and the
engines' arrays against the reference's in tests/test_torch_parity.py.
"""
import random
import zlib

import numpy as np
import pytest
import torch

from conftest import make_corpus
from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import chain
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.ops import deflate_encode as de

torch.set_num_threads(1)


def _capture(fn) -> list:
    """The maps fn hands to chain.chain_walk, as (int32 array, seg)."""
    maps = []
    real = chain.chain_walk

    def record(f, seg):
        maps.append((f.to(torch.int32).numpy().copy(), seg))
        return real(f, seg)

    chain.chain_walk = record
    try:
        fn()
    finally:
        chain.chain_walk = real
    return maps


def encoder_map(n: int = 4096, lz4_rules: bool = False):
    """The greedy parse's map of a K1 batch of the conftest corpora at n,
    ragged lengths, level 1."""
    rng = random.Random(0xC0FFEE)
    datas = [make_corpus(rng, n, "text"), make_corpus(rng, n - 1000, "random"),
             make_corpus(rng, n, "constant"),
             make_corpus(rng, 777, "iterative"), b""]
    data = np.zeros((len(datas), n + 8), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        data[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    depth, kwords = de.level_params(1)
    (got,) = _capture(lambda: de.analyze_blocks(
        torch.from_numpy(data), torch.from_numpy(lens), depth, kwords,
        lz4_rules=lz4_rules))
    assert got[1] == de.SEG
    return got


def decoder_map(nbits: int = 8192):
    """The speculative decoder's map of one round: the first Huffman block
    of zlib streams of the conftest corpora, and a corrupted one."""
    rng = random.Random(7)
    payloads = []
    for size, kind, level in ((1500, "text", 9), (3000, "constant", 6),
                              (900, "iterative", 1)):
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        payloads.append(co.compress(make_corpus(rng, size, kind))
                        + co.flush())
    bad = bytearray(payloads[0])
    bad[len(bad) // 2] ^= 0xFF
    payloads.append(bytes(bad))
    B = len(payloads)
    PB = ((max(map(len, payloads)) + 4 + 127) // 128) * 128 + 128
    assert PB * 8 <= nbits
    pay = np.zeros((B, PB), np.uint8)
    bit0 = np.zeros(B, np.int32)
    tll = np.zeros((B, 1 << 15), np.int64)
    td = np.zeros((B, 1 << 15), np.int64)
    for i, p in enumerate(payloads):
        s = dd._Stream(p, 0, i)
        assert dd._parse_one_header(s) == "huff"
        pay[i, :len(p)] = np.frombuffer(p, np.uint8)
        bit0[i] = s.bits.pos
        tll[i], td[i] = dd._spec_tables(s)
    ins = [torch.from_numpy(a) for a in (
        pay, bit0, tll, td, np.zeros((B, 32768), np.uint8),
        np.zeros(B, np.int32))]
    (got,) = _capture(lambda: dd._decode_kernel_impl(*ins, nbits=nbits,
                                                     outcap=4096))
    assert got[1] == dd.SEG
    return got


def random_map(B: int, n: int, seed: int, most: int = 300) -> np.ndarray:
    """Seeded steps of 1 to ``most`` positions, clamped to n."""
    rng = np.random.default_rng(seed)
    pos = np.arange(n)[None, :]
    return np.minimum(pos + rng.integers(1, most + 1, (B, n)), n).astype(
        np.int32)


def step1_map(B: int, n: int) -> np.ndarray:
    return np.broadcast_to(np.arange(1, n + 1, dtype=np.int32),
                           (B, n)).copy()


def all_n_map(B: int, n: int) -> np.ndarray:
    return np.full((B, n), n, np.int32)


def maps() -> list:
    """(label, map, seg) for every kind of map these tests take."""
    return [("random", random_map(3, 4096, 1), 256),
            ("random short steps", random_map(2, 2048, 2, most=3), 512),
            ("random seg 32", random_map(2, 512, 3, most=40), 32),
            ("steps of 1", step1_map(2, 1024), 256),
            ("steps of 1, seg 512", step1_map(1, 2048), 512),
            ("all n", all_n_map(2, 1024), 256),
            ("encoder", *encoder_map()),
            ("encoder, LZ4 rules", *encoder_map(lz4_rules=True)),
            ("decoder", *decoder_map())]


def sequential_walk(f: np.ndarray, seg: int) -> np.ndarray:
    """The walk's definition, one row at a time: the chain from 0 (follow
    f until n); row s of a segment holds the chain's positions inside the
    segment, in order, then the first chain position past it."""
    B, n = f.shape
    out = np.empty((B, n // seg, seg), np.int32)
    for b in range(B):
        pos = [0]
        while pos[-1] < n:
            pos.append(int(f[b, pos[-1]]))
        pos = np.asarray(pos)
        for s in range(n // seg):
            lo, hi = s * seg, (s + 1) * seg
            inside = pos[(pos >= lo) & (pos < hi)]
            out[b, s] = pos[pos >= hi][0]
            out[b, s, :len(inside)] = inside
    return out


@pytest.fixture(scope="module")
def all_maps():
    return maps()


@pytest.mark.parametrize("k", range(9))
def test_chain_walk_ref_equals_the_sequential_walk(all_maps, k):
    label, f, seg = all_maps[k]
    got = chain.chain_walk_ref(torch.from_numpy(f), seg)
    assert got.dtype == torch.int32
    assert got.shape == (f.shape[0], f.shape[1] // seg, seg)
    assert (got.numpy() == sequential_walk(f, seg)).all(), label


def test_engine_maps_keep_the_walks_precondition(all_maps):
    """Each map the engines build moves every position forward, at most
    to n (the kernel's precondition), and the decoder's chain really
    leaves the segments at their starts."""
    for label, f, _ in all_maps:
        n = f.shape[1]
        pos = np.arange(n)[None, :]
        assert ((f > pos) & (f <= n)).all(), label


def test_chain_walk_runs_the_plain_version_on_the_cpu(all_maps):
    n0 = chain.KERNEL.launches
    for label, f, seg in all_maps:
        t = torch.from_numpy(f)
        assert torch.equal(chain.chain_walk(t, seg),
                           chain.chain_walk_ref(t, seg)), label
        assert torch.equal(chain.chain_walk(t.long(), seg),
                           chain.chain_walk_ref(t, seg)), label
    assert chain.KERNEL.launches == n0


def test_chain_walk_raises_for_a_device_without_the_kernel():
    """No quiet fallback: a tensor off the CPU that is not a CUDA tensor
    raises, as a CUDA tensor would if the kernel could not run."""
    f = torch.empty((2, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(_build.KernelError, match="no chain kernel"):
        chain.chain_walk(f, 256)


@pytest.mark.parametrize("n,seg", [(1024, 16), (1024, 48), (4096, 2048),
                                   (1000, 256), (0, 256)])
def test_kernel_limits_refuse_other_shapes(n, seg):
    with pytest.raises(ValueError):
        chain.check_kernel_limits(n, seg)


@pytest.mark.parametrize("n,seg", [(256, 256), (65536, 256), (1 << 19, 512),
                                   (1 << 23, 512), (64, 32)])
def test_kernel_limits_take_the_engines_shapes(n, seg):
    chain.check_kernel_limits(n, seg)


@pytest.mark.parametrize("n,seg,path", [
    (65536, 256, "cluster"), (1 << 18, 512, "cluster"), (4096, 256, "cluster"),
    (1 << 19, 512, "cluster"), (1 << 18, 64, "cluster"), (1 << 17, 32, "cluster"),
    (1 << 20, 512, "rows"), (1 << 19, 64, "rows"), (1 << 22, 32, "rows"),
    (1 << 23, 512, "rows")])
def test_kernel_limits_name_the_path(n, seg, path):
    """The documented cut between the kernel's two paths: rows of up to
    16 * min(32768, 256 * seg) positions take one cluster launch (the
    encoder's 2^16 and the decoder's rounds up to 2^19), longer rows the
    three-launch row path."""
    assert chain.check_kernel_limits(n, seg) == path
    c, spc = chain.cluster_plan(n, seg)
    assert (c > 0) == (path == "cluster")
    if c:
        assert c <= chain.CLUSTER_MAX and spc * seg <= chain.CLUSTER_SHARE
        assert (c - 1) * spc < n // seg <= c * spc


def test_chain_walk_refuses_other_types():
    with pytest.raises(ValueError):
        chain.chain_walk(torch.zeros((2, 512), dtype=torch.float32), 256)
    with pytest.raises(ValueError):
        chain.chain_walk(torch.zeros(512, dtype=torch.int32), 256)
