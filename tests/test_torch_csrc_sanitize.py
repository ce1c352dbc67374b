"""The kernels' host logic under AddressSanitizer and UBSan.

``csrc/inflate_step.cuh``, ``csrc/select.cuh``, ``csrc/lz4_block.cuh``,
``csrc/chain.cuh`` and ``csrc/checksum.cuh`` (with the rest of the host
shim of ``tests/test_torch_csrc_host.py``, which runs their launches
serially) are built by g++ with ``-fsanitize=address,undefined
-fno-sanitize-recover=all`` into a small executable.  It reads rounds from
a file the test writes, each array of a round in an allocation of its own
size, so that a read past a lane's stream words, its table regions, the
CTA's shared memory, a select row or an LZ4 block is reported; it writes the outputs,
which must equal the plain torch versions'.  Any sanitizer report fails
the test.  The rounds: the lockstep layouts with corrupted and idle lanes,
and one lane a round of fuzzed streams (point mutations, truncation,
spliced windows over the first 64 KB of the pinned corpus, from a seed);
select rows at the boundary lengths and with invalid tails; LZ4 and LZ4s
blocks, fuzzed the same way, and the cases at the LZ4 kernel's
shared-memory edges (the match window's wrap, offsets 1 and 65535 across
it, blocks ending at an input refill's boundary), one a round in a row of
exactly its length, its input and window reads checked by the shim's
hooks; the chain walk on every kind of map of tests/test_torch_chain.py,
and the checksums on rows in allocations of exactly their length.
This is the memory-safety check the card's machine cannot give (no
compute-sanitizer there).
"""
import os
import pathlib
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import chain as CH
from qatzip_tpu_torch.ops import checksums as CK
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.ops import inflate as PI
from qatzip_tpu_torch.ops import lz4_decode as LD
from qatzip_tpu_torch.ops import match_finder as mf
from qatzip_tpu_torch.ops import select as SEL
from qatzip_tpu_torch.tools.corpus import build_corpus
from qatzip_tpu_torch.tools import lz4_cases as LC
from tests.test_torch_csrc_host import (_SHIM, _block, _layout,
                                        _lz4_corpus_blocks, _lz4_rows, _raw,
                                        _runs, _same_rows)

torch.set_num_threads(1)

_MAIN = r"""
#include <cstdio>
#include <cstdlib>

// Rounds from argv[1], outputs to argv[2].  A round starts with 8 int32:
// kind 0 (inflate: lanes, nw, max_steps), kind 1 (select: B, n, n_full,
// depth, to_pos, vec), kind 2 (LZ4: one row of n bytes, outcap, lz4s,
// base, len), kind 3 (chain walk: rows, n, seg, share; share 0 the row
// path, else the cluster path at that share) or kind 4 (checksum: one row
// of len bytes, n, kind, CTAs a row), then its arrays; every array is read
// into a vector of its exact size.
template <class T>
static std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) {
    fprintf(stderr, "short read\n");
    exit(3);
  }
  return v;
}

template <class T>
static void put(FILE* f, const std::vector<T>& v) {
  fwrite(v.data(), sizeof(T), v.size(), f);
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  if (!in || !out) return 2;
  int32_t h[8];
  while (fread(h, sizeof(int32_t), 8, in) == 8) {
    if (h[0] == 0) {
      const size_t lanes = h[1], nw = h[2], ms = h[3];
      auto words = take<uint32_t>(in, lanes * nw);
      auto bit0 = take<int32_t>(in, lanes);
      auto nbits = take<int32_t>(in, lanes);
      auto tll = take<uint32_t>(in, lanes * QZ_CELLS);
      auto td = take<uint32_t>(in, lanes * QZ_CELLS);
      auto active = take<int32_t>(in, lanes);
      std::vector<uint32_t> tokens(ms * lanes);
      std::vector<int32_t> err(lanes), outcnt(lanes), end_bit(lanes);
      std::vector<int32_t> ns(1);
      ns[0] = shim_inflate(words.data(), (int)nw, bit0.data(), nbits.data(),
                           tll.data(), td.data(), active.data(), (int)lanes,
                           (int)ms, tokens.data(), err.data(), outcnt.data(),
                           end_bit.data());
      put(out, ns); put(out, tokens); put(out, err); put(out, outcnt);
      put(out, end_bit);
    } else if (h[0] == 3) {
      const size_t rows = h[1], n = h[2], seg = h[3];
      auto f = take<int32_t>(in, rows * n);
      std::vector<int32_t> o(rows * n), ent(rows * (n / seg));
      std::vector<int32_t> met(rows * QZ_CHAIN_CLUSTER_MAX);
      if (h[4])
        shim_chain_cluster(f.data(), o.data(), (int)rows, (int)n, (int)seg,
                           h[4], met.data());
      else
        shim_chain(f.data(), o.data(), ent.data(), (int)rows, (int)n,
                   (int)seg);
      put(out, o);
    } else if (h[0] == 4) {
      const size_t len = h[2];
      auto row = take<uint8_t>(in, len);
      auto tables = take<uint32_t>(in, QZ_CK_TABLE_WORDS);
      std::vector<int32_t> lens(1, (int32_t)len);
      std::vector<int64_t> o(1);
      shim_checksum(row.data(), (int64_t)len, lens.data(), 0, tables.data(),
                    o.data(), 1, h[1], h[3], h[4]);
      put(out, o);
    } else if (h[0] == 2) {
      const size_t n = h[1], outcap = h[2];
      auto row = take<uint8_t>(in, n);
      std::vector<int32_t> len(1, h[5]), tot(1);
      std::vector<uint8_t> o(outcap), err(1);
      std::vector<int64_t> stats(8);
      shim_lz4(row.data(), len.data(), 1, (int)n, (int)outcap, h[3], h[4],
               o.data(), tot.data(), err.data(), stats.data());
      if (stats[2] || stats[4])
        fprintf(stderr, "runtime error: lz4 read %lld input bytes that are "
                "not the block's, %lld window bytes that are not the "
                "output's\n", (long long)stats[2], (long long)stats[4]);
      put(out, tot); put(out, err); put(out, o);
    } else {
      const size_t B = h[1], n = h[2], n_full = h[3];
      auto sk = take<uint32_t>(in, B * n);
      auto sb4 = take<uint32_t>(in, B * n);
      auto sb4b = take<uint32_t>(in, B * n);
      std::vector<unsigned char> o(h[5] ? B * n_full * 2 : B * n * 4);
      std::vector<int32_t> rc(1);
      rc[0] = shim_select(sk.data(), sb4.data(), sb4b.data(), o.data(),
                          (int)B, (int)n, (int)n_full, h[4], h[5], h[6]);
      put(out, rc); put(out, o);
    }
  }
  fclose(out);
  return 0;
}
"""

_SAN = ["-fsanitize=address,undefined", "-fno-sanitize-recover=all"]


@pytest.fixture(scope="module")
def sanitized(tmp_path_factory):
    """Path of the sanitized executable (skips where g++ cannot link the
    sanitizer runtimes)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available to build the sanitized shim")
    d = tmp_path_factory.mktemp("san")
    probe = subprocess.run(["g++", *_SAN, "-x", "c++", "-", "-o",
                            str(d / "probe")], input="int main(){}",
                           capture_output=True, text=True)
    if probe.returncode != 0:
        pytest.skip("g++ lacks the ASan/UBSan runtime: " + probe.stderr[:200])
    return _compile(d)


def _compile(d):
    """Build the sanitized executable in ``d``.  A header placed in ``d``
    takes the place of the one of the same name in csrc/ (the source's own
    directory is searched first)."""
    src = d / "shim_san.cpp"
    src.write_text(_SHIM + _MAIN)
    exe = d / "shim_san"
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-g",
                    "-fno-omit-frame-pointer", *_SAN, "-D__host__=",
                    "-D__device__=", f"-I{_build.CSRC}", f"-I{_build.TOOLS}",
                    str(src), "-o", str(exe)], check=True,
                   capture_output=True, text=True)
    return exe


def _run(exe, tmp_path, rounds):
    """Write ``rounds`` (a list of (header, arrays)), run the executable
    and return its output bytes; any sanitizer report fails."""
    inp, outp = tmp_path / "rounds.bin", tmp_path / "out.bin"
    with open(inp, "wb") as f:
        for header, arrays in rounds:
            np.array(header + [0] * (8 - len(header)), np.int32).tofile(f)
            for a in arrays:
                np.ascontiguousarray(a).tofile(f)
    env = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    proc = subprocess.run([str(exe), str(inp), str(outp)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "runtime error" not in proc.stderr \
        and "Sanitizer" not in proc.stderr, proc.stderr[-4000:]
    return outp.read_bytes()


def _inflate_round(words, bit0, nbits, tll, td, active, max_steps):
    lanes, nw = words.shape
    return ([0, lanes, nw, max_steps],
            [words.astype(np.uint32), bit0.astype(np.int32),
             nbits.astype(np.int32), tll.astype(np.uint32),
             td.astype(np.uint32), active.astype(np.int32)])


def _read_inflate(buf, off, lanes, max_steps):
    """One inflate round's outputs from ``buf`` at ``off``: (tokens, err,
    outcnt, end_bit, nsteps), and the next offset."""
    def take(dtype, n):
        nonlocal off
        a = np.frombuffer(buf, dtype, n, off)
        off += a.nbytes
        return a

    ns = int(take(np.int32, 1)[0])
    tokens = take(np.uint32, max_steps * lanes).reshape(max_steps, lanes)
    err, outcnt, end_bit = (take(np.int32, lanes) for _ in range(3))
    return (tokens, err, outcnt, end_bit, ns), off


def _plain(inputs, max_steps):
    words, bit0, nbits, tll, td, active = inputs
    out = PI._decode_ref(
        torch.from_numpy(np.ascontiguousarray(words).view(np.int32)),
        torch.from_numpy(bit0), torch.from_numpy(nbits),
        torch.from_numpy(tll.view(np.int32)), torch.from_numpy(td.view(
            np.int32)), torch.from_numpy(active) != 0, max_steps)
    return (out[0].numpy().view(np.uint32), out[1].numpy(), out[2].numpy(),
            out[3].numpy(), int(out[4][0]))


def test_inflate_layouts_with_corrupt_and_idle_lanes(sanitized, tmp_path,
                                                     corpus_factory):
    """The host shim's rounds (corrupted and idle lanes at 4 and 37 lanes,
    lanes cut short at the tight word count) under the sanitizers, equal to
    the plain version."""
    datas = [corpus_factory(1500, "text"), corpus_factory(700, "iterative")]
    streams = [_block(_raw(datas[0], 6)), _block(_raw(datas[1], 1,
                                                      zlib.Z_FIXED))]
    streams += [streams[0], streams[0]]
    cut = [_block(_raw(corpus_factory(3000, "text"), 6), k)
           for k in (97, 98, 99, 100, 150, 151, 152, 153)]
    tight = (153 + 3) // 4 + 2
    rounds = [(_layout(streams, lanes, 1024, corrupt=range(2, lanes, 4),
                       idle=range(3, lanes, 4)), 4096) for lanes in (4, 37)]
    rounds += [(_layout(cut, len(cut), nw), 512) for nw in (tight,
                                                            tight + 8)]
    buf = _run(sanitized, tmp_path, [_inflate_round(*inp, ms)
                                     for inp, ms in rounds])
    off = 0
    for inp, ms in rounds:
        got, off = _read_inflate(buf, off, inp[0].shape[0], ms)
        want = _plain(inp, ms)
        assert got[4] == want[4]
        for g, w in zip(got[:4], want[:4]):
            assert (g == w).all()
    assert off == len(buf)


def _fuzzed_lanes(seed: int = 10):
    """First-block lanes of the first 64 KB of the pinned corpus in 4 KB
    chunks at zlib level 1, and three mutated copies of each (1-3 point
    mutations, a truncation, a spliced window), as far as their first block
    header still parses: [(stream after its header, its bytes)]."""
    rng = np.random.default_rng(seed)
    corpus = build_corpus(1)[:1 << 16]
    lanes = []
    for i in range(0, len(corpus), 4096):
        payload = _raw(corpus[i:i + 4096], 1)
        variants = [bytearray(payload) for _ in range(4)]
        for _ in range(int(rng.integers(1, 4))):
            variants[1][int(rng.integers(0, len(payload)))] ^= int(
                rng.integers(1, 256))
        variants[2] = variants[2][:int(rng.integers(8, len(payload)))]
        w = int(rng.integers(4, 64))
        src, dst = (int(rng.integers(0, len(payload) - w)) for _ in range(2))
        variants[3][dst:dst + w] = payload[src:src + w]
        for v in variants:
            s = dd._Stream(bytes(v), 4096, 0)
            try:
                if dd._parse_one_header(s) != "huff":
                    continue
            except (EOFError, ValueError):
                continue
            lanes.append((s, np.frombuffer(bytes(v), np.uint8)[
                s.bits.pos >> 3:]))
    return lanes


def test_inflate_fuzzed_lanes_one_a_round(sanitized, tmp_path):
    """Each fuzzed lane in a round of its own, twice: with its stream words
    exactly the lockstep round's tight count, so a read past them leaves
    the allocation, and padded to the widest lane's count.  Padded, each
    lane equals its column of one plain round over all of them on every
    output; tight, on the error flag, and a lane that does not err (so
    never ran past its stream, where the word clamp moves with the count)
    on every output too."""
    lanes = _fuzzed_lanes()
    ms = 4096
    tight = [(len(pv) + 3) // 4 + 2 for _, pv in lanes]
    nw = max(tight)
    rounds = [_layout([ln], 1, w) for ln, w in zip(lanes, tight)]
    rounds += [_layout([ln], 1, nw) for ln in lanes]
    buf = _run(sanitized, tmp_path, [_inflate_round(*inp, ms)
                                     for inp in rounds])
    want = _plain(_layout(lanes, len(lanes), nw), ms)
    off = 0
    for r in range(len(rounds)):
        i, padded = r % len(lanes), r >= len(lanes)
        (tokens, err, outcnt, end_bit, ns), off = _read_inflate(buf, off, 1,
                                                                ms)
        assert (err[0] != 0) == bool(want[1][i]), (i, padded)
        if padded or not want[1][i]:
            assert (outcnt[0], end_bit[0]) == (want[2][i], want[3][i]), i
            assert (tokens[:, 0] == want[0][:, i]).all(), (i, padded)
    assert off == len(buf)
    errs = int(want[1].sum())
    assert len(lanes) > 40 and 0 < errs < len(lanes)


def test_a_read_past_the_words_is_reported(sanitized, tmp_path,
                                           corpus_factory):
    """The check itself: the shim built from a copy of inflate_step.cuh
    whose ``qz_word`` reads one word further where it clamps to the last
    word fails a one-lane round at the tight word count with a
    heap-buffer-overflow report, so the cases here would see such a read
    in the kernel's own code."""
    good = pathlib.Path(_build.CSRC, "inflate_step.cuh").read_text()
    clamp = "words + (i < nw ? i : nw - 1)"
    assert good.count(clamp) == 1
    d = tmp_path / "mutant"
    d.mkdir()
    (d / "inflate_step.cuh").write_text(
        good.replace(clamp, "words + (i < nw ? i : nw)"))
    exe = _compile(d)
    lane = _block(_raw(corpus_factory(3000, "text"), 6))
    nw = (len(lane[1]) + 3) // 4 + 2
    inp = _layout([lane], 1, nw)
    with pytest.raises(AssertionError, match="heap-buffer-overflow"):
        _run(exe, tmp_path, [_inflate_round(*inp, 4096)])
    # the same round through the kernel's own header runs clean
    _run(sanitized, tmp_path, [_inflate_round(*inp, 4096)])


def test_select_rows_at_boundary_lengths_and_invalid_tails(sanitized,
                                                           tmp_path):
    """Select rows of one chunk each at the boundary lengths (0-13,
    255/256, 4095-4097, 8191, 12288 of a 16 KB row), both orders, and the
    long-run rows with invalid tails: each row in a round of its own, equal
    to the plain versions."""
    corpus = build_corpus(1)
    n_full = 16384
    rows = []
    for length in [0, 1, 2, 3, 4, 5, 11, 12, 13, 255, 256, 4095, 4096,
                   4097, 8191, 12288]:
        arr = np.zeros((1, n_full + 8), np.uint8)
        arr[0, :length] = np.frombuffer(corpus[:length], np.uint8)
        lens = torch.tensor([length], dtype=torch.int32)
        for stride, depth in ((2, 16), (1, 8)):
            rows.append((mf.sorted_records(torch.from_numpy(arr), lens,
                                           stride, True), depth, n_full))
    rows.append((_runs(8), 8, 65536))
    rounds, wants = [], []
    for (sk, sb4, sb4b), depth, full in rows:
        B, n = sk.shape
        arrays = [t.numpy().view(np.uint32) for t in (sk, sb4, sb4b)]
        for to_pos in (0, 1):
            rounds.append(([1, B, n, full, depth, to_pos, int(n % 4 == 0)],
                           arrays))
            wants.append(
                SEL.select_to_positions_ref(sk, sb4, sb4b, depth, full)
                .numpy() if to_pos else
                SEL.select_candidates_ref(sk, sb4, sb4b, depth).numpy())
    buf = _run(sanitized, tmp_path, rounds)
    off = 0
    for (header, _), want in zip(rounds, wants):
        assert np.frombuffer(buf, np.int32, 1, off)[0] == 0
        off += 4
        got = np.frombuffer(buf, want.dtype, want.size, off)
        off += got.nbytes
        assert (got.reshape(want.shape) == want).all(), header
    assert off == len(buf)


def _lz4_rounds(blocks, lz4s: bool, outcap: int):
    """One round a block: its row exactly the block's bytes, so a read at or
    past its length leaves the allocation, and an output of outcap."""
    return [([2, len(b), outcap, int(lz4s), 2, len(b)],
             [np.frombuffer(b, np.uint8)]) for b in blocks]


def _read_lz4(buf, rounds):
    """Each round's (out[1, outcap], tot[1], err[1])."""
    off, got = 0, []
    for header, _ in rounds:
        outcap = header[2]
        tot = np.frombuffer(buf, np.int32, 1, off)
        err = np.frombuffer(buf, np.uint8, 1, off + 4) != 0
        out = np.frombuffer(buf, np.uint8, outcap, off + 5)
        off += 5 + outcap
        got.append((out[None], tot, err))
    assert off == len(buf)
    return got


@pytest.mark.parametrize("lz4s", [False, True])
def test_lz4_fuzzed_blocks_one_a_round(sanitized, tmp_path, lz4s):
    """The fuzz's corpus blocks and 12 mutated copies of each (point flips,
    cuts, zeroed runs, spliced windows, from a seed), each alone in a row
    of its own length with an output of the chunk's 2048 bytes: no
    sanitizer report, and every round equal to the plain version on the
    block zero-padded as decode_blocks lays a group out."""
    rng = np.random.default_rng(11)
    seeds = _lz4_corpus_blocks(lz4s)
    blocks = list(seeds)
    for blk in seeds:
        for _ in range(12):
            blocks.append(LC.mutate(blk, LC.random_mutations(rng)))
    outcap = 2048
    rounds = _lz4_rounds(blocks, lz4s, outcap)
    got = _read_lz4(_run(sanitized, tmp_path, rounds), rounds)
    arr, lens = _lz4_rows(blocks)
    want = [t.numpy() for t in LD._decode_blocks_impl(
        torch.from_numpy(arr), torch.from_numpy(lens), arr.shape[1], outcap,
        lz4s, 2)]
    errs = 0
    for r, (blk, g) in enumerate(zip(blocks, got)):
        assert _same_rows(g, [a[r:r + 1] for a in want]).all(), blk.hex()
        errs += int(g[2][0])
    assert not any(g[2][0] for g in got[:len(seeds)])
    assert 0 < errs < len(blocks)


def test_a_read_past_the_block_is_reported(sanitized, tmp_path):
    """The check itself: the shim built from a copy of lz4_block.cuh whose
    length-extension ballot reads the byte at the block's length fails a
    block that ends inside a 0xFF run with a heap-buffer-overflow report;
    the kernel's own header runs it clean."""
    good = pathlib.Path(_build.CSRC, "lz4_block.cuh").read_text()
    bound = "return i >= len || qz_lz4_get(in, i, w) != 0xFF;"
    assert good.count(bound) == 1
    d = tmp_path / "mutant"
    d.mkdir()
    (d / "lz4_block.cuh").write_text(
        good.replace(bound, "return i > len || qz_lz4_get(in, i, w) != 0xFF;"))
    exe = _compile(d)
    rounds = _lz4_rounds([LC.seq(b"", lit_ext=b"\xff" * 3)], False, 64)
    with pytest.raises(AssertionError, match="heap-buffer-overflow"):
        _run(exe, tmp_path, rounds)
    got = _read_lz4(_run(sanitized, tmp_path, rounds), rounds)
    assert got[0][2][0]


@pytest.mark.parametrize("lz4s", [False, True])
def test_lz4_ring_edges_one_a_round(sanitized, tmp_path, lz4s):
    """tools/lz4_cases.py's shared-memory edge cases (output past the 64 KB
    match window, offsets 1 and 65535 across its edge, one ending at
    MAX_OUT, blocks of exactly 1-4 KB of input, the refill boundaries), its
    edge cases and the LZ4s block of an incompressible 64 KB chunk (65.8 KB,
    past the input ring and the window): each alone in a row of its own
    length, no sanitizer report, and equal to the plain version."""
    from qatzip_tpu_torch.engine.lz4_block import lz4s_block_compress

    rng = np.random.default_rng(14)
    blocks = [b for _, b in LC.ring_edge_blocks()]
    blocks += [b for _, b in LC.edge_blocks() if b]
    blocks.append(lz4s_block_compress(
        rng.integers(0, 256, 1 << 16, np.uint8).tobytes(), 3))
    rounds = _lz4_rounds(blocks, lz4s, LD.MAX_OUT)
    got = _read_lz4(_run(sanitized, tmp_path, rounds), rounds)
    for r, (blk, g) in enumerate(zip(blocks, got)):
        arr, lens = _lz4_rows([blk])
        want = [t.numpy() for t in LD._decode_blocks_impl(
            torch.from_numpy(arr), torch.from_numpy(lens), arr.shape[1],
            LD.MAX_OUT, lz4s, 2)]
        assert _same_rows(g, want).all(), r
        if not g[2][0]:
            assert g[0][0, :g[1][0]].tobytes() == LC.host_decode(
                blk, lz4s, 2, LD.MAX_OUT), r


def _chain_rounds(cases, share: int = 0):
    return [([3, f.shape[0], f.shape[1], seg, share], [np.ascontiguousarray(
        f, np.int32)]) for _, f, seg in cases]


def _read_chain(buf, rounds) -> list:
    off, got = 0, []
    for header, _ in rounds:
        rows, n = header[1], header[2]
        got.append(np.frombuffer(buf, np.int32, rows * n, off))
        off += 4 * rows * n
    assert off == len(buf)
    return got


@pytest.mark.parametrize("share", [0, CH.CLUSTER_SHARE, 512])
def test_chain_walks_of_every_map_kind(sanitized, tmp_path, share):
    """The chain shim on each kind of map of tests/test_torch_chain.py
    (random, steps of 1, all n, the engines' maps) and on rows of one
    segment, each map in an allocation of its own, on the row path's
    three phases (share 0) and the cluster path's (one CTA a row at the
    card's share, up to 8 at 512 words, each CTA's shared memory a vector
    of exactly its bytes): no sanitizer report, equal to
    chain_walk_ref."""
    from tests.test_torch_chain import maps, random_map

    cases = maps() + [("one segment", random_map(3, 512, 4, most=600), 512),
                      ("33 rows", random_map(33, 64, 5, most=70), 32)]
    if share:
        cases = [c for c in cases
                 if CH.cluster_plan(c[1].shape[1], c[2], share)[0]]
        assert len(cases) >= 9
    rounds = _chain_rounds(cases, share)
    got = _read_chain(_run(sanitized, tmp_path, rounds), rounds)
    for (label, f, seg), g in zip(cases, got):
        want = CH.chain_walk_ref(torch.from_numpy(f), seg).numpy()
        assert (g == want.reshape(-1)).all(), label


@pytest.mark.parametrize("share", [0, CH.CLUSTER_SHARE, 512])
def test_chain_maps_outside_the_precondition_stay_in_bounds(sanitized,
                                                            tmp_path, share):
    """Maps that break i < f[i] <= n (values below the position, negative,
    past n, a chain that stands still) on both paths: positions are
    unspecified, but no read leaves the row, the segment or the shared
    memory, and the walk ends."""
    rng = np.random.default_rng(77)
    n = 2048
    cases = [("any int32", rng.integers(-2**31, 2**31, (2, n),
                                        dtype=np.int64).astype(np.int32),
              256),
             ("around n", rng.integers(-40, n + 40, (3, n)).astype(np.int32),
              32),
             ("stands still", np.tile(np.arange(n, dtype=np.int32), (1, 1)),
              64),
             ("backwards", np.tile(np.arange(n, dtype=np.int32) - 5, (2, 1)),
              128)]
    rounds = _chain_rounds(cases, share)
    got = _read_chain(_run(sanitized, tmp_path, rounds), rounds)
    assert [g.size for g in got] == [f.size for _, f, _ in cases]


def test_a_read_past_the_map_is_reported(sanitized, tmp_path):
    """The check itself: the shim built from a copy of chain.cuh whose
    walk also follows f at the segment's end reads f[n] past the last
    row's map (a map that jumps to n at once) and is reported; the
    kernel's own header runs it clean."""
    from tests.test_torch_chain import all_n_map

    good = pathlib.Path(_build.CSRC, "chain.cuh").read_text()
    bound = "if (p < hi) p = f[p < 0 ? 0 : p];"
    assert good.count(bound) == 1
    d = tmp_path / "mutant"
    d.mkdir()
    (d / "chain.cuh").write_text(
        good.replace(bound, "if (p <= hi) p = f[p < 0 ? 0 : p];"))
    exe = _compile(d)
    rounds = _chain_rounds([("all n", all_n_map(1, 256), 256)])
    with pytest.raises(AssertionError, match="heap-buffer-overflow"):
        _run(exe, tmp_path, rounds)
    _run(sanitized, tmp_path, rounds)


@pytest.mark.parametrize("kind", ["crc32", "adler32"])
def test_checksum_rows_of_exactly_their_length(sanitized, tmp_path, kind):
    """The checksum shim on rows in allocations of exactly their length
    (the length sweep, 64 KB and 2 MB rows of 0xFF and of zeros, a row of
    a 2 MB buffer's first 65537 bytes), sliced as the launch would for
    one row (8 CTAs), over 1 CTA and over 8: no sanitizer report, equal to
    zlib."""
    rng = np.random.default_rng(31)
    rows = [rng.integers(0, 256, k, dtype=np.uint8)
            for k in list(range(0, 70)) + [255, 256, 257, 1023, 1024, 1025,
                                           4097, 65535, 65536]]
    rows += [np.full(k, v, np.uint8) for k in (65536, 1 << 21)
             for v in (0xFF, 0)]
    rows.append(np.full(65537, 0xFF, np.uint8))
    tables = CK.kernel_tables()
    rounds = [([4, max(len(r), 1 << 21), len(r), int(kind == "adler32"), p],
               [r, tables]) for p in (0, 1, 8) for r in rows]
    buf = _run(sanitized, tmp_path, rounds)
    got = np.frombuffer(buf, np.int64).tolist()
    assert got == [getattr(zlib, kind)(r.tobytes()) for r in rows] * 3
