"""The silesia-like request data, made from the run's seed.

A frozen copy of the generator in ``qatzip_tpu_torch/tools/corpus.py``
(itself a copy of ``build_corpus`` in the repository's bench.py): the same
nine segment classes, the same weights (text twice) and the same 0.5%
pointwise mutation of every 256 KB tile.  The nine segments come from that
generator's pinned seed, so that they are its segments, byte for byte;
the mutations come from (seed, client), so that each client of a run sends
its own distinct input and the same seed gives the same bytes.  The
segments stay pinned because the seed should not change the work: segments
drawn from the run's seed made one seed's gzip-ext compress requests run
1.5x as fast as another's, on both of two runs of each (PERF.md, PR 22).
"""
from __future__ import annotations

import functools

import numpy as np

SEG_SZ = 256 << 10
_SEED = 20260821      # tools/corpus.py's


def build(seed: int, client: int, nbytes: int) -> bytes:
    """``nbytes`` of silesia-like data for ``client`` of a run at ``seed``."""
    segs = _segments()
    rng = np.random.default_rng([seed & ((1 << 64) - 1), client])
    seg_sz = SEG_SZ
    ntiles = -(-nbytes // seg_sz)
    out = np.empty(ntiles * seg_sz, np.uint8)
    for t in range(ntiles):
        tile = segs[t % len(segs)].copy()
        # 0.5% pointwise mutation so tiles are not byte-identical
        k = len(tile) // 200
        pos = rng.integers(0, len(tile), k)
        tile[pos] = rng.integers(0, 256, k, dtype=np.uint8)
        out[t * seg_sz:(t + 1) * seg_sz] = tile
    return out[:nbytes].tobytes()


@functools.cache
def _segments() -> tuple:
    """The nine segments, drawn from the pinned seed in the original's
    order."""
    rng = np.random.default_rng(_SEED)
    seg_sz = SEG_SZ

    def _take(parts, tot=seg_sz):
        a = np.concatenate(parts)
        reps = -(-tot // len(a))
        return np.tile(a, reps)[:tot] if reps > 1 else a[:tot]

    def text_seg():
        # zipf-ish word stream (the dickens/webster role)
        nwords = 4096
        words = [rng.integers(97, 123, rng.integers(2, 12),
                              dtype=np.uint8) for _ in range(nwords)]
        space = np.array([32], np.uint8)
        nl = np.array([10], np.uint8)
        idx = (rng.random(seg_sz // 4) ** 3 * nwords).astype(np.int64)
        parts = []
        for k, i in enumerate(idx):
            parts.append(words[i])
            parts.append(nl if k % 13 == 12 else space)
        return _take(parts)

    def records_seg():
        # CSV-ish numeric records (the sao/nci role)
        rows = []
        base = rng.integers(0, 1000000)
        for r in range(4000):
            rows.append(f"{base + r},{r % 97},{(r * 31) % 1013},"
                        f"item-{r % 50:04d},OK\n".encode())
        return _take([np.frombuffer(b"".join(rows), np.uint8)])

    def markup_seg():
        # XML-ish (the xml role)
        rows = []
        for r in range(3000):
            rows.append(f"<row id=\"{r}\"><v>{(r * 7) % 991}</v>"
                        f"<name>node{r % 211}</name></row>\n".encode())
        return _take([np.frombuffer(b"".join(rows), np.uint8)])

    def binary_seg():
        # executable-like: skewed byte histogram + zero runs (mozilla role)
        raw = rng.integers(0, 256, seg_sz, dtype=np.int64)
        skew = (raw * raw // 256 % 256).astype(np.uint8)
        out = skew.copy()
        starts = rng.integers(0, seg_sz - 64, 2000)
        for s in starts:
            out[s:s + rng.integers(8, 64)] = 0
        return out

    def log_seg():
        rows = []
        t = 1700000000
        for r in range(3000):
            t += int(rng.integers(1, 30))
            lvl = ("INFO", "WARN", "DEBUG")[r % 3]
            rows.append(f"{t} {lvl} svc{r % 17}: request {r} done "
                        f"in {int(rng.integers(1, 500))}us code=200\n".encode())
        return _take([np.frombuffer(b"".join(rows), np.uint8)])

    def b64_seg():
        # base64-ish: printable, high-entropy (hard-to-compress text)
        al = np.frombuffer(
            b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/",
            np.uint8)
        return al[rng.integers(0, 64, seg_sz)]

    def sparse_seg():
        out = np.zeros(seg_sz, np.uint8)
        starts = rng.integers(0, seg_sz - 128, 800)
        for s in starts:
            ln = int(rng.integers(16, 128))
            out[s:s + ln] = rng.integers(0, 256, ln, dtype=np.uint8)
        return out

    def xray_seg():
        # 12-bit sensor samples in 16-bit words (the x-ray role: hard but
        # not incompressible: top nibbles are zero, low bits are noise)
        samples = rng.integers(0, 4096, seg_sz // 2, dtype=np.uint16)
        smooth = samples.astype(np.int32)
        smooth[1:] = (smooth[1:] + smooth[:-1]) // 2
        return smooth.astype(np.uint16).view(np.uint8)[:seg_sz]

    # text double-weighted to match silesia's text-heavy profile
    segs = (text_seg(), records_seg(), text_seg(), markup_seg(),
            binary_seg(), log_seg(), b64_seg(), sparse_seg(), xray_seg())
    for seg in segs:
        seg.flags.writeable = False
    return segs
