"""The pinned 32 MB test corpus: a copy of ``build_corpus`` from the
repository's bench.py, so that the port's card run (chip_smoke.py) needs
nothing of the reference's files.  The same seed gives the same bytes (a
CPU test holds the two equal).
"""
from __future__ import annotations

_SEED = 20260821


def build_corpus(target_mb: int = 32) -> bytes:
    """Pinned deterministic corpus approximating silesia's mix.

    Eight ~256KB segment classes tiled round-robin with a 0.5% pointwise
    mutation per tile (so no two 64KB chunks are byte-identical, matching
    silesia's per-chunk diversity, while compressibility per chunk stays in
    the zlib-L1 ~2.4-3.0 band the north star assumes).
    """
    import numpy as np

    rng = np.random.default_rng(_SEED)
    seg_sz = 256 << 10

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
        # not incompressible — top nibbles are zero, low bits are noise)
        samples = rng.integers(0, 4096, seg_sz // 2, dtype=np.uint16)
        smooth = samples.astype(np.int32)
        smooth[1:] = (smooth[1:] + smooth[:-1]) // 2
        return smooth.astype(np.uint16).view(np.uint8)[:seg_sz]

    # text double-weighted to match silesia's text-heavy profile
    segs = [text_seg(), records_seg(), text_seg(), markup_seg(),
            binary_seg(), log_seg(), b64_seg(), sparse_seg(), xray_seg()]
    target = target_mb << 20
    ntiles = -(-target // seg_sz)
    out = np.empty(ntiles * seg_sz, np.uint8)
    for t in range(ntiles):
        tile = segs[t % len(segs)].copy()
        # 0.5% pointwise mutation so tiles are not byte-identical
        k = len(tile) // 200
        pos = rng.integers(0, len(tile), k)
        tile[pos] = rng.integers(0, 256, k, dtype=np.uint8)
        out[t * seg_sz:(t + 1) * seg_sz] = tile
    return out[:target].tobytes()

