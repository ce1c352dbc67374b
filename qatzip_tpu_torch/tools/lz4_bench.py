"""Side-by-side timing of the LZ4 / LZ4s block-decode kernel on a CUDA card.

Builds ``qatzip_tpu_torch/csrc/lz4_block.cu`` of this checkout, and of each
checkout named with ``--against`` (for example an earlier commit unpacked
with ``git archive`` under ``build/``), each into a library of its own under
``build/lz4_bench/``.  Then, in one process, it times each kernel alone
(the C entry point on preallocated arrays, mean of 5 calls after a warm-up,
CUDA events) in turns, the others first and then this checkout's, then
this checkout's first and the others after (old, new, new, old), on
chip_smoke.py's step 2 launches, made the same way from the pinned 32 MB
corpus at 64 KB chunks: the first 128 LZ4 level-1 blocks, 128 LZ4s blocks
of incompressible chunks, the edge cases with mutated blocks as LZ4 and as
LZ4s, and every compressed block of the 32 MB LZ4 frame in one launch (the
request's).  Each kernel's result is held against the plain version
(``lz4_decode._decode_blocks_impl``, groups of ``GROUP`` rows): err on
every row, tot and the bytes on every clear row.  A ``--diag`` checkout
(a copy with an edited kernel, e.g. one that skips a stage to see what it
costs) is timed beside them unchecked.

    python3 -m qatzip_tpu_torch.tools.lz4_bench [--against DIR ...]
        [--diag DIR ...]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import lz4_decode as ld

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "lz4_bench")
CHUNK = 64 << 10
SEED = 10   # chip_smoke.py's EDGE_SEED


def build(roots: dict) -> dict:
    """{label: checkout root} -> {label: qz_lz4_decode of that checkout},
    one nvcc each, all started together."""
    procs = {}
    for label, root in roots.items():
        os.makedirs(os.path.join(OUT, label), exist_ok=True)
        lib = os.path.join(OUT, label, "liblz4.so")
        src = os.path.join(root, "qatzip_tpu_torch", "csrc", "lz4_block.cu")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", src, "-o", lib]
        procs[label] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for label, (lib, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise _build.KernelError(f"nvcc failed for {label}:\n{err}")
        fn = ctypes.CDLL(lib).qz_lz4_decode
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def launches(corpus: bytes) -> list:
    """(label, blocks, lz4s) of chip_smoke.py's step 2 launches."""
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.tools import lz4_cases as LC

    chunks, blocks = [], []
    for i in range(0, len(corpus), CHUNK):
        blk = dd._native.lz4_compress_block(corpus[i:i + CHUNK])
        if len(blk) < CHUNK:
            chunks.append(corpus[i:i + CHUNK])
            blocks.append(blk)
    rng = np.random.default_rng(SEED)
    rand = [rng.integers(0, 256, CHUNK, np.uint8).tobytes()
            for _ in range(ld.GROUP)]
    out = [("lz4 L1", blocks[:ld.GROUP], False),
           ("lz4s incompressible",
            [dd._native.lz4s_compress_block(c, 3) for c in rand], True)]
    edges = [b for _, b in LC.edge_blocks()]
    for lz4s in (False, True):
        good = (blocks[:16] if not lz4s else
                [dd._native.lz4s_compress_block(c, 3) for c in chunks[:16]])
        fuzz = [LC.mutate(good[i % 16], LC.random_mutations(rng))
                for i in range(64)]
        out.append(("edges and fuzz " + ("lz4s" if lz4s else "lz4"),
                    edges + fuzz, lz4s))
    out.append(("lz4 L1 request", blocks, False))
    return out


def rows(blocks: list, dev) -> tuple:
    """Blocks zero-padded into uint8[B, n] on dev, their int32 lengths, n."""
    n = ld._next_pow2(max(len(b) for b in blocks) + 8, 1024)
    arr = np.zeros((len(blocks), n), np.uint8)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    lens = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    return torch.from_numpy(arr).to(dev), lens.to(dev), n


def plain(b, lens, n: int, lz4s: bool) -> list:
    """The plain version, GROUP rows a call, on the card."""
    parts = [ld._decode_blocks_impl(b[g:g + ld.GROUP], lens[g:g + ld.GROUP],
                                    n, ld.MAX_OUT, lz4s, 2)
             for g in range(0, b.shape[0], ld.GROUP)]
    return [torch.cat(x).cpu() for x in zip(*parts)]


def kernel_call(fn, b, lens, n: int, lz4s: bool):
    """Output arrays and a call that decodes b into them with fn."""
    B = b.shape[0]
    out = torch.zeros((B, ld.MAX_OUT), dtype=torch.uint8, device=b.device)
    tot = torch.empty(B, dtype=torch.int32, device=b.device)
    err = torch.empty(B, dtype=torch.bool, device=b.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(b.data_ptr(), lens.data_ptr(), out.data_ptr(),
                tot.data_ptr(), err.data_ptr(), B, n, ld.MAX_OUT, int(lz4s),
                2, stream)
        if rc:
            raise _build.KernelError(f"qz_lz4_decode: CUDA error {rc}")
    return (out, tot, err), call


def same(got: list, want: list) -> bool:
    """err equal on every row; tot and bytes on every clear row."""
    if not torch.equal(got[2], want[2]):
        return False
    for r in torch.nonzero(~want[2]).flatten().tolist():
        t = int(want[1][r])
        if int(got[1][r]) != t or not torch.equal(got[0][r, :t],
                                                  want[0][r, :t]):
            return False
    return True


def time_ms(fn, reps: int = 5) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[],
                    help="roots of other checkouts to build and time")
    ap.add_argument("--diag", nargs="*", default=[],
                    help="roots of edited copies to time unchecked")
    args = ap.parse_args()
    from qatzip_tpu_torch.tools.corpus import build_corpus

    roots = {os.path.basename(os.path.normpath(r)): r
             for r in args.against + args.diag}
    roots["this"] = os.path.dirname(_build.PKG)
    unchecked = {os.path.basename(os.path.normpath(r)) for r in args.diag}
    fns = build(roots)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    for label, blocks, lz4s in launches(build_corpus(32)):
        b, lens, n = rows(blocks, dev)
        want = plain(b, lens, n, lz4s)
        calls = {}
        for name, fn in fns.items():
            outs, call = kernel_call(fn, b, lens, n, lz4s)
            call()
            torch.cuda.synchronize()
            if name not in unchecked and not same([t.cpu() for t in outs],
                                                  want):
                raise AssertionError(f"{name} != plain on {label}")
            calls[name] = call
        order = list(calls) + list(reversed(calls))
        cells = [f"{name} {time_ms(calls[name]):.4f}" for name in order]
        print(f"{label}: {len(blocks)} blocks, n {n}, "
              f"{int(want[2].sum())} flagged; ms: " + "; ".join(cells))


if __name__ == "__main__":
    main()
