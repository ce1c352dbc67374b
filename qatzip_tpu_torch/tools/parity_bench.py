"""Side-by-side timing of the parity engines' two kernels on a CUDA card.

Builds ``csrc/chain.cu`` and ``csrc/checksum.cu`` of this checkout, and of
each checkout named with ``--against`` (for example an earlier commit
unpacked with ``git archive`` under ``build/``), into libraries of their
own under ``build/parity_bench/``.  Then, in one process, it times each
kernel alone (its C entry point on preallocated arrays, from a CUDA graph
of 10 calls, so without Python's launch cost) in turns, the others first
and then this checkout's, then this checkout's first and the others after
(old, new, new, old), on chip_smoke.py step 7's shapes:

* the chain walk on the device encoder's map of the pinned corpus's first
  128 chunks ([128, 65536], seg 256), a speculative round's map of 8
  zlib-L1 streams of its chunks ([8, 2^18], seg 512), and maps of steps of
  1 at [128, 65536] seg 256, [8, 2^18], [8, 2^19] and [8, 2^20] seg 512
  and [1, 2^22] seg 32; its phases by difference (masks 1, 3, 7);
* the checksums on a ragged [128, 65536] batch in rows 8 bytes wider (the
  encoder's staging) and on 8 full rows of 64 KB (a spec round's output).

Every kernel's output is held against the plain version
(``chain.chain_walk_ref``, ``checksums.*_blocks_ref``); a ``--diag``
checkout (a copy with an edited kernel, e.g. a constant changed) is timed
beside them unchecked.  Last, this
checkout's dependent shared-memory load probe (``chain.probe_clocks``): a
load from the CTA's own shared memory and one from its cluster sibling's,
clocks and ns a load.  One line a shape, the card's name and power limit
first.

    python3 -m qatzip_tpu_torch.tools.parity_bench [--against DIR ...]
        [--diag DIR ...] [--only chain|checksums]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import random
import subprocess
import zlib

import numpy as np
import torch

from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import chain as CH
from qatzip_tpu_torch.ops import checksums as CK

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "parity_bench")
CHUNK = 64 << 10
REPS = 10


def build(roots: dict) -> dict:
    """{label: checkout root} -> {label: (chain library, checksum
    library)}, one nvcc a source, all started together."""
    procs = []
    for label, root in roots.items():
        os.makedirs(os.path.join(OUT, label), exist_ok=True)
        for name in ("chain", "checksum"):
            lib = os.path.join(OUT, label, f"lib{name}.so")
            src = os.path.join(root, "qatzip_tpu_torch", "csrc", f"{name}.cu")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", src, "-o",
                   lib]
            procs.append((label, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    libs: dict = {}
    for label, lib, p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise _build.KernelError(f"nvcc failed for {label}:\n{err}")
        libs.setdefault(label, []).append(ctypes.CDLL(lib))
    return {k: tuple(v) for k, v in libs.items()}


def graph_ms(fn, reps: int = REPS) -> float:
    """Mean device ms a call of fn, from one replay of a CUDA graph of
    reps calls."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _check(rc: int, what: str) -> None:
    if rc:
        raise _build.KernelError(f"{what}: CUDA error {rc}")


def chain_call(lib, f: torch.Tensor, seg: int, mask: int = CH.ALL_PHASES):
    """The output [B, nseg, seg] and a call of lib's qz_chain_walk into
    it (scratch always given: an earlier checkout needs it)."""
    fn = lib.qz_chain_walk
    fn.argtypes = CH.KERNEL.argtypes
    fn.restype = ctypes.c_int
    B, n = f.shape
    out = torch.empty((B, n // seg, seg), dtype=torch.int32, device=f.device)
    ent = torch.empty((B, n // seg), dtype=torch.int32, device=f.device)

    def call(mask: int = mask):
        _check(fn(f.data_ptr(), out.data_ptr(), ent.data_ptr(), B, n, seg,
                  mask, torch.cuda.current_stream().cuda_stream),
               "qz_chain_walk")
    return out, call


def checksum_call(lib, data: torch.Tensor, lens: torch.Tensor, kind: str):
    """The output and a call of lib's qz_checksum (this checkout's entry,
    or the earlier one, with the zero-advance matrices alone and int32
    lengths)."""
    fn = lib.qz_checksum
    fn.restype = ctypes.c_int
    tables = CK._kernel_tables(data.device)
    out = torch.empty(data.shape[0], dtype=torch.int64, device=data.device)
    args = (data.shape[0], CHUNK, int(kind == "adler32"))
    if hasattr(lib, "qz_checksum_plan"):
        fn.argtypes = CK.KERNEL.argtypes
        head = (data.data_ptr(), data.stride(0), lens.data_ptr(), 0,
                tables.data_ptr(), out.data_ptr())
    else:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [
            ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        zadv = tables[CK.TAB_WORDS:]
        head = (data.data_ptr(), data.stride(0), lens.data_ptr(),
                zadv.data_ptr(), out.data_ptr())

    def call():
        _check(fn(*head, *args, torch.cuda.current_stream().cuda_stream),
               "qz_checksum")
    return out, call


def _captured(fn) -> tuple:
    maps = []
    real = CH.chain_walk

    def record(f, seg):
        maps.append((f.to(torch.int32).contiguous(), seg))
        return real(f, seg)

    CH.chain_walk = record
    try:
        fn()
    finally:
        CH.chain_walk = real
    return maps[0]


def chain_cases(corpus: bytes, dev) -> list:
    """(label, map, seg) of step 7's chain-walk shapes."""
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import deflate_encode as de

    blob = np.frombuffer(corpus[:128 * CHUNK], np.uint8).reshape(128, CHUNK)
    data = torch.zeros((128, CHUNK + 8), dtype=torch.uint8, device=dev)
    data[:, :CHUNK] = torch.from_numpy(blob.copy()).to(dev)
    lens = torch.full((128,), CHUNK, dtype=torch.int32, device=dev)
    depth, kwords = de.level_params(1)
    enc = _captured(lambda: de.analyze_blocks(data, lens, depth, kwords))
    payloads = []
    for i in range(8):
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        payloads.append(co.compress(corpus[i * CHUNK:(i + 1) * CHUNK])
                        + co.flush())
    os.environ["QATZIP_TPU_INFLATE"] = "spec"
    try:
        dec = _captured(lambda: dd.inflate_batch(payloads, [CHUNK] * 8, dev,
                                                 kind="crc32"))
    finally:
        os.environ.pop("QATZIP_TPU_INFLATE", None)

    def steps1(B, n):
        return (torch.arange(1, n + 1, dtype=torch.int32, device=dev)
                .expand(B, n).contiguous())

    return [("encoder map", *enc), ("decoder map", *dec),
            ("steps of 1, encoder shape", steps1(128, CHUNK), 256),
            ("steps of 1, [8, 2^18]", steps1(8, 1 << 18), 512),
            ("steps of 1, [8, 2^19]", steps1(8, 1 << 19), 512),
            ("steps of 1, [8, 2^20]", steps1(8, 1 << 20), 512),
            ("steps of 1, [1, 2^22]", steps1(1, 1 << 22), 32)]


def checksum_cases(corpus: bytes, dev) -> list:
    """(label, data, int32 lengths) of step 7's checksum shapes."""
    rng = random.Random(5)
    lens = [rng.randrange(0, CHUNK + 1) for _ in range(128)]
    lens[:3] = [0, 1, CHUNK]
    blob = np.frombuffer(corpus[:128 * CHUNK], np.uint8).reshape(128, CHUNK)
    wide = torch.zeros((128, CHUNK + 8), dtype=torch.uint8, device=dev)
    wide[:, :CHUNK] = torch.from_numpy(blob.copy()).to(dev)
    full = torch.from_numpy(blob[:8].copy()).to(dev)
    return [("ragged [128, 65536]", wide,
             torch.tensor(lens, dtype=torch.int32, device=dev)),
            ("[8, 65536]", full,
             torch.full((8,), CHUNK, dtype=torch.int32, device=dev))]


def probe(dev) -> dict:
    """Clocks and ns a dependent shared-memory load, own and remote: ns by
    the slope of two chases timed with CUDA events."""
    out = {}
    for remote in (False, True):
        clocks = CH.probe_clocks(remote, 1 << 16, dev) / (1 << 16)
        ms = {}
        for steps in (1 << 12, 1 << 16):
            buf = torch.zeros(2, dtype=torch.int64, device=dev)
            ms[steps] = graph_ms(lambda: CH.PROBE(
                buf.data_ptr(), int(remote), steps,
                torch.cuda.current_stream(dev).cuda_stream), 3)
        ns = (ms[1 << 16] - ms[1 << 12]) * 1e6 / ((1 << 16) - (1 << 12))
        out["remote" if remote else "local"] = {"clocks": clocks, "ns": ns}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[],
                    help="roots of other checkouts to build and time")
    ap.add_argument("--diag", nargs="*", default=[],
                    help="roots of edited copies to time unchecked")
    ap.add_argument("--only", choices=("chain", "checksums"),
                    help="time one of the two kernels")
    args = ap.parse_args()
    from qatzip_tpu_torch.tools.corpus import build_corpus

    roots = {os.path.basename(os.path.normpath(r)): r
             for r in args.against + args.diag}
    unchecked = {os.path.basename(os.path.normpath(r)) for r in args.diag}
    roots["this"] = os.path.dirname(_build.PKG)
    libs = build(roots)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    corpus = build_corpus(32)
    order = list(libs) + list(reversed(libs))
    for label, f, seg in ([] if args.only == "checksums" else
                          chain_cases(corpus, dev)):
        want = CH.chain_walk_ref(f, seg)
        calls = {}
        for name, (chain_lib, _) in libs.items():
            out, call = chain_call(chain_lib, f, seg)
            call()
            torch.cuda.synchronize()
            if name not in unchecked and not torch.equal(out, want):
                raise AssertionError(f"{name} != plain on the {label}")
            calls[name] = call
        cells = []
        for name in order:
            call = calls[name]
            upto = {m: graph_ms(lambda m=m: call(m)) for m in (1, 3, 7)}
            cells.append(f"{name} {upto[7]:.4f} (A {upto[1]:.4f}, B "
                         f"{upto[3] - upto[1]:.4f}, C {upto[7] - upto[3]:.4f})")
        print(f"chain walk {label} {tuple(f.shape)} seg {seg}, path "
              f"{CH.check_kernel_limits(f.shape[1], seg)}: ms " +
              "; ".join(cells))
    for label, data, lens in ([] if args.only == "chain" else
                              checksum_cases(corpus, dev)):
        for kind in ("crc32", "adler32"):
            want = getattr(CK, f"{kind}_blocks_ref")(data, lens, CHUNK)
            calls = {}
            for name, (_, ck_lib) in libs.items():
                out, call = checksum_call(ck_lib, data, lens, kind)
                call()
                torch.cuda.synchronize()
                if name not in unchecked and not torch.equal(out, want):
                    raise AssertionError(f"{name} {kind} != plain on "
                                         f"{label}")
                calls[name] = call
            cells = [f"{name} {graph_ms(calls[name], 20):.4f}"
                     for name in order]
            print(f"checksums {kind} {label}, {int(lens.sum())} bytes: ms "
                  + "; ".join(cells))
    for where, rec in ({} if args.only else probe(dev)).items():
        print(f"dependent shared-memory load, {where}: {rec['clocks']:.2f} "
              f"clocks, {rec['ns']:.3f} ns")


if __name__ == "__main__":
    main()
