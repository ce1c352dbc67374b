"""Side-by-side timing of the select kernel on a CUDA card.

Builds ``qatzip_tpu_torch/csrc/select.cu`` of this checkout, its variant
without the shared-memory tile (``tools/select_l1.cu``: every neighbour read
through L1) and ``csrc/select.cu`` of each checkout named with
``--against`` (for example an earlier commit unpacked with ``git archive``
under ``build/``), each into a library of its own under
``build/select_bench/``.  On the sorted records of the first 128 chunks of
the 32 MB corpus, at depth 16 / stride 2 (the L1 path) and depth 8 / stride
1, it then times in turns, twice, with CUDA events (mean of 50 calls after a
warm-up):

* each library's sorted-order entry alone (``qz_select_candidates``);
* the position-order entry with its memset (``qz_select_to_positions``),
  where the library has it;
* for a library without it, the chain that entry replaces: its sorted-order
  kernel, then ``ops/select.to_positions`` (an index ``where``, ``zeros`` +
  ``scatter_``, a slice and a cast);

and checks that every output equals the plain version.  It prints each
time beside the bound of :func:`work` (bytes at the HBM rate, the
look-back's operations at the float32 rate).  A checkout named with
``--diag`` (a copy with a kernel edited for a measurement, which may change
its output) is built and timed the same way, unchecked.

    python3 -m qatzip_tpu_torch.tools.select_bench [--against DIR ...]
        [--diag DIR ...]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import select as S
from qatzip_tpu_torch.tools.h100 import FP32_OPS_S, HBM_BYTES_S

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "select_bench")
L1_SRC = os.path.join(_build.PKG, "tools", "select_l1.cu")
CHUNK = 64 << 10
CASES = ((16, 2), (8, 1))          # (depth, stride)
OPS_A_STEP = 12                    # integer operations a neighbour visited


def lookback_steps(sk: torch.Tensor, sb4: torch.Tensor, sb4b: torch.Tensor,
                   depth: int) -> int:
    """Neighbours the kernel's look-back visits on these rows (plain torch):
    every valid record reads neighbour dd until one with another hash, a
    distance past 32767 or an 8-byte match stops it (csrc/select.cuh); the
    row's start reads as another hash."""
    cur_h = (sk >> 16) & 0xFFFF
    cur_pos = sk & 0xFFFF
    alive = sk != -1
    steps = 0
    for dd in range(1, depth + 1):
        steps += int(alive.sum())
        ck = S._shift_right(sk, dd, -1)
        dist = cur_pos - (ck & 0xFFFF)
        eq8 = ((S._shift_right(sb4, dd, 0) == sb4)
               & (S._shift_right(sb4b, dd, 0) == sb4b))
        alive = (alive & (((ck >> 16) & 0xFFFF) == cur_h) & (dist <= 32767)
                 & ~eq8)
    return steps


def work(sk, sb4, sb4b, depth: int, n_full: int | None = None) -> dict:
    """The least the card could do for one call: each input read once, each
    output written once (int32 a record in sorted order, uint16 a column in
    position order), and the look-back's operations on these rows.
    Returns bytes, operations, steps and the bound in ms."""
    nrec = sk.numel()
    out_bytes = 4 * nrec if n_full is None else 2 * sk.shape[0] * n_full
    nbytes = 12 * nrec + out_bytes
    steps = lookback_steps(sk, sb4, sb4b, depth)
    ops = OPS_A_STEP * steps
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / FP32_OPS_S * 1e3
    return {"bytes": nbytes, "ops": ops, "steps": steps,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def build(srcs: dict) -> dict:
    """{label: select source} -> {label: its library}, built together."""
    procs = {}
    for label, src in srcs.items():
        os.makedirs(os.path.join(OUT, label), exist_ok=True)
        lib = os.path.join(OUT, label, "libselect.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
               "-shared", src, "-o", lib]
        procs[label] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (lib, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise _build.KernelError(f"nvcc failed for {label}:\n{err}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in err.splitlines()
                if "Used " in ln and "registers" in ln]
        print(f"{label}: ptxas {', '.join(regs)} (a kernel each)")
        libs[label] = ctypes.CDLL(lib)
    return libs


def _fn(lib, symbol: str, nint: int):
    fn = getattr(lib, symbol, None)
    if fn is not None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * nint + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _rc(rc: int, what: str) -> None:
    if rc:
        raise _build.KernelError(f"{what}: CUDA error {rc}")


def calls(lib, t: list, depth: int, n_full: int) -> dict:
    """{what: (call, result)} for one library on the records t: the
    sorted-order entry, and the position-order entry or, without it, the
    chain it replaces.  result() is the last call's output."""
    sk, sb4, sb4b = t
    B, n = sk.shape
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [x.data_ptr() for x in t]
    sorted_fn = _fn(lib, "qz_select_candidates", 3)
    pos_fn = _fn(lib, "qz_select_to_positions", 4)
    out = torch.empty_like(sk)
    last = {}

    def sorted_call():
        _rc(sorted_fn(*ptrs, out.data_ptr(), B, n, depth, stream), "sorted")

    def pos_call():
        pos = torch.zeros((B, n_full), dtype=torch.int16, device=sk.device)
        _rc(pos_fn(*ptrs, pos.data_ptr(), B, n, n_full, depth, stream),
            "positions")
        last["pos"] = pos

    def chain_call():
        dist = torch.empty_like(sk)
        _rc(sorted_fn(*ptrs, dist.data_ptr(), B, n, depth, stream), "chain")
        last["pos"] = S.to_positions(sk, dist, n_full).view(torch.int16)

    got = {"sorted": (sorted_call, lambda: out)}
    if pos_fn is not None:
        got["positions"] = (pos_call, lambda: last["pos"])
    else:
        got["chain"] = (chain_call, lambda: last["pos"])
    return got


def time_ms(fn, reps: int = 50) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def records(corpus: bytes, stride: int, dev) -> tuple:
    """The match finder's sorted records of the corpus's first 128 chunks."""
    import numpy as np

    from qatzip_tpu_torch.ops import match_finder as mf

    arr = np.frombuffer(corpus[:128 * CHUNK], np.uint8).reshape(128, CHUNK)
    data = torch.zeros((128, CHUNK + 8), dtype=torch.uint8, device=dev)
    data[:, :CHUNK] = torch.from_numpy(arr.copy()).to(dev)
    lens = torch.full((128,), CHUNK, dtype=torch.int32, device=dev)
    return mf.sorted_records(data, lens, stride, True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[],
                    help="roots of other checkouts to build and time")
    ap.add_argument("--diag", nargs="*", default=[],
                    help="roots of edited copies to build and time unchecked")
    args = ap.parse_args()
    srcs = {"this": os.path.join(_build.CSRC, "select.cu"), "l1": L1_SRC}
    srcs.update({os.path.basename(os.path.normpath(r)):
                 os.path.join(r, "qatzip_tpu_torch", "csrc", "select.cu")
                 for r in args.against + args.diag})
    unchecked = {os.path.basename(os.path.normpath(r)) for r in args.diag}
    libs = build(srcs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    from qatzip_tpu_torch.tools.corpus import build_corpus

    dev = torch.device("cuda", 0)
    corpus = build_corpus(32)
    for depth, stride in CASES:
        t = records(corpus, stride, dev)
        want = S.select_candidates_ref(*t, depth)
        want_pos = S.select_to_positions_ref(*t, depth, CHUNK).view(
            torch.int16)
        w_sorted = work(*t, depth)
        w_pos = work(*t, depth, CHUNK)
        print(f"depth {depth} stride {stride} records {tuple(t[0].shape)}: "
              f"look-back steps {w_sorted['steps']} "
              f"({w_sorted['steps'] / t[0].numel():.3f} a record); bound, "
              f"ms: sorted {w_sorted['bound_ms']:.4f} "
              f"({w_sorted['bound_by']}), positions {w_pos['bound_ms']:.4f} "
              f"({w_pos['bound_by']})")
        runs = {label: calls(lib, t, depth, CHUNK)
                for label, lib in libs.items()}
        cells = []
        for _ in range(2):
            for label, entries in runs.items():
                for what, (call, result) in entries.items():
                    call()
                    torch.cuda.synchronize()
                    ok = torch.equal(result(), want if what == "sorted"
                                     else want_pos)
                    if not ok and label not in unchecked:
                        raise AssertionError(f"{label} {what} != plain at "
                                             f"depth {depth}")
                    cells.append(f"{label} {what} {time_ms(call):.4f}")
        print("  ms: " + "; ".join(cells))


if __name__ == "__main__":
    main()
