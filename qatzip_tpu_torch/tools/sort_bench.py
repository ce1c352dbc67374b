"""Side-by-side timing of the sort kernel on a CUDA card.

Builds ``qatzip_tpu_torch/csrc/sort.cu`` of this checkout, and of each
checkout named with ``--against`` (for example an earlier commit unpacked
with ``git archive`` under ``build/``), each into a library of its own under
``build/sort_bench/``.  Then, in turns within one process, it times each
kernel alone (in place on a copy of the input, mean of 20 calls after a
warm-up, CUDA events) and the plain version (``torch.sort`` + gathers,
:func:`sort_u32_ref`) at the match finder's sort-1 shapes and a few others,
twice each, and checks that every kernel's result equals the plain one.

    python3 -m qatzip_tpu_torch.tools.sort_bench [--against DIR ...]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops.sort import MAX_PAYLOADS, sort_u32_ref

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "sort_bench")
# (B, n, payloads): the sort-1 shapes at stride 2 and 1 first
SHAPES = [(128, 32768, 2), (128, 65536, 2), (128, 32768, 4), (128, 32768, 0),
          (128, 4096, 2), (4, 262144, 2), (4, 16384, 4)]


def build(roots: dict) -> dict:
    """{label: checkout root} -> {label: qz_sort_u32 of that checkout}."""
    procs = {}
    for label, root in roots.items():
        os.makedirs(os.path.join(OUT, label), exist_ok=True)
        lib = os.path.join(OUT, label, "libsort.so")
        src = os.path.join(root, "qatzip_tpu_torch", "csrc", "sort.cu")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", src, "-o", lib]
        procs[label] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for label, (lib, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise _build.KernelError(f"nvcc failed for {label}:\n{err}")
        fn = ctypes.CDLL(lib).qz_sort_u32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def inputs(B: int, n: int, npay: int, seed: int, dev="cuda") -> list:
    """int32[B, n] keys, unique in each row across the u32 range, and npay
    random payload rows, made from a seed, on dev."""
    g = torch.Generator().manual_seed(seed)
    keys = (torch.randint(0, (1 << 32) // n, (B, n), generator=g) * n
            + torch.argsort(torch.rand((B, n), generator=g), dim=1))
    keys = torch.where(keys >= 1 << 31, keys - (1 << 32), keys)
    pays = [torch.randint(-2**31, 2**31 - 1, (B, n), generator=g,
                          dtype=torch.int32) for _ in range(npay)]
    return [t.to(torch.int32).to(dev) for t in (keys, *pays)]


def time_ms(fn, reps: int = 20) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_call(fn, t: list):
    """A copy of t, and a call that sorts it in place with fn."""
    outs = [x.clone() for x in t]
    ptrs = [o.data_ptr() for o in outs[1:]]
    ptrs += [None] * (MAX_PAYLOADS - len(ptrs))
    B, n = t[0].shape
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(outs[0].data_ptr(), *ptrs, B, n, len(t) - 1, stream)
        if rc:
            raise _build.KernelError(f"qz_sort_u32: CUDA error {rc}")
    return outs, call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[],
                    help="roots of other checkouts to build and time")
    args = ap.parse_args()
    roots = {"this": os.path.dirname(_build.PKG)}
    roots.update({os.path.basename(os.path.normpath(r)): r
                  for r in args.against})
    fns = build(roots)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for B, n, npay in SHAPES:
        t = inputs(B, n, npay, seed=n + npay)
        ref = sort_u32_ref(*t)
        cells = []
        for _ in range(2):
            cells.append(f"plain {time_ms(lambda: sort_u32_ref(*t)):.4f}")
            for label, fn in fns.items():
                outs, call = kernel_call(fn, t)
                call()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(outs, ref)):
                    raise AssertionError(f"{label} != plain at {(B, n, npay)}")
                cells.append(f"{label} {time_ms(call):.4f}")
        print(f"[{B}, {n}] {npay} payloads, ms: " + "; ".join(cells))


if __name__ == "__main__":
    main()
