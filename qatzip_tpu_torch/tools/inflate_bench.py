"""Side-by-side timing of the lockstep inflate kernel on a CUDA card.

Builds ``qatzip_tpu_torch/csrc/inflate.cu`` of this checkout, and of each
checkout named with ``--against`` (an earlier commit unpacked with ``git
archive``, or a copy with an edited kernel), each into a library of its own
under ``build/inflate_bench/``; also ``tools/inflate_warp.cu`` (a warp of W
lanes a CTA, the same step) at each W of ``WARP_LANES``.  The rounds are those
of chip_smoke.py: the first deflate block of each of the first 128 and 512
chunks of the pinned 32 MB corpus at zlib level 1, the lanes sorted by
payload so that a warp's lanes end close together.  In turns within one
process it times each kernel alone (mean of 5 calls after a warm-up, CUDA
events), twice a round width, and checks that every kernel's five outputs
equal this checkout's (chip_smoke.py holds this checkout's against the
plain version).

    python3 -m qatzip_tpu_torch.tools.inflate_bench [--against DIR ...]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import zlib

import torch

from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.ops import inflate as PI
from qatzip_tpu_torch.tools.corpus import build_corpus

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "inflate_bench")
CHUNK = 64 << 10
WIDTHS = (128, 512)
WARP_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "inflate_warp.cu")
WARP_LANES = (4, 8, 16, 24)


def build(jobs: dict) -> dict:
    """{label: (source, extra nvcc flags)} -> {label: the qz_inflate_decode
    of that source}, the nvcc processes started together."""
    procs = {}
    for label, (src, flags) in jobs.items():
        os.makedirs(os.path.join(OUT, label), exist_ok=True)
        lib = os.path.join(OUT, label, "libinflate.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", src,
               "-o", lib]
        procs[label] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for label, (lib, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise _build.KernelError(f"nvcc failed for {label}:\n{err}")
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln]
        print(f"{label}: {'; '.join(regs)}")
        fn = ctypes.CDLL(lib).qz_inflate_decode
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def round_inputs(corpus: bytes, lanes: int, dev) -> tuple:
    """The device tensors of one round and its step bound."""
    streams = []
    for i in range(lanes):
        chunk = corpus[i * CHUNK:(i + 1) * CHUNK]
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        s = dd._Stream(co.compress(chunk) + co.flush(), len(chunk), i)
        if dd._parse_one_header(s) != "huff":
            raise AssertionError("expected a Huffman block")
        streams.append(s)
    streams.sort(key=lambda s: len(s.payload) - (s.bits.pos >> 3))
    _, inputs = dd.pack_round(streams)
    return PI.upload(*inputs[:-1], dev), inputs[-1]


def kernel_call(fn, t: tuple, max_steps: int):
    """Zeroed outputs for one round, and a call that fills them with fn."""
    words, bit0, nbits, tll, td, active = (x.to(torch.int32) for x in t)
    lanes, nw = words.shape
    dev = words.device
    outs = [torch.zeros((max_steps, lanes), dtype=torch.int32, device=dev)]
    outs += [torch.zeros(lanes, dtype=torch.int32, device=dev)
             for _ in range(3)]
    outs.append(torch.zeros(1, dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        rc = fn(*(x.data_ptr() for x in (words, bit0, nbits, tll, td,
                                          active, *outs)),
                lanes, nw, max_steps, stream)
        if rc:
            raise _build.KernelError(f"qz_inflate_decode: CUDA error {rc}")
    return outs, call


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
    args = ap.parse_args()
    roots = {"this": os.path.dirname(_build.PKG)}
    roots.update({os.path.basename(os.path.normpath(r)): r
                  for r in args.against})
    jobs = {label: (os.path.join(root, "qatzip_tpu_torch", "csrc",
                                 "inflate.cu"), [])
            for label, root in roots.items()}
    jobs.update({f"warp{w}": (WARP_SRC, [f"-DQZ_WARP_LANES={w}",
                                         f"-I{_build.CSRC}"])
                 for w in WARP_LANES})
    fns = build(jobs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    corpus = build_corpus(32)
    for lanes in WIDTHS:
        t, max_steps = round_inputs(corpus, lanes, dev)
        calls = {label: kernel_call(fn, t, max_steps)
                 for label, fn in fns.items()}
        for label, (outs, call) in calls.items():
            call()
        torch.cuda.synchronize()
        ref = calls["this"][0]
        ns = int(ref[4][0])
        for label, (outs, _) in calls.items():
            if not all(torch.equal(a, b) for a, b in zip(outs, ref)):
                raise AssertionError(f"{label} != this at {lanes} lanes")
        cells = [f"{label} {time_ms(call):.4f}"
                 for _ in range(2) for label, (_, call) in calls.items()]
        print(f"{lanes} lanes, {ns} steps, ms a round: " + "; ".join(cells))


if __name__ == "__main__":
    main()
