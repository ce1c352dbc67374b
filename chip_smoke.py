#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (qatzip_tpu_torch) once on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Environment: torch/CUDA versions, the card's name and power limit, the
   native host codec (libqzcore.so) and the CUDA kernel build, timed.
2. Each kernel against its plain torch version, on the card, at the shapes
   the main path gives it, on the pinned 32 MB corpus (bench.build_corpus):
   candidate select on the sorted records of the first 128 chunks of 64 KB
   (depth 16 / stride 2, the L1 default, and depth 8 / stride 1), and one
   128-lane lockstep inflate round of zlib level-1 payloads.  Outputs must
   be equal; both are timed with CUDA events.
3. The DEFLATE device path through the public API: gzip-ext level 1 at
   64 KB chunks, compress then decompress the 32 MB corpus.  The launch
   counters are zeroed just before this run and must show both kernels;
   the engine must report device requests only, no lane may fail over to
   the CPU and the health breaker must record no failure; the output must
   be gzip-interoperable and round-trip bit-exactly.
4. A profiled pass of each direction: device busy time against the
   unprofiled wall time, and the host functions that take the time.

Prints the kernels' JSON line and the card's line before the last line,
which is {"ok": true, "device": {...}}.  Any failed check raises, so the
script exits non-zero; without a CUDA device it exits 2 and prints no
result.
"""
from __future__ import annotations

import cProfile
import gzip
import io
import json
import os
import pstats
import subprocess
import sys
import time
import zlib

CHUNK = 64 << 10
LANES = 128


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current CUDA stream."""
    import torch

    fn()  # warm
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def phase_environment(torch):
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"gpu: {_gpu_line()}")
    from qatzip_tpu_torch.ops import _build
    from qatzip_tpu_torch.ops import deflate_decode as dd

    # the port's host side binds the native codec (libqzcore.so) at import
    _check(dd._native is not None, "the native host codec did not build")
    print(f"native host codec: {dd._native._path}")

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({_build.LIB})")
    with open(_build.LOG) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def phase_select(torch, corpus: bytes, dev) -> dict:
    import numpy as np

    from qatzip_tpu_torch.ops import match_finder as mf
    from qatzip_tpu_torch.ops import select as S

    arr = np.frombuffer(corpus[:LANES * CHUNK], np.uint8).reshape(LANES, CHUNK)
    data = torch.zeros((LANES, CHUNK + 8), dtype=torch.uint8, device=dev)
    data[:, :CHUNK] = torch.from_numpy(arr.copy()).to(dev)
    lens = torch.full((LANES,), CHUNK, dtype=torch.int32, device=dev)
    rec = None
    for depth, stride in ((16, 2), (8, 1)):
        sk, sb4, sb4b = mf.sorted_records(data, lens, stride, True)
        ker = S.select_candidates(sk, sb4, sb4b, depth)
        ref = S.select_candidates_ref(sk, sb4, sb4b, depth)
        torch.cuda.synchronize()
        err = int((ker.to(torch.int64) - ref).abs().max())
        _check(torch.equal(ker, ref),
               f"select kernel != plain at depth {depth} stride {stride}")
        ms = _time_ms(lambda: S.select_candidates(sk, sb4, sb4b, depth), 50)
        plain_ms = _time_ms(
            lambda: S.select_candidates_ref(sk, sb4, sb4b, depth), 10)
        print(f"select depth {depth} stride {stride} shape "
              f"{tuple(sk.shape)}: equal, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, nonzero {int((ker > 0).sum())}")
        if rec is None:   # the L1 main path's shape
            rec = {"name": "select_candidates", "route": "cuda",
                   "source": "qatzip_tpu_torch/csrc/select.cu",
                   "replaces": "qatzip_tpu/ops/pallas_select.py:89",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return rec


def phase_inflate(torch, corpus: bytes, dev) -> dict:
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import inflate as PI

    streams = []
    for i in range(LANES):
        chunk = corpus[i * CHUNK:(i + 1) * CHUNK]
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        s = dd._Stream(co.compress(chunk) + co.flush(), len(chunk), i)
        _check(dd._parse_one_header(s) == "huff", "expected a Huffman block")
        streams.append(s)
    live, inputs = dd.pack_round(streams)
    _check(len(live) == LANES, "every lane must take part in the round")
    max_steps = inputs[-1]
    t = PI.upload(*inputs[:-1], dev)
    ker = PI.decode_lockstep(*t, max_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = PI._decode_ref(*t, max_steps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    names = ("tokens", "err", "outcnt", "end_bit", "nsteps")
    for name, a, b in zip(names, ker, ref):
        _check(torch.equal(a, b), f"inflate kernel != plain in {name}")
    ns = int(ker[4][0])
    _check(not bool(ker[1].any()), "a lane of the round errored")
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(ker, ref))
    ms = _time_ms(lambda: PI.decode_lockstep(*t, max_steps), 5)
    lane_steps = ker[0][:ns].ne(0).sum(0)
    util = float(lane_steps.sum()) / (ns * LANES)
    out_bytes = int(ker[2].sum())
    print(f"inflate round: {LANES} lanes, max_steps {max_steps}, nsteps "
          f"{ns}, {out_bytes} output bytes: equal, kernel {ms:.4f} ms "
          f"({out_bytes / ms / 1e6:.4f} GB/s), plain {plain_ms:.1f} ms "
          f"(one run), lane utilisation {util:.4f} (token steps / "
          f"(nsteps x lanes))")
    return {"name": "inflate_decode", "route": "cuda",
            "source": "qatzip_tpu_torch/csrc/inflate.cu",
            "replaces": "qatzip_tpu/ops/pallas_inflate_kernel.py:228",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_slice(torch, corpus: bytes, kernels: list):
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.engine.health import health
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import inflate_kernel as K
    from qatzip_tpu_torch.ops import select as S

    os.environ["QATZIP_TPU_DEVICE"] = "1"
    sess = qt.QzSession()
    _check(qt.qz_init(sess) == qt.QZ_OK, "qz_init did not return QZ_OK")
    eng = core.engine()
    _check(eng.hw_present and eng.hw_backend.device.type == "cuda",
           "engine not on a cuda backend")
    params = qt.QzSessionParamsDeflate(
        common_params=qt.QzSessionParamsCommon(comp_lvl=1, hw_buff_sz=CHUNK),
        data_fmt=qt.QzDataFormat.QZ_DEFLATE_GZIP_EXT)
    _check(qt.qz_setup_session_deflate(sess, params) == qt.QZ_OK,
           "session setup failed")
    print(f"engine: {eng.hw_backend.name} backend on {eng.device_kind}")

    def run(direction, src):
        hw0, sw0 = eng.hw_requests, eng.sw_requests
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = (qt.qz_compress(sess, src) if direction == "compress"
               else qt.qz_decompress(sess, src))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _check(res.rc == qt.QZ_OK, f"{direction} rc {res.rc}")
        _check(not res.ext_rc & qt.QZ_SW_EXECUTION_MASK,
               f"{direction} ran on the software path")
        _check(eng.hw_requests > hw0 and eng.sw_requests == sw0,
               f"{direction}: hw_requests {eng.hw_requests - hw0}, "
               f"sw_requests {eng.sw_requests - sw0}")
        return res, dt

    warm, _ = run("compress", corpus[:LANES * CHUNK])   # warm-up, uncounted
    run("decompress", warm.data)

    S.KERNEL.launches = 0
    K.KERNEL.launches = 0
    dd.failover_lanes = 0
    comp, t_c = run("compress", corpus)
    dec, t_d = run("decompress", comp.data)
    launches = {"select_candidates": S.KERNEL.launches,
                "inflate_decode": K.KERNEL.launches}

    nchunks = -(-len(corpus) // CHUNK)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        _check(k["launches"] >= nchunks // LANES,
               f"{k['name']} launched {k['launches']} times on the main path")
    _check(dd.failover_lanes == 0,
           f"{dd.failover_lanes} lanes failed over to the CPU")
    _check(health.total_failures == 0,
           f"health recorded {health.total_failures} device failures")
    _check(gzip.decompress(comp.data) == corpus, "gzip cannot read the output")
    _check(dec.data == corpus, "round trip is not bit-exact")
    zl = 0
    for i in range(0, len(corpus), CHUNK):
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        zl += len(co.compress(corpus[i:i + CHUNK]) + co.flush())
    gb = len(corpus) / 1e9
    print(f"slice: {len(corpus)} bytes, {nchunks} chunks; compress "
          f"{t_c:.4f} s = {gb / t_c:.4f} GB/s, decompress {t_d:.4f} s = "
          f"{gb / t_d:.4f} GB/s; launches {launches}; failover lanes 0; "
          f"health failures 0; gzip interop and round trip exact")
    walls = {"compress": [t_c], "decompress": [t_d]}
    for rep in range(3):
        _, t_c = run("compress", corpus)
        _, t_d = run("decompress", comp.data)
        walls["compress"].append(t_c)
        walls["decompress"].append(t_d)
        print(f"repeat {rep}: compress {gb / t_c:.4f} GB/s, decompress "
              f"{gb / t_d:.4f} GB/s")
    print(f"ratio: port gzip-ext {len(corpus) / len(comp.data):.4f} "
          f"(framed), zlib L1 raw deflate {len(corpus) / zl:.4f} "
          f"(same 64 KB chunks)")
    medians = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    return sess, comp.data, medians


def phase_profile(torch, sess, corpus: bytes, comp: bytes,
                  walls: dict) -> None:
    """Device busy time and the host's top functions, one pass each way.

    The idle share is taken against the median unprofiled wall time of the
    slice phase, since the profiler itself slows the host."""
    import qatzip_tpu_torch as qt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()   # the first session pays the set-up
    for direction, fn in (("compress", lambda: qt.qz_compress(sess, corpus)),
                          ("decompress", lambda: qt.qz_decompress(sess, comp))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # device-side rows only: a CPU op's device time repeats its kernels'
        dev_rows = sorted((e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA),
                          key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in dev_rows) / 1e6
        _check(busy > 0, f"the profiler saw no device time in {direction}")
        print(f"profile {direction}: device busy {busy:.6f} s; wall "
              f"{walls[direction]:.6f} s unprofiled (median), {wall:.4f} s "
              f"profiled; idle share {1 - busy / walls[direction]:.4f}")
        for e in dev_rows[:6]:
            print(f"  device {e.self_device_time_total / 1e3:10.3f} ms "
                  f"x{e.count:<6d} {e.key[:70]}")
        pr = cProfile.Profile()
        pr.enable()
        fn()
        torch.cuda.synchronize()
        pr.disable()
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(10)
        lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
        print(f"host {direction}, top self time:")
        for ln in lines[3:16]:
            print("  " + ln[:150])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qatzip_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_environment(torch)
    from bench import build_corpus

    dev = torch.device("cuda", 0)
    corpus = build_corpus(32)
    kernels = [phase_select(torch, corpus, dev),
               phase_inflate(torch, corpus, dev)]
    sess, comp, walls = phase_slice(torch, corpus, kernels)
    phase_profile(torch, sess, corpus, comp, walls)
    _check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {_gpu_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
