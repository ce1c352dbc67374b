"""One rank of a multi-process run of the port (the reference's
run_perf_test.sh multi-process analog).

Start one process a rank with QATZIP_TPU_COORDINATOR (host:port of a free
port on localhost), QATZIP_TPU_NUM_PROCESSES and QATZIP_TPU_PROCESS_ID set:

    python -m qatzip_tpu_torch.tools.dist_worker [--lz4] [--async]
        [--offsets] [--device [cpu|cuda]] [--perf] [--overhead]
        [--smoke-mb MB [--chunk-kb KB] --out F]

Every rank compresses a deterministic text corpus through the distributed
engine (parallel/dist_engine.py, gloo), checks the assembled stream
against gzip and against a single-process stream, and prints one ``DIST
... OK`` line a mode, then, once every rank is there, leaves the process
group and prints ``DIST DONE``.  ``--offsets`` checks the collectives of
parallel/dist.py across the ranks.  ``--device`` forces the device route
on the device it names: ``cpu`` (the kernels' plain versions) or ``cuda``
(this rank's card, ``cuda:{rank % device_count}``; two ranks may share
one).  ``--smoke-mb`` drives that many MB of the pinned corpus
(tools/corpus.py), gzip-ext L1 at ``--chunk-kb`` chunks (64 KB), compress
then decompress, and then LZ4 frame on a quarter of it, on the device
route, and prints a ``DIST SMOKE`` JSON line a rank: launches of the
select, inflate and LZ4 decode kernels, software requests, failed-over
lanes and blocks, seconds and the share of the time spent outside the
rank's own compress or decompress; rank 0 writes the assembled gzip-ext
stream to ``--out``.  ``--perf`` and ``--overhead`` print the rows of
tools/scaling_run.py.  ``launch`` starts the ranks.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch


def _corpus() -> bytes:
    rng = np.random.default_rng(42)
    words = [b"the", b"quick", b"brown", b"fox", b"distributed", b"offload"]
    return b" ".join(words[i] for i in rng.integers(0, len(words), 30000))


class _Timed:
    """Wrap the public compress/decompress to add up the seconds spent in
    them (the rank's own work) while the distributed engine calls them."""

    def __init__(self, qt):
        self.qt = qt
        self.fns = {"compress": qt.compress, "decompress": qt.decompress}
        self.seconds = 0.0

    def __enter__(self):
        for name, fn in self.fns.items():
            def timed(*a, _fn=fn, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self._sync()
                    self.seconds += time.perf_counter() - t0
            setattr(self.qt, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.fns.items():
            setattr(self.qt, name, fn)

    @staticmethod
    def _sync():
        # only a rank that works on the card has a context to wait for (a
        # synchronize would create one, ~0.4 s, inside the timed call)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()


def _counters():
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.engine.health import health
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import inflate_kernel as K
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.ops import lz4_kernel as LK
    from qatzip_tpu_torch.ops import select as S

    eng = core.engine()
    return {"select": S.POS_KERNEL.launches, "inflate": K.KERNEL.launches,
            "lz4_decode": LK.KERNEL.launches,
            "hw_requests": eng.hw_requests, "sw_requests": eng.sw_requests,
            "failover_lanes": dd.failover_lanes,
            "failover_blocks": ld.failover_blocks,
            "health_failures": health.total_failures}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counters().items()}


def _smoke(mb: int, chunk: int, out_path: str | None, pid: int) -> None:
    """gzip-ext L1 at ``chunk``-byte chunks on ``mb`` MB, then LZ4 frame on
    a quarter of it, through the distributed engine on the device route."""
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.constants import QzDataFormat
    from qatzip_tpu_torch.parallel import dist_engine
    from qatzip_tpu_torch.tools.corpus import build_corpus

    corpus = build_corpus(mb)
    report = {"rank": pid, "bytes": len(corpus)}
    fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
    # warm-up on one chunk a rank, uncounted
    dist_engine.decompress_distributed(dist_engine.compress_distributed(
        corpus[:2 * chunk], fmt=fmt, hw_buff_sz=chunk), fmt=fmt,
        hw_buff_sz=chunk)
    for algo, data in (("deflate", corpus),
                       ("lz4", corpus[:len(corpus) // 4])):
        kw = {"fmt": fmt} if algo == "deflate" else {"algorithm": "lz4"}
        for direction in ("compress", "decompress"):
            before = _counters()
            _Timed._sync()
            with _Timed(qt) as tm:
                t0 = time.perf_counter()
                if direction == "compress":
                    comp = dist_engine.compress_distributed(
                        data, level=1, hw_buff_sz=chunk, **kw)
                else:
                    back = dist_engine.decompress_distributed(
                        comp, hw_buff_sz=chunk, **kw)
                dt = time.perf_counter() - t0
            rec = _delta(before)
            rec.update(seconds=dt, local_seconds=tm.seconds,
                       overhead_share=max(dt - tm.seconds, 0.0) / dt)
            report[f"{algo} {direction}"] = rec
        assert back == data, f"distributed {algo} round trip differs"
        if algo == "deflate":
            assert gzip.decompress(comp) == data, "gzip cannot read it"
            report["deflate stream bytes"] = len(comp)
            if pid == 0 and out_path:
                with open(out_path, "wb") as f:
                    f.write(comp)
    print("DIST SMOKE " + json.dumps(report), flush=True)


def launch(args, nranks: int = 2, env: dict | None = None,
           timeout: float = 120.0) -> list[str]:
    """Run ``nranks`` ranks of this worker with ``args`` against a
    coordinator on a free localhost port and return each rank's output
    (stdout and stderr).  Raises RuntimeError when a rank exits non-zero,
    or when any is still running after ``timeout`` seconds (every rank is
    then killed)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(nranks):
        e = dict(os.environ if env is None else env)
        e.update({"QATZIP_TPU_COORDINATOR": f"127.0.0.1:{port}",
                  "QATZIP_TPU_NUM_PROCESSES": str(nranks),
                  "QATZIP_TPU_PROCESS_ID": str(rank)})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "qatzip_tpu_torch.tools.dist_worker",
             *args], cwd=root, env=e, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise RuntimeError(f"a rank ran past {timeout} s; all killed")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} exited {p.returncode}:\n"
                               f"{out[-3000:]}")
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lz4", action="store_true")
    ap.add_argument("--async", dest="async_", action="store_true")
    ap.add_argument("--offsets", action="store_true")
    ap.add_argument("--device", nargs="?", const="cuda", default=None,
                    choices=("cpu", "cuda"))
    ap.add_argument("--perf", action="store_true")
    ap.add_argument("--overhead", action="store_true")
    ap.add_argument("--smoke-mb", type=int, default=0)
    ap.add_argument("--chunk-kb", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch.distributed as tdist

    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.constants import QzDataFormat
    from qatzip_tpu_torch.parallel import dist, dist_engine

    assert dist.init_distributed(), "coordinator env not set"
    pid, nproc = dist.process_info()
    if args.device:
        # the device route, on the device asked for
        os.environ["QATZIP_TPU_DEVICE"] = "1"
        dev = (torch.device("cpu") if args.device == "cpu"
               else dist.local_device())
        assert dev is not None, "--device cuda: no CUDA device"
        rc = qt.qz_init(qt.QzSession(), device=dev)
        assert rc == qt.QZ_OK, f"qz_init on {dev}: {rc}"
    fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
    data = _corpus()

    comp = dist_engine.compress_distributed(data, fmt=fmt, hw_buff_sz=4096,
                                            sw_only=True)
    assert gzip.decompress(comp) == data, "gzip oracle mismatch"
    out = dist_engine.decompress_distributed(comp, fmt=fmt, hw_buff_sz=4096,
                                             sw_only=True)
    assert out == data, "distributed decompress mismatch"
    # the distributed stream equals the single-process stream
    ref = qt.compress(data, "deflate", fmt=fmt, hw_buff_sz=4096,
                      sw_only=True)
    assert comp == ref, "distributed stream differs from single-process"
    print(f"DIST OK rank={pid}/{nproc} bytes={len(data)} comp={len(comp)}",
          flush=True)

    if args.lz4:
        lcomp = dist_engine.compress_distributed(
            data, algorithm="lz4", hw_buff_sz=4096, sw_only=True)
        assert lcomp == qt.compress(data, "lz4", hw_buff_sz=4096,
                                    sw_only=True), "distributed lz4 differs"
        lout = dist_engine.decompress_distributed(
            lcomp, algorithm="lz4", hw_buff_sz=4096, sw_only=True)
        assert lout == data, "distributed lz4 decompress mismatch"
        print(f"DIST LZ4 OK rank={pid}", flush=True)

    if args.async_:
        # the async ring on each rank and the collectives coexist
        from qatzip_tpu_torch import async_api

        sess = qt.QzSession()
        assert qt.qz_setup_session_deflate(sess) == qt.QZ_OK
        futs = []
        for i in range(6):
            rc, fut = async_api.qz_compress2(sess, data[i::7])
            assert rc == qt.QZ_OK
            futs.append((i, fut))
        for i, fut in futs:
            r = fut.result(timeout=60)
            assert r.rc == qt.QZ_OK
            assert qt.decompress(r.data, "deflate") == data[i::7]
        out2 = dist_engine.decompress_distributed(comp, fmt=fmt,
                                                  hw_buff_sz=4096,
                                                  sw_only=True)
        assert out2 == data
        print(f"DIST ASYNC OK rank={pid}", flush=True)

    if args.offsets:
        lens = np.random.default_rng(7).integers(0, 1000, 4 * nproc)
        mine = lens[4 * pid:4 * pid + 4]
        assert (dist.allgather_lengths(mine).numpy().reshape(-1)
                == lens).all(), "allgather_lengths"
        got = dist.sharded_offsets(None, mine).numpy()
        want = (np.cumsum(lens) - lens)[4 * pid:4 * pid + 4]
        assert (got == want).all(), f"sharded_offsets {got} != {want}"
        per = -(-10 // nproc)
        assert dist.host_block_range(10) == (min(pid * per, 10),
                                             min(pid * per + per, 10))
        print(f"DIST OFFSETS OK rank={pid}", flush=True)

    if args.device and not args.smoke_mb:
        # the device route end to end under the process group
        before = _counters()
        dcomp = dist_engine.compress_distributed(data, fmt=fmt,
                                                 hw_buff_sz=16384)
        assert gzip.decompress(dcomp) == data, "device-route gzip mismatch"
        assert dcomp == qt.compress(data, fmt=fmt, hw_buff_sz=16384), \
            "device-route stream differs from single-process"
        dout = dist_engine.decompress_distributed(dcomp, fmt=fmt,
                                                  hw_buff_sz=16384)
        assert dout == data, "device-route round trip differs"
        d = _delta(before)
        assert d["hw_requests"] > 0, "device path not exercised"
        assert d["sw_requests"] == 0 and d["failover_lanes"] == 0, d
        print(f"DIST DEVICE OK rank={pid} hw={d['hw_requests']} "
              f"select={d['select']} inflate={d['inflate']}", flush=True)

    if args.smoke_mb:
        _smoke(args.smoke_mb, args.chunk_kb << 10, args.out, pid)

    if args.overhead or args.perf:
        # the distributed engine's own cost at fixed compute (--overhead:
        # the share of the time outside the rank's compress) and the
        # throughput a rank sees (--perf), software path, 64 KB chunks
        big = data * (64 if args.overhead else 8)
        kw = {"fmt": fmt, "hw_buff_sz": 65536, "sw_only": True}
        dist_engine.compress_distributed(big, **kw)  # warm
        reps = 5
        with _Timed(qt) as tm:
            t0 = time.perf_counter()
            for _ in range(reps):
                dist_engine.compress_distributed(big, **kw)
            total = (time.perf_counter() - t0) / reps
        local = tm.seconds / reps
        if args.overhead:
            print(f"DIST OVERHEAD rank={pid} total_s={total:.5f} "
                  f"local_s={local:.5f} "
                  f"overhead_frac={max(total - local, 0.0) / total:.4f}",
                  flush=True)
        if args.perf:
            print(f"DIST PERF rank={pid} Bps={len(big) / total:.0f}",
                  flush=True)
    # every rank is done before any leaves: rank 0 hosts the TCP store, and
    # a rank still tearing down its gloo group without it aborts
    tdist.barrier()
    tdist.destroy_process_group()
    print(f"DIST DONE rank={pid}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
