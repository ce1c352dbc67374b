"""Scaling rows of the port (the reference's run_perf_test.sh analog; the
port's counterpart of tools/scaling_run.py, which writes the JAX package's
SCALING.json).  Prints one JSON object as its last line and writes no
file:

    python -m qatzip_tpu_torch.tools.scaling_run [--devices cpu,cpu]

* ``mesh{n}``: ``shard.scaling_report`` (the match finder at one device
  against an n-device mesh) for every n from 1 to the CUDA device count,
  or over the devices ``--devices`` names;
* ``amdahl_hybrid``: the match finder alone against it plus the native
  host assembly, on 16 chunks of 64 KB on the first device;
* ``two_process``: two ranks of ``tools/dist_worker.py --perf`` (gloo,
  the software path) against one process, one software thread a process;
* ``dist_overhead``: two ranks of ``--overhead``, the share of a
  distributed compress spent outside the ranks' own compress.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch


def mesh_rows(devices: list[torch.device]) -> dict:
    from qatzip_tpu_torch.parallel import shard

    out = {}
    for ndev in range(1, len(devices) + 1):
        rep = shard.scaling_report(shard.make_mesh(ndev, devices))
        out[f"mesh{ndev}"] = rep
    return out


def amdahl_row(device: torch.device) -> dict:
    from qatzip_tpu_torch.engine.cpu_backend import _map_chunks
    from qatzip_tpu_torch.native import qzcore as native
    from qatzip_tpu_torch.ops import match_finder as mf
    from qatzip_tpu_torch.parallel import shard

    rng = np.random.default_rng(0)
    words = [b"the", b"quick", b"brown", b"fox", b"hybrid", b"assembly"]
    blob = b" ".join(words[i] for i in rng.integers(0, len(words), 200000))
    n = 65536
    chunks = [blob[i * n:(i + 1) * n] for i in range(16)]
    data = np.zeros((16, n + 8), np.uint8)
    for i, c in enumerate(chunks):
        data[i, :len(c)] = np.frombuffer(c, np.uint8)
    dj = torch.from_numpy(data).to(device)
    lj = torch.full((16,), n, dtype=torch.int32, device=device)

    def kernel_only():
        with shard.on(device):
            return mf.find_candidates(dj, lj).cpu().numpy()

    def full():
        c = kernel_only()
        return _map_chunks(
            lambda ic: native.deflate_candidates(ic[1], c[ic[0]], 1),
            list(enumerate(chunks)))

    kernel_only()
    t0 = time.perf_counter()
    kernel_only()
    t_k = time.perf_counter() - t0
    full()
    t0 = time.perf_counter()
    full()
    t_f = time.perf_counter() - t0
    return {"batch_bytes": 16 * n, "kernel_s": t_k,
            "kernel_plus_host_assembly_s": t_f,
            "host_serial_fraction": max(t_f - t_k, 0.0) / t_f}


def _ranks(flag: str) -> list[str]:
    from qatzip_tpu_torch.tools import dist_worker

    env = dict(os.environ, QATZIP_TPU_FORCE_SW="1")
    return dist_worker.launch([flag], env=env, timeout=600)


def two_process_row() -> dict:
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.constants import QzDataFormat
    from qatzip_tpu_torch.tools import dist_worker

    bps = [int(re.search(r"DIST PERF rank=\d+ Bps=(\d+)", o).group(1))
           for o in _ranks("--perf")]
    data = dist_worker._corpus() * 8
    kw = {"fmt": QzDataFormat.QZ_DEFLATE_GZIP_EXT, "hw_buff_sz": 65536,
          "sw_only": True}
    qt.compress(data, **kw)
    t0 = time.perf_counter()
    for _ in range(5):
        qt.compress(data, **kw)
    single = len(data) / ((time.perf_counter() - t0) / 5)
    # every rank reports the whole stream's rate of one cooperative
    # compress, so the two-process rate is their mean
    agg = sum(bps) / len(bps)
    return {"processes": 2, "per_rank_stream_Bps": bps,
            "single_process_Bps": single, "two_process_stream_Bps": agg,
            "speedup": agg / single}


def dist_overhead_row() -> dict:
    pat = (r"DIST OVERHEAD rank=\d+ total_s=([0-9.]+) local_s=([0-9.]+) "
           r"overhead_frac=([0-9.]+)")
    rows = [tuple(map(float, re.search(pat, o).groups()))
            for o in _ranks("--overhead")]
    fracs = [r[2] for r in rows]
    return {"processes": 2,
            "per_rank_total_s": [r[0] for r in rows],
            "per_rank_local_compress_s": [r[1] for r in rows],
            "per_rank_overhead_frac": fracs,
            "mean_overhead_frac": sum(fracs) / len(fracs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", default=None,
                    help="comma-separated torch devices (default: every "
                         "CUDA device)")
    args = ap.parse_args(argv)
    devices = ([torch.device(d) for d in args.devices.split(",")]
               if args.devices else
               [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())])
    if not devices:
        raise SystemExit("no CUDA device; name devices with --devices")
    # one software thread a process: the ranks' and the single process's
    os.environ["QATZIP_TPU_SW_THREADS"] = "1"
    doc = {"devices": [str(d) for d in devices]}
    if devices[0].type == "cuda":
        doc["gpu"] = torch.cuda.get_device_name(devices[0])
    doc.update(mesh_rows(devices))
    doc["amdahl_hybrid"] = amdahl_row(devices[0])
    doc["two_process"] = two_process_row()
    doc["dist_overhead"] = dist_overhead_row()
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
