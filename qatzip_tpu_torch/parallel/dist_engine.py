"""Multi-process engine path: distributed block compression.

Port of qatzip_tpu/parallel/dist_engine.py over ``torch.distributed``.
The reference's process-level scaling shares its devices across up to
NumProcesses=64 processes and its perf harness sums per-process
throughput.  Here the input's block axis scatters across the ranks
(contiguous ranges, which keep the seq reassembly invariant); every rank
compresses its range with its local engine (its card, ``cuda:{rank %
device_count}``, or the CPU funnel); lengths and payload bytes all-gather
over gloo so every rank assembles the same global stream.

Every member of a chunked stream (gzip-ext, gzip, 4B, ...) is a
self-contained framed unit, so the global stream is the block-order
concatenation of the ranks' outputs, byte for byte the single-process
stream.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist

from qatzip_tpu_torch.parallel import dist


def _process_info() -> tuple[int, int]:
    return dist.process_info()


def _ensure_engine() -> None:
    """Bring the engine up on this rank's card when nothing has yet (a
    rank that initialized it itself keeps its choice)."""
    from qatzip_tpu_torch.engine import core

    if not core.engine().initialized:
        core.qz_init_engine(device=dist.local_device())


def compress_distributed(src: bytes, *, algorithm: str = "deflate",
                         fmt=None, level: int = 1,
                         hw_buff_sz: int = 64 * 1024,
                         sw_only: bool = False) -> bytes:
    """Compress ``src`` with its block range scattered over the ranks.

    A single-process run is the plain engine path; a multi-process run
    returns the same assembled stream on every rank."""
    import qatzip_tpu_torch as qt

    dist.init_distributed()
    _ensure_engine()
    pid, nproc = _process_info()
    if nproc == 1 or len(src) == 0:
        return qt.compress(src, algorithm, fmt=fmt, level=level,
                           hw_buff_sz=hw_buff_sz, sw_only=sw_only)

    total_blocks = (len(src) + hw_buff_sz - 1) // hw_buff_sz
    start, end = dist.host_block_range(total_blocks)
    lo = start * hw_buff_sz
    hi = min(end * hw_buff_sz, len(src))
    local = src[lo:hi] if hi > lo else b""
    # each block becomes one framed member: the ranks' outputs in rank
    # order are the single-process stream
    payload = (qt.compress(local, algorithm, fmt=fmt, level=level,
                           hw_buff_sz=hw_buff_sz, sw_only=sw_only)
               if local else b"")
    return _allgather_concat(payload)


def decompress_distributed(comp: bytes, *, algorithm: str = "deflate",
                           fmt=None, hw_buff_sz: int = 64 * 1024,
                           sw_only: bool = False) -> bytes:
    """Decompress with the members scattered over the ranks: member
    boundaries from a host framing walk, a contiguous member range a rank,
    outputs all-gathered in rank order."""
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch import api as qt_api

    dist.init_distributed()
    _ensure_engine()
    pid, nproc = _process_info()
    if nproc == 1 or len(comp) == 0:
        return qt.decompress(comp, algorithm, fmt=fmt,
                             hw_buff_sz=hw_buff_sz, sw_only=sw_only)

    bounds = qt_api.member_boundaries(comp, algorithm, fmt=fmt,
                                      hw_buff_sz=hw_buff_sz)
    nmem = len(bounds)
    per = (nmem + nproc - 1) // nproc
    mstart = min(pid * per, nmem)
    mend = min(mstart + per, nmem)
    if mend > mstart:
        out = qt.decompress(comp[bounds[mstart][0]:bounds[mend - 1][1]],
                            algorithm, fmt=fmt, hw_buff_sz=hw_buff_sz,
                            sw_only=sw_only)
    else:
        out = b""
    return _allgather_concat(out)


def _allgather_concat(payload: bytes) -> bytes:
    """All-gather variable-length byte payloads across the ranks (gloo)
    and concatenate them in rank order: the lengths first, then every
    payload padded to the longest, since ``all_gather`` takes equal
    sizes."""
    _, nproc = _process_info()
    ln = torch.tensor([len(payload)], dtype=torch.int64)
    lens = [torch.empty_like(ln) for _ in range(nproc)]
    tdist.all_gather(lens, ln)
    all_len = [int(t) for t in lens]
    buf = torch.zeros(max(max(all_len), 1), dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.from_numpy(
            np.frombuffer(payload, np.uint8).copy())
    bufs = [torch.empty_like(buf) for _ in range(nproc)]
    tdist.all_gather(bufs, buf)
    return b"".join(b[:n].numpy().tobytes() for b, n in zip(bufs, all_len))
