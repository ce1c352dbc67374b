"""Block data-parallel over a list of devices.

Port of qatzip_tpu/parallel/shard.py.  The reference shards the batch axis
of its kernels over a ``jax.sharding.Mesh``; here a "mesh" is an ordered
list of ``torch.device``s, and a batch of blocks is cut into contiguous
slices, one a device in mesh order, each staged and run on its device (on
that device's current CUDA stream), the results gathered back in block
order.  Block order is submission order, the reference's seq reassembly
invariant (its src/qatzip.c:1641-1649), so the bytes equal the one-device
path's.

Per-block compressed lengths travel with each slice; hosts gather payload
bytes in block order.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def make_mesh(n_devices: int | None = None,
              devices=None) -> list[torch.device]:
    """The first ``n_devices`` CUDA devices (all of them when None), or the
    first ``n_devices`` of ``devices`` when a list is given.  Raises when
    fewer devices exist than asked for."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if n_devices is None:
        n_devices = len(devs)
    if n_devices < 1 or n_devices > len(devs):
        what = "devices given" if devices is not None else "CUDA devices"
        raise RuntimeError(f"have {len(devs)} {what}, need {n_devices}")
    return devs[:n_devices]


_MESH_UNSET = object()
_MESH = _MESH_UNSET


def local_mesh():
    """One cached mesh over every local CUDA device; None below two (one
    device has nothing to win from sharding).  Tests and the dry run pin
    ``_MESH`` to a list of their own."""
    global _MESH
    if _MESH is _MESH_UNSET:
        _MESH = make_mesh() if torch.cuda.device_count() > 1 else None
    return _MESH


def block_slices(count: int, mesh) -> list | None:
    """[(device, start, end)] cutting a batch of ``count`` blocks into
    contiguous slices, one a device of ``mesh``; None when the batch stays
    on one device (no mesh, or fewer than two blocks a device)."""
    if mesh is None or count < 2 * len(mesh):
        return None
    per, extra = divmod(count, len(mesh))
    out, start = [], 0
    for i, dev in enumerate(mesh):
        end = start + per + (1 if i < extra else 0)
        out.append((dev, start, end))
        start = end
    return out


@contextlib.contextmanager
def on(device: torch.device):
    """Make ``device`` current for the launches inside (a kernel goes to
    the current stream of its tensors' device, which must be current)."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


def _put(a, rows: slice, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a[rows].to(device, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[rows])).to(
        device, non_blocking=True)


def scatter(mesh, *arrays) -> list[tuple]:
    """Each array's rows cut into len(mesh) equal contiguous slices, each
    moved to its device: [(slice of arrays[0], slice of arrays[1], ...)]
    in mesh order.  The row count must divide by the mesh size."""
    B = arrays[0].shape[0]
    if B % len(mesh):
        raise ValueError(f"batch of {B} blocks does not divide over "
                         f"{len(mesh)} devices")
    per = B // len(mesh)
    return [tuple(_put(a, slice(i * per, (i + 1) * per), dev)
                  for a in arrays) for i, dev in enumerate(mesh)]


def gather(shards) -> np.ndarray:
    """Per-device tensors (a list, in mesh order) or one tensor -> one
    host numpy array in block order."""
    if isinstance(shards, torch.Tensor):
        return shards.cpu().numpy()
    return np.concatenate([s.cpu().numpy() for s in shards])


def compress_blocks_sharded(mesh, data_pad, lengths, depth: int = 1,
                            kwords: int = 16, allow_dynamic: bool = True,
                            m_words: int | None = None):
    """Compress a [B, N+8] batch cut over the mesh's devices.

    B must be a multiple of the mesh size.  Both device stages (K1 analyze,
    K2 pack) run on each device's slice; the host Huffman/header build
    between them works on the gathered [B, 286] histograms.  Returns
    (words, bits, mode): words and bits as lists of per-device tensors,
    each slice's on its device; mode numpy.
    """
    from qatzip_tpu_torch.ops import deflate_encode as de

    n = data_pad.shape[1] - 8
    if m_words is None:
        m_words = de.words_bound(n)
    return de.encode_blocks(data_pad, lengths, depth, kwords, allow_dynamic,
                            m_words, mesh=mesh)


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def scaling_report(mesh, block_bytes: int = 65536,
                   blocks_per_device: int = 8, reps: int = 5) -> dict:
    """Scaling of the path's device stage, the hybrid match finder, at one
    device against the whole mesh (the reference's run_perf_test.sh
    analog).  On CUDA devices each device's time comes from CUDA events
    around the timed calls and the mesh's is the slowest device's; CPU
    devices are timed on the host clock."""
    from qatzip_tpu_torch.ops import match_finder as mf

    n = block_bytes
    rng = np.random.default_rng(0)

    def run(m):
        b = len(m) * blocks_per_device
        data = np.zeros((b, n + 8), np.uint8)
        data[:, :n] = rng.integers(0, 256, (b, n), dtype=np.uint8)
        lens = np.full((b,), n, np.int32)
        shards = scatter(m, data, lens)

        def once():
            for dev, (d, l) in zip(m, shards):
                with on(dev):
                    mf.find_candidates(d, l)

        once()
        _sync(m)
        cuda = all(d.type == "cuda" for d in m)
        if cuda:
            marks = []
            for dev in m:
                with on(dev):
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    marks.append(ev)
        t0 = time.perf_counter()
        for _ in range(reps):
            once()
        if cuda:
            for dev, ev in zip(m, marks):
                with on(dev):
                    ev[1].record()
        _sync(m)
        dt = ((max(ev[0].elapsed_time(ev[1]) for ev in marks) / 1e3) if cuda
              else time.perf_counter() - t0) / reps
        return b * n / dt

    full = run(mesh)
    single = run(mesh[:1])
    ndev = len(mesh)
    return {
        "devices": ndev,
        "single_device_Bps": single,
        "mesh_Bps": full,
        "speedup": full / single,
        "efficiency": full / (single * ndev),
    }
