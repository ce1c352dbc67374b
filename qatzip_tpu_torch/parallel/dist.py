"""Multi-process initialization and cross-process block scattering.

Port of qatzip_tpu/parallel/dist.py over ``torch.distributed``.  The
reference scales across PCIe devices with up to NumProcesses=64 processes
sharing instances (the multiple-process section of its configuration);
the JAX package runs one process a host over ``jax.distributed``.  Here each
process is a rank of a ``torch.distributed`` process group on the gloo
backend: the collectives carry host bytes (payloads and lengths), and gloo
lets two ranks share one card, which NCCL refuses.  Each rank computes on
``cuda:{rank % torch.cuda.device_count()}`` (``local_device``).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as tdist

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join the process group (gloo, ``tcp://<coordinator_address>``).

    Arguments default from the environment (QATZIP_TPU_COORDINATOR /
    QATZIP_TPU_NUM_PROCESSES / QATZIP_TPU_PROCESS_ID, or the JAX_*
    equivalents the reference reads).  A single-process run (no
    coordinator configured) is a no-op returning False: the library stays
    whole in one process."""
    global _initialized
    if _initialized or tdist.is_initialized():
        _initialized = True
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("QATZIP_TPU_COORDINATOR")
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        np_s = (os.environ.get("QATZIP_TPU_NUM_PROCESSES")
                or os.environ.get("JAX_NUM_PROCESSES"))
        num_processes = int(np_s) if np_s else None
    if process_id is None:
        pid_s = (os.environ.get("QATZIP_TPU_PROCESS_ID")
                 or os.environ.get("JAX_PROCESS_ID"))
        process_id = int(pid_s) if pid_s else None
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator "
                         "address, the number of processes and this "
                         "process's id")
    tdist.init_process_group("gloo",
                             init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=process_id)
    _initialized = True
    return True


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def local_device() -> torch.device | None:
    """This rank's card, ``cuda:{rank % device_count}``; None without
    CUDA."""
    count = torch.cuda.device_count()
    if count == 0:
        return None
    return torch.device("cuda", process_info()[0] % count)


def global_mesh() -> list[torch.device]:
    """The devices this process drives, as a block-DP mesh.  A torch
    process addresses only its own devices, so the global set is every
    rank's ``global_mesh()``; on a single host with one process it equals
    ``shard.make_mesh()``."""
    from qatzip_tpu_torch.parallel import shard

    return shard.make_mesh()


def host_block_range(total_blocks: int) -> tuple[int, int]:
    """[start, end) of the block indices this rank owns under an even
    contiguous split (deterministic block order keeps the reference's seq
    reassembly invariant)."""
    pid, nproc = process_info()
    per = (total_blocks + nproc - 1) // nproc
    start = min(pid * per, total_blocks)
    return start, min(start + per, total_blocks)


def allgather_lengths(local_lengths) -> torch.Tensor:
    """All-gather this rank's per-block lengths (equal counts on every
    rank): int64[world, n] on the CPU, rank order."""
    ln = torch.as_tensor(local_lengths, dtype=torch.int64).cpu().reshape(-1)
    _, nproc = process_info()
    if nproc == 1:
        return ln[None, :]
    out = [torch.empty_like(ln) for _ in range(nproc)]
    tdist.all_gather(out, ln)
    return torch.stack(out)


def sharded_offsets(mesh, lengths):
    """Global exclusive prefix offsets of per-block lengths; each shard
    gets back its own window.

    ``mesh`` a list of devices: ``lengths`` is the whole array, cut into
    contiguous equal shards, one a device; the shards are concatenated,
    summed and each device receives its window: a list of tensors in mesh
    order.  ``mesh`` None: ``lengths`` is this rank's shard; the shards are
    all-gathered across the ranks and this rank's window comes back."""
    if mesh is None:
        ln = torch.as_tensor(lengths, dtype=torch.int64).reshape(-1)
        allv = allgather_lengths(ln).reshape(-1)
        excl = torch.cumsum(allv, 0) - allv
        rank = process_info()[0]
        return excl[rank * ln.numel():(rank + 1) * ln.numel()].to(ln.device)
    from qatzip_tpu_torch.parallel import shard

    shards = [s for (s,) in shard.scatter(mesh, torch.as_tensor(
        lengths, dtype=torch.int64))]
    allv = torch.cat([s.cpu() for s in shards])
    excl = torch.cumsum(allv, 0) - allv
    per = allv.numel() // len(mesh)
    return [excl[i * per:(i + 1) * per].to(dev)
            for i, dev in enumerate(mesh)]
