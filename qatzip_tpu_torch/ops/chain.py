"""The chain walk that the device encoder and the speculative decoder share.

A row is a successor map ``f`` over positions [0, n) with i < f[i] <= n,
cut into segments of ``seg`` positions (n % seg == 0).  The walk returns,
for every segment, the ``seg`` positions that the chain 0, f[0], f[f[0]],
... visits from the segment's entry, in order, the first position past the
segment repeated once the walk leaves it: int32 [B, n / seg, seg].

* :func:`chain_walk_ref` is the plain torch version: the loops both
  engines ran, the reference's two ``lax.scan`` walks
  (qatzip_tpu/ops/deflate_encode.py:294-322,
  qatzip_tpu/ops/deflate_decode.py:282-313) as Python loops of batched
  steps: a clamped doubling for each position's exit from its segment, a
  step a segment for the entries, ``seg`` steps for the walks.
* :func:`chain_walk` runs it for a tensor on the CPU, and for a CUDA
  tensor launches ``csrc/chain.cu`` or raises: one launch a call for rows
  that fit a thread-block cluster (:func:`cluster_plan`), three for longer
  rows, counted as one call on :data:`KERNEL` either way.
"""
from __future__ import annotations

import ctypes

import torch

from qatzip_tpu_torch.ops._build import Kernel, KernelError

MIN_SEG, MAX_SEG = 32, 1024   # the kernel's segment widths, powers of 2
# csrc/chain.cuh's cluster path: a CTA holds up to CLUSTER_SHARE words of a
# row (and a segment a thread, at most CLUSTER_THREADS), a cluster up to
# CLUSTER_MAX CTAs
CLUSTER_SHARE, CLUSTER_MAX, CLUSTER_THREADS = 32768, 16, 256

KERNEL = Kernel("qz_chain_walk",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
INFO = Kernel("qz_chain_info", [ctypes.c_int] * 2 + [ctypes.c_void_p])
PROBE = Kernel("qz_chain_probe", [ctypes.c_void_p] + [ctypes.c_int] * 2
               + [ctypes.c_void_p])
ALL_PHASES = 7   # qz_chain_walk's mask: exits (1), entries (2), walks (4)


def chain_walk_ref(f: torch.Tensor, seg: int) -> torch.Tensor:
    """f: int [B, n] successor map.  Returns int32 [B, n // seg, seg]."""
    # deflate_encode imports this module
    from qatzip_tpu_torch.ops.deflate_encode import _take

    B, n = f.shape
    dev = f.device
    f = f.long()
    nseg = n // seg
    pos = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    seg_end = ((pos // seg) + 1) * seg

    # X(i) = first chain position >= seg_end(i), by clamped doubling
    X = f
    hops = 1
    while hops < seg:
        X = torch.where(X >= seg_end, X, torch.where(X >= n, n, _take(X, X)))
        hops <<= 1

    # segment entries: the reference's first lax.scan
    e = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    ent = []
    for s in range(nseg):
        ent.append(e[:, 0])
        e = torch.where(e >= (s + 1) * seg, e,
                        torch.where(e >= n, n, _take(X, e)))
    entries = torch.stack(ent, dim=1)                      # [B, nseg]

    # parallel segment walks: the reference's second lax.scan
    seg_hi = (torch.arange(nseg, dtype=torch.int64, device=dev)
              + 1)[None, :] * seg
    p = entries
    visited = []
    for _ in range(seg):
        visited.append(p)
        p = torch.where(p < seg_hi, _take(f, p), p)
    return torch.stack(visited, dim=2).to(torch.int32)    # [B, nseg, seg]


def cluster_plan(n: int, seg: int,
                 share: int = CLUSTER_SHARE) -> tuple[int, int]:
    """(CTAs a cluster, segments a CTA) of the kernel's cluster path for
    rows of n positions in segments of seg, as csrc/chain.cuh's
    qz_chain_plan computes it; (0, 0) where a row needs more than
    CLUSTER_MAX CTAs and takes the three-launch row path."""
    nseg = n // seg
    most = min(share // seg, CLUSTER_THREADS)
    if most < 1 or nseg < 1:
        return 0, 0
    c = -(-nseg // most)
    return (c, -(-nseg // c)) if c <= CLUSTER_MAX else (0, 0)


def check_kernel_limits(n: int, seg: int) -> str:
    """Raises ValueError unless the kernel takes rows of n positions in
    segments of seg: seg a power of 2 in [MIN_SEG, MAX_SEG], n a positive
    multiple of it below 2^31.  Returns the path the kernel takes:
    "cluster" for rows of at most CLUSTER_MAX * min(CLUSTER_SHARE,
    CLUSTER_THREADS * seg) positions (2^19 at seg >= 128, 2^18 at 64,
    2^17 at 32), one launch; "rows" for longer rows, three launches
    through device memory."""
    if seg < MIN_SEG or seg > MAX_SEG or seg & (seg - 1):
        raise ValueError(f"the chain kernel takes segments of a power of 2 "
                         f"in [{MIN_SEG}, {MAX_SEG}], not {seg}")
    if n < seg or n % seg or n >= 1 << 31:
        raise ValueError(f"the chain kernel takes rows of a positive "
                         f"multiple of {seg} positions, not {n}")
    return "cluster" if cluster_plan(n, seg)[0] else "rows"


def launch_info(n: int, seg: int) -> dict:
    """The card's launch shape for rows of n positions in segments of seg
    (qz_chain_info): CTAs a cluster (0 on the row path), segments a CTA,
    threads a segment in phase A, shared bytes a CTA, the clusters the
    card holds at once."""
    check_kernel_limits(n, seg)
    info = (ctypes.c_int * 5)()
    INFO(n, seg, ctypes.addressof(info))
    return dict(zip(("c", "spc", "parts", "smem", "active_clusters"),
                    info))


def chain_walk(f: torch.Tensor, seg: int) -> torch.Tensor:
    """As :func:`chain_walk_ref`; on a CUDA tensor, the kernel."""
    if f.dim() != 2 or f.dtype not in (torch.int32, torch.int64):
        raise ValueError("chain_walk takes an int32 or int64 [B, n] map")
    B, n = f.shape
    if f.device.type == "cpu":
        return chain_walk_ref(f, seg)
    if f.device.type != "cuda":
        raise KernelError(f"no chain kernel for device {f.device}")
    path = check_kernel_limits(n, seg)
    fi = f.to(torch.int32).contiguous()
    if fi.data_ptr() % 16:   # the cluster path's 16-byte loads
        fi = fi.clone()
    out = torch.empty((B, n // seg, seg), dtype=torch.int32, device=f.device)
    if B:
        ent = (None if path == "cluster" else
               torch.empty((B, n // seg), dtype=torch.int32, device=f.device))
        KERNEL(fi.data_ptr(), out.data_ptr(),
               None if ent is None else ent.data_ptr(), B, n, seg,
               ALL_PHASES, torch.cuda.current_stream(f.device).cuda_stream)
    return out


def probe_clocks(remote: bool, steps: int, device) -> int:
    """Clocks of a chain of ``steps`` dependent shared-memory loads on the
    card (qz_chain_probe): in the CTA's own shared memory (the cluster
    path's phase B), or in its cluster sibling's (``remote``)."""
    out = torch.zeros(2, dtype=torch.int64, device=device)
    PROBE(out.data_ptr(), int(remote), steps,
          torch.cuda.current_stream(device).cuda_stream)
    return int(out[0])
