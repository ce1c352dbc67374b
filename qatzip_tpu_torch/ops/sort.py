"""Ascending sort of u32 keys with same-permutation payloads.

Port of qatzip_tpu/ops/pallas_sort.py (``sort_u32``).  uint32 data travels
as int32 tensors holding the same bit pattern (torch has no uint32 shift
on the CPU).

* :func:`sort_u32_ref` is the plain torch version: keys bias-flipped into
  int32 order, ``torch.sort``, payloads gathered by the same order.
* :func:`sort_u32` runs it for a tensor on the CPU, for any [B, n] and any
  number of payloads, as the reference's ``lax.sort`` path does; for a CUDA
  tensor it launches the bitonic network of ``csrc/sort.cu`` (one
  thread-block cluster a row) within the kernel's limits
  (:func:`check_kernel_limits`), or raises.

As in the reference, keys must be unique when payloads are passed: the
network is not stable, so payloads of equal keys may leave in any order.
No path of the port calls it yet; the match finder sorts with
``torch.sort``.
"""
from __future__ import annotations

import ctypes

import torch

from qatzip_tpu_torch.ops._build import Kernel, KernelError, library

MAX_PAYLOADS = 4
MIN_N = 1024
_SIGN = torch.iinfo(torch.int32).min   # u32 order <-> int32 order

KERNEL = Kernel("qz_sort_u32",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def sort_u32_ref(keys: torch.Tensor, *pays: torch.Tensor) -> tuple:
    """keys, pays: int32[B, n] u32 bit patterns.  Returns (keys, *pays)
    sorted by key in u32 order."""
    skey, order = torch.sort(keys ^ _SIGN, dim=1)
    return (skey ^ _SIGN, *(p.gather(1, order) for p in pays))


def check_kernel_limits(n: int, npay: int) -> None:
    """Raises ValueError unless the kernel takes rows of n keys with npay
    payloads: n a power of 2, at least 1024, and at most 4 payloads."""
    if npay > MAX_PAYLOADS:
        raise ValueError(f"the sort kernel moves at most {MAX_PAYLOADS} "
                         f"payloads, got {npay}")
    if n < MIN_N or n & (n - 1):
        raise ValueError(f"the sort kernel needs n a power of 2 and at least "
                         f"{MIN_N}, got {n}")


def sort_u32(keys: torch.Tensor, *pays: torch.Tensor) -> tuple:
    """As :func:`sort_u32_ref`; on a CUDA tensor, the kernel."""
    for t in (keys, *pays):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape != keys.shape:
            raise ValueError("sort_u32 takes int32[B, n] tensors of one shape")
        if t.device != keys.device:
            raise ValueError("sort_u32 inputs on different devices")
    B, n = keys.shape
    if keys.device.type == "cpu":
        return sort_u32_ref(keys, *pays)
    if keys.device.type != "cuda":
        raise KernelError(f"no sort kernel for device {keys.device}")
    check_kernel_limits(n, len(pays))
    outs = [t.clone(memory_format=torch.contiguous_format)
            for t in (keys, *pays)]
    if B:
        ptrs = [o.data_ptr() for o in outs[1:]]
        ptrs += [None] * (MAX_PAYLOADS - len(ptrs))
        KERNEL(outs[0].data_ptr(), *ptrs, B, n, len(pays),
               torch.cuda.current_stream(keys.device).cuda_stream)
    return tuple(outs)


def cluster_info(n: int, npay: int) -> dict:
    """The kernel's launch shape for rows of n keys with npay payloads, and
    how many of its clusters the current card holds at once."""
    check_kernel_limits(n, npay)
    info = (ctypes.c_int * 5)()
    rc = library().qz_sort_cluster_info(n, npay, info)
    if rc != 0:
        msg = library().qz_cuda_error_string(rc).decode()
        raise KernelError(f"qz_sort_cluster_info: CUDA error {rc} ({msg})")
    return dict(zip(("cta_elems", "cluster_ctas", "cluster_elems",
                     "cta_smem_bytes", "max_active_clusters"), info))
