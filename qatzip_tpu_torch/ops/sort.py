"""Ascending sort of u32 keys with same-permutation payloads.

Port of qatzip_tpu/ops/pallas_sort.py (``sort_u32``).  uint32 data travels
as int32 tensors holding the same bit pattern (torch has no uint32 shift
on the CPU).

* :func:`sort_u32_ref` is the plain torch version: keys bias-flipped into
  int32 order, ``torch.sort``, payloads gathered by the same order.
* :func:`sort_u32` runs it for a tensor on the CPU, and for a CUDA tensor
  launches the bitonic network of ``csrc/sort.cu`` or raises.

As in the reference, keys must be unique when payloads are passed: the
network is not stable, so payloads of equal keys may leave in any order.
No path of the port calls it yet; the match finder sorts with
``torch.sort``.
"""
from __future__ import annotations

import ctypes

import torch

from qatzip_tpu_torch.ops._build import Kernel, KernelError

MAX_PAYLOADS = 4
_SIGN = torch.iinfo(torch.int32).min   # u32 order <-> int32 order

KERNEL = Kernel("qz_sort_u32",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def sort_u32_ref(keys: torch.Tensor, *pays: torch.Tensor) -> tuple:
    """keys, pays: int32[B, n] u32 bit patterns.  Returns (keys, *pays)
    sorted by key in u32 order."""
    skey, order = torch.sort(keys ^ _SIGN, dim=1)
    return (skey ^ _SIGN, *(p.gather(1, order) for p in pays))


def sort_u32(keys: torch.Tensor, *pays: torch.Tensor) -> tuple:
    """As :func:`sort_u32_ref`, for n a power of 2 and a multiple of 1024
    and at most 4 payloads; on a CUDA tensor, the kernel."""
    if len(pays) > MAX_PAYLOADS:
        raise ValueError(f"sort_u32 moves at most {MAX_PAYLOADS} payloads")
    for t in (keys, *pays):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape != keys.shape:
            raise ValueError("sort_u32 takes int32[B, n] tensors of one shape")
        if t.device != keys.device:
            raise ValueError("sort_u32 inputs on different devices")
    B, n = keys.shape
    if n < 1024 or n % 1024 or n & (n - 1):
        raise ValueError(f"sort_u32 needs n a power of 2 and a multiple of "
                         f"1024, got {n}")
    if keys.device.type == "cpu":
        return sort_u32_ref(keys, *pays)
    if keys.device.type != "cuda":
        raise KernelError(f"no sort kernel for device {keys.device}")
    outs = [t.clone(memory_format=torch.contiguous_format)
            for t in (keys, *pays)]
    if B:
        ptrs = [o.data_ptr() for o in outs[1:]]
        ptrs += [None] * (MAX_PAYLOADS - len(ptrs))
        KERNEL(outs[0].data_ptr(), *ptrs, B, n, len(pays),
               torch.cuda.current_stream(keys.device).cuda_stream)
    return tuple(outs)
