"""Candidate select for the hybrid match finder.

Port of qatzip_tpu/ops/pallas_select.py.  It sits between the two sorts of
ops/match_finder.py: given one block's hash-sorted keys and prefix words,
each record looks back at its depth nearest sorted neighbours and keeps
the best candidate distance.

uint32 data travels as int32 tensors holding the same bit pattern (torch
has no uint32 shift on the CPU).

* :func:`select_candidates_ref` is the plain torch version: the XLA branch
  of qatzip_tpu/ops/match_finder.py:134-162 written in torch.
* :func:`select_candidates` runs it for a tensor on the CPU, and for a CUDA
  tensor launches ``csrc/select.cu`` or raises.
"""
from __future__ import annotations

import ctypes

import torch

from qatzip_tpu_torch.ops._build import Kernel, KernelError

TOO_FAR = 4096   # len-3 matches beyond this distance are not worth bits
_INV = -1        # invalid key 0xFFFFFFFF as int32

KERNEL = Kernel("qz_select_candidates",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _shift_right(a: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """value at column i <- column i-k (first k columns = fill)."""
    pad = a.new_full((a.shape[0], k), fill)
    return torch.cat([pad, a[:, :-k]], dim=1)[:, :a.shape[1]]


def select_candidates_ref(sk: torch.Tensor, sb4: torch.Tensor,
                          sb4b: torch.Tensor, depth: int) -> torch.Tensor:
    """sk/sb4/sb4b: int32[B, n] sorted arrays (u32 bit patterns).
    Returns int32[B, n] best candidate distance per sorted record."""
    cur_pos = sk & 0xFFFF
    cur_h = (sk >> 16) & 0xFFFF
    cur_ok = sk != _INV
    best8 = torch.zeros_like(sk)   # nearest, 8-byte prefix
    best4 = torch.zeros_like(sk)   # nearest, 4-byte prefix
    best3 = torch.zeros_like(sk)   # nearest, 3-byte prefix
    for dd in range(1, depth + 1):
        ck = _shift_right(sk, dd, _INV)
        cb4 = _shift_right(sb4, dd, 0)
        cb4b = _shift_right(sb4b, dd, 0)
        dist = cur_pos - (ck & 0xFFFF)
        ok = (cur_ok & (ck != _INV) & (((ck >> 16) & 0xFFFF) == cur_h)
              & (dist >= 1) & (dist <= 32767))
        eq4 = ok & (cb4 == sb4)
        eq8 = eq4 & (cb4b == sb4b)
        eq3 = ok & (((cb4 ^ sb4) & 0xFFFFFF) == 0)
        # nearest-first within rank (dd ascends by recency in a chain)
        best8 = torch.where((best8 == 0) & eq8, dist, best8)
        best4 = torch.where((best4 == 0) & eq4, dist, best4)
        best3 = torch.where((best3 == 0) & eq3, dist, best3)
    best3 = torch.where(best3 < TOO_FAR, best3, 0)
    return torch.where(best8 > 0, best8, torch.where(best4 > 0, best4, best3))


def select_candidates(sk: torch.Tensor, sb4: torch.Tensor,
                      sb4b: torch.Tensor, depth: int) -> torch.Tensor:
    """As :func:`select_candidates_ref`; on a CUDA tensor, the kernel."""
    for t in (sk, sb4, sb4b):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape != sk.shape:
            raise ValueError("select_candidates takes three int32[B, n] "
                             "tensors of one shape")
        if t.device != sk.device:
            raise ValueError("select_candidates inputs on different devices")
    if sk.device.type == "cpu":
        return select_candidates_ref(sk, sb4, sb4b, depth)
    if sk.device.type != "cuda":
        raise KernelError(f"no select kernel for device {sk.device}")
    B, n = sk.shape
    sk, sb4, sb4b = (t.contiguous() for t in (sk, sb4, sb4b))
    out = torch.empty_like(sk)
    if out.numel():
        KERNEL(sk.data_ptr(), sb4.data_ptr(), sb4b.data_ptr(), out.data_ptr(),
               B, n, depth, torch.cuda.current_stream(sk.device).cuda_stream)
    return out
