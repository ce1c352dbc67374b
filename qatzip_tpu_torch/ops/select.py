"""Candidate select for the hybrid match finder.

Port of qatzip_tpu/ops/pallas_select.py.  It sits after sort 1 of
ops/match_finder.py: given one block's hash-sorted keys and prefix words,
each record looks back at its depth nearest sorted neighbours and keeps the
best candidate distance.

uint32 data travels as int32 tensors holding the same bit pattern (torch
has no uint32 shift on the CPU).

* :func:`select_candidates_ref` is the plain torch version: the XLA branch
  of qatzip_tpu/ops/match_finder.py:134-162 written in torch.
* :func:`select_to_positions_ref` follows it with the scatter back to
  position order (:func:`to_positions`), the array ``find_candidates``
  returns.
* :func:`select_candidates` and :func:`select_to_positions` run the plain
  versions for tensors on the CPU, and for CUDA tensors launch the two
  entries of ``csrc/select.cu`` or raise.  The kernel takes rows sorted as
  sort 1 leaves them (``csrc/select.cuh``) and the depths in
  :data:`DEPTHS`; the plain versions take any depth.
"""
from __future__ import annotations

import ctypes

import torch

from qatzip_tpu_torch.ops._build import Kernel, KernelError

TOO_FAR = 4096   # len-3 matches beyond this distance are not worth bits
_INV = -1        # invalid key 0xFFFFFFFF as int32
# the kernel's template depths: deflate_encode.level_params' 8, 12 and 16
# (deflate L1/L2 raise theirs to 16), and match_finder.DEPTH's 4
DEPTHS = (4, 8, 12, 16)

KERNEL = Kernel("qz_select_candidates",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
POS_KERNEL = Kernel("qz_select_to_positions",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])


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


def to_positions(sk: torch.Tensor, dist_sorted: torch.Tensor,
                 n_full: int) -> torch.Tensor:
    """Sorted-order distances back to position order (the reference's sort
    2 and stride interleave): every valid record's distance lands in column
    pos of a uint16[B, n_full] row, every other column is 0."""
    # invalid records go to a dropped column
    col = torch.where(sk != _INV, (sk & 0xFFFF).to(torch.int64), n_full)
    out = torch.zeros((sk.shape[0], n_full + 1), dtype=torch.int32,
                      device=sk.device)
    out.scatter_(1, col, dist_sorted)
    return out[:, :n_full].to(torch.uint16)


def select_to_positions_ref(sk: torch.Tensor, sb4: torch.Tensor,
                            sb4b: torch.Tensor, depth: int,
                            n_full: int) -> torch.Tensor:
    """:func:`select_candidates_ref`, then :func:`to_positions`."""
    return to_positions(sk, select_candidates_ref(sk, sb4, sb4b, depth),
                        n_full)


def _check_inputs(sk, sb4, sb4b, what: str) -> None:
    for t in (sk, sb4, sb4b):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape != sk.shape:
            raise ValueError(f"{what} takes three int32[B, n] tensors of "
                             f"one shape")
        if t.device != sk.device:
            raise ValueError(f"{what} inputs on different devices")


def _check_kernel(sk, depth: int) -> None:
    if sk.device.type != "cuda":
        raise KernelError(f"no select kernel for device {sk.device}")
    if depth not in DEPTHS:
        raise ValueError(f"the select kernel takes depth {DEPTHS}, not "
                         f"{depth}")
    if sk.shape[0] > 65535:
        raise ValueError("the select kernel takes at most 65535 rows")


def select_candidates(sk: torch.Tensor, sb4: torch.Tensor,
                      sb4b: torch.Tensor, depth: int) -> torch.Tensor:
    """As :func:`select_candidates_ref`; on a CUDA tensor, the kernel."""
    _check_inputs(sk, sb4, sb4b, "select_candidates")
    if sk.device.type == "cpu":
        return select_candidates_ref(sk, sb4, sb4b, depth)
    _check_kernel(sk, depth)
    B, n = sk.shape
    sk, sb4, sb4b = (t.contiguous() for t in (sk, sb4, sb4b))
    out = torch.empty_like(sk)
    if out.numel():
        KERNEL(sk.data_ptr(), sb4.data_ptr(), sb4b.data_ptr(), out.data_ptr(),
               B, n, depth, torch.cuda.current_stream(sk.device).cuda_stream)
    return out


def select_to_positions(sk: torch.Tensor, sb4: torch.Tensor,
                        sb4b: torch.Tensor, depth: int,
                        n_full: int) -> torch.Tensor:
    """As :func:`select_to_positions_ref`; on a CUDA tensor, the kernel's
    position-order entry on a zeroed row (one memset)."""
    _check_inputs(sk, sb4, sb4b, "select_to_positions")
    if sk.device.type == "cpu":
        return select_to_positions_ref(sk, sb4, sb4b, depth, n_full)
    _check_kernel(sk, depth)
    B, n = sk.shape
    sk, sb4, sb4b = (t.contiguous() for t in (sk, sb4, sb4b))
    # int16 zeros viewed as uint16: the bits the kernel stores
    out = torch.zeros((B, n_full), dtype=torch.int16,
                      device=sk.device).view(torch.uint16)
    if sk.numel() and n_full:
        POS_KERNEL(sk.data_ptr(), sb4.data_ptr(), sb4b.data_ptr(),
                   out.data_ptr(), B, n, n_full, depth,
                   torch.cuda.current_stream(sk.device).cuda_stream)
    return out
