"""Sort-based LZ77 candidate finder: the device half of the hybrid deflate
pipeline.

Port of qatzip_tpu/ops/match_finder.py (``find_candidates``, lines 48-180).
Per block of n <= 65536 bytes, batched [B, n]:

  1. 3-byte hash keys  key1 = h15 << 16 | pos16  (elementwise)
  2. sort 1 by key1, stable, carrying the prefix words b4 (bytes p..p+3)
     and, with rank8, b4b (bytes p+4..p+7)
  3. candidate select over the sorted neighbours (ops/select.py, the
     ported Pallas kernel), straight into position order: every valid
     record's distance lands in output column pos, every other column is
     0.  The reference does this with a second sort and a stride
     interleave; the kernel's stores give the same array.

The candidates are verified only to a 3/4/8-byte prefix; the native parser
(qz_deflate_candidates, shared with the reference) re-verifies and extends
them.  Keys are built in int64, because torch on the CPU has no uint32
shift; the product b3 * 2654435761 stays below 2**56 and is masked to 32
bits before the shift.  ``find_candidates_packed`` packs the candidates
into the reference's 0.75-byte-a-position format (lines 183-247);
``find_candidates_batch`` (lines 250-263) is the host wrapper, block-DP
over a list of devices.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from qatzip_tpu_torch.ops.select import select_to_positions

DEPTH = 4            # hash-chain depth (the level -> depth map is the caller's)
_INVALID = 0xFFFFFFFF
_M32 = 0xFFFFFFFF
_SIGN = torch.iinfo(torch.int32).min   # u32 order <-> int32 order


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def find_candidates(data: torch.Tensor, lengths: torch.Tensor,
                    depth: int = DEPTH, stride: int | None = None,
                    rank8: bool | None = None) -> torch.Tensor:
    """data: uint8[B, n+8] zero-padded, n <= 65536; lengths: int32[B], on one
    device.  Returns uint16[B, n] on that device: per-position candidate
    distance (0 = none).

    ``stride`` (env QATZIP_TPU_MF_STRIDE, default 1) indexes only every
    stride-th position; ``rank8`` (env QATZIP_TPU_MF_RANK8, default on)
    carries the second prefix word through the sort so candidates rank by
    an 8-byte prefix."""
    if stride is None:
        stride = int(os.environ.get("QATZIP_TPU_MF_STRIDE", "1"))
    if rank8 is None:
        rank8 = os.environ.get("QATZIP_TPU_MF_RANK8", "1") != "0"
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be uint8[B, n+8]")
    n = data.shape[1] - 8
    if not 0 < n <= 65536:
        raise ValueError("block width must be 1..65536 bytes")
    return _find_candidates_impl(data, lengths, int(depth), int(stride),
                                 bool(rank8))


def _find_candidates_impl(data: torch.Tensor, lengths: torch.Tensor,
                          depth: int, stride: int,
                          rank8: bool) -> torch.Tensor:
    sk, sb4, sb4b = sorted_records(data, lengths, stride, rank8)
    # select, then sort 2 + stride interleave: each valid record's distance
    # goes to its position
    return select_to_positions(sk, sb4, sb4b, depth, data.shape[1] - 8)


def hash_records(data: torch.Tensor, lengths: torch.Tensor, stride: int,
                 rank8: bool):
    """Step 1: the records in position order.  Returns (key1, b4, b4b) as
    int32[B, n // stride] u32 bit patterns: key h15 << 16 | pos16
    (0xFFFFFFFF where fewer than 3 bytes remain), prefix bytes p..p+3 and,
    with rank8, p+4..p+7 (zeros without)."""
    B = data.shape[0]
    n = data.shape[1] - 8
    d = data.to(torch.int64)
    b4 = (d[:, 0:n] | (d[:, 1:n + 1] << 8)
          | (d[:, 2:n + 2] << 16) | (d[:, 3:n + 3] << 24))
    h = (((b4 & 0xFFFFFF) * 2654435761) & _M32) >> 17   # 15-bit 3-gram hash
    pos = torch.arange(n, dtype=torch.int64, device=data.device)[None, :]
    valid = pos + 2 < lengths.to(torch.int64)[:, None]
    key1 = torch.where(valid, (h << 16) | pos, _INVALID)
    b4b = (torch.cat([b4[:, 4:], b4.new_zeros((B, 4))], dim=1)
           if rank8 else torch.zeros_like(b4))     # eq8 degenerates to eq4
    if stride > 1:
        # index only every stride-th position; the native parser's
        # byte-compare extension recovers most of the lost coverage
        lim = (n // stride) * stride   # trim the ragged tail
        key1, b4, b4b = (t[:, :lim:stride] for t in (key1, b4, b4b))
    return _as_i32(key1), _as_i32(b4), _as_i32(b4b)


def sorted_records(data: torch.Tensor, lengths: torch.Tensor, stride: int,
                   rank8: bool):
    """Steps 1-2: hash keys and sort 1.  Returns the hash-sorted (sk, sb4,
    sb4b) as int32[B, n // stride] u32 bit patterns — the input of the
    candidate select."""
    key1, b4, b4b = hash_records(data, lengths, stride, rank8)
    # stable sort on the key biased into int32 order, payloads gathered
    skey, order = torch.sort(key1 ^ _SIGN, dim=1, stable=True)
    return (skey ^ _SIGN, b4.gather(1, order),
            b4b.gather(1, order) if rank8 else b4b)


# Packed candidate format (the reference's round-4 D2H cut): the uint16 a
# position costs 2 bytes of device-to-host traffic an input byte; this packs
# to a fixed 0.75:
#   2-bit class a position (n/4 bytes): 0 = no candidate; 1 = the same
#     distance as the previous position; 2 = exception (distance in the side
#     stream); 3 = distance 1
#   exception stream (n/2 bytes): for each 64-position chunk, up to 16 uint16
#     distances in position order, little-endian; exceptions beyond 16 become
#     class 1, a stale guess the parser's byte-compare verification makes
#     safe.
# Decoded by qz_deflate_candidates_packed (native/qzdeflate.cpp).
EXC_PER_CHUNK = 16
CHUNK_P = 64


def _find_candidates_packed_impl(data: torch.Tensor, lengths: torch.Tensor,
                                 depth: int, stride: int) -> torch.Tensor:
    d = _find_candidates_impl(data, lengths, depth, stride,
                              True).to(torch.int32)
    B, n = d.shape
    prev = torch.cat([d.new_zeros((B, 1)), d[:, :-1]], dim=1)
    isrep = (d == prev) & (d != 0)
    cls = torch.where(d == 0, 0,
                      torch.where(isrep, 1, torch.where(d == 1, 3, 2)))
    nc = n // CHUNK_P
    f3 = (cls == 2).reshape(B, nc, CHUNK_P)
    lidx = torch.cumsum(f3.to(torch.int32), dim=-1) - 1
    keep3 = f3 & (lidx < EXC_PER_CHUNK)
    # overflowed exceptions degrade to "repeat previous" rather than "none":
    # the native parser verifies candidates by byte compare, so a stale
    # guess can only recover matches, never corrupt
    cls = torch.where((cls == 2) & ~keep3.reshape(B, n), 1, cls)
    d3 = d.reshape(B, nc, CHUNK_P)
    exc = torch.stack([torch.where(keep3 & (lidx == s), d3, 0).sum(dim=-1)
                       for s in range(EXC_PER_CHUNK)], dim=-1)
    two = (cls[:, 0::4] | (cls[:, 1::4] << 2) | (cls[:, 2::4] << 4)
           | (cls[:, 3::4] << 6))
    exc = exc.reshape(B, nc * EXC_PER_CHUNK)
    exc8 = torch.stack([exc & 0xFF, exc >> 8], dim=-1).reshape(B, -1)
    return torch.cat([two, exc8], dim=1).to(torch.uint8)  # u8 [B, 3n/4]


def find_candidates_packed(data: torch.Tensor, lengths: torch.Tensor,
                           depth: int = DEPTH) -> torch.Tensor:
    """Packed variant of :func:`find_candidates`: uint8[B, 3n/4] in the
    format above, n a multiple of 64 (stride mode is not packed: the stride
    knob already trades ratio)."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be uint8[B, n+8]")
    n = data.shape[1] - 8
    if not 0 < n <= 65536 or n % CHUNK_P:
        raise ValueError("block width must be a multiple of 64 up to 65536")
    return _find_candidates_packed_impl(data, lengths, int(depth), 1)


def find_candidates_batch(data_np: np.ndarray, lengths_np: np.ndarray,
                          depth: int = DEPTH, mesh=None,
                          device: torch.device | None = None) -> np.ndarray:
    """Host wrapper: upload, run, return uint16[B, n] distances as numpy.

    Runs on ``device`` (default ``cuda:0``), or with ``mesh`` (a list of
    devices, parallel/shard.py) a contiguous slice of the batch on each
    device when there are at least two blocks a device."""
    from qatzip_tpu_torch.parallel import shard

    B = data_np.shape[0]
    slices = shard.block_slices(B, mesh)
    if slices is None:
        if device is None:
            device = mesh[0] if mesh else torch.device("cuda", 0)
        slices = [(device, 0, B)]
    out = []
    for dev, start, end in slices:
        with shard.on(dev):
            out.append(find_candidates(
                torch.from_numpy(np.ascontiguousarray(data_np[start:end])).to(
                    dev),
                torch.from_numpy(np.ascontiguousarray(
                    lengths_np[start:end])).to(dev), depth))
    return shard.gather(out)
