"""DEFLATE length/distance codes computed arithmetically, and the table
lookups and histograms of the device encoder.

Port of qatzip_tpu/ops/codes.py (lines 26-93).  The RFC1951 length and
distance codes come from closed forms:

  length L in [3,258], l = L-3:
    l < 8:   code 257+l, eb 0
    l >= 8:  eb = floor(log2 l) - 2, code = 257 + 4*(eb+1) + ((l>>eb)&3),
             extra = l & ((1<<eb)-1)
    L == 258: code 285, eb 0 (special-cased by RFC)

  distance D in [1,32768], v = D-1:
    v < 4:   code v, eb 0
    v >= 4:  eb = floor(log2 v) - 1, code = 2*(eb+1) + ((v>>eb)&1),
             extra = v & ((1<<eb)-1)

floor(log2 x) comes from the float32 exponent (exact for x < 2^24).  The
reference's one-hot matmuls stand in for gathers the TPU lacks; on a GPU
a lookup is an index and a weighted histogram an ``index_add_``, with the
same integers.
"""
from __future__ import annotations

import torch


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int32 x >= 1 via the float32 exponent."""
    bits = x.to(torch.float32).view(torch.int32)
    return (bits >> 23) - 127


def length_code(mlen: torch.Tensor):
    """mlen int32 (>=3 where used) -> (code, extra_bits, extra_val)."""
    mlen = mlen.to(torch.int32)
    l = torch.clamp(mlen - 3, min=0)
    small = l < 8
    lg = floor_log2(torch.clamp(l, min=1))
    eb = torch.where(small, 0, lg - 2)
    eb0 = torch.clamp(eb, min=0)
    code = torch.where(small, 257 + l, 257 + 4 * (eb + 1) + ((l >> eb0) & 3))
    ev = torch.where(small, 0, l & ((1 << eb0) - 1))
    is258 = mlen == 258
    code = torch.where(is258, 285, code)
    eb = torch.where(is258, 0, eb)
    ev = torch.where(is258, 0, ev)
    return code.to(torch.int32), eb.to(torch.int32), ev.to(torch.int32)


def dist_code(mdist: torch.Tensor):
    """mdist int32 (>=1 where used) -> (code, extra_bits, extra_val)."""
    v = torch.clamp(mdist.to(torch.int32) - 1, min=0)
    small = v < 4
    lg = floor_log2(torch.clamp(v, min=1))
    eb = torch.where(small, 0, lg - 1)
    eb0 = torch.clamp(eb, min=0)
    code = torch.where(small, v, 2 * (eb + 1) + ((v >> eb0) & 1))
    ev = torch.where(small, 0, v & ((1 << eb0) - 1))
    return code.to(torch.int32), eb.to(torch.int32), ev.to(torch.int32)


def onehot_lookup(indices: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[indices] (indices [..., n], table [k, c]) as float32
    [..., n, c], the reference's one-hot matmul result (exact for table
    values < 2^24)."""
    return table.to(torch.float32)[indices.long()]


def onehot_lookup1(indices: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[indices] for a 1-D integer table; int32 with indices' shape."""
    return table.to(torch.int32)[indices.long()]


def onehot_histogram(indices: torch.Tensor, weights: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Histogram of ``indices`` [n] with integer ``weights`` [n]; int32
    [k].  Exact integer sums (the reference's matmul is exact below
    2^24)."""
    out = torch.zeros(k, dtype=torch.int64, device=indices.device)
    out.index_add_(0, indices.long(), weights.long())
    return out.to(torch.int32)
