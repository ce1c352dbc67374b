"""Host orchestration of the lockstep inflate rounds.

Port of the lockstep half of qatzip_tpu/ops/deflate_decode.py:
``inflate_batch`` (:463-522), ``_run_device_round`` (:562-575),
``_lockstep_regions`` (:582-595) and ``_run_device_round_lockstep``
(:633-699).  The host parses block headers and builds table regions, the
device decodes tokens (ops/inflate.py), and the native ``apply_tokens``
(shared with the reference) does the LZ77 window copies.  The stream
state (``_Stream``, with its 32 KB history window) and the header parser
are the reference's, imported.

A stream the device cannot prove correct comes back as None and the
caller inflates it on the CPU; ``failover_lanes`` counts them.
"""
from __future__ import annotations

import numpy as np
import torch

from qatzip_tpu.ops.deflate_decode import (MAX_OUTCAP, MAX_PAYLOAD, _Stream,
                                           _apply_tokens_py,
                                           _parse_one_header)
from qatzip_tpu_torch.ops import inflate as PI

try:  # native token applier (qz_apply_tokens); python fallback below
    from qatzip_tpu.native import qzcore as _native
except ImportError:  # pragma: no cover - native build optional
    _native = None

_LOCKSTEP_NW = (1024, 4096, 16896)       # stream words per lane (buckets)
_LOCKSTEP_STEPS = (1024, 4096, 16384, 65664)

# streams handed back to the caller for CPU inflate, over the process
failover_lanes = 0


def inflate_batch(payloads, hints, device: torch.device,
                  max_rounds: int = 64, kind: str | None = None,
                  ran_out: list | None = None):
    """Inflate complete raw-deflate streams on ``device``.

    Returns a list of (data: bytes, end_of_stream: bool, checksum) entries
    (checksum per ``kind`` — "crc32"/"adler32" — or None when kind is
    unset), or None for streams that must fall back to the CPU path."""
    global failover_lanes
    if kind == "xxh32":
        kind = None  # not combinable from parts; caller computes on host
    streams = []
    for i, (pl, hint) in enumerate(zip(payloads, hints)):
        s = _Stream(bytes(pl), int(hint), i, kind=kind or "")
        if len(s.payload) == 0 or len(s.payload) > MAX_PAYLOAD:
            s.failed = True
        if hint is not None and hint > MAX_OUTCAP:
            s.failed = True
        streams.append(s)

    if ran_out is not None:
        ran_out.clear()
    for _ in range(max_rounds):
        batch = []
        for s in streams:
            if s.done or s.failed:
                continue
            # parse as many host-handled (stored) blocks as possible and
            # stop at a Huffman block or stream end
            try:
                while not s.done:
                    if _parse_one_header(s) == "huff":
                        batch.append(s)
                        break
            except (EOFError, ValueError):
                s.failed = True
        if not batch:
            break
        if ran_out is not None and not ran_out:
            ran_out.append(True)  # at least one real device round executed
        _run_device_round(batch, device)

    results = []
    for s in streams:
        if s.failed or not s.done:
            results.append(None)
        else:
            crc = s.crc if s.kind else None
            if s.kind and s.crc_len == 0:  # empty stream
                crc = 1 if s.kind == "adler32" else 0
            results.append((bytes(s.out), True, crc))
    failover_lanes += results.count(None)
    return results


def _run_device_round(batch, device: torch.device) -> None:
    """Dispatch one device decode round.  Rounds take up to LANES blocks,
    sorted by remaining payload so similar-sized blocks share a round
    (lockstep runs to the slowest lane)."""
    order = sorted(batch, key=lambda s: len(s.payload) - (s.bits.pos >> 3))
    for i in range(0, len(order), PI.LANES):
        _run_device_round_lockstep(order[i:i + PI.LANES], device)


def _lockstep_regions(s):
    """Packed 9-bit table regions for one block (ops/inflate.py layout)."""
    if getattr(s, "_lens", None) is None:
        return PI.static_regions()
    ll_lens, d_lens = s._lens
    return PI.build_ll_region(ll_lens), PI.build_d_region(d_lens)


def pack_round(batch):
    """Lay out one lockstep round: per-lane stream words, start bits, bit
    counts, table regions and active flags, and the step bound.  Streams
    the round cannot take are marked failed.  Returns (live, inputs) with
    inputs = (stream_words u32[LANES, NW], bit0, nbits, tll, td, active,
    max_steps), or (live, None) when no stream is left."""
    B = PI.LANES
    live: list[tuple] = []
    for s in batch:
        try:
            regions = _lockstep_regions(s)
        except ValueError:
            s.failed = True  # over-subscribed/invalid code: CPU decides
            continue
        byte0 = s.bits.pos >> 3
        words = (len(s.payload) - byte0 + 3) // 4 + 2
        if words > _LOCKSTEP_NW[-1]:
            s.failed = True  # beyond the per-lane stream budget
            continue
        rem = (s.hint - len(s.out)) if (s.hint and s.hint > 0) else (1 << 16)
        rem = max(1, min(rem, MAX_OUTCAP))
        live.append((s, regions, byte0, rem, words))
    if not live:
        return live, None

    NW = next(b for b in _LOCKSTEP_NW if b >= max(t[4] for t in live))
    need = min(65537, max(t[3] for t in live) + 2)
    MS = next(b for b in _LOCKSTEP_STEPS if b >= need)

    stream8 = np.zeros((B, NW * 4), np.uint8)
    bit0 = np.zeros((B,), np.int32)
    nbits = np.zeros((B,), np.int32)
    tll = np.zeros((B, PI.CELLS), np.uint32)
    td = np.zeros((B, PI.CELLS), np.uint32)
    active = np.zeros((B,), bool)
    for i, (s, regions, byte0, rem, words) in enumerate(live):
        pv = np.frombuffer(s.payload, np.uint8, len(s.payload) - byte0,
                           byte0)
        stream8[i, :len(pv)] = pv
        bit0[i] = s.bits.pos & 7
        nbits[i] = len(pv) * 8
        tll[i], td[i] = regions
        active[i] = True
    return live, (stream8.view("<u4"), bit0, nbits, tll, td, active, MS)


def _run_device_round_lockstep(batch, device: torch.device) -> None:
    live, inputs = pack_round(batch)
    if inputs is None:
        return
    tokens, err, outcnt, end_bit, _ns = PI.decode_blocks(*inputs, device)
    tokens = np.ascontiguousarray(tokens)

    for i, (s, regions, byte0, rem, words) in enumerate(live):
        if err[i] or end_bit[i] < 0 or outcnt[i] > rem:
            s.failed = True
            continue
        try:
            if _native is not None:
                data = _native.apply_tokens(tokens, i, s.window,
                                            len(s.window), int(outcnt[i]))
            else:
                data = _apply_tokens_py(tokens[:, i], s.window,
                                        int(outcnt[i]))
        except ValueError:
            s.failed = True
            continue
        if len(data) != int(outcnt[i]):
            s.failed = True
            continue
        s.push(data)
        s.bits.pos = (byte0 << 3) + int(end_bit[i])
        if s.final_block:
            s.done = True
