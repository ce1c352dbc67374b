"""Host orchestration of the lockstep inflate rounds.

Port of the lockstep half of qatzip_tpu/ops/deflate_decode.py:
``inflate_batch`` (:463-522), ``_lockstep_regions`` (:582-595) and
``_run_device_round_lockstep`` (:633-699).  The reference's
``_run_device_round`` (:562-575) sorts a batch and cuts it into launches of
128 lanes; here one launch takes the whole batch (the caller bounds the
width: DeflateDeviceCodec.LOCKSTEP_BATCH), a lane a CTA that waits for no
other lane, so nothing is sorted.  The host parses block headers and builds
table regions, the device decodes tokens (ops/inflate.py), and the native ``apply_tokens``
does the LZ77 window copies.  The stream state (``_Stream``, with its 32 KB
history window), the bit reader, the header parsers and the Python token
applier are copies of the reference's.

A stream the device cannot prove correct comes back as None and the
caller inflates it on the CPU; ``failover_lanes`` counts them.
"""
from __future__ import annotations

import numpy as np
import torch

from qatzip_tpu_torch.ops import deflate_tables as T
from qatzip_tpu_torch.ops import inflate as PI

try:  # native token applier (qz_apply_tokens); python fallback below
    from qatzip_tpu_torch.native import qzcore as _native
except ImportError:  # pragma: no cover - native build optional
    _native = None

MAX_PAYLOAD = 1 << 20     # payloads larger than 1 MB route to the CPU path
MAX_OUTCAP = 1 << 20

_LOCKSTEP_NW = (1024, 4096, 16896)       # stream words per lane (buckets)
_LOCKSTEP_STEPS = (1024, 4096, 16384, 65664)

# streams handed back to the caller for CPU inflate, over the process
failover_lanes = 0


# ---------------------------------------------------------------------------
# Host side: bit reader, header parsing, stream state (copies of the
# reference's)
# ---------------------------------------------------------------------------
class _Bits:
    """LSB-first bit reader over bytes (deflate bit order, RFC1951 3.1.1)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos  # absolute bit position

    def read(self, n: int) -> int:
        v = 0
        for i in range(n):
            p = self.pos + i
            byi = p >> 3
            if byi >= len(self.data):
                raise EOFError("deflate stream truncated")
            v |= ((self.data[byi] >> (p & 7)) & 1) << i
        self.pos += n
        return v


def parse_dynamic_header(br: _Bits) -> tuple[np.ndarray, np.ndarray]:
    """Parse the BTYPE=10 code-length section (RFC1951 3.2.7).  Returns
    (litlen lens[hlit], dist lens[hdist])."""
    hlit = br.read(5) + 257
    hdist = br.read(5) + 1
    hclen = br.read(4) + 4
    cl_lens = np.zeros(19, np.int32)
    for i in range(hclen):
        cl_lens[T.CLCODE_ORDER[i]] = br.read(3)
    cl_codes = T.canonical_codes(cl_lens)
    # host decode of the ~300 code lengths via a dict keyed by (len, code)
    dec = {}
    for s in range(19):
        if cl_lens[s]:
            dec[(int(cl_lens[s]), int(cl_codes[s]))] = s
    lens = np.zeros(hlit + hdist, np.int32)
    i = 0
    while i < hlit + hdist:
        code = 0
        clen = 0
        while True:
            code = (code << 1) | br.read(1)
            clen += 1
            if clen > 15:
                raise ValueError("bad code-length code")
            if (clen, code) in dec:
                sym = dec[(clen, code)]
                break
        if sym < 16:
            lens[i] = sym
            i += 1
        elif sym == 16:
            if i == 0:
                raise ValueError("repeat with no previous length")
            rep = 3 + br.read(2)
            lens[i:i + rep] = lens[i - 1]
            i += rep
        elif sym == 17:
            i += 3 + br.read(3)
        else:
            i += 11 + br.read(7)
    if i != hlit + hdist:
        raise ValueError("code-length overrun")
    return lens[:hlit], lens[hlit:]


class _Stream:
    __slots__ = ("payload", "hint", "bits", "out", "window", "done", "failed",
                 "final_block", "index", "_lens", "kind", "crc", "crc_len")

    def __init__(self, payload: bytes, hint: int, index: int,
                 kind: str = "crc32"):
        self.payload = payload
        self.hint = hint
        self.bits = _Bits(payload)
        self.out = bytearray()
        self.window = b""
        self.done = False
        self.failed = False
        self.final_block = False
        self.index = index
        self.kind = kind
        self.crc: int | None = None  # running checksum of self.out
        self.crc_len = 0

    def push(self, data: bytes, part_crc: int | None = None) -> None:
        """Append decoded bytes; fold ``part_crc`` (device-computed checksum
        of this part) into the running stream checksum.  Host computes the
        part only for host-handled stored blocks."""
        import zlib as _z

        from qatzip_tpu_torch.utils import checksum as _ck

        if self.kind:
            if part_crc is None:
                part_crc = (_z.adler32(data) if self.kind == "adler32"
                            else _z.crc32(data)) & 0xFFFFFFFF
            if self.crc is None or self.crc_len == 0:
                self.crc = part_crc
            elif self.kind == "adler32":
                self.crc = _ck.adler32_combine(self.crc, part_crc, len(data))
            else:
                self.crc = _ck.crc32_combine(self.crc, part_crc, len(data))
            self.crc_len += len(data)
        self.out += data
        w = self.window + data
        self.window = w[-32768:] if len(w) > 32768 else w


def _parse_one_header(s: _Stream) -> str:
    """Advance past one block header.  Returns 'huff' (device decode needed;
    tables stashed on the stream), or handles a stored block / stream end
    inline and returns 'stored' / 'end'."""
    br = s.bits
    bfinal = br.read(1)
    btype = br.read(2)
    s.final_block = bool(bfinal)
    if btype == 0:
        br.pos = (br.pos + 7) & ~7  # byte-align
        byi = br.pos >> 3
        if byi + 4 > len(s.payload):
            raise EOFError("truncated stored block")
        ln = int.from_bytes(s.payload[byi:byi + 2], "little")
        nlen = int.from_bytes(s.payload[byi + 2:byi + 4], "little")
        if ln != (~nlen & 0xFFFF):
            raise ValueError("stored block LEN/NLEN mismatch")
        data = s.payload[byi + 4:byi + 4 + ln]
        if len(data) != ln:
            raise EOFError("truncated stored block data")
        s.push(data)
        br.pos = (byi + 4 + ln) << 3
        if bfinal:
            s.done = True
            return "end"
        return "stored"
    if btype == 1:
        s._lens = None  # static tables; engines cache their builds
        return "huff"
    if btype == 2:
        # stash the code lengths; each decode engine (lockstep regions /
        # speculative flat tables) builds its own table form at round time
        s._lens = parse_dynamic_header(br)  # type: ignore[attr-defined]
        return "huff"
    raise ValueError("reserved BTYPE")


def _apply_tokens_py(lane_tokens: np.ndarray, window: bytes,
                     cap: int) -> bytes:
    """Python fallback for qz_apply_tokens (native absent)."""
    out = bytearray()
    wl = len(window)
    for t in lane_tokens:
        t = int(t)
        if t == 0:
            continue
        if t & 1:
            if len(out) >= cap:
                raise ValueError("token overflow")
            out.append((t >> 1) & 0xFF)
            if t & 0x200:  # paired second literal (bits 10..17)
                if len(out) >= cap:
                    raise ValueError("token overflow")
                out.append((t >> 10) & 0xFF)
            continue
        if not t & 2:
            raise ValueError("bad token")
        ln = (t >> 2) & 0x1FF
        d = ((t >> 11) & 0x7FFF) + 1
        if ln < 3 or ln > 258 or len(out) + ln > cap:
            raise ValueError("bad token")
        for _ in range(ln):
            p = len(out) - d
            if p >= 0:
                out.append(out[p])
            elif wl + p >= 0:
                out.append(window[wl + p])
            else:
                raise ValueError("window underrun")
    return bytes(out)


# ---------------------------------------------------------------------------
# Rounds
# ---------------------------------------------------------------------------
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
        _run_device_round_lockstep(batch, device)

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
    inputs = (stream_words u32[lanes, NW], bit0, nbits, tll, td, active,
    max_steps), or (live, None) when no stream is left.  A round has one
    lane a live stream, in batch order, so every lane is active: ``active``
    is kept for the reference's interface (an inactive lane decodes
    nothing), and only the tests clear it."""
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

    B = len(live)
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
