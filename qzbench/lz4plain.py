"""LZ4 blocks and frames, made and read without the program.

Written from the LZ4 block and frame format descriptions
(https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md and
lz4_Frame_format.md), for many blocks at once:

* :func:`compress_blocks` is a greedy LZ4 compressor.  Each position's
  candidate is the latest earlier position of the block with the same 4
  bytes (one stable sort a block); a match's length follows from its
  successor's where both use the same offset, and is extended byte by
  byte, up to ``EXT_CAP`` bytes, where that chain ends.  The walk from a
  block's start takes the first position that has a match, as LZ4's fast
  mode does.  It keeps the format's end rules: the last 5 bytes are
  literals and no match starts in the last 12.  Any valid LZ4 will do
  here; this one is not the program's parse.
* :func:`decode_blocks` reads every byte as a possible sequence start
  (torch, on any device), walks every block's chain of sequences together
  (NumPy), resolves each match byte to a literal byte by pointer doubling
  (torch), and refuses what the format forbids.
* :func:`frame` and :func:`read_frames` write and read LZ4 frames, with
  their header, block and content checksums.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from qzbench import xxh32 as X

MAGIC = 0x184D2204
MIN_MATCH = 4
LAST_LITERALS = 5
MF_LIMIT = 12
MAX_OFFSET = 65535
EXT_CAP = 64          # bytes a match is extended past its chain's end
STORED = 0x80000000


class FormatError(ValueError):
    """The bytes break the LZ4 block or frame format or one of its checks."""


# ---------------------------------------------------------------------------
# Compressor
# ---------------------------------------------------------------------------
def _matches(data: torch.Tensor, lens: torch.Tensor):
    """For rows of ``data`` [B, n] (uint8, ``lens`` valid bytes each): the
    match each position may start, as (length, offset) int64 [B, n], length
    0 where none may."""
    B, n = data.shape
    dev = data.device
    d = torch.nn.functional.pad(data.long(), (0, EXT_CAP + 8))
    pos = torch.arange(n, device=dev).expand(B, n)
    ln = lens.long()[:, None]
    key = (d[:, :n] | d[:, 1:n + 1] << 8 | d[:, 2:n + 2] << 16
           | d[:, 3:n + 3] << 24)
    # a position without 4 bytes left gets a key of its own
    key = torch.where(pos + MIN_MATCH <= ln, key, (1 << 33) + pos)
    skey, order = torch.sort(key, dim=1, stable=True)
    same_key = torch.zeros_like(skey, dtype=torch.bool)
    same_key[:, 1:] = skey[:, 1:] == skey[:, :-1]
    prev = torch.full_like(order, -1)
    prev[:, 1:] = order[:, :-1]
    cand = torch.full((B, n), -1, dtype=torch.long, device=dev)
    cand.scatter_(1, order, torch.where(same_key, prev, -1))
    cand = torch.where(pos - cand <= MAX_OFFSET, cand, -1)
    has = cand >= 0
    # the match at i continues the match at i + 1 when both use one offset
    nxt = torch.full_like(cand, -2)
    nxt[:, :-1] = cand[:, 1:]
    chained = has & (nxt == cand + 1)
    # the chain's end: the first position at or after i not chained on
    big = torch.full_like(pos, n)
    ends = torch.where(chained, big, pos)
    end = torch.flip(torch.cummin(torch.flip(ends, [1]), dim=1).values, [1])
    # a chain's last match, extended byte by byte from its 4th byte
    flat = torch.nonzero((has & ~chained).reshape(-1)).squeeze(1)
    row, at = flat // n, flat % n
    w = n + EXT_CAP + 8
    a0 = row * w + at + MIN_MATCH
    b0 = row * w + cand.reshape(-1)[flat] + MIN_MATCH
    room = ln.reshape(-1)[row] - at - MIN_MATCH
    dflat = d.reshape(-1)
    grow = torch.zeros_like(flat)
    live = torch.arange(flat.numel(), device=dev)
    for k in range(EXT_CAP):
        live = live[(dflat[a0[live] + k] == dflat[b0[live] + k])
                    & (room[live] > k)]
        if not live.numel():
            break
        grow[live] += 1
    ext = torch.zeros(B * n, dtype=torch.long, device=dev)
    ext[flat] = grow
    ext = ext.reshape(B, n)
    at_end = torch.gather(ext, 1, end.clamp(max=n - 1))
    length = end - pos + MIN_MATCH + at_end
    length = torch.minimum(length, ln - LAST_LITERALS - pos)
    ok = has & (pos <= ln - MF_LIMIT) & (length >= MIN_MATCH)
    return torch.where(ok, length, 0), torch.where(ok, pos - cand, 0)


def _varlen(v: np.ndarray) -> np.ndarray:
    """Bytes of the length extension of each nibble-capped value ``v``."""
    return np.where(v >= 15, (v - 15) // 255 + 1, 0)


def _ramp(counts: np.ndarray) -> np.ndarray:
    """0..c-1 for each count, concatenated."""
    total = int(counts.sum())
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(total, dtype=np.int64) - starts


def _put_varlen(out, at, v, nbytes) -> None:
    """Write the length extensions of values ``v`` (>= 15 where nbytes > 0)
    at offsets ``at``: 255s, then the remainder."""
    has = nbytes > 0
    at, v, nbytes = at[has], v[has], nbytes[has]
    out[np.repeat(at, nbytes) + _ramp(nbytes)] = 255
    out[at + nbytes - 1] = (v - 15) % 255


def compress_blocks(chunks: list[bytes], device=None) -> list[bytes | None]:
    """Each chunk as one LZ4 block, or None where the block would not be
    smaller than the chunk (store it).  Chunks are at most 64 KB."""
    if not chunks:
        return []
    n = max(len(c) for c in chunks)
    B = len(chunks)
    host = np.zeros((B, n), np.uint8)
    lens = np.array([len(c) for c in chunks], np.int64)
    for i, c in enumerate(chunks):
        host[i, :len(c)] = np.frombuffer(c, np.uint8)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    mlen, moff = _matches(torch.from_numpy(host).to(dev),
                          torch.from_numpy(lens).to(dev))
    mlen = mlen.cpu().numpy()
    moff = moff.cpu().numpy()
    # the first position at or after i where a match may start
    idx = np.where(mlen > 0, np.arange(n), n)
    nextm = np.minimum.accumulate(idx[:, ::-1], axis=1)[:, ::-1]
    nextm = np.concatenate([nextm, np.full((B, 1), n)], axis=1)
    mlen = np.concatenate([mlen, np.zeros((B, 1), mlen.dtype)], axis=1)
    moff = np.concatenate([moff, np.zeros((B, 1), moff.dtype)], axis=1)
    # the greedy walk, every block a step at a time
    rows = np.arange(B)
    p = np.zeros(B, np.int64)
    seqs = []
    live = rows
    while live.size:
        m = nextm[live, p[live]]
        go = m < n
        live = live[go]
        m = m[go]
        if not live.size:
            break
        ml = mlen[live, m]
        seqs.append((live, p[live], m, ml, moff[live, m]))
        p[live] = m + ml
    if seqs:
        sb, sp, sm, sml, soff = (np.concatenate(a) for a in zip(*seqs))
    else:
        sb = sp = sm = sml = soff = np.zeros(0, np.int64)
    # the last literals of every block, as a sequence with no match
    sb = np.concatenate([sb, rows])
    sp = np.concatenate([sp, p])
    sm = np.concatenate([sm, lens])
    sml = np.concatenate([sml, np.zeros(B, np.int64)])
    soff = np.concatenate([soff, np.zeros(B, np.int64)])
    last = np.zeros(sb.size, bool)
    last[-B:] = True
    order = np.lexsort((sp, sb))
    sb, sp, sm, sml, soff, last = (a[order] for a in
                                   (sb, sp, sm, sml, soff, last))
    ll = sm - sp
    mc = np.where(last, 0, sml - MIN_MATCH)
    lle = _varlen(ll)
    mle = np.where(last, 0, _varlen(mc))
    size = 1 + lle + ll + np.where(last, 0, 2 + mle)
    at = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    out[at] = (np.minimum(ll, 15) << 4 | np.minimum(mc, 15)).astype(np.uint8)
    _put_varlen(out, at + 1, ll, lle)
    lit = at + 1 + lle
    src = host.reshape(-1)
    r = _ramp(ll)
    out[np.repeat(lit, ll) + r] = src[np.repeat(sb * n + sp, ll) + r]
    o = (lit + ll)[~last]
    off = soff[~last]
    out[o] = off & 0xFF
    out[o + 1] = off >> 8
    _put_varlen(out, o + 2, mc[~last], mle[~last])
    bounds = np.searchsorted(sb, np.arange(B + 1))
    starts = np.append(at, out.size)[bounds]
    res = []
    for i in range(B):
        blk = out[starts[i]:starts[i + 1]].tobytes()
        res.append(blk if len(blk) < lens[i] else None)
    return res


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def _tramp(counts: torch.Tensor) -> torch.Tensor:
    """0..c-1 for each count, concatenated (on the counts' device)."""
    total = int(counts.sum())
    starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    return torch.arange(total, device=counts.device) - starts


def decode_blocks(buf, starts, ends, out_base, floor, out_size: int,
                  device=None) -> np.ndarray:
    """Decode the LZ4 blocks at ``buf[starts[i]:ends[i]]`` into one output
    array of ``out_size`` bytes, block i's bytes from ``out_base[i]`` on,
    none of its matches reaching below ``floor[i]`` (its own start, or its
    frame's for linked blocks).  Returns (output uint8, bytes of each
    block); raises FormatError on what the format forbids.  The arithmetic
    over every byte runs in torch on ``device``; the walk along each
    block's sequences in NumPy."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    out_base = np.asarray(out_base, np.int64)
    floor = np.asarray(floor, np.int64)
    if (starts >= ends).any():
        raise FormatError("an empty block")
    dev = torch.device(device) if device is not None else torch.device("cpu")
    b = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(dev)
    n = b.numel()
    # every byte read as the start of a sequence: its literals' start and
    # length, its offset, its match length, and where the next one starts.
    # A length extension is the run of 255s at a byte, then one more.
    ar = torch.arange(n, device=dev)
    idx = torch.where(b != 255, ar, n)
    stop = torch.flip(torch.cummin(torch.flip(idx, [0]), 0).values, [0])
    bp = torch.nn.functional.pad(b.long(), (0, 8))
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    ext_cnt = torch.cat([stop - ar + 1, zero])
    ext_sum = torch.cat([255 * (ext_cnt[:n] - 1) + bp[stop.clamp(max=n)],
                         zero])
    del idx, stop
    tok = bp[:n]
    q = ar + 1
    qq = q.clamp(max=n)
    long_l = tok >> 4 == 15
    ll = (tok >> 4) + torch.where(long_l, ext_sum[qq], 0)
    lit = q + torch.where(long_l, ext_cnt[qq], 0)
    del q, qq, long_l, ar
    alit = lit + ll                      # just after the literals
    off = bp[alit.clamp(max=n)] | bp[(alit + 1).clamp(max=n + 7)] << 8
    q2 = (alit + 2).clamp(max=n)
    long_m = tok & 15 == 15
    ml = (tok & 15) + MIN_MATCH + torch.where(long_m, ext_sum[q2], 0)
    amatch = alit + 2 + torch.where(long_m, ext_cnt[q2], 0)
    del q2, long_m, ext_sum, ext_cnt
    # the chain of sequence starts from each block's start, every block a
    # step at a time; a block's last sequence ends exactly at its end
    alit_h, amatch_h = alit.cpu().numpy(), amatch.cpu().numpy()
    pos, owner, last = [], [], []
    live = np.arange(starts.size)
    cur = starts.copy()
    while live.size:
        c = cur[live]
        e = ends[live]
        fin = alit_h[c] >= e
        pos.append(c)
        owner.append(live)
        last.append(fin)
        nxt = amatch_h[c]
        if (~fin & (nxt >= e)).any():
            raise FormatError("a block ends on a match, or runs past its end")
        live = live[~fin]
        cur[live] = nxt[~fin]
    pos, owner, last = (np.concatenate(a) for a in (pos, owner, last))
    order = np.argsort(owner, kind="stable")     # each block's in order
    pos, owner, last = pos[order], owner[order], last[order]
    if (alit_h[pos[last]] != ends[owner[last]]).any():
        raise FormatError("literals run past the block")
    pt = torch.from_numpy(pos).to(dev)
    lit, ll = lit[pt].cpu().numpy(), ll[pt].cpu().numpy()
    off = np.where(last, 0, off[pt].cpu().numpy())
    ml = np.where(last, 0, ml[pt].cpu().numpy())
    if (~last & (off == 0)).any():
        raise FormatError("an offset of 0")
    size = ll + ml
    run = np.cumsum(size) - size
    first = np.searchsorted(owner, np.arange(starts.size))
    o = run - run[first][owner] + out_base[owner]
    if (~last & (o + ll - off < floor[owner])).any():
        raise FormatError("a match reaches before its block or frame")
    sizes = np.bincount(owner, weights=size,
                        minlength=starts.size).astype(np.int64)
    if (out_base + sizes > out_size).any():
        raise FormatError("blocks decode past the output")
    o, lit, ll, off, ml = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in (o, lit, ll, off, ml))
    # every output byte points at its source: a literal at its input byte
    # (coded as -1 - input position), a match byte at an earlier output byte
    ptr = torch.full((out_size,), -1 - n, dtype=torch.long, device=dev)
    rl = _tramp(ll)
    ptr[torch.repeat_interleave(o, ll) + rl] = -1 - (
        torch.repeat_interleave(lit, ll) + rl)
    mdst = torch.repeat_interleave(o + ll, ml) + _tramp(ml)
    ptr[mdst] = mdst - torch.repeat_interleave(off, ml)
    while True:
        hop = ptr[mdst]
        nxt = torch.where(hop >= 0, ptr[hop.clamp(min=0)], hop)
        if bool((nxt == hop).all()):
            break
        ptr[mdst] = nxt
    # a match resolved to a byte no block wrote reads outside its output
    if bool((ptr[mdst] == -1 - n).any()):
        raise FormatError("a match reads bytes no block wrote")
    out = torch.zeros(out_size, dtype=torch.uint8, device=dev)
    wrote = ptr > -1 - n
    out[wrote] = b[-1 - ptr[wrote]]
    return out.cpu().numpy(), sizes


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------
def _bd(n: int) -> int:
    for code, size in ((4, 64 << 10), (5, 256 << 10), (6, 1 << 20),
                       (7, 4 << 20)):
        if n <= size:
            return code << 4
    raise ValueError("chunk above 4 MB")


def frame(chunk: bytes, block: bytes | None, content_xxh: int) -> bytes:
    """One LZ4 frame of ``chunk`` in one block (``block``, or stored when
    None), with its content size and content checksum: the flags QATzip's
    LZ4 frames carry (FLG 0x4C)."""
    desc = struct.pack("<BBQ", 0x4C, _bd(len(chunk)), len(chunk))
    head = struct.pack("<I", MAGIC) + desc + bytes([X.xxh32(desc) >> 8 & 0xFF])
    if block is None:
        body = struct.pack("<I", len(chunk) | STORED) + chunk
    else:
        body = struct.pack("<I", len(block)) + block
    return head + body + struct.pack("<II", 0, content_xxh)


def write(chunks: list[bytes], device=None) -> bytes:
    """An LZ4 stream of ``chunks``, a frame each (the program's layout)."""
    blocks = compress_blocks(chunks, device)
    sums = _xxh_many(chunks)
    return b"".join(frame(c, blk, h)
                    for c, blk, h in zip(chunks, blocks, sums))


def _xxh_many(parts: list) -> list[int]:
    """XXH32 of each part, the parts of one length hashed together."""
    out = [0] * len(parts)
    by_len: dict[int, list[int]] = {}
    for i, pt in enumerate(parts):
        by_len.setdefault(len(pt), []).append(i)
    for n, ids in by_len.items():
        rows = np.frombuffer(b"".join(bytes(parts[i]) for i in ids),
                             np.uint8).reshape(len(ids), n)
        for i, h in zip(ids, X.xxh32_rows(rows)):
            out[i] = h
    return out


def read_frames(stream, device=None) -> bytes:
    """Decode a run of LZ4 frames (any valid ones: content size, block and
    content checksums optional, linked or independent blocks) and check
    every header, block and content checksum and content size."""
    buf = memoryview(stream)
    n = len(buf)
    frames = []          # (out_base, out_end, content_size, checksum)
    blocks = []          # (start, end, out_base, floor, stored, maxsize)
    pos = 0
    out = 0
    while pos < n:
        k = len(frames)
        if n - pos < 7:
            raise FormatError(f"frame {k}: truncated header")
        (magic,) = struct.unpack_from("<I", buf, pos)
        if magic != MAGIC:
            raise FormatError(f"frame {k}: magic {magic:#x}")
        flg, bd = buf[pos + 4], buf[pos + 5]
        if flg >> 6 != 1 or flg & 0x2 or bd & 0x8F:
            raise FormatError(f"frame {k}: FLG {flg:#x} BD {bd:#x}")
        code = bd >> 4 & 7
        if code < 4:
            raise FormatError(f"frame {k}: block size code {code}")
        maxsize = 1 << (8 + 2 * code)
        indep, bsum, csize, csum, dictid = (flg >> 5 & 1, flg >> 4 & 1,
                                            flg >> 3 & 1, flg >> 2 & 1,
                                            flg & 1)
        hl = 2 + 8 * csize + 4 * dictid
        if n - pos < 4 + hl + 1:
            raise FormatError(f"frame {k}: truncated header")
        desc = bytes(buf[pos + 4:pos + 4 + hl])
        if buf[pos + 4 + hl] != X.xxh32(desc) >> 8 & 0xFF:
            raise FormatError(f"frame {k}: header checksum")
        if dictid:
            raise FormatError(f"frame {k}: needs a dictionary")
        size = struct.unpack_from("<Q", desc, 2)[0] if csize else None
        pos += 4 + hl + 1
        base = out
        while True:
            if n - pos < 4:
                raise FormatError(f"frame {k}: truncated block header")
            (word,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            if word == 0:
                break
            ln = word & ~STORED
            if ln > maxsize or n - pos < ln + 4 * bsum:
                raise FormatError(f"frame {k}: block of {ln} bytes")
            blk = (pos, pos + ln)
            pos += ln
            if bsum:
                (h,) = struct.unpack_from("<I", buf, pos)
                if h != X.xxh32(buf[blk[0]:blk[1]]):
                    raise FormatError(f"frame {k}: block checksum")
                pos += 4
            blocks.append((*blk, out, out if indep else base,
                           bool(word & STORED), maxsize))
            # a block's output size is known only once decoded: keep room
            # for the largest it may be, and pack the frame's output later
            out += ln if word & STORED else maxsize
        check = None
        if csum:
            if n - pos < 4:
                raise FormatError(f"frame {k}: truncated content checksum")
            (check,) = struct.unpack_from("<I", buf, pos)
            pos += 4
        frames.append((base, out, size, check))
    if not blocks:
        return b""
    st, en, ob, fl, stored, mx = (np.array(a) for a in zip(*blocks))
    data = np.zeros(out, np.uint8)
    sizes = np.where(stored, en - st, 0)
    for i in np.flatnonzero(stored):
        data[ob[i]:ob[i] + sizes[i]] = np.frombuffer(buf[st[i]:en[i]],
                                                     np.uint8)
    comp = np.flatnonzero(~stored)
    if comp.size:
        dec, dsz = decode_blocks(buf, st[comp], en[comp], ob[comp], fl[comp],
                                 out, device)
        if (dsz > mx[comp]).any():
            raise FormatError("a block decodes past its frame's block size")
        take = np.zeros(out, bool)
        take[np.repeat(ob[comp], dsz) + _ramp(dsz)] = True
        data[take] = dec[take]
        sizes[comp] = dsz
    # each frame's bytes: its blocks' outputs one after another
    parts = []
    for base, end, size, check in frames:
        sel = (ob >= base) & (ob < end)
        part = b"".join(data[o:o + s].tobytes()
                        for o, s in zip(ob[sel], sizes[sel]))
        if size is not None and len(part) != size:
            raise FormatError(f"frame of {len(part)} bytes, content size "
                              f"{size}")
        parts.append((part, check))
    sums = _xxh_many([p for p, c in parts if c is not None])
    for (part, check), h in zip((pc for pc in parts if pc[1] is not None),
                                sums):
        if h != check:
            raise FormatError("content checksum")
    return b"".join(p for p, _ in parts)
