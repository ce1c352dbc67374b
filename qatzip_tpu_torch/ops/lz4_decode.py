"""Device LZ4 / LZ4s block decoder.

Port of qatzip_tpu/ops/lz4_decode.py (``_decode_blocks_impl`` and
``decode_blocks``).  The reference is XLA code, not a Pallas kernel.
:func:`decode_blocks` runs the hand-written kernel of
``csrc/lz4_block.cu`` (ops/lz4_kernel.py, a warp walks a block's
sequences) for a CUDA device, and :func:`_decode_blocks_impl`, the plain
torch version of the reference, for the CPU; the plain version is also
what the kernel is held to.  It runs on whatever device its tensors lie on:

  1. every byte offset speculatively parses as a sequence start (token,
     literal-length extension, offset, match-length extension), with the
     0xFF-run length at every byte from one log-doubling pass;
  2. the real sequence chain from offset 0 comes from pointer-doubling
     tables (next hop, output bytes and any-error over 2^k hops);
  3. slot j of [B, Jp] takes the j-th sequence by the bits of j;
  4. every output byte finds its sequence by binary search, and match
     bytes resolve to a literal by log-doubling a source pointer.

The table sizes (``n``, ``outcap``, ``J``, ``Jp``), the loop counts and
``EXT_RUN_CAP`` and ``MAX_OUT`` are the reference's, so the arrays are
equal on every block the reference decodes right.  Three divergences:

* ``MAX_BLOCK``: the reference sends every block above 64 KB to the CPU,
  which is every LZ4s block of an incompressible 64 KB chunk (LZ4s has no
  stored escape; such a block is about 65.8 KB).  The port takes any block
  up to ``MAX_OUT``, the most output a block may decode to here; a larger
  output is flagged as before.
* The last sequence's errors: the reference ORs the errors of the
  sequences before each live one, so the last sequence's own (a truncated
  offset, literals or match length, an offset of 0) go unseen, and a
  truncated block decodes to bytes the host decoder refuses.  The port
  flags every live sequence's errors.
* The owner search: the reference keys a sequence that adds no bytes (an
  LZ4s token of 0, no literals and no match) as "never", which breaks the
  order the binary search needs, and the bytes after such a sequence may
  come from the wrong one.  The port keys every live sequence by its
  output start.

The reference's ``take_along_axis(mode="clip")`` becomes ``torch.gather``
on an index clamped to the same range.  All arithmetic is int32, as in XLA.

``decode_blocks`` decodes at most ``GROUP`` blocks at a time (the
reference hands all of a request's blocks to one call): the plain
version's doubling tables stay live for every level, about 2.4 GB at 128
rows of n = 131072.  The bytes do not depend on the grouping, since ``n``
and ``outcap`` only pad.
"""
from __future__ import annotations

import numpy as np
import torch

EXT_RUN_CAP = 512     # max 0xFF-run in a length extension (len <= ~130K)
MAX_OUT = 1 << 17
MAX_BLOCK = MAX_OUT   # block payloads beyond this fall back to CPU
GROUP = 128           # blocks per decode call

_I32 = torch.int32
_I32_MAX = torch.iinfo(torch.int32).max

# blocks handed back to the caller for CPU decode, over the process
failover_blocks = 0


def _next_pow2(x: int, lo: int) -> int:
    p = lo
    while p < x:
        p <<= 1
    return p


def _take(arr: torch.Tensor, idx: torch.Tensor, hi: int) -> torch.Tensor:
    """take_along_axis(arr, clip(idx, 0, hi), axis=-1) for [B, *] arrays;
    an index of one row broadcasts over the B rows, as in jnp."""
    idx = idx.expand(arr.shape[0], -1)
    return torch.gather(arr, 1, idx.clamp(0, hi).to(torch.int64))


def _shift_left(a: torch.Tensor, k: int) -> torch.Tensor:
    """value at column i <- column i+k (last k columns = 0)."""
    return torch.cat([a[:, k:], a.new_zeros((a.shape[0], k))], dim=1)


def _decode_blocks_impl(b: torch.Tensor, blk_len: torch.Tensor, n: int,
                        outcap: int, lz4s: bool, base: int):
    """b: uint8[B, n] zero-padded blocks; blk_len: int32[B].  Returns
    (out uint8[B, outcap], tot int32[B], err bool[B])."""
    dev = b.device
    B = b.shape[0]
    pos = torch.arange(n, dtype=_I32, device=dev)[None, :]
    L = blk_len.to(_I32)[:, None]
    bi = b.to(_I32)

    def gat(idx):
        return _take(bi, idx, n - 1)

    # --- speculative per-position sequence parse -------------------------
    lit0 = bi >> 4
    m0 = bi & 15

    # 0xFF-run length at every byte via log-doubling: a length extension
    # starting at q is run[q] bytes of 255 plus one terminator
    run = (bi == 255).to(_I32)
    s = 1
    while s < EXT_RUN_CAP:
        run = torch.where(run >= s,
                          torch.clamp(s + _shift_left(run, s),
                                      max=EXT_RUN_CAP), run)
        s <<= 1
    run_overflow = (run >= EXT_RUN_CAP).to(_I32)

    def parse_ext(q, active):
        """(ext_len_bytes, ext_value, overflow) of the length extension at
        byte offset q, where active marks fields with base == 15."""
        rl = _take(run, q, n - 1)
        term = gat(q + rl)
        e_len = torch.where(active, rl + 1, 0)
        e_val = torch.where(active, 255 * rl + term, 0)
        ovf = active & (_take(run_overflow, q, n - 1) != 0)
        return e_len, e_val, ovf

    lit_ext_len, lit_ext_val, lit_overflow = parse_ext(pos + 1, lit0 == 15)
    litlen = lit0 + lit_ext_val
    lit_start = pos + 1 + lit_ext_len
    q2 = lit_start + litlen             # offset field position (varies)

    # terminal literal-only sequence: consumes exactly to block end
    terminal = q2 == L

    off = gat(q2) | (gat(q2 + 1) << 8)
    m_ext_len, m_ext_val, m_overflow = parse_ext(q2 + 2, m0 == 15)
    mraw = m0 + m_ext_val
    if lz4s:
        mlen = torch.where(mraw != 0, mraw + base, 0)
    else:
        mlen = mraw + 4
    mlen = torch.where(terminal, 0, mlen)
    off = torch.where(terminal, 0, off)

    nxt = torch.where(terminal, L, q2 + 2 + m_ext_len)
    bad = (lit_overflow | (~terminal & (m_overflow | (off == 0)))
           | (q2 > L) | (nxt > L))
    out_adv = litlen + mlen

    # --- chain materialization from position 0 ---------------------------
    # doubling tables: F[k] = next^(2^k), S[k] = output bytes over that hop,
    # E[k] = any-bad over that hop
    LOG = max(1, (n - 1).bit_length())
    Fs, Ss, Es = [torch.clamp(nxt, max=n)], [out_adv], [bad.to(_I32)]
    for _ in range(LOG - 1):
        F, S, E = Fs[-1], Ss[-1], Es[-1]
        done = F >= L
        Fs.append(torch.where(done, F, _take(F, F, n - 1)))
        Ss.append(S + torch.where(done, 0, _take(S, F, n - 1)))
        Es.append(E | torch.where(done, 0, _take(E, F, n - 1)))

    # enumerate the first J chain nodes via bit decomposition of the slot
    # index: slot j holds (in_pos, out_pos) of the j-th sequence
    J = n // 3 + 2
    Jp = _next_pow2(J, 128)
    j_idx = torch.arange(Jp, dtype=_I32, device=dev)[None, :]
    a_pos = torch.zeros((B, Jp), dtype=_I32, device=dev)
    a_out = torch.zeros((B, Jp), dtype=_I32, device=dev)
    a_bad = torch.zeros((B, Jp), dtype=torch.bool, device=dev)
    for k in range(LOG - 1, -1, -1):
        f_at = _take(Fs[k], a_pos, n - 1)
        s_at = _take(Ss[k], a_pos, n - 1)
        e_at = _take(Es[k], a_pos, n - 1) != 0
        take = (((j_idx >> k) & 1) == 1) & (a_pos < L)
        a_out = a_out + torch.where(take, s_at, 0)
        a_bad = a_bad | (take & e_at)
        a_pos = torch.where(take, torch.clamp(f_at, max=n), a_pos)
    del Fs, Ss, Es

    live = a_pos < L      # slot j is a real sequence

    def slot_gather(arr):
        return _take(arr, a_pos, n - 1)

    # a live slot's own errors count too (the last one's included)
    err_stream = (live & (a_bad | (slot_gather(bad.to(_I32)) != 0))).any(
        dim=1)

    s_litlen = torch.where(live, slot_gather(litlen), 0)
    s_litstart = slot_gather(lit_start)
    s_off = torch.where(live, slot_gather(off), 0)
    s_mlen = torch.where(live, slot_gather(mlen), 0)
    s_adv = s_litlen + s_mlen
    tot = torch.where(live, s_adv, 0).sum(dim=1, dtype=_I32)
    err_stream = err_stream | (tot > outcap)

    # --- output construction --------------------------------------------
    # the owning slot of each output position: binary search over the
    # live slots' output starts, which chain order keeps non-decreasing (a
    # slot that adds no bytes shares its start with the next)
    o = torch.arange(outcap, dtype=_I32, device=dev)[None, :].expand(B, -1)
    start_key = torch.where(live, a_out, _I32_MAX)
    lo = torch.zeros_like(o)
    hi = torch.full_like(o, Jp)
    for _ in range(int(np.log2(Jp)) + 1):
        mid = (lo + hi) // 2
        go = _take(start_key, mid, Jp - 1) <= o
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    slot_of_o = torch.clamp(lo - 1, 0, Jp - 1)   # last slot with start <= o

    def o_gather(arr):
        return _take(arr, slot_of_o, Jp - 1)

    g_litdelta = o_gather(s_litstart - a_out)
    g_litend = o_gather(a_out + s_litlen)
    g_off = o_gather(s_off)
    in_range = o < tot[:, None]
    is_lit = o < g_litend
    # offset reaching before output start is malformed (host oracle raises)
    err_stream = err_stream | (in_range & ~is_lit & (o - g_off < 0)).any(dim=1)
    # source pointer in OUTPUT space for match bytes; literals are ground
    ptr = torch.clamp(torch.where(is_lit, o, o - g_off), 0, outcap - 1)
    for _ in range(int(np.log2(outcap)) + 1):
        ptr = _take(ptr, ptr, outcap - 1)
    # resolved ptr lands on a literal output position; fetch its input byte
    delta_at = _take(g_litdelta, ptr, outcap - 1)
    out = _take(bi, delta_at + ptr, n - 1)
    out = torch.where(in_range, out, 0)
    return out.to(torch.uint8), tot, err_stream


def decode_blocks(blocks, mini_match: int | None = None,
                  device: torch.device | None = None) -> list:
    """Decode a batch of LZ4 (mini_match=None) or LZ4s blocks on ``device``
    (default: ``cuda:0``, the kernel, one launch a group; a CPU device runs
    the plain version).  A kernel error reaches the caller.

    blocks: list of bytes.  Returns a list of bytes-or-None (None = this
    block needs the CPU path: empty, oversize, deep length extensions, or
    any malformed construct the decoder flags); ``failover_blocks`` counts
    the Nones."""
    global failover_blocks
    device = device if device is not None else torch.device("cuda", 0)
    results: list = [None] * len(blocks)
    idxs = [i for i, blk in enumerate(blocks) if 0 < len(blk) <= MAX_BLOCK]
    lz4s = mini_match is not None
    base = (mini_match - 1) if lz4s else 0
    if device.type == "cuda":
        from qatzip_tpu_torch.ops import lz4_kernel
        decode = lz4_kernel.decode
    else:
        decode = _decode_blocks_impl
    for g in range(0, len(idxs), GROUP):
        group = idxs[g:g + GROUP]
        n = _next_pow2(max(len(blocks[i]) for i in group) + 8, 1024)
        # high-ratio blocks (RLE-ish) expand far beyond 4x: always allow the
        # full 128K output so small compressed blocks don't fall back
        outcap = min(_next_pow2(max(4 * n, MAX_OUT), 4096), MAX_OUT)
        arr = np.zeros((len(group), n), np.uint8)
        lens = np.zeros((len(group),), np.int32)
        for row, i in enumerate(group):
            blk = blocks[i]
            arr[row, :len(blk)] = np.frombuffer(blk, np.uint8)
            lens[row] = len(blk)
        out, tot, err = decode(torch.from_numpy(arr).to(device),
                               torch.from_numpy(lens).to(device),
                               n, outcap, lz4s, base)
        tot, err = tot.cpu().numpy(), err.cpu().numpy()
        good = ~err & (tot >= 0) & (tot <= outcap)
        # only the columns a good row needs come back to the host
        out = out[:, :int(tot[good].max(initial=0))].cpu().numpy()
        for row, i in enumerate(group):
            if good[row]:
                results[i] = out[row, :tot[row]].tobytes()
    failover_blocks += results.count(None)
    return results
