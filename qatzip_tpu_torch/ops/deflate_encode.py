"""DEFLATE block encoder on the device: the full-device parity engine
(``QATZIP_TPU_ENCODER=device``).

Port of qatzip_tpu/ops/deflate_encode.py as plain torch: the reference is
XLA-compiled code that reaches no Pallas kernel, so it runs here as torch
operations on the card, apart from the greedy parse's chain walk, which an
H100 profile gave a hand-written kernel (ops/chain.py).  The pipeline:

  K1 ``analyze_blocks`` (device): hash-chain candidates from one stable
    key sort whose payloads carry the shifted prefix words of every
    position, so match lengths are payload compares in sorted order; a
    second sort back to position order; exact dist-1 run lengths by
    log-doubling; the greedy parse as a segment-entry recurrence plus
    parallel segment walks (``chain.chain_walk``, where the reference has
    two ``lax.scan`` loops) and one scatter of the selected positions;
    litlen/dist histograms (``torch.bincount``).
  Host ``huff_build_batch`` (native): length-limited Huffman codes, the
    dynamic headers and the stored/static/dynamic decision from exact bit
    costs.
  K2 ``pack_blocks`` (device): per-position fields, per-block code-table
    lookups by sort-merge-forward-fill, and bit packing by prefix sums that
    ride a merge sort to the word boundaries.

The reference's sort-merge lookups and one-hot histograms exist to avoid
TPU gathers; they are kept as the reference has them, so every array is
equal to the reference's, except the histograms, which are bincounts with
the same integers.  u32 values ride int64 tensors with masks (torch on the
CPU has no uint32 shift); ``lax.optimization_barrier`` has no counterpart
and is dropped.  With ``mesh`` (a list of devices, parallel/shard.py)
``encode_blocks`` runs block-data-parallel: a contiguous slice of the
batch on each device.
"""
from __future__ import annotations

import numpy as np
import torch

from qatzip_tpu_torch.native import qzcore as native
from qatzip_tpu_torch.ops import chain
from qatzip_tpu_torch.ops.codes import dist_code, length_code

MODE_DYNAMIC = 0
MODE_STATIC = 1
MODE_STORED = 2

WINDOW = 32767  # dist rides 15 payload bits of the unscramble key
SEG = 256       # greedy-parse segment width
HDR_MAX = 672   # 4 + 19 + 2*316 header fields + slack
MAX_BLOCK = 1 << 17  # keys pack pos into 17 bits

_M32 = 0xFFFFFFFF
_INVALID = 0xFFFFFFFF
_HASH_MUL = 2654435761


def words_bound(n: int) -> int:
    """Output words per block: static-mode worst case plus slack, padded to
    128 (the host mode decision guarantees dynamic/static blocks fit;
    stored blocks are emitted on the host)."""
    return ((9 * n + n // 4 + 8192) // 32 + 127) & ~127


def level_params(level: int) -> tuple[int, int]:
    """Compression level -> (hash-chain depth, payload words for the
    depth-1 exact extension), the reference's table."""
    if level <= 3:
        return 8, 16
    if level <= 6:
        return 12, 24
    return 16, 32


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(a, idx, axis=-1, mode="clip")."""
    return a.gather(-1, torch.clamp(idx.long(), 0, a.shape[-1] - 1))


def _vsort(key: torch.Tensor, *payloads: torch.Tensor):
    """Stable ascending sort by key (int64 holding u32) along the last
    axis, payloads carried: one sort and a gather a payload, the same
    permutation as the reference's ``lax.sort(num_keys=1,
    is_stable=True)``."""
    skey, order = torch.sort(key, dim=-1, stable=True)
    return (skey, *(p.gather(-1, order) for p in payloads))


def _shift_right(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    pad = torch.full(a.shape[:-1] + (k,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([pad, a[..., :-k]], dim=-1)


def _shift_left(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    pad = torch.full(a.shape[:-1] + (k,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a[..., k:], pad], dim=-1)


def _hist_onehot(idx: torch.Tensor, valid: torch.Tensor,
                 nbins: int) -> torch.Tensor:
    """Per-row histogram of ``idx`` [B, n] (values in [0, nbins)) over the
    positions where ``valid``: one ``torch.bincount`` over
    row * (nbins + 1) + bin, invalid positions in a spill bin (the
    reference's one-hot matmuls give the same integers).  int32
    [B, nbins]."""
    B = idx.shape[0]
    rows = torch.arange(B, device=idx.device, dtype=torch.int64)[:, None]
    flat = rows * (nbins + 1) + torch.where(valid, idx.long(), nbins)
    counts = torch.bincount(flat.reshape(-1), minlength=B * (nbins + 1))
    return counts.reshape(B, nbins + 1)[:, :nbins].to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a < 2^32 and c < 2^32, without leaving
    int64's range."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _pos_bits(n: int) -> int:
    b = 17
    while (1 << b) < n:
        b += 1
    return b


def analyze_blocks(data: torch.Tensor, lengths: torch.Tensor, depth: int,
                   kwords: int, lz4_rules: bool = False):
    """K1: LZ77 + greedy parse + histograms for a batch of blocks.

    data: uint8[B, N+8] zero-padded; lengths: int32[B], on one device;
    N <= 128K, N % SEG == 0.  Returns (sel bool[B,N], take bool[B,N],
    mlen int32[B,N], mdist int32[B,N], freq_ll int32[B,286], freq_d
    int32[B,30]) on that device.

    With ``lz4_rules`` the parse obeys the LZ4 block contract: min match 4
    (no len-3 matches), the last 5 bytes are literals and no match begins
    within the final 12 bytes.
    """
    B = data.shape[0]
    n = data.shape[1] - 8
    assert n <= MAX_BLOCK and n % SEG == 0
    dev = data.device
    pos_bits = _pos_bits(n)
    pos_mask = (1 << pos_bits) - 1
    hash_bits = min(15, 32 - pos_bits)

    d64 = data.to(torch.int64)
    b4 = (d64[:, 0:n] | (d64[:, 1:n + 1] << 8)
          | (d64[:, 2:n + 2] << 16) | (d64[:, 3:n + 3] << 24))
    pos = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    L = lengths.to(torch.int64)[:, None]

    # shifted prefix words ride the sort as payloads: in sorted order the
    # candidate's words are one-element shifts, so match extension is a
    # payload compare instead of a random read
    b4s = [b4]
    for k in range(4, 4 * kwords, 4):
        b4s.append(_shift_left(b4, k, 0))

    h = _mul32(b4, _HASH_MUL) >> (32 - hash_bits)
    valid = (pos + 3) < L
    keys = torch.where(valid, (h << pos_bits) | pos, _INVALID)
    sorted_all = _vsort(keys, *b4s)
    sk = sorted_all[0]
    pw_sorted = sorted_all[1:]
    cur_pos = sk & pos_mask
    cur_ok = sk != _INVALID
    cur_hash = sk >> pos_bits

    def _matchlen_sorted(dd, nwords):
        """Exact match length (<= 4*nwords+3) of each sorted entry against
        its dd-back neighbour, by payload word compares only."""
        cand = _shift_right(sk, dd, _INVALID)
        dist = cur_pos - (cand & pos_mask)
        ok = (cur_ok & (cand != _INVALID) & ((cand >> pos_bits) == cur_hash)
              & (dist >= 1) & (dist <= WINDOW))
        mlen = torch.zeros((B, n), dtype=torch.int64, device=dev)
        alive = ok
        for pw in pw_sorted[:nwords]:
            x = pw ^ _shift_right(pw, dd, 0)
            eq = x == 0
            part = (((x & 0xFF) == 0).long() + ((x & 0xFFFF) == 0).long()
                    + ((x & 0xFFFFFF) == 0).long())
            mlen = mlen + torch.where(alive, torch.where(eq, 4, part), 0)
            alive = alive & eq
        return torch.where(ok & (mlen >= 4), mlen, 0), dist

    # the nearest chain entry gets the full extension; deeper entries a
    # short scored one (the next parse position re-matches the tail)
    ml_s, dist_s = _matchlen_sorted(1, kwords)
    best = torch.where(ml_s > 0, (ml_s << 15) | (32767 - (dist_s - 1)), 0)
    for dd in range(2, depth + 1):
        ml_s, dist_s = _matchlen_sorted(dd, 4)
        cand = torch.where(ml_s > 0, (ml_s << 15) | (32767 - (dist_s - 1)), 0)
        best = torch.maximum(best, cand)

    # back to position order with a second sort; invalid entries sort past
    # every real position, and positions >= length-3 have no matches, so
    # the sorted prefix aligns 1:1 with positions [0, length-3)
    keys2 = torch.where(cur_ok, (cur_pos << 15) | (32767 - (best & 0x7FFF)),
                        _INVALID)
    sk2, ml_pay = _vsort(keys2, best >> 15)
    in_range = (pos + 3 < L) & (sk2 != _INVALID)
    low15 = sk2 & 0x7FFF  # dist-1; 32767 = none
    dist_p = torch.where(in_range & (low15 != 32767), low15 + 1, 0)
    mlen_h = torch.where(dist_p > 0, ml_pay, 0)
    maxm = torch.clamp(L - pos, max=258)
    mlen_h = torch.minimum(mlen_h, maxm)

    # len-3 matches (deflate's min match) from a 3-byte-hash chain; only
    # near distances are worthwhile (zlib's too_far heuristic)
    b3 = b4 & 0xFFFFFF
    h3 = _mul32(b3, _HASH_MUL) >> (32 - hash_bits)
    valid3 = (pos + 2) < L
    keys3 = torch.where(valid3, (h3 << pos_bits) | pos, _INVALID)
    sk3, q3 = _vsort(keys3, b3)
    c3 = _shift_right(sk3, 1, _INVALID)
    c3q = _shift_right(q3, 1, 0)
    d3 = (sk3 & pos_mask) - (c3 & pos_mask)
    ok3 = ((sk3 != _INVALID) & (c3 != _INVALID)
           & ((c3 >> pos_bits) == (sk3 >> pos_bits)) & (q3 == c3q)
           & (d3 >= 1) & (d3 < 4096))
    key3b = torch.where(sk3 != _INVALID,
                        ((sk3 & pos_mask) << 15)
                        | torch.where(ok3, d3 - 1, 32767), _INVALID)
    (sk3b,) = _vsort(key3b)
    low3 = sk3b & 0x7FFF
    dist3_p = torch.where((pos + 2 < L) & (sk3b != _INVALID) & (low3 != 32767),
                          low3 + 1, 0)
    has3 = (dist3_p > 0) & (dist_p == 0) & (maxm >= 3)

    # exact dist-1 runs by log-doubling: covers RLE data beyond the
    # payload cap, up to the full 258
    eq_prev = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                         data[:, 1:n] == data[:, 0:n - 1]], dim=-1)
    r = eq_prev.long()
    s = 1
    while s < 258:
        r_sh = _shift_left(r, s, 0)
        r = torch.where(r >= s, torch.clamp(s + r_sh, max=258), r)
        s <<= 1
    mlen_rle = torch.minimum(r, torch.clamp(maxm, max=258))

    use_rle = (mlen_rle >= 4) & (mlen_rle >= mlen_h)
    mlen = torch.where(use_rle, mlen_rle, mlen_h)
    mdist = torch.where(use_rle, 1, dist_p)
    take = (mlen >= 4) & (mdist >= 1)
    if not lz4_rules:
        # deflate's min match is 3: near len-3 matches where nothing
        # longer is available
        m3 = has3 & ~take
        mlen = torch.where(m3, 3, mlen)
        mdist = torch.where(m3, dist3_p, mdist)
        take = take | m3
    else:
        # LZ4 end of block: the last 5 bytes literal, no match start in the
        # final 12 bytes; matches may not reach into the last 5 bytes
        take = take & (pos <= L - 13) & (pos + mlen <= L - 5)
    if depth >= 6:
        # one-step lazy matching (zlib levels >= 4): prefer the longer
        # match starting one byte later
        take = take & ~(_shift_left(mlen, 1, 0) > mlen)
    mlen = torch.where(take, mlen, 0)
    mdist = torch.where(take, mdist, 0)

    # greedy parse: chain membership is the one random-access stage, the
    # walk that ops/chain.py runs (the kernel on a CUDA tensor)
    step = torch.where(take, mlen, 1)
    f = torch.clamp(pos + step, max=n)
    nseg = n // SEG
    visited = chain.chain_walk(f, SEG).long()             # [B, nseg, SEG]
    seg_lo3 = (torch.arange(nseg, dtype=torch.int64, device=dev)
               * SEG)[None, :, None]
    ok_slot = ((visited >= seg_lo3) & (visited < seg_lo3 + SEG)
               & (visited < L[:, :, None]))
    slots = torch.where(ok_slot, visited, n).reshape(B, n)

    # one scatter builds the chain-membership mask in position order
    selpad = torch.zeros((B, n + 128), dtype=torch.bool, device=dev)
    selpad.scatter_(1, slots, True)
    sel = selpad[:, :n] & (pos < L)
    take = sel & take

    # histograms over the selected positions
    lc, _, _ = length_code(mlen)
    sym = torch.where(take, lc.long(), d64[:, :n])
    freq_ll = _hist_onehot(torch.clamp(sym, 0, 285), sel, 286)
    freq_ll[:, 256] += 1  # EOB
    dc, _, _ = dist_code(mdist)
    freq_d = _hist_onehot(torch.clamp(dc, 0, 29), take, 30)
    return (sel, take, mlen.to(torch.int32), mdist.to(torch.int32), freq_ll,
            freq_d)


def _ffill_u32(marker: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Forward-fill 32-bit ``vals`` (int64) from marker positions along
    the last axis: three 12-bit planes, each packed under a running
    position key and forward-filled by cummax."""
    B, M = marker.shape
    idx = torch.arange(M, dtype=torch.int64, device=marker.device)[None, :] + 1
    key = torch.where(marker, idx, 0)  # 0 = "nothing yet"
    out = torch.zeros((B, M), dtype=torch.int64, device=marker.device)
    for plane in range(3):
        part = (vals >> (12 * plane)) & 0xFFF
        packed = torch.where(marker, (key << 12) | part, 0)
        filled = torch.cummax(packed, dim=1).values
        out = out | ((filled & 0xFFF) << (12 * plane))
    return out & _M32


def _lookup_sorted(table: torch.Tensor, idx: torch.Tensor,
                   tbits: int) -> torch.Tensor:
    """y[b,i] = table[b, idx[b,i]] by sort-merge + forward-fill + unsort,
    as the reference does it.  table: int[B,T] values < 2^20; idx:
    int[B,N] in [0,T)."""
    B, T = table.shape
    N = idx.shape[1]
    M = T + N
    ibits = 18  # enough for M up to 256K entries
    dev = table.device
    ar_t = torch.arange(T, dtype=torch.int64, device=dev)[None, :]
    ar_n = torch.arange(N, dtype=torch.int64, device=dev)[None, :]
    # records: table entries first at each key (flag 0), queries flag 1;
    # the low bits keep record identity for the unsort
    tkey = (((ar_t << 1) << ibits) | ar_t).expand(B, T)
    qkey = (((idx.long() << 1) | 1) << ibits) | (ar_n + T)
    keys = torch.cat([tkey, qkey], dim=-1)
    pay = torch.cat([table.long(),
                     torch.zeros((B, N), dtype=torch.int64, device=dev)],
                    dim=-1)
    skeys, spay = _vsort(keys, pay)
    is_tab = ((skeys >> ibits) & 1) == 0
    filled = _ffill_u32(is_tab, spay)
    # unsort: order by record identity, keep only query records
    rid = skeys & ((1 << ibits) - 1)
    k2 = torch.where(is_tab, M + 1, rid - T)
    _, out = _vsort(k2, filled)
    return out[:, :N]


def pack_blocks(data: torch.Tensor, sel: torch.Tensor, take: torch.Tensor,
                mlen: torch.Tensor, mdist: torch.Tensor,
                hdr_vals: torch.Tensor, hdr_nbits: torch.Tensor,
                ll_len: torch.Tensor, ll_code: torch.Tensor,
                d_len: torch.Tensor, d_code: torch.Tensor, m_words: int):
    """K2: the deflate bitstream for a batch of blocks (sort-merge lookups,
    prefix-sum packing).

    Position p carries the literal-or-length field; p+1 carries the
    distance field of a match starting at p (p+1 is always inside it).
    Code tables are host-built ([B,286]/[B,30], already mode-selected).
    Returns (words int64[B, m_words] holding u32, bits int32[B]).
    """
    B, n = sel.shape
    dev = sel.device
    lit = data[:, :n].to(torch.int64)

    lc, leb, lev = (t.long() for t in length_code(mlen))
    dc, deb, dev_ = (t.long() for t in dist_code(mdist))
    sym = torch.clamp(torch.where(take, lc, lit), 0, 285)

    # fused per-block lookup of (code, len) pairs: value = code | len<<15
    ll_fused = ll_code.long() | (ll_len.long() << 15)
    ll_hit = _lookup_sorted(ll_fused, sym, 9)
    ll_c = ll_hit & 0x7FFF
    ll_n = ll_hit >> 15
    d_fused = d_code.long() | (d_len.long() << 15)
    d_hit = _lookup_sorted(d_fused, torch.clamp(dc, 0, 29), 5)
    d_c = d_hit & 0x7FFF
    d_n = d_hit >> 15

    # field A at p: literal or length code (+ length extra), <= 20 bits
    aV = torch.where(sel, (ll_c | (lev << ll_n)) & _M32, 0)
    aN = torch.where(sel, ll_n + torch.where(take, leb, 0), 0)
    # field B at p+1: distance code + extra of the match starting at p
    bV = _shift_right(torch.where(take, (d_c | (dev_ << d_n)) & _M32, 0), 1, 0)
    bN = _shift_right(torch.where(take, d_n + deb, 0), 1, 0)
    # p+1 of a match is never selected, so its slot takes the distance
    posV = torch.where(bN > 0, bV, aV)
    posN = torch.where(bN > 0, bN, aN)

    eob_v = ll_fused[:, 256:257]
    values = torch.cat([hdr_vals.long(), posV, eob_v & 0x7FFF], dim=-1)
    nbits = torch.cat([hdr_nbits.long(), posN, eob_v >> 15], dim=-1)
    fpad = (-values.shape[1]) % 128
    if fpad:
        values = torch.nn.functional.pad(values, (0, fpad))
        nbits = torch.nn.functional.pad(nbits, (0, fpad))
    F = values.shape[1]

    # scatter-free packing: per-field prefix sums ride a merge sort to the
    # word-boundary queries; per-word values are forward-filled prefix
    # differences.  Contributions to a word occupy disjoint bit ranges
    # (sum == or); u32 wraparound is the masks below.
    cum = torch.cumsum(nbits, dim=-1)
    off = cum - nbits
    total_bits = cum[:, -1]

    vmask = torch.where(nbits > 0, values, 0)
    bit = off & 31
    lo = (vmask << bit) & _M32
    hi = torch.where(bit == 0, 0, vmask >> (32 - bit))
    ps_lo = torch.cumsum(lo, dim=-1) & _M32
    ps_hi = torch.cumsum(hi, dim=-1) & _M32
    word_idx = off >> 5

    # merge fields and word queries: field key (word_idx, 1), query key
    # (w, 0), so queries precede same-word fields and the forward-filled
    # prefix sum at a query is that of the last field of word w-1
    wq = torch.arange(m_words, dtype=torch.int64, device=dev)[None, :].expand(
        B, m_words)
    fkey = ((word_idx << 1) | 1) << 13
    qkey = (wq << 1) << 13
    keys = torch.cat([fkey, qkey], dim=-1)
    ident = torch.cat([torch.zeros((B, F), dtype=torch.int64, device=dev),
                       wq + 1], dim=-1)
    zeros_w = torch.zeros((B, m_words), dtype=torch.int64, device=dev)
    pl = torch.cat([ps_lo, zeros_w], dim=-1)
    ph = torch.cat([ps_hi, zeros_w], dim=-1)
    skeys, sident, spl, sph = _vsort(keys, ident, pl, ph)
    is_field = ((skeys >> 13) & 1) == 1
    fl = _ffill_u32(is_field, spl)
    fh = _ffill_u32(is_field, sph)
    # compact the query records back to word order
    k2 = torch.where(is_field, F + m_words + 2, sident)
    _, cfl, cfh = _vsort(k2, fl, fh)
    bnd_lo = cfl[:, :m_words]   # ps_lo at the last field of word w-1
    bnd_hi = cfh[:, :m_words]
    nxt_lo = torch.cat([bnd_lo[:, 1:], ps_lo[:, -1:]], dim=-1)
    w_direct = (nxt_lo - bnd_lo) & _M32   # lo parts of word w's fields
    prev_hi = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                         bnd_hi[:, :-1]], dim=-1)
    w_carry = (bnd_hi - prev_hi) & _M32   # hi parts of word w-1's fields
    words = (w_direct + w_carry) & _M32
    return words, total_bits.to(torch.int32)


def encode_blocks(data, lengths, depth: int, kwords: int,
                  allow_dynamic: bool, m_words: int, mesh=None,
                  device: torch.device | None = None):
    """K1 -> host Huffman build -> K2 for a batch of blocks.

    data: uint8[B, N+8], lengths: int32[B] (tensors, or numpy arrays that
    go to ``device``, default ``cuda:0``).  Returns (words int64[B,
    m_words] holding u32, bits int32[B], mode int32[B] numpy); words and
    bits stay on the device.  Blocks with mode == MODE_STORED are emitted
    by the caller (host stored-block framing).

    With ``mesh`` (a list of devices), both device stages run
    block-data-parallel: B must divide by the mesh size, each device takes
    a contiguous slice, and words and bits come back as lists of
    per-device tensors, each slice's on its device.  ``data`` and
    ``lengths`` may then also be lists of per-device shards already staged.
    """
    from qatzip_tpu_torch.parallel import shard

    if mesh is not None:
        shards = (list(zip(data, lengths)) if isinstance(data, list)
                  else shard.scatter(mesh, data, lengths))
    else:
        if not isinstance(data, torch.Tensor):
            if device is None:
                device = torch.device("cuda", 0)
            data = torch.as_tensor(np.asarray(data), device=device)
        lengths = torch.as_tensor(np.asarray(lengths) if not isinstance(
            lengths, torch.Tensor) else lengths, device=data.device)
        shards = [(data, lengths)]
    k1 = [analyze_blocks(d, l, depth, kwords) for d, l in shards]
    freq_ll = np.concatenate([k[4].cpu().numpy() for k in k1])
    freq_d = np.concatenate([k[5].cpu().numpy() for k in k1])
    lens_np = np.concatenate([l.cpu().numpy() for _, l in shards])
    mode, ll_len, ll_code, d_len, d_code, hv, hn, _est = \
        native.huff_build_batch(freq_ll, freq_d, lens_np, allow_dynamic,
                                32 * m_words, HDR_MAX)
    words, bits = [], []
    row = 0
    for (d, _), (sel, take, mlen, mdist, _f1, _f2) in zip(shards, k1):
        rows = slice(row, row + d.shape[0])
        row += d.shape[0]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[rows])).to(
                d.device)

        w, b = pack_blocks(d, sel, take, mlen, mdist,
                           put(hv.astype(np.int64)), put(hn), put(ll_len),
                           put(ll_code), put(d_len), put(d_code), m_words)
        words.append(w)
        bits.append(b)
    if mesh is None:
        return words[0], bits[0], mode
    return words, bits, mode
