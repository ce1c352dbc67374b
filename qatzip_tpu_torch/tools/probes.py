"""The Mosaic construct probes, ported: plain versions and kernel wrappers.

``tools/probe_pallas*.py`` and ``tools/probe_inflate_step*.py`` of the JAX
package measured, on the TPU, what a lockstep decoder can be built from
under Mosaic.  Each of their ``pl.pallas_call`` kernels has here

* a plain torch version, named after the TPU function (``dep_gather_loop``,
  ``step_loop``, ``lane_major_step`` ...), which computes what it returns
  from the same int32 / uint32 inputs (uint32 data travels as int32 tensors
  of the same bits; the arithmetic runs on int64 and wraps to 32 bits, as
  torch has no uint32 shift on the CPU);
* a counterpart among the Hopper kernels of ``probes.cu``
  (``libqzprobes.so``, built apart from the path's kernels by
  ``ops/_build``), launched by :func:`probe_chain`, :func:`probe_column`,
  :func:`probe_alu`, :func:`probe_step`, :func:`probe_roll`,
  :func:`probe_refill` and the tile wrappers below; :func:`launch_floor`
  launches an empty kernel.

A wrapper given tensors on the CPU runs the plain version; given CUDA
tensors it launches the kernel or raises :class:`KernelError`.  The
64K-element sorts of probe_pallas.py go through :func:`probe_bitonic_64k`.
Nothing on the codec's path calls this module: ``tools/probe_bench.py``
and chip_smoke.py time it, the tests hold it against the TPU probes.
"""
from __future__ import annotations

import ctypes

import torch

from qatzip_tpu_torch.ops._build import PROBES, Kernel, KernelError

_M32 = 0xFFFFFFFF
HASH_MUL = 2654435761
_I, _P, _U = ctypes.c_int, ctypes.c_void_p, ctypes.c_uint

DEP = Kernel("qz_probe_dep", [_I, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P],
             lib=PROBES)
CHAIN = Kernel("qz_probe_chain", [_I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _U,
                                  _P, _P], lib=PROBES)
INDEP = Kernel("qz_probe_indep", [_I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P,
                                  _P], lib=PROBES)
COLUMN = Kernel("qz_probe_column", [_I, _P, _I, _P, _P, _I, _I, _I, _U, _P,
                                    _P], lib=PROBES)
ALU = Kernel("qz_probe_alu", [_I, _P, _P, _I, _I, _P, _P], lib=PROBES)
STEP = Kernel("qz_probe_step", [_I, _I] + [_P] * 6 + [_I] * 7 + [_P] * 2,
              lib=PROBES)
TILE = Kernel("qz_probe_tile", [_P, _P] + [_I] * 7 + [_P, _P], lib=PROBES)
TRANSPOSE = Kernel("qz_probe_transpose", [_P, _P, _I, _I, _P, _P],
                   lib=PROBES)
ROLL = Kernel("qz_probe_roll", [_P, _P, _I, _I, _I, _I, _P], lib=PROBES)
REFILL = Kernel("qz_probe_refill", [_I, _P, _P, _I, _I, _P, _I, _I, _I, _P,
                                    _P], lib=PROBES)
EMPTY = Kernel("qz_probe_empty", [_I, _P], lib=PROBES)
ROW = Kernel("qz_probe_bitonic_row", [_P, _P, _I, _I, _P, _P], lib=PROBES)
KERNELS = {k.symbol: k for k in (DEP, CHAIN, INDEP, COLUMN, ALU, STEP, TILE,
                                 TRANSPOSE, ROLL, REFILL, EMPTY, ROW)}
MAX_LANES = 512   # QZP_MAX_LANES: the offsets a refill's parameters hold
MAX_SMEM = 227 * 1024   # QZP_MAX_SMEM: the shared memory a CTA may take
COLUMN_MAX_N = 1024   # QZP_COL_MAX_N: the tallest column the card stages
INDEP_MAX_R = 32   # QZP_INDEP_MAX_R: the most copies of a staged table word
BITONIC_N = (32, 4096)   # QZP_BIT_MIN_N, QZP_BIT_MAX_N: the tiles it sorts
ROW_N = 65536   # QZP_ROW_N: the rows qz_probe_bitonic_row sorts
ROW_CTAS = 16   # QZP_ROW_CTAS: the cluster it spreads a row over
# STEP5's kernels are built for one window and subtable size, these root
# sizes and lanes a CTA (QzpS5Shape, qzp_s5_dispatch)
STEP5_W, STEP5_SUB, STEP5_ROOTS, STEP5_LPC = 128, 256, (128, 256), (1, 8, 32)

# -- 32-bit arithmetic on int64 ----------------------------------------------


def _s(t: torch.Tensor) -> torch.Tensor:
    """int32 values, signed, as int64."""
    return t.to(torch.int64)


def _u(t: torch.Tensor) -> torch.Tensor:
    """The uint32 value of int32 bits, as int64."""
    return t.to(torch.int64) & _M32


def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 wrapped to the int32 range, as int32."""
    return (((v + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for uint32 values a and c, without leaving int64."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _ones_below(n: torch.Tensor) -> torch.Tensor:
    """(1 << n) - 1 elementwise, n <= 32."""
    return (torch.ones_like(n) << n) - 1


def _high_part(hi: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """((hi << (31 - sh)) << 1) mod 2^32 for uint32 hi, sh < 32."""
    return (hi & _ones_below(sh)) << (32 - sh)


def _rows(t: torch.Tensor, n_rows: int) -> torch.Tensor:
    return t.expand(n_rows, -1) if t.shape[0] == 1 else t


# -- plain versions of the TPU probe functions -------------------------------


def dep_gather_loop(t: torch.Tensor, i: torch.Tensor, K: int) -> torch.Tensor:
    """probe_inflate_step.py:dep_gather_loop (and probe_inflate_step3.py's
    dep_loop): K dependent lane gathers ``idx = t[r, idx & (w - 1)]`` over an
    int32 [R, n] index and an int32 [R, w] or [1, w] table, w a power of 2
    (the TPU's take_along_axis with its index kept in range).  Leading dims
    of a grid (probe_pallas4.py:p_chain_grid) fold into R."""
    shape, w = i.shape, t.shape[-1]
    idx = _s(i).reshape(-1, shape[-1])
    tt = _rows(_s(t).reshape(-1, w), idx.shape[0])
    for _ in range(K):
        idx = torch.gather(tt, 1, idx & (w - 1))
    return idx.to(torch.int32).reshape(shape)


def chain16(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """probe_pallas4.py:p_chain (and p_chain_grid over a leading grid dim):
    16 dependent row gathers ``idx = x[r, idx & 127]``."""
    return dep_gather_loop(x, i, 16)


def tbl1024(tbl: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """probe_pallas4.py:p_tbl: ``tbl.flat[idx]`` for an [8, 128] table and
    idx in [0, 1024)."""
    return dep_gather_loop(tbl.reshape(1, -1), i, 1)


def indep_gather_loop(t: torch.Tensor, i: torch.Tensor, K: int,
                      W: int) -> torch.Tensor:
    """probe_inflate_step.py:indep_gather_loop: K times, W gathers of
    ``t[r, (idx + w) & (w_t - 1)]`` summed onto idx, then masked."""
    m = t.shape[-1] - 1
    idx = _s(i)
    tt = _rows(_s(t), idx.shape[0])
    for _ in range(K):
        acc = idx
        for w in range(W):
            acc = acc + torch.gather(tt, 1, (idx + w) & m)
        idx = acc & m
    return idx.to(torch.int32)


def elemwise_loop(i: torch.Tensor, K: int) -> torch.Tensor:
    """probe_inflate_step.py:elemwise_loop, its int32 body with 32-bit wrap
    (``v = (x * 2654435761 + 12345) & 0x7FFFFFFF; x = (v ^ v >> 7) &
    0xFFFF``), which the JAX function itself refuses to trace: 2654435761
    does not fit in int32."""
    x = _u(i)
    for _ in range(K):
        v = (_mul32(x, HASH_MUL) + 12345) & 0x7FFFFFFF
        x = (v ^ (v >> 7)) & 0xFFFF
    return x.to(torch.int32)


def ew(x: torch.Tensor, K: int) -> torch.Tensor:
    """probe_inflate_step5.py:mk_ew (A): K times ``x = (x * 2654435761) ^
    (x >> 7)`` in uint32."""
    v = _u(x)
    for _ in range(K):
        v = _mul32(v, HASH_MUL) ^ (v >> 7)
    return _i32(v)


def double(x: torch.Tensor, K: int = 1) -> torch.Tensor:
    """probe_pallas.py:p_double: ``x * 2`` (K times), int32."""
    v = _u(x)
    for _ in range(K):
        v = (v * 2) & _M32
    return _i32(v)


def shfl_pairs(x: torch.Tensor, K: int) -> torch.Tensor:
    """K swaps of each pair of neighbouring elements (2i, 2i + 1) of x
    (flattened; an odd last element pairs with 0): what K dependent
    ``__shfl_xor_sync(.., 1)`` leave in a thread an element.  It replaces
    no TPU kernel: the unit of BITONIC's stages across lanes."""
    if K % 2 == 0:
        return x.clone()
    v = x.reshape(-1)
    p = torch.cat([v, v.new_zeros(v.numel() % 2)]).reshape(-1, 2).flip(1)
    return p.reshape(-1)[:v.numel()].reshape(x.shape)


def count_up(x: torch.Tensor, K: int) -> torch.Tensor:
    """x + K with 32-bit wrap: what K barriers, each followed by + 1, leave
    in a thread an element (qz_probe_alu BAR; no TPU kernel)."""
    return _i32(_u(x) + K)


def scalar_walk(x: torch.Tensor, K: int = 4096) -> torch.Tensor:
    """probe_pallas.py:p_walk: ``acc += x[acc % rows, i % cols]`` for i < K
    over an int32 [rows, cols] tile (powers of 2), from acc = 0; [1, 1]."""
    rows, cols = x.shape
    flat = _s(x).reshape(-1)
    acc = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(K):
        at = (acc & (rows - 1)) * cols + (i & (cols - 1))
        acc = _s(_i32(acc + flat[at]))
    return acc.to(torch.int32).reshape(1, 1)


def _column(t: torch.Tensor, i: torch.Tensor, K: int, post: int):
    """K steps of ``idx = (idx + t[idx & (N - 1), lane]) & post`` over int32
    [N, L] columns and [R, L] indexes."""
    n = t.shape[0]
    tt = _s(t)
    idx = _s(i)
    for _ in range(K):
        idx = (idx + torch.gather(tt, 0, idx & (n - 1))) & post
    return _i32(idx)


def subshuf(t: torch.Tensor, i: torch.Tensor, K: int) -> torch.Tensor:
    """probe_inflate_step5.py:mk_subshuf (B): the [8, 128] sublane shuffle
    chain ``idx += t[idx & 7, lane]``, int32."""
    return _column(t, i, K, _M32)


def onehot(t: torch.Tensor, i: torch.Tensor, K: int) -> torch.Tensor:
    """probe_inflate_step5.py:mk_onehot (C): ``idx = (idx + t[idx, lane]) &
    (N - 1)`` over [N, 128] columns and a [1, 128] idx in [0, N)."""
    return _column(t, i, K, t.shape[0] - 1)


def groupsel(t: torch.Tensor, i: torch.Tensor, K: int) -> torch.Tensor:
    """probe_inflate_step5.py:mk_groupsel (C2): the function of onehot over
    an [8, 128] idx (a row-group select, then the sublane shuffle)."""
    return _column(t, i, K, t.shape[0] - 1)


def transpose(x: torch.Tensor, K: int) -> torch.Tensor:
    """probe_inflate_step5.py:mk_transpose (D): K times ``x = x.T + 1``."""
    v = _s(x)
    for _ in range(K):
        v = v.t() + 1
    return _i32(v.contiguous())


def roll(x: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """probe_pallas3.py:pallas_roll, probe_pallas.py:p_roll: np.roll."""
    n = x.shape[axis]
    src = torch.remainder(torch.arange(n, device=x.device) - shift, n)
    return x.index_select(axis, src)


def bitonic(x: torch.Tensor, segment: str) -> torch.Tensor:
    """probe_pallas3.py p_bitonic ("flat"), p_rows ("rows"), p_cols
    ("cols"): each segment of an int32 [..., S, L] tile sorted ascending by
    the bitonic network of the TPU kernels (partner ``lin ^ j``, ascending
    where ``lin & k == 0``)."""
    S, L = x.shape[-2:]
    v = x.reshape(-1, S, L)
    v = (v.reshape(v.shape[0], 1, S * L) if segment == "flat"
         else v.transpose(1, 2) if segment == "cols" else v)
    n = v.shape[-1]
    lin = torch.arange(n, device=x.device)
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            pv = v[..., lin ^ j]
            take_min = ((lin & j) == 0) == ((lin & k) == 0)
            v = torch.where(take_min, torch.minimum(v, pv),
                            torch.maximum(v, pv))
            j //= 2
        k *= 2
    v = v.transpose(1, 2) if segment == "cols" else v
    return v.reshape(x.shape).contiguous()


def _refill(stream: torch.Tensor, off: torch.Tensor, win: int, K: int = 1,
            alt: int = 0) -> torch.Tensor:
    """The window of win words at off (+ alt after an odd number of earlier
    refills) of each row of stream, as the K-th refill leaves it; off on
    any device."""
    o = _s(off).to(stream.device).reshape(-1, 1) + ((K - 1) & 1) * alt
    idx = o + torch.arange(win, device=stream.device)
    return torch.gather(stream, 1, idx)


def refill_dma(off: torch.Tensor, stream: torch.Tensor,
               WIN: int) -> torch.Tensor:
    """probe_inflate_step.py:refill_dma: ``win[i] = stream[i, off[0, i]:
    off[0, i] + WIN]``."""
    return _refill(stream, off, WIN)


def refill_vmem(off: torch.Tensor, stream: torch.Tensor,
                WIN: int) -> torch.Tensor:
    """probe_inflate_step3.py:refill_vmem: ``win[i] = stream[i, off[i]:
    off[i] + WIN]``."""
    return _refill(stream, off, WIN)


def refill3d(stream: torch.Tensor, blkv: torch.Tensor,
             nrefills: int) -> torch.Tensor:
    """probe_inflate_step4.py:refill3d: nrefills times, rows blk and blk + 1
    of lane i's [NB, 64] blocks, blk = blkv[0, i] + (refill & 1); returns
    the last refill's [R, 2, 64]."""
    R, NB, B = stream.shape
    flat = stream.reshape(R, NB * B)
    return _refill(flat, blkv * B, 2 * B, nrefills, B).reshape(R, 2, B)


def step_loop(win: torch.Tensor, tll: torch.Tensor, td: torch.Tensor,
              i: torch.Tensor, K: int) -> torch.Tensor:
    """probe_inflate_step3.py:step_loop: the decode-step skeleton over
    int32 [R, 128] (an element a lane, its row's window and tables): two
    window words, root and sub litlen, root and sub distance, the bit
    arithmetic between; returns ``acc + bitpos``."""
    w_, ll, dd = _s(win), _s(tll), _s(td)
    bp = _s(i)
    acc = torch.zeros_like(bp)
    for _ in range(K):
        wi = (bp >> 5) & 63
        sh = bp & 31
        w0 = torch.gather(w_, 1, wi)
        w1 = torch.gather(w_, 1, (wi + 1) & 63)
        bits = (((w0 >> sh) & _M32) | _high_part(w1 & _M32, sh)) & 0x7FFFFFFF
        e = torch.gather(ll, 1, bits & 127)
        e2 = torch.gather(ll, 1, ((e >> 8) + (bits >> 9)) & 127)
        e = torch.where((e & 48) == 48, e2, e)
        clen = e & 15
        bits2 = (bits >> clen) & 0x3FFFFFF
        ed = torch.gather(dd, 1, bits2 & 127)
        ed2 = torch.gather(dd, 1, ((ed >> 8) + (bits2 >> 9)) & 127)
        ed = torch.where((ed & 48) == 48, ed2, ed)
        adv = clen + (ed & 15) + 1
        bp = _s(_i32(bp + (adv & 31)))
        acc = acc ^ bits
    return _i32(acc + bp)


def _funnel(lo: torch.Tensor, hi: torch.Tensor,
            sh: torch.Tensor) -> torch.Tensor:
    """((hi:lo) >> sh) mod 2^32 for uint32 lo and hi (int64), sh < 32."""
    return ((lo >> sh) | _high_part(hi, sh)) & _M32


def _litlen(e: torch.Tensor, b0: torch.Tensor) -> tuple:
    """A resolved u16 litlen entry e (clen bits 0-3, kind 4-5, symbol 6-13)
    over the stream bits b0, as mk_lane_major_step reads it: (the match
    length, used1 = clen + the length's extra bits, whether it is a length
    (kind 1)), int64."""
    clen, kind, sym = e & 15, (e >> 4) & 3, (e >> 6) & 0xFF
    e_len = torch.clamp(torch.clamp(sym - 4, min=0) >> 2, max=5)
    lbase = torch.where(sym < 4, sym + 3, ((4 + (sym & 3)) << e_len) + 3)
    e_len = torch.where(sym >= 28, 0, e_len)
    lbase = torch.where(sym >= 28, 258, lbase)
    eb = torch.where(kind == 1, e_len, 0)
    return lbase + ((b0 >> clen) & _ones_below(eb)), clen + eb, kind == 1


def _dist(ed: torch.Tensor, bits2: torch.Tensor) -> tuple:
    """A resolved u16 distance entry over the bits after the length: (the
    distance + 1, dclen + its extra bits), int64."""
    dclen, ds = ed & 15, (ed >> 6) & 31
    e_d = torch.clamp(ds - 2, min=0) >> 1
    dbase1 = torch.where(ds < 4, ds, (2 + (ds & 1)) << e_d)
    deb = torch.where(ds < 4, 0, e_d)
    return dbase1 + ((bits2 >> dclen) & _ones_below(deb)), dclen + deb


def lane_major_step(win: torch.Tensor, tll: torch.Tensor, td: torch.Tensor,
                    bp: torch.Tensor, K: int, root_cells: int,
                    sub_cells: int) -> tuple:
    """probe_inflate_step5.py:mk_lane_major_step, "onehot" mode: the
    lane-major decode step over uint32 columns (win [W, L], tll and td
    [root_cells + sub_cells, L], u16 entries two a cell) and an int32
    bitpos [R0, L] whose element (r, l) reads column l.  Returns the bitpos
    after K steps (the TPU function's output) and the tokens, int32
    [K, R0 * L]."""
    W, rc, sc = win.shape[0], root_cells, sub_cells
    rbits = (2 * rc).bit_length() - 1
    w_, ll, dd = _u(win), _u(tll), _u(td)
    lroot, lsub, droot, dsub = ll[:rc], ll[rc:rc + sc], dd[:rc], dd[rc:rc + sc]
    bitpos = _s(bp)
    tokens = []

    def fetch(t, idx, n):
        return torch.gather(t, 0, idx & (n - 1))

    def half(cell, i):
        return (cell >> ((i & 1) << 4)) & 0xFFFF

    for _ in range(K):
        wi = torch.remainder(bitpos >> 5, W - 2)
        sh = bitpos & 31
        w0, w1, w2 = (fetch(w_, wi + d, W) for d in range(3))
        b0 = _funnel(w0, w1, sh)
        b1 = _funnel(w1, w2, sh)
        idxr = b0 & ((1 << rbits) - 1)
        e = half(fetch(lroot, idxr >> 1, rc), idxr)
        sidx = (((e >> 6) & 0xFF) << 1) + ((b0 >> rbits) & _ones_below(e & 15))
        e2 = half(fetch(lsub, sidx >> 1, sc), sidx)
        e = torch.where(((e >> 4) & 3) == 3, e2, e)
        mlen, used1, is_len = _litlen(e, b0)
        bits2 = _funnel(b0, b1, used1)
        didx = bits2 & ((1 << rbits) - 1)
        ed = half(fetch(droot, didx >> 1, rc), didx)
        dsidx = (((ed >> 6) & 0xFF) << 1) + ((bits2 >> rbits)
                                             & _ones_below(ed & 15))
        ed2 = half(fetch(dsub, dsidx >> 1, sc), dsidx)
        ed = torch.where(((ed >> 4) & 3) == 3, ed2, ed)
        dist1, dadv = _dist(ed, bits2)
        adv = used1 + torch.where(is_len, dadv, 0)
        tok = (2 | (mlen << 2) | (dist1 << 11)) & _M32
        bitpos = _s(_i32(bitpos + (adv & 15) + (tok & 1)))
        tokens.append(tok.reshape(-1))
    toks = (torch.stack(tokens) if tokens else
            torch.zeros((0, bitpos.numel()), dtype=torch.int64,
                        device=bp.device))
    return bitpos.to(torch.int32), _i32(toks)


def tokens_dma(t: torch.Tensor, i: torch.Tensor, K: int) -> tuple:
    """probe_inflate_step4.py:tokens_dma: K steps of ``g = t[r, idx & 127];
    idx += g`` over int32 [R, 128], each step's g a token.  Returns the
    tokens of every lane given, [K, R * 128], and the step count.  The TPU
    kernel keeps row 0's tokens ([K, 128]): this function on ``t[:1],
    i[:1]``."""
    tt = _s(t)
    idx = _s(i)
    out = []
    for _ in range(K):
        g = torch.gather(tt, 1, idx & 127)
        out.append(g.reshape(-1))
        idx = _s(_i32(idx + g))
    toks = (torch.stack(out) if out else
            torch.zeros((0, idx.numel()), dtype=torch.int64, device=t.device))
    return toks.to(torch.int32), K


# -- kernel wrappers ---------------------------------------------------------


def _on(*ts: torch.Tensor) -> torch.device:
    """The one device of ts: the CPU, or a CUDA device; else KernelError."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("probe inputs on different devices")
        if t.dtype != torch.int32:
            raise ValueError(f"probe inputs are int32, got {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise KernelError(f"no probe kernel for device {dev}")
    return dev


def _raw_stream(dev: torch.device) -> int:
    """The raw handle of dev's current stream (a CUDA device with its
    index), read without building a torch Stream object."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _args(dev: torch.device, clk):
    return None if clk is None else clk.data_ptr(), _raw_stream(dev)


_WALK = 4   # qz_probe_chain's mode (QZP_WALK)


def _dep(t: torch.Tensor, idx: torch.Tensor, K: int, smem: bool,
         clk: torch.Tensor | None) -> torch.Tensor:
    """DEP on the card (qz_probe_dep): every check once, no reshape (the
    kernel reads [rows, cols] and [t_rows, w] from the contiguous
    storage), the output like idx."""
    dev = t.get_device()
    if (t.dtype != torch.int32 or idx.dtype != torch.int32
            or idx.get_device() != dev):
        raise ValueError("dep takes int32 tables and indexes on one device")
    w, cols = t.shape[-1], idx.shape[-1]
    if w < 1 or w & (w - 1):
        raise ValueError("probe tables are a power of 2 wide")
    tt = t if t.is_contiguous() else t.contiguous()
    ii = idx if idx.is_contiguous() else idx.contiguous()
    out = torch.empty_like(ii)
    if not cols or not ii.numel():
        return out
    rows, t_rows = ii.numel() // cols, tt.numel() // w
    if t_rows not in (1, rows):
        raise ValueError("a chain table has 1 row or a row an index row")
    DEP(int(smem), tt.data_ptr(), t_rows, w, ii.data_ptr(), out.data_ptr(),
        rows, cols, K, None if clk is None else clk.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev))
    return out


def _pow2_below(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def indep_copies(w: int, W: int) -> int:
    """R, the copies of each word of a w-word table row that the INDEP
    kernel stages (qzp_indep_r): the largest power of 2 up to 32 whose
    (w + W - 1) R words fit in a CTA's shared memory; 0 where none does."""
    r = INDEP_MAX_R
    while r and (w + W - 1) * r * 4 > MAX_SMEM:
        r //= 2
    return r


def indep_check(w: int, W: int, smem: bool) -> None:
    """ValueError unless the INDEP kernel takes a table row of w words: a
    power of 2, and, staged (smem), one copy of it and its W - 1 wrapped
    words fit in a CTA's shared memory."""
    if w < 1 or w & (w - 1) or (smem and not indep_copies(w, W)):
        raise ValueError(
            f"indep runs on the card over tables a power of 2 wide (staged: "
            f"up to {_pow2_below(MAX_SMEM // 4 - W + 1)} words); got {w}")


def _indep(W: int, t: torch.Tensor, idx: torch.Tensor, K: int, smem: bool,
           clk: torch.Tensor | None) -> torch.Tensor:
    """INDEP on the card (qz_probe_indep): every check once, no reshape,
    the output like idx."""
    dev = t.get_device()
    if (t.dtype != torch.int32 or idx.dtype != torch.int32
            or idx.get_device() != dev):
        raise ValueError("indep takes int32 tables and indexes on one device")
    w, cols = t.shape[-1], idx.shape[-1]
    indep_check(w, W, smem)
    tt = t if t.is_contiguous() else t.contiguous()
    ii = idx if idx.is_contiguous() else idx.contiguous()
    out = torch.empty_like(ii)
    if not cols or not ii.numel():
        return out
    rows, t_rows = ii.numel() // cols, tt.numel() // w
    if t_rows not in (1, rows):
        raise ValueError("a chain table has 1 row or a row an index row")
    INDEP(W, int(smem), tt.data_ptr(), t_rows, w, ii.data_ptr(),
          out.data_ptr(), rows, cols, K, None if clk is None else
          clk.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
    return out


def probe_chain(mode: str, t: torch.Tensor, idx: torch.Tensor | None, K: int,
                *, smem: bool = True, post: int | None = None,
                clk: torch.Tensor | None = None) -> torch.Tensor:
    """Table lookups, K a lane: ``dep`` (qz_probe_dep) and ``indep4`` /
    ``indep8`` (qz_probe_indep; :func:`indep_check`) as
    :func:`dep_gather_loop` / :func:`indep_gather_loop` (tables of 1 or R
    rows), ``column`` as :func:`probe_column` (post: the mask after each
    sum, default N - 1), ``walk`` (qz_probe_chain) as :func:`scalar_walk`
    (idx unused).  smem: the table staged in shared memory, else read with
    __ldg."""
    if mode == "dep" and t.is_cuda:
        return _dep(t, idx, K, smem, clk)
    if mode in ("indep4", "indep8") and t.is_cuda:
        return _indep(int(mode[-1]), t, idx, K, smem, clk)
    if mode == "column":
        return probe_column(t, idx, K, smem=smem, post=post, clk=clk)
    if mode == "walk":
        dev = _on(t)
    else:
        dev = _on(t, idx)
    w = t.shape[-1]
    if dev.type == "cpu":
        if mode == "dep":
            return dep_gather_loop(t, idx, K)
        if mode in ("indep4", "indep8"):
            return indep_gather_loop(t, idx, K, int(mode[-1]))
        if mode == "walk":
            return scalar_walk(t, K)
        raise ValueError(f"no chain mode {mode}")
    if mode != "walk":
        raise ValueError(f"no chain mode {mode}")
    if w & (w - 1) or t.shape[0] & (t.shape[0] - 1):
        raise ValueError("probe tables are a power of 2 wide")
    tt = t.contiguous()   # no index array: idx points at the table, unread
    out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    CHAIN(_WALK, int(smem), tt.data_ptr(), tt.shape[0], tt.shape[1],
          tt.data_ptr(), out.data_ptr(), 1, 1, K, w - 1, *_args(dev, clk))
    return out


def column_check(n: int, rows: int, cols: int, post: int) -> None:
    """ValueError unless the COLUMN kernel takes the shape: a column of n
    entries, n a power of 2 up to 1024; a multiple of 32 columns (lanes),
    from 1 to 32 index rows; post of the form 2^p - 1 and at least n - 1
    (so that the kernel masks the chain once, after its last step)."""
    post &= _M32
    if (n < 1 or n & (n - 1) or n > COLUMN_MAX_N or cols < 32 or cols % 32
            or not 1 <= rows <= 32 or post & (post + 1) or post < n - 1):
        raise ValueError(
            f"column runs on the card at n a power of 2 up to "
            f"{COLUMN_MAX_N}, a multiple of 32 columns, 1-32 index rows and "
            f"post 2^p - 1 >= n - 1; got n {n}, {cols} columns, {rows} rows, "
            f"post {post:#x}")


def probe_column(t: torch.Tensor, idx: torch.Tensor, K: int, *,
                 smem: bool = True, post: int | None = None,
                 clk: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`_column`: K dependent lookups down each lane's column of an
    int32 [N, L] table from int32 [R, L] indexes, ``post`` the mask after
    each sum (default N - 1).  On the card (qz_probe_column) only the
    shapes of :func:`column_check`: a CTA a block of 32 columns stages it
    in shared memory with every load in flight (smem), or reads the table
    with __ldg."""
    if post is None:
        post = t.shape[0] - 1
    if not t.is_cuda:
        _on(t, idx)
        return _column(t, idx, K, post)
    dev = t.get_device()
    if (t.dtype != torch.int32 or idx.dtype != torch.int32
            or idx.get_device() != dev or t.dim() != 2):
        raise ValueError("column takes an int32 [N, L] table and int32 "
                         "indexes on one device")
    n, cols = t.shape
    if idx.shape[-1] != cols:
        raise ValueError("column tables have a column a lane")
    ii = idx if idx.is_contiguous() else idx.contiguous()
    rows = ii.numel() // cols if cols else 0
    column_check(n, rows, cols, post)
    tt = _aligned(t)
    out = torch.empty_like(ii)
    COLUMN(int(smem), tt.data_ptr(), n, ii.data_ptr(), out.data_ptr(), rows,
           cols, K, post & _M32, None if clk is None else clk.data_ptr(),
           torch._C._cuda_getCurrentRawStream(dev))
    return out


_ALU_MODES = {"hash": 0, "ew": 1, "double": 2, "shfl": 3, "bar": 4}
_ALU_PLAIN = {"hash": elemwise_loop, "ew": ew, "double": double,
              "shfl": shfl_pairs, "bar": count_up}


def probe_alu(mode: str, x: torch.Tensor, K: int,
              clk: torch.Tensor | None = None) -> torch.Tensor:
    """Register-only integer chains, K a lane (qz_probe_alu): ``hash`` as
    :func:`elemwise_loop`, ``ew`` as :func:`ew`, ``double`` as
    :func:`double`; ``shfl`` as :func:`shfl_pairs` (a dependent warp
    shuffle a step), ``bar`` x + K (a barrier of 128 threads a step)."""
    dev = _on(x)
    if dev.type == "cpu":
        return _ALU_PLAIN[mode](x, K)
    xx = x.contiguous()
    out = torch.empty_like(xx)
    ALU(_ALU_MODES[mode], xx.data_ptr(), out.data_ptr(), xx.numel(), K,
        *_args(dev, clk))
    return out


_STEP_MODES = {"step3": 0, "step5": 1, "tokens": 2}
_STORES = {"none": 0, "lone": 1, "tile": 2}


def step5_check(W: int, root_cells: int, sub_cells: int,
                lanes_per_cta: int) -> None:
    """ValueError unless STEP5's kernels are built for the shape (a window
    of 128 words, 128 or 256 root cells, 256 subtable cells) and the lanes
    a CTA (1, 8 or 32)."""
    if (W != STEP5_W or sub_cells != STEP5_SUB
            or root_cells not in STEP5_ROOTS
            or lanes_per_cta not in STEP5_LPC):
        raise ValueError(
            f"step5 runs on the card at W {STEP5_W}, root cells "
            f"{STEP5_ROOTS}, sub cells {STEP5_SUB} and lanes a CTA "
            f"{STEP5_LPC}; got W {W}, root {root_cells}, sub {sub_cells}, "
            f"{lanes_per_cta} lanes a CTA")


def tokens_rows(tile: int, lanes_per_cta: int) -> int:
    """qzp_tok_rows: the rows of each of the token tile's two buffers on
    the card, the tile where both fit beside the 384 staged words in a
    CTA's shared memory and a bulk tensor copy's box (256 rows), else the
    largest divisor of the tile that does."""
    for d in range(1, tile + 1):
        if (tile % d == 0 and tile // d <= 256
                and (384 + 2 * (tile // d) * lanes_per_cta) * 4 <= MAX_SMEM):
            return tile // d
    return 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-byte aligned (a copy where it is not)."""
    t = t if t.is_contiguous() else t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def probe_step(mode: str, store: str, win, tll, td, state: torch.Tensor,
               K: int, *, lanes_per_cta: int = 1, tile: int = 0,
               root_cells: int = 0, sub_cells: int = 0,
               clk: torch.Tensor | None = None) -> tuple:
    """A decode-step skeleton, K steps a lane (qz_probe_step), lanes_per_cta
    lanes (threads) a CTA.  Returns (out, tokens): ``step3`` as
    :func:`step_loop` (win, tll, td, state [R, 128]; tokens None);
    ``step5`` as :func:`lane_major_step` (state [1, L]; tokens [K, L] with
    store ``lone``, else None; on the card only the shapes of
    :func:`step5_check`, staged by a CTA of at least 128 threads that
    widens the tables' entries); ``tokens`` as :func:`tokens_dma` (tll is
    its t, win and td unused; out the step count a lane), store ``lone``
    (a 4-byte store a step) or ``tile`` (K a multiple of tile; on the card
    a double-buffered tile of :func:`tokens_rows` rows a buffer, each
    flushed by one bulk asynchronous tensor copy)."""
    arrays = [a for a in (win, tll, td, state) if a is not None]
    dev = _on(*arrays)
    if dev.type == "cpu":
        if mode == "step3":
            return step_loop(win, tll, td, state, K), None
        if mode == "step5":
            bp, toks = lane_major_step(win, tll, td, state, K, root_cells,
                                       sub_cells)
            return bp, (toks if store != "none" else None)
        if mode == "tokens":
            toks, steps = tokens_dma(tll, state, K)
            return torch.full(state.shape, steps, dtype=torch.int32), toks
        raise ValueError(f"no step mode {mode}")
    lanes = state.numel()
    W = win.shape[0] if mode == "step5" else 0
    if mode == "step5":
        step5_check(W, root_cells, sub_cells, lanes_per_cta)
        if state.shape[0] != 1 or any(a.shape != (a.shape[0], lanes)
                                      for a in (win, tll, td)):
            raise ValueError("step5 takes one row of lanes and a column of "
                             "each array a lane")
        if any(a.shape[0] != root_cells + sub_cells for a in (tll, td)):
            raise ValueError("step5's tables hold root + sub cells")
    elif state.shape[-1] != 128 or tll.shape != state.shape:
        raise ValueError(f"{mode} takes [R, 128] arrays")
    if store == "tile" and (tile < 1 or K % tile or lanes_per_cta % 4):
        raise ValueError("a token tile takes K a multiple of the tile and "
                         "lanes a CTA a multiple of 4")
    if lanes % lanes_per_cta:
        raise ValueError("the lanes are a multiple of the lanes a CTA")
    ins = [_aligned(a) if a is not None else None
           for a in (win, tll, td, state)]
    out = torch.empty(state.shape, dtype=torch.int32, device=dev)
    toks = (torch.empty((K, lanes), dtype=torch.int32, device=dev)
            if store != "none" else None)
    STEP(_STEP_MODES[mode], _STORES[store],
         *(a.data_ptr() if a is not None else None for a in ins),
         out.data_ptr(), toks.data_ptr() if toks is not None else None,
         lanes, lanes_per_cta, K, W, root_cells, sub_cells, tile,
         *_args(dev, clk))
    return out, toks


def probe_roll(x: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """:func:`roll` of an int32 [S, C] tile (qz_probe_roll): the lane axis
    (C = 128) by warp shuffles, the row axis (C <= 128) by a row
    permutation copied 16 bytes a thread."""
    if not x.is_cuda:
        _on(x)
        return roll(x, shift, axis)
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError("probe_roll takes an int32 [S, C] tile")
    xx = x if x.is_contiguous() else x.contiguous()
    rows, cols = xx.shape
    out = torch.empty_like(xx)
    if xx.numel():
        ROLL(xx.data_ptr(), out.data_ptr(), rows, cols,
             shift % xx.shape[axis], axis & 1, _raw_stream(xx.device))
    return out


def transpose_plan(n: int) -> dict:
    """qzp_tr_plan: the cluster that transposes an [n, n] tile on the card
    (4 <= n <= 128), a block of b x b words a CTA, nb blocks a side,
    ``ctas`` = nb * nb CTAs of ``threads`` threads, moving 16 bytes at
    once, buffer rows of ``stride`` words."""
    b = min(n, 32)
    return {"b": b, "nb": n // b, "ctas": (n // b) ** 2, "stride": b + 4,
            "threads": max(32, b * b // 4)}


def probe_transpose(x: torch.Tensor, K: int,
                    clk: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`transpose` of an int32 [n, n] tile, n <= 128 a power of 2,
    over a thread-block cluster of (n / 32)^2 CTAs (qz_probe_transpose),
    each CTA storing its block into its partner's shared memory by
    st.async counted on the partner's mbarrier.  The kernel moves 16 bytes
    at once: a tile that is not 16-byte aligned is copied first, and one
    of n < 4 is run zero-padded to [4, 4].  clk, if given: int64 of at
    least 1 + the cluster's CTAs; it receives the ticks of the steps and
    the SM of each CTA."""
    if not x.is_cuda:
        _on(x)
        return transpose(x, K)
    n = x.shape[0] if x.dim() == 2 and x.shape[1] == x.shape[0] else 0
    if x.dtype != torch.int32 or not 1 <= n <= 128 or n & (n - 1):
        raise ValueError("probe_transpose takes an int32 [n, n] tile, "
                         "n <= 128 a power of 2")
    if n < 4:
        pad = x.new_zeros(4, 4)
        pad[:n, :n] = x
        return probe_transpose(pad, K, clk)[:n, :n].contiguous()
    if clk is not None and clk.numel() < 1 + transpose_plan(n)["ctas"]:
        raise ValueError("a transpose's clk holds 1 + its CTAs")
    xx = x if x.is_contiguous() else x.contiguous()
    if xx.data_ptr() % 16:
        xx = xx.clone()
    out = torch.empty_like(xx)
    TRANSPOSE(xx.data_ptr(), out.data_ptr(), n, K,
              None if clk is None else clk.data_ptr(),
              torch._C._cuda_getCurrentRawStream(xx.get_device()))
    return out


_REFILL = {"ld": 0, "cp": 1, "tma": 2}


def probe_refill(stream: torch.Tensor, off, win: int, K: int = 1, *,
                 alt: int = 0, how: str = "ld",
                 clk: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`_refill`: K refills of each lane's window of win words at
    off (+ alt on odd refills) from its row of stream into shared memory
    (qz_probe_refill), a warp a lane, by plain loads (``ld``), cp.async
    (``cp``) or a TMA bulk copy (``tma``); returns the last window of each
    lane, [B, win].  For a stream on the card, off (an int per lane) is a
    CPU tensor or an array: the launch carries it in its parameters, and
    the windows' bounds are checked here from it, with no readback."""
    oo = torch.as_tensor(off)
    if stream.is_cuda and oo.is_cuda:
        raise ValueError("a refill on the card takes its offsets on the CPU")
    if stream.dtype != torch.int32 or stream.dim() != 2:
        raise ValueError("a refill takes int32 [B, n] streams")
    B, NW = stream.shape
    if oo.numel() != B or B == 0:
        raise ValueError("a refill takes an offset a lane")
    lo, hi = torch.aminmax(oo)
    step = alt if K > 1 else 0
    if int(lo) + min(step, 0) < 0 or int(hi) + max(step, 0) + win > NW:
        raise ValueError("a refill window lies outside its stream")
    if not stream.is_cuda:
        _on(stream)
        return _refill(stream, oo, win, K, alt)
    if B > MAX_LANES:
        raise ValueError(f"a refill on the card takes at most {MAX_LANES} "
                         "lanes")
    if oo.dtype != torch.int32 or not oo.is_contiguous():
        oo = oo.to(torch.int32).contiguous()
    ss = stream if stream.is_contiguous() else stream.contiguous()
    if how != "ld" and (NW % 4 or ss.data_ptr() % 16):
        raise ValueError("cp.async and TMA refills need 16-byte rows")
    out = torch.empty((B, win), dtype=torch.int32, device=ss.device)
    REFILL(_REFILL[how], ss.data_ptr(), out.data_ptr(), B, NW, oo.data_ptr(),
           alt, win, K, *_args(ss.device, clk))
    return out


def launch_floor(dev: torch.device, ctas: int = 1) -> None:
    """One launch of an empty kernel of ``ctas`` CTAs of a warp on the
    current stream of dev (a CUDA device with its index; qz_probe_empty):
    at one CTA the least time any launch takes."""
    EMPTY(ctas, _raw_stream(dev))


def bitonic_plan(n: int, m: int) -> dict:
    """qzp_bit_plan: how the card sorts segments of m in a tile of n: ``v``
    values a thread (slot), ``t`` slots a segment, ``threads`` a CTA, and
    the network's stages by where a pair's two values meet (``regs``: one
    thread; ``shfl``: lanes of a warp; ``smem``: across warps)."""
    v = m if m <= 8 else 4
    stages = {"regs": 0, "shfl": 0, "smem": 0}
    k = 2
    while k <= m:
        j = k // 2
        while j >= 1:
            stages["regs" if j < v else "shfl" if j < 32 * v else "smem"] += 1
            j //= 2
        k *= 2
    return {"v": v, "t": m // v, "threads": min(1024, max(32, n // v)),
            "stages": stages}


def bitonic_check(S: int, L: int) -> None:
    """ValueError unless the BITONIC kernel takes an [S, L] tile: S and L
    powers of 2, S * L from 32 to 4096 elements."""
    lo, hi = BITONIC_N
    if (S < 1 or L < 1 or S & (S - 1) or L & (L - 1)
            or not lo <= S * L <= hi):
        raise ValueError(
            f"bitonic runs on the card over tiles of {lo} to {hi} elements, "
            f"powers of 2 on both axes; got [{S}, {L}]")


def probe_bitonic(x: torch.Tensor, segment: str, K: int = 1,
                  clk: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`bitonic`: each segment (``flat``, ``rows`` or ``cols``) of
    each int32 [S, L] tile of x sorted by the network, K times, in one CTA
    (qz_probe_tile BITONIC; :func:`bitonic_check`): a thread's values in
    registers, pairs across threads by warp shuffles, across warps through
    shared memory."""
    if _on(x).type == "cpu":
        return bitonic(x, segment)
    S, L = x.shape[-2:]
    bitonic_check(S, L)
    seg = {"flat": (S * L, 0, 1), "rows": (L, L, 1),
           "cols": (S, 1, L)}[segment]
    xx = x.contiguous()
    out = torch.empty_like(xx)
    TILE(xx.data_ptr(), out.data_ptr(), S, L, K, *seg,
         xx.numel() // (S * L), *_args(xx.device, clk))
    return out


def probe_bitonic_64k(x: torch.Tensor, K: int = 1,
                      clk: torch.Tensor | None = None) -> torch.Tensor:
    """probe_pallas.py:154 p_bitonic, :186 p_bitonic_grid and :225
    p_bitonic_grid2: each row of an int32 [B, 512, 128] (the TPU's tiles)
    or [B, 65536] sorted ascending in signed int32 order by the TPU
    kernels' network (``k_bitonic``, ``k_bitonic3``).  On the CPU the
    plain version, :func:`bitonic` of each [512, 128] tile; on the card
    qz_probe_bitonic_row, K sorts a row over a thread-block cluster of 16
    CTAs, the passes across CTAs through distributed shared memory.  clk,
    if given: int64 of at least 17; it receives the ticks of the sorts and
    the SM of each CTA of the first row."""
    dev = _on(x)
    if not ((x.dim() == 3 and tuple(x.shape[1:]) == (512, 128))
            or (x.dim() == 2 and x.shape[1] == ROW_N)):
        raise ValueError("the 64K sort takes int32 [B, 512, 128] or "
                         f"[B, 65536]; got {list(x.shape)}")
    if dev.type == "cpu":
        return bitonic(x.reshape(-1, 512, 128), "flat").reshape(x.shape)
    rows = x.shape[0]
    if clk is not None and clk.numel() < 1 + ROW_CTAS:
        raise ValueError("a row sort's clk holds 1 + its cluster's CTAs")
    xx = x if x.is_contiguous() else x.contiguous()
    if xx.data_ptr() % 16:
        xx = xx.clone()
    out = torch.empty_like(xx)
    if rows:
        ROW(xx.data_ptr(), out.data_ptr(), rows, K, *_args(dev, clk))
    return out
