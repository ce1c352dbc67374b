"""Lockstep DEFLATE entropy decoder: the device half of the hybrid inflate
pipeline.

Port of qatzip_tpu/ops/pallas_inflate.py.  The device decodes the serial
Huffman half of DEFLATE for any number of independent blocks in one
launch, one block per lane, and emits one fixed-width token per (step,
lane); the host applies the tokens (``libqzcore``'s ``qz_apply_round``,
native/qzapply.cpp) and carries the 32 KB history between rounds.

Region layout.  The port uses the reference's 9-bit/9-bit layout
(``region_spec(False)``) for both its plain version and its kernel: per lane
a litlen and a distance region of CELLS u32 cells, cells 0..255 the 9-bit
root (u16 entries packed two per cell) and cells 256..511 the subtable
area.  The reference's 8/7-bit Pallas roots exist only because a one-hot
fetch on the TPU costs in proportion to the table's rows.  With the same
layout the port's tokens equal the reference XLA driver's exactly.

  litlen u16:  clen[0:4] kind[4:6] payload[6:14]
     kind 0 literal : payload = byte
     kind 1 length  : payload = length symbol index 0..28
     kind 2 EOB
     kind 3 subptr  : clen field = subbits, payload = sub_base/2
  dist u16:    clen[0:4] kind[4:6] payload[6:11] = dist symbol 0..29
  u16 == 0 -> invalid (corrupt stream; the lane errors)

Token format (shared with qz_apply_round, qatzip_tpu_torch/native/qzapply.cpp):
  0                  inactive (lane done / padding)
  bit0=1             literal, byte in bits 1..8; bit9=1 marks a paired
                     second literal, byte in bits 10..17
  bit0=0,bit1=1      match, len(3..258) in bits 2..10, dist-1 in bits 11..25

uint32 data (stream words, table cells, tokens) travels as int32 tensors
holding the same bit pattern; the plain version computes in int64.

Regions.  ``libqzcore``'s ``qz_inflate_regions`` (native/qzregions.cpp)
builds them, a round's lanes in one call (ops/deflate_decode.py's
``pack_round``), and :func:`static_regions` once for the static block; the
tests hold it to the reference's numpy builders
(qatzip_tpu/ops/pallas_inflate.py), byte for byte and reject for reject.

* :func:`_decode_ref` is the plain torch version of the reference driver
  ``_decode_xla`` (:335-387), built on :func:`decode_step` (:212-329).
* ops/inflate_kernel.py launches ``csrc/inflate.cu`` for CUDA tensors.
* :func:`decode_blocks` takes host arrays and a device and dispatches on
  the device, as the reference's ``decode_blocks`` (:393-417) does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from qatzip_tpu_torch.native import qzcore
from qatzip_tpu_torch.ops import deflate_tables as T

CELLS = 512          # u32 cells per region (root 256 + sub 256)
ROOT_BITS = 9
_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=1)
def static_regions() -> tuple[np.ndarray, np.ndarray]:
    """The static block's (tll, td) regions, uint32[CELLS] each."""
    tll = np.zeros((1, CELLS), np.uint32)
    td = np.zeros((1, CELLS), np.uint32)
    qzcore.inflate_regions([(T.STATIC_LITLEN_LEN, T.STATIC_DIST_LEN)], tll,
                           td)
    return tll[0], td[0]


# ---------------------------------------------------------------------------
# Step arithmetic (torch; int64 tensors holding u32 values)
# ---------------------------------------------------------------------------
def _mask(nbits):
    return (1 << nbits) - 1


def _root_entry(root_fetch, bits):
    """Root-level u16 entry for the low ROOT_BITS of ``bits``."""
    idx = bits & ((1 << ROOT_BITS) - 1)
    cell = root_fetch(idx >> 1)
    return (cell >> ((idx & 1) << 4)) & 0xFFFF


def _resolve(root_fetch, sub_fetch, bits):
    """Root+sub lookup through the packed region.  Returns (entry,
    resolved_at_root)."""
    e = _root_entry(root_fetch, bits)
    is_sub = ((e >> 4) & 3) == 3
    sidx = (((e >> 6) & 0xFF) << 1) + ((bits >> ROOT_BITS) & _mask(e & 15))
    cell2 = sub_fetch(sidx >> 1)
    e2 = (cell2 >> ((sidx & 1) << 4)) & 0xFFFF
    return torch.where(is_sub, e2, e), ~is_sub


def decode_step(peek2, ll_root, ll_sub, d_root, d_sub, st):
    """One lockstep symbol decode.  ``st`` = (bitpos, done, err, outcnt,
    end_bit); ``peek2(bitpos) -> (b0, b1)`` returns the next 64 stream
    bits as two words; ``*_root/*_sub(cell_idx)`` fetch packed table cells
    from the root/sub areas.  Length/distance base+extra come from
    RFC1951's closed forms.  Returns (token, new_st)."""
    bitpos, done, err, outcnt, end_bit = st

    b0, b1 = peek2(bitpos)
    e, at_root = _resolve(ll_root, ll_sub, b0)
    clen = e & 15
    kind = (e >> 4) & 3
    bad = (e == 0) | (kind == 3)  # unresolved subptr = corrupt stream
    islit = (kind == 0) & ~bad
    islen = kind == 1
    iseob = kind == 2
    sym = (e >> 6) & 0xFF
    # length base/extra closed form: sym 0..27 -> e=(max(sym,4)-4)>>2,
    # base = sym<4 ? sym+3 : ((4+(sym&3))<<e)+3; sym 28 -> 258, e=0
    e_len = torch.clamp((sym - 4).clamp(min=0) >> 2, max=5)
    lbase = torch.where(sym < 4, sym + 3, ((4 + (sym & 3)) << e_len) + 3)
    e_len = torch.where(sym >= 28, 0, e_len)
    lbase = torch.where(sym >= 28, 258, lbase)
    eb = torch.where(islen, e_len, 0)
    mlen = lbase + ((b0 >> clen) & _mask(eb))
    used1 = clen + eb  # <= 20 bits

    bits2 = ((b0 >> used1) | ((b1 << (31 - used1)) << 1)) & _M32
    ed, _ = _resolve(d_root, d_sub, bits2)
    dclen = ed & 15
    dbad = (ed == 0) | (((ed >> 4) & 3) != 0)
    ds = (ed >> 6) & 31
    # dist base closed form: s<4 -> base-1=s, e=0; else e=(s-2)>>1,
    # base-1 = (2+(s&1))<<e
    e_d = (ds - 2).clamp(min=0) >> 1
    dbase1 = torch.where(ds < 4, ds, (2 + (ds & 1)) << e_d)
    deb = torch.where(ds < 4, 0, e_d)
    dist1 = dbase1 + ((bits2 >> dclen) & _mask(deb))

    bad = bad | (islen & dbad)
    islen = islen & ~bad
    islit = islit & ~bad

    active = ~done & ~err
    lit_tok = 1 | (sym << 1)
    len_tok = 2 | (mlen << 2) | (dist1 << 11)
    token = (active & islit) * lit_tok + (active & islen) * len_tok

    # literal pairing: a root-resolved literal followed by another root
    # literal decodes both in this step (bit 9 flag, byte in bits 10..17);
    # any other second symbol defers to the next step
    pair = active & islit & at_root
    e2 = _root_entry(ll_root, b0 >> clen)
    lit2 = pair & (e2 != 0) & (((e2 >> 4) & 3) == 0)
    token = (token + lit2 * (0x200 | (((e2 >> 6) & 0xFF) << 10))) & _M32

    new_end = torch.where(active & iseob, bitpos + used1, end_bit)
    new_err = err | (active & bad)
    new_done = done | (active & (iseob | bad))
    new_outcnt = outcnt + (active & islit) + lit2 + (active & islen) * mlen
    adv = used1 + islen * (dclen + deb) + lit2 * (e2 & 15)
    new_bitpos = bitpos + active * adv
    return token, (new_bitpos, new_done, new_err, new_outcnt, new_end)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 u32 value."""
    return x.to(torch.int64) & _M32


def _decode_ref(stream_words, bit0, nbits, tll, td, active0,
                max_steps: int):
    """Plain torch version of the lockstep decode (the reference driver
    ``_decode_xla``).  stream_words int32[B, NW]; bit0/nbits int32[B];
    tll/td int32[B, CELLS]; active0 bool[B] — all on one device.  Returns
    (tokens int32[max_steps, B], err bool[B], outcnt int32[B],
    end_bit int32[B], nsteps int32[1])."""
    B, NW = stream_words.shape
    dev = stream_words.device
    words = _u32(stream_words)
    tll64 = _u32(tll)
    td64 = _u32(td)

    def peek2(bitpos):
        wi = torch.clamp(bitpos >> 5, 0, NW - 3)[:, None]
        sh = bitpos & 31
        w0, w1, w2 = (words.gather(1, wi + k)[:, 0] for k in range(3))
        b0 = ((w0 >> sh) | ((w1 << (31 - sh)) << 1)) & _M32
        b1 = ((w1 >> sh) | ((w2 << (31 - sh)) << 1)) & _M32
        return b0, b1

    def mk_cell(tbl, base):
        def f(idx):
            i = torch.clamp(base + idx, 0, CELLS - 1)[:, None]
            return tbl.gather(1, i)[:, 0]
        return f

    fetch = (mk_cell(tll64, 0), mk_cell(tll64, 256),
             mk_cell(td64, 0), mk_cell(td64, 256))
    rows = []
    active0 = active0.to(torch.bool)
    st = (bit0.to(torch.int64), ~active0,
          torch.zeros(B, dtype=torch.bool, device=dev),
          torch.zeros(B, dtype=torch.int64, device=dev),
          torch.full((B,), -1, dtype=torch.int64, device=dev))
    while len(rows) < max_steps and not bool((st[1] | st[2]).all()):
        tok, st = decode_step(peek2, *fetch, st)
        rows.append(tok)
    step = len(rows)
    bitpos, done, err, outcnt, end_bit = st
    # a lane still undone at max_steps, that ran past its stream, or that
    # has no EOB is decoded on the CPU instead
    err = err | (active0 & ~done) | (active0 & (bitpos > nbits.to(torch.int64)))
    err = err | (active0 & ~err & (end_bit < 0))
    tokens = torch.zeros((max_steps, B), dtype=torch.int32, device=dev)
    if rows:
        t = torch.stack(rows)
        tokens[:step] = torch.where(t >= 1 << 31, t - (1 << 32), t)
    return (tokens, err, outcnt.to(torch.int32),
            end_bit.to(torch.int32),
            torch.tensor([step], dtype=torch.int32, device=dev))


def decode_lockstep(stream_words, bit0, nbits, tll, td, active,
                    max_steps: int):
    """Tensor-level dispatch: the plain version for tensors on the CPU, the
    kernel (ops/inflate_kernel.py) for CUDA tensors."""
    from qatzip_tpu_torch.ops import inflate_kernel as K

    if K._capture is not None:
        K._capture.append((stream_words, bit0, nbits, tll, td, active,
                           max_steps))
    dev = stream_words.device
    if dev.type == "cpu":
        return _decode_ref(stream_words, bit0, nbits, tll, td, active,
                           max_steps)
    if dev.type != "cuda":
        raise K.KernelError(f"no inflate kernel for device {dev}")

    return K.decode(stream_words, bit0, nbits, tll, td, active, max_steps)


def upload(stream_words: np.ndarray, bit0: np.ndarray, nbits: np.ndarray,
           tll: np.ndarray, td: np.ndarray, active: np.ndarray,
           device: torch.device):
    """Host arrays of one round -> the tensors ``decode_lockstep`` takes."""
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype).view(
            np.int32)).to(device, non_blocking=True)

    return (up(stream_words, np.uint32), up(bit0, np.int32),
            up(nbits, np.int32), up(tll, np.uint32), up(td, np.uint32),
            up(active, np.int32) != 0)


def decode_blocks(stream_words: np.ndarray, bit0: np.ndarray,
                  nbits: np.ndarray, tll: np.ndarray, td: np.ndarray,
                  active: np.ndarray, max_steps: int,
                  device: torch.device):
    """Decode one deflate block per lane on ``device``.  Host numpy in, host
    numpy out: (tokens u32[S, B], err bool[B], outcnt i32[B], end_bit i32[B],
    nsteps)."""
    tokens, err, outcnt, end_bit, ns = decode_lockstep(
        *upload(stream_words, bit0, nbits, tll, td, active, device),
        max_steps)
    ns = int(ns[0])
    return (tokens[:ns].cpu().numpy().view(np.uint32), err.cpu().numpy(),
            outcnt.cpu().numpy(), end_bit.cpu().numpy(), ns)
