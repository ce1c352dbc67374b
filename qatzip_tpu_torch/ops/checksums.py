"""Device checksums: CRC32 and Adler-32 of every block of a batch.

Port of qatzip_tpu/ops/checksums.py (lines 29-163).  The reference's
hardware returns the chunk checksum with every completed request, so the
host never re-scans the data; here the card computes it from the staged
batch.  CRC32 is GF(2)-linear in the message bits, so a batch of blocks
reduces with a log-depth combine tree of constant 32x32 bit matrices
("advance the register by 2^k zero bytes"), with per-word leaf CRCs from
the same kind of matrix.  The reference applies a matrix as 32 select-XORs
(no TPU gathers); here it is four lookups in the matrix's byte tables (the
XOR of the columns a byte value picks), about 16 launches an apply
instead of 96.  Adler-32 is two modular sums.

Variable block lengths: blocks are right-aligned (padding becomes leading
zeros, which leave a zero register at 0) before the tree; the init and
final-xor convention is restored per block with a ladder of the same
zero-advance matrices.  u32 values ride int64 tensors (torch on the CPU
has no uint32 shift).  Equal to ``zlib.crc32``/``zlib.adler32`` for every
length, 0 included.

* :func:`crc32_blocks_ref` and :func:`adler32_blocks_ref` are the plain
  torch versions (the tree and the ladder are some hundreds of launches a
  call on the card).
* :func:`crc32_blocks` and :func:`adler32_blocks` run them for tensors on
  the CPU, and for CUDA tensors launch ``csrc/checksum.cu`` (a cluster of
  CTAs a row, a slice a thread, one launch a call, int32 or int64
  lengths as given) or raise.  Both refuse the shapes the plain versions
  do not take (:func:`check_shape`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from qatzip_tpu_torch.ops._build import Kernel, KernelError

KERNEL = Kernel("qz_checksum",
                [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                 ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
PLAN = Kernel("qz_checksum_plan", [ctypes.c_int] * 2 + [ctypes.c_void_p])
MAX_N = 1 << 25   # the kernel's ladder advances by up to 2^25 - 1 bytes
TAB_WORDS = 2048  # kernel_tables(): the slice-by-8 tables' words come first

_POLY = 0xEDB88320
_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=1)
def _host_tables() -> dict:
    """Constant GF(2) operators, built once on the host.

    cols_word[b]  : crc0 of the 4-byte message with only bit b set
    zadv[k][b]    : column b of the "advance by 2^k zero bytes" matrix
    """
    def adv1(c: int) -> int:
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        return c

    z1 = [adv1(1 << b) for b in range(32)]

    def mat_apply(cols, v):
        acc = 0
        for b in range(32):
            if (v >> b) & 1:
                acc ^= cols[b]
        return acc

    def mat_sq(cols):
        return [mat_apply(cols, cols[b]) for b in range(32)]

    zadv = [z1]
    for _ in range(24):  # up to 2^24-byte advances
        zadv.append(mat_sq(zadv[-1]))

    def crc0_word(w: int) -> int:
        """Raw reflected register (init 0) after one 4-byte LE word."""
        c = 0
        for i in range(4):
            c ^= (w >> (8 * i)) & 0xFF
            for _ in range(8):
                c = (c >> 1) ^ (_POLY if c & 1 else 0)
        return c

    cols_word = [crc0_word(1 << b) for b in range(32)]
    return {
        "cols_word": np.array(cols_word, np.uint32),
        "zadv": np.array([np.array(m, np.uint32) for m in zadv]),
    }


@functools.lru_cache(maxsize=None)
def _byte_tables(matrix: int, device: torch.device) -> torch.Tensor:
    """int64 [4 * 256] on ``device``: entry 256*j + x is the XOR of the
    columns 8j..8j+7 of a matrix that the bits of byte value x pick.
    ``matrix`` -1 is cols_word, k >= 0 zadv[k]."""
    t = _host_tables()
    cols = (t["cols_word"] if matrix < 0 else t["zadv"][matrix]).astype(
        np.uint64)
    bits = (np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1
    tab = np.stack([np.bitwise_xor.reduce(
        np.where(bits == 1, cols[None, 8 * j:8 * j + 8], 0), axis=1)
        for j in range(4)])
    return torch.from_numpy(tab.reshape(-1).astype(np.int64)).to(device)


def _mat_apply(matrix: int, v: torch.Tensor) -> torch.Tensor:
    """Apply a GF(2) 32x32 matrix to every element of v (int64 holding
    u32): the XOR of cols[b] for the set bits b of v, as the XOR of four
    byte-table lookups."""
    t = _byte_tables(matrix, v.device)
    return (t[v & 0xFF] ^ t[256 + ((v >> 8) & 0xFF)]
            ^ t[512 + ((v >> 16) & 0xFF)] ^ t[768 + ((v >> 24) & 0xFF)])


def crc32_blocks_ref(data: torch.Tensor, lengths: torch.Tensor,
                     n: int) -> torch.Tensor:
    """crc32 (zlib convention) of data[b, :lengths[b]] for each block.

    data: uint8[B, >=n] with n // 4 a power of two; lengths: int32[B], on
    one device.  Returns int64[B] holding the u32 CRCs, on that device."""
    B = data.shape[0]
    d = data[:, :n].to(torch.int64)
    lengths = lengths.to(torch.int64)
    pos = torch.arange(n, dtype=torch.int64, device=data.device)[None, :]

    # right-align: byte i of a block moves to position i + (n - len)
    src = pos - (n - lengths)[:, None]
    aligned = torch.where(src >= 0,
                          d.gather(1, torch.clamp(src, 0, n - 1)), 0)

    # leaf CRCs of 4-byte LE words
    w = aligned.reshape(B, n // 4, 4)
    word = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)
    c = _mat_apply(-1, word)                      # [B, n // 4]

    # combine tree: crc(left||right) = Zlen(right)(crc_left) ^ crc_right
    level = 2  # the right segment is 2^level bytes at the first fold
    while c.shape[1] > 1:
        c = _mat_apply(level, c[:, 0::2]) ^ c[:, 1::2]
        level += 1

    crc0 = c[:, 0]  # raw register with init 0 over the real bytes
    # init 0xFFFFFFFF advanced over len(data) zero bytes, xor'd in by
    # linearity, then the standard final complement
    init = torch.full((B,), _M32, dtype=torch.int64, device=data.device)
    for k in range(25):
        adv = _mat_apply(k, init)
        init = torch.where(((lengths >> k) & 1) == 1, adv, init)
    return crc0 ^ init ^ _M32


def adler32_blocks_ref(data: torch.Tensor, lengths: torch.Tensor,
                       n: int) -> torch.Tensor:
    """adler32 (zlib convention) of data[b, :lengths[b]] per block; n a
    multiple of 128.  Returns int64[B] holding the u32 values."""
    MOD = 65521
    B = data.shape[0]
    d = data[:, :n].to(torch.int64)
    pos = torch.arange(n, dtype=torch.int64, device=data.device)[None, :]
    L = lengths.to(torch.int64)[:, None]
    valid = pos < L
    dv = torch.where(valid, d, 0)

    # A = 1 + sum(d) mod m ; B = len + sum((len-i)*d_i) mod m, summed in
    # groups of 128 as the reference does (its uint32 bound)
    wts = torch.where(valid, (L - pos) % MOD, 0)
    part = (dv * wts).reshape(B, n // 128, 128).sum(dim=-1) % MOD
    sB = part.sum(dim=-1) % MOD
    sA = dv.reshape(B, n // 128, 128).sum(dim=-1) % MOD
    sA = sA.sum(dim=-1) % MOD
    A = (sA + 1) % MOD
    Bv = (sB + L[:, 0]) % MOD
    return (Bv << 16) | A


def check_shape(data: torch.Tensor, lengths: torch.Tensor, n: int,
                kind: str) -> None:
    """Raises ValueError unless data is uint8 [B, >= n] and lengths [B] on
    its device, with n as the plain versions take it: n // 4 a power of 2
    for CRC32, a multiple of 128 for Adler-32, and below MAX_N.  Lengths
    must lie in [0, n] (not checked: they stay on the device)."""
    if data.dim() != 2 or data.dtype != torch.uint8 or data.shape[1] < n:
        raise ValueError(f"{kind} takes uint8 [B, >= {n}] data, got "
                         f"{data.dtype} {tuple(data.shape)}")
    if tuple(lengths.shape) != (data.shape[0],) or (
            lengths.device != data.device):
        raise ValueError(f"{kind} takes lengths [B] on the data's device")
    if kind == "crc32" and (n < 4 or (n // 4) & (n // 4 - 1)):
        raise ValueError(f"crc32_blocks takes n // 4 a power of 2, not {n}")
    if kind == "adler32" and (n < 128 or n % 128):
        raise ValueError(f"adler32_blocks takes n a multiple of 128, not {n}")
    if n >= MAX_N:
        raise ValueError(f"the checksums take n below {MAX_N}, not {n}")


def _unstep(c: int) -> int:
    """The register before one bit step of the reflected CRC (the step is
    invertible: the polynomial's top bit says which bit left)."""
    b = c >> 31
    return (((c ^ (_POLY if b else 0)) << 1) | b) & _M32


@functools.lru_cache(maxsize=1)
def kernel_tables() -> np.ndarray:
    """uint32 [2048 + 25 * 32 + 8 * 32]: the kernel's tables
    (csrc/checksum.cuh): the slice-by-8 tables (table j holds the register
    after a byte and j zero bytes), the zero-advance matrices' columns, and
    the columns of the inverse advances over 0-7 zero bytes."""
    t0 = []
    for x in range(256):
        c = x
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        t0.append(c)
    tabs = [t0]
    for _ in range(7):
        tabs.append([(v >> 8) ^ t0[v & 0xFF] for v in tabs[-1]])
    unpad = []
    for pad in range(8):
        for b in range(32):
            c = 1 << b
            for _ in range(8 * pad):
                c = _unstep(c)
            unpad.append(c)
    return np.concatenate([np.array(tabs, np.uint32).reshape(-1),
                           _host_tables()["zadv"].reshape(-1),
                           np.array(unpad, np.uint32)]).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _kernel_tables(device: torch.device) -> torch.Tensor:
    """kernel_tables() on ``device`` as int32, built once a device."""
    return torch.from_numpy(kernel_tables().view(np.int32).copy()).to(device)


def launch_plan(rows: int, n: int) -> dict:
    """The card's launch shape for rows of up to n bytes
    (qz_checksum_plan): CTAs a row (a cluster), log2 of a thread's slice
    and of the bytes the slices span, the clusters the card holds at
    once."""
    info = (ctypes.c_int * 4)()
    PLAN(rows, n, ctypes.addressof(info))
    return dict(zip(("p", "slice_lg", "span_lg", "active_clusters"), info))


def _launch(data: torch.Tensor, lengths: torch.Tensor, n: int,
            kind: str) -> torch.Tensor:
    dev = data.device
    if dev.type != "cuda":
        raise KernelError(f"no checksum kernel for device {dev}")
    if data.stride(1) != 1:
        data = data.contiguous()
    lens = lengths
    if lens.dtype not in (torch.int32, torch.int64):
        lens = lens.to(torch.int32)
    if not lens.is_contiguous():
        lens = lens.contiguous()
    out = torch.empty(data.shape[0], dtype=torch.int64, device=dev)
    if data.shape[0]:
        KERNEL(data.data_ptr(), data.stride(0), lens.data_ptr(),
               int(lens.dtype == torch.int64), _kernel_tables(dev).data_ptr(),
               out.data_ptr(), data.shape[0], n, int(kind == "adler32"),
               torch.cuda.current_stream(dev).cuda_stream)
    return out


def crc32_blocks(data: torch.Tensor, lengths: torch.Tensor,
                 n: int) -> torch.Tensor:
    """As :func:`crc32_blocks_ref`; on a CUDA tensor, the kernel."""
    check_shape(data, lengths, n, "crc32")
    if data.device.type == "cpu":
        return crc32_blocks_ref(data, lengths, n)
    return _launch(data, lengths, n, "crc32")


def adler32_blocks(data: torch.Tensor, lengths: torch.Tensor,
                   n: int) -> torch.Tensor:
    """As :func:`adler32_blocks_ref`; on a CUDA tensor, the kernel."""
    check_shape(data, lengths, n, "adler32")
    if data.device.type == "cpu":
        return adler32_blocks_ref(data, lengths, n)
    return _launch(data, lengths, n, "adler32")
