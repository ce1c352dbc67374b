"""Launch wrapper of the LZ4 / LZ4s block-decode kernel
(``csrc/lz4_block.cu``).

Counterpart of the XLA decoder qatzip_tpu/ops/lz4_decode.py:42
(``_decode_blocks_impl``).  One launch takes every block of a call, a CTA
a block: a parse warp walks the block's sequence headers from the input
staged in shared memory and queues them, a copy warp copies literals and
matches through a 64 KB match window in shared memory; the work lives in
``csrc/lz4_block.cuh``.  The plain torch version it is held against is
``qatzip_tpu_torch.ops.lz4_decode._decode_blocks_impl``.
"""
from __future__ import annotations

import ctypes

import torch

from qatzip_tpu_torch.ops._build import Kernel, KernelError, library

KERNEL = Kernel("qz_lz4_decode",
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])


def decode(b: torch.Tensor, blk_len: torch.Tensor, n: int, outcap: int,
           lz4s: bool, base: int):
    """Same contract as ``lz4_decode._decode_blocks_impl``: b uint8[B, n]
    zero-padded blocks (n a multiple of 16, as decode_blocks's powers of 2
    are), blk_len int32[B] (each in [0, n]; a row outside it is flagged)
    on one CUDA device.  Returns (out uint8[B, outcap], tot
    int32[B], err bool[B]) on the device without synchronising; err is the
    plain version's on every row, and tot and out[:tot] on the rows whose
    err is clear.  out is not zero-filled: its bytes at and past tot, and
    all of a row in error, are unspecified."""
    dev = b.device
    if dev.type != "cuda":
        raise KernelError(f"LZ4 decode kernel needs CUDA tensors, got {dev}")
    if b.dim() != 2 or b.dtype != torch.uint8 or tuple(b.shape)[1] != n:
        raise KernelError(f"LZ4 decode kernel needs uint8 [B, {n}] blocks, "
                          f"got {b.dtype} {tuple(b.shape)}")
    B = b.shape[0]
    if B < 1 or n < 1 or outcap < 1 or base < 0:
        raise KernelError("LZ4 decode kernel needs >= 1 block, n >= 1, "
                          "outcap >= 1 and base >= 0")
    if blk_len.device != dev or tuple(blk_len.shape) != (B,):
        raise KernelError("LZ4 decode kernel inputs disagree in device or "
                          "shape")
    blocks = b.contiguous()
    if n % 16 or blocks.data_ptr() % 16:
        raise KernelError("LZ4 decode kernel stages rows 16 bytes a copy: "
                          "it needs n % 16 == 0 and 16-byte aligned blocks")
    lens = blk_len.to(torch.int32).contiguous()
    out = torch.empty((B, outcap), dtype=torch.uint8, device=dev)
    tot = torch.empty(B, dtype=torch.int32, device=dev)
    err = torch.empty(B, dtype=torch.bool, device=dev)
    KERNEL(blocks.data_ptr(), lens.data_ptr(), out.data_ptr(),
           tot.data_ptr(), err.data_ptr(), B, n, outcap, int(lz4s), base,
           torch.cuda.current_stream(dev).cuda_stream)
    return out, tot, err


def launch_info() -> dict:
    """The kernel's launch shape and how many of its CTAs the current card
    holds at once (by its shared memory), from the CUDA runtime."""
    info = (ctypes.c_int * 4)()
    rc = library().qz_lz4_info(info)
    if rc != 0:
        msg = library().qz_cuda_error_string(rc).decode()
        raise KernelError(f"qz_lz4_info: CUDA error {rc} ({msg})")
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm", "sms"), info))
