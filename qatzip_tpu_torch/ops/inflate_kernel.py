"""Launch wrapper of the lockstep inflate kernel (``csrc/inflate.cu``).

Counterpart of qatzip_tpu/ops/pallas_inflate_kernel.py.  One launch takes
every lane of a round, a thread block a lane: its warp stages the lane's
tables in shared memory and one thread decodes; the work lives in
``csrc/inflate_step.cuh``.  The plain torch version it is held against is
``qatzip_tpu_torch.ops.inflate._decode_ref``.

``_capture`` and :func:`timed_replay` are the compute-timing hook of the
calibration (engine/devcal.py), as in the reference: with ``_capture`` a
list, ``inflate.decode_lockstep`` appends each round's arguments to it, and
``timed_replay`` runs the rounds again and times them on the device alone.
"""
from __future__ import annotations

import ctypes
import time

import torch

from qatzip_tpu_torch.ops import inflate as PI
from qatzip_tpu_torch.ops._build import Kernel, KernelError

KERNEL = Kernel("qz_inflate_decode",
                [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])


def decode(stream_words, bit0, nbits, tll, td, active, max_steps: int):
    """Same contract as ``inflate._decode_ref``; every tensor must lie on
    one CUDA device.  Returns device tensors without synchronising."""
    dev = stream_words.device
    if dev.type != "cuda":
        raise KernelError(f"inflate kernel needs CUDA tensors, got {dev}")
    B, NW = stream_words.shape
    if B < 1 or NW < 3 or max_steps < 1:
        raise KernelError("inflate kernel needs >= 1 lane, >= 3 words a lane "
                          "and max_steps >= 1")
    for t, shape in ((bit0, (B,)), (nbits, (B,)), (tll, (B, PI.CELLS)),
                     (td, (B, PI.CELLS)), (active, (B,))):
        if t.device != dev or tuple(t.shape) != shape:
            raise KernelError("inflate kernel inputs disagree in device or "
                              "shape")
    words = stream_words.to(torch.int32).contiguous()
    args = [t.to(torch.int32).contiguous()
            for t in (bit0, nbits, tll, td, active)]
    tokens = torch.zeros((max_steps, B), dtype=torch.int32, device=dev)
    err = torch.empty(B, dtype=torch.int32, device=dev)
    outcnt = torch.empty(B, dtype=torch.int32, device=dev)
    end_bit = torch.empty(B, dtype=torch.int32, device=dev)
    nsteps = torch.zeros(1, dtype=torch.int32, device=dev)
    KERNEL(words.data_ptr(), *(a.data_ptr() for a in args),
           tokens.data_ptr(), err.data_ptr(), outcnt.data_ptr(),
           end_bit.data_ptr(), nsteps.data_ptr(), B, NW, max_steps,
           torch.cuda.current_stream(dev).cuda_stream)
    return tokens, err != 0, outcnt, end_bit, nsteps


_capture: list | None = None


def timed_replay(calls, reps: int = 3) -> float:
    """Run the captured rounds again, ``reps`` passes over all of them
    after a warm pass; returns the mean seconds a pass.  CUDA events time
    the passes on a CUDA device, ``time.perf_counter`` on the CPU."""
    if not calls:
        return 0.0

    def one_pass():
        for args in calls:
            PI.decode_lockstep(*args)

    one_pass()  # warm
    dev = calls[0][0].device
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            one_pass()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(dev)
    start.record(stream)
    for _ in range(reps):
        one_pass()
    stop.record(stream)
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / 1e3 / reps
