"""qatzip_tpu_torch: the PyTorch/CUDA port of qatzip-tpu.

A second package beside ``qatzip_tpu`` (the JAX reference, which it is
tested against).  It runs the DEFLATE device path — the hybrid compressor
(device match finder + native entropy coder) and the lockstep inflate
(device entropy decode + native window copies) — and the LZ4/LZ4s device
path — the same match finder with native LZ4 emission, and a device block
decoder — on an NVIDIA GPU through hand-written CUDA kernels (``csrc/``)
and plain torch, behind the reference's whole qz* API: one-shot, CRC and
CRC64 variants, streaming (``stream``), async (``async_api``), the
metadata block index (``metadata``) and the qzip/qzstd/7z command lines
(``cli``).  It imports nothing of ``qatzip_tpu``: the host layers it
shares with the reference (constants, sessions, wire formats, the native
C++ codec, the CPU backend) are its own copies, and its native codec builds
under ``build/qatzip_tpu_torch/``.  Importing it never loads jax.

Its import is the ``setup.import`` phase of the set-up record
(``qz_trace_setup``; engine/flow.py).
"""
import time as _time

_since = (_time.perf_counter_ns(), _time.thread_time_ns())

from qatzip_tpu_torch.constants import *  # noqa: E402,F401,F403
from qatzip_tpu_torch.session import (  # noqa: E402,F401
    QzSession,
    QzSessionParams,
    QzSessionParamsCommon,
    QzSessionParamsDeflate,
    QzSessionParamsDeflateExt,
    QzSessionParamsLZ4,
    QzSessionParamsLZ4S,
)
from qatzip_tpu_torch.api import *  # noqa: E402,F401,F403
from qatzip_tpu_torch.engine.flow import flow as _flow  # noqa: E402

__version__ = "0.1.0"
_flow.record_setup("setup.import", _since)
del _flow, _since, _time
