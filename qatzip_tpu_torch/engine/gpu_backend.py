"""GPU backend: routes chunk batches to the port's device codecs.

Port of qatzip_tpu/engine/tpu_backend.py (the analog of the QAT ASIC plus
its instance pool).  The backend holds one explicit ``torch.device``;
kernel availability is per (format, direction) through the registry, and
anything unsupported reports False from ``supports()`` so the engine
routes it to the CPU backend.
"""
from __future__ import annotations

from typing import Sequence

import torch

from qatzip_tpu_torch.constants import QzDirection
from qatzip_tpu_torch.engine.backend import (Backend, CompressedChunk,
                                             DecompressedChunk)
from qatzip_tpu_torch.engine.instances import pool
from qatzip_tpu_torch.ops import registry
from qatzip_tpu_torch.session import InternalParams


class GpuBackend(Backend):
    name = "cuda"
    is_hw = True

    def __init__(self, device: torch.device):
        self.device = device
        self.device_kind = (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else device.type)
        self.num_devices = 1

    @classmethod
    def create(cls, device: torch.device | None = None) -> "GpuBackend | None":
        """With ``device=None``, the first CUDA device, or None when torch
        sees none.  An explicit device (``torch.device("cpu")`` runs the
        kernels' plain versions, the seam the CPU tests use) is taken as
        given."""
        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device("cuda", 0)
        pool.resize(1)
        return cls(torch.device(device))

    # -- capability gate ----------------------------------------------------
    def supports(self, params: InternalParams, direction: QzDirection) -> bool:
        return registry.supports(params, direction)

    # -- dispatch -----------------------------------------------------------
    # A saturated pool raises and the engine's failover routes that request
    # to the CPU instead of piling onto the device queue.
    GRAB_TIMEOUT_S = 10.0

    def compress_chunks(self, chunks: Sequence[bytes],
                        params: InternalParams) -> list[CompressedChunk]:
        codec = registry.get_codec(params)
        with pool.instance(timeout=self.GRAB_TIMEOUT_S) as inst:
            if inst is None:
                raise RuntimeError("device instance pool saturated")
            return codec.compress_chunks(chunks, params, self.device)

    def decompress_chunks(self, payloads: Sequence[bytes],
                          out_size_hints: Sequence[int],
                          params: InternalParams) -> list[DecompressedChunk]:
        codec = registry.get_codec(params)
        with pool.instance(timeout=self.GRAB_TIMEOUT_S) as inst:
            if inst is None:
                raise RuntimeError("device instance pool saturated")
            return codec.decompress_chunks(payloads, out_size_hints, params,
                                           self.device)
