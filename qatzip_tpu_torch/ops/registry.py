"""Capability registry: which (format, direction) pairs run on the device.

Port of qatzip_tpu/ops/registry.py (the analog of the per-instance
capability filter in qzGrabInstance).  Anything absent goes to the CPU
backend.  Unlike the reference, an error while the codecs register
propagates to the caller, and there is no compile cache to set up.
"""
from __future__ import annotations

import torch

from qatzip_tpu_torch.constants import DataFormatInternal, QzDirection
from qatzip_tpu_torch.session import InternalParams

_CODECS: dict[tuple[DataFormatInternal, str], object] = {}
_registered = False


def register(fmt: DataFormatInternal, direction: str, codec: object) -> None:
    """direction: 'compress' | 'decompress'."""
    _CODECS[(fmt, direction)] = codec


def _directions_needed(direction: QzDirection) -> list[str]:
    if direction == QzDirection.QZ_DIR_COMPRESS:
        return ["compress"]
    if direction == QzDirection.QZ_DIR_DECOMPRESS:
        return ["decompress"]
    return ["compress", "decompress"]


def supports(params: InternalParams, direction: QzDirection) -> bool:
    _ensure_registered()
    return all((params.data_fmt, d) in _CODECS
               for d in _directions_needed(direction))


class _Dispatch:
    def compress_chunks(self, chunks, p: InternalParams,
                        device: torch.device):
        return _CODECS[(p.data_fmt, "compress")].compress_chunks(
            chunks, p, device)

    def decompress_chunks(self, payloads, hints, p: InternalParams,
                          device: torch.device):
        return _CODECS[(p.data_fmt, "decompress")].decompress_chunks(
            payloads, hints, p, device)


def get_codec(params: InternalParams) -> _Dispatch:
    _ensure_registered()
    return _Dispatch()


def _ensure_registered() -> None:
    global _registered
    if _registered:
        return
    from qatzip_tpu_torch.ops import device_codecs

    device_codecs.register_all()
    _registered = True
