"""Session parameter model and validation: a copy of qatzip_tpu/session.py.

Dataclass analogs of the reference per-algorithm session-parameter structs
(include/qatzip.h:461-571) with the same defaults (src/qatzip.c:100-116) and
the same validation rules (src/qatzip_utils.c:395-635).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

from qatzip_tpu_torch import constants as C
from qatzip_tpu_torch.constants import (
    DataFormatInternal,
    QzDataFormat,
    QzDirection,
    QzHuffmanHdr,
    QzPollingMode,
)

# Post-processing callback type: analog of qzLZ4SCallbackFn
# (reference include/qatzip.h:448).  Called with (external, src_bytes,
# dest_bytes) and returns the post-processed bytes or raises.
QzLZ4SCallback = Callable[[object, bytes, bytes], bytes]


@dataclasses.dataclass
class QzSessionParamsCommon:
    direction: QzDirection = C.QZ_DIRECTION_DEFAULT
    comp_lvl: int = C.QZ_COMP_LEVEL_DEFAULT
    comp_algorithm: int = C.QZ_COMP_ALGOL_DEFAULT
    max_forks: int = C.QZ_MAX_FORK_DEFAULT
    sw_backup: int = C.QZ_SW_BACKUP_DEFAULT
    hw_buff_sz: int = C.QZ_HW_BUFF_SZ
    strm_buff_sz: int = C.QZ_STRM_BUFF_SZ_DEFAULT
    input_sz_thrshold: int = C.QZ_COMP_THRESHOLD_DEFAULT
    req_cnt_thrshold: int = C.QZ_REQ_THRESHOLD_DEFAULT
    wait_cnt_thrshold: int = C.QZ_WAIT_CNT_THRESHOLD_DEFAULT
    polling_mode: QzPollingMode = QzPollingMode.QZ_PERIODICAL_POLLING
    is_sensitive_mode: int = 0  # latency-sensitive mode (LSM)


@dataclasses.dataclass
class QzSessionParamsDeflate:
    common_params: QzSessionParamsCommon = dataclasses.field(
        default_factory=QzSessionParamsCommon)
    huffman_hdr: QzHuffmanHdr = C.QZ_HUFF_HDR_DEFAULT
    data_fmt: QzDataFormat = C.QZ_DATA_FORMAT_DEFAULT


@dataclasses.dataclass
class QzSessionParamsDeflateExt:
    deflate_params: QzSessionParamsDeflate = dataclasses.field(
        default_factory=QzSessionParamsDeflate)
    stop_decompression_stream_end: int = 0
    zlib_format: int = 0


@dataclasses.dataclass
class QzSessionParamsLZ4:
    common_params: QzSessionParamsCommon = dataclasses.field(
        default_factory=QzSessionParamsCommon)


@dataclasses.dataclass
class QzSessionParamsLZ4S:
    common_params: QzSessionParamsCommon = dataclasses.field(
        default_factory=QzSessionParamsCommon)
    qzCallback: Optional[QzLZ4SCallback] = None
    qzCallback_external: object = None
    lz4s_mini_match: int = C.QZ_LZ4S_MINI_MATCH_DEFAULT


@dataclasses.dataclass
class QzSessionParams:
    """Legacy combined-parameter struct (reference include/qatzip.h:461-499)."""

    huffman_hdr: QzHuffmanHdr = C.QZ_HUFF_HDR_DEFAULT
    direction: QzDirection = C.QZ_DIRECTION_DEFAULT
    data_fmt: QzDataFormat = C.QZ_DATA_FORMAT_DEFAULT
    comp_lvl: int = C.QZ_COMP_LEVEL_DEFAULT
    comp_algorithm: int = C.QZ_COMP_ALGOL_DEFAULT
    max_forks: int = C.QZ_MAX_FORK_DEFAULT
    sw_backup: int = C.QZ_SW_BACKUP_DEFAULT
    hw_buff_sz: int = C.QZ_HW_BUFF_SZ
    strm_buff_sz: int = C.QZ_STRM_BUFF_SZ_DEFAULT
    input_sz_thrshold: int = C.QZ_COMP_THRESHOLD_DEFAULT
    req_cnt_thrshold: int = C.QZ_REQ_THRESHOLD_DEFAULT
    wait_cnt_thrshold: int = C.QZ_WAIT_CNT_THRESHOLD_DEFAULT


@dataclasses.dataclass
class InternalParams:
    """Unified internal parameter view (reference src/qatzip_internal.h:256-304)."""

    direction: QzDirection = C.QZ_DIRECTION_DEFAULT
    comp_lvl: int = C.QZ_COMP_LEVEL_DEFAULT
    comp_algorithm: int = C.QZ_COMP_ALGOL_DEFAULT
    max_forks: int = C.QZ_MAX_FORK_DEFAULT
    sw_backup: int = C.QZ_SW_BACKUP_DEFAULT
    hw_buff_sz: int = C.QZ_HW_BUFF_SZ
    strm_buff_sz: int = C.QZ_STRM_BUFF_SZ_DEFAULT
    input_sz_thrshold: int = C.QZ_COMP_THRESHOLD_DEFAULT
    req_cnt_thrshold: int = C.QZ_REQ_THRESHOLD_DEFAULT
    wait_cnt_thrshold: int = C.QZ_WAIT_CNT_THRESHOLD_DEFAULT
    polling_mode: QzPollingMode = QzPollingMode.QZ_PERIODICAL_POLLING
    is_sensitive_mode: int = 0
    data_fmt: DataFormatInternal = DataFormatInternal.DEFLATE_GZIP_EXT
    huffman_hdr: QzHuffmanHdr = C.QZ_HUFF_HDR_DEFAULT
    lz4s_mini_match: int = C.QZ_LZ4S_MINI_MATCH_DEFAULT
    qzCallback: Optional[QzLZ4SCallback] = None
    qzCallback_external: object = None
    stop_decompression_stream_end: int = 0


def _validate_common(p: QzSessionParamsCommon) -> bool:
    """Reference src/qatzip_utils.c:437-520."""
    if p.direction not in (QzDirection.QZ_DIR_COMPRESS, QzDirection.QZ_DIR_DECOMPRESS,
                           QzDirection.QZ_DIR_BOTH):
        return False
    if not (C.QZ_HW_BUFF_MIN_SZ <= p.hw_buff_sz <= C.QZ_HW_BUFF_MAX_SZ):
        return False
    if p.hw_buff_sz & (p.hw_buff_sz - 1):  # must be a power of two
        return False
    if not (C.QZ_STRM_BUFF_MIN_SZ <= p.strm_buff_sz <= C.QZ_STRM_BUFF_MAX_SZ):
        return False
    if p.input_sz_thrshold < C.QZ_COMP_THRESHOLD_MINIMUM:
        return False
    if not (C.QZ_REQ_THRESHOLD_MINIMUM <= p.req_cnt_thrshold
            <= C.QZ_REQ_THRESHOLD_MAXIMUM):
        return False
    if p.sw_backup not in (0, 1, 2, 3):
        return False
    return True


def validate_params_deflate(p: QzSessionParamsDeflate) -> bool:
    if not _validate_common(p.common_params):
        return False
    if not (C.QZ_DEFLATE_COMP_LVL_MINIMUM <= p.common_params.comp_lvl
            <= C.QZ_DEFLATE_COMP_LVL_MAXIMUM):
        return False
    if p.huffman_hdr not in (QzHuffmanHdr.QZ_DYNAMIC_HDR, QzHuffmanHdr.QZ_STATIC_HDR):
        return False
    if p.data_fmt not in (QzDataFormat.QZ_DEFLATE_4B, QzDataFormat.QZ_DEFLATE_GZIP,
                          QzDataFormat.QZ_DEFLATE_GZIP_EXT, QzDataFormat.QZ_DEFLATE_RAW):
        return False
    return True


def validate_params_lz4(p: QzSessionParamsLZ4) -> bool:
    if not _validate_common(p.common_params):
        return False
    return (C.QZ_LZS_COMP_LVL_MINIMUM <= p.common_params.comp_lvl
            <= C.QZ_LZS_COMP_LVL_MAXIMUM)


def validate_params_lz4s(p: QzSessionParamsLZ4S) -> bool:
    if not _validate_common(p.common_params):
        return False
    if not (C.QZ_LZS_COMP_LVL_MINIMUM <= p.common_params.comp_lvl
            <= C.QZ_LZS_COMP_LVL_MAXIMUM):
        return False
    return 3 <= p.lz4s_mini_match <= 4  # reference src/qatzip_utils.c:628-631


def _common_to_internal(c: QzSessionParamsCommon, ip: InternalParams) -> None:
    for f in ("direction", "comp_lvl", "comp_algorithm", "max_forks", "sw_backup",
              "hw_buff_sz", "strm_buff_sz", "input_sz_thrshold", "req_cnt_thrshold",
              "wait_cnt_thrshold", "polling_mode", "is_sensitive_mode"):
        setattr(ip, f, getattr(c, f))


def deflate_to_internal(p: QzSessionParamsDeflate,
                        zlib_format: bool = False,
                        stop_at_stream_end: int = 0) -> InternalParams:
    ip = InternalParams()
    _common_to_internal(p.common_params, ip)
    ip.comp_algorithm = C.QZ_DEFLATE
    ip.huffman_hdr = p.huffman_hdr
    ip.data_fmt = (DataFormatInternal.DEFLATE_ZLIB if zlib_format
                   else DataFormatInternal(int(p.data_fmt)))
    ip.stop_decompression_stream_end = stop_at_stream_end
    return ip


def lz4_to_internal(p: QzSessionParamsLZ4) -> InternalParams:
    ip = InternalParams()
    _common_to_internal(p.common_params, ip)
    ip.comp_algorithm = C.QZ_LZ4
    ip.data_fmt = DataFormatInternal.LZ4_FH
    return ip


def lz4s_to_internal(p: QzSessionParamsLZ4S) -> InternalParams:
    ip = InternalParams()
    _common_to_internal(p.common_params, ip)
    ip.comp_algorithm = C.QZ_LZ4S
    ip.data_fmt = DataFormatInternal.LZ4S_BK
    ip.lz4s_mini_match = p.lz4s_mini_match
    ip.qzCallback = p.qzCallback
    ip.qzCallback_external = p.qzCallback_external
    return ip


def legacy_to_internal(p: QzSessionParams) -> InternalParams:
    ip = InternalParams()
    for f in ("direction", "comp_lvl", "comp_algorithm", "max_forks", "sw_backup",
              "hw_buff_sz", "strm_buff_sz", "input_sz_thrshold", "req_cnt_thrshold",
              "wait_cnt_thrshold"):
        setattr(ip, f, getattr(p, f))
    ip.huffman_hdr = p.huffman_hdr
    ip.data_fmt = DataFormatInternal(int(p.data_fmt))
    return ip


class LatencyMetrix:
    """EWMA-style ring of recent request latencies (reference
    src/qatzip_internal.h:309-316, src/qatzip_utils.c:1556-1612)."""

    SIZE = 8

    def __init__(self):
        self._lock = threading.Lock()
        self.samples = [0.0] * self.SIZE
        self.idx = 0
        self.filled = 0

    def update(self, value: float) -> None:
        # async mode runs several executors against one session; the ring
        # index must not be corrupted by concurrent updates
        with self._lock:
            self.samples[self.idx] = value
            self.idx = (self.idx + 1) % self.SIZE
            self.filled = min(self.filled + 1, self.SIZE)

    def average(self) -> float:
        with self._lock:
            if not self.filled:
                return 0.0
            return sum(self.samples[: self.filled]) / self.filled


class QzSession:
    """Opaque session object (analog of QzSession_T + QzSess_T internals;
    reference include/qatzip.h:676-697, src/qatzip_internal.h:359-405)."""

    def __init__(self):
        self.hw_session_stat = C.QZ_NONE
        self.thd_sess_stat = C.QZ_OK
        self.stats_lock = threading.Lock()  # guards total_in/total_out
        self.total_in = 0
        self.total_out = 0
        self.params: InternalParams | None = None
        self.force_sw = False          # sticky QZ_FORCE_SW mode
        self.inst_hint = -1
        self.end_of_last_block = False
        # LSM latency matrices: device round-trip / post-process / software time
        self.rrt = LatencyMetrix()
        self.ppt = LatencyMetrix()
        self.swt = LatencyMetrix()
        # streaming state
        self.stream_state = None
        # async mode control block
        self.async_ctrl = None
        # most recent per-call bookkeeping
        self.last_ext_rc = 0
        # session CRC configuration (qzSet/GetSessionCrc32/64Config;
        # defaults: gzip CRC-32 and ECMA-182-normal CRC-64)
        self.crc32_config = None
        self.crc64_config = None
