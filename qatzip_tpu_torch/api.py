"""Public qz-style API of the port.

Port of the entry points of qatzip_tpu/api.py that the DEFLATE and LZ4/LZ4s
device paths use: init and session setup, one-shot compress and
decompress, status, and the ``compress``/``decompress`` helpers.  Names,
arguments and status codes are the reference's; the sessions, parameters
and result types are the port's copies of the reference's classes, and the
entry points that do not touch the engine (``qz_close``,
``qz_teardown_session``, ``qz_max_compressed_length``) and ``QzStatus`` are
copies of the reference's.  The remaining qz* functions (CRC variants,
defaults, metadata, streaming) are not ported yet (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import dataclasses

import torch

from qatzip_tpu_torch import constants as C
from qatzip_tpu_torch import memory as _mem
from qatzip_tpu_torch import session as S
from qatzip_tpu_torch.constants import QzDataFormat, QzDirection
from qatzip_tpu_torch.engine import framing
from qatzip_tpu_torch.session import (
    InternalParams,
    QzSession,
    QzSessionParams,
    QzSessionParamsDeflate,
    QzSessionParamsDeflateExt,
    QzSessionParamsLZ4,
    QzSessionParamsLZ4S,
)
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.engine.core import OpResult

__all__ = [
    "QzSession", "OpResult", "QzStatus",
    "qz_init", "qz_close", "qz_teardown_session",
    "qz_setup_session", "qz_setup_session_deflate",
    "qz_setup_session_deflate_ext", "qz_setup_session_lz4",
    "qz_setup_session_lz4s",
    "qz_compress", "qz_compress_ext", "qz_decompress", "qz_decompress_ext",
    "qz_max_compressed_length", "qz_get_status",
    "compress", "decompress",
]

_defaults_deflate = QzSessionParamsDeflate()
_defaults_deflate_ext = QzSessionParamsDeflateExt()
_defaults_lz4 = QzSessionParamsLZ4()
_defaults_lz4s = QzSessionParamsLZ4S()


# ---------------------------------------------------------------------------
# Init / teardown
# ---------------------------------------------------------------------------
def qz_init(sess: QzSession, sw_backup: int = C.QZ_SW_BACKUP_DEFAULT,
            device: torch.device | None = None) -> int:
    """qzInit analog.  ``device`` picks the engine's device (None: the
    first CUDA device, if any)."""
    if not isinstance(sess, QzSession):
        return C.QZ_PARAMS
    if sw_backup not in (0, 1, 2, 3):
        return C.QZ_PARAMS
    rc = core.qz_init_engine(sw_backup, device)
    if rc == C.QZ_DUPLICATE:
        sess.hw_session_stat = (C.QZ_OK if core.engine().hw_present
                                else core.engine().init_status)
        return C.QZ_DUPLICATE
    sess.hw_session_stat = (C.QZ_OK if rc == C.QZ_OK else rc)
    return C.QZ_OK if rc in (C.QZ_OK, C.QZ_NO_HW) else rc


def qz_close(sess: QzSession) -> int:
    """qzClose analog: end the session, free session state."""
    if not isinstance(sess, QzSession):
        return C.QZ_PARAMS
    sess.params = None
    sess.stream_state = None
    if sess.async_ctrl is not None:
        sess.async_ctrl.shutdown()
        sess.async_ctrl = None
    sess.hw_session_stat = C.QZ_NONE
    return C.QZ_OK


def qz_teardown_session(sess: QzSession) -> int:
    return qz_close(sess)


# ---------------------------------------------------------------------------
# Session setup
# ---------------------------------------------------------------------------
def _setup(sess: QzSession, params: InternalParams) -> int:
    sess.params = params
    sess.force_sw = False
    rc = core.ensure_init(sess)
    if rc < 0:
        return rc
    return C.QZ_OK


def qz_setup_session(sess: QzSession,
                     params: QzSessionParams | None = None) -> int:
    p = params or QzSessionParams(
        huffman_hdr=_defaults_deflate.huffman_hdr,
        data_fmt=_defaults_deflate.data_fmt)
    ip = S.legacy_to_internal(p)
    if not S.validate_params_deflate(QzSessionParamsDeflate(
            common_params=S.QzSessionParamsCommon(
                direction=p.direction, comp_lvl=p.comp_lvl,
                comp_algorithm=p.comp_algorithm, max_forks=p.max_forks,
                sw_backup=p.sw_backup, hw_buff_sz=p.hw_buff_sz,
                strm_buff_sz=p.strm_buff_sz,
                input_sz_thrshold=p.input_sz_thrshold,
                req_cnt_thrshold=p.req_cnt_thrshold,
                wait_cnt_thrshold=p.wait_cnt_thrshold),
            huffman_hdr=p.huffman_hdr, data_fmt=p.data_fmt)):
        return C.QZ_PARAMS
    return _setup(sess, ip)


def qz_setup_session_deflate(sess: QzSession,
                             params: QzSessionParamsDeflate | None = None) -> int:
    p = params or _defaults_deflate
    if not S.validate_params_deflate(p):
        return C.QZ_PARAMS
    return _setup(sess, S.deflate_to_internal(p))


def qz_setup_session_deflate_ext(
        sess: QzSession, params: QzSessionParamsDeflateExt | None = None) -> int:
    p = params if params is not None else dataclasses.replace(
        _defaults_deflate_ext,
        deflate_params=dataclasses.replace(_defaults_deflate_ext.deflate_params))
    if not S.validate_params_deflate(p.deflate_params):
        return C.QZ_PARAMS
    return _setup(sess, S.deflate_to_internal(
        p.deflate_params, zlib_format=bool(p.zlib_format),
        stop_at_stream_end=p.stop_decompression_stream_end))


def qz_setup_session_lz4(sess: QzSession,
                         params: QzSessionParamsLZ4 | None = None) -> int:
    p = params or _defaults_lz4
    if not S.validate_params_lz4(p):
        return C.QZ_PARAMS
    return _setup(sess, S.lz4_to_internal(p))


def qz_setup_session_lz4s(sess: QzSession,
                          params: QzSessionParamsLZ4S | None = None) -> int:
    p = params or _defaults_lz4s
    if not S.validate_params_lz4s(p):
        return C.QZ_PARAMS
    return _setup(sess, S.lz4s_to_internal(p))


def _auto_session(sess: QzSession) -> int:
    """Transparent auto-init + default session setup
    (reference src/qatzip.c:1894-1912)."""
    if sess.params is None:
        rc = qz_setup_session_deflate(sess)
        if rc != C.QZ_OK:
            return rc
    return core.ensure_init(sess)


# ---------------------------------------------------------------------------
# One-shot compress / decompress
# ---------------------------------------------------------------------------
def qz_compress_ext(sess: QzSession, src, last: int = 1,
                    dest_limit: int | None = None,
                    crc_init: int = 0) -> OpResult:
    if not isinstance(sess, QzSession) or src is None:
        return OpResult(rc=C.QZ_PARAMS)
    rc = _auto_session(sess)
    if rc < 0:
        return OpResult(rc=rc)
    if sess.params.direction == QzDirection.QZ_DIR_DECOMPRESS:
        return OpResult(rc=C.QZ_PARAMS)
    return core.compress_ext(sess, src, last=last, dest_limit=dest_limit,
                             crc_init=crc_init)


def qz_compress(sess: QzSession, src, last: int = 1,
                dest_limit: int | None = None) -> OpResult:
    return qz_compress_ext(sess, src, last=last, dest_limit=dest_limit)


def qz_decompress_ext(sess: QzSession, src,
                      dest_limit: int | None = None) -> OpResult:
    if not isinstance(sess, QzSession) or src is None:
        return OpResult(rc=C.QZ_PARAMS)
    rc = _auto_session(sess)
    if rc < 0:
        return OpResult(rc=rc)
    if sess.params.direction == QzDirection.QZ_DIR_COMPRESS:
        return OpResult(rc=C.QZ_PARAMS)
    if len(core._as_view(src)) == 0:
        return OpResult()
    return core.decompress_ext(sess, src, dest_limit=dest_limit)


def qz_decompress(sess: QzSession, src,
                  dest_limit: int | None = None) -> OpResult:
    return qz_decompress_ext(sess, src, dest_limit=dest_limit)


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------
def qz_max_compressed_length(src_sz: int, sess: QzSession | None = None) -> int:
    """qzMaxCompressedLength analog (reference src/qatzip.c:3022-3069)."""
    if src_sz == 0:
        return C.QZ_COMPRESSED_SZ_OF_EMPTY_FILE
    if sess is None or sess.params is None:
        hw_buff_sz = C.QZ_HW_BUFF_SZ
        fmt = C.DataFormatInternal.DEFLATE_GZIP_EXT
    else:
        hw_buff_sz = sess.params.hw_buff_sz
        fmt = sess.params.data_fmt
    chunk_cnt = (src_sz + hw_buff_sz - 1) // hw_buff_sz
    bound = C.qz_dest_sz(src_sz)
    bound += chunk_cnt * (framing.header_sz(fmt) + framing.footer_sz(fmt))
    if bound >= 1 << 32:
        return 0
    return bound


@dataclasses.dataclass
class QzStatus:
    """qzGetStatus analog (reference include/qatzip.h:699-720)."""

    qat_hw_count: int = 0
    qat_service_init: bool = False
    qat_mem_drvr: int = 0
    qat_instance_attach: bool = False
    memory_alloced: int = 0
    using_huge_pages: bool = False
    hw_session_status: int = C.QZ_NONE
    algo_sw: dict = dataclasses.field(default_factory=dict)
    algo_hw: dict = dataclasses.field(default_factory=dict)
    device_kind: str = ""


def qz_get_status(sess: QzSession | None = None) -> QzStatus:
    from qatzip_tpu_torch.ops import registry

    eng = core.engine()
    st = QzStatus()
    st.memory_alloced = _mem.registered_bytes()
    st.qat_mem_drvr = _mem.registered_count()
    st.qat_hw_count = eng.num_devices
    st.qat_service_init = eng.initialized
    st.qat_instance_attach = eng.hw_present
    st.hw_session_status = (sess.hw_session_stat if sess else eng.init_status)
    st.device_kind = eng.device_kind
    st.algo_sw = {"deflate": True, "lz4": True, "lz4s": True, "zstd": True}
    hw = {}
    for name, fmt in (("deflate", C.DataFormatInternal.DEFLATE_GZIP),
                      ("lz4", C.DataFormatInternal.LZ4_FH),
                      ("lz4s", C.DataFormatInternal.LZ4S_BK)):
        ip = InternalParams()
        ip.data_fmt = fmt
        hw[name] = eng.hw_present and registry.supports(
            ip, QzDirection.QZ_DIR_COMPRESS)
    st.algo_hw = hw
    return st


# ---------------------------------------------------------------------------
# Pythonic one-shot helpers
# ---------------------------------------------------------------------------
def _session_for(algorithm: str, fmt: QzDataFormat | None, level: int,
                 hw_buff_sz: int, sw_only: bool = False,
                 mini_match: int = 3) -> QzSession:
    sess = QzSession()
    common = S.QzSessionParamsCommon(comp_lvl=level, hw_buff_sz=hw_buff_sz)
    if sw_only:
        common.sw_backup = 3
    if algorithm == "deflate":
        p = QzSessionParamsDeflate(
            common_params=common,
            data_fmt=fmt if fmt is not None else C.QZ_DATA_FORMAT_DEFAULT)
        rc = qz_setup_session_deflate(sess, p)
    elif algorithm == "zlib":
        p = QzSessionParamsDeflateExt(
            deflate_params=QzSessionParamsDeflate(common_params=common),
            zlib_format=1)
        rc = qz_setup_session_deflate_ext(sess, p)
    elif algorithm == "lz4":
        rc = qz_setup_session_lz4(sess,
                                  QzSessionParamsLZ4(common_params=common))
    elif algorithm == "lz4s":
        rc = qz_setup_session_lz4s(sess, QzSessionParamsLZ4S(
            common_params=common, lz4s_mini_match=mini_match))
    else:
        raise ValueError(f"unknown algorithm {algorithm}")
    if rc != C.QZ_OK:
        raise C.QzError(rc, "session setup failed")
    return sess


def compress(data, algorithm: str = "deflate",
             fmt: QzDataFormat | None = None, level: int = 1,
             hw_buff_sz: int = C.QZ_HW_BUFF_SZ, sw_only: bool = False) -> bytes:
    """One-shot convenience compressor."""
    sess = _session_for(algorithm, fmt, level, hw_buff_sz, sw_only)
    res = qz_compress(sess, data)
    if res.rc != C.QZ_OK:
        raise C.QzError(res.rc, "compress failed")
    return res.data


def decompress(data, algorithm: str = "deflate",
               fmt: QzDataFormat | None = None,
               hw_buff_sz: int = C.QZ_HW_BUFF_SZ, sw_only: bool = False) -> bytes:
    """One-shot convenience decompressor."""
    sess = _session_for(algorithm, fmt, 1, hw_buff_sz, sw_only)
    res = qz_decompress(sess, data)
    if res.rc != C.QZ_OK:
        raise C.QzError(res.rc, "decompress failed")
    return res.data


# camelCase aliases matching the reference API names
qzInit = qz_init
qzClose = qz_close
qzTeardownSession = qz_teardown_session
qzSetupSession = qz_setup_session
qzSetupSessionDeflate = qz_setup_session_deflate
qzSetupSessionDeflateExt = qz_setup_session_deflate_ext
qzSetupSessionLZ4 = qz_setup_session_lz4
qzSetupSessionLZ4S = qz_setup_session_lz4s
qzCompress = qz_compress
qzCompressExt = qz_compress_ext
qzDecompress = qz_decompress
qzDecompressExt = qz_decompress_ext
qzMaxCompressedLength = qz_max_compressed_length
qzGetStatus = qz_get_status
