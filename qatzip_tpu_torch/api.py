"""Public qz-style API of the port (a copy of qatzip_tpu/api.py).

Python analog of the 54-function QATZIP_API surface
(reference include/qatzip.h:990-3098).  Functions keep the reference names
(camelCase aliases provided) and status-code semantics; buffer in/out
pointers become returned bytes + consumed counts.  ``qz_init`` takes the
engine's device (None: the first CUDA device, if any), and the
software-component list names torch and its CUDA build where the reference
names jax.
"""
from __future__ import annotations

import dataclasses

import torch

from qatzip_tpu_torch import constants as C
from qatzip_tpu_torch import memory as _mem
from qatzip_tpu_torch import session as S
from qatzip_tpu_torch.constants import QzDataFormat, QzDirection
from qatzip_tpu_torch.engine import core, framing
from qatzip_tpu_torch.engine.core import OpResult
from qatzip_tpu_torch.session import (
    InternalParams,
    QzSession,
    QzSessionParams,
    QzSessionParamsDeflate,
    QzSessionParamsDeflateExt,
    QzSessionParamsLZ4,
    QzSessionParamsLZ4S,
)
from qatzip_tpu_torch.memory import (  # noqa: F401
    qz_free,
    qz_malloc,
    qz_mem_find_addr,
)
from qatzip_tpu_torch.metadata import (  # noqa: F401
    QzMetadataBlob,
    qz_allocate_metadata,
    qz_compress_with_metadata_ext,
    qz_decompress_with_metadata_ext,
    qz_free_metadata,
    qz_metadata_block_get_crc32,
    qz_metadata_block_get_crc64,
    qz_metadata_block_read,
    qz_metadata_block_write,
)
from qatzip_tpu_torch.utils import checksum as ck
from qatzip_tpu_torch.utils.checksum import (  # noqa: F401
    Crc32Config,
    Crc64Config,
)
from qatzip_tpu_torch.utils.logging import (  # noqa: F401
    set_log_level as qz_set_log_level,
)

__all__ = [
    "QzSession", "OpResult", "QzStatus", "member_boundaries",
    "qz_init", "qz_close", "qz_teardown_session",
    "qz_setup_session", "qz_setup_session_deflate", "qz_setup_session_deflate_ext",
    "qz_setup_session_lz4", "qz_setup_session_lz4s",
    "qz_compress", "qz_compress_crc", "qz_compress_ext",
    "qz_compress_crc64", "qz_compress_crc64_ext",
    "qz_decompress", "qz_decompress_crc", "qz_decompress_ext",
    "qz_decompress_crc64", "qz_decompress_crc64_ext",
    "qz_max_compressed_length", "qz_get_status", "qz_get_defaults_deflate",
    "qz_set_defaults_deflate", "qz_get_defaults_lz4", "qz_set_defaults_lz4",
    "qz_get_defaults_lz4s", "qz_set_defaults_lz4s",
    "qz_get_defaults", "qz_set_defaults",
    "qz_get_defaults_deflate_ext", "qz_set_defaults_deflate_ext",
    "qz_get_deflate_end_of_stream", "qz_set_log_level", "qz_dump_counters",
    "qz_trace", "qz_trace_spans", "qz_trace_setup",
    "qz_get_session_crc32_config", "qz_set_session_crc32_config",
    "qz_get_session_crc64_config", "qz_set_session_crc64_config",
    "qz_get_software_component_count", "qz_get_software_component_version_list",
    "qz_malloc", "qz_free", "qz_mem_find_addr",
    "QzMetadataBlob", "qz_allocate_metadata", "qz_free_metadata",
    "qz_compress_with_metadata_ext", "qz_decompress_with_metadata_ext",
    "qz_metadata_block_read", "qz_metadata_block_write",
    "qz_metadata_block_get_crc32", "qz_metadata_block_get_crc64",
    "Crc32Config", "Crc64Config",
    "compress", "decompress",
]

# process-wide session defaults (qzGetDefaults/qzSetDefaults analogs,
# reference include/qatzip.h:2086-2140)
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
# Session setup (5 variants, reference include/qatzip.h:1100-1400)
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
    # None -> process defaults set via qz_set_defaults_deflate_ext (the
    # reference qzSetDefaults semantics: defaults feed subsequent setup)
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


def qz_compress_crc(sess: QzSession, src, last: int = 1,
                    crc_init: int = 0,
                    dest_limit: int | None = None) -> OpResult:
    cfg = getattr(sess, "crc32_config", None)
    if cfg is not None and cfg != Crc32Config():
        # custom session CRC32 config (qzSetSessionCrc32Config): the format
        # checksum stays gzip CRC-32 on the wire, but the API-returned crc
        # honors the configured polynomial/reflection (reference
        # include/qatzip.h:2722-2791)
        res = qz_compress_ext(sess, src, last=last, dest_limit=dest_limit)
        if res.rc != C.QZ_OK:
            return res
        res.crc = ck.crc32_update(bytes(src)[: res.consumed], crc_init, cfg)
        return res
    return qz_compress_ext(sess, src, last=last, dest_limit=dest_limit,
                           crc_init=crc_init)


def qz_compress_crc64_ext(sess: QzSession, src, last: int = 1,
                          crc64: int = 0,
                          dest_limit: int | None = None) -> OpResult:
    """qzCompressCrc64Ext analog: the session-configured CRC64 of the
    consumed input (continuing from ``crc64``; pass 0 to start fresh) is
    returned in ``res.crc``.  Default config is ECMA-182 Normal
    (reference include/qatzip.h:753-765)."""
    res = qz_compress_ext(sess, src, last=last, dest_limit=dest_limit)
    if res.rc != C.QZ_OK:
        return res
    cfg = getattr(sess, "crc64_config", None)
    consumed = bytes(src)[: res.consumed]
    # Always continue from the passed value: for the default (and XZ-style)
    # configs crc_continue(0) == fresh start, and a legitimately-zero running
    # CRC from a prior call is never misread as "first call".
    res.crc = ck.crc64_update(consumed, crc64, cfg)
    return res


def qz_compress_crc64(sess: QzSession, src, last: int = 1,
                      crc64: int = 0) -> OpResult:
    return qz_compress_crc64_ext(sess, src, last=last, crc64=crc64)


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


def qz_decompress_crc(sess: QzSession, src,
                      dest_limit: int | None = None) -> OpResult:
    cfg = getattr(sess, "crc32_config", None)
    if cfg is not None and cfg != Crc32Config():
        res = qz_decompress_ext(sess, src, dest_limit=dest_limit)
        if res.rc != C.QZ_OK:
            return res
        res.crc = ck.crc32_update(res.data, 0, cfg)
        return res
    return qz_decompress_ext(sess, src, dest_limit=dest_limit)


def qz_decompress_crc64_ext(sess: QzSession, src, crc64: int = 0,
                            dest_limit: int | None = None) -> OpResult:
    """qzDecompressCrc64Ext analog: session-configured CRC64 of the
    produced output returned in ``res.crc`` (continuing from ``crc64``)."""
    res = qz_decompress_ext(sess, src, dest_limit=dest_limit)
    if res.rc != C.QZ_OK:
        return res
    cfg = getattr(sess, "crc64_config", None)
    res.crc = ck.crc64_update(res.data, crc64, cfg)
    return res


def qz_decompress_crc64(sess: QzSession, src, crc64: int = 0) -> OpResult:
    return qz_decompress_crc64_ext(sess, src, crc64=crc64)


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


def qz_get_deflate_end_of_stream(sess: QzSession) -> bool:
    """qzGetDeflateEndOfStream analog (reference src/qatzip.c:2766)."""
    return bool(sess.end_of_last_block)


def qz_dump_counters() -> dict:
    """Counter dump: per-stage flow counters + HW/SW request totals (the
    qatzip_counter.c dumpAllCounters + per-thread counter analog, reference
    src/qatzip_counter.c:56-82, src/qatzip_utils.c:55-183), and the port's
    own: the device instance pool's ``stats()`` and grab wait
    (``pool_<key>``), the streams and LZ4 blocks failed over to the CPU, the
    LZ4 blocks handed to the block decoder and the stored ones copied
    through (``lz4_blocks_device``, ``lz4_blocks_stored``), the device
    failures the health breaker saw, the spans dropped past the buffer and
    each kernel's launches (``launches.<symbol>``).  Every value is a
    count."""
    from qatzip_tpu_torch.engine.health import health
    from qatzip_tpu_torch.engine.instances import pool
    from qatzip_tpu_torch.ops import _build, deflate_decode, lz4_decode

    eng = core.engine()
    out = core.flow.dump()
    out["hw_requests"] = eng.hw_requests
    out["sw_requests"] = eng.sw_requests
    out.update({f"pool_{k}": v for k, v in pool.stats().items()})
    out["pool_grab_wait_ns"] = pool.grab_wait_ns
    out["failover_lanes"] = deflate_decode.failover_lanes
    out["failover_blocks"] = lz4_decode.failover_blocks
    out["lz4_blocks_device"] = lz4_decode.device_blocks
    out["lz4_blocks_stored"] = lz4_decode.stored_blocks
    out["health_failures"] = health.total_failures
    out["spans_dropped"] = core.flow.spans_dropped
    for k in _build.kernels():
        out["launches." + k.symbol] = out.get("launches." + k.symbol,
                                              0) + k.launches
    return out


# ---------------------------------------------------------------------------
# Tracing (engine/flow.py)
# ---------------------------------------------------------------------------
def qz_trace(on: bool) -> None:
    """Trace every request (``on``), or only those that run while
    ``torch.profiler`` records (the default)."""
    core.flow.tracing = bool(on)


def qz_trace_spans(clear: bool = False) -> list[dict]:
    """The spans of the traced requests kept so far, in the order their
    requests ended, each a dict: ``name``; ``request`` (its request's id);
    ``index`` (in its request) and ``parent`` (its parent's index, -1 for
    the request's root); ``thread``; ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``; ``cpu_ns``, the thread's CPU time between
    them; ``value``; ``launches``, of the port's kernels inside it; and
    ``failover_lanes``, the streams its inflate batches, or the blocks
    its LZ4 batches, failed over.  ``clear`` empties the buffer."""
    with core.flow._lock:
        spans = list(core.flow.spans)
        if clear:
            core.flow.spans = []
    return [sp.as_dict() for sp in spans]


def qz_trace_setup() -> list[dict]:
    """The set-up phases of this process so far, in the order they ended:
    ``name`` (``setup.import``, ``setup.native``, ``setup.engine``,
    ``setup.kernels``, ``setup.first_launch``), ``thread``, ``start_ns``,
    ``end_ns``, ``cpu_ns`` and ``value``."""
    keys = ("name", "thread", "start_ns", "end_ns", "cpu_ns", "value")
    with core.flow._lock:
        phases = list(core.flow.setup)
    return [{k: getattr(sp, k) for k in keys} for sp in phases]


# ---------------------------------------------------------------------------
# Defaults get/set
# ---------------------------------------------------------------------------
def qz_get_defaults_deflate() -> QzSessionParamsDeflate:
    return dataclasses.replace(_defaults_deflate)


def qz_set_defaults_deflate(params: QzSessionParamsDeflate) -> int:
    global _defaults_deflate
    if not S.validate_params_deflate(params):
        return C.QZ_PARAMS
    _defaults_deflate = dataclasses.replace(params)
    return C.QZ_OK


def qz_get_defaults_lz4() -> QzSessionParamsLZ4:
    return dataclasses.replace(_defaults_lz4)


def qz_set_defaults_lz4(params: QzSessionParamsLZ4) -> int:
    global _defaults_lz4
    if not S.validate_params_lz4(params):
        return C.QZ_PARAMS
    _defaults_lz4 = dataclasses.replace(params)
    return C.QZ_OK


def qz_get_defaults_lz4s() -> QzSessionParamsLZ4S:
    return dataclasses.replace(_defaults_lz4s)


def qz_set_defaults_lz4s(params: QzSessionParamsLZ4S) -> int:
    global _defaults_lz4s
    if not S.validate_params_lz4s(params):
        return C.QZ_PARAMS
    _defaults_lz4s = dataclasses.replace(params)
    return C.QZ_OK


# ---------------------------------------------------------------------------
# Session CRC configuration (reference include/qatzip.h:2722-2861)
# ---------------------------------------------------------------------------
def qz_set_session_crc32_config(sess: QzSession, config: Crc32Config) -> int:
    """qzSetSessionCrc32Config analog; requires a set-up session."""
    if not isinstance(sess, QzSession) or not isinstance(config, Crc32Config):
        return C.QZ_PARAMS
    if sess.params is None:
        return C.QZ_FAIL
    sess.crc32_config = dataclasses.replace(config)
    return C.QZ_OK


def qz_get_session_crc32_config(sess: QzSession):
    """qzGetSessionCrc32Config analog: (rc, config)."""
    if not isinstance(sess, QzSession):
        return C.QZ_PARAMS, None
    if sess.params is None:
        return C.QZ_FAIL, None
    cfg = getattr(sess, "crc32_config", None) or Crc32Config()
    return C.QZ_OK, dataclasses.replace(cfg)


def qz_set_session_crc64_config(sess: QzSession, config: Crc64Config) -> int:
    """qzSetSessionCrc64Config analog; requires a set-up session."""
    if not isinstance(sess, QzSession) or not isinstance(config, Crc64Config):
        return C.QZ_PARAMS
    if sess.params is None:
        return C.QZ_FAIL
    sess.crc64_config = dataclasses.replace(config)
    return C.QZ_OK


def qz_get_session_crc64_config(sess: QzSession):
    """qzGetSessionCrc64Config analog: (rc, config).  Sessions default to
    ECMA-182 Normal on creation (reference include/qatzip.h:750-765)."""
    if not isinstance(sess, QzSession):
        return C.QZ_PARAMS, None
    if sess.params is None:
        return C.QZ_FAIL, None
    cfg = getattr(sess, "crc64_config", None) or Crc64Config()
    return C.QZ_OK, dataclasses.replace(cfg)


# ---------------------------------------------------------------------------
# Generic (legacy) defaults + DeflateExt defaults
# ---------------------------------------------------------------------------
def qz_get_defaults() -> QzSessionParams:
    """qzGetDefaults analog (legacy unified-params struct)."""
    d = _defaults_deflate
    return QzSessionParams(
        comp_lvl=d.common_params.comp_lvl,
        sw_backup=d.common_params.sw_backup,
        hw_buff_sz=d.common_params.hw_buff_sz,
        strm_buff_sz=d.common_params.strm_buff_sz,
        input_sz_thrshold=d.common_params.input_sz_thrshold,
        req_cnt_thrshold=d.common_params.req_cnt_thrshold,
        wait_cnt_thrshold=d.common_params.wait_cnt_thrshold,
        max_forks=d.common_params.max_forks,
        direction=d.common_params.direction,
        comp_algorithm=d.common_params.comp_algorithm,
        huffman_hdr=d.huffman_hdr, data_fmt=d.data_fmt)


def qz_set_defaults(params: QzSessionParams) -> int:
    """qzSetDefaults analog: folds the legacy struct into the deflate
    defaults (the reference's unified struct predates per-algo params)."""
    global _defaults_deflate
    p = QzSessionParamsDeflate(
        common_params=S.QzSessionParamsCommon(
            direction=params.direction, comp_lvl=params.comp_lvl,
            comp_algorithm=params.comp_algorithm, max_forks=params.max_forks,
            sw_backup=params.sw_backup, hw_buff_sz=params.hw_buff_sz,
            strm_buff_sz=params.strm_buff_sz,
            input_sz_thrshold=params.input_sz_thrshold,
            req_cnt_thrshold=params.req_cnt_thrshold,
            wait_cnt_thrshold=params.wait_cnt_thrshold),
        huffman_hdr=params.huffman_hdr, data_fmt=params.data_fmt)
    if not S.validate_params_deflate(p):
        return C.QZ_PARAMS
    _defaults_deflate = p
    return C.QZ_OK


def qz_get_defaults_deflate_ext() -> QzSessionParamsDeflateExt:
    return dataclasses.replace(_defaults_deflate_ext)


def qz_set_defaults_deflate_ext(params: QzSessionParamsDeflateExt) -> int:
    global _defaults_deflate_ext
    if not S.validate_params_deflate(params.deflate_params):
        return C.QZ_PARAMS
    _defaults_deflate_ext = dataclasses.replace(params)
    return C.QZ_OK


# ---------------------------------------------------------------------------
# Software component introspection (reference include/qatzip.h:2629-2678;
# the reference stubs these to QZ_FAIL on Linux — implemented for real here)
# ---------------------------------------------------------------------------
def _software_components() -> list[tuple[str, str]]:
    import zlib as _zlib

    comps = [("qatzip_tpu_torch", C.QATZIP_TPU_VERSION),
             ("zlib", getattr(_zlib, "ZLIB_RUNTIME_VERSION", _zlib.ZLIB_VERSION))]
    try:
        import xxhash as _xx
        comps.append(("xxhash", _xx.VERSION))
    except Exception:  # pragma: no cover
        pass
    comps.append(("torch", torch.__version__))
    if torch.version.cuda:
        comps.append(("cuda", torch.version.cuda))
    try:
        import numpy as _np
        comps.append(("numpy", _np.__version__))
    except Exception:  # pragma: no cover
        pass
    try:
        from qatzip_tpu_torch.native import qzcore as _n  # noqa: F401
        comps.append(("qzcore", "native"))
    except Exception:
        pass
    return comps


def qz_get_software_component_count() -> tuple[int, int]:
    """qzGetSoftwareComponentCount analog: (rc, num_elem)."""
    return C.QZ_OK, len(_software_components())


def qz_get_software_component_version_list() -> tuple[int, list[tuple[str, str]]]:
    """qzGetSoftwareComponentVersionList analog: (rc, [(name, version)])."""
    return C.QZ_OK, _software_components()


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


def member_boundaries(data, algorithm: str = "deflate",
                      fmt: QzDataFormat | None = None,
                      hw_buff_sz: int = C.QZ_HW_BUFF_SZ) -> list[tuple[int, int]]:
    """Byte spans [start, end) of each framed member in a chunked stream.

    The framing walk is the checkHeader analog (reference
    src/qatzip_utils.c:1232-1345); members whose boundary is only
    discoverable by inflating (raw deflate, foreign gzip) terminate the
    walk with one final span covering the rest.  Used by the distributed
    engine to scatter members across processes (parallel/dist_engine.py)
    and by random-access readers."""
    sess = _session_for(algorithm, fmt, 1, hw_buff_sz, sw_only=True)
    buf = memoryview(bytes(data))
    out: list[tuple[int, int]] = []
    pos = 0
    while pos < len(buf):
        m = core._parse_member(buf, pos, sess.params, sess)
        if m is None:
            break
        total_len = m[4]
        if m[5] or total_len < 0:  # inline member: span unknown until inflate
            out.append((pos, len(buf)))
            return out
        out.append((pos, pos + total_len))
        pos += total_len
    return out


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
qzCompressCrc = qz_compress_crc
qzCompressExt = qz_compress_ext
qzDecompress = qz_decompress
qzDecompressCrc = qz_decompress_crc
qzDecompressExt = qz_decompress_ext
qzMaxCompressedLength = qz_max_compressed_length
qzGetStatus = qz_get_status
qzSetLogLevel = qz_set_log_level
qzGetDeflateEndOfStream = qz_get_deflate_end_of_stream
qzCompressCrc64 = qz_compress_crc64
qzCompressCrc64Ext = qz_compress_crc64_ext
qzDecompressCrc64 = qz_decompress_crc64
qzDecompressCrc64Ext = qz_decompress_crc64_ext
qzGetDefaults = qz_get_defaults
qzSetDefaults = qz_set_defaults
qzGetDefaultsDeflate = qz_get_defaults_deflate
qzSetDefaultsDeflate = qz_set_defaults_deflate
qzGetDefaultsDeflateExt = qz_get_defaults_deflate_ext
qzSetDefaultsDeflateExt = qz_set_defaults_deflate_ext
qzGetDefaultsLZ4 = qz_get_defaults_lz4
qzSetDefaultsLZ4 = qz_set_defaults_lz4
qzGetDefaultsLZ4S = qz_get_defaults_lz4s
qzSetDefaultsLZ4S = qz_set_defaults_lz4s
qzSetSessionCrc32Config = qz_set_session_crc32_config
qzGetSessionCrc32Config = qz_get_session_crc32_config
qzSetSessionCrc64Config = qz_set_session_crc64_config
qzGetSessionCrc64Config = qz_get_session_crc64_config
qzGetSoftwareComponentCount = qz_get_software_component_count
qzGetSoftwareComponentVersionList = qz_get_software_component_version_list
qzMalloc = qz_malloc
qzFree = qz_free
qzMemFindAddr = qz_mem_find_addr
qzAllocateMetadata = qz_allocate_metadata
qzFreeMetadata = qz_free_metadata
qzCompressWithMetadataExt = qz_compress_with_metadata_ext
qzDecompressWithMetadataExt = qz_decompress_with_metadata_ext
qzMetadataBlockRead = qz_metadata_block_read
qzMetadataBlockWrite = qz_metadata_block_write
qzMetadataBlockGetCrc32 = qz_metadata_block_get_crc32
qzMetadataBlockGetCrc64 = qz_metadata_block_get_crc64
