"""Public constants of the port: a copy of qatzip_tpu/constants.py.

Mirrors the behavioral contract of the QATzip public header
(include/qatzip.h): status codes (:311-362), enums
(:179-290), defaults and limits (:573-632), extended return-code bits
(:651-664).  The values are kept numerically identical so applications
ported from QATzip keep their semantics.
"""
from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Version (reference: src/qatzip_internal.h:59, include/qatzip.h:71-83)
# ---------------------------------------------------------------------------
QATZIP_TPU_VERSION = "0.1.0"
QZ_API_VERSION = "2.5"

# ---------------------------------------------------------------------------
# Status codes (reference include/qatzip.h:311-362)
# ---------------------------------------------------------------------------
QZ_OK = 0                     # Success
QZ_DUPLICATE = 1              # Cannot process function again; no failure
QZ_FORCE_SW = 2               # Using SW: switch to software because of previous block
QZ_PARAMS = -1                # Invalid parameter in function call
QZ_FAIL = -2                  # Unspecified error
QZ_BUF_ERROR = -3             # Insufficient buffer error
QZ_DATA_ERROR = -4            # Input data was corrupted
QZ_TIMEOUT = -5               # Operation timed out
QZ_INTEG = -100               # Integrity check failed
QZ_NO_HW = 11                 # Using SW: no TPU detected
QZ_NO_MDRV = 12               # Using SW: no memory driver detected
QZ_NO_INST_ATTACH = 13        # Using SW: could not attach to an instance
QZ_LOW_MEM = 14               # Using SW: not enough device memory
QZ_LOW_DEST_MEM = 15          # Using SW: not enough device memory for dest buffer
QZ_UNSUPPORTED_FMT = 16       # Using SW: device does not support data format
QZ_NONE = 100                 # Device uninitialized
QZ_NOSW_NO_HW = -101          # Not using SW: no TPU detected
QZ_NOSW_NO_MDRV = -102        # Not using SW: no memory driver detected
QZ_NOSW_NO_INST_ATTACH = -103 # Not using SW: could not attach to instance
QZ_NOSW_LOW_MEM = -104        # Not using SW: not enough device memory
QZ_NO_SW_AVAIL = -105         # Session may require software but none available
QZ_NOSW_UNSUPPORTED_FMT = -116
QZ_POST_PROCESS_ERROR = -117  # Post-process callback reported an error
QZ_METADATA_OVERFLOW = -118   # Insufficient memory allocated for metadata
QZ_OUT_OF_RANGE = -119        # Metadata block_num out of range
QZ_NOT_SUPPORTED = -200       # Request not supported


class QzError(Exception):
    """Exception carrying a QZ_* status code (pythonic error surface)."""

    def __init__(self, status: int, msg: str = ""):
        self.status = status
        super().__init__(f"QZ status {status}: {msg}" if msg else f"QZ status {status}")


# ---------------------------------------------------------------------------
# Enums (reference include/qatzip.h:179-290)
# ---------------------------------------------------------------------------
class QzHuffmanHdr(enum.IntEnum):
    QZ_DYNAMIC_HDR = 0
    QZ_STATIC_HDR = 1


class QzDirection(enum.IntEnum):
    QZ_DIR_COMPRESS = 0
    QZ_DIR_DECOMPRESS = 1
    QZ_DIR_BOTH = 2


class QzDataFormat(enum.IntEnum):
    """Streaming/data wire formats (reference include/qatzip.h:235-253)."""

    QZ_DEFLATE_4B = 0        # raw deflate + 4-byte LE length header per block
    QZ_DEFLATE_GZIP = 1      # RFC1952 gzip member per block
    QZ_DEFLATE_GZIP_EXT = 2  # gzip + QZ extra field (chunk sizes) per block
    QZ_DEFLATE_RAW = 3       # headerless deflate streams
    QZ_FMT_NUM = 4


class DataFormatInternal(enum.IntEnum):
    """Internal format enum (reference src/qatzip_internal.h:238-253)."""

    DEFLATE_4B = 0
    DEFLATE_GZIP = 1
    DEFLATE_GZIP_EXT = 2
    DEFLATE_RAW = 3
    DEFLATE_ZLIB = 4
    LZ4_FH = 5
    LZ4S_BK = 6


class QzPollingMode(enum.IntEnum):
    QZ_PERIODICAL_POLLING = 0
    QZ_BUSY_POLLING = 1


class QzLogLevel(enum.IntEnum):
    """Reference include/qatzip.h:944-990."""

    LOG_NONE = 0
    LOG_ERROR = 1
    LOG_WARNING = 2
    LOG_INFO = 3
    LOG_DEBUG1 = 4
    LOG_DEBUG2 = 5
    LOG_DEBUG3 = 6
    LOG_TEST = 7


# Compression algorithms (reference include/qatzip.h comp_algorithm values).
QZ_DEFLATE = 8      # 'deflate' compression method id (same as gzip CM byte)
QZ_LZ4 = ord("4")
QZ_LZ4S = ord("s")
QZ_ZSTD = ord("z")  # used by qzstd pipeline (LZ4S + zstd post-processing)

QZ_MAX_ALGORITHMS = 255

# ---------------------------------------------------------------------------
# Defaults and limits (reference include/qatzip.h:573-632, src/qatzip.c:100-116)
# ---------------------------------------------------------------------------
QZ_HUFF_HDR_DEFAULT = QzHuffmanHdr.QZ_DYNAMIC_HDR
QZ_DIRECTION_DEFAULT = QzDirection.QZ_DIR_BOTH
QZ_DATA_FORMAT_DEFAULT = QzDataFormat.QZ_DEFLATE_GZIP_EXT
QZ_COMP_LEVEL_DEFAULT = 1
QZ_COMP_ALGOL_DEFAULT = QZ_DEFLATE
QZ_POLL_SLEEP_DEFAULT = 10
QZ_MAX_FORK_DEFAULT = 3
QZ_SW_BACKUP_DEFAULT = 1
QZ_HW_BUFF_SZ = 64 * 1024
QZ_HW_BUFF_MIN_SZ = 1 * 1024
QZ_HW_BUFF_MAX_SZ = 512 * 1024
QZ_STRM_BUFF_SZ_DEFAULT = QZ_HW_BUFF_SZ
QZ_STRM_BUFF_MIN_SZ = 1 * 1024
QZ_STRM_BUFF_MAX_SZ = 2 * 1024 * 1024 - 5 * 1024
QZ_COMP_THRESHOLD_DEFAULT = 1024
QZ_COMP_THRESHOLD_MINIMUM = 128
QZ_REQ_THRESHOLD_MINIMUM = 1
QZ_REQ_THRESHOLD_MAXIMUM = 32       # NUM_BUFF (reference src/qatzip_internal.h:65)
QZ_REQ_THRESHOLD_DEFAULT = QZ_REQ_THRESHOLD_MAXIMUM
QZ_WAIT_CNT_THRESHOLD_DEFAULT = 8
QZ_DEFLATE_COMP_LVL_MINIMUM = 1
QZ_DEFLATE_COMP_LVL_MAXIMUM = 9
QZ_LZS_COMP_LVL_MINIMUM = 1
QZ_LZS_COMP_LVL_MAXIMUM = 12
QZ_AUTO_SELECT_NUMA_NODE = -1
QZ_LZ4S_MINI_MATCH_DEFAULT = 3

# Empty-file compressed size (gzipext header 24B + empty deflate 2B + footer 8B;
# reference include/qatzip.h:2044).
QZ_COMPRESSED_SZ_OF_EMPTY_FILE = 34

# SW compressed-size bound: DEST_SZ(n) = 9n/8 + QZ_SKID_PAD_SZ
# (reference src/qatzip_internal.h:99).
QZ_SKID_PAD_SZ = 1024


def qz_dest_sz(src_sz: int) -> int:
    """Per-chunk compressed-payload bound (reference src/qatzip_internal.h:99)."""
    return (9 * src_sz) // 8 + QZ_SKID_PAD_SZ


# sw_backup bit field (reference include/qatzip.h:617-632)
QZ_SW_BACKUP_BIT_POSITION = 0
QZ_SW_FORCESW_BIT_POSITION = 1


def qz_sw_backup_enabled(sw_backup: int) -> bool:
    return bool(sw_backup & (1 << QZ_SW_BACKUP_BIT_POSITION))


def qz_sw_only(sw_backup: int) -> bool:
    return bool(sw_backup & (1 << QZ_SW_FORCESW_BIT_POSITION))


# Extended return-code bits (reference include/qatzip.h:651-664)
QZ_SW_EXECUTION_BIT = 4
QZ_SW_EXECUTION_MASK = 1 << QZ_SW_EXECUTION_BIT
QZ_TIMEOUT_BIT = 8
QZ_TIMEOUT_MASK = 1 << QZ_TIMEOUT_BIT
QZ_POST_PROCESS_FAIL_BIT = 10
QZ_POST_PROCESS_FAIL_MASK = 1 << QZ_POST_PROCESS_FAIL_BIT
