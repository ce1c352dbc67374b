"""7z container writer/reader of the port (a copy of
qatzip_tpu/cli/sevenz.py; reference utils/qzip_7z.c).

Archive layout mirrors the reference's output: all non-empty files are
catenated into one folder compressed as a single raw-deflate stream
(reference doCompressFile, utils/qzip_7z.c:447-737), with per-file
substream sizes and CRCs, names, mtimes, attributes, and empty-file/dir
entries in the end header.

The end-header property grammar follows the public 7z format spec
(property IDs as in reference utils/qzip.h:87-131).
"""
from __future__ import annotations

import os
import struct
import time
import zlib

# property ids (reference utils/qzip.h:87-131)
K_END = 0x00
K_HEADER = 0x01
K_MAIN_STREAMS_INFO = 0x04
K_FILES_INFO = 0x05
K_PACK_INFO = 0x06
K_UNPACK_INFO = 0x07
K_SUBSTREAMS_INFO = 0x08
K_SIZE = 0x09
K_CRC = 0x0A
K_FOLDER = 0x0B
K_CODERS_UNPACK_SIZE = 0x0C
K_NUM_UNPACK_STREAM = 0x0D
K_EMPTY_STREAM = 0x0E
K_EMPTY_FILE = 0x0F
K_NAME = 0x11
K_MTIME = 0x14
K_ATTRIBUTES = 0x15

MAGIC = b"7z\xbc\xaf\x27\x1c"
VERSION = b"\x00\x04"
CODEC_DEFLATE = b"\x04\x01\x08"
CODEC_COPY = b"\x00"

_EPOCH_AS_FILETIME = 116444736000000000  # 1970-01-01 in FILETIME ticks


def _write_number(v: int) -> bytes:
    """7z variable-length number encoding (inverse of _read_number):
    n extra little-endian bytes hold the low 8n bits; the first byte has its
    top n bits set, then a zero bit, then the (7-n)-bit high part."""
    for n in range(9):
        if n < 8 and v < (1 << (8 * n + 7 - n)):
            first = ((0xFF << (8 - n)) & 0xFF) | (v >> (8 * n))
            return bytes([first]) + (v & ((1 << (8 * n)) - 1)).to_bytes(n, "little")
    return b"\xff" + v.to_bytes(8, "little")


def _read_number(buf: memoryview, pos: int) -> tuple[int, int]:
    first = buf[pos]
    pos += 1
    mask = 0x80
    value = 0
    for i in range(8):
        if not (first & mask):
            value |= (first & (mask - 1)) << (8 * i)
            return value, pos
        value |= buf[pos] << (8 * i)
        pos += 1
        mask >>= 1
    return value, pos


def _bitfield(bits: list[bool]) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 0x80 >> (i % 8)
    return bytes(out)


def _read_bitfield(buf: memoryview, pos: int, n: int) -> tuple[list[bool], int]:
    nbytes = (n + 7) // 8
    bits = []
    for i in range(n):
        bits.append(bool(buf[pos + i // 8] & (0x80 >> (i % 8))))
    return bits, pos + nbytes


def _unix_to_filetime(t: float) -> int:
    return int(t * 10_000_000) + _EPOCH_AS_FILETIME


def _filetime_to_unix(ft: int) -> float:
    return (ft - _EPOCH_AS_FILETIME) / 10_000_000


class _Entry:
    def __init__(self, name, is_dir, data=b"", mtime=0.0, attrs=0x20):
        self.name = name
        self.is_dir = is_dir
        self.data = data
        self.mtime = mtime
        self.attrs = attrs


def _collect(paths) -> list[_Entry]:
    entries = []
    for p in paths:
        if os.path.isdir(p):
            base = os.path.dirname(os.path.abspath(p))
            for root, dirs, files in os.walk(p):
                rel_root = os.path.relpath(root, base)
                entries.append(_Entry(rel_root, True,
                                      mtime=os.path.getmtime(root),
                                      attrs=0x10))
                for f in sorted(files):
                    fp = os.path.join(root, f)
                    with open(fp, "rb") as fh:
                        entries.append(_Entry(os.path.join(rel_root, f), False,
                                              fh.read(),
                                              os.path.getmtime(fp)))
        else:
            with open(p, "rb") as fh:
                entries.append(_Entry(os.path.basename(p), False, fh.read(),
                                      os.path.getmtime(p)))
    return entries


def write_7z(out_path: str, paths, level: int = 1,
             chunk_sz: int = 64 * 1024) -> tuple[int, int]:
    """Create a 7z archive.  Returns (total_input, archive_size)."""
    entries = _collect(paths)
    content_files = [e for e in entries if not e.is_dir and e.data]
    blob = b"".join(e.data for e in content_files)

    # single raw-deflate stream for the folder (single-stream semantics the
    # 7z deflate decoder expects; multi-BFINAL members would not do)
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    packed = co.compress(blob) + co.flush()

    header = bytearray()
    header.append(K_HEADER)
    if content_files:
        header.append(K_MAIN_STREAMS_INFO)
        # PackInfo
        header.append(K_PACK_INFO)
        header += _write_number(0)            # pack pos
        header += _write_number(1)            # num pack streams
        header.append(K_SIZE)
        header += _write_number(len(packed))
        header.append(K_END)
        # UnpackInfo
        header.append(K_UNPACK_INFO)
        header.append(K_FOLDER)
        header += _write_number(1)            # num folders
        header.append(0)                      # external = 0
        header += _write_number(1)            # num coders
        header.append(len(CODEC_DEFLATE))     # flags: id size, simple coder
        header += CODEC_DEFLATE
        header.append(K_CODERS_UNPACK_SIZE)
        header += _write_number(len(blob))
        header.append(K_CRC)
        header.append(1)                      # all defined
        header += struct.pack("<I", zlib.crc32(blob) & 0xFFFFFFFF)
        header.append(K_END)
        # SubStreamsInfo
        header.append(K_SUBSTREAMS_INFO)
        header.append(K_NUM_UNPACK_STREAM)
        header += _write_number(len(content_files))
        if len(content_files) > 1:
            header.append(K_SIZE)
            for e in content_files[:-1]:
                header += _write_number(len(e.data))
            header.append(K_CRC)
            header.append(1)
            for e in content_files:
                header += struct.pack("<I", zlib.crc32(e.data) & 0xFFFFFFFF)
        header.append(K_END)
        header.append(K_END)

    # FilesInfo
    header.append(K_FILES_INFO)
    header += _write_number(len(entries))
    empty_flags = [e.is_dir or not e.data for e in entries]
    if any(empty_flags):
        bf = _bitfield(empty_flags)
        header.append(K_EMPTY_STREAM)
        header += _write_number(len(bf))
        header += bf
        empty_file_flags = [not e.is_dir for e in entries if e.is_dir or not e.data]
        if any(empty_file_flags):
            bf2 = _bitfield(empty_file_flags)
            header.append(K_EMPTY_FILE)
            header += _write_number(len(bf2))
            header += bf2
    names = bytearray()
    for e in entries:
        names += e.name.replace(os.sep, "/").encode("utf-16-le") + b"\x00\x00"
    header.append(K_NAME)
    header += _write_number(len(names) + 1)
    header.append(0)  # external = 0
    header += names
    header.append(K_MTIME)
    header += _write_number(2 + 8 * len(entries))
    header.append(1)  # all defined
    header.append(0)  # external
    for e in entries:
        header += struct.pack("<Q", _unix_to_filetime(e.mtime))
    header.append(K_ATTRIBUTES)
    header += _write_number(2 + 4 * len(entries))
    header.append(1)
    header.append(0)
    for e in entries:
        header += struct.pack("<I", e.attrs)
    header.append(K_END)
    header.append(K_END)

    next_header = bytes(header)
    nh_crc = zlib.crc32(next_header) & 0xFFFFFFFF
    start_header = struct.pack("<QQI", len(packed), len(next_header), nh_crc)
    sh_crc = zlib.crc32(start_header) & 0xFFFFFFFF

    with open(out_path, "wb") as f:
        f.write(MAGIC + VERSION + struct.pack("<I", sh_crc) + start_header)
        f.write(packed)
        f.write(next_header)
    total_in = sum(len(e.data) for e in entries)
    return total_in, 32 + len(packed) + len(next_header)


class SevenZReader:
    """Parses the archives write_7z produces plus simple single-folder
    Copy/Deflate archives from other tools."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:6] != MAGIC:
            raise ValueError("not a 7z archive")
        sh_crc, = struct.unpack_from("<I", raw, 8)
        start = raw[12:32]
        if zlib.crc32(start) & 0xFFFFFFFF != sh_crc:
            raise ValueError("7z start header CRC mismatch")
        nh_off, nh_size, nh_crc = struct.unpack("<QQI", start)
        header = raw[32 + nh_off:32 + nh_off + nh_size]
        if zlib.crc32(header) & 0xFFFFFFFF != nh_crc:
            raise ValueError("7z end header CRC mismatch")
        self._raw = raw
        self._parse_header(memoryview(header))

    def _parse_header(self, h: memoryview):
        pos = 0
        pid = h[pos]; pos += 1
        if pid != K_HEADER:
            raise ValueError("unsupported 7z header (encoded headers not supported)")
        self.pack_sizes = []
        self.coder_id = CODEC_COPY
        self.folder_unpack_size = 0
        self.folder_crc = None
        self.substream_sizes = []
        self.substream_crcs = []
        self.num_substreams = 1
        self.names = []
        self.empty_flags = []
        self.empty_file_flags = []
        self.mtimes = []
        self.attrs = []
        self.num_files = 0

        while pos < len(h):
            pid = h[pos]; pos += 1
            if pid == K_END:
                continue
            if pid == K_MAIN_STREAMS_INFO:
                pos = self._parse_streams_info(h, pos)
            elif pid == K_FILES_INFO:
                pos = self._parse_files_info(h, pos)
            else:
                raise ValueError(f"unsupported 7z property 0x{pid:02x}")

    def _parse_streams_info(self, h, pos):
        while True:
            pid = h[pos]; pos += 1
            if pid == K_END:
                return pos
            if pid == K_PACK_INFO:
                pack_pos, pos = _read_number(h, pos)
                num_pack, pos = _read_number(h, pos)
                while True:
                    sub = h[pos]; pos += 1
                    if sub == K_END:
                        break
                    if sub == K_SIZE:
                        for _ in range(num_pack):
                            sz, pos = _read_number(h, pos)
                            self.pack_sizes.append(sz)
                    elif sub == K_CRC:
                        all_def = h[pos]; pos += 1
                        if all_def:
                            pos += 4 * num_pack
                    else:
                        raise ValueError("bad PackInfo")
            elif pid == K_UNPACK_INFO:
                pid2 = h[pos]; pos += 1
                assert pid2 == K_FOLDER
                num_folders, pos = _read_number(h, pos)
                if num_folders != 1:
                    raise ValueError("only single-folder archives supported")
                external = h[pos]; pos += 1
                num_coders, pos = _read_number(h, pos)
                if num_coders != 1:
                    raise ValueError("only single-coder folders supported")
                flags = h[pos]; pos += 1
                id_size = flags & 0x0F
                self.coder_id = bytes(h[pos:pos + id_size]); pos += id_size
                if flags & 0x10:  # complex coder
                    raise ValueError("complex coders unsupported")
                if flags & 0x20:  # attributes
                    asz, pos = _read_number(h, pos)
                    pos += asz
                while True:
                    sub = h[pos]; pos += 1
                    if sub == K_END:
                        break
                    if sub == K_CODERS_UNPACK_SIZE:
                        self.folder_unpack_size, pos = _read_number(h, pos)
                    elif sub == K_CRC:
                        all_def = h[pos]; pos += 1
                        if all_def:
                            self.folder_crc, = struct.unpack_from("<I", h, pos)
                            pos += 4
                    else:
                        raise ValueError("bad UnpackInfo")
            elif pid == K_SUBSTREAMS_INFO:
                self.num_substreams = 1
                have_sizes = False
                while True:
                    sub = h[pos]; pos += 1
                    if sub == K_END:
                        break
                    if sub == K_NUM_UNPACK_STREAM:
                        self.num_substreams, pos = _read_number(h, pos)
                    elif sub == K_SIZE:
                        have_sizes = True
                        total = 0
                        for _ in range(self.num_substreams - 1):
                            sz, pos = _read_number(h, pos)
                            self.substream_sizes.append(sz)
                            total += sz
                        self.substream_sizes.append(
                            self.folder_unpack_size - total)
                    elif sub == K_CRC:
                        ndigests = self.num_substreams
                        if self.num_substreams == 1 and self.folder_crc is not None:
                            ndigests = 0
                        all_def = h[pos]; pos += 1
                        defined = [True] * ndigests
                        if not all_def:
                            defined, pos = _read_bitfield(h, pos, ndigests)
                        for d in defined:
                            if d:
                                crc, = struct.unpack_from("<I", h, pos)
                                pos += 4
                                self.substream_crcs.append(crc)
                            else:
                                self.substream_crcs.append(None)
                    else:
                        raise ValueError("bad SubStreamsInfo")
                if not have_sizes:
                    self.substream_sizes = [self.folder_unpack_size]
            else:
                raise ValueError(f"unsupported StreamsInfo prop 0x{pid:02x}")

    def _parse_files_info(self, h, pos):
        self.num_files, pos = _read_number(h, pos)
        self.empty_flags = [False] * self.num_files
        while True:
            pid = h[pos]; pos += 1
            if pid == K_END:
                return pos
            size, pos = _read_number(h, pos)
            end = pos + size
            if pid == K_EMPTY_STREAM:
                self.empty_flags, pos = _read_bitfield(h, pos, self.num_files)
            elif pid == K_EMPTY_FILE:
                n_empty = sum(self.empty_flags)
                self.empty_file_flags, pos = _read_bitfield(h, pos, n_empty)
            elif pid == K_NAME:
                external = h[pos]; pos += 1
                data = bytes(h[pos:end])
                # split on UTF-16 code-unit boundaries (byte-split misaligns)
                units = struct.unpack(f"<{len(data) // 2}H", data[:len(data) & ~1])
                cur = []
                for u in units:
                    if u == 0:
                        self.names.append("".join(map(chr, cur)))
                        cur = []
                    else:
                        cur.append(u)
                self.names = self.names[:self.num_files]
            elif pid == K_MTIME:
                all_def = h[pos]; pos += 1
                external = h[pos]; pos += 1
                for i in range(self.num_files):
                    ft, = struct.unpack_from("<Q", h, pos)
                    pos += 8
                    self.mtimes.append(_filetime_to_unix(ft))
            elif pid == K_ATTRIBUTES:
                all_def = h[pos]; pos += 1
                external = h[pos]; pos += 1
                for i in range(self.num_files):
                    a, = struct.unpack_from("<I", h, pos)
                    pos += 4
                    self.attrs.append(a)
            pos = end

    def extract_all(self, dest_dir: str) -> tuple[int, int]:
        """Extract to dest_dir.  Returns (archive_size, total_output)."""
        packed_total = sum(self.pack_sizes)
        body = self._raw[32:32 + packed_total]
        if self.coder_id == CODEC_DEFLATE:
            blob = zlib.decompressobj(-15).decompress(body)
        elif self.coder_id == CODEC_COPY:
            blob = bytes(body)
        else:
            raise ValueError(f"unsupported coder {self.coder_id.hex()}")
        if self.folder_crc is not None:
            if zlib.crc32(blob) & 0xFFFFFFFF != self.folder_crc:
                raise ValueError("folder CRC mismatch")

        sizes = self.substream_sizes or [len(blob)]
        offset = 0
        content_idx = 0
        empty_iter = iter(self.empty_file_flags)
        total_out = 0
        for i in range(self.num_files):
            name = self.names[i] if i < len(self.names) else f"file{i}"
            safe = os.path.normpath(name).lstrip("/").replace("..", "_")
            target = os.path.join(dest_dir, safe)
            if self.empty_flags[i]:
                is_empty_file = next(empty_iter, False)
                if is_empty_file:
                    os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
                    open(target, "wb").close()
                else:
                    os.makedirs(target, exist_ok=True)
                continue
            sz = sizes[content_idx]
            data = blob[offset:offset + sz]
            if (content_idx < len(self.substream_crcs)
                    and self.substream_crcs[content_idx] is not None):
                if zlib.crc32(data) & 0xFFFFFFFF != self.substream_crcs[content_idx]:
                    raise ValueError(f"substream CRC mismatch for {name}")
            offset += sz
            content_idx += 1
            os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
            with open(target, "wb") as f:
                f.write(data)
            total_out += sz
            if i < len(self.mtimes):
                try:
                    os.utime(target, (self.mtimes[i], self.mtimes[i]))
                except OSError:
                    pass
        return len(self._raw), total_out


def compress_7z(paths, out_path, args) -> tuple[int, int]:
    return write_7z(out_path, paths, level=args.level, chunk_sz=args.chunk_sz)


def decompress_7z(path, dest_dir) -> tuple[int, int]:
    return SevenZReader(path).extract_all(dest_dir)
