"""Stateful streaming API of the port (a copy of qatzip_tpu/stream.py;
reference src/qatzip_stream.c).

Piecemeal interface on top of the one-shot engine: input accumulates into a
strm_buff_sz bounce buffer; when full (or on last) the buffer is compressed
through the session funnel and the output drained from pending_out —
mirroring qzCompressStream/qzDecompressStream/qzEndStream
(reference src/qatzip_stream.c:403-781).

Compression is restricted to the deflate formats the reference's stream path
supports (gzip/gzipext/raw — src/qatzip_stream.c:478-484).
"""
from __future__ import annotations

from qatzip_tpu_torch import constants as C
from qatzip_tpu_torch.constants import DataFormatInternal, QzDirection
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.session import QzSession

_STREAM_COMP_FMTS = (DataFormatInternal.DEFLATE_GZIP,
                     DataFormatInternal.DEFLATE_GZIP_EXT,
                     DataFormatInternal.DEFLATE_RAW,
                     DataFormatInternal.DEFLATE_4B,
                     DataFormatInternal.DEFLATE_ZLIB)


class QzStream:
    """Analog of QzStream_T (reference include/qatzip.h:2358-2406)."""

    def __init__(self):
        self.in_buf = bytearray()
        self.pending_out = bytearray()
        self.comp_in = bytearray()   # decompress-side accumulation
        self.crc_32 = 0
        self.in_sz = 0               # total input consumed
        self.out_sz = 0              # total output produced
        self.pending_in = 0
        self.ended = False
        # incremental decompress carry: mid-member inflate state so piecemeal
        # feeding stays O(n) (the reference drains incrementally,
        # src/qatzip_stream.c:599-749)
        self._dobj = None
        self._any_member = False
        self._lz4 = None             # LZ4-frame walk state (dict)

    @property
    def pending_out_sz(self) -> int:
        return len(self.pending_out)


def _drain(strm: QzStream, max_out: int | None) -> bytes:
    if max_out is None:
        out = bytes(strm.pending_out)
        strm.pending_out.clear()
    else:
        out = bytes(strm.pending_out[:max_out])
        del strm.pending_out[:max_out]
    strm.out_sz += len(out)
    return out


def qz_compress_stream(sess: QzSession, strm: QzStream, data=b"",
                       last: int = 0, max_out: int | None = None):
    """Returns (rc, produced_bytes).  Accumulates until the stream buffer is
    full or ``last`` is set, then pushes a compressed member to pending_out."""
    if not isinstance(sess, QzSession) or not isinstance(strm, QzStream):
        return C.QZ_PARAMS, b""
    if strm.ended:
        return C.QZ_FAIL, b""
    from qatzip_tpu_torch.api import _auto_session
    rc = _auto_session(sess)
    if rc < 0:
        return rc, b""
    p = sess.params
    if p.data_fmt not in _STREAM_COMP_FMTS:
        return C.QZ_UNSUPPORTED_FMT, b""

    strm.in_buf += bytes(data)
    strm.pending_in = len(strm.in_buf)

    while len(strm.in_buf) >= p.strm_buff_sz or (last and strm.in_buf):
        take = min(len(strm.in_buf), p.strm_buff_sz)
        is_final_piece = last and take == len(strm.in_buf)
        piece = bytes(strm.in_buf[:take])
        res = core.compress_ext(sess, piece, last=1 if is_final_piece else 0,
                                crc_init=strm.crc_32)
        if res.rc != C.QZ_OK:
            return res.rc, _drain(strm, max_out)
        strm.crc_32 = res.crc
        strm.pending_out += res.data
        del strm.in_buf[:res.consumed]
        strm.in_sz += res.consumed
        strm.pending_in = len(strm.in_buf)
        if is_final_piece:
            break

    if last and not strm.in_buf and strm.in_sz == 0 and not strm.ended:
        # empty stream still emits a valid empty member
        res = core.compress_ext(sess, b"", last=1)
        if res.rc == C.QZ_OK:
            strm.pending_out += res.data

    return C.QZ_OK, _drain(strm, max_out)


_INCREMENTAL_WBITS = {
    DataFormatInternal.DEFLATE_GZIP: 31,
    DataFormatInternal.DEFLATE_GZIP_EXT: 31,
    DataFormatInternal.DEFLATE_RAW: -15,
    DataFormatInternal.DEFLATE_ZLIB: 15,
}


def _decompress_stream_incremental(sess: QzSession, strm: QzStream, data,
                                   last: int, max_out: int | None, wbits: int):
    """O(n) piecemeal decompress for the deflate formats: a zlib
    decompressobj carries mid-member state between calls, so each call costs
    only the new bytes (the one-shot funnel would re-parse the accumulated
    buffer every call — quadratic).  Footer checksums (gzip CRC32+ISIZE,
    zlib Adler32) are verified by the inflater itself."""
    import zlib

    p = sess.params
    adler = p.data_fmt == DataFormatInternal.DEFLATE_ZLIB
    strm.comp_in += bytes(data)
    while strm.comp_in:
        if strm._dobj is None:
            strm._dobj = zlib.decompressobj(wbits)
        feed = bytes(strm.comp_in)
        try:
            out = strm._dobj.decompress(feed)
        except zlib.error:
            return C.QZ_DATA_ERROR, _drain(strm, max_out)
        consumed = len(feed) - len(strm._dobj.unused_data)
        strm.pending_out += out
        del strm.comp_in[:consumed]
        strm.in_sz += consumed
        if adler:
            cur = strm.crc_32 if strm._any_member else 1
            strm.crc_32 = zlib.adler32(out, cur) & 0xFFFFFFFF
            strm._any_member = True
        else:
            strm.crc_32 = zlib.crc32(out, strm.crc_32) & 0xFFFFFFFF
        if strm._dobj.eof:
            sess.end_of_last_block = True
            strm._dobj = None
            strm._any_member = True
            continue  # next catenated member
        break  # mid-member: wait for more input
    if last and (strm.comp_in or strm._dobj is not None):
        return C.QZ_DATA_ERROR, _drain(strm, max_out)
    return C.QZ_OK, _drain(strm, max_out)


def _decompress_stream_lz4(sess: QzSession, strm: QzStream, data,
                           last: int, max_out: int | None):
    """O(n) piecemeal LZ4-frame decompress: the frame walk (header →
    block headers → blocks → endmark/footer) carries its offset and
    per-frame state across calls, so each input byte is examined once.
    Linked-block frames (FLG block-indep=0) keep a 64KB history window;
    the content XXH32 folds incrementally (utils.checksum.XXH32State).
    The reference's stream path is deflate-only (src/qatzip_stream.c:
    478-484) — this exceeds it, linearly."""
    import struct as _struct

    from qatzip_tpu_torch.engine.lz4_block import lz4_block_decompress
    from qatzip_tpu_torch.formats import lz4_fmt
    from qatzip_tpu_torch.utils import checksum as _ck

    strm.comp_in += bytes(data)
    st = strm._lz4
    if st is None:
        # xxh_all spans catenated frames (the whole-stream digest)
        st = strm._lz4 = {"phase": "header", "xxh_all": _ck.XXH32State(0)}
    buf = strm.comp_in

    def consume(k: int) -> None:
        del buf[:k]
        strm.in_sz += k

    while True:
        if st["phase"] == "header":
            if not buf:
                break
            try:
                hlen, hdr = lz4_fmt.parse_lz4_frame_header(buf, 0)
            except ValueError as e:
                if "truncated" in str(e) and len(buf) < 19:
                    break  # longest possible v1 header is 19 bytes
                return C.QZ_DATA_ERROR, _drain(strm, max_out)
            if len(buf) < hlen:
                break
            consume(hlen)
            st.update(phase="block_hdr",
                      indep=bool((hdr.flg >> 5) & 1),
                      blk_cksum=bool((hdr.flg >> 4) & 1),
                      content_cksum=bool((hdr.flg >> 2) & 1),
                      max_blk=1 << (8 + 2 * max((hdr.bd >> 4) & 7, 4)),
                      xxh=_ck.XXH32State(0), history=b"")
        elif st["phase"] == "block_hdr":
            if len(buf) < 4:
                break
            (word,) = _struct.unpack_from("<I", buf, 0)
            consume(4)
            if word == 0:
                st["phase"] = "footer"
                continue
            st["bsz"] = word & 0x7FFFFFFF
            st["stored"] = bool(word & 0x80000000)
            if st["bsz"] > st["max_blk"] + 16:
                return C.QZ_DATA_ERROR, _drain(strm, max_out)
            st["phase"] = "block_body"
        elif st["phase"] == "block_body":
            need = st["bsz"] + (4 if st["blk_cksum"] else 0)
            if len(buf) < need:
                break
            blk = bytes(buf[:st["bsz"]])
            if st["blk_cksum"]:
                (bck,) = _struct.unpack_from("<I", buf, st["bsz"])
                if _ck.xxh32(blk, 0) != bck:
                    return C.QZ_DATA_ERROR, _drain(strm, max_out)
            consume(need)
            if st["stored"]:
                out = blk
            else:
                try:
                    out = lz4_block_decompress(
                        blk, st["max_blk"],
                        prefix=b"" if st["indep"] else st["history"])
                except ValueError:
                    return C.QZ_DATA_ERROR, _drain(strm, max_out)
            if not st["indep"]:
                st["history"] = (st["history"] + out)[-65536:]
            st["xxh"].update(out)
            # session checksum = whole-stream xxh32 over all decoded output
            # (matches the one-shot funnel, engine/core.py:645-647)
            strm.crc_32 = st["xxh_all"].update(out).digest()
            strm.pending_out += out
            st["phase"] = "block_hdr"
        elif st["phase"] == "footer":
            if st["content_cksum"]:
                if len(buf) < 4:
                    break
                (cck,) = _struct.unpack_from("<I", buf, 0)
                consume(4)
                if st["xxh"].digest() != cck:
                    return C.QZ_DATA_ERROR, _drain(strm, max_out)
            strm._any_member = True
            sess.end_of_last_block = True
            strm._lz4 = st = {"phase": "header",     # catenated frames
                              "xxh_all": st["xxh_all"]}
        else:  # pragma: no cover
            return C.QZ_FAIL, _drain(strm, max_out)

    mid_frame = st["phase"] != "header" or bool(buf)
    if last and mid_frame:
        return C.QZ_DATA_ERROR, _drain(strm, max_out)
    return C.QZ_OK, _drain(strm, max_out)


def qz_decompress_stream(sess: QzSession, strm: QzStream, data=b"",
                         last: int = 0, max_out: int | None = None):
    """Returns (rc, produced_bytes).  Buffers compressed input and emits
    decompressed bytes of every complete member seen so far; deflate formats
    drain incrementally (mid-member state carries between calls)."""
    if not isinstance(sess, QzSession) or not isinstance(strm, QzStream):
        return C.QZ_PARAMS, b""
    from qatzip_tpu_torch.api import _auto_session
    rc = _auto_session(sess)
    if rc < 0:
        return rc, b""
    wbits = _INCREMENTAL_WBITS.get(sess.params.data_fmt)
    if wbits is not None:
        return _decompress_stream_incremental(sess, strm, data, last, max_out,
                                              wbits)
    if sess.params.data_fmt == DataFormatInternal.LZ4_FH:
        return _decompress_stream_lz4(sess, strm, data, last, max_out)

    strm.comp_in += bytes(data)
    if sess.params.data_fmt == DataFormatInternal.DEFLATE_4B:
        # the 4B header names the member's compressed length: wait for the
        # complete member instead of re-parsing the accumulated buffer
        # every call (keeps piecemeal feeding O(n))
        import struct as _struct

        from qatzip_tpu_torch.utils import checksum as _ck

        while len(strm.comp_in) >= 4:
            (clen,) = _struct.unpack_from("<I", strm.comp_in, 0)
            if len(strm.comp_in) < 4 + clen:
                return ((C.QZ_DATA_ERROR if last else C.QZ_OK),
                        _drain(strm, max_out))
            res = core.decompress_ext(sess, bytes(strm.comp_in[:4 + clen]))
            if res.rc != C.QZ_OK or res.consumed == 0:
                return (res.rc if res.rc != C.QZ_OK else C.QZ_DATA_ERROR,
                        _drain(strm, max_out))
            strm.pending_out += res.data
            del strm.comp_in[:res.consumed]
            strm.in_sz += res.consumed
            strm.crc_32 = (res.crc if not strm._any_member else
                           _ck.crc32_combine(strm.crc_32, res.crc,
                                             len(res.data)))
            strm._any_member = True
        if last and strm.comp_in:
            return C.QZ_DATA_ERROR, _drain(strm, max_out)
        return C.QZ_OK, _drain(strm, max_out)

    if strm.comp_in:
        res = core.decompress_ext(sess, bytes(strm.comp_in))
        if res.rc == C.QZ_DATA_ERROR and not last and res.consumed == 0:
            # likely an incomplete member; wait for more input
            return C.QZ_OK, _drain(strm, max_out)
        if res.rc not in (C.QZ_OK, C.QZ_BUF_ERROR):
            return res.rc, _drain(strm, max_out)
        strm.pending_out += res.data
        del strm.comp_in[:res.consumed]
        strm.in_sz += res.consumed
        strm.crc_32 = res.crc
    if last and strm.comp_in:
        return C.QZ_DATA_ERROR, _drain(strm, max_out)
    return C.QZ_OK, _drain(strm, max_out)


def qz_end_stream(sess: QzSession, strm: QzStream):
    """Flush remaining output and release stream state
    (qzEndStream, reference src/qatzip_stream.c:751-781)."""
    out = bytes(strm.pending_out)
    strm.out_sz += len(out)
    strm.pending_out.clear()
    strm.in_buf.clear()
    strm.comp_in.clear()
    strm.ended = True
    return C.QZ_OK, out
