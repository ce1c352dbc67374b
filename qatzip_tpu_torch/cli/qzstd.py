"""qzstd: LZ4s -> Zstandard post-processing pipeline CLI of the port (a
copy of qatzip_tpu/cli/qzstd.py; reference utils/qzstd.c,
utils/qzstd_main.c).  Needs the ``zstandard`` package, imported only when a
zstd callback is made or a file decompressed.

The accelerator emits LZ4s sequences; the post-process callback turns them
into standard Zstd frames.  The reference re-encodes the sequences directly
with ZSTD_compressSequences; the Python zstandard binding has no sequence
API, so the callback validates/decodes the LZ4s sequences and re-encodes the
reconstructed bytes with the zstd encoder — output is standard Zstd either
way.  (A native C++ ZSTD_compressSequences path is the planned upgrade.)
"""
from __future__ import annotations

import argparse
import os
import struct
import sys
import time

from qatzip_tpu_torch import constants as C


def make_zstd_callback(level: int = 1):
    """Returns (callback, external) implementing qzLZ4SCallbackFn
    (reference include/qatzip.h:448, utils/qzstd.c:212-279)."""
    import zstandard

    cctx = zstandard.ZstdCompressor(level=max(1, min(level, 19)))

    def zstd_callback(external, src: bytes, lz4s_payload: bytes) -> bytes:
        from qatzip_tpu_torch.engine.lz4_block import lz4s_decode_sequences
        out = bytearray()
        pos = 0
        consumed = 0
        mini_match = external.get("mini_match", 3) if isinstance(external, dict) else 3
        while pos + 4 <= len(lz4s_payload):
            (blk_sz,) = struct.unpack_from("<I", lz4s_payload, pos)
            pos += 4
            block = lz4s_payload[pos:pos + blk_sz]
            pos += blk_sz
            # decode sequences (validates the LZ4s stream) and measure the
            # content size they describe
            seqs = lz4s_decode_sequences(block, mini_match)
            cnt = sum(s[1] + s[3] for s in seqs)
            chunk = src[consumed:consumed + cnt]
            consumed += cnt
            out += external["cctx"].compress(chunk) if isinstance(external, dict) \
                else cctx.compress(chunk)
        return bytes(out)

    return zstd_callback, {"cctx": cctx, "mini_match": 3}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="qzstd",
        description="LZ4s->Zstd pipeline (qzstd-compatible CLI)")
    ap.add_argument("-d", dest="decompress", action="store_true")
    ap.add_argument("-L", dest="level", type=int, default=1)
    ap.add_argument("-C", dest="chunk_sz", type=int, default=C.QZ_HW_BUFF_SZ)
    ap.add_argument("-o", dest="output", default=None)
    ap.add_argument("-k", dest="keep", action="store_true")
    ap.add_argument("files", nargs="*")
    args = ap.parse_args(argv)

    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.session import (QzSessionParamsCommon,
                                          QzSessionParamsLZ4S)

    for path in args.files:
        t0 = time.time()
        with open(path, "rb") as f:
            data = f.read()
        if args.decompress:
            import io
            import zstandard
            dctx = zstandard.ZstdDecompressor()
            out = bytearray()
            with dctx.stream_reader(io.BytesIO(bytes(data)),
                                    read_across_frames=True) as r:
                while True:
                    piece = r.read(1 << 20)
                    if not piece:
                        break
                    out += piece
            out = bytes(out)
            out_path = args.output or (path[:-4] if path.endswith(".zst")
                                       else path + ".out")
        else:
            sess = qz.QzSession()
            cb, ext = make_zstd_callback(args.level)
            p = QzSessionParamsLZ4S(
                common_params=QzSessionParamsCommon(comp_lvl=args.level,
                                                    hw_buff_sz=args.chunk_sz),
                qzCallback=cb, qzCallback_external=ext)
            rc = qz.qz_setup_session_lz4s(sess, p)
            if rc != C.QZ_OK:
                print(f"qzstd: setup failed rc={rc}", file=sys.stderr)
                sys.exit(1)
            res = qz.qz_compress(sess, data)
            if res.rc != C.QZ_OK:
                print(f"qzstd: compress failed rc={res.rc}", file=sys.stderr)
                sys.exit(1)
            out = res.data
            out_path = args.output or (path + ".zst")
        with open(out_path, "wb") as f:
            f.write(out)
        elapsed = time.time() - t0
        mbit = len(data) * 8 / 1e6 / elapsed if elapsed else 0.0
        print(f"{path}: {len(data)} -> {len(out)} bytes, {mbit:.1f} Mbit/s",
              file=sys.stderr)
        if not args.keep:
            os.remove(path)


if __name__ == "__main__":
    main()
