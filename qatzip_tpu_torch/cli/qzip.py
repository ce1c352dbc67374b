"""qzip-compatible CLI of the port (a copy of qatzip_tpu/cli/qzip.py;
reference utils/qzip_main.c, utils/qzip.c).

Run it as ``python3 -m qatzip_tpu_torch.cli.qzip``.  Requests run on the
first CUDA device when there is one and the routing lets them (set
QATZIP_TPU_DEVICE=1 to force the device route), else on the CPU.

Supported flags mirror the reference:
  -d            decompress
  -k            keep source files (reference deletes by default)
  -R            recursive directory traversal
  -A ALGO       deflate | lz4 | lz4s | zstd
  -O FMT        gzip | gzipext | deflate_4B | deflate_raw | zlib | lz4 |
                lz4s | 7z | zstd
  -L LEVEL      compression level 1-9
  -C SIZE       chunk (hw buffer) size in bytes
  -o NAME       output file name
  -g LEVEL      log level (0-7)
  -s            use the streaming interface
  -r N          repeat each request N times (perf loops, reference -r)
  -P busy       busy-polling mode (eager device dispatch, reference -P)
  -S            latency-sensitive mode routing (reference -s LSM flag)
  -h            help

Files compress to <name>.<suffix>; with no files, stdin->stdout streaming is
used (reference utils/qzip.c:794).  Per-file stats (throughput, ratio, space
savings) are printed as in displayStats (reference utils/qzip.c:147-178).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from qatzip_tpu_torch import constants as C


_SUFFIX = {"gzip": ".gz", "gzipext": ".gz", "deflate_4B": ".4b",
           "deflate_raw": ".deflate", "zlib": ".zz", "lz4": ".lz4",
           "lz4s": ".lz4s", "7z": ".7z", "zstd": ".zst"}


def _session(args):
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.constants import QzDataFormat, QzPollingMode
    from qatzip_tpu_torch.session import (QzSessionParamsCommon,
                                          QzSessionParamsDeflate,
                                          QzSessionParamsDeflateExt,
                                          QzSessionParamsLZ4,
                                          QzSessionParamsLZ4S)

    common = QzSessionParamsCommon(comp_lvl=args.level,
                                   hw_buff_sz=args.chunk_sz,
                                   strm_buff_sz=args.chunk_sz,
                                   is_sensitive_mode=1 if getattr(args, "sensitive", False) else 0,
                                   polling_mode=(QzPollingMode.QZ_BUSY_POLLING
                                                 if getattr(args, "polling", None) == "busy"
                                                 else QzPollingMode.QZ_PERIODICAL_POLLING))
    sess = qz.QzSession()
    algo = args.algorithm
    fmt = args.output_fmt
    if algo == "deflate":
        fmt_map = {"gzip": QzDataFormat.QZ_DEFLATE_GZIP,
                   "gzipext": QzDataFormat.QZ_DEFLATE_GZIP_EXT,
                   "deflate_4B": QzDataFormat.QZ_DEFLATE_4B,
                   "deflate_raw": QzDataFormat.QZ_DEFLATE_RAW,
                   "7z": QzDataFormat.QZ_DEFLATE_RAW}
        if fmt == "zlib":
            p = QzSessionParamsDeflateExt(
                deflate_params=QzSessionParamsDeflate(common_params=common),
                zlib_format=1)
            rc = qz.qz_setup_session_deflate_ext(sess, p)
        else:
            p = QzSessionParamsDeflate(
                common_params=common,
                data_fmt=fmt_map.get(fmt, QzDataFormat.QZ_DEFLATE_GZIP))
            rc = qz.qz_setup_session_deflate(sess, p)
    elif algo == "lz4":
        rc = qz.qz_setup_session_lz4(
            sess, QzSessionParamsLZ4(common_params=common))
    elif algo in ("lz4s", "zstd"):
        from qatzip_tpu_torch.cli.qzstd import make_zstd_callback
        p = QzSessionParamsLZ4S(common_params=common)
        if algo == "zstd":
            p.qzCallback, p.qzCallback_external = make_zstd_callback(args.level)
        rc = qz.qz_setup_session_lz4s(sess, p)
    else:
        print(f"qzip: unknown algorithm {algo}", file=sys.stderr)
        sys.exit(1)
    if rc != C.QZ_OK:
        print(f"qzip: session setup failed (rc={rc})", file=sys.stderr)
        sys.exit(1)
    return sess


def _display_stats(direction, in_sz, out_sz, elapsed):
    """displayStats analog (reference utils/qzip.c:147-178)."""
    mbit = (in_sz * 8 / 1e6) / elapsed if elapsed > 0 else 0.0
    if direction == "compress" and in_sz > 0:
        ratio = in_sz / out_sz if out_sz else 0.0
        savings = 100.0 * (1 - out_sz / in_sz)
        print(f"Throughput: {mbit:.2f} Mbit/s, compression ratio: "
              f"{ratio:.2f}, space savings: {savings:.1f}%", file=sys.stderr)
    else:
        print(f"Throughput: {mbit:.2f} Mbit/s", file=sys.stderr)


def _out_name(path, args):
    """makeOutName analog (reference utils/qzip.c:659-700): compressing
    appends the format suffix even when -o is given; decompressing uses -o
    verbatim, else strips the recognized suffix."""
    if args.decompress:
        if args.output:
            return args.output
        for suf in set(_SUFFIX.values()):
            if path.endswith(suf):
                return path[: -len(suf)]
        return path + ".out"
    base = args.output if args.output else path
    return base + _SUFFIX.get(args.output_fmt, ".gz")


def _detect_args_from_suffix(path, args):
    if path.endswith(".lz4"):
        args.algorithm = "lz4"
    elif path.endswith(".zst"):
        args.algorithm = "zstd"
    elif path.endswith(".7z"):
        args.output_fmt = "7z"
    elif path.endswith(".zz"):
        args.output_fmt = "zlib"


def _process_special(path, args):
    """Block/character devices and FIFOs (reference utils/qzip.c:566-658
    compresses block devices): stream the device through the bounded-memory
    stream API into an explicit -o target (no suffix naming or source
    removal for device nodes)."""
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.stream import (QzStream, qz_compress_stream,
                                         qz_decompress_stream, qz_end_stream)

    if not args.output:
        print(f"qzip: {path}: device input requires -o <output>",
              file=sys.stderr)
        sys.exit(1)
    sess = _session(args)
    strm = QzStream()
    fn = qz_decompress_stream if args.decompress else qz_compress_stream
    in_sz = out_sz = 0
    t0 = time.time()
    with open(path, "rb") as src, open(args.output, "wb") as dst:
        while True:
            piece = src.read(args.chunk_sz)
            last = 0 if piece else 1
            in_sz += len(piece)
            rc, out = fn(sess, strm, piece, last=last)
            if rc != C.QZ_OK:
                print(f"qzip: stream error rc={rc}", file=sys.stderr)
                sys.exit(1)
            dst.write(out)
            out_sz += len(out)
            if last:
                break
        _rc, tail = qz_end_stream(sess, strm)
        dst.write(tail)
        out_sz += len(tail)
    _display_stats("decompress" if args.decompress else "compress",
                   in_sz, out_sz, time.time() - t0)


def _is_special(path) -> bool:
    import stat as _stat

    try:
        mode = os.stat(path).st_mode
    except OSError:
        return False
    return (_stat.S_ISBLK(mode) or _stat.S_ISCHR(mode)
            or _stat.S_ISFIFO(mode))


def _process_file(path, args):
    import qatzip_tpu_torch as qz

    if _is_special(path):
        return _process_special(path, args)
    if args.decompress:
        _detect_args_from_suffix(path, args)
    if args.output_fmt == "7z" and not args.decompress:
        from qatzip_tpu_torch.cli.sevenz import compress_7z
        out = args.output or (path + ".7z")
        t0 = time.time()
        in_sz, out_sz = compress_7z([path], out, args)
        _display_stats("compress", in_sz, out_sz, time.time() - t0)
        if not args.keep:
            os.remove(path)
        return
    if args.decompress and path.endswith(".7z"):
        from qatzip_tpu_torch.cli.sevenz import decompress_7z
        t0 = time.time()
        in_sz, out_sz = decompress_7z(path, args.output or ".")
        _display_stats("decompress", in_sz, out_sz, time.time() - t0)
        if not args.keep:
            os.remove(path)
        return

    sess = _session(args)
    with open(path, "rb") as f:
        data = f.read()
    out_path = _out_name(path, args)
    reps = max(1, getattr(args, "req_count", 1))
    t0 = time.time()
    for _ in range(reps):
        if args.decompress:
            res = qz.qz_decompress(sess, data)
        else:
            res = qz.qz_compress(sess, data)
    elapsed = time.time() - t0
    if res.rc != C.QZ_OK:
        print(f"qzip: {'de' if args.decompress else ''}compress failed on "
              f"{path} (rc={res.rc})", file=sys.stderr)
        sys.exit(1)
    with open(out_path, "wb") as f:
        f.write(res.data)
    _display_stats("decompress" if args.decompress else "compress",
                   len(data) * reps, len(res.data) * reps, elapsed)
    if not args.keep and os.path.abspath(out_path) != os.path.abspath(path):
        os.remove(path)


def _process_dir(path, args):
    for root, _dirs, files in os.walk(path):
        for name in files:
            _process_file(os.path.join(root, name), args)


def _process_stdio(args):
    import qatzip_tpu_torch as qz
    from qatzip_tpu_torch.stream import QzStream, qz_compress_stream, \
        qz_decompress_stream, qz_end_stream

    sess = _session(args)
    strm = QzStream()
    src = sys.stdin.buffer
    dst = sys.stdout.buffer
    fn = qz_decompress_stream if args.decompress else qz_compress_stream
    while True:
        piece = src.read(args.chunk_sz)
        last = 0 if piece else 1
        rc, out = fn(sess, strm, piece, last=last)
        if rc not in (C.QZ_OK,):
            print(f"qzip: stream error rc={rc}", file=sys.stderr)
            sys.exit(1)
        dst.write(out)
        if last:
            break
    _rc, tail = qz_end_stream(sess, strm)
    dst.write(tail)
    dst.flush()


def make_parser():
    ap = argparse.ArgumentParser(
        prog="qzip",
        description="GPU-accelerated compression (qzip-compatible CLI)")
    ap.add_argument("-d", dest="decompress", action="store_true",
                    help="decompress")
    ap.add_argument("-k", dest="keep", action="store_true",
                    help="keep source files")
    ap.add_argument("-R", dest="recursive", action="store_true",
                    help="recurse into directories")
    ap.add_argument("-A", dest="algorithm", default="deflate",
                    choices=["deflate", "lz4", "lz4s", "zstd"])
    ap.add_argument("-O", dest="output_fmt", default="gzipext",
                    choices=["gzip", "gzipext", "deflate_4B", "deflate_raw",
                             "zlib", "lz4", "lz4s", "7z", "zstd"])
    ap.add_argument("-L", dest="level", type=int, default=1)
    ap.add_argument("-C", dest="chunk_sz", type=int, default=C.QZ_HW_BUFF_SZ)
    ap.add_argument("-o", dest="output", default=None)
    ap.add_argument("-g", dest="loglevel", type=int, default=None)
    ap.add_argument("-s", dest="stream", action="store_true",
                    help="use streaming interface")
    # perf-tuning surface (reference utils/qzip_main.c:53-194)
    ap.add_argument("-r", dest="req_count", type=int, default=1,
                    help="times to repeat each (de)compression request "
                         "(perf loops; stats cover all repetitions)")
    ap.add_argument("-P", dest="polling", default=None, choices=["busy"],
                    help="polling mode: busy keeps the submit pipeline "
                         "saturated (maps to eager device dispatch)")
    ap.add_argument("-S", dest="sensitive", action="store_true",
                    help="enable latency-sensitive mode (LSM path routing; "
                         "reference -s flag)")
    ap.add_argument("files", nargs="*")
    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)
    if args.loglevel is not None:
        from qatzip_tpu_torch.utils.logging import set_log_level
        set_log_level(args.loglevel)
    if args.algorithm == "lz4":
        args.output_fmt = "lz4"
    elif args.algorithm == "lz4s":
        args.output_fmt = "lz4s"
    elif args.algorithm == "zstd":
        args.output_fmt = "zstd"

    if not args.files:
        _process_stdio(args)
        return

    if args.output_fmt == "7z" and not args.decompress:
        # the reference catenates EVERY input file/dir of one invocation
        # into a single archive (utils/qzip_main.c:196-344,
        # utils/qzip_7z.c:447-737) — one archive per run, not per file
        for path in args.files:
            if not os.path.exists(path):
                print(f"qzip: {path}: no such file", file=sys.stderr)
                sys.exit(1)
        from qatzip_tpu_torch.cli.sevenz import compress_7z
        out = args.output or (args.files[0].rstrip(os.sep) + ".7z")
        t0 = time.time()
        in_sz, out_sz = compress_7z(list(args.files), out, args)
        _display_stats("compress", in_sz, out_sz, time.time() - t0)
        if not args.keep:
            for path in args.files:
                if os.path.isfile(path):
                    os.remove(path)
        return

    for path in args.files:
        if os.path.isdir(path):
            if args.recursive:
                _process_dir(path, args)
            else:
                print(f"qzip: {path} is a directory (use -R)", file=sys.stderr)
                sys.exit(1)
        elif os.path.exists(path):
            _process_file(path, args)
        else:
            print(f"qzip: {path}: no such file", file=sys.stderr)
            sys.exit(1)


if __name__ == "__main__":
    main()
