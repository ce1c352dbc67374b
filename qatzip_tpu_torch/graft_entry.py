"""The port's compile-check and multi-device dry-run entry points (the
counterparts of the JAX package's ``__graft_entry__.py``).

``entry()`` returns the path's device stage, the sort-based LZ77 candidate
search (ops/match_finder.py, which launches the select kernel), with
example tensors on the card.

``dryrun_multichip(n)`` pins the block-DP mesh (parallel/shard.py) to the
first n CUDA devices and runs the public API's compress -> decompress
round trip over it with the device route forced, then the distributed
engine, the offsets collective over the mesh and a sweep of every wire
format at levels 1 and 9 through the one-shot, stream and async APIs.  It
raises when fewer than n CUDA devices exist; ``devices`` names others
(the tests pass CPU devices, which run the kernels' plain versions).
"""
from __future__ import annotations

import gzip
import os
import zlib

import numpy as np
import torch


def entry(device: torch.device | None = None):
    """(fn, (data, lengths)): ``match_finder.find_candidates`` at depth 4
    and a [8, 4096 + 8] batch on ``device`` (default ``cuda:0``)."""
    from qatzip_tpu_torch.ops import match_finder as mf

    if device is None:
        device = torch.device("cuda", 0)
    n, b = 4096, 8

    def fn(data_pad, lengths):
        return mf.find_candidates(data_pad, lengths, depth=4)

    rng = np.random.default_rng(0)
    data = np.zeros((b, n + 8), np.uint8)
    data[:, :n] = rng.integers(0, 64, (b, n), dtype=np.uint8)
    lengths = np.full((b,), n, np.int32)
    return fn, (torch.from_numpy(data).to(device),
                torch.from_numpy(lengths).to(device))


def _sweep(sdata: bytes, sweep_n: int) -> list[str]:
    """Every wire format at levels 1 and 9 through the one-shot, stream and
    async APIs; returns the matrix's cells."""
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch import async_api
    from qatzip_tpu_torch import stream as S
    from qatzip_tpu_torch.constants import QzDataFormat

    fmts = [("deflate", QzDataFormat.QZ_DEFLATE_GZIP, "gzip"),
            ("deflate", QzDataFormat.QZ_DEFLATE_GZIP_EXT, "gzipext"),
            ("deflate", QzDataFormat.QZ_DEFLATE_RAW, "raw"),
            ("deflate", QzDataFormat.QZ_DEFLATE_4B, "4B"),
            ("zlib", None, "zlib"), ("lz4", None, "lz4"),
            ("lz4s", None, "lz4s")]
    matrix = []
    for algo, fmt, name in fmts:
        for level in (1, 9):
            comp = qt.compress(sdata, algo, fmt=fmt, level=level,
                               hw_buff_sz=sweep_n)
            assert qt.decompress(comp, algo, fmt=fmt,
                                 hw_buff_sz=sweep_n) == sdata, \
                f"{name} L{level} one-shot"
            if name == "gzip":
                assert gzip.decompress(comp) == sdata
            elif name == "zlib":
                # a multi-member zlib stream: walk it with decompressobj
                zout, rest = bytearray(), bytes(comp)
                while rest:
                    zo = zlib.decompressobj()
                    zout += zo.decompress(rest) + zo.flush()
                    rest = zo.unused_data
                assert bytes(zout) == sdata
            # stream compress where the stream API takes the format
            # (deflate family), incremental decompress for all
            if algo in ("deflate", "zlib"):
                sess = qt.api._session_for(algo, fmt, level, sweep_n)
                cs = S.QzStream()
                rc1, out1 = S.qz_compress_stream(sess, cs, sdata, last=1)
                assert rc1 == qt.QZ_OK
                scomp = out1 + S.qz_end_stream(sess, cs)[1]
            else:
                scomp = comp
            dsess = qt.api._session_for(algo, fmt, level, sweep_n)
            ds = S.QzStream()
            sout = bytearray()
            step = 1777
            for i in range(0, len(scomp), step):
                rc2, piece = S.qz_decompress_stream(
                    dsess, ds, scomp[i:i + step],
                    last=1 if i + step >= len(scomp) else 0)
                assert rc2 == qt.QZ_OK, f"{name} L{level} stream rc={rc2}"
                sout += piece
            assert bytes(sout) == sdata, f"{name} L{level} stream"
            # the async ring, both directions
            asess = qt.api._session_for(algo, fmt, level, sweep_n)
            rc3, fut = async_api.qz_compress2(asess, sdata)
            assert rc3 == qt.QZ_OK
            acomp = fut.result(timeout=120)
            assert acomp.rc == qt.QZ_OK
            adsess = qt.api._session_for(algo, fmt, level, sweep_n)
            rc4, dfut = async_api.qz_decompress2(adsess, acomp.data)
            assert rc4 == qt.QZ_OK
            ares = dfut.result(timeout=120)
            assert ares.rc == qt.QZ_OK and ares.data == sdata, \
                f"{name} L{level} async"
            matrix.append(f"{name}:L{level}:oneshot+stream+async")
    return matrix


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """One block-DP run of the public API over ``n_devices`` devices: the
    first n CUDA devices, or the first n of ``devices``.  Raises
    RuntimeError when fewer exist; never falls back to other devices."""
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.constants import QzDataFormat
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.parallel import dist, dist_engine, shard

    mesh = shard.make_mesh(n_devices, devices)
    saved = shard._MESH, os.environ.get("QATZIP_TPU_DEVICE")
    # pin the engine's block-DP mesh and force the device route: the dry
    # run must run the sharded device path
    shard._MESH = mesh
    os.environ["QATZIP_TPU_DEVICE"] = "1"
    try:
        eng = core.engine()
        if (not eng.initialized or eng.hw_backend is None
                or eng.hw_backend.device != mesh[0]):
            core.qz_close_engine()
            rc = qt.qz_init(qt.QzSession(), device=mesh[0])
            if rc != qt.QZ_OK:
                raise RuntimeError(f"qz_init on {mesh[0]}: {rc}")
        eng = core.engine()

        n = 4096  # small chunks: 4 a device, so every batch is cut
        words = [b"the", b"quick", b"brown", b"fox", b"compression",
                 b"offload"]
        rng = np.random.default_rng(0)
        raw = b" ".join(words[i] for i in rng.integers(0, len(words), 40000))
        data = raw[:n * n_devices * 4]
        fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT

        hw0, sw0 = eng.hw_requests, eng.sw_requests
        comp = qt.compress(data, "deflate", fmt=fmt, level=1, hw_buff_sz=n)
        out = qt.decompress(comp, "deflate", hw_buff_sz=n)
        assert out == data, "sharded public-API round trip mismatch"
        assert gzip.decompress(comp) == data, "gzip interop mismatch"
        hw_used = eng.hw_requests - hw0
        assert hw_used > 0 and eng.sw_requests == sw0, \
            "the dry run did not stay on the device path"

        # the distributed engine (one process here) and the offsets
        # collective over the mesh
        dcomp = dist_engine.compress_distributed(data, fmt=fmt, level=1,
                                                 hw_buff_sz=n)
        assert dist_engine.decompress_distributed(dcomp, fmt=fmt,
                                                  hw_buff_sz=n) == data
        lens = np.arange(1, n_devices * 4 + 1, dtype=np.int64) * 100
        want = np.concatenate([[0], np.cumsum(lens)[:-1]])
        offs = dist.sharded_offsets(mesh, lens)
        assert all(o.device == d for o, d in zip(offs, mesh)), \
            "an offsets shard left its device"
        assert (np.concatenate([o.cpu().numpy() for o in offs])
                == want).all(), "sharded_offsets mismatch"

        matrix = _sweep(data[:2048 * n_devices * 2], 2048)
    finally:
        shard._MESH, env = saved
        if env is None:
            os.environ.pop("QATZIP_TPU_DEVICE", None)
        else:
            os.environ["QATZIP_TPU_DEVICE"] = env
    print(f"dryrun_multichip: {n_devices} devices ({', '.join(map(str, mesh))}"
          f"), {len(data)} bytes round-tripped bit-exact through "
          f"qz_compress/qz_decompress ({hw_used} device chunk requests, "
          f"{n_devices}-way block-DP; dist engine and mesh offsets checked)")
    print("multichip matrix: " + " ".join(matrix))
