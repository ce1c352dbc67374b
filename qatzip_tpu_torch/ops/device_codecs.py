"""Device codec: batch chunks into device tensors, run the kernels, unpack
results into backend-contract payloads.

Port of the two device codecs of qatzip_tpu/ops/device_codecs.py, with the
reference's per-batch CPU failover and its ``faults``/``health`` hooks:

* ``DeflateDeviceCodec``: the hybrid compress path (``_compress_hybrid``,
  :102-224), with the raw and the packed candidate format; the full-device
  encoder (``_compress_full_device``, :226-303, QATZIP_TPU_ENCODER=device)
  with the chunk checksums computed on the device from the same staged
  batch; and the decompress path (``decompress_chunks``, :306-362): the
  lockstep inflate, or the speculative decoder in batches of
  ``MAX_DECODE_BATCH`` with QATZIP_TPU_INFLATE=spec;
* ``Lz4DeviceCodec`` (:365-521), for LZ4 frames and LZ4s blocks: the hybrid
  compress branch, the device encoder's branch (``_lz4_analyze``) and the
  device block decoder (ops/lz4_decode.py) with per-block CPU failover.

Every compress path runs block-data-parallel over ``shard.local_mesh()``
(a list of devices, parallel/shard.py) when a batch has at least two
chunks a device: each contiguous slice is staged and run on its own
device, and the results are gathered in block order.  With one device
(one H100: no mesh) a batch runs whole on the engine's device.

The per-batch failover takes injected faults and a card out of memory
(``faults.FAILOVER``); any other error, a :class:`KernelError` (a kernel
that cannot be built or launched) and a CUDA error (a kernel that faulted
on the card) among them, reaches the caller, where the reference reroutes
every exception.  A chunk the device fails over that the host decoder
refuses raises :class:`RefusedStream`: a data error, not a device failure.
The host-only helpers (CPU fallbacks, checksums, the stored-block framing)
are copies of the reference's.

A traced request (engine/flow.py) gets a ``staging`` span for each staged
batch (the bytes sent to the device) and, on the hybrid compress path, an
``mf`` span for each batch's match finder, a ``gather`` span for each
candidate read-back (the bytes brought to the host) and an ``assemble``
span for each batch's native parse (its chunks); an LZ4 decompress gets
one ``lz4.batch`` span a call, holding ``lz4.walk``, the decoder's
``lz4.stage``, ``lz4.device`` and ``lz4.collect``, ``lz4.assemble`` and
``lz4.checksum``.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np
import torch

from qatzip_tpu_torch.constants import DataFormatInternal, QzHuffmanHdr
from qatzip_tpu_torch.engine import faults
from qatzip_tpu_torch.engine.backend import (CompressedChunk,
                                             DecompressedChunk, RefusedStream)
from qatzip_tpu_torch.engine.cpu_backend import CpuBackend, _map_chunks
from qatzip_tpu_torch.engine.flow import tls
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.engine.lz4_block import (lz4_block_decompress,
                                               lz4s_block_decompress)
from qatzip_tpu_torch.native import qzcore as native
from qatzip_tpu_torch.ops import deflate_encode as de
from qatzip_tpu_torch.parallel import shard
from qatzip_tpu_torch.session import InternalParams
from qatzip_tpu_torch.utils import checksum as _ck


def _stage_chunks(batch, n: int, device: torch.device):
    """Build the [len(batch), n+8] uint8 device input for a batch of chunks:
    one staged host copy, then a non-blocking upload.  Returns (data, lens)
    on ``device``."""
    rec = tls.rec
    span = rec.open("staging") if rec is not None else None
    lens = np.zeros((len(batch),), np.int32)
    data = np.zeros((len(batch), n + 8), np.uint8)
    for i, c in enumerate(batch):
        if len(c) > n:
            raise ValueError("chunk exceeds hw_buff_sz")
        lens[i] = len(c)
        data[i, :len(c)] = np.frombuffer(c, np.uint8)
    staged = (torch.from_numpy(data).to(device, non_blocking=True),
              torch.from_numpy(lens).to(device, non_blocking=True))
    if span is not None:
        rec.close(span, data.nbytes + lens.nbytes)
    return staged


def _submit(batch, n: int, device: torch.device, run) -> list:
    """Stage ``batch`` and call ``run(data, lens)`` on it: whole on
    ``device``, or cut over the local mesh (``shard.block_slices``) with
    each slice staged and run on its own device.  Returns the per-slice
    results in block order."""
    slices = shard.block_slices(len(batch), shard.local_mesh())
    if slices is None:
        slices = [(device, 0, len(batch))]
    out = []
    for dev, start, end in slices:
        with shard.on(dev):
            out.append(run(*_stage_chunks(batch[start:end], n, dev)))
    return out


def _batch_size(nchunks: int, bsz: int) -> int:
    """Chunks a dispatch: ``bsz``, or ``bsz`` a device of the local mesh
    when the request has at least two chunks a device (the reference's
    block-DP batch)."""
    mesh = shard.local_mesh()
    if mesh is None or nchunks < 2 * len(mesh):
        return bsz
    ndev = len(mesh)
    return max(ndev, (min(nchunks, bsz * ndev) // ndev) * ndev)


def _stored_block(chunk: bytes) -> bytes:
    """BFINAL=1 BTYPE=00 stored deflate block(s) for one chunk (host side)."""
    out = bytearray()
    n = len(chunk)
    pos = 0
    while True:
        seg = min(n - pos, 65535)
        last = pos + seg == n
        out.append(0x01 if last else 0x00)
        out += seg.to_bytes(2, "little")
        out += (seg ^ 0xFFFF).to_bytes(2, "little")
        out += chunk[pos:pos + seg]
        pos += seg
        if last:
            break
    return bytes(out)


class DeflateDeviceCodec:
    """Batched deflate-block codec running on a torch device."""

    MAX_BATCH = 128        # chunks per device dispatch
    # blocks per inflate round, one lane each and one launch a round; the
    # reference's 128 (a TPU vreg's lanes) cut a 32 MB request's 512 chunks
    # into 4 launches a round (PERF.md, the inflate kernel's redesign)
    LOCKSTEP_BATCH = 512
    MAX_DECODE_BATCH = 8   # streams a speculative round (the reference's)

    def compress_chunks(self, chunks: Sequence[bytes], params: InternalParams,
                        device: torch.device) -> list[CompressedChunk]:
        if os.environ.get("QATZIP_TPU_ENCODER", "hybrid") == "hybrid":
            return self._compress_hybrid(chunks, params, device)
        return self._compress_full_device(chunks, params, device)

    def _compress_hybrid(self, chunks: Sequence[bytes],
                         params: InternalParams,
                         device: torch.device) -> list[CompressedChunk]:
        """Hybrid path: the device runs the sort-based LZ77 candidate search
        (ops/match_finder.py) and the native host code verifies, extends and
        entropy-codes (qz_deflate_candidates), the split the reference
        makes between its search engine and its driver."""
        from qatzip_tpu_torch.engine import devcal
        from qatzip_tpu_torch.ops import match_finder as mf

        n = params.hw_buff_sz
        depth, _ = de.level_params(params.comp_lvl)
        # Packed candidate D2H (0.75 bytes an input byte against 2):
        # exceptions above the side stream's budget degrade to guesses, so
        # packing trades a few % of compressed size for 2.7x less D2H.
        # QATZIP_TPU_PACK=1/0 overrides; otherwise the calibration record's
        # measured winner decides (engine/devcal.py).
        env_pack = os.environ.get("QATZIP_TPU_PACK", "")
        if env_pack in ("0", "1"):
            use_packed = env_pack == "1"
        else:
            use_packed = bool(devcal._load().get("pack_wins", False))
        use_packed = use_packed and int(
            os.environ.get("QATZIP_TPU_MF_STRIDE", "1")) == 1
        # L1/L2 default: stride-2 indexing at depth >= 16 (the reference's
        # speed point; the parser's two-sided probes keep the ratio).  The
        # packed format keeps stride 1 (its classes assume dense candidates).
        stride_env = os.environ.get("QATZIP_TPU_MF_STRIDE")
        if use_packed:
            stride = 1
        elif stride_env is not None:
            stride = int(stride_env)
        elif params.comp_lvl <= 2:
            stride = 2
            depth = max(depth, 16)
        else:
            stride = 1

        rec = tls.rec

        def run(data, lens):
            faults.check("submit", "compress")
            span = rec.open("mf") if rec is not None else None
            cand = (mf.find_candidates_packed(data, lens, depth)
                    if use_packed else
                    mf.find_candidates(data, lens, depth, stride=stride))
            if span is not None:
                rec.close(span)
            return cand

        # submit-all-then-assemble: kernels queue on the device while the
        # host assembles earlier batches
        bsz = _batch_size(len(chunks), self.MAX_BATCH)
        pending: list[tuple] = []
        for start in range(0, len(chunks), bsz):
            batch = list(chunks[start:start + bsz])
            try:
                pending.append((batch, _submit(batch, n, device, run)))
            except faults.FAILOVER:
                # per-batch reroute to the CPU (compInSWFallback analog)
                health.record_failure()
                pending.append((batch, None))

        out: list[CompressedChunk] = []
        for batch, cand in pending:
            if cand is None:
                out.extend(_cpu_compress_batch(batch, params))
                continue
            span = rec.open("gather") if rec is not None else None
            try:
                faults.check("death", "compress")
                cand_np = shard.gather(cand)
            except faults.FAILOVER:
                if span is not None:
                    rec.close(span)
                health.record_failure()
                out.extend(_cpu_compress_batch(batch, params))
                continue
            if span is not None:
                rec.close(span, cand_np.nbytes)
            health.record_success()
            if faults.armed() and faults.should_fire("poison", "compress"):
                # a poisoned candidate array must be HARMLESS: the native
                # parser verifies every candidate by byte compare
                rngp = np.random.default_rng(0)
                cand_np = rngp.integers(
                    0, int(np.iinfo(cand_np.dtype).max) + 1,
                    cand_np.shape).astype(cand_np.dtype)

            def assemble(i_c):
                i, c = i_c
                if use_packed:
                    payload = native.deflate_candidates_packed(
                        c, cand_np[i], params.comp_lvl)
                else:
                    payload = native.deflate_candidates(c, cand_np[i],
                                                        params.comp_lvl)
                return CompressedChunk(payload, _chunk_checksum(c, params),
                                       len(c))

            span = rec.open("assemble", len(batch)) if rec is not None \
                else None
            out.extend(_map_chunks(assemble, list(enumerate(batch))))
            if span is not None:
                rec.close(span)
        return out

    def _compress_full_device(self, chunks: Sequence[bytes],
                              params: InternalParams,
                              device: torch.device) -> list[CompressedChunk]:
        """The full-device parity engine (ops/deflate_encode.py): K1 on the
        device, the native Huffman build, K2 on the device; the chunk
        checksums on the device from the same staged batch (the
        reference's hardware returns the checksum with each request)."""
        from qatzip_tpu_torch.ops import checksums as cksum

        n = params.hw_buff_sz
        depth, kwords = de.level_params(params.comp_lvl)
        allow_dynamic = params.huffman_hdr == QzHuffmanHdr.QZ_DYNAMIC_HDR
        m_words = de.words_bound(n)
        checksum = (cksum.adler32_blocks
                    if _checksum_kind(params) == "adler32"
                    else cksum.crc32_blocks)

        # submit everything, then collect in order: batch k+1's device
        # work queues while batch k's results come back
        bsz = _batch_size(len(chunks), self.MAX_BATCH)
        pending: list[tuple] = []
        for start in range(0, len(chunks), bsz):
            batch = list(chunks[start:start + bsz])
            try:
                # one staged upload, a slice a device, feeds the encoder
                # and the checksum
                staged = _submit(batch, n, device, lambda d, l: (d, l))
                data = [d for d, _ in staged]
                words, bits, mode = de.encode_blocks(
                    data, [l for _, l in staged], depth, kwords,
                    allow_dynamic, m_words, mesh=[d.device for d in data])
                cks = [checksum(d, l, n) for d, l in staged]
                pending.append((batch, words, bits, mode, cks))
            except faults.FAILOVER:
                # mid-request per-batch reroute (compInSWFallback analog):
                # only this batch goes to the CPU
                health.record_failure()
                pending.append((batch, None, None, None, None))

        out: list[CompressedChunk] = []
        for batch, words, bits, mode, cks in pending:
            if words is None:
                out.extend(_cpu_compress_batch(batch, params))
                continue
            try:
                words = shard.gather(words).astype(np.uint32)
                bits = shard.gather(bits)
                cks = shard.gather(cks)
            except faults.FAILOVER:
                health.record_failure()
                out.extend(_cpu_compress_batch(batch, params))
                continue
            health.record_success()
            for i, c in enumerate(batch):
                if mode[i] == de.MODE_STORED:
                    payload = _stored_block(c)
                else:
                    payload = words[i].tobytes()[:(int(bits[i]) + 7) // 8]
                out.append(CompressedChunk(payload, int(cks[i]), len(c)))
        return out

    def decompress_chunks(self, payloads, hints, params: InternalParams,
                          device: torch.device) -> list[DecompressedChunk]:
        """Device inflate with per-chunk CPU failover (the reference's
        decompOutSWFallback): chunks the decoder flags as unprovable are
        re-inflated with zlib.  The lockstep engine's chunk checksums are
        computed on the host over each decoded part; the speculative
        engine (QATZIP_TPU_INFLATE=spec) returns them from the device."""
        from qatzip_tpu_torch.ops import deflate_decode as dd

        kind = _checksum_kind(params)
        bsz = (self.MAX_DECODE_BATCH
               if os.environ.get("QATZIP_TPU_INFLATE", "lockstep") == "spec"
               else self.LOCKSTEP_BATCH)
        out: list[DecompressedChunk] = []
        for start in range(0, len(payloads), bsz):
            batch = payloads[start:start + bsz]
            bh = hints[start:start + bsz]
            try:
                faults.check("submit", "decompress")
                ran: list = []
                results = dd.inflate_batch(batch, bh, device, kind=kind,
                                           ran_out=ran)
                faults.check("death", "decompress")
                if ran:
                    # only a round that reached the device is evidence of
                    # health; an all-pre-failed batch is not
                    health.record_success()
            except faults.FAILOVER:
                # device dispatch failure: per-batch reroute to the CPU
                # (decompInSWFallback analog)
                health.record_failure()
                results = [None] * len(batch)
            for i, (payload, hint, r) in enumerate(zip(batch, bh, results)):
                if r is None:
                    try:
                        data, eof = _cpu_inflate(bytes(payload), hint)
                    except zlib.error as exc:
                        raise RefusedStream(f"chunk {start + i}: {exc}") \
                            from exc
                    ckv = _chunk_checksum(data, params)
                else:
                    data, eof, ckv = r
                    if faults.armed() and data and \
                            faults.should_fire("poison", "decompress"):
                        # simulated corruption of decoded output: the
                        # engine's checksum/size verification must catch it
                        bad = bytearray(data)
                        bad[len(bad) // 2] ^= 0x55
                        data = bytes(bad)
                        ckv = None
                    if ckv is None:
                        ckv = _chunk_checksum(data, params)
                    if faults.armed() and \
                            faults.should_fire("checksum", "decompress"):
                        ckv ^= 0xDEAD  # checksum-engine fault, good payload
                out.append(DecompressedChunk(data, ckv, eof))
        return out


class Lz4DeviceCodec:
    """LZ4 frame / LZ4s block codec: the deflate match finder and select
    kernel find candidates, the native host code emits LZ4 sequences, and
    ops/lz4_decode.py decodes blocks on the device."""

    MAX_BATCH = 128

    def compress_chunks(self, chunks: Sequence[bytes], params: InternalParams,
                        device: torch.device) -> list[CompressedChunk]:
        """Hybrid compress (the reference's default branch): device
        candidates, native ``lz4_candidates``; with QATZIP_TPU_ENCODER=device
        the device encoder's K1 under LZ4 rules (``_lz4_analyze``) and the
        native ``lz4_assemble``.  Unlike deflate, LZ4 keeps the match
        finder's stride (QATZIP_TPU_MF_STRIDE, default 1) at every level,
        as the reference does."""
        from qatzip_tpu_torch.formats.lz4_fmt import gen_lz4_block_header
        from qatzip_tpu_torch.ops import match_finder as mf

        n = params.hw_buff_sz
        depth, kwords = de.level_params(params.comp_lvl)
        is_lz4s = params.data_fmt == DataFormatInternal.LZ4S_BK
        mode = 1 if is_lz4s else 0
        mini = params.lz4s_mini_match if is_lz4s else 4
        hybrid = os.environ.get("QATZIP_TPU_ENCODER", "hybrid") == "hybrid"

        def run(data, lens):
            faults.check("submit", "compress")
            if hybrid:
                return mf.find_candidates(data, lens, depth)
            return _lz4_analyze(data, lens, depth, kwords)

        bsz = _batch_size(len(chunks), self.MAX_BATCH)
        pending: list[tuple] = []
        for start in range(0, len(chunks), bsz):
            batch = list(chunks[start:start + bsz])
            try:
                pending.append((batch, _submit(batch, n, device, run)))
            except faults.FAILOVER:
                health.record_failure()
                pending.append((batch, None))

        out: list[CompressedChunk] = []
        for batch, rec in pending:
            if rec is None:
                out.extend(_cpu_compress_batch(batch, params))
                continue
            try:
                arr = shard.gather(rec)
            except faults.FAILOVER:
                health.record_failure()
                out.extend(_cpu_compress_batch(batch, params))
                continue
            health.record_success()

            def assemble(i_c):
                i, c = i_c
                if hybrid:
                    payload = native.lz4_candidates(c, arr[i, :len(c)], mode,
                                                    mini)
                else:
                    payload = native.lz4_assemble(c, arr[i, :len(c)], mode,
                                                  mini)
                ckv = _chunk_checksum(c, params)
                if is_lz4s:
                    return CompressedChunk(payload, ckv, len(c))
                # LZ4 frame block section with the stored-block escape
                if len(payload) >= len(c):
                    blk = gen_lz4_block_header(len(c), stored=True) + c
                else:
                    blk = gen_lz4_block_header(len(payload),
                                               stored=False) + payload
                return CompressedChunk(blk, ckv, len(c))

            out.extend(_map_chunks(assemble, list(enumerate(batch))))
        return out

    def decompress_chunks(self, payloads, hints, params: InternalParams,
                          device: torch.device) -> list[DecompressedChunk]:
        """Host frame-block walk (stored blocks copy through), a batched
        device decode of every compressed block, per-block CPU failover
        for the blocks the decoder flags (``lz4_decode.failover_blocks``),
        and each chunk's XXH32.  A traced request gets one ``lz4.batch``
        span a call [blocks], the blocks decoded on the CPU on its
        ``failover_lanes``, holding in turn ``lz4.walk`` [frames], the
        decoder's spans, ``lz4.assemble`` (each chunk's bytes put together
        from its blocks, a failed-over block decoded on the CPU;
        [chunks]) and ``lz4.checksum`` [bytes hashed]."""
        from qatzip_tpu_torch.ops import lz4_decode

        is_lz4s = params.data_fmt == DataFormatInternal.LZ4S_BK
        mini = params.lz4s_mini_match if is_lz4s else None
        rec = tls.rec
        span = rec.open("lz4.batch") if rec is not None else None
        walk = rec.open("lz4.walk") if rec is not None else None

        plan = []       # per chunk: list of ("raw", bytes) | ("blk", idx)
        blocks: list[bytes] = []
        stored = 0
        for payload in payloads:
            pv = memoryview(payload)
            items = []
            if is_lz4s:
                items.append(("blk", len(blocks)))
                blocks.append(bytes(pv))
            else:
                off = 0
                while off + 4 <= len(pv):
                    (bsz,) = struct.unpack_from("<I", pv, off)
                    off += 4
                    if bsz == 0:
                        break
                    is_stored = bool(bsz & 0x80000000)
                    bsz &= 0x7FFFFFFF
                    blk = bytes(pv[off:off + bsz])
                    off += bsz
                    if is_stored:
                        items.append(("raw", blk))
                        stored += 1
                    else:
                        items.append(("blk", len(blocks)))
                        blocks.append(blk)
            plan.append(items)
        lz4_decode.count_stored(stored)
        decoded = [None] * len(blocks)
        if walk is not None:
            rec.close(walk, len(payloads))
        if blocks:
            try:
                faults.check("submit", "decompress")
                decoded = lz4_decode.decode_blocks(blocks, mini_match=mini,
                                                   device=device)
                if any(d is not None for d in decoded):
                    health.record_success()
            except faults.FAILOVER:
                health.record_failure()

        put = rec.open("lz4.assemble") if rec is not None else None
        datas = []
        for hint, items in zip(hints, plan):
            parts = []
            for kind_i, v in items:
                if kind_i == "raw":
                    parts.append(v)
                    continue
                d = decoded[v]
                if d is None:
                    maxo = hint if hint and hint > 0 else 1 << 22
                    try:
                        d = (lz4s_block_decompress(blocks[v], maxo, mini)
                             if is_lz4s else
                             lz4_block_decompress(blocks[v], maxo))
                    except ValueError as exc:
                        raise RefusedStream(f"block {v}: {exc}") from exc
                parts.append(d)
            datas.append(parts[0] if len(parts) == 1 else b"".join(parts))
        if put is not None:
            rec.close(put, len(datas))
        check = rec.open("lz4.checksum") if rec is not None else None
        out = [DecompressedChunk(d, ckv, True)
               for d, ckv in zip(datas, _ck.xxh32_each(datas))]
        if span is not None:
            rec.close(check, sum(len(d) for d in datas))
            span.failover_lanes += decoded.count(None)
            rec.close(span, len(blocks) + stored)
        return out


def _lz4_analyze(data, lengths, depth: int, kwords: int) -> torch.Tensor:
    """Device K1 under LZ4 parse rules; per-position (mlen<<15|dist)
    records (int32) for the host assembler."""
    sel, take, mlen, mdist, _f1, _f2 = de.analyze_blocks(
        data, lengths, depth, kwords, lz4_rules=True)
    return (mlen << 15) | mdist


# CPU fallbacks and checksums: copies of the helpers of
# qatzip_tpu/ops/device_codecs.py
def _cpu_inflate(payload: bytes, hint: int) -> tuple[bytes, bool]:
    do = zlib.decompressobj(-15)
    data = do.decompress(payload) + do.flush()
    return data, do.eof


def _cpu_compress_batch(batch, params) -> list[CompressedChunk]:
    """CPU fallback for one failed device batch (same wire contract)."""
    return CpuBackend().compress_chunks(batch, params)


def _checksum_kind(params: InternalParams) -> str:
    fmt = params.data_fmt
    if fmt == DataFormatInternal.DEFLATE_ZLIB:
        return "adler32"
    if fmt in (DataFormatInternal.LZ4_FH, DataFormatInternal.LZ4S_BK):
        return "xxh32"
    return "crc32"


def _chunk_checksum(chunk: bytes, params: InternalParams) -> int:
    kind = _checksum_kind(params)
    if kind == "adler32":
        return zlib.adler32(chunk) & 0xFFFFFFFF
    if kind == "xxh32":
        return _ck.xxh32(chunk, 0)
    return zlib.crc32(chunk) & 0xFFFFFFFF


def register_all() -> None:
    from qatzip_tpu_torch.ops import registry

    deflate = DeflateDeviceCodec()
    for fmt in (DataFormatInternal.DEFLATE_4B, DataFormatInternal.DEFLATE_GZIP,
                DataFormatInternal.DEFLATE_GZIP_EXT,
                DataFormatInternal.DEFLATE_RAW,
                DataFormatInternal.DEFLATE_ZLIB):
        registry.register(fmt, "compress", deflate)
        registry.register(fmt, "decompress", deflate)
    lz4 = Lz4DeviceCodec()
    for fmt in (DataFormatInternal.LZ4_FH, DataFormatInternal.LZ4S_BK):
        registry.register(fmt, "compress", lz4)
        registry.register(fmt, "decompress", lz4)
