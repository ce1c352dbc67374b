#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (qatzip_tpu_torch) once on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Environment: torch/CUDA versions, the card's name and power limit, the
   native host codec (libqzcore.so) and the CUDA kernel build, timed.
2. Each kernel against its plain torch version, on the card, at the shapes
   the main path gives it, on the pinned 32 MB corpus
   (qatzip_tpu_torch/tools/corpus.py, a copy of bench.build_corpus): both
   entries of the candidate select (sorted order, and position order, the
   one the match finder runs) on the sorted records of the first 128 chunks
   of 64 KB (depth 16 / stride 2, the L1 default, and depth 8 / stride 1),
   timed beside the chain the position-order entry replaces (the sorted
   select, then a where, a scatter and a cast); and the lockstep inflate on
   zlib level-1 payloads in one round of 128 lanes (the reference's width)
   and one of 512 (the port's, every chunk of the request).  Outputs must be
   equal; both are timed with CUDA events and printed beside their bound
   (bytes moved at the HBM rate, operations at the float32 rate: for the
   select, the look-back steps these rows need), the inflate also beside
   the probes' measured STEP5 skeleton and dependent load (below).  The
   u32 sort kernel, which no path runs yet, on the unsorted sort-1 records
   of the same chunks at stride 2 and 1 ([128, 32768] and [128, 65536]),
   on random unique keys beyond one
   cluster ([4, 262144]) and with 4 payloads ([128, 32768]): equal to its
   plain version, timed the same way, its device operations a call counted
   with torch.profiler (one kernel at the two sort-1 shapes) and its
   clusters' occupancy printed.  The LZ4 block-decode kernel
   (csrc/lz4_block.cu) against its plain version on the same tensors, on
   the corpus's first 128 LZ4 blocks (the path's group), 128 LZ4s blocks of
   incompressible 64 KB chunks (about 65.8 KB each, n = 131072) and the
   edge cases of tools/lz4_cases.py with mutated corpus blocks, as LZ4 and
   as LZ4s: err equal on every row, tot and bytes on every clear row, which
   the host decoder gives too; then every compressed block of the 32 MB
   LZ4 frame (about 400) in one launch, the request's, against the plain
   version run group by group on the same rows; each launch timed with
   CUDA events beside the plain version, its bound (bytes at the HBM rate)
   and, for the corpus's, its latency bound (the block with the most
   sequences at one dependent shared-memory load a sequence, the probes'
   measure); the kernel's ptxas report (registers, shared memory, spills)
   and the CTAs the card holds a SM; then the first group through
   decode_blocks, equal to its chunks.  The construct probes
   (tools/probe_bench.py): the STEP5, TOKENS tile, COLUMN, STEP3, INDEP,
   BITONIC, 64K row sort, HASH, EW and DOUBLE kernels' loops read from the
   library's SASS; ROLL, REFILL, TRANSPOSE, DEP, COLUMN, STEP3, STEP5,
   TOKENS, INDEP, BITONIC and the 64K row sort under sync debug mode
   "error" and replayed from a CUDA graph, the launch floor (an empty
   kernel) and the host pieces of a launch, then every probe equal to its
   plain version (a latency bound beside the latency-bound ones; the 64K
   row sort also on full-range keys with negatives and repeats), timed
   host-paced and graph-replayed beside its PyTorch call, and slope-timed
   (TRANSPOSE and the row sort with the SMs their clusters ran on).
3. Calibration (engine/devcal.calibrate, 8 MB, into a record of its own):
   the CPU funnel, the device codec's raw and packed compress and its
   decompress, the inflate kernel and the match finder alone.  No device or
   probe error, and every device rate above 0.
4. The DEFLATE device path through the public API: gzip-ext level 1 at
   64 KB chunks, compress then decompress the 32 MB corpus.  The launch
   counters are zeroed just before this run and must show both kernels of
   the path (the position-order select, the inflate), the decompress in
   fewer than the 16 inflate launches of 128-lane rounds; the engine must
   report device requests only, no lane may fail over to the CPU and the
   health breaker must record no failure; the output must be
   gzip-interoperable and round-trip bit-exactly; the raw candidate format
   (QATZIP_TPU_PACK=0), whatever the record of step 3 says.  Then the corpus
   once more with the packed candidate format (QATZIP_TPU_PACK=1): bytes that
   round-trip and gzip reads, GB/s and candidate D2H bytes beside the raw
   format's.
5. The LZ4 device path through the public API: an LZ4-frame session at
   level 1 and 64 KB chunks on the 32 MB corpus, then an LZ4s session
   (mini match 3) on 8 MB of it.  Each must launch the select kernel once
   a 128-chunk batch and the LZ4 decode kernel once in its first
   decompress (the count zeroed just before it), run on the device only,
   never run the plain decode on the card, fail no block over to the CPU,
   record no health failure, round-trip bit-exactly, and be readable by
   the software path.
6. The rest of the qz* surface through the public API, gzip-ext and 4B at
   level 1 and 64 KB chunks, the device route forced and the raw candidate
   format, the launch counts zeroed before each step: stream compress of
   8 MB in 1 MB pieces (gzip-ext and 4B; the select kernel at least once a
   stream buffer) and the 4B stream decompressed piecemeal; eight 4 MB
   slices through qz_compress2 and then qz_decompress2 from two submitter
   threads (completed in submission order, equal to the one-shot
   results); the metadata API over the 32 MB corpus at 64 KB blocks (every
   block's CRC32/CRC64, the decompress in one batch of at most 512 lanes a
   launch, no more launches than the one-shot decompress of step 4); the
   CRC64 variants; and qzip -k -O gzip and -d in this process, then once
   as a child (python3 -m qatzip_tpu_torch.cli.qzip).  Each step must
   launch the kernels it reaches, run no software request or result, fail
   no lane over and record no health failure, and round-trip exactly; its
   GB/s is printed beside the card's name and power limit, and the
   kernels line carries each step's launches (``api_launches``).
7. The parity engines and the multi-device and multi-process layer, the
   device route forced, the launch counts zeroed before each part, each
   part's wall time, GB/s and launches on a line of its own: the device
   encoder (QATZIP_TPU_ENCODER=device) on the 32 MB corpus, gzip-ext and
   LZ4 frame (gzip and the native LZ4 decoder read the streams, every
   chunk CRC32 equals zlib's, the codec's output for the first 1 MB equals
   the CPU device's, the chain-walk kernel launched once a batch and the
   checksum kernel once a gzip-ext batch); the speculative decoder
   (QATZIP_TPU_INFLATE=spec) on the 32 MB gzip-ext stream (exact, its
   device CRC32s equal zlib's, both kernels launched once a round); the
   device checksums on a [128, 65536] batch of ragged lengths and on a
   spec round's [8, 65536] against zlib and their plain versions, with
   int32 and int64 lengths; the chain-walk kernel against its plain
   version on the maps the encoder and the decoder build from the
   corpus's first chunks (its cluster path) and on maps of steps of 1 at
   [128, 65536], [8, 2^18], [8, 2^19] (the cluster path) and [8, 2^20] (the
   three-launch row path), timed by phase beside its bytes and latency
   bounds (the row path's phase-B load time probed on a [1, 2^22] map; the
   dependent shared-memory load in a CTA's own and in its cluster
   sibling's memory by qz_chain_probe); the device profile of each engine's 32 MB pass
   (``parity profile`` lines); block-DP over [cuda:0]
   (compress_blocks_sharded equal to encode_blocks, graft_entry.entry()
   launching the select kernel, graft_entry.dryrun_multichip(1),
   shard.scaling_report); and two ranks of tools/dist_worker.py on the card
   over gloo, 32 MB gzip-ext then 8 MB LZ4 frame through the distributed
   engine: each rank launches select, inflate and the LZ4 decode with no
   software request or failover, the assembled stream equals this process's
   single-process stream, per-rank and total GB/s and the share of the time
   outside the ranks' own work.
   The kernels line carries each part's launches (``parity_dist_launches``)
   and the records of ``chain_walk`` and ``checksums`` (their launches in
   each engine part beside the engine's batches or rounds).
8. The failure and edge paths of the select and inflate kernels, the
   device route forced, the launch counts, failed-over lanes and blocks and
   health failures zeroed before each part and the engine's software
   requests read, each part's wall time and counts on a line of its own
   (``edges ...``): (1) one lockstep round of 128 lanes of 16 KB zlib-L1
   chunks, a third corrupted past their dynamic header, one in eight
   truncated, a few idle, the kernel equal to its plain version on all
   five outputs, then step 2's clean 512-lane round again, unchanged;
   (2) the corpus compressed gzip-ext and 9 mutated copies (point
   mutations, truncation, a spliced window, as tests/test_fuzz.py)
   decompressed on the card: the reference's rc class, a prefix of the
   input on QZ_OK, inflate launched, no batch failed over (no health
   failure, no software request), no more lanes failed over than chunks
   touched; (3) the boundary lengths of tests/test_sweep.py x text, random
   and constant through the device codec (the select kernel at every
   non-empty length), and gzip, gzip-ext, raw, 4B and zlib at L1 and L9 on
   1 MB through the API, bytes equal to the CPU-tensor route's, read back
   on the card; (4) injected faults: submit, death and poison on compress,
   poison and checksum on decompress, then the breaker tripped, a request
   on the software route with no launch, and past the cooldown (its clock
   moved) the probe that revives the device; (5) four threads compressing
   and decompressing 8 MB each on cuda:0 at once, equal to the serial run;
   (6) the 8 MB LZ4-frame stream with mutated blocks through the LZ4
   decode kernel: the blocks the card fails over are the ones the native
   decoder refuses.  The kernels line carries each part's launches
   (``edge_launches``).
9. A profiled pass of each direction of the gzip-ext and LZ4 sessions:
   device busy time (torch's work from the profiler, the port's kernels
   from CUDA events around each launch) against the unprofiled wall time,
   each kernel's time in the request, and the host functions that take
   the time.
10. Routing: one gzip-ext request each way with QATZIP_TPU_DEVICE unset,
   routed by the record of step 3; prints which backend took each
   direction, which must be the one the record names.

Prints the kernels' JSON line and the card's line before the last line,
which is {"ok": true, "device": {...}}.  Any failed check raises, so the
script exits non-zero; without a CUDA device it exits 2 and prints no
result.
"""
from __future__ import annotations

import cProfile
import gzip
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time
import zlib

CHUNK = 64 << 10
LANES = 128            # the reference's lanes a round and chunks a batch
EDGE_LANE = 16 << 10   # step 8's corrupt round: 16 KB zlib-L1 chunks a lane
EDGE_SEED = 10         # step 8's mutations
CHAIN_PROBE = 1 << 22  # step 7's probe of the chain walk's dependent load
_ROUNDS: dict = {}     # step 2's inflate rounds by lanes: inputs, outputs


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current CUDA stream."""
    import torch

    fn()  # warm
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds a call of fn, from one replay of a CUDA
    graph of reps calls: the kernels alone, without the host's cost of
    launching them through Python."""
    import torch

    fn()  # warm: builds, binds and sets kernel attributes outside capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def phase_environment(torch):
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"gpu: {_gpu_line()}")
    from qatzip_tpu_torch.ops import _build
    from qatzip_tpu_torch.ops import deflate_decode as dd

    # the port's device path requires the native codec (libqzcore.so): the
    # import above raises where it cannot be built
    print(f"native host codec: {dd._native._path}")

    t0 = time.perf_counter()
    path = _build.build(force=True)
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({path})")
    with open(_build.log_path()) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def _first_chunks(torch, corpus: bytes, dev):
    """The match finder's input for the first 128 chunks: uint8[128, 64 K
    + 8] and their lengths, on the card."""
    import numpy as np

    arr = np.frombuffer(corpus[:LANES * CHUNK], np.uint8).reshape(LANES, CHUNK)
    data = torch.zeros((LANES, CHUNK + 8), dtype=torch.uint8, device=dev)
    data[:, :CHUNK] = torch.from_numpy(arr.copy()).to(dev)
    lens = torch.full((LANES,), CHUNK, dtype=torch.int32, device=dev)
    return data, lens


def phase_select(torch, corpus: bytes, dev) -> list:
    """Both entries of the select kernel against their plain versions on the
    sorted records of the first 128 chunks, at depth 16 / stride 2 (the L1
    path) and depth 8 / stride 1; timed beside the chain the position-order
    entry replaces and their bounds.  Returns the records of the
    position-order entry (the main path's) and the sorted-order one at the
    L1 shape."""
    from qatzip_tpu_torch.ops import match_finder as mf
    from qatzip_tpu_torch.ops import select as S
    from qatzip_tpu_torch.tools import select_bench as SB

    data, lens = _first_chunks(torch, corpus, dev)
    recs = {}
    for depth, stride in ((16, 2), (8, 1)):
        t = mf.sorted_records(data, lens, stride, True)
        ker = S.select_candidates(*t, depth)
        ref = S.select_candidates_ref(*t, depth)
        pos = S.select_to_positions(*t, depth, CHUNK).view(torch.int16)
        pos_ref = S.select_to_positions_ref(*t, depth, CHUNK).view(torch.int16)
        torch.cuda.synchronize()
        _check(torch.equal(ker, ref),
               f"select kernel != plain at depth {depth} stride {stride}")
        _check(torch.equal(pos, pos_ref),
               f"select_to_positions != plain at depth {depth} stride "
               f"{stride}")
        err = int((ker.to(torch.int64) - ref).abs().max())
        pos_err = int((pos.to(torch.int32) - pos_ref).abs().max())
        ms = _time_ms(lambda: S.select_candidates(*t, depth), 50)
        pos_ms = _time_ms(lambda: S.select_to_positions(*t, depth, CHUNK), 50)
        # what the position-order entry replaces: the sorted-order select,
        # then the where, scatter and cast of to_positions
        chain_ms = _time_ms(lambda: S.to_positions(
            t[0], S.select_candidates(*t, depth), CHUNK), 50)
        plain_ms = _time_ms(lambda: S.select_candidates_ref(*t, depth), 10)
        pos_plain_ms = _time_ms(
            lambda: S.select_to_positions_ref(*t, depth, CHUNK), 10)
        # bound: inputs read once, outputs written once, the look-back's
        # operations on these rows (the steps its early exits leave)
        w = SB.work(*t, depth)
        wp = SB.work(*t, depth, CHUNK)
        print(f"select depth {depth} stride {stride} records "
              f"{tuple(t[0].shape)}: both entries equal to plain; sorted "
              f"order {ms:.4f} ms (plain {plain_ms:.4f}, bound "
              f"{w['bound_ms']:.4f} {w['bound_by']}); position order "
              f"{pos_ms:.4f} ms with its memset (plain {pos_plain_ms:.4f}, "
              f"bound {wp['bound_ms']:.4f} {wp['bound_by']}), the chain it "
              f"replaces (select + where, zeros, scatter_, cast) "
              f"{chain_ms:.4f} ms; look-back steps {w['steps']} "
              f"({w['steps'] / t[0].numel():.3f} a record), nonzero "
              f"{int((ker > 0).sum())}")
        if not recs:   # the L1 main path's shape
            common = {"route": "cuda",
                      "source": "qatzip_tpu_torch/csrc/select.cu",
                      "replaces": "qatzip_tpu/ops/pallas_select.py:89",
                      "library_ms": None}
            recs["select_to_positions"] = {
                "name": "select_to_positions", **common, "path": "deflate",
                "max_abs_err": pos_err, "ms": pos_ms,
                "plain_ms": pos_plain_ms, "bound_ms": wp["bound_ms"],
                "bound_by": wp["bound_by"], "chain_ms": chain_ms}
            recs["select_candidates"] = {
                "name": "select_candidates", **common, "path": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": w["bound_ms"], "bound_by": w["bound_by"]}
    return [recs["select_to_positions"], recs["select_candidates"]]


def phase_probes(torch, dev) -> list:
    """The construct probes' library built, and the loops of the kernels
    of probe_bench.SASS_KERNELS (STEP5, the TOKENS tile, COLUMN, STEP3,
    INDEP, BITONIC, the 64K row sort, HASH, EW, DOUBLE) read from its SASS
    (instructions, shared-memory loads, shuffles and the dependent chain a
    step); the ROLL, REFILL, TRANSPOSE, DEP, COLUMN, STEP3, STEP5, TOKENS,
    INDEP, BITONIC and 64K row sort wrappers under sync debug mode "error"
    and replayed from a CUDA graph; then the launch floor, the host pieces of a launch and every
    case of tools/probe_bench.py: the kernel equal to its plain version, timed
    host-paced and graph-replayed beside its PyTorch call, and slope-timed
    (ns and clock64() ticks a unit).  Returns the cases' records."""
    from qatzip_tpu_torch.ops import _build
    from qatzip_tpu_torch.tools import probe_bench as PB

    t0 = time.perf_counter()
    path = _build.build(force=True, name=_build.PROBES)
    _build.library(_build.PROBES)
    print(f"probe build: {time.perf_counter() - t0:.2f} s ({path})")
    sass = PB.sass_report({"this": path})
    _check(len(sass) == len(PB.SASS_KERNELS) == 13
           and all("chain" in r for r in sass),
           "the STEP5, TOKENS tile, COLUMN, STEP3, INDEP, BITONIC, 64K row "
           "sort, HASH, EW and DOUBLE kernels' loops not found in the SASS")
    PB.graph_safe(dev)
    t0 = time.perf_counter()
    recs = PB.run(dev)
    print(f"probes: {len(recs)} cases equal to their plain versions in "
          f"{time.perf_counter() - t0:.1f} s")
    return recs


def _inflate_round(torch, corpus: bytes, dev, lanes: int,
                   probes: list) -> dict:
    """One lockstep round over the first block of each of the first
    ``lanes`` chunks at zlib level 1: the kernel against the plain version
    (once, it takes ~30 s) on all five outputs, then timed; beside it the
    STEP5 probe's measured ns a step (the port's redesigned skeleton, at
    these lanes, one lane a CTA) and the DEP probe's dependent
    shared-memory load."""
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import inflate as PI
    from qatzip_tpu_torch.tools import probe_bench as PB
    from qatzip_tpu_torch.tools.h100 import FP32_OPS_S, HBM_BYTES_S

    streams = []
    for i in range(lanes):
        chunk = corpus[i * CHUNK:(i + 1) * CHUNK]
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        s = dd._Stream(co.compress(chunk) + co.flush(), len(chunk), i)
        _check(dd._parse_one_header(s) == "huff", "expected a Huffman block")
        streams.append(s)
    live, inputs = dd.pack_round(streams)
    _check(len(live) == lanes, "every lane must take part in the round")
    words, bit0, nbits, tll, td, active, max_steps = inputs
    t = PI.upload(words, bit0, nbits, tll, td, active, dev)
    ker = PI.decode_lockstep(*t, max_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = PI._decode_ref(*t, max_steps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    names = ("tokens", "err", "outcnt", "end_bit", "nsteps")
    for name, a, b in zip(names, ker, ref):
        _check(torch.equal(a, b),
               f"inflate kernel != plain in {name} at {lanes} lanes")
    ns = int(ker[4][0])
    _check(not bool(ker[1].any()), "a lane of the round errored")
    _ROUNDS[lanes] = (t, max_steps, ker)
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(ker, ref))
    ms = _time_ms(lambda: PI.decode_lockstep(*t, max_steps), 5)
    # the tables' staging and one step: the launch's fixed cost
    ms1 = _time_ms(lambda: PI.decode_lockstep(*t, 1), 20)
    lane_steps = ker[0][:ns].ne(0).sum(0)
    util = float(lane_steps.sum()) / (ns * lanes)
    out_bytes = int(ker[2].sum())
    # bound: each input read once (the stream bytes, the tables), each
    # output written once (the ns token rows the host reads, err, outcnt,
    # end_bit); ~60 integer operations a lane step at the float32 rate
    nbytes = (int(nbits.sum()) // 8 + tll.nbytes + td.nbytes
              + ns * lanes * 4 + 3 * lanes * 4)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = float(lane_steps.sum()) * 60 / FP32_OPS_S * 1e3
    step_ns = PB.step_skeleton_ns(probes, lanes)
    dep_ns = PB.dep_load_ns(probes)
    print(f"inflate round: {lanes} lanes, max_steps {max_steps}, nsteps "
          f"{ns}, {out_bytes} output bytes: equal on all five outputs; "
          f"kernel {ms:.4f} ms ({ms / ns * 1e6:.1f} ns a step, "
          f"{out_bytes / ms / 1e6:.4f} GB/s), staging + 1 step {ms1:.4f} ms, "
          f"plain {plain_ms:.1f} ms (one run); lane utilisation {util:.4f} "
          f"(token steps / (nsteps x lanes)); bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({nbytes} bytes; operations "
          f"{ops_ms:.4f} ms); measured primitives: the port's STEP5 "
          f"skeleton (the TPU probe's step over entries widened while "
          f"staged, compile-time shapes) {step_ns:.3f} ns a step (not a "
          f"floor: it does work this step does not), a dependent "
          f"shared-memory load {dep_ns:.3f} ns")
    return {"name": "inflate_decode", "route": "cuda",
            "source": "qatzip_tpu_torch/csrc/inflate.cu",
            "replaces": "qatzip_tpu/ops/pallas_inflate_kernel.py:228",
            "path": "deflate", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "lanes": lanes, "nsteps": ns,
            "lane_utilisation": util}


def phase_inflate(torch, corpus: bytes, dev, probes: list) -> dict:
    """The inflate kernel at the reference's 128 lanes and at the port's
    round width, which takes every chunk of the 32 MB request at once;
    returns the record at the port's width (the main path's shape)."""
    from qatzip_tpu_torch.ops import device_codecs as dc
    from qatzip_tpu_torch.tools import probe_bench as PB

    width = dc.DeflateDeviceCodec.LOCKSTEP_BATCH
    _check(width * CHUNK <= len(corpus), "the corpus is narrower than a round")
    _check(width == PB.INFLATE_LANES, "the probes time another round width")
    rec128 = _inflate_round(torch, corpus, dev, LANES, probes)
    rec = _inflate_round(torch, corpus, dev, width, probes)
    print(f"inflate: {width} lanes a round take {rec['ms']:.4f} ms, "
          f"{LANES} lanes {rec128['ms']:.4f} ms")
    return rec


def _device_ops(torch, fn) -> dict:
    """The device operations one call of fn runs, by kind, from
    torch.profiler: sort kernels, other kernels, memcpys."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {"sort_kernels": 0, "other_kernels": 0, "memcpys": 0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = ("memcpys" if "Memcpy" in e.key or "Memset" in e.key else
                "sort_kernels" if "qz_sort" in e.key else "other_kernels")
        ops[kind] += e.count
    return ops


def phase_sort(torch, corpus: bytes, dev) -> dict:
    """The u32 sort kernel on the match finder's sort-1 input at stride 2
    and 1, then on random unique keys at a shape beyond one cluster and
    with 4 payloads, and on keys alone (full-range, with repeats) at [1,
    65536] and [32, 65536].  No path calls it, so its launches are this
    phase's own checked calls."""
    from qatzip_tpu_torch.ops import match_finder as mf
    from qatzip_tpu_torch.ops import sort as S
    from qatzip_tpu_torch.tools import sort_bench as SB
    from qatzip_tpu_torch.tools.h100 import FP32_OPS_S, HBM_BYTES_S

    data, lens = _first_chunks(torch, corpus, dev)
    cases = []
    for stride in (2, 1):
        key1, b4, b4b = mf.hash_records(data, lens, stride, True)
        # payloads need unique keys: the invalid records (0xFFFFFFFF, the
        # last positions of a chunk) take 0xFFFF0000 | column instead,
        # which still sorts after every valid key (h15 << 16 | pos16)
        col = torch.arange(key1.shape[1], dtype=torch.int32, device=dev)
        keys = torch.where(key1 == -1, col - 65536, key1)
        cases.append((f"stride {stride}", [keys, b4, b4b]))
    cases.append(("beyond one cluster", SB.inputs(4, 262144, 2, 1, dev)))
    cases.append(("4 payloads", SB.inputs(128, 32768, 4, 2, dev)))
    g = torch.Generator().manual_seed(20)
    for B in (1, 32):   # no payloads: a cluster of 2 CTAs of 32768 keys
        keys = torch.randint(-2**31, 2**31 - 1, (B, 65536), generator=g,
                             dtype=torch.int32)
        keys[:, 1::2] = keys[:, ::2]
        cases.append((f"keys only, {B} rows", [keys.to(dev)]))
    S.KERNEL.launches = 0
    rec = None
    for label, t in cases:
        ker = S.sort_u32(*t)
        ref = S.sort_u32_ref(*t)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(ker, ref)):
            _check(torch.equal(a, b),
                   f"sort kernel != plain in array {i} ({label})")
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(ker, ref))
        launches = S.KERNEL.launches
        B, n = t[0].shape
        info = S.cluster_info(n, len(t) - 1)
        ops = _device_ops(torch, lambda: S.sort_u32(*t))
        ms = _time_ms(lambda: S.sort_u32(*t), 20)
        plain_ms = _time_ms(lambda: S.sort_u32_ref(*t), 20)
        # the kernel alone, in place on one copy (the network does the same
        # work on sorted rows)
        outs = [x.clone() for x in t]
        ptrs = [o.data_ptr() for o in outs[1:]]
        ptrs += [None] * (S.MAX_PAYLOADS - len(ptrs))
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel_ms = _time_ms(lambda: S.KERNEL(outs[0].data_ptr(), *ptrs, B,
                                              n, len(t) - 1, stream), 20)
        S.KERNEL.launches = launches
        print(f"sort {label} shape {(B, n)}, {len(t) - 1} payloads: equal; "
              f"wrapper {ms:.4f} ms (kernel alone {kernel_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms; device ops a call {ops}; cluster "
              f"{info['cluster_ctas']} CTAs x {info['cta_elems']} elements "
              f"({info['cta_smem_bytes']} B shared), max active clusters "
              f"{info['max_active_clusters']}")
        if label.startswith("stride"):
            _check(ops["sort_kernels"] == 1,
                   f"sort at {(B, n)} ran {ops} device operations")
            _check(info["max_active_clusters"] > 0,
                   f"no cluster of the sort at {(B, n)} fits the card")
        if rec is None:   # the L1 match finder's sort-1 shape
            # bound: keys and payloads read once and written once; the
            # network's n/2 x log n (log n + 1)/2 compare-exchanges a row,
            # ~3 operations a word they move, at the float32 rate
            words = len(t) * B * n
            lg = n.bit_length() - 1
            cx = B * n // 2 * lg * (lg + 1) // 2
            bytes_ms = 2 * 4 * words / HBM_BYTES_S * 1e3
            ops_ms = 3 * len(t) * cx / FP32_OPS_S * 1e3
            # the library's sort with the payloads gathered after it is the
            # plain version; timed again as the library's figure
            lib_ms = _time_ms(lambda: S.sort_u32_ref(*t), 20)
            rec = {"name": "sort_u32", "route": "cuda",
                   "source": "qatzip_tpu_torch/csrc/sort.cu",
                   "replaces": "qatzip_tpu/ops/pallas_sort.py:113",
                   "path": None, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": ("bytes" if bytes_ms >= ops_ms
                                else "operations"),
                   "library_ms": lib_ms,
                   "device_kernels_per_call": ops["sort_kernels"]}
            print(f"  sort bound {rec['bound_ms']:.4f} ms (bytes "
                  f"{bytes_ms:.4f}, operations {ops_ms:.4f}); torch.sort + "
                  f"gathers {lib_ms:.4f} ms")
    rec["checked_calls"] = S.KERNEL.launches
    return rec


def _lz4_group_vs_plain(torch, label: str, blocks: list, lz4s: bool,
                        dev, want: list | None = None,
                        dep_ns: float | None = None) -> dict:
    """One launch of blocks through the LZ4 decode kernel and its plain
    version on the same tensors on the card, the plain version in groups
    of ``lz4_decode.GROUP`` rows: err equal on every row, tot and bytes on
    every clear row, and a clear row's bytes the host decoder's; with
    ``want`` (the bytes each block must give) no row may be flagged.  Both
    timed with CUDA events; the bound is the blocks' bytes read and the
    clear rows' bytes written (and the four small arrays) at the HBM rate;
    with ``want``, also the latency bound: the block with the most
    sequences, one dependent shared-memory load (``dep_ns``, the probes'
    measure) a sequence."""
    import numpy as np

    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.ops import lz4_kernel as LK
    from qatzip_tpu_torch.tools import lz4_cases as LC
    from qatzip_tpu_torch.tools.h100 import HBM_BYTES_S

    base = 2 if lz4s else 0
    n = ld._next_pow2(max(len(b) for b in blocks) + 8, 1024)
    arr = np.zeros((len(blocks), n), np.uint8)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    b_t = torch.from_numpy(arr).to(dev)
    l_t = torch.tensor([len(b) for b in blocks], dtype=torch.int32,
                       device=dev)

    def kernel():
        return LK.decode(b_t, l_t, n, ld.MAX_OUT, lz4s, base)

    def plain():
        parts = [ld._decode_blocks_impl(b_t[g:g + ld.GROUP],
                                        l_t[g:g + ld.GROUP], n, ld.MAX_OUT,
                                        lz4s, base)
                 for g in range(0, len(blocks), ld.GROUP)]
        return [torch.cat(x) for x in zip(*parts)]

    ker = [t.cpu() for t in kernel()]
    ref = [t.cpu() for t in plain()]
    _check(torch.equal(ker[2], ref[2]),
           f"lz4 decode {label}: the kernel flags other rows than plain")
    err, out_bytes = 0, 0
    for r, blk in enumerate(blocks):
        if bool(ker[2][r]):
            _check(want is None, f"lz4 decode {label}: row {r} flagged")
            continue
        t = int(ker[1][r])
        err = max(err, abs(t - int(ref[1][r])), int(
            (ker[0][r, :t].to(torch.int32) - ref[0][r, :t].to(torch.int32))
            .abs().max()) if t else 0)
        got = ker[0][r, :t].numpy().tobytes()
        _check(got == LC.host_decode(blk, lz4s, base, ld.MAX_OUT),
               f"lz4 decode {label}: row {r} != the host decoder")
        _check(want is None or got == want[r],
               f"lz4 decode {label}: row {r} != its chunk")
        out_bytes += t
    _check(err == 0, f"lz4 decode {label}: kernel != plain by {err}")
    flagged = int(ker[2].sum())
    ms = _time_ms(kernel, 5)
    plain_ms = _time_ms(plain, 2)
    nbytes = sum(len(b) for b in blocks) + out_bytes + 13 * len(blocks)
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    rec = {"blocks": len(blocks), "n": n, "flagged": flagged,
           "output_bytes": out_bytes, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms}
    walk = ""
    if want is not None:
        # the launch lasts as long as the block with the most sequences
        rec["max_sequences"] = max(LC.count_sequences(b) for b in blocks)
        rec["latency_bound_ms"] = rec["max_sequences"] * dep_ns * 1e-6
        walk = (f"; most sequences in a block {rec['max_sequences']}, "
                f"{ms * 1e6 / rec['max_sequences']:.1f} ns a sequence, "
                f"latency bound {rec['latency_bound_ms']:.4f} ms (one "
                f"dependent shared-memory load a sequence, {dep_ns:.3f} ns)")
    print(f"lz4 decode {label}: {len(blocks)} blocks, n {n}, outcap "
          f"{ld.MAX_OUT}, {out_bytes} output bytes, {flagged} flagged; "
          f"kernel = plain on every row; kernel {ms:.4f} ms "
          f"({out_bytes / ms / 1e6:.4f} GB/s of output), plain {plain_ms:.4f}"
          f" ms, bound {bound_ms:.6f} ms ({nbytes} bytes at the HBM "
          f"rate){walk} ({_gpu_line()})")
    return rec


def _lz4_build_report(torch) -> dict:
    """The LZ4 decode kernel's ptxas report (registers, shared memory,
    spills) from the build's log, and its CTAs resident a SM from the CUDA
    runtime's occupancy count."""
    from qatzip_tpu_torch.ops import _build
    from qatzip_tpu_torch.ops import lz4_kernel as LK

    with open(_build.log_path()) as f:
        log = f.read().splitlines()
    at = [i for i, ln in enumerate(log) if "qz_lz4_kernel" in ln
          and "Compiling entry" in ln]
    _check(len(at) == 1, "no ptxas report of the LZ4 decode kernel")
    report = []
    for ln in log[at[0] + 1:]:
        if not ln.startswith(("ptxas info", " ")) or "Compiling" in ln:
            break
        report.append(ln.strip())
        print(f"lz4 decode ptxas: {ln.strip()}")
    info = LK.launch_info()
    _check(info["ctas_per_sm"] >= 3, f"the LZ4 decode kernel fits "
           f"{info['ctas_per_sm']} CTAs a SM, not the design's 3")
    print(f"lz4 decode launch: {info['threads']} threads and "
          f"{info['smem_bytes']} bytes of shared memory a CTA, "
          f"{info['ctas_per_sm']} CTAs resident a SM on {info['sms']} SMs "
          f"({info['ctas_per_sm'] * info['sms']} blocks at once)")
    return {"ptxas": report, **info}


def phase_lz4_decode(torch, corpus: bytes, dev, probes: list) -> dict:
    """The LZ4 block-decode kernel against its plain version on three kinds
    of group: the corpus's first 128 LZ4 blocks (level 1, 64 KB chunks; the
    blocks a frame does not store), the path's shape; 128 LZ4s blocks of
    incompressible 64 KB chunks (mini match 3, about 65.8 KB each, n =
    131072); and the edge cases of tools/lz4_cases.py with mutated corpus
    blocks, as LZ4 and as LZ4s.  Then every compressed block of the 32 MB
    LZ4 frame in one launch, the request's, against the plain version run
    group by group on the same rows; the kernel's ptxas report and its
    CTAs a SM; and the first group through decode_blocks, equal to its
    chunks with none flagged.  Returns the kernel's record (times of the
    first group and of the request's launch)."""
    import numpy as np

    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.tools import lz4_cases as LC
    from qatzip_tpu_torch.tools import probe_bench as PB

    build = _lz4_build_report(torch)
    dep_ns = PB.dep_load_ns(probes)
    all_chunks, all_blocks = [], []
    for i in range(0, len(corpus), CHUNK):
        chunk = corpus[i:i + CHUNK]
        blk = dd._native.lz4_compress_block(chunk)
        if len(blk) < len(chunk):
            all_chunks.append(chunk)
            all_blocks.append(blk)
    chunks, blocks = all_chunks[:ld.GROUP], all_blocks[:ld.GROUP]
    rng = np.random.default_rng(EDGE_SEED)
    rand = [rng.integers(0, 256, CHUNK, np.uint8).tobytes()
            for _ in range(ld.GROUP)]
    rand_blocks = [dd._native.lz4s_compress_block(c, 3) for c in rand]
    _check(min(len(b) for b in rand_blocks) > CHUNK,
           "an incompressible LZ4s block is not above 64 KB")
    groups = {"lz4 L1": _lz4_group_vs_plain(torch, "lz4 L1", blocks, False,
                                            dev, chunks, dep_ns),
              "lz4s incompressible": _lz4_group_vs_plain(
                  torch, "lz4s incompressible", rand_blocks, True, dev,
                  rand, dep_ns)}
    edges = [b for _, b in LC.edge_blocks()]
    for lz4s in (False, True):
        good = (blocks[:16] if not lz4s else
                [dd._native.lz4s_compress_block(c, 3) for c in chunks[:16]])
        fuzz = [LC.mutate(good[i % 16], LC.random_mutations(rng))
                for i in range(64)]
        label = "edges and fuzz " + ("lz4s" if lz4s else "lz4")
        groups[label] = _lz4_group_vs_plain(torch, label, edges + fuzz,
                                            lz4s, dev)
        _check(0 < groups[label]["flagged"] < len(edges) + len(fuzz),
               f"{label}: {groups[label]['flagged']} flagged")

    rows = ld.LAUNCH_OUT_BYTES // ld.MAX_OUT
    _check(ld.GROUP < len(all_blocks) <= rows, f"the 32 MB LZ4 frame has "
           f"{len(all_blocks)} compressed blocks, not one launch of more "
           f"than {ld.GROUP}")
    request = _lz4_group_vs_plain(torch, "lz4 L1 request", all_blocks,
                                  False, dev, all_chunks, dep_ns)

    ld.failover_blocks = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ld.decode_blocks(blocks, device=dev)
    wall = time.perf_counter() - t0
    _check(ld.failover_blocks == 0,
           f"the decoder flagged {ld.failover_blocks} of {len(blocks)} blocks")
    _check(got == chunks, "decode_blocks on the card != the chunks")
    print(f"lz4 decode: decode_blocks of the L1 group equal to its chunks, "
          f"none flagged, {wall * 1e3:.1f} ms with copies")
    main = groups["lz4 L1"]
    return {"name": "lz4_decode", "route": "cuda",
            "source": "qatzip_tpu_torch/csrc/lz4_block.cu",
            "replaces": "qatzip_tpu/ops/lz4_decode.py:42", "path": "lz4",
            "max_abs_err": max(g["max_abs_err"] for g in groups.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "latency_bound_ms": main["latency_bound_ms"],
            "request": request, "build": build, "groups": groups}


def _run(torch, sess, direction: str, src):
    """One request through the public API on the device route only;
    returns (result, seconds)."""
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.engine import core

    eng = core.engine()
    hw0, sw0 = eng.hw_requests, eng.sw_requests
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = (qt.qz_compress(sess, src) if direction == "compress"
           else qt.qz_decompress(sess, src))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _check(res.rc == qt.QZ_OK, f"{direction} rc {res.rc}")
    _check(not res.ext_rc & qt.QZ_SW_EXECUTION_MASK,
           f"{direction} ran on the software path")
    _check(eng.hw_requests > hw0 and eng.sw_requests == sw0,
           f"{direction}: hw_requests {eng.hw_requests - hw0}, "
           f"sw_requests {eng.sw_requests - sw0}")
    return res, dt


def phase_slice(torch, corpus: bytes, kernels: list, sort_rec: dict,
                probes: list):
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.engine.health import health
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import inflate_kernel as K
    from qatzip_tpu_torch.ops import select as S
    from qatzip_tpu_torch.ops import sort as SO
    from qatzip_tpu_torch.tools import probes as PR

    # the device route and the raw candidate format, whatever the
    # calibration record says (phase_routing follows the record)
    os.environ["QATZIP_TPU_DEVICE"] = "1"
    os.environ["QATZIP_TPU_PACK"] = "0"
    sess = qt.QzSession()
    _check(qt.qz_init(sess) == qt.QZ_OK, "qz_init did not return QZ_OK")
    eng = core.engine()
    _check(eng.hw_present and eng.hw_backend.device.type == "cuda",
           "engine not on a cuda backend")
    params = qt.QzSessionParamsDeflate(
        common_params=qt.QzSessionParamsCommon(comp_lvl=1, hw_buff_sz=CHUNK),
        data_fmt=qt.QzDataFormat.QZ_DEFLATE_GZIP_EXT)
    _check(qt.qz_setup_session_deflate(sess, params) == qt.QZ_OK,
           "session setup failed")
    print(f"engine: {eng.hw_backend.name} backend on {eng.device_kind}")

    # warm-up, uncounted
    warm, _ = _run(torch, sess, "compress", corpus[:LANES * CHUNK])
    _run(torch, sess, "decompress", warm.data)

    S.KERNEL.launches = 0
    S.POS_KERNEL.launches = 0
    K.KERNEL.launches = 0
    SO.KERNEL.launches = 0
    for k in PR.KERNELS.values():
        k.launches = 0
    dd.failover_lanes = 0
    comp, t_c = _run(torch, sess, "compress", corpus)
    select_launches = S.POS_KERNEL.launches
    dec, t_d = _run(torch, sess, "decompress", comp.data)
    launches = {"select_to_positions": S.POS_KERNEL.launches,
                "select_candidates": S.KERNEL.launches,
                "inflate_decode": K.KERNEL.launches,
                "sort_u32": SO.KERNEL.launches}
    launches.update({name: k.launches for name, k in PR.KERNELS.items()})

    nchunks = -(-len(corpus) // CHUNK)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    sort_rec["launches"] = launches["sort_u32"]
    for rec in probes:   # no path runs a probe
        rec["launches"] = launches[rec["kernel"]]
        _check(rec["launches"] == 0, f"the main path ran {rec['kernel']}")
    _check(launches["select_to_positions"] >= nchunks // LANES,
           f"select launched {select_launches} times on the main path")
    print(f"gzip-ext compress of {nchunks} chunks: {select_launches} "
          f"launches of the position-order select, "
          f"{launches['select_candidates']} of the sorted-order entry")
    # one launch a round: the reference's 128-lane rounds took 16 here
    _check(1 <= launches["inflate_decode"] < 16,
           f"the decompress ran {launches['inflate_decode']} inflate launches")
    print(f"gzip-ext decompress of {nchunks} chunks: "
          f"{launches['inflate_decode']} inflate launches (the reference's "
          f"128-lane rounds: 16)")
    _check(dd.failover_lanes == 0,
           f"{dd.failover_lanes} lanes failed over to the CPU")
    _check(health.total_failures == 0,
           f"health recorded {health.total_failures} device failures")
    _check(gzip.decompress(comp.data) == corpus, "gzip cannot read the output")
    _check(dec.data == corpus, "round trip is not bit-exact")
    zl = 0
    for i in range(0, len(corpus), CHUNK):
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        zl += len(co.compress(corpus[i:i + CHUNK]) + co.flush())
    gb = len(corpus) / 1e9
    print(f"slice: {len(corpus)} bytes, {nchunks} chunks; compress "
          f"{t_c:.4f} s = {gb / t_c:.4f} GB/s, decompress {t_d:.4f} s = "
          f"{gb / t_d:.4f} GB/s; launches {launches}; failover lanes 0; "
          f"health failures 0; gzip interop and round trip exact")
    walls = {"compress": [t_c], "decompress": [t_d]}
    for rep in range(3):
        _, t_c = _run(torch, sess, "compress", corpus)
        _, t_d = _run(torch, sess, "decompress", comp.data)
        walls["compress"].append(t_c)
        walls["decompress"].append(t_d)
        print(f"repeat {rep}: compress {gb / t_c:.4f} GB/s, decompress "
              f"{gb / t_d:.4f} GB/s")
    print(f"ratio: port gzip-ext {len(corpus) / len(comp.data):.4f} "
          f"(framed), zlib L1 raw deflate {len(corpus) / zl:.4f} "
          f"(same 64 KB chunks)")
    medians = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    _packed_pass(torch, sess, corpus, len(comp.data), medians["compress"])
    return "gzip-ext", sess, corpus, comp.data, medians


def _packed_pass(torch, sess, corpus: bytes, raw_len: int,
                 raw_s: float) -> None:
    """The 32 MB corpus once more with the packed candidate format
    (QATZIP_TPU_PACK=1): the bytes must round-trip and gzip must read them.
    The candidate D2H bytes are the arrays' sizes (uint16 a position, or
    3/4 of a byte)."""
    from qatzip_tpu_torch.engine.health import health
    from qatzip_tpu_torch.ops import device_codecs as dc
    from qatzip_tpu_torch.ops import match_finder as mf

    sizes = []
    packed_fn = mf.find_candidates_packed

    def packed(*args):
        out = packed_fn(*args)
        sizes.append(out.numel() * out.element_size())
        return out

    os.environ["QATZIP_TPU_PACK"] = "1"
    mf.find_candidates_packed = packed
    try:
        comp, t_p = _run(torch, sess, "compress", corpus)
    finally:
        mf.find_candidates_packed = packed_fn
        os.environ["QATZIP_TPU_PACK"] = "0"
    batches = -(-len(corpus) // (CHUNK * dc.DeflateDeviceCodec.MAX_BATCH))
    _check(len(sizes) == batches,
           f"packed compress ran {len(sizes)} packed batches, not {batches}")
    _check(health.total_failures == 0, "packed compress recorded failures")
    _check(gzip.decompress(comp.data) == corpus,
           "gzip cannot read the packed output")
    dec, _ = _run(torch, sess, "decompress", comp.data)
    _check(dec.data == corpus, "packed round trip is not bit-exact")
    gb = len(corpus) / 1e9
    raw_d2h = len(corpus) * 2
    print(f"packed compress (QATZIP_TPU_PACK=1): {t_p:.4f} s = "
          f"{gb / t_p:.4f} GB/s (raw format, median: {gb / raw_s:.4f}); "
          f"candidate D2H {sum(sizes)} bytes (raw: {raw_d2h}); ratio "
          f"{len(corpus) / len(comp.data):.4f} (raw: "
          f"{len(corpus) / raw_len:.4f}); round trip exact, gzip reads it")


def phase_calibrate(tmpdir: str) -> dict:
    """devcal.calibrate on the card (8 MB sample) into a record of its own;
    returns the record.  No device or probe error, and every device rate
    above 0."""
    from qatzip_tpu_torch.engine import devcal

    os.environ["QATZIP_TPU_DEVCAL_PATH"] = os.path.join(tmpdir, "devcal.json")
    devcal.invalidate()
    t0 = time.perf_counter()
    rec = devcal.calibrate(sample_bytes=8 << 20)
    print(f"calibration ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(rec, sort_keys=True)}")
    for key in ("device_error", "compute_probe_error"):
        _check(key not in rec, f"calibration recorded {key}: {rec.get(key)}")
    for key, value in rec.items():
        if key.startswith("dev_") and key.endswith("_gbps"):
            _check(value > 0, f"calibration measured {key} = {value}")
    _check(devcal._load() == rec, "the record was not saved")
    return rec


def phase_routing(torch, corpus: bytes, rec: dict) -> None:
    """One gzip-ext request each way through the public API with
    QATZIP_TPU_DEVICE unset: the measured record routes each direction."""
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.engine.health import health

    os.environ.pop("QATZIP_TPU_DEVICE", None)
    os.environ.pop("QATZIP_TPU_PACK", None)
    sess = qt.QzSession()
    params = qt.QzSessionParamsDeflate(
        common_params=qt.QzSessionParamsCommon(comp_lvl=1, hw_buff_sz=CHUNK),
        data_fmt=qt.QzDataFormat.QZ_DEFLATE_GZIP_EXT)
    _check(qt.qz_setup_session_deflate(sess, params) == qt.QZ_OK,
           "session setup failed")
    eng = core.engine()
    routes = {}
    data = corpus
    for direction in ("compress", "decompress"):
        hw0, sw0 = eng.hw_requests, eng.sw_requests
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = (qt.qz_compress(sess, data) if direction == "compress"
               else qt.qz_decompress(sess, data))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _check(res.rc == qt.QZ_OK, f"routed {direction} rc {res.rc}")
        hw, sw = eng.hw_requests - hw0, eng.sw_requests - sw0
        routes[direction] = ("device" if hw and not sw else
                             "cpu" if sw and not hw else "mixed")
        wins = rec[("comp" if direction == "compress" else "decomp")
                   + "_device_wins"]
        _check(routes[direction] == ("device" if wins else "cpu"),
               f"{direction} took {routes[direction]}, the record says "
               f"device wins: {wins}")
        print(f"routing, QATZIP_TPU_DEVICE unset: {direction} took the "
              f"{routes[direction]} ({hw} device, {sw} software chunk "
              f"requests; record: device wins {wins}, pack_wins "
              f"{rec['pack_wins']}), {dt:.4f} s = "
              f"{len(corpus) / 1e9 / dt:.4f} GB/s")
        data = res.data
    _check(data == corpus, "routed round trip is not bit-exact")
    _check(health.total_failures == 0, "routing recorded device failures")


def phase_lz4(torch, corpus: bytes, lz4_rec: dict) -> list:
    """The LZ4-frame session on the corpus and the LZ4s session on 8 MB of
    it, through the public API with the device forced (phase_slice set
    QATZIP_TPU_DEVICE and initialised the engine on the card).  The LZ4
    decode kernel's count is zeroed just before each session's first
    decompress and read just after it, into ``lz4_rec``; one launch a
    request, and the plain decode never runs on the card."""
    from qatzip_tpu_torch.ops import lz4_decode as ld

    plain_on_card = []
    impl = ld._decode_blocks_impl

    def counted(b, *a):
        if b.device.type == "cuda":
            plain_on_card.append(1)
        return impl(b, *a)

    ld._decode_blocks_impl = counted
    try:
        runs = _lz4_sessions(torch, corpus, lz4_rec)
    finally:
        ld._decode_blocks_impl = impl
    _check(not plain_on_card, f"the plain LZ4 decode ran "
           f"{len(plain_on_card)} times on the card")
    lz4_rec["launches"] = sum(lz4_rec["path_launches"].values())
    lz4_rec["launches_per_request"] = dict(lz4_rec["path_launches"])
    return runs


def _lz4_sessions(torch, corpus: bytes, lz4_rec: dict) -> list:
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.engine.health import health
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.ops import lz4_kernel as LK
    from qatzip_tpu_torch.ops import select as S

    def common():
        return qt.QzSessionParamsCommon(comp_lvl=1, hw_buff_sz=CHUNK)

    runs = []
    lz4_rec["path_launches"] = {}
    for name, setup, params, src in (
            ("lz4", qt.qz_setup_session_lz4,
             qt.QzSessionParamsLZ4(common_params=common()), corpus),
            ("lz4s", qt.qz_setup_session_lz4s,
             qt.QzSessionParamsLZ4S(common_params=common(),
                                    lz4s_mini_match=3), corpus[:8 << 20])):
        sess = qt.QzSession()
        _check(setup(sess, params) == qt.QZ_OK, f"{name} session setup")
        nchunks = -(-len(src) // CHUNK)
        S.POS_KERNEL.launches = 0
        ld.failover_blocks = 0
        comp, t_c = _run(torch, sess, "compress", src)
        launches = S.POS_KERNEL.launches
        LK.KERNEL.launches = 0
        dec, t_d = _run(torch, sess, "decompress", comp.data)
        decodes = LK.KERNEL.launches
        lz4_rec["path_launches"][name] = decodes
        _check(launches >= nchunks // LANES,
               f"{name}: select launched {launches} times")
        _check(decodes == -(-nchunks // (ld.LAUNCH_OUT_BYTES //
                                         ld.MAX_OUT)),
               f"{name}: the LZ4 decode kernel launched {decodes} times, "
               f"not once a request")
        _check(ld.failover_blocks == 0,
               f"{name}: {ld.failover_blocks} blocks failed over to the CPU")
        _check(health.total_failures == 0,
               f"{name}: health recorded {health.total_failures} failures")
        _check(dec.data == src, f"{name} round trip is not bit-exact")
        _check(qt.decompress(comp.data, name, hw_buff_sz=CHUNK,
                             sw_only=True) == src,
               f"the software path cannot read the {name} output")
        gb = len(src) / 1e9
        print(f"{name}: {len(src)} bytes, {nchunks} chunks, ratio "
              f"{len(src) / len(comp.data):.4f}; compress {t_c:.4f} s = "
              f"{gb / t_c:.4f} GB/s, decompress {t_d:.4f} s = "
              f"{gb / t_d:.4f} GB/s; select launches {launches}, LZ4 decode "
              f"launches {decodes}; failover "
              f"blocks 0; health failures 0; round trip exact, software "
              f"path reads it")
        walls = {"compress": [t_c], "decompress": [t_d]}
        for rep in range(2):
            _, t_c = _run(torch, sess, "compress", src)
            _, t_d = _run(torch, sess, "decompress", comp.data)
            walls["compress"].append(t_c)
            walls["decompress"].append(t_d)
            print(f"{name} repeat {rep}: compress {gb / t_c:.4f} GB/s, "
                  f"decompress {gb / t_d:.4f} GB/s")
        runs.append((name, sess, src, comp.data,
                     {k: sorted(v)[1] for k, v in walls.items()}))
    return runs


class _ApiStep:
    """One step of phase_api: made just before the step, it zeroes the
    launch counts, the failed-over lanes and the health failures and starts
    the clock; ``done`` stops it, checks the step ran on the device route
    only (no software request or result, no lane failed over, no health
    failure) and prints its line."""

    def __init__(self, torch, name: str, gpu: str, records: dict):
        from qatzip_tpu_torch.engine import core
        from qatzip_tpu_torch.engine.health import health
        from qatzip_tpu_torch.ops import chain as CH
        from qatzip_tpu_torch.ops import checksums as CK
        from qatzip_tpu_torch.ops import deflate_decode as dd
        from qatzip_tpu_torch.ops import inflate_kernel as K
        from qatzip_tpu_torch.ops import select as S

        self.torch, self.name, self.gpu, self.records = torch, name, gpu, \
            records
        S.POS_KERNEL.launches = 0
        K.KERNEL.launches = 0
        CH.KERNEL.launches = 0
        CK.KERNEL.launches = 0
        dd.failover_lanes = 0
        health.total_failures = 0
        self.sw0 = core.engine().sw_requests
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def done(self, nbytes: int, need: dict, results=(),
             extra: str = "") -> dict:
        """Close the step over ``nbytes`` of uncompressed data: ``need``
        gives the least launches of each kernel the step reaches,
        ``results`` the OpResult-like objects whose ext_rc must be clear of
        the software mask.  Returns the launches."""
        import qatzip_tpu_torch as qt
        from qatzip_tpu_torch.engine import core
        from qatzip_tpu_torch.engine.health import health
        from qatzip_tpu_torch.ops import chain as CH
        from qatzip_tpu_torch.ops import checksums as CK
        from qatzip_tpu_torch.ops import deflate_decode as dd
        from qatzip_tpu_torch.ops import inflate_kernel as K
        from qatzip_tpu_torch.ops import select as S

        self.torch.cuda.synchronize()
        dt = time.perf_counter() - self.t0
        launches = {"select_to_positions": S.POS_KERNEL.launches,
                    "inflate_decode": K.KERNEL.launches,
                    "chain_walk": CH.KERNEL.launches,
                    "checksums": CK.KERNEL.launches}
        sw = core.engine().sw_requests - self.sw0
        for r in results:
            _check(r.rc == qt.QZ_OK, f"{self.name}: rc {r.rc}")
            _check(not r.ext_rc & qt.QZ_SW_EXECUTION_MASK,
                   f"{self.name}: a result ran on the software path")
        _check(sw == 0, f"{self.name}: {sw} software requests")
        _check(dd.failover_lanes == 0,
               f"{self.name}: {dd.failover_lanes} lanes failed over")
        _check(health.total_failures == 0,
               f"{self.name}: {health.total_failures} health failures")
        for kernel, least in need.items():
            _check(launches[kernel] >= least, f"{self.name}: {kernel} "
                   f"launched {launches[kernel]} times, not {least}")
        self.records[self.name] = launches
        print(f"api {self.name}: {nbytes} bytes in {dt:.4f} s = "
              f"{nbytes / 1e9 / dt:.4f} GB/s ({self.gpu}); launches "
              f"{launches}; software requests 0, failover lanes 0, health "
              f"failures 0{extra}")
        return launches


def phase_api(torch, corpus: bytes, tmpdir: str, main_inflate: int) -> dict:
    """The rest of the qz* surface on the card, the device route forced and
    the raw candidate format (phase_slice set both): stream, async,
    metadata, the CRC64 variants and the qzip CLI, each step with its
    launch counts zeroed before it.  Returns {step: launches}."""
    import threading

    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch import async_api, metadata, stream
    from qatzip_tpu_torch.cli import qzip
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import device_codecs as dc
    from qatzip_tpu_torch.utils import checksum as ck

    gpu = _gpu_line()
    records: dict = {}

    def session(fmt):
        sess = qt.QzSession()
        p = qt.QzSessionParamsDeflate(
            common_params=qt.QzSessionParamsCommon(comp_lvl=1,
                                                   hw_buff_sz=CHUNK),
            data_fmt=fmt)
        _check(qt.qz_setup_session_deflate(sess, p) == qt.QZ_OK,
               "session setup failed")
        return sess

    def feed(fn, sess, data, piece=1 << 20):
        strm, out = stream.QzStream(), bytearray()
        for i in range(0, len(data), piece):
            rc, produced = fn(sess, strm, data[i:i + piece],
                              last=int(i + piece >= len(data)))
            _check(rc == qt.QZ_OK, f"{fn.__name__} rc {rc}")
            out += produced
        out += stream.qz_end_stream(sess, strm)[1]
        return bytes(out)

    # 1. stream: a quarter of the corpus (8 MB) in 1 MB pieces at the
    # default strm_buff_sz
    src = corpus[:len(corpus) // 4]
    gz, fb = qt.QzDataFormat.QZ_DEFLATE_GZIP_EXT, qt.QzDataFormat.QZ_DEFLATE_4B
    buffers = -(-len(src) // qt.QZ_STRM_BUFF_SZ_DEFAULT)
    st = _ApiStep(torch, "stream gzip-ext compress", gpu, records)
    comp = feed(stream.qz_compress_stream, session(gz), src)
    st.done(len(src), {"select_to_positions": buffers},
            extra=f"; {buffers} stream buffers")
    _check(gzip.decompress(comp) == src, "gzip cannot read the stream")
    st = _ApiStep(torch, "stream 4B compress", gpu, records)
    comp = feed(stream.qz_compress_stream, session(fb), src)
    st.done(len(src), {"select_to_positions": buffers})
    st = _ApiStep(torch, "stream 4B decompress", gpu, records)
    back = feed(stream.qz_decompress_stream, session(fb), comp)
    st.done(len(src), {"inflate_decode": 1})
    _check(back == src, "the 4B stream round trip is not bit-exact")

    # 2. async: eight slices of the corpus (4 MB) from two submitter threads
    part = len(corpus) // 8
    slices = [corpus[i * part:(i + 1) * part] for i in range(8)]
    sess = session(gz)
    want = [qt.qz_compress(sess, s).data for s in slices]
    order, submitted, lock = [], [], threading.Lock()

    def submit(direction, idx, futs):
        for i in idx:
            with lock:   # the seq order is the order of this list
                fn = (async_api.qz_compress2 if direction == "compress"
                      else async_api.qz_decompress2)
                rc, fut = fn(sess, slices[i] if direction == "compress"
                             else want[i],
                             callback=lambda ext, *a: order.append(ext),
                             external=i)
                _check(rc == qt.QZ_OK, f"qz_{direction}2 rc {rc}")
                submitted.append(i)
                futs[i] = fut

    for direction in ("compress", "decompress"):
        order.clear()
        submitted.clear()
        futs = [None] * 8
        st = _ApiStep(torch, f"async {direction}", gpu, records)
        threads = [threading.Thread(target=submit,
                                    args=(direction, range(k, 8, 2),
                                          futs)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        _check(not any(t.is_alive() for t in threads),
               "an async submitter did not finish")
        results = [f.result(timeout=300) for f in futs]
        st.done(len(corpus), {"select_to_positions" if direction ==
                              "compress" else "inflate_decode": 1}, results)
        _check(order == submitted,
               f"async {direction} completed out of submission order")
        _check([r.data for r in results] ==
               (want if direction == "compress" else slices),
               f"async {direction} differs from the one-shot results")
    qt.qz_close(sess)

    # 3. metadata: the 32 MB corpus at 64 KB blocks, decoded as one batch
    rc, blob = qt.qz_allocate_metadata(len(corpus), CHUNK)
    _check(rc == qt.QZ_OK and blob.block_count == len(corpus) // CHUNK,
           "metadata allocation")
    st = _ApiStep(torch, "metadata compress", gpu, records)
    res = qt.qz_compress_with_metadata_ext(session(gz), corpus, blob)
    st.done(len(corpus), {"select_to_positions": 1}, [res])
    for k in range(blob.valid):
        chunk = corpus[k * CHUNK:(k + 1) * CHUNK]
        _, in32, _ = qt.qz_metadata_block_get_crc32(k, blob)
        _, in64, _ = qt.qz_metadata_block_get_crc64(k, blob)
        _check((in32, in64) == (zlib.crc32(chunk), ck.crc64(chunk)),
               f"metadata block {k}: CRC32/CRC64 differ from checksum's")
    deflate = sum(1 for b in blob.blocks[:blob.valid]
                  if b.flags & metadata.QZ_METADATA_BLOCK_DEFLATE)
    lanes, batches = [], []
    round_fn, batch_fn = dd._run_device_round_lockstep, dd.inflate_batch
    dd._run_device_round_lockstep = (
        lambda batch, dev: lanes.append(len(batch)) or round_fn(batch, dev))
    dd.inflate_batch = (
        lambda p, *a, **k: batches.append(len(p)) or batch_fn(p, *a, **k))
    try:
        st = _ApiStep(torch, "metadata decompress", gpu, records)
        dres = qt.qz_decompress_with_metadata_ext(session(gz), res.data,
                                                  blob)
        inflates = st.done(
            len(corpus), {"inflate_decode": 1}, [dres],
            extra=f"; {deflate} deflate blocks in batches {batches}, lanes "
                  f"a launch {lanes}")["inflate_decode"]
    finally:
        dd._run_device_round_lockstep, dd.inflate_batch = round_fn, batch_fn
    _check(dres.data == corpus, "the metadata round trip is not bit-exact")
    width = dc.DeflateDeviceCodec.LOCKSTEP_BATCH
    _check(batches == [width] * (deflate // width)
           + ([deflate % width] if deflate % width else []),
           f"metadata decompress batches {batches} for {deflate} blocks")
    _check(inflates == len(lanes) <= main_inflate,
           f"metadata decompress ran {inflates} inflate launches over "
           f"{len(lanes)} rounds (the one-shot decompress: {main_inflate})")

    # 4. the CRC64 variants on the 32 MB corpus
    want64 = ck.crc64(corpus)
    st = _ApiStep(torch, "crc64 compress", gpu, records)
    res = qt.qz_compress_crc64(session(gz), corpus)
    st.done(len(corpus), {"select_to_positions": 1}, [res])
    _check(res.crc == want64, "qz_compress_crc64 returned another crc64")
    st = _ApiStep(torch, "crc64 decompress", gpu, records)
    dres = qt.qz_decompress_crc64(session(gz), res.data)
    st.done(len(corpus), {"inflate_decode": 1}, [dres])
    _check(dres.crc == want64 and dres.data == corpus,
           "qz_decompress_crc64: crc64 or bytes")

    # 5. the qzip CLI in this process, then in a child
    path = os.path.join(tmpdir, "corpus.bin")
    with open(path, "wb") as f:
        f.write(corpus)
    st = _ApiStep(torch, "qzip -k -O gzip", gpu, records)
    qzip.main(["-k", "-O", "gzip", path])
    st.done(len(corpus), {"select_to_positions": 1})
    with open(path + ".gz", "rb") as f:
        _check(gzip.decompress(f.read()) == corpus,
               "gzip cannot read qzip's output")
    out = os.path.join(tmpdir, "restored.bin")
    st = _ApiStep(torch, "qzip -d", gpu, records)
    qzip.main(["-d", "-k", "-o", out, path + ".gz"])
    st.done(len(corpus), {"inflate_decode": 1})
    with open(out, "rb") as f:
        _check(f.read() == corpus, "qzip -d did not restore the file")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, QATZIP_TPU_DEVICE="1", PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "qatzip_tpu_torch.cli.qzip",
                           "-k", "-O", "gzip", "-o",
                           os.path.join(tmpdir, "child"), path],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    dt = time.perf_counter() - t0
    _check(proc.returncode == 0, f"the qzip child exited {proc.returncode}: "
           f"{proc.stderr[-2000:]}")
    with open(os.path.join(tmpdir, "child.gz"), "rb") as f:
        _check(gzip.decompress(f.read()) == corpus,
               "gzip cannot read the qzip child's output")
    print(f"api python3 -m qatzip_tpu_torch.cli.qzip (a child, "
          f"QATZIP_TPU_DEVICE=1): exit 0 in {dt:.2f} s, start-up and kernel "
          f"load included; gzip reads its output; its own line: "
          f"{proc.stderr.strip().splitlines()[-1]}")
    return records


def _busy(torch, label: str, fn) -> None:
    """One profiled pass of fn: the device's busy time, the device
    operations it ran and the three that took the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _KernelEvents(torch) as ev, profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # torch's rows from the profiler, the port's kernels by CUDA events
    # (the profiler drops their records)
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("qz_")),
                  key=lambda e: -e.self_device_time_total)
    ours = ev.ms()
    busy = (sum(e.self_device_time_total for e in rows) / 1e6
            + sum(ms for ms, _ in ours.values()) / 1e3)
    ops = sum(e.count for e in rows)
    calls = sum(k for _, k in ours.values())
    print(f"parity profile {label}: device busy {busy:.6f} s of {wall:.4f} "
          f"s profiled wall, {ops + calls} device operations ({ops} of "
          f"torch's, {calls} calls of the port's kernels: "
          + ", ".join(f"{s} x{k} {ms:.3f} ms" for s, (ms, k) in ours.items())
          + "); top: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms "
              f"x{e.count}" for e in rows[:3]))


def _codec_on(device, chunks, params, codec, encoder: str):
    """One codec call on ``device`` with QATZIP_TPU_ENCODER=``encoder``."""
    os.environ["QATZIP_TPU_ENCODER"] = encoder
    try:
        return codec.compress_chunks(chunks, params, device)
    finally:
        os.environ.pop("QATZIP_TPU_ENCODER", None)


def _chain_maps(fn) -> list:
    """The (map as int32, seg) pairs fn hands to chain.chain_walk."""
    import torch

    from qatzip_tpu_torch.ops import chain as CH

    maps = []
    real = CH.chain_walk

    def record(f, seg):
        maps.append((f.to(torch.int32), seg))
        return real(f, seg)

    CH.chain_walk = record
    try:
        fn()
    finally:
        CH.chain_walk = real
    return maps


def _smem_load_ns(torch, dev, gpu: str) -> dict:
    """The dependent shared-memory load alone (chain.probe_clocks): in the
    CTA's own memory (the cluster path's phases) and in its cluster
    sibling's (distributed shared memory), clocks a load from clock64 and
    ns a load from the slope of two chases timed with CUDA events."""
    from qatzip_tpu_torch.ops import chain as CH

    out = {}
    for where, remote in (("local", False), ("remote", True)):
        clocks = CH.probe_clocks(remote, 1 << 16, dev) / (1 << 16)
        buf = torch.zeros(2, dtype=torch.int64, device=dev)
        ms = {steps: _graph_ms(lambda steps=steps: CH.PROBE(
            buf.data_ptr(), int(remote), steps,
            torch.cuda.current_stream(dev).cuda_stream), 3)
            for steps in (1 << 12, 1 << 16)}
        ns = (ms[1 << 16] - ms[1 << 12]) * 1e6 / ((1 << 16) - (1 << 12))
        out[where] = {"clocks": clocks, "ns": ns}
        print(f"chain walk dependent shared-memory load, {where}: "
              f"{clocks:.2f} clocks, {ns:.3f} ns ({gpu})")
    return out


def _parity_chain(torch, dev, captured: list, gpu: str) -> dict:
    """The chain-walk kernel against chain_walk_ref on the card: the maps
    the device encoder ([128, 65536], seg 256) and the speculative decoder
    ([8, 2^18], seg 512) build from the corpus's first chunks, and maps of
    steps of 1 at [128, 65536], [8, 2^18], [8, 2^19] (the cluster path, one
    launch) and [8, 2^20] (the row path, three); each timed with CUDA events
    beside the plain version, by phase, with its bytes bound and the
    latency bound of its path: on the cluster path the dependent
    shared-memory loads of a row's longest chain (a part of a segment in
    phase A, the share's entries in B, a segment's walk in C) at the load
    time probed here, a wave of clusters at a time; on the row path phase
    B's nseg dependent loads a row through L2, at the load time probed on
    a [1, 2^22] map of steps of 1 in segments of 32 (131072 loads, the
    other phases negligible).  Returns the kernel's record."""
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.ops import chain as CH
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import device_codecs as dc
    from qatzip_tpu_torch.tools.h100 import FP32_OPS_S, HBM_BYTES_S

    params = qt.api._session_for(
        "deflate", qt.QzDataFormat.QZ_DEFLATE_GZIP_EXT, 1, CHUNK).params
    chunks = [c for c, _ in captured[:LANES]]
    enc = _chain_maps(lambda: _codec_on(dev, chunks, params,
                                        dc.DeflateDeviceCodec(), "device"))
    os.environ["QATZIP_TPU_INFLATE"] = "spec"
    try:
        dec = _chain_maps(lambda: dd.inflate_batch(
            [r.payload for _, r in captured[:8]], [CHUNK] * 8, dev,
            kind="crc32"))
    finally:
        os.environ.pop("QATZIP_TPU_INFLATE", None)

    def steps1(B, n):
        return (torch.arange(1, n + 1, dtype=torch.int32, device=dev)
                .expand(B, n).contiguous())

    probe = steps1(1, CHAIN_PROBE)
    _check(CH.check_kernel_limits(CHAIN_PROBE, 32) == "rows",
           "the [1, 2^22] probe left the row path")
    probe_ms = _graph_ms(lambda: CH.chain_walk(probe, 32), 5)
    load_ns = probe_ms * 1e6 / (CHAIN_PROBE // 32)
    print(f"chain walk row path phase B dependent load: {load_ns:.2f} ns (a "
          f"[1, {CHAIN_PROBE}] map of steps of 1 in segments of 32, "
          f"{CHAIN_PROBE // 32} loads, {probe_ms:.4f} ms; {gpu})")
    smem = _smem_load_ns(torch, dev, gpu)
    cases = [("encoder map", *enc[0]), ("decoder map", *dec[0]),
             ("steps of 1, encoder shape", steps1(LANES, CHUNK), 256),
             ("steps of 1, [8, 2^18]", steps1(8, 1 << 18), 512),
             ("steps of 1, [8, 2^19]", steps1(8, 1 << 19), 512),
             ("steps of 1, [8, 2^20]", steps1(8, 1 << 20), 512)]
    shapes = {}
    for label, f, seg in cases:
        B, n = f.shape
        path = CH.check_kernel_limits(n, seg)
        info = CH.launch_info(n, seg)
        got = CH.chain_walk(f, seg)
        want = CH.chain_walk_ref(f, seg)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        _check(torch.equal(got, want), f"chain walk != plain on the {label}")
        ms = _graph_ms(lambda: CH.chain_walk(f, seg), 10)
        wrapper_ms = _time_ms(lambda: CH.chain_walk(f, seg), 10)
        plain_ms = _time_ms(lambda: CH.chain_walk_ref(f, seg), 2)
        # the phases by difference: A alone, A then B, all three (a phase
        # timed alone would find the data its last replay left in L1)
        out = torch.empty_like(f)
        ent = torch.empty((B, n // seg), dtype=torch.int32, device=dev)
        upto = {}
        for mask in (1, 3, CH.ALL_PHASES):
            def one(mask=mask):
                CH.KERNEL(f.data_ptr(), out.data_ptr(), ent.data_ptr(), B, n,
                          seg, mask,
                          torch.cuda.current_stream(dev).cuda_stream)
            upto[mask] = _graph_ms(one, 10)
        phase_ms = {"A exits": upto[1], "B entries": upto[3] - upto[1],
                    "C walks": upto[CH.ALL_PHASES] - upto[3]}
        bytes_ms = 2 * 4 * B * n / HBM_BYTES_S * 1e3
        # phase A a compare and a select a position, phase C a compare and
        # a load a step, phase B a compare a segment
        ops_ms = (4 * B * n + B * (n // seg)) / FP32_OPS_S * 1e3
        if path == "cluster":
            waves = -(-B // max(info["active_clusters"], 1))
            chain = seg // info["parts"] + info["spc"] + seg
            lat_ms = waves * chain * smem["local"]["ns"] / 1e6
            lat_what = (f"{waves} wave(s) x {chain} dependent shared-memory "
                        f"loads x {smem['local']['ns']:.3f} ns")
        else:
            lat_ms = (n // seg) * load_ns / 1e6
            lat_what = f"{n // seg} loads x {load_ns:.2f} ns"
        shapes[label] = {
            "shape": [B, n], "seg": seg, "path": path, "launch": info,
            "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms,
            "phase_ms": phase_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "latency_bound_ms": lat_ms}
        launches = "1 launch" if path == "cluster" else "3 launches"
        print(f"chain walk {label} {(B, n)} seg {seg}, {path} path "
              f"({info['c']} CTAs a cluster, {info['spc']} segments a CTA, "
              f"{info['active_clusters']} clusters at once): equal; kernel "
              f"{ms:.4f} ms ({launches} from a CUDA graph; phases "
              + ", ".join(f"{k} {v:.4f}" for k, v in phase_ms.items())
              + f"), through the wrapper {wrapper_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {max(bytes_ms, ops_ms):.6f} ms "
              f"(bytes {bytes_ms:.6f}, operations {ops_ms:.6f}); latency "
              f"bound {lat_ms:.4f} ms ({lat_what}) ({gpu})")
    main = shapes["encoder map"]
    return {"name": "chain_walk", "route": "cuda",
            "source": "qatzip_tpu_torch/csrc/chain.cu",
            "replaces": "qatzip_tpu/ops/deflate_encode.py:294",
            "also_replaces": "qatzip_tpu/ops/deflate_decode.py:282",
            "path": "parity",
            "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "latency_bound_ms": main["latency_bound_ms"],
            "row_path_load_ns": load_ns, "smem_load": smem,
            "shapes": shapes}


def _parity_checksums(torch, data, lt, host, lens: list, gpu: str) -> dict:
    """The checksum kernel against the plain versions and zlib on step 7's
    ragged [128, 65536] batch (its rows 8 bytes wider than a chunk, as the
    encoder stages them) and on a spec round's 8 full rows of 64 KB, with
    int32 and int64 lengths (one launch a call either way), timed with
    CUDA events beside its bound (the rows' bytes read once).  Returns the
    kernel's record."""
    from qatzip_tpu_torch.ops import checksums as cks
    from qatzip_tpu_torch.tools.h100 import FP32_OPS_S, HBM_BYTES_S

    full = data[:8, :CHUNK].contiguous()
    batches = {f"ragged [{LANES}, {CHUNK}]": (data, lt, host, lens),
               f"[8, {CHUNK}]": (full, torch.full((8,), CHUNK,
                                                 dtype=torch.int32,
                                                 device=data.device),
                                 full.cpu().numpy(), [CHUNK] * 8)}
    shapes = {}
    for label, (d, lengths, h, ln) in batches.items():
        nbytes = sum(ln)
        plan = cks.launch_plan(d.shape[0], CHUNK)
        for kind in ("crc32", "adler32"):
            fn = getattr(cks, f"{kind}_blocks")
            ref = getattr(cks, f"{kind}_blocks_ref")
            want = ref(d, lengths, CHUNK)
            n0 = cks.KERNEL.launches
            for dtype in (torch.int32, torch.int64):
                got = fn(d, lengths.to(dtype), CHUNK)
                torch.cuda.synchronize()
                _check(torch.equal(got, want), f"{kind} kernel != plain on "
                       f"{label} ({dtype})")
            _check(cks.KERNEL.launches == n0 + 2, f"{kind}: not one launch "
                   f"a call")
            _check(got.cpu().tolist() == [
                getattr(zlib, kind)(h[i, :k].tobytes())
                for i, k in enumerate(ln)], f"{kind} kernel != zlib")
            ms = _graph_ms(lambda: fn(d, lengths, CHUNK), 20)
            wrapper_ms = _time_ms(lambda: fn(d, lengths, CHUNK), 20)
            plain_ms = _time_ms(lambda: ref(d, lengths, CHUNK), 5)
            bytes_ms = nbytes / HBM_BYTES_S * 1e3
            # a table lookup, a shift and an XOR a byte (CRC32), two adds a
            # byte (Adler-32)
            ops_ms = 3 * nbytes / FP32_OPS_S * 1e3
            shapes[f"{kind} {label}"] = {
                "max_abs_err": int((got - want).abs().max()), "ms": ms,
                "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "plan": plan}
            print(f"checksums {kind} {label}, {nbytes} bytes ({plan['p']} "
                  f"CTAs a row, {plan['active_clusters']} clusters at "
                  f"once): equal to plain and zlib, int32 and int64 "
                  f"lengths; kernel {ms:.4f} ms from a CUDA graph "
                  f"({nbytes / ms / 1e6:.4f} GB/s), through the wrapper "
                  f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
                  f"{max(bytes_ms, ops_ms):.6f} ms ({gpu})")
    main = shapes[f"crc32 ragged [{LANES}, {CHUNK}]"]
    return {"name": "checksums", "route": "cuda",
            "source": "qatzip_tpu_torch/csrc/checksum.cu",
            "replaces": "qatzip_tpu/ops/checksums.py:91",
            "also_replaces": "qatzip_tpu/ops/checksums.py:139",
            "path": "parity",
            "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shapes": shapes}


def phase_parity_dist(torch, corpus: bytes, dev, tmpdir: str) -> dict:
    """Step 7: the parity engines (the device encoder, the speculative
    decoder, the device checksums), block-DP over [cuda:0] and two ranks on
    the card, the device route forced, the launch counts zeroed before each
    part; the chain-walk and checksum kernels against their plain versions.
    Returns ({part: launches}, the two kernels' records)."""
    import random

    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch import graft_entry
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.ops import chain as CH
    from qatzip_tpu_torch.ops import checksums as cks
    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import deflate_encode as de
    from qatzip_tpu_torch.ops import device_codecs as dc
    from qatzip_tpu_torch.ops import select as S
    from qatzip_tpu_torch.parallel import shard
    from qatzip_tpu_torch.tools import dist_worker

    os.environ["QATZIP_TPU_DEVICE"] = "1"
    gpu = _gpu_line()
    records: dict = {}
    cpu = torch.device("cpu")
    src = corpus
    nchunks = len(src) // CHUNK
    batches = -(-nchunks // dc.DeflateDeviceCodec.MAX_BATCH)
    gz = qt.QzDataFormat.QZ_DEFLATE_GZIP_EXT
    first = [corpus[i:i + CHUNK] for i in range(0, 1 << 20, CHUNK)]

    # 1. the device encoder, gzip-ext and LZ4 frame, 32 MB each: the
    # chain-walk kernel once a batch, the checksum kernel once a gzip-ext
    # batch
    captured = []
    full = dc.DeflateDeviceCodec._compress_full_device

    def capture(self, chunks, params, device):
        out = full(self, chunks, params, device)
        captured.extend(zip(chunks, out))
        return out

    dc.DeflateDeviceCodec._compress_full_device = capture
    os.environ["QATZIP_TPU_ENCODER"] = "device"
    try:
        st = _ApiStep(torch, "parity device encoder gzip-ext compress", gpu,
                      records)
        comp = qt.compress(src, fmt=gz, level=1, hw_buff_sz=CHUNK)
        st.done(len(src), {"chain_walk": batches, "checksums": batches},
                extra=f"; ratio {len(src) / len(comp):.4f}; {batches} "
                f"batches")
        st = _ApiStep(torch, "parity device encoder lz4 compress", gpu,
                      records)
        lz = qt.compress(src, "lz4", level=1, hw_buff_sz=CHUNK)
        st.done(len(src), {"chain_walk": batches},
                extra=f"; ratio {len(src) / len(lz):.4f}; {batches} batches")
    finally:
        os.environ.pop("QATZIP_TPU_ENCODER", None)
        dc.DeflateDeviceCodec._compress_full_device = full
    _check(gzip.decompress(comp) == src, "gzip cannot read the device "
           "encoder's stream")
    _check(len(captured) == nchunks and all(
        r.checksum == zlib.crc32(c) for c, r in captured),
        "a device chunk CRC differs from zlib's")
    _check(qt.decompress(lz, "lz4", hw_buff_sz=CHUNK, sw_only=True) == src,
           "the native decoder cannot read the device encoder's LZ4")
    os.environ["QATZIP_TPU_ENCODER"] = "device"
    try:
        _busy(torch, f"device encoder gzip-ext compress, {len(src) >> 20} MB",
              lambda: qt.compress(src, fmt=gz, level=1, hw_buff_sz=CHUNK))
    finally:
        os.environ.pop("QATZIP_TPU_ENCODER", None)
    params = qt.api._session_for("deflate", gz, 1, CHUNK).params
    lz_params = qt.api._session_for("lz4", None, 1, CHUNK).params
    for label, codec, p in (("gzip-ext", dc.DeflateDeviceCodec(), params),
                            ("lz4", dc.Lz4DeviceCodec(), lz_params)):
        on_card = _codec_on(dev, first, p, codec, "device")
        on_cpu = _codec_on(cpu, first, p, codec, "device")
        _check([(r.payload, r.checksum) for r in on_card]
               == [(r.payload, r.checksum) for r in on_cpu],
               f"device encoder {label}: the card's first 1 MB differs from "
               f"the CPU device's")
    print(f"parity device encoder: the first 1 MB ({len(first)} chunks) "
          f"equal to the CPU device's, gzip-ext and LZ4; {len(captured)} "
          f"chunk CRC32s equal to zlib's; gzip and the native LZ4 decoder "
          f"read the 32 MB streams")

    # 2. the speculative decoder on the device encoder's 32 MB stream: the
    # chain-walk and checksum kernels once a round
    decoded = []
    rounds = []
    dec = dc.DeflateDeviceCodec.decompress_chunks
    spec_round = dd._run_device_round_spec

    def capture_dec(self, *a, **k):
        out = dec(self, *a, **k)
        decoded.extend(out)
        return out

    def count_round(batch, device):
        rounds.append(len(batch))
        return spec_round(batch, device)

    # the chain walk's path a round, by its map's width (the decoder's
    # rounds are 2^18 or 2^19 positions wide by their longest payload)
    paths: dict = {}
    walk = CH.chain_walk

    def note_path(f, seg):
        key = f"{CH.check_kernel_limits(f.shape[1], seg)} n={f.shape[1]}"
        paths[key] = paths.get(key, 0) + 1
        return walk(f, seg)

    dc.DeflateDeviceCodec.decompress_chunks = capture_dec
    dd._run_device_round_spec = count_round
    CH.chain_walk = note_path
    os.environ["QATZIP_TPU_INFLATE"] = "spec"
    try:
        st = _ApiStep(torch, "parity speculative decoder decompress", gpu,
                      records)
        back = qt.decompress(comp, fmt=gz, hw_buff_sz=CHUNK)
        st.done(len(src), {"chain_walk": len(rounds),
                           "checksums": len(rounds)},
                extra=f"; {len(rounds)} rounds of {max(rounds)} streams; "
                f"chain walk paths {json.dumps(paths, sort_keys=True)}")
    finally:
        os.environ.pop("QATZIP_TPU_INFLATE", None)
        dc.DeflateDeviceCodec.decompress_chunks = dec
        dd._run_device_round_spec = spec_round
        CH.chain_walk = walk
    _check(back == src, "the speculative decoder's round trip differs")
    _check(records["parity speculative decoder decompress"]["chain_walk"]
           == len(rounds) > 0, "the chain-walk kernel did not launch once "
           "a speculative round")
    os.environ["QATZIP_TPU_INFLATE"] = "spec"
    try:
        _busy(torch, f"speculative decoder decompress, {len(src) >> 20} MB",
              lambda: qt.decompress(comp, fmt=gz, hw_buff_sz=CHUNK))
    finally:
        os.environ.pop("QATZIP_TPU_INFLATE", None)
    _check(len(decoded) == nchunks and all(
        d.checksum == zlib.crc32(d.data) for d in decoded),
        "a device CRC of the speculative decoder differs from zlib's")

    # 3. the device checksums on a [128, 65536] batch of ragged lengths,
    # against zlib and their plain versions
    rng = random.Random(5)
    lens = [rng.randrange(0, CHUNK + 1) for _ in range(LANES)]
    lens[:3] = [0, 1, CHUNK]
    data, _ = _first_chunks(torch, corpus, dev)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    host = data.cpu().numpy()
    st = _ApiStep(torch, "parity device checksums, CRC32 and Adler-32", gpu,
                  records)
    crc = cks.crc32_blocks(data, lt, CHUNK).cpu().tolist()
    adl = cks.adler32_blocks(data, lt, CHUNK).cpu().tolist()
    nbytes = sum(lens)
    st.done(nbytes, {"checksums": 2}, extra="; both equal to zlib on every "
            "length, checked on the host")
    _check(crc == [zlib.crc32(host[i, :n].tobytes())
                   for i, n in enumerate(lens)], "device CRC32 != zlib")
    _check(adl == [zlib.adler32(host[i, :n].tobytes())
                   for i, n in enumerate(lens)], "device Adler-32 != zlib")
    _busy(torch, f"crc32_blocks [{LANES}, {CHUNK}]",
          lambda: cks.crc32_blocks(data, lt, CHUNK))
    kernels = [_parity_chain(torch, dev, captured, gpu),
               _parity_checksums(torch, data, lt, host, lens, gpu)]
    parts = ("parity device encoder gzip-ext compress",
             "parity device encoder lz4 compress",
             "parity speculative decoder decompress")
    calls = {parts[0]: batches, parts[1]: batches, parts[2]: len(rounds)}
    for rec in kernels:
        rec["launches_per_part"] = {p: records[p][rec["name"]] for p in parts}
        rec["engine_calls_per_part"] = calls
        rec["launches"] = sum(rec["launches_per_part"].values())
        _check(rec["launches"] > 0, f"the parity engines never launched "
               f"{rec['name']}")

    # 4. block-DP over [cuda:0]
    mesh = [dev]
    arr = torch.zeros((16, CHUNK + 8), dtype=torch.uint8)
    arr[:, :CHUNK] = torch.frombuffer(bytearray(b"".join(first[:16])),
                                      dtype=torch.uint8).view(16, CHUNK)
    ln = torch.full((16,), CHUNK, dtype=torch.int32)
    m_words = de.words_bound(CHUNK)
    w1, b1, m1 = de.encode_blocks(arr.to(dev), ln.to(dev), 8, 16, True,
                                  m_words)
    st = _ApiStep(torch, "parity compress_blocks_sharded over [cuda:0]", gpu,
                  records)
    ws, bs, ms_ = shard.compress_blocks_sharded(mesh, arr.numpy(), ln.numpy(),
                                                8, 16, True, m_words)
    st.done(arr.shape[0] * CHUNK, {}, extra="; equal to encode_blocks")
    _check(all(w.device == dev for w in ws), "a shard left its device")
    _check(torch.equal(torch.cat(ws), w1) and torch.equal(torch.cat(bs), b1)
           and (ms_ == m1).all(),
           "compress_blocks_sharded over [cuda:0] != encode_blocks")
    st = _ApiStep(torch, "parity graft_entry.entry()", gpu, records)
    fn, args = graft_entry.entry()
    cand = fn(*args)
    st.done(cand.numel(), {"select_to_positions": 1})
    _check(tuple(cand.shape) == (8, 4096), "graft_entry.entry()'s shape")
    st = _ApiStep(torch, "parity dryrun_multichip(1)", gpu, records)
    graft_entry.dryrun_multichip(1)
    st.done(4 * 4096, {"select_to_positions": 1, "inflate_decode": 1},
            extra="; the data of its round trip, its format matrix beside")
    _check(core.engine().hw_backend.device == dev, "the engine left cuda:0")
    st = _ApiStep(torch, "parity scaling_report over [cuda:0]", gpu, records)
    rep = shard.scaling_report(mesh)
    st.done(2 * 6 * 8 * CHUNK, {"select_to_positions": 1},
            extra=f"; 2 x 6 calls of 8 x 64 KB; {json.dumps(rep)}")

    # 5. two ranks on the card over gloo: 32 MB gzip-ext, then 8 MB LZ4
    want = qt.compress(corpus, fmt=gz, level=1, hw_buff_sz=CHUNK)
    out_path = os.path.join(tmpdir, "dist.gz")
    t0 = time.perf_counter()
    outs = dist_worker.launch(["--device", dev.type, "--smoke-mb",
                               str(len(corpus) >> 20), "--chunk-kb",
                               str(CHUNK >> 10), "--out", out_path],
                              timeout=600)
    wall = time.perf_counter() - t0
    reports = [json.loads(ln[len("DIST SMOKE "):]) for out in outs
               for ln in out.splitlines() if ln.startswith("DIST SMOKE ")]
    _check(len(reports) == 2, f"{len(reports)} ranks reported")
    with open(out_path, "rb") as f:
        _check(f.read() == want, "the two-rank stream differs from the "
               "single-process stream")
    parts = ("deflate compress", "deflate decompress", "lz4 compress",
             "lz4 decompress")
    need = {"deflate compress": "select", "deflate decompress": "inflate",
            "lz4 compress": "select", "lz4 decompress": "lz4_decode"}
    for r in reports:
        for part, rec in r.items():
            if not isinstance(rec, dict):
                continue
            for key in ("sw_requests", "failover_lanes", "failover_blocks",
                        "health_failures"):
                _check(rec[key] == 0, f"rank {r['rank']} {part}: {key} "
                       f"{rec[key]}")
            if part in need:
                _check(rec[need[part]] >= 1, f"rank {r['rank']} {part}: "
                       f"{need[part]} launched {rec[need[part]]} times")
            gb = (len(corpus) if part.startswith("deflate")
                  else len(corpus) // 4) / 1e9
            print(f"parity two ranks, rank {r['rank']} {part}: "
                  f"{rec['seconds']:.4f} s = {gb / rec['seconds']:.4f} GB/s "
                  f"of the stream, own work {rec['local_seconds']:.4f} s, "
                  f"outside it {rec['overhead_share']:.4f}; select "
                  f"{rec['select']}, inflate {rec['inflate']}, lz4 decode "
                  f"{rec['lz4_decode']} launches; "
                  f"software requests 0, failover 0 ({gpu})")
        records[f"two ranks, rank {r['rank']}"] = {
            "select_to_positions": sum(v["select"] for v in r.values()
                                       if isinstance(v, dict)),
            "inflate_decode": sum(v["inflate"] for v in r.values()
                                  if isinstance(v, dict)),
            "lz4_decode": sum(v["lz4_decode"] for v in r.values()
                              if isinstance(v, dict))}
    for part in parts:
        slowest = max(r[part]["seconds"] for r in reports)
        gb = (len(corpus) if part.startswith("deflate")
              else len(corpus) // 4) / 1e9
        print(f"parity two ranks {part}: {gb / slowest:.4f} GB/s over both "
              f"ranks (the slower rank's {slowest:.4f} s); mean share "
              f"outside the ranks' own work "
              f"{sum(r[part]['overhead_share'] for r in reports) / 2:.4f}")
    print(f"parity two ranks: {wall:.1f} s with start-up; the assembled "
          f"gzip-ext stream equals the single-process stream "
          f"({len(want)} bytes)")
    return records, kernels


class _EdgePart:
    """One part of step 8: made just before the part, it zeroes the launch
    counts, the failed-over lanes and blocks and the health failures, reads
    the engine's software requests and starts the clock; ``counts`` reads
    them all, ``done`` prints the part's line and returns its launches."""

    def __init__(self, torch, name: str, gpu: str):
        from qatzip_tpu_torch.engine import core
        from qatzip_tpu_torch.engine.health import health
        from qatzip_tpu_torch.ops import deflate_decode as dd
        from qatzip_tpu_torch.ops import inflate_kernel as K
        from qatzip_tpu_torch.ops import lz4_decode as ld
        from qatzip_tpu_torch.ops import lz4_kernel as LK
        from qatzip_tpu_torch.ops import select as S

        self.torch, self.name, self.gpu = torch, name, gpu
        S.POS_KERNEL.launches = 0
        K.KERNEL.launches = 0
        LK.KERNEL.launches = 0
        dd.failover_lanes = 0
        ld.failover_blocks = 0
        health.total_failures = 0
        self.sw0 = core.engine().sw_requests
        self.zero()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def zero(self) -> None:
        """Mark the start of one request inside the part."""
        self.mark = self.counts()

    def counts(self, since: bool = False) -> dict:
        """The part's counts so far, or since the last ``zero``."""
        from qatzip_tpu_torch.engine import core
        from qatzip_tpu_torch.engine.health import health
        from qatzip_tpu_torch.ops import deflate_decode as dd
        from qatzip_tpu_torch.ops import inflate_kernel as K
        from qatzip_tpu_torch.ops import lz4_decode as ld
        from qatzip_tpu_torch.ops import lz4_kernel as LK
        from qatzip_tpu_torch.ops import select as S

        now = {"select_to_positions": S.POS_KERNEL.launches,
               "inflate_decode": K.KERNEL.launches,
               "lz4_decode": LK.KERNEL.launches,
               "failover_lanes": dd.failover_lanes,
               "failover_blocks": ld.failover_blocks,
               "health_failures": health.total_failures,
               "sw_requests": core.engine().sw_requests - self.sw0}
        if since:
            return {k: v - self.mark[k] for k, v in now.items()}
        return now

    def done(self, extra: str = "") -> dict:
        self.torch.cuda.synchronize()
        dt = time.perf_counter() - self.t0
        c = self.counts()
        print(f"edges {self.name}: {dt:.4f} s ({self.gpu}); launches select "
              f"{c['select_to_positions']}, inflate {c['inflate_decode']}, "
              f"lz4 decode {c['lz4_decode']}; "
              f"failover lanes {c['failover_lanes']}, blocks "
              f"{c['failover_blocks']}; health failures "
              f"{c['health_failures']}; software requests "
              f"{c['sw_requests']}{extra}")
        return {k: c[k] for k in ("select_to_positions", "inflate_decode",
                                  "lz4_decode")}


def _fuzz(buf: bytearray, rng, kind: int) -> list:
    """Mutate ``buf`` as the reference's fuzz does (tests/test_fuzz.py): kind
    0 flips 1-4 bytes, 1 truncates, 2 splices a 4-63 byte window over
    another offset.  Returns the (start, end) byte ranges it changed (a
    truncation: from the cut to the end)."""
    if kind == 0:
        spans = []
        for _ in range(int(rng.integers(1, 5))):
            i = int(rng.integers(0, len(buf)))
            buf[i] ^= int(rng.integers(1, 256))
            spans.append((i, i + 1))
        return spans
    if kind == 1:
        cut = int(rng.integers(1, len(buf)))
        n = len(buf)
        del buf[cut:]
        return [(cut, n)]
    w = int(rng.integers(4, 64))
    src = int(rng.integers(0, len(buf) - w))
    dst = int(rng.integers(0, len(buf) - w))
    buf[dst:dst + w] = buf[src:src + w]
    return [(dst, dst + w)]


def _gz_members(buf: bytes) -> list:
    """(start, end) of each gzip-ext member of a well-formed stream."""
    from qatzip_tpu_torch.formats import gzip_fmt

    out, pos = [], 0
    while pos < len(buf):
        ext = gzip_fmt.parse_gzipext_header(buf, pos)
        _check(ext is not None, "not a gzip-ext stream")
        end = pos + gzip_fmt.GZIPEXT_HEADER_SIZE + ext.dest_sz + 8
        out.append((pos, end))
        pos = end
    return out


def _lz4_blocks(buf: bytes) -> list:
    """(offset, size) of each compressed block of an LZ4-frame stream."""
    import struct

    from qatzip_tpu_torch.formats import lz4_fmt

    out, pos = [], 0
    while pos < len(buf):
        hlen, _ = lz4_fmt.parse_lz4_frame_header(buf, pos)
        pos += hlen
        while True:
            (size,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            if size == 0:
                pos += 4          # the content checksum
                break
            if not size & 0x80000000:
                out.append((pos, size))
            pos += size & 0x7FFFFFFF
    return out


def _gz_session(qt, fmt=None, hw_buff_sz: int | None = None):
    """A level-1 session, gzip-ext unless ``fmt``, at CHUNK unless
    ``hw_buff_sz``."""
    sess = qt.QzSession()
    params = qt.QzSessionParamsDeflate(
        common_params=qt.QzSessionParamsCommon(
            comp_lvl=1, hw_buff_sz=hw_buff_sz or CHUNK),
        data_fmt=fmt or qt.QzDataFormat.QZ_DEFLATE_GZIP_EXT)
    _check(qt.qz_setup_session_deflate(sess, params) == qt.QZ_OK,
           "session setup failed")
    return sess


def _edge_corrupt_round(torch, corpus: bytes, dev, gpu: str) -> dict:
    """Part 1: one lockstep round of 128 lanes of 16 KB zlib-L1 chunks, a
    third corrupted past their dynamic header, one in eight truncated, a
    few idle, at the step bound the clean round takes (a corrupted lane
    without an end of block runs to it): the kernel equals its plain
    version on all five outputs; then step 2's clean 512-lane round again,
    equal to its first run."""
    import numpy as np

    from qatzip_tpu_torch.ops import deflate_decode as dd
    from qatzip_tpu_torch.ops import inflate as PI

    part = _EdgePart(torch, "corrupt round", gpu)
    streams = []
    for i in range(LANES):
        chunk = corpus[i * EDGE_LANE:(i + 1) * EDGE_LANE]
        co = zlib.compressobj(1, zlib.DEFLATED, -15)
        s = dd._Stream(co.compress(chunk) + co.flush(), len(chunk), i)
        _check(dd._parse_one_header(s) == "huff", "expected a Huffman block")
        streams.append(s)
    live, inputs = dd.pack_round(streams)
    _check(len(live) == LANES, "every lane must take part in the round")
    words, bit0, nbits, tll, td, active, bound = inputs
    # the step bound: what the clean round takes (the kernel, once)
    clean_run = PI.decode_lockstep(*PI.upload(*inputs[:6], dev), bound)
    max_steps = int(clean_run[4][0])
    _check(not bool(clean_run[1].any()), "a lane of the clean round errored")
    stream8 = words.view(np.uint8)
    rng = np.random.default_rng(EDGE_SEED)
    lanes = np.arange(LANES)
    corrupt, trunc, idle = lanes % 3 == 1, lanes % 8 == 5, lanes % 32 == 7
    for i in lanes[corrupt]:
        # bytes flipped from the middle on, past the dynamic header, as
        # tests/test_torch_inflate.py does
        nb = int(nbits[i]) // 8
        stream8[i, nb // 2:nb - 4:5] ^= 0x5A
    for i in lanes[trunc]:
        nb = int(nbits[i]) // 8
        cut = int(rng.integers(nb // 8, nb))
        stream8[i, cut:] = 0
        nbits[i] = cut * 8
    active[idle] = False
    t = PI.upload(words, bit0, nbits, tll, td, active, dev)
    ker = PI.decode_lockstep(*t, max_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = PI._decode_ref(*t, max_steps)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for name, a, b in zip(("tokens", "err", "outcnt", "end_bit", "nsteps"),
                          ker, ref):
        _check(torch.equal(a, b), f"corrupt round: kernel != plain in {name}")
    err = ker[1].cpu().numpy()
    clean = ~(corrupt | trunc | idle)
    _check(not err[clean].any(), "a clean lane of the corrupt round errored")
    _check(not err[idle].any() and not ker[2].cpu().numpy()[idle].any(),
           "an idle lane decoded")
    t5, ms5, want = _ROUNDS[max(_ROUNDS)]
    again = PI.decode_lockstep(*t5, ms5)
    for name, a, b in zip(("tokens", "err", "outcnt", "end_bit", "nsteps"),
                          again, want):
        _check(torch.equal(a, b), f"step 2's clean round changed in {name} "
               f"after the corrupt round")
    return part.done(
        f"; {LANES} lanes, nsteps {int(ker[4][0])} of {max_steps}: kernel "
        f"equal to plain ({plain_s:.1f} s) on all five outputs; errored "
        f"lanes {int(err.sum())} (corrupted {int(err[corrupt].sum())} of "
        f"{int(corrupt.sum())}, truncated {int(err[trunc].sum())} of "
        f"{int(trunc.sum())}; {int(idle.sum())} idle lanes decoded nothing); step 2's "
        f"{t5[0].shape[0]}-lane round again equal")


def _edge_api_fuzz(torch, corpus: bytes, gpu: str) -> tuple:
    """Part 2: the corpus compressed gzip-ext L1 at 64 KB chunks, then 9
    mutated copies (3 each of point mutations, truncation and a spliced
    window, from EDGE_SEED) decompressed on the card: the reference's rc
    class, a prefix of the input on QZ_OK, inflate launched unless the
    first member's header no longer parses, no health failure, software
    request or CPU rerun of a batch (a chunk zlib refuses after its lane
    failed over ends the request), and no more lanes failed over than
    chunks touched.  Returns (launches, the compressed stream)."""
    import numpy as np

    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.formats import gzip_fmt

    part = _EdgePart(torch, "api fuzz", gpu)
    res = qt.qz_compress(_gz_session(qt), corpus)
    _check(res.rc == qt.QZ_OK, f"compress rc {res.rc}")
    comp = res.data
    members = _gz_members(comp)
    nbatch = -(-len(members) // LANES)
    _check(part.counts()["select_to_positions"] >= nbatch,
           "the compress did not launch select once a batch")
    rng = np.random.default_rng(EDGE_SEED)
    ok_codes = {qt.QZ_OK, qt.QZ_DATA_ERROR, qt.QZ_BUF_ERROR, qt.QZ_FAIL}
    rows = []
    for trial in range(9):
        buf = bytearray(comp)
        spans = _fuzz(buf, rng, trial % 3)
        touched = {k for k, (a, b) in enumerate(members)
                   for lo, hi in spans if lo < b and hi > a}
        # a first member whose header no longer parses (or is cut) ends
        # the request before any batch: no launch is owed
        ext = gzip_fmt.parse_gzipext_header(bytes(buf), 0)
        head_broken = (ext is None or ext.dest_sz
                       > len(buf) - gzip_fmt.GZIPEXT_HEADER_SIZE)
        part.zero()
        out = qt.qz_decompress(_gz_session(qt), bytes(buf))
        c = part.counts(since=True)
        _check(out.rc in ok_codes, f"api fuzz {trial}: rc {out.rc}")
        _check(out.rc != qt.QZ_OK or corpus.startswith(out.data),
               f"api fuzz {trial}: QZ_OK with bytes that are not a prefix")
        _check(c["inflate_decode"] >= 1 or head_broken,
               f"api fuzz {trial}: no inflate launch")
        if head_broken:
            print(f"edges api fuzz {trial}: the first member's header no "
                  f"longer parses, so no inflate launch is owed")
        _check(c["health_failures"] == 0 and c["sw_requests"] == 0
               and not out.ext_rc & qt.QZ_SW_EXECUTION_MASK,
               f"api fuzz {trial}: a batch failed over ({c}, ext_rc "
               f"{out.ext_rc:#x})")
        _check(c["failover_lanes"] <= len(touched),
               f"api fuzz {trial}: {c['failover_lanes']} lanes failed over "
               f"for {len(touched)} chunks touched")
        rows.append(f"{('point', 'cut', 'splice')[trial % 3]} rc {out.rc} "
                    f"lanes {c['failover_lanes']}/{len(touched)} out "
                    f"{len(out.data)} inflate {c['inflate_decode']}")
    launches = part.done(f"; {len(corpus)} bytes, {len(members)} chunks, "
                         f"9 copies (rc, lanes failed over / chunks "
                         f"touched, output bytes, inflate launches; no CPU "
                         f"rerun): "
                         + "; ".join(rows))
    return launches, comp


def _edge_sweep(torch, corpus: bytes, dev, gpu: str) -> dict:
    """Part 3: the reference's boundary lengths (tests/test_sweep.py) x
    text, random and constant through the device codec at 4 KB chunks on
    the card (below the API's 1 KB threshold too; an empty request as one
    empty chunk), the select kernel launched for each, bytes equal to the
    codec's CPU-tensor route, framed as gzip that gzip reads and the card
    decompresses; then gzip, gzip-ext, raw, 4B and zlib at L1 and L9 on
    1 MB through the API, bytes equal to the CPU-tensor route's."""
    import numpy as np

    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.engine import core, framing
    from qatzip_tpu_torch.ops import device_codecs as dc
    from qatzip_tpu_torch.ops import select as S

    part = _EdgePart(torch, "sweep", gpu)
    cpu = torch.device("cpu")
    codec = dc.DeflateDeviceCodec()
    gz = qt.QzDataFormat.QZ_DEFLATE_GZIP
    params = _gz_session(qt, gz, 4096).params
    lengths = [0, 1, 2, 3, 4, 5, 11, 12, 13, 255, 256, 4095, 4096, 4097,
               8191, 12288]
    rnd = np.random.default_rng(EDGE_SEED).integers(
        0, 256, max(lengths), np.uint8).tobytes()
    cases = 0
    for kind, src in (("text", corpus), ("random", rnd),
                      ("constant", b"A" * max(lengths))):
        for n in lengths:
            data = src[:n]
            # an empty request is one empty chunk, as the API makes it
            chunks = [data[i:i + 4096] for i in range(0, n, 4096)] or [b""]
            part.zero()
            got = codec.compress_chunks(chunks, params, dev)
            sel = part.counts(since=True)["select_to_positions"]
            _check(sel >= 1, f"sweep {kind} {n}: no select launch")
            want = codec.compress_chunks(chunks, params, cpu)
            _check([(c.payload, c.checksum) for c in got]
                   == [(c.payload, c.checksum) for c in want],
                   f"sweep {kind} {n}: card bytes != CPU-tensor bytes")
            comp = b"".join(framing.frame_chunk(
                params.data_fmt, c.payload, c.consumed, c.checksum)
                for c in got)
            _check(gzip.decompress(comp) == data,
                   f"sweep {kind} {n}: gzip cannot read it")
            _check(qt.decompress(comp, hw_buff_sz=4096) == data,
                   f"sweep {kind} {n}: the card's decompress != input")
            cases += 1
    backend = core.engine().hw_backend
    src = corpus[:1 << 20]
    fmts = {"gzip": ("deflate", gz),
            "gzip_ext": ("deflate", qt.QzDataFormat.QZ_DEFLATE_GZIP_EXT),
            "raw": ("deflate", qt.QzDataFormat.QZ_DEFLATE_RAW),
            "4b": ("deflate", qt.QzDataFormat.QZ_DEFLATE_4B),
            "zlib": ("zlib", None)}
    for name, (algorithm, fmt) in fmts.items():
        for level in (1, 9):
            comp = qt.compress(src, algorithm, fmt=fmt, level=level,
                               hw_buff_sz=CHUNK)
            backend.device = cpu
            try:
                want = qt.compress(src, algorithm, fmt=fmt, level=level,
                                   hw_buff_sz=CHUNK)
            finally:
                backend.device = dev
            _check(comp == want, f"{name} L{level}: card bytes != CPU-tensor "
                   f"route's")
            if name in ("gzip", "gzip_ext"):
                _check(gzip.decompress(comp) == src, f"{name} L{level}: "
                       f"gzip cannot read it")
            _check(qt.decompress(comp, algorithm, fmt=fmt,
                                 hw_buff_sz=CHUNK) == src,
                   f"{name} L{level}: the card's decompress != input")
    c = part.counts()
    _check(c["health_failures"] == 0 and c["failover_lanes"] == 0
           and c["sw_requests"] == 0, f"sweep: {c}")
    _check(S.POS_KERNEL.launches > 0, "sweep: select never launched")
    return part.done(f"; {cases} length cases (select launched for each, "
                     f"bytes equal to the CPU-tensor route, "
                     f"gzip reads them, the card returns the input); "
                     f"gzip, gzip-ext, raw, 4B, zlib at L1 and L9 on 1 MB: "
                     f"bytes equal to the CPU-tensor route, round trips "
                     f"exact")


def _edge_faults(torch, corpus: bytes, comp: bytes, gpu: str) -> dict:
    """Part 4: injected faults on the corpus, gzip-ext L1: submit (one batch
    reroutes), death mid-batch, poison compress (harmless), poison and
    checksum decompress (detected), then FAILURE_TRIP failures that open
    the breaker, a request on the software route with no launch, and past
    the cooldown (the breaker's clock moved, not slept) a probe request
    that revives the device."""
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.engine import core, faults
    from qatzip_tpu_torch.engine import health as hm

    part = _EdgePart(torch, "faults", gpu)
    nbatch = -(-len(corpus) // (CHUNK * LANES))
    notes = []
    for kind, sel in (("submit", nbatch - 1), ("death", nbatch),
                      ("poison", nbatch)):
        faults.inject_error(kind, nth=1, direction="compress", count=1)
        part.zero()
        res = qt.qz_compress(_gz_session(qt), corpus)
        c = part.counts(since=True)
        _check(not faults.armed(), f"{kind}: the fault did not fire")
        _check(res.rc == qt.QZ_OK and gzip.decompress(res.data) == corpus,
               f"{kind}: the stream does not read back")
        _check(c["health_failures"] == (kind != "poison"),
               f"{kind}: {c['health_failures']} batches rerouted")
        _check(c["select_to_positions"] == sel,
               f"{kind}: select launched {c['select_to_positions']}, not "
               f"{sel}")
        if kind == "poison":
            _check(qt.qz_decompress(_gz_session(qt), res.data).data
                   == corpus, "poison: the card cannot read the stream")
        notes.append(f"{kind} compress: {c['health_failures']} batch "
                     f"rerouted, select {c['select_to_positions']}"
                     + (f", bytes equal to the clean run "
                        f"{res.data == comp}" if kind == "poison" else ""))
        hm.health.record_success()
    for kind in ("poison", "checksum"):
        faults.inject_error(kind, nth=1, direction="decompress", count=1)
        part.zero()
        res = qt.qz_decompress(_gz_session(qt), comp)
        c = part.counts(since=True)
        _check(not faults.armed(), f"{kind}: the fault did not fire")
        _check(res.rc == qt.QZ_DATA_ERROR, f"{kind} decompress: rc {res.rc}")
        _check(c["inflate_decode"] >= 1, f"{kind}: no inflate launch")
        notes.append(f"{kind} decompress: rc {res.rc}, inflate "
                     f"{c['inflate_decode']}")
    # the breaker: a batch a request (64 chunks), a submit fault each time
    src = corpus[:LANES * CHUNK // 2]
    eng = core.engine()
    faults.inject_error("submit", direction="compress", count=-1)
    try:
        for _ in range(hm.FAILURE_TRIP):
            res = qt.qz_compress(_gz_session(qt), src)
            _check(gzip.decompress(res.data) == src, "trip: bad stream")
        _check(not hm.health.healthy(), "the breaker did not open")
        part.zero()
        hw0 = eng.hw_requests
        res = qt.qz_compress(_gz_session(qt), src)
        c = part.counts(since=True)
        _check(res.rc == qt.QZ_OK and res.ext_rc & qt.QZ_SW_EXECUTION_MASK
               and eng.hw_requests == hw0 and c["sw_requests"] > 0
               and c["select_to_positions"] == 0,
               f"breaker open: the request did not stay on the software "
               f"route ({c})")
    finally:
        faults.clear()

    class _PastCooldown:
        """The breaker's clock, past its cooldown."""
        sleep = staticmethod(time.sleep)

        @staticmethod
        def monotonic():
            return time.monotonic() + hm.COOLDOWN_S + 1

    hm.time = _PastCooldown
    try:
        part.zero()
        res = qt.qz_compress(_gz_session(qt), src)
        back = qt.qz_decompress(_gz_session(qt), res.data)
        c = part.counts(since=True)
    finally:
        hm.time = time
    _check(hm.health.healthy(), "the probe did not close the breaker")
    _check(back.data == src and not (res.ext_rc | back.ext_rc)
           & qt.QZ_SW_EXECUTION_MASK, "revival: not a device round trip")
    _check(c["select_to_positions"] >= 1 and c["inflate_decode"] >= 1,
           f"revival: select {c['select_to_positions']}, inflate "
           f"{c['inflate_decode']}")
    notes.append(f"trip after {hm.FAILURE_TRIP} failures, open: 0 launches, "
                 f"software; revived: select {c['select_to_positions']}, "
                 f"inflate {c['inflate_decode']}")
    return part.done("; " + "; ".join(notes))


def _edge_threads(torch, corpus: bytes, gpu: str) -> dict:
    """Part 5: four threads each compress and decompress a quarter of the
    corpus (8 MB) through cuda:0 at once; every result equals the serial run's, no software
    request or failure, and at least the serial run's launches."""
    import threading

    import qatzip_tpu_torch as qt

    part = _EdgePart(torch, "threads", gpu)
    q = len(corpus) // 4
    slices = [corpus[i * q:(i + 1) * q] for i in range(4)]

    def run(i, out):
        c = qt.qz_compress(_gz_session(qt), slices[i])
        d = qt.qz_decompress(_gz_session(qt), c.data)
        out[i] = (c.rc, c.data, d.rc, d.data,
                  (c.ext_rc | d.ext_rc) & qt.QZ_SW_EXECUTION_MASK)

    serial: dict = {}
    for i in range(4):
        run(i, serial)
    s_counts = part.counts()
    part.zero()
    t0 = time.perf_counter()
    together: dict = {}
    ts = [threading.Thread(target=run, args=(i, together)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    c = part.counts(since=True)
    _check(all(not t.is_alive() for t in ts), "a thread did not finish")
    for i in range(4):
        _check(serial[i][0] == serial[i][2] == qt.QZ_OK
               and serial[i][3] == slices[i] and not serial[i][4],
               f"threads: serial run {i} failed")
        _check(together.get(i) == serial[i],
               f"threads: thread {i}'s result != the serial run's")
    for k in ("select_to_positions", "inflate_decode"):
        _check(c[k] >= s_counts[k], f"threads: {k} {c[k]} < serial "
               f"{s_counts[k]}")
    _check(c["sw_requests"] == 0 and c["health_failures"] == 0
           and c["failover_lanes"] == 0, f"threads: {c}")
    return part.done(f"; 4 x {q} bytes at once {wall:.4f} s: results equal the "
                     f"serial run's (select {s_counts['select_to_positions']}"
                     f", inflate {s_counts['inflate_decode']} serial; "
                     f"{c['select_to_positions']}, {c['inflate_decode']} "
                     f"at once)")


def _edge_lz4(torch, corpus: bytes, dev, gpu: str) -> dict:
    """Part 6: the 8 MB LZ4-frame stream with six compressed blocks mutated
    (three by point mutations, three by a zeroed tail): decoded on cuda:0 through the API (rc class, prefix on QZ_OK)
    and block by block, the blocks failed over are the ones the native
    decoder refuses and the others decode to its bytes; then a clean group
    decodes to its bytes (the card survived)."""
    import numpy as np

    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.engine.lz4_block import lz4_block_decompress
    from qatzip_tpu_torch.ops import lz4_decode as ld

    part = _EdgePart(torch, "lz4 blocks", gpu)
    src = corpus[:8 << 20]

    def session():
        sess = qt.QzSession()
        _check(qt.qz_setup_session_lz4(sess, qt.QzSessionParamsLZ4(
            common_params=qt.QzSessionParamsCommon(
                comp_lvl=1, hw_buff_sz=CHUNK))) == qt.QZ_OK, "lz4 session")
        return sess

    comp = qt.qz_compress(session(), src).data
    spans = _lz4_blocks(comp)
    rng = np.random.default_rng(EDGE_SEED)
    buf = bytearray(comp)
    hit = sorted(int(k) for k in rng.choice(len(spans), 6, replace=False))
    for j, k in enumerate(hit):
        off, size = spans[k]
        if j % 2:
            # a zeroed tail: zero tokens and offsets, which no decoder takes
            buf[off + size - 16:off + size] = bytes(16)
            continue
        for _ in range(3):   # point mutations, mostly in literals
            buf[off + int(rng.integers(0, size))] ^= int(rng.integers(1, 256))
    blocks = [bytes(buf[o:o + n]) for o, n in spans]

    def native(blk):
        try:
            return lz4_block_decompress(blk, CHUNK)
        except ValueError:
            return None

    want = [native(b) for b in blocks]
    refused = sum(w is None for w in want)
    _check(refused > 0, "lz4: the native decoder took every mutated block")
    part.zero()
    res = qt.qz_decompress(session(), bytes(buf))
    c = part.counts(since=True)
    _check(res.rc in (qt.QZ_OK, qt.QZ_DATA_ERROR, qt.QZ_BUF_ERROR,
                      qt.QZ_FAIL), f"lz4: rc {res.rc}")
    _check(res.rc != qt.QZ_OK or src.startswith(res.data),
           "lz4: QZ_OK with bytes that are not a prefix")
    _check(c["health_failures"] == 0 and c["sw_requests"] == 0
           and not res.ext_rc & qt.QZ_SW_EXECUTION_MASK,
           f"lz4: a batch failed over ({c}, ext_rc {res.ext_rc:#x})")
    api_blocks = c["failover_blocks"]
    _check(c["lz4_decode"] >= 1, "lz4: the decompress ran no LZ4 decode "
           "kernel")
    part.zero()
    got = ld.decode_blocks(blocks, device=dev)
    _check(part.counts(since=True)["lz4_decode"] == -(-sum(
        0 < len(b) <= ld.MAX_BLOCK for b in blocks) // (
            ld.LAUNCH_OUT_BYTES // ld.MAX_OUT)),
           "lz4: decode_blocks did not launch the kernel once a capped "
           "launch")
    _check([g is None for g in got] == [w is None for w in want],
           "lz4: the blocks failed over are not the ones the native decoder "
           "refuses")
    _check(all(g == w for g, w in zip(got, want) if w is not None),
           "lz4: a block decoded on the card != the native decoder")
    clean = [comp[o:o + n] for o, n in spans[:ld.GROUP]]
    part.zero()
    again = ld.decode_blocks(clean, device=dev)
    _check(part.counts(since=True)["failover_blocks"] == 0
           and again == [native(b) for b in clean],
           "lz4: a clean group after the corrupt blocks != native")
    return part.done(f"; {len(spans)} compressed blocks, {len(hit)} mutated "
                     f"(3 point, 3 zeroed tails), "
                     f"{refused} refused by the native decoder; API rc "
                     f"{res.rc} ({len(res.data)} bytes out), "
                     f"{api_blocks} blocks failed over; block by block the "
                     f"same blocks fail over, the rest equal native; a "
                     f"clean group of {len(clean)} equal after")


def phase_edges(torch, corpus: bytes, dev) -> dict:
    """Step 8: the failure and edge paths of the select and inflate kernels
    on the card, the device route forced, each part with its counts zeroed
    before it and its line after.  Returns {part: launches}."""
    from qatzip_tpu_torch.engine import faults
    from qatzip_tpu_torch.engine.health import health

    os.environ["QATZIP_TPU_DEVICE"] = "1"
    gpu = _gpu_line()
    t0 = time.perf_counter()
    records = {"corrupt_round": _edge_corrupt_round(torch, corpus, dev, gpu)}
    records["api_fuzz"], comp = _edge_api_fuzz(torch, corpus, gpu)
    records["sweep"] = _edge_sweep(torch, corpus, dev, gpu)
    records["faults"] = _edge_faults(torch, corpus, comp, gpu)
    records["threads"] = _edge_threads(torch, corpus, gpu)
    records["lz4_blocks"] = _edge_lz4(torch, corpus, dev, gpu)
    _check(not faults.armed() and health.healthy(),
           "step 8 left a fault armed or the breaker open")
    print(f"edges: {time.perf_counter() - t0:.1f} s in all; launches "
          f"{json.dumps(records)}")
    return records


class _KernelEvents:
    """While active, every launch of a port kernel (``_build.Kernel``) is
    bracketed by CUDA events on the current stream, so its device time is
    known whether or not the profiler keeps its record: on the H100 the
    profiler was seen to drop records of short passes, the port's kernels'
    and torch's own copies alike (a whole LZ4s decompress pass showed no
    device row)."""

    def __init__(self, torch):
        from qatzip_tpu_torch.ops import _build

        self.torch, self.cls, self.call = torch, _build.Kernel, None
        self.launches: list = []

    def __enter__(self):
        torch, launches, call = self.torch, self.launches, self.cls.__call__

        def timed(kernel, *args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            call(kernel, *args)
            stop.record()
            launches.append((kernel.symbol, start, stop))

        self.call, self.cls.__call__ = call, timed
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.call

    def ms(self) -> dict:
        """{symbol: (ms, launches)} of the launches made while active."""
        out: dict = {}
        for symbol, start, stop in self.launches:
            ms, k = out.get(symbol, (0.0, 0))
            out[symbol] = (ms + start.elapsed_time(stop), k + 1)
        return out


def phase_profile(torch, runs: list) -> None:
    """Device busy time and the host's top functions, one pass each way of
    each session.

    The idle share is taken against the median unprofiled wall time of the
    session's phase, since the profiler itself slows the host.  Device busy
    is the profiler's rows of torch's own work plus the port's kernels
    timed by CUDA events (``_KernelEvents``), since the profiler drops
    records of short passes."""
    import qatzip_tpu_torch as qt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()   # the first session pays the set-up
    passes = [(label, direction, sess, src if direction == "compress" else
               comp, walls[direction])
              for label, sess, src, comp, walls in runs
              for direction in ("compress", "decompress")]
    for label, direction, sess, data, unprofiled in passes:
        def fn():
            return (qt.qz_compress(sess, data) if direction == "compress"
                    else qt.qz_decompress(sess, data))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _KernelEvents(torch) as ev, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # device-side rows only: a CPU op's device time repeats its kernels'
        dev_rows = sorted((e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA),
                          key=lambda e: -e.self_device_time_total)
        torch_rows = [e for e in dev_rows if not e.key.startswith("qz_")]
        ours = ev.ms()
        busy = (sum(e.self_device_time_total for e in torch_rows) / 1e6
                + sum(ms for ms, _ in ours.values()) / 1e3)
        _check(busy > 0, f"no device time in {label} {direction}")
        seen = sum(e.count for e in dev_rows if e.key.startswith("qz_"))
        print(f"profile {label} {direction}: device busy {busy:.6f} s "
              f"(torch's rows in the profiler, the port's kernels by CUDA "
              f"events; the profiler kept {seen} of their "
              f"{len(ev.launches)} launches); wall {unprofiled:.6f} s "
              f"unprofiled (median), {wall:.4f} s profiled; idle share "
              f"{1 - busy / unprofiled:.4f}")
        for symbol, (ms, k) in sorted(ours.items()):
            print(f"  kernel {symbol}: {ms:.4f} ms over {k} launches (CUDA "
                  f"events)")
        for e in torch_rows[:6]:
            print(f"  device {e.self_device_time_total / 1e3:10.3f} ms "
                  f"x{e.count:<6d} {e.key[:70]}")
        pr = cProfile.Profile()
        pr.enable()
        fn()
        torch.cuda.synchronize()
        pr.disable()
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(10)
        lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
        print(f"host {label} {direction}, top self time:")
        for ln in lines[3:16]:
            print("  " + ln[:150])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qatzip_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_environment(torch)
    from qatzip_tpu_torch.tools.corpus import build_corpus

    dev = torch.device("cuda", 0)
    corpus = build_corpus(32)
    kernels = phase_select(torch, corpus, dev)
    probes = phase_probes(torch, dev)
    kernels.insert(1, phase_inflate(torch, corpus, dev, probes))
    sort_rec = phase_sort(torch, corpus, dev)
    lz4_rec = phase_lz4_decode(torch, corpus, dev, probes)
    with tempfile.TemporaryDirectory() as tmpdir:
        rec = phase_calibrate(tmpdir)
        runs = [phase_slice(torch, corpus, kernels, sort_rec, probes)]
        runs += phase_lz4(torch, corpus, lz4_rec)
        kernels.append(lz4_rec)
        main = {k["name"]: k for k in kernels}
        api = phase_api(torch, corpus, tmpdir,
                        main["inflate_decode"]["launches"])
        parity, parity_kernels = phase_parity_dist(torch, corpus, dev,
                                                   tmpdir)
        edges = phase_edges(torch, corpus, dev)
        for name in ("select_to_positions", "inflate_decode"):
            # each step's launches of the path's kernels
            main[name]["api_launches"] = {step: counts[name]
                                          for step, counts in api.items()}
            main[name]["parity_dist_launches"] = {
                step: counts[name] for step, counts in parity.items()}
            main[name]["edge_launches"] = {
                part: counts[name] for part, counts in edges.items()}
        # the LZ4 decode kernel's launches where a part counted them
        lz4_rec["parity_dist_launches"] = {
            step: counts["lz4_decode"] for step, counts in parity.items()
            if "lz4_decode" in counts}
        lz4_rec["edge_launches"] = {
            part: counts["lz4_decode"] for part, counts in edges.items()}
        phase_profile(torch, runs)
        phase_routing(torch, corpus, rec)
    kernels.append(sort_rec)
    kernels += parity_kernels
    kernels += probes
    _check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {_gpu_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
