"""The LZ4 decompress cell, ``lz4_l1.decompress_32m_c4``: its per-layer
readers on the CPU.  The roofline of the LZ4 block kernel counts only the
compressed blocks of the cell's own input, in and decoded out, and reads
nothing without the kernel's device time; a traced run at a small size
reads every one of the program's LZ4 spans; and loading a reader imports
nothing of the program."""
import copy
import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from qzbench import harness, lz4plain, xxh32

CPU = torch.device("cpu")
L4D = "lz4_l1.decompress_32m_c4"
SPAN_READERS = ["lz4_walk_ms", "lz4_stage_ms", "lz4_device_ms",
                "lz4_collect_ms", "lz4_checksum_ms"]
ROOFLINE = "lz4_block_roofline"


def _bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _cell(chunk=None, clients=None):
    cell = harness.Cell(_bench(), L4D)
    if chunk:
        cell.traffic = dict(cell.traffic, clients=clients,
                            request_bytes=2 * chunk)
        cell.config = copy.deepcopy(cell.config)
        cell.config["chunk_bytes"] = chunk
        cell.config["session"]["common"]["hw_buff_sz"] = chunk
    return cell


def _request():
    """One stored frame (random bytes) and one compressed frame (text)."""
    import random

    noise = random.Random(3).randbytes(4096)
    text = b"the quick brown fox jumps over the lazy dog. " * 200
    stored, packed = lz4plain.compress_blocks([noise, text])
    assert stored is None and packed is not None and len(packed) < 1000
    stream = (lz4plain.frame(noise, None, xxh32.xxh32(noise))
              + lz4plain.frame(text, packed, xxh32.xxh32(text)))
    return stream, len(packed) + len(text)


def test_the_cell_and_its_readers_are_listed():
    bench = _bench()
    cell = _cell()
    assert cell.chips == 1 and cell.config["name"] == "lz4_l1"
    assert cell.request_bytes == 32 << 20
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"decompress_gbps", "setup_s"}
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_READERS + [ROOFLINE]:
        m = entries[name]
        assert m["workloads"] == [L4D] and m["moves"] == "decompress_gbps"
        assert name in cell.readers
    assert entries[ROOFLINE]["source"] == "device_trace"
    assert {entries[n]["source"] for n in SPAN_READERS} == {"program_span"}


def test_the_roofline_counts_only_the_compressed_block():
    stream, want = _request()
    reader = _cell().readers[ROOFLINE]
    assert reader.kernel_bytes(stream) == want
    # a frame whose compressed block has no content size cannot be counted
    blind = bytearray(lz4plain.frame(b"ab" * 600, lz4plain.compress_blocks(
        [b"ab" * 600])[0], 0))
    blind[4] &= ~0x08
    assert reader.kernel_bytes(bytes(blind)) is None
    assert reader.kernel_bytes(b"not a frame") is None


def test_the_roofline_reads_nothing_without_device_time():
    stream, want = _request()
    cell = _cell()
    reader = cell.readers[ROOFLINE]
    run = harness.Run(cell)
    run.peaks = {"hbm_bytes_per_s": 3.35e12}
    run.spans["lz4_request"] = [types.SimpleNamespace(value=stream)] * 3
    assert run.device_s("lz4_kernel") is None
    assert reader.read(run) is None
    run.device_s = lambda span: 1e-6 if span == "lz4_kernel" else None
    got = reader.read(run)
    assert got == pytest.approx(100 * 3 * want / 3.35e12 / 1e-6)
    assert 0 < got < 100


def test_a_traced_run_reads_the_lz4_spans():
    cell = _cell(chunk=16384, clients=2)
    result, _ = harness.run_cell(cell, 2**31 + 41, 0.01, True,
                                 time.perf_counter(), device=CPU)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    assert all(n in got for n in SPAN_READERS), sorted(got)
    assert all(got[n]["value"] > 0 for n in SPAN_READERS)
    assert ROOFLINE not in got          # no card, no device time


def test_loading_a_reader_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from qzbench import harness\n"
        "for n in %r:\n"
        "    harness.load_module(harness.HERE + '/metrics/' + n + '.py', n)\n"
        "print(sorted(m for m in sys.modules if m.startswith('qatzip')))\n"
        % (harness.ROOT, SPAN_READERS + [ROOFLINE]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
