"""The per-layer metrics read from the program's own spans and set-up
record: a traced run of each direction on the CPU, at a small size, reads
every one listed for its cell; and loading a reader imports nothing of the
program (readers load before a run sets the program's environment)."""
import copy
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from qzbench import harness

CPU = torch.device("cpu")
GZC, GZD = "gzipext_l1.compress_128m_c4", "gzipext_l1.decompress_32m_c4"
PROGRAM_SPANS = ["inflate_parse_ms", "inflate_tables_ms", "inflate_device_ms",
                 "inflate_apply_ms", "inflate_host_cpu_pct",
                 "pool_wait_ms.decompress", "init_import_s", "init_engine_s",
                 "warmup_first_use_s"]


def _bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _small(name):
    cell = harness.Cell(_bench(), name)
    chunk = 4096 if name == GZD else 65536
    cell.traffic = dict(cell.traffic, clients=1 if name == GZD else 2,
                        request_bytes=2 * chunk)
    cell.config = copy.deepcopy(cell.config)
    cell.config["chunk_bytes"] = chunk
    cell.config["session"]["common"]["hw_buff_sz"] = chunk
    return cell


def test_every_program_span_metric_has_its_entry():
    entries = {m["name"]: m for m in _bench()["per_layer"]}
    for name in PROGRAM_SPANS:
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"]
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           name + ".py"))


@pytest.mark.parametrize("name", [GZC, GZD])
def test_a_traced_run_reads_the_program_spans(name):
    cell = _small(name)
    result, _ = harness.run_cell(cell, 2**31 + 29, 0.01, True,
                                 time.perf_counter(), device=CPU)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    listed = [m["name"] for m in cell.per_layer if m["name"] in PROGRAM_SPANS]
    assert listed and all(n in got for n in listed), (listed, sorted(got))
    for n in listed:
        assert got[n]["value"] >= 0
    if name == GZD:
        parts = sum(got[f"inflate_{p}_ms"]["value"]
                    for p in ("parse", "tables", "device", "apply"))
        assert parts > 0 and 0 < got["inflate_host_cpu_pct"]["value"] <= 105
        assert got["init_import_s"]["value"] > 0


def test_loading_a_reader_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from qzbench import harness\n"
        "for n in %r:\n"
        "    harness.load_module(harness.HERE + '/metrics/' + n + '.py', n)\n"
        "print(sorted(m for m in sys.modules if m.startswith('qatzip')))\n"
        % (harness.ROOT, PROGRAM_SPANS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
