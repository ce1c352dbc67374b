"""A cell, its configuration, its traffic mix and its metrics are found by
name from files of their own; adding one is new files and entries only."""
import json
import os
import shutil

import pytest

from qzbench import harness

ROOT = harness.ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_loads_with_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"], ROOT)
        assert cell.traffic["direction"] in ("compress", "decompress")
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.reference, "read") and hasattr(
            cell.reference, "make")
        names = {m["name"] for m in cell.end_to_end + cell.per_layer}
        assert "setup_s" in names and names <= set(cell.readers)
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric, each per-layer metric's own moved metric too
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        e2e = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in e2e for m in cell.per_layer)


def test_request_size_from_the_config_unless_the_mix_cuts_it():
    bench = _bench()
    sizes = {}
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"], ROOT)
        sizes[w["name"]] = cell.request_bytes
        want = cell.traffic.get("request_bytes", cell.config["request_bytes"])
        assert cell.request_bytes == want
        # a cut of the source's request is listed as a reduced key
        cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
        assert "request_bytes" in cfg["reduced"]
    assert sizes["gzipext_l1.compress_128m_c4"] == 128 << 20
    assert sizes["gzipext_l1.decompress_32m_c4"] == 32 << 20


def test_unknown_cell_is_an_error():
    with pytest.raises(KeyError):
        harness.Cell(_bench(), "no_such_cell", ROOT)


def test_adding_a_config_traffic_and_metric_is_new_files(tmp_path):
    root = tmp_path / "co"
    shutil.copytree(os.path.join(ROOT, "qzbench"), root / "qzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "qzbench").rglob("*")
              if p.is_file()}
    bench = _bench()
    # a new configuration, traffic mix and per-layer metric: files
    cfg = json.loads((root / "qzbench/configs/gzipext_l1.json").read_text())
    cfg["name"] = "gzipext_l3"
    cfg["session"]["common"]["comp_lvl"] = 3
    (root / "qzbench/configs/gzipext_l3.json").write_text(json.dumps(cfg))
    (root / "qzbench/traffic/compress_1m_c2.json").write_text(json.dumps({
        "direction": "compress", "request_bytes": 1 << 20, "clients": 2,
        "loop": "closed", "warmup_requests": 1}))
    (root / "qzbench/metrics/requests_done.py").write_text(
        "def read(run):\n    return len(run.requests)\n")
    # and entries
    bench["configs"].append({"name": "gzipext_l3", "source": "x",
                             "file": "qzbench/configs/gzipext_l3.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "gzipext_l3.compress_1m_c2",
                               "config": "gzipext_l3",
                               "traffic": "compress_1m_c2", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({
        "name": "requests_done", "unit": "n", "better": "higher",
        "source": "host_clock", "layer": "API and funnel",
        "moves": "compress_ratio",
        "workloads": ["gzipext_l3.compress_1m_c2"]})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["compress_ratio"]["workloads"].append("gzipext_l3.compress_1m_c2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("gzipext_l3.compress_1m_c2", str(root))
    assert cell.config["session"]["common"]["comp_lvl"] == 3
    assert cell.traffic["request_bytes"] == 1 << 20
    assert "requests_done" in cell.readers
    assert {m["name"] for m in cell.end_to_end} == {"compress_ratio",
                                                   "setup_s"}
    run = harness.Run(cell)
    run.requests = [1, 2, 3]
    assert cell.readers["requests_done"].read(run) == 3
    # no file that was there changed
    for p, data in before.items():
        assert p.read_bytes() == data, p
