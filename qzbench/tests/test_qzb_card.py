"""On the card: every cell runs short and comes out correct, with each of
its end-to-end metrics, and the control comes out not correct at the
cell's own sizes.  Marked ``cuda``; each test decides by itself whether a
card is there.  On the card:

    python3 -m pytest -q -m cuda qzbench/tests/test_qzb_card.py
"""
import json
import os
import subprocess
import sys

import pytest

from qzbench import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(args):
    p = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, cwd=ROOT, timeout=900)
    return p, [json.loads(x) for x in p.stdout.splitlines()
               if x.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    _card()
    p, out = _run(["qzbench/run.py", "--workload", name, "--seed",
                   str(2**31 + 99), "--seconds", "2", "--trace", "0"])
    assert p.returncode == 0, p.stderr[-3000:]
    res = out[-1]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    cell = harness.load_cell(name)
    assert {m["name"] for m in cell.end_to_end} == set(res["metrics"])
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    _card()
    p, out = _run(["qzbench/control.py", "--workload", name, "--seeds",
                   "1", "--seconds", "1"])
    assert p.returncode == 0, p.stderr[-3000:]
    assert out and not any(r["correct"] for r in out)
