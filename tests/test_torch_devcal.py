"""The port's device calibration and routing policy (engine/devcal.py).

The cold-start hook of the reference's ``test_devcal_autocalibrate_cold_start``
(tests/test_health.py), and ``calibrate`` on the CPU device: the record
carries the reference's keys, a host without the device records why, and a
kernel that cannot be built or launched reaches the caller.
"""
import json
import time
import zlib

import pytest
import torch

from qatzip_tpu_torch.constants import QzDirection
from qatzip_tpu_torch.engine import devcal
from qatzip_tpu_torch.engine.cpu_backend import CpuBackend
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import inflate as PI
from qatzip_tpu_torch.ops.device_codecs import DeflateDeviceCodec

torch.set_num_threads(1)

CPU = torch.device("cpu")
KEYS = ("cpu_comp_gbps", "cpu_decomp_gbps", "dev_comp_gbps",
        "dev_comp_raw_gbps", "dev_comp_packed_gbps", "pack_wins",
        "dev_decomp_gbps", "dev_decomp_compute_gbps",
        "dev_comp_compute_gbps", "comp_device_wins", "decomp_device_wins")


@pytest.fixture
def cal_path(monkeypatch, tmp_path):
    path = tmp_path / "cal.json"
    monkeypatch.setenv("QATZIP_TPU_DEVCAL_PATH", str(path))
    monkeypatch.delenv("QATZIP_TPU_DEVICE", raising=False)
    monkeypatch.delenv("QATZIP_TPU_PACK", raising=False)
    devcal.invalidate()
    yield path
    devcal.invalidate()


def test_devcal_autocalibrate_cold_start(monkeypatch, cal_path):
    """With QATZIP_TPU_AUTOCAL=1 and no record, the first routing decision
    spawns one background calibration; routing stays CPU until the record
    lands, then flips to the measured winners."""
    monkeypatch.setenv("QATZIP_TPU_AUTOCAL", "1")
    monkeypatch.setattr(devcal, "_autocal_started", False)
    calls = []

    def fake_calibrate(sample_bytes=0, save=True):
        calls.append(sample_bytes)
        cal_path.write_text(json.dumps({"comp_device_wins": True,
                                        "decomp_device_wins": False}))
        devcal.invalidate()

    monkeypatch.setattr(devcal, "calibrate", fake_calibrate)
    # first decision: no record -> CPU, autocal spawned
    assert not devcal.device_allowed(QzDirection.QZ_DIR_COMPRESS)
    deadline = time.monotonic() + 5
    while not calls and time.monotonic() < deadline:
        time.sleep(0.01)
    assert calls, "autocal thread never ran"
    while time.monotonic() < deadline:
        if devcal.device_allowed(QzDirection.QZ_DIR_COMPRESS):
            break
        time.sleep(0.01)
    assert devcal.device_allowed(QzDirection.QZ_DIR_COMPRESS)
    assert not devcal.device_allowed(QzDirection.QZ_DIR_DECOMPRESS)
    # exactly one attempt even across many decisions
    cal_path.unlink()
    devcal.invalidate()
    assert not devcal.device_allowed(QzDirection.QZ_DIR_COMPRESS)
    assert len(calls) == 1


def test_no_record_without_autocal_stays_on_the_cpu(monkeypatch, cal_path):
    monkeypatch.delenv("QATZIP_TPU_AUTOCAL", raising=False)
    monkeypatch.setattr(devcal, "_autocal_started", False)
    monkeypatch.setattr(devcal, "calibrate", lambda **kw: pytest.fail(
        "calibrated without QATZIP_TPU_AUTOCAL"))
    for d in (QzDirection.QZ_DIR_COMPRESS, QzDirection.QZ_DIR_DECOMPRESS,
              QzDirection.QZ_DIR_BOTH):
        assert not devcal.device_allowed(d)
    assert not devcal._autocal_started


@pytest.fixture
def small_decompress(monkeypatch):
    """The device codec's decompress, cut to what the CPU can run quickly:
    one small lockstep round on the device (so the inflate capture has a
    round to replay), then the CPU funnel's result for the real payloads."""
    real = DeflateDeviceCodec.decompress_chunks
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    tiny = co.compress(b"calibrate the port " * 8) + co.flush()

    def decompress(self, payloads, hints, params, device):
        real(self, [tiny], [8 * 19], params, device)
        return CpuBackend().decompress_chunks(payloads, hints, params)

    monkeypatch.setattr(DeflateDeviceCodec, "decompress_chunks", decompress)


def test_calibrate_on_the_cpu_writes_the_reference_keys(cal_path,
                                                        small_decompress):
    failures0 = health.total_failures
    rec = devcal.calibrate(sample_bytes=256 << 10, device=CPU)
    for k in KEYS:
        assert k in rec, k
    assert "device_error" not in rec and "compute_probe_error" not in rec
    assert rec["device"] == "cpu" and rec["sample_bytes"] == 256 << 10
    for k in KEYS:
        if k.endswith("_gbps"):
            assert rec[k] > 0, k
    assert rec["dev_comp_gbps"] == max(rec["dev_comp_raw_gbps"],
                                       rec["dev_comp_packed_gbps"])
    assert rec["pack_wins"] == (rec["dev_comp_packed_gbps"]
                                > rec["dev_comp_raw_gbps"])
    assert rec["comp_device_wins"] == (rec["dev_comp_gbps"]
                                       > rec["cpu_comp_gbps"])
    assert json.loads(cal_path.read_text()) == rec
    assert devcal._load() == rec
    assert health.total_failures == failures0


def test_calibrate_replays_the_captured_inflate_rounds(cal_path,
                                                       small_decompress,
                                                       monkeypatch):
    """dev_decomp_compute_gbps comes from re-running the rounds the
    decompress launched, no others."""
    from qatzip_tpu_torch.ops import inflate_kernel as K

    replayed = []
    real = K.timed_replay

    def timed_replay(calls, reps=3):
        replayed.append([c[-1] for c in calls])
        return real(calls, reps)

    monkeypatch.setattr(K, "timed_replay", timed_replay)
    rec = devcal.calibrate(sample_bytes=64 << 10, device=CPU, save=False)
    assert len(replayed) == 1 and len(replayed[0]) == 1
    assert rec["dev_decomp_compute_gbps"] > 0
    assert K._capture is None
    assert not cal_path.exists()


def test_calibrate_without_the_device_records_why(cal_path):
    """A device that does not exist: the record says so, the device's
    numbers are 0 and routing stays on the CPU."""
    rec = devcal.calibrate(sample_bytes=64 << 10, device="cuda:99")
    assert "device_error" in rec and "compute_probe_error" in rec
    assert rec["dev_comp_gbps"] == rec["dev_decomp_gbps"] == 0.0
    assert rec["dev_comp_compute_gbps"] == 0.0
    assert not rec["comp_device_wins"] and not rec["decomp_device_wins"]
    assert not devcal.device_allowed(QzDirection.QZ_DIR_COMPRESS)


def test_calibrate_counts_a_failed_over_batch_as_a_device_error(
        cal_path, small_decompress, monkeypatch):
    """A batch the codec sent to the CPU would make the device's numbers
    the CPU's: the record says so instead."""
    def compress(self, chunks, params, device):
        health.record_failure()
        return CpuBackend().compress_chunks(chunks, params)

    monkeypatch.setattr(DeflateDeviceCodec, "compress_chunks", compress)
    try:
        rec = devcal.calibrate(sample_bytes=64 << 10, device=CPU)
    finally:
        health.record_success()
    assert "failed over" in rec["device_error"]
    assert rec["dev_comp_gbps"] == 0.0 and not rec["comp_device_wins"]


def test_calibrate_lets_a_kernel_error_through(cal_path, monkeypatch):
    def compress(self, chunks, params, device):
        raise _build.KernelError("nvcc not found")

    monkeypatch.setattr(DeflateDeviceCodec, "compress_chunks", compress)
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        devcal.calibrate(sample_bytes=64 << 10, device=CPU)
    assert not cal_path.exists()


def test_timed_replay_times_the_rounds_on_the_cpu():
    from qatzip_tpu_torch.ops import inflate_kernel as K

    assert K.timed_replay([]) == 0.0
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    from qatzip_tpu_torch.ops import deflate_decode as dd

    s = dd._Stream(co.compress(b"abcabcabd" * 10) + co.flush(), 90, 0)
    assert dd._parse_one_header(s) == "huff"
    _, inputs = dd.pack_round([s])
    t = PI.upload(*inputs[:6], CPU)
    calls = []
    K._capture = calls
    try:
        want = PI.decode_lockstep(*t, inputs[6])
    finally:
        K._capture = None
    assert len(calls) == 1 and calls[0][-1] == inputs[6]
    assert K.timed_replay(calls, reps=2) > 0
    got = PI.decode_lockstep(*calls[0])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
