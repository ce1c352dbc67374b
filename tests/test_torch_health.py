"""The reference's health suite (tests/test_health.py) against the port.

The breaker, the probe slot, the flow counters, the instance pool,
concurrent sessions and the injected faults (submit, death, poison,
checksum; trip, sticky software route, revival), each case run in both
packages on the same input.  The port's engine runs on
``torch.device("cpu")`` with the device route forced where the reference
forces it, and each such case checks that the port took that route or that
its fault fired.  The reference's ``test_devcal_autocalibrate_cold_start``
is held in ``tests/test_torch_devcal.py``.

Beyond the reference: a CUDA error raised on the device route
(``torch.AcceleratorError``, or a ``RuntimeError`` starting with ``CUDA
error``) reaches the caller through every codec, funnel, metadata and
stream path with no CPU rerun and no health failure, where the reference
reroutes it.  So does any other error but an injected fault or a card out
of memory (``faults.FAILOVER``), which keep the reference's per-batch
reroute.
"""
import gzip
import threading
import time
import zlib

import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu import constants as C
from qatzip_tpu.constants import QzDataFormat
from qatzip_tpu.engine import core as ref_core
from qatzip_tpu.engine import faults as ref_faults
from qatzip_tpu.engine import health as ref_hm
from qatzip_tpu.engine import instances as ref_instances
from qatzip_tpu_torch import metadata, stream
from qatzip_tpu_torch.engine import core, faults, flow, gpu_backend
from qatzip_tpu_torch.engine import health as hm
from qatzip_tpu_torch.engine import instances
from tests.torch_conformance import (  # noqa: F401 (fixtures)
    both, engine_on, port_engine, route, same)

torch.set_num_threads(1)

GZ_EXT = QzDataFormat.QZ_DEFLATE_GZIP_EXT
# each package's engine core, fault injector and health module
SIDES = {"ref": (ref_core, ref_faults, ref_hm),
         "port": (core, faults, hm)}


@pytest.fixture(autouse=True)
def _reset():
    yield
    for _, fl, h in SIDES.values():
        fl.clear()
        h.health.record_success()


def _side(qz):
    return SIDES["ref" if qz is qatzip_tpu else "port"]


def _hw(qz) -> int:
    return _side(qz)[0]._engine.hw_requests


def _gz_sess(qz, hw_buff_sz=8192, fmt=GZ_EXT):
    sess = qz.QzSession()
    p = qz.QzSessionParamsDeflate()
    p.common_params.comp_lvl = 1
    p.common_params.hw_buff_sz = hw_buff_sz
    p.data_fmt = fmt
    assert qz.qz_setup_session_deflate(sess, p) == C.QZ_OK
    return sess


# ---------------------------------------------------------------------------
# The breaker and the probe slot
# ---------------------------------------------------------------------------
def _breaker_run(h_mod, t):
    h = h_mod.DeviceHealth()
    seen = [h.healthy()]
    for _ in range(h_mod.FAILURE_TRIP):
        h.record_failure()
    seen.append(h.healthy())
    t[0] += h_mod.COOLDOWN_S + 1
    seen += [h.healthy(), h.healthy()]
    h.record_success()
    seen += [h.healthy(), h.healthy()]
    return seen


def test_breaker_trips_and_recovers(monkeypatch):
    t = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: t[0])
    got = {name: _breaker_run(h, t) for name, (_, _, h) in SIDES.items()}
    assert got["port"] == got["ref"] == [True, False, True, False, True,
                                         True]
    assert (hm.FAILURE_TRIP, hm.COOLDOWN_S, hm.PROBE_TIMEOUT_S) == (
        ref_hm.FAILURE_TRIP, ref_hm.COOLDOWN_S, ref_hm.PROBE_TIMEOUT_S)


def _probe_run(h_mod):
    h = h_mod.DeviceHealth()
    for _ in range(h_mod.FAILURE_TRIP):
        h.record_failure()
    seen = [h.healthy()]
    h._tripped_at -= h_mod.COOLDOWN_S + 1
    seen += [h.healthy(), h.healthy()]
    h._probe_started -= h_mod.PROBE_TIMEOUT_S + 1
    seen.append(h.healthy())
    return seen


def test_probe_slot_expires():
    assert _probe_run(hm) == _probe_run(ref_hm) == [False, True, False,
                                                    True]


def test_engine_routes_sw_when_breaker_open(port_engine, corpus_factory):
    data = corpus_factory(100_000)

    def run(qz):
        h_mod = _side(qz)[2]
        h = h_mod.health
        for _ in range(h_mod.FAILURE_TRIP):
            h.record_failure()
        hw0 = _hw(qz)
        comp = qz.compress(data, "deflate", fmt=GZ_EXT)
        assert _hw(qz) == hw0  # stayed on the software route
        assert qz.decompress(comp, "deflate") == data
        h.record_success()
        return comp

    ref, port = both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# Injected faults: per-batch failover, death, poison, checksum
# ---------------------------------------------------------------------------
def test_per_batch_compress_failover(port_engine, corpus_factory,
                                     monkeypatch):
    """74 chunks of 4 KB: the reference, on the tests' 8 virtual devices,
    cuts them into batches of 72 and 2 (block-DP), so the port's mesh is
    pinned to 8 CPU devices to cut the same batches; the fault fails the
    first over to the CPU, the second runs on the device."""
    from qatzip_tpu_torch.parallel import shard

    monkeypatch.setattr(shard, "_MESH", [torch.device("cpu")] * 8)
    data = corpus_factory(300_000, "text")

    def run(qz):
        _, fl, h = _side(qz)
        fl.inject_error("submit", nth=1, direction="compress", count=1)
        fails0 = h.health.total_failures
        comp = qz.compress(data, "deflate", fmt=GZ_EXT, level=1,
                           hw_buff_sz=4096)
        assert h.health.total_failures == fails0 + 1
        assert not fl.armed()
        assert gzip.decompress(comp) == data
        return comp

    ref, port = both(run)
    assert port == ref
    assert qt.decompress(port, "deflate", hw_buff_sz=4096,
                         sw_only=True) == data


def test_device_checksums_flow_through_api(port_engine, corpus_factory):
    data = corpus_factory(100_000, "text")

    def run(qz):
        sess = _gz_sess(qz, hw_buff_sz=16384)
        res = qz.qz_compress_crc(sess, data)
        dres = qz.qz_decompress_crc(_gz_sess(qz, hw_buff_sz=16384),
                                    res.data)
        assert res.rc == dres.rc == C.QZ_OK and dres.data == data
        assert res.crc == dres.crc == zlib.crc32(data) & 0xFFFFFFFF
        return res, dres

    with route(device=True):
        (ref_c, ref_d), (port_c, port_d) = both(run)
    same(ref_c, port_c)
    same(ref_d, port_d)


def test_fault_death_mid_batch_compress(port_engine, corpus_factory):
    data = corpus_factory(100_000, "text")

    def run(qz):
        _, fl, h = _side(qz)
        fl.inject_error("death", nth=1, direction="compress", count=1)
        fails0 = h.health.total_failures
        comp = qz.compress(data, "deflate", fmt=GZ_EXT, level=1)
        assert not fl.armed()
        assert h.health.total_failures == fails0 + 1
        assert gzip.decompress(comp) == data
        return comp

    ref, port = both(run)
    assert port == ref


def test_fault_poison_compress_is_harmless(port_engine, corpus_factory):
    """Poisoned candidates cost ratio, never bytes: gzip reads the stream.
    The port's bytes differ from the reference's under this fault, as its
    batch holds only its chunks where the reference's pads to 128 rows, so
    the same seeded garbage lands on other rows (ROADMAP queue 3);
    the clean runs' bytes are equal."""
    data = corpus_factory(120_000, "text")
    clean = both(lambda qz: qz.compress(data, "deflate", fmt=GZ_EXT,
                                        level=1))
    assert clean[1] == clean[0]

    def run(qz):
        _, fl, h = _side(qz)
        fl.inject_error("poison", nth=1, direction="compress", count=1)
        fails0 = h.health.total_failures
        comp = qz.compress(data, "deflate", fmt=GZ_EXT, level=1)
        assert not fl.armed()
        assert h.health.total_failures == fails0
        assert gzip.decompress(comp) == data
        return comp

    with route(device=True):
        both(run)


@pytest.mark.parametrize("kind,fmt", [
    ("poison", QzDataFormat.QZ_DEFLATE_GZIP),
    ("checksum", QzDataFormat.QZ_DEFLATE_GZIP_EXT)])
def test_fault_decompress_detected(port_engine, corpus_factory, kind, fmt):
    """The reference's test_fault_poison_decompress_detected and
    test_fault_checksum_engine_detected: the fault fires on the device
    route (its 60 KB member latches the 8 KB session to the software route
    only after the request was routed) and the request fails with the
    reference's code, never with silently wrong bytes."""
    data = corpus_factory(60_000, "text")

    def run(qz):
        _, fl, _ = _side(qz)
        comp = qz.compress(data, "deflate", fmt=fmt, sw_only=True)
        fl.inject_error(kind, nth=1, direction="decompress", count=1)
        res = qz.qz_decompress(_gz_sess(qz, fmt=fmt), comp)
        assert not fl.armed()
        assert res.rc == C.QZ_DATA_ERROR
        return res

    ref, port = both(run)
    same(ref, port)


def test_fault_trip_then_sticky_sw_then_revival(port_engine, corpus_factory,
                                                monkeypatch):
    data = corpus_factory(64_000, "text")
    t = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: t[0])

    def run(qz):
        eng, fl, h = _side(qz)
        health = h.health

        def comp_once():
            return qz.compress(data, "deflate", fmt=GZ_EXT, level=1,
                               hw_buff_sz=8192)

        out = []
        fl.inject_error("submit", direction="compress", count=-1)
        fails0 = health.total_failures
        for _ in range(h.FAILURE_TRIP):
            out.append(comp_once())   # each records one failure
            assert gzip.decompress(out[-1]) == data
        assert health.total_failures == fails0 + h.FAILURE_TRIP
        assert not health.healthy()   # the breaker is open
        hw0 = eng._engine.hw_requests
        out.append(comp_once())       # sticky software route
        assert eng._engine.hw_requests == hw0
        assert health.total_failures == fails0 + h.FAILURE_TRIP
        fl.clear()                    # the device heals
        t[0] += h.COOLDOWN_S + 1
        out.append(comp_once())       # the probe closes the breaker
        assert health.healthy()
        assert eng._engine.hw_requests > hw0
        return out

    ref, port = both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# Flow counters and the instance pool (the reference's names, repair 2)
# ---------------------------------------------------------------------------
def test_flow_counters_balance(port_engine, corpus_factory):
    assert core.flow is flow.flow
    data = corpus_factory(300_000)

    def run(qz):
        # the deltas over these requests: the counters are process-wide, and
        # the reference's test_flow_error_detected leaves them unbalanced
        d0 = qz.qz_dump_counters()
        comp = qz.compress(data, "deflate", sw_only=True, fmt=GZ_EXT)
        assert qz.decompress(comp, "deflate", sw_only=True) == data
        d = {k: v - d0[k] for k, v in qz.qz_dump_counters().items()}
        assert d["flow_errors"] == 0 and d["requests"] == 2
        assert d["planned"] == d["submitted"] == d["completed"] == \
            d["reassembled"] > 0
        return comp

    ref, port = both(run)
    assert port == ref


def test_flow_error_detected(monkeypatch, corpus_factory):
    data = corpus_factory(200_000)

    def run(qz):
        ec = _side(qz)[0]
        real = ec.CpuBackend.compress_chunks

        def dropping(self, chunks, params):
            out = real(self, chunks, params)
            return out[:-1] if len(out) > 1 else out

        monkeypatch.setattr(ec.CpuBackend, "compress_chunks", dropping)
        monkeypatch.setattr(ec, "_native", None)
        tracker = ec.flow
        # the failed request unbalances the process-wide totals: give them
        # back afterwards, as later tests of either package check balance
        for name in ("totals", "flow_errors", "requests"):
            value = getattr(tracker, name)
            monkeypatch.setattr(tracker, name,
                                dict(value) if name == "totals" else value)
        sess = qz.QzSession()
        assert qz.qz_setup_session_deflate(sess) == C.QZ_OK
        errs0 = tracker.dump()["flow_errors"]
        res = qz.qz_compress(sess, data)
        assert tracker.dump()["flow_errors"] == errs0 + 1
        return res

    ref, port = both(run)
    assert port.rc == ref.rc == C.QZ_FAIL


def test_instance_pool_admission(port_engine, corpus_factory):
    stats = {}
    for name, mod in (("ref", ref_instances), ("port", instances)):
        p = mod.InstancePool(num_devices=2, oversub=1)
        a, b = p.grab(), p.grab()
        assert {a, b} == {0, 1}
        assert p.grab() is None
        assert p.stats()["busy_rejects"] == 1
        p.release(a)
        c = p.grab()
        assert c is not None
        p.release(b)
        p.release(c)
        stats[name] = p.stats()
    assert stats["port"] == stats["ref"]
    # the module's pool is the one the engine's device backend grabs from
    assert gpu_backend.pool is instances.pool
    grabs0 = instances.pool.stats()["grabs"]
    qt.compress(corpus_factory(20_000), hw_buff_sz=16384)
    assert instances.pool.stats()["grabs"] == grabs0 + 1


def test_concurrent_sessions_multiplex(port_engine, corpus_factory,
                                       monkeypatch):
    """Four sessions share the pool's two slots; the plain match finder on
    a loaded CPU can hold a slot for seconds, so a waiting session gets
    more than the card's 10 s before it would fail over."""
    monkeypatch.setattr(gpu_backend.GpuBackend, "GRAB_TIMEOUT_S", 120.0)
    data = corpus_factory(150_000)
    want = qatzip_tpu.compress(data, "deflate", level=1)
    results = {}

    def run(name):
        comp = qt.compress(data, "deflate", level=1)
        results[name] = (comp, qt.decompress(comp, "deflate", sw_only=True))

    hw0 = port_engine.hw_requests
    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert all(results[i] == (want, data) for i in range(4))
    assert port_engine.hw_requests - hw0 == 4 * -(-len(data) // 65536)


# ---------------------------------------------------------------------------
# A CUDA error reaches the caller (repair of the port's failover)
# ---------------------------------------------------------------------------
def _cuda_error(kind: str):
    msg = "CUDA error: an illegal memory access was encountered"
    return (torch.AcceleratorError(msg) if kind == "accelerator"
            else RuntimeError(msg))


def _raise(exc):
    def fn(*a, **k):
        raise exc
    return fn


_HW = 16 << 10


def _patch_site(monkeypatch, site: str, exc):
    """Make the device call of ``site`` raise ``exc``."""
    from qatzip_tpu_torch.ops import deflate_encode as de
    from qatzip_tpu_torch.ops import inflate as PI
    from qatzip_tpu_torch.ops import lz4_decode as ld
    from qatzip_tpu_torch.ops import match_finder as mf
    from qatzip_tpu_torch.parallel import shard

    if site in ("compress", "lz4_compress", "metadata_compress",
                "stream_compress"):
        monkeypatch.setattr(mf, "select_to_positions", _raise(exc))
    elif site in ("compress_d2h", "lz4_compress_d2h"):
        monkeypatch.setattr(shard, "gather", _raise(exc))
    elif site == "device_encoder":
        monkeypatch.setenv("QATZIP_TPU_ENCODER", "device")
        monkeypatch.setattr(de, "encode_blocks", _raise(exc))
    elif site in ("decompress", "metadata_decompress", "stream_decompress"):
        monkeypatch.setattr(PI, "decode_lockstep", _raise(exc))
    elif site == "lz4_decompress":
        monkeypatch.setattr(ld, "_decode_blocks_impl", _raise(exc))
    else:
        raise ValueError(site)


def _call_site(site: str, data: bytes, comp: dict):
    if site in ("compress", "compress_d2h", "device_encoder"):
        return qt.compress(data, level=1, hw_buff_sz=_HW)
    if site in ("lz4_compress", "lz4_compress_d2h"):
        return qt.compress(data, "lz4", hw_buff_sz=_HW)
    if site == "decompress":
        return qt.decompress(comp["deflate"], hw_buff_sz=_HW)
    if site == "lz4_decompress":
        return qt.decompress(comp["lz4"], "lz4", hw_buff_sz=_HW)
    sess = _gz_sess(qt, hw_buff_sz=_HW)
    if site.startswith("metadata"):
        md = metadata.qz_allocate_metadata(len(data), _HW)[1]
        if site == "metadata_compress":
            return metadata.qz_compress_with_metadata_ext(sess, data, md)
        res = metadata.qz_compress_with_metadata_ext(
            sess, data, md, hw_buff_sz_override=0)
        return res, metadata.qz_decompress_with_metadata_ext(
            _gz_sess(qt, hw_buff_sz=_HW), res.data, md)
    if site == "stream_compress":
        return stream.qz_compress_stream(sess, stream.QzStream(), data,
                                         last=1)
    # the 4B stream decompress runs the one-shot funnel a member (the
    # gzip formats' incremental stream inflates on the host)
    return stream.qz_decompress_stream(
        _gz_sess(qt, hw_buff_sz=_HW, fmt=QzDataFormat.QZ_DEFLATE_4B),
        stream.QzStream(), comp["4b"], last=1)


_SITES = ["compress", "compress_d2h", "device_encoder", "decompress",
          "lz4_compress", "lz4_compress_d2h", "lz4_decompress",
          "metadata_compress", "metadata_decompress", "stream_compress",
          "stream_decompress"]


@pytest.mark.parametrize("site", _SITES)
def test_cuda_error_reaches_the_caller(port_engine, corpus_factory,
                                       monkeypatch, site):
    data = corpus_factory(20_000, "text")
    comp = {"deflate": qt.compress(data, level=1, hw_buff_sz=_HW,
                                   sw_only=True),
            "lz4": qt.compress(data, "lz4", hw_buff_sz=_HW, sw_only=True),
            "4b": qt.compress(data, fmt=QzDataFormat.QZ_DEFLATE_4B,
                              level=1, hw_buff_sz=_HW, sw_only=True)}
    if site == "metadata_decompress":
        # the metadata compress runs clean; its decompress meets the error
        from qatzip_tpu_torch.ops import inflate as PI

        md = metadata.qz_allocate_metadata(len(data), _HW)[1]
        res = metadata.qz_compress_with_metadata_ext(
            _gz_sess(qt, hw_buff_sz=_HW), data, md)
        monkeypatch.setattr(PI, "decode_lockstep",
                            _raise(_cuda_error("accelerator")))
        call = (lambda: metadata.qz_decompress_with_metadata_ext(
            _gz_sess(qt, hw_buff_sz=_HW), res.data, md))
    else:
        _patch_site(monkeypatch, site, _cuda_error("accelerator"))
        call = (lambda: _call_site(site, data, comp))
    sw0, fails0 = port_engine.sw_requests, hm.health.total_failures
    with pytest.raises(torch.AcceleratorError, match="illegal memory"):
        call()
    assert port_engine.sw_requests == sw0      # no CPU rerun
    assert hm.health.total_failures == fails0  # no device failure recorded


_ERRORS = {"accelerator": (_cuda_error("accelerator"), True),
           "runtime": (_cuda_error("runtime"), True),
           "other": (RuntimeError("device lost"), True),
           "port_code": (TypeError("a fault of the port's own code"), True),
           "injected": (faults.InjectedFault("injected submit fault"), False),
           "oom": (torch.OutOfMemoryError("CUDA out of memory"), False)}


@pytest.mark.parametrize("kind", list(_ERRORS))
def test_only_injected_faults_and_oom_fail_over(port_engine, corpus_factory,
                                                monkeypatch, kind):
    """A RuntimeError that starts with "CUDA error" passes as a
    torch.AcceleratorError does, and so does any error but an injected
    fault or a card out of memory: no health failure, no CPU rerun.  Those
    two keep the reference's per-batch CPU reroute: one health failure,
    the bytes of the software path."""
    data = corpus_factory(20_000, "text")
    exc, passes = _ERRORS[kind]
    assert isinstance(exc, faults.FAILOVER) is not passes
    _patch_site(monkeypatch, "compress", exc)
    fails0 = hm.health.total_failures
    if passes:
        with pytest.raises(type(exc), match=str(exc)):
            qt.compress(data, level=1, hw_buff_sz=_HW)
        assert hm.health.total_failures == fails0
    else:
        comp = qt.compress(data, level=1, hw_buff_sz=_HW)
        assert hm.health.total_failures == fails0 + 1
        assert comp == qt.compress(data, level=1, hw_buff_sz=_HW,
                                   sw_only=True)
