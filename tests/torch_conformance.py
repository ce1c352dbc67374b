"""What the port's conformance suites share.

``tests/test_torch_{api, sweep, fuzz, negative, formats, lz4_interop,
health, device_decode}.py`` run the cases of the reference's suite of the
same name against ``qatzip_tpu_torch``, and the reference package on the
same input in the same test.  ``both`` makes one call in each package;
``same`` holds two ``OpResult``s equal; ``route`` checks which route the
port's engine took over a block.  The fixtures ``engine_on`` (an
initializer for the port's engine, closed afterwards) and ``port_engine``
(the engine on ``torch.device("cpu")`` with the device route forced) are
imported by the test files that use them.
"""
import contextlib

import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.ops import lz4_decode as ld


@pytest.fixture
def engine_on():
    """Yield an initializer for the port's engine; close it afterwards."""
    def init(device=None):
        core.qz_close_engine()
        sess = qt.QzSession()
        rc = qt.qz_init(sess, device=device)
        return sess, rc

    yield init
    core.qz_close_engine()


@pytest.fixture
def port_engine(engine_on, monkeypatch):
    """The port's engine on ``torch.device("cpu")`` (the kernels' plain
    versions) with the device route forced in both packages; yields the
    engine state."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    _, rc = engine_on(torch.device("cpu"))
    assert rc == 0 and core.engine().hw_backend.device.type == "cpu"
    return core.engine()


def both(fn):
    """``fn(package)`` for the reference, then for the port."""
    return fn(qatzip_tpu), fn(qt)


def refused(ref, port) -> bool:
    """The deliberate divergence of a refused chunk (ROADMAP queue 3): a
    QZ_DATA_ERROR that the reference reached by rerunning the batch on the
    CPU (its ext_rc carries QZ_SW_EXECUTION_MASK), where the port ended the
    request at the chunk with no rerun (no mask)."""
    mask = qt.QZ_SW_EXECUTION_MASK
    return (ref.rc == port.rc == qt.QZ_DATA_ERROR and bool(ref.ext_rc & mask)
            and not port.ext_rc & mask)


def same(ref, port, what="", refused_ok=False):
    """The port's OpResult equals the reference's in every field a caller
    reads (rc, data, consumed, crc, ext_rc), but for the software mask of
    a refused chunk where ``refused_ok``; returns the port's."""
    fields = ("rc", "data", "consumed", "crc", "ext_rc")
    want = {f: getattr(ref, f) for f in fields}
    if refused_ok and refused(ref, port):
        want["ext_rc"] &= ~qt.QZ_SW_EXECUTION_MASK
    got = {f: getattr(port, f) for f in fields}
    assert got == want, (what, {f: (want[f], got[f]) for f in fields
                                if want[f] != got[f] and f != "data"},
                         len(want["data"]), len(got["data"]))
    return port


@contextlib.contextmanager
def route(device: bool, failover_ok: bool = False):
    """The block's requests took the port's device route (device requests
    counted, no software request, no health failure and, unless
    ``failover_ok``, no lane or block failed over) or, with ``device``
    False, no device request."""
    eng = core.engine()
    hw0, sw0 = eng.hw_requests, eng.sw_requests
    lanes0, blocks0 = dd.failover_lanes, ld.failover_blocks
    failures0 = health.total_failures
    yield
    if device:
        assert eng.hw_requests > hw0, "the device route was not taken"
        assert eng.sw_requests == sw0
        assert health.total_failures == failures0
        if not failover_ok:
            assert (dd.failover_lanes, ld.failover_blocks) == (lanes0,
                                                               blocks0)
    else:
        assert eng.hw_requests == hw0
