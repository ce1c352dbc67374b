"""The port's async API against the reference's, on the same inputs.

The cases of tests/test_async.py with the device route forced in both
packages (the port's engine on ``torch.device("cpu")``, the kernels' plain
versions): every future resolves within its timeout, in submission order,
to the bytes a one-shot ``qz_compress`` gives in the reference, with no
software execution and no failed-over lane.
"""
import sys
import threading

import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu import async_api as ref_async
from qatzip_tpu import constants as C
from qatzip_tpu_torch import async_api as A
from qatzip_tpu_torch.ops import _build
from tests.test_torch_api_ext import device_only, port  # noqa: F401

torch.set_num_threads(1)

HW_BUFF = 16 << 10
TIMEOUT = 60


@pytest.fixture
def sess(port):
    s = session(qt)
    yield s
    assert qt.qz_close(s) == C.QZ_OK
    assert s.async_ctrl is None


def session(qz):
    s = qz.QzSession()
    p = qz.QzSessionParamsDeflate()
    p.common_params.hw_buff_sz = HW_BUFF
    assert qz.qz_setup_session_deflate(s, p) == C.QZ_OK
    return s


def reference(datas) -> list[bytes]:
    s = session(qatzip_tpu)
    return [qatzip_tpu.qz_compress(s, d).data for d in datas]


def check(results, want) -> None:
    assert [r.rc for r in results] == [C.QZ_OK] * len(want)
    assert [r.done for r in results] == [True] * len(want)
    assert not any(r.ext_rc & C.QZ_SW_EXECUTION_MASK for r in results)
    assert [r.data for r in results] == want


def test_compress_futures_equal_reference_in_order(corpus_factory, port,
                                                   sess):
    datas = [corpus_factory(20_000 + i * 1000) for i in range(8)]
    order = []
    with device_only(port):
        futs = []
        for i, d in enumerate(datas):
            rc, fut = A.qz_compress2(
                sess, d, callback=lambda ext, *a: order.append(ext),
                external=i)
            assert rc == C.QZ_OK
            futs.append(fut)
        results = [f.result(timeout=TIMEOUT) for f in futs]
    check(results, reference(datas))
    assert order == list(range(8))
    assert [r.consumed for r in results] == [len(d) for d in datas]


def test_callback_arguments_equal_reference(corpus_factory, port, sess):
    """The completion callback (reference CallAsyncbackfn): external, the
    source, consumed, dest, dest_len, rc and ext_rc."""
    data = corpus_factory(30_000)
    got = {}
    for name, qz, api, s in (("port", qt, A, sess),
                             ("ref", qatzip_tpu, ref_async,
                              session(qatzip_tpu))):
        done = threading.Event()
        seen = {}

        def cb(*args):
            seen["args"] = args
            done.set()

        rc, fut = api.qz_compress2(s, data, callback=cb, external="ctx")
        assert rc == C.QZ_OK
        fut.result(timeout=TIMEOUT)
        assert done.wait(timeout=TIMEOUT)
        got[name] = seen["args"]
        qz.qz_close(s)
    assert got["port"] == got["ref"]
    assert got["port"][0] == "ctx" and got["port"][5] == C.QZ_OK


def test_decompress2_round_trip_on_the_device(corpus_factory, port, sess):
    datas = [corpus_factory(30_000), corpus_factory(12_000)]
    comps = reference(datas)
    with device_only(port):
        futs = [A.qz_decompress2(sess, c)[1] for c in comps]
        results = [f.result(timeout=TIMEOUT) for f in futs]
    check(results, datas)
    assert [r.consumed for r in results] == [len(c) for c in comps]


def test_concurrent_submitters_keep_order_and_totals(corpus_factory, port,
                                                     sess):
    """Four threads submit on one session with a short switch interval:
    seq numbers stay unique (the completer never stalls), every result
    equals the reference's bytes and the session totals balance."""
    datas = [corpus_factory(8_000 + 500 * i) for i in range(4)]
    want = reference(datas)
    futures, flock = [], threading.Lock()

    def submitter(i):
        for _ in range(6):
            rc, fut = A.qz_compress2(sess, datas[i])
            assert rc == C.QZ_OK
            with flock:
                futures.append((i, fut))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(futures) == 24
    results = [(i, f.result(timeout=TIMEOUT)) for i, f in futures]
    check([r for _, r in results], [want[i] for i, _ in results])
    assert sess.total_in == sum(len(datas[i]) for i, _ in results)
    assert sess.total_out == sum(len(r.data) for _, r in results)


def test_kernel_error_reaches_the_future(corpus_factory, port, sess,
                                         monkeypatch):
    """A kernel that cannot be built raises out of the future, not a
    software result."""
    def fail(*args):
        raise _build.KernelError("nvcc not found")

    monkeypatch.setattr(port.hw_backend, "compress_chunks", fail)
    sw0 = port.sw_requests
    rc, fut = A.qz_compress2(sess, corpus_factory(20_000))
    assert rc == C.QZ_OK
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        fut.result(timeout=TIMEOUT)
    assert port.sw_requests == sw0
