"""Async batch mode of the port (a copy of qatzip_tpu/async_api.py;
reference src/qatzip.c:3090-4196).

The reference's per-session MPMC ring (1024 deep) + consumer thread +
poller thread map to a bounded queue + worker thread here; completion is
exposed both as a Future and via the reference-style callback
(include/qatzip.h:922: qzCallbackFn(external, src, src_len, dest, dest_len,
rc, ext_rc)).

On the card each executor launches its batches on the device's current
CUDA stream and waits for their results, while completions drain in
submission order, which is what the reference's consumer/poller pair does
for the ASIC.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional

from qatzip_tpu_torch import constants as C
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.session import QzSession

ASYNC_RING_DEPTH = 1024  # reference src/qatzip_internal.h:327


@dataclass
class QzResult:
    """Analog of QzResult_T (reference include/qatzip.h:865-905)."""

    rc: int = C.QZ_NONE
    data: bytes = b""
    consumed: int = 0
    ext_rc: int = 0
    done: bool = False


@dataclass
class _Request:
    direction: str
    src: bytes
    last: int
    future: Future = field(default_factory=Future)
    callback: Optional[Callable] = None
    external: object = None
    result: QzResult = field(default_factory=QzResult)
    seq: int = -1
    error: Optional[BaseException] = None


class AsyncCtrl:
    """Per-session async control block (reference qzSetupAsyncCtrl,
    src/qatzip.c:3977-4011): bounded ring + executor pool + in-order
    completer.

    The reference overlaps a consumer thread (submits to the ASIC) with a
    poller thread (drains completions) and preserves submission order via
    the seq invariant (src/qatzip.c:1641-1649).  Here N executors run
    engine requests concurrently (zlib/native codecs release the GIL; the
    device path is async-dispatched), and a completer fires callbacks and
    futures strictly in submission order."""

    EXECUTORS = 3

    def __init__(self, sess: QzSession):
        self.sess = sess
        self.ring: queue.Queue = queue.Queue(maxsize=ASYNC_RING_DEPTH)
        self.shutdown_evt = threading.Event()
        self._seq_submit = 0
        self._seq_done = 0
        self._completed: dict[int, _Request] = {}
        self._cv = threading.Condition()
        self.workers = []
        for i in range(self.EXECUTORS):
            t = threading.Thread(target=self._consume, daemon=True,
                                 name=f"qzt-async-exec-{i}")
            t.start()
            self.workers.append(t)
        self.completer = threading.Thread(target=self._complete, daemon=True,
                                          name="qzt-async-completer")
        self.completer.start()

    def submit(self, req: _Request) -> int:
        # seq assignment + enqueue are atomic: two threads submitting on one
        # session must never get duplicate seq numbers, or the in-order
        # completer stalls at the missing seq forever
        with self._cv:
            if self.ring.full():
                return C.QZ_FAIL
            req.seq = self._seq_submit  # assign before enqueue: the consumer
            self._seq_submit += 1       # may dequeue immediately
            self.ring.put_nowait(req)
        return C.QZ_OK

    def _consume(self) -> None:
        while not self.shutdown_evt.is_set():
            try:
                req = self.ring.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                if req.direction == "compress":
                    res = core.compress_ext(self.sess, req.src, last=req.last)
                else:
                    res = core.decompress_ext(self.sess, req.src)
                req.result.rc = res.rc
                req.result.data = res.data
                req.result.consumed = res.consumed
                req.result.ext_rc = res.ext_rc
            except Exception as exc:  # pragma: no cover
                req.result.rc = C.QZ_FAIL
                req.error = exc
            finally:
                req.result.done = True
            with self._cv:
                self._completed[req.seq] = req
                self._cv.notify_all()

    def _complete(self) -> None:
        """Drain completions in submission order (the doCompressOut seq
        invariant) and fire user callbacks + futures."""
        while not self.shutdown_evt.is_set():
            with self._cv:
                self._cv.wait_for(
                    lambda: self._seq_done in self._completed
                    or self.shutdown_evt.is_set(), timeout=0.05)
                req = self._completed.pop(self._seq_done, None)
                if req is not None:
                    self._seq_done += 1
            if req is None:
                continue
            if req.error is not None:
                req.future.set_exception(req.error)
                continue
            if req.callback is not None:
                try:
                    req.callback(req.external, req.src, req.result.consumed,
                                 req.result.data, len(req.result.data),
                                 req.result.rc, req.result.ext_rc)
                except Exception:
                    pass
            req.future.set_result(req.result)

    def shutdown(self) -> None:
        self.shutdown_evt.set()
        for t in self.workers:
            t.join(timeout=2.0)
        self.completer.join(timeout=2.0)


_ctrl_lock = threading.Lock()


def _ensure_ctrl(sess: QzSession) -> AsyncCtrl:
    # double-checked under a lock: two first-submit threads racing here
    # must not each spawn a ctrl (one ring would be orphaned with its
    # requests never completed)
    if sess.async_ctrl is None:
        with _ctrl_lock:
            if sess.async_ctrl is None:
                sess.async_ctrl = AsyncCtrl(sess)
    return sess.async_ctrl


def qz_compress2(sess: QzSession, src, last: int = 1,
                 callback: Optional[Callable] = None,
                 external: object = None):
    """qzCompress2 analog (reference src/qatzip.c:4112-4153).

    With callback=None and wait=True semantics the reference degrades to the
    synchronous path; here a Future is always returned alongside the status.
    Returns (rc, Future[QzResult])."""
    from qatzip_tpu_torch.api import _auto_session
    rc = _auto_session(sess)
    if rc < 0:
        return rc, None
    ctrl = _ensure_ctrl(sess)
    req = _Request("compress", bytes(src), last, callback=callback,
                   external=external)
    rc = ctrl.submit(req)
    return rc, req.future


def qz_decompress2(sess: QzSession, src,
                   callback: Optional[Callable] = None,
                   external: object = None):
    """qzDecompress2 analog."""
    from qatzip_tpu_torch.api import _auto_session
    rc = _auto_session(sess)
    if rc < 0:
        return rc, None
    ctrl = _ensure_ctrl(sess)
    req = _Request("decompress", bytes(src), 1, callback=callback,
                   external=external)
    rc = ctrl.submit(req)
    return rc, req.future
