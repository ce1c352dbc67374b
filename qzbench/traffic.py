"""The one traffic generator: a closed loop of clients in one process.

A traffic mix is a data file under ``qzbench/traffic/`` (its direction,
clients, loop, warm-up and, where it cuts the configuration's request
further, its own request size); this module drives any of them.
Each client is a thread that sends its next request when the last one
returns.  All clients start together; none starts a request after the
window's planned end, and the window ends when the last request started
inside it returns, so that a rate over the window counts whole requests
only.
"""
from __future__ import annotations

import threading
import time


class Request:
    """One request: its client, host-clock start and end, and whatever the
    client's function returned."""

    __slots__ = ("client", "start", "end", "result")

    def __init__(self, client, start, end, result):
        self.client, self.start, self.end, self.result = (
            client, start, end, result)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def validate(mix: dict) -> dict:
    """Check a traffic file's keys; returns it."""
    need = {"direction", "clients", "loop", "warmup_requests"}
    missing = need - set(mix)
    if missing:
        raise ValueError(f"traffic file lacks {sorted(missing)}")
    if mix["loop"] != "closed":
        raise ValueError(f"loop {mix['loop']!r}: only 'closed' is driven")
    if mix["direction"] not in ("compress", "decompress"):
        raise ValueError(f"direction {mix['direction']!r}")
    if int(mix["clients"]) < 1 or int(mix.get("request_bytes", 1)) < 1:
        raise ValueError("clients and request_bytes must be positive")
    return mix


def run_all_once(fns, check=None) -> list:
    """Every client's function once, all at once (the warm-up), each result
    passed through ``check(client, result)`` where given; a client's
    exception is raised here."""
    out = [None] * len(fns)
    errors: list = []

    def one(i):
        try:
            out[i] = fns[i]()
            if check is not None:
                out[i] = check(i, out[i])
        except BaseException as exc:  # noqa: BLE001  (re-raised below)
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(i,)) for i in
               range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def closed_loop(fns, seconds: float, on_start=None, check=None):
    """Drive client functions ``fns`` in a closed loop for ``seconds``.

    ``on_start`` runs once, on the calling thread, just before the clients
    are released.  ``check(client, result)``, where given, runs after a
    request's end is stamped, on its client's thread: its time is the
    window's but not the request's; what it returns is the request's
    result.  Returns (requests, window start, window end) on the host's
    ``perf_counter`` clock; a client's exception is raised here."""
    barrier = threading.Barrier(len(fns) + 1)
    done: list[list[Request]] = [[] for _ in fns]
    errors: list = []
    t0 = [0.0]

    def client(i):
        fn = fns[i]
        barrier.wait()
        deadline = t0[0] + seconds
        try:
            while True:
                start = time.perf_counter()
                if start >= deadline:
                    break
                result = fn()
                end = time.perf_counter()
                if check is not None:
                    result = check(i, result)
                done[i].append(Request(i, start, end, result))
        except BaseException as exc:  # noqa: BLE001  (re-raised below)
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    if on_start is not None:
        on_start()
    t0[0] = time.perf_counter()
    barrier.wait()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    requests = sorted((r for d in done for r in d), key=lambda r: r.start)
    end = max((r.end for r in requests), default=t0[0])
    return requests, t0[0], end
