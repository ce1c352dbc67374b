"""The metric arithmetic: a rate over a window with its drain, the tail
over all requests, a roofline share, busy time from overlapping
intervals, the quartile spread."""
import statistics
import time

import pytest

from qzbench import stats, traffic


def test_closed_loop_window_ends_with_the_last_request():
    calls = []

    def slow():
        time.sleep(0.05)
        calls.append(1)
        return None

    reqs, t0, t1 = traffic.closed_loop([slow, slow], 0.12)
    # no request starts after the planned end; the window waits for the
    # last one started before it
    assert all(r.start < t0 + 0.12 for r in reqs)
    assert t1 == max(r.end for r in reqs) and t1 > t0 + 0.12
    assert len(reqs) == len(calls)
    # the rate: all the bytes over all the window
    assert stats.rate_gbps(len(reqs) * 1e9, t1 - t0) == pytest.approx(
        len(reqs) / (t1 - t0))


def test_closed_loop_checks_after_the_request_clock():
    def fast():
        return "out"

    def check(client, result):
        time.sleep(0.03)
        return (client, result)

    reqs, t0, t1 = traffic.closed_loop([fast, fast], 0.05, check=check)
    assert reqs and all(r.result == (r.client, "out") for r in reqs)
    # the check's time is the window's, not the request's: each client's
    # next request waits for it, and the window ends at the last request
    assert max(r.seconds for r in reqs) < 0.02
    assert len(reqs) >= 4 and all(r.start - t0 < 0.05 for r in reqs)
    assert t1 == max(r.end for r in reqs)


def test_closed_loop_reraises_a_client_error():
    def boom():
        raise RuntimeError("client")

    with pytest.raises(RuntimeError):
        traffic.closed_loop([boom], 0.05)


def test_p95_nearest_rank_over_all():
    assert stats.p95(range(1, 101)) == 95
    assert stats.p95([5.0]) == 5.0
    assert stats.p95(list(range(20))) == 18
    assert stats.p95([]) is None


def test_roofline_share():
    assert stats.roofline_pct(3.35e9, 3.35e12, 0.002) == pytest.approx(50.0)
    assert stats.roofline_pct(1, 1, 0) is None


def test_busy_and_gaps_of_overlapping_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10, 11)]
    assert stats.busy(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.union([(1, 2), (2, 3)]) == [(1, 3)]


def test_spread_is_the_stdlib_quartiles():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_traffic_file_is_checked():
    good = {"direction": "compress", "request_bytes": 1, "clients": 1,
            "loop": "closed", "warmup_requests": 1}
    assert traffic.validate(dict(good)) == good
    for bad in ({"loop": "open"}, {"direction": "both"}, {"clients": 0}):
        with pytest.raises(ValueError):
            traffic.validate(dict(good, **bad))


def _fake_run(port_records: int):
    """A traced run's reductions, with made-up records: two torch ops and
    one launch of the program's kernel, of which the profiler kept
    ``port_records``."""
    import types

    from qzbench import harness, tracing

    cell = types.SimpleNamespace(direction="compress")
    run = harness.Run(cell)
    ops = [("aten_sort", 1.0, 1.5, "mf"), ("Memcpy DtoH", 2.0, 3.0, "gather")]
    # the profiler does not tie the program's own launches to a span:
    # each takes its launch's, by order
    ops += [("void qz_select_kernel<16, true>(QzSelectArgs)", 1.5, 1.6,
             None)][:port_records]
    tl = types.SimpleNamespace(ops=ops, window=10.0)
    tl.port_ops = lambda: tracing.DeviceTimeline.port_ops(tl)
    tl.torch_ops = lambda: tracing.DeviceTimeline.torch_ops(tl)
    run.timeline = tl
    run.launches = [("qz_select_to_positions", "mf")]
    run.counted = 1
    tl.host = [(1, "mf", 0.9, 1.7), (2, "assemble", 3.0, 9.0)]
    return run


def test_device_time_from_the_profiler_records():
    run = _fake_run(1)
    assert run.launches_match()
    assert run.device_s("mf") == pytest.approx(0.6)
    assert run.device_s("gather") == pytest.approx(1.0)
    assert run.device_s("assemble") is None
    assert run.busy_s() == pytest.approx(1.6)


@pytest.mark.parametrize("lost", ["profiler", "counter"])
def test_no_device_metric_where_the_launch_counts_differ(lost):
    from qzbench import harness

    run = _fake_run(0 if lost == "profiler" else 1)
    if lost == "counter":
        run.counted = 2
    assert not run.launches_match()
    assert run.device_ops() is None and run.device_s("mf") is None
    for name in ("mf_roofline", "device_idle.compress"):
        reader = harness.load_module(
            f"{harness.HERE}/metrics/{name}.py", "t_" + name.replace(".", "_"))
        run.peaks = {"hbm_bytes_per_s": 3.35e12}
        run.raw_bytes = 1 << 20
        assert reader.read(run) is None
    # busy time still counts every record the profiler kept
    assert run.busy_s() == pytest.approx(1.5 if lost == "profiler" else 1.6)


def test_breakdown_names_idle_time_by_the_open_spans():
    from qzbench import breakdown

    b = breakdown.build(_fake_run(1))
    assert b["device_ops"][0] == ["Memcpy DtoH", pytest.approx(1.0)]
    idle = dict(b["idle_gaps"])
    # idle 0-1 (middle 0.5: nothing open), 1.6-2 (1.8: nothing), 3-10
    # (6.5: assemble)
    assert idle["assemble"] == pytest.approx(7.0)
    assert idle["no span open"] == pytest.approx(1.4)
