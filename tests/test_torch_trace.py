"""The port's own spans, set-up record and counter read-out
(engine/flow.py), on the CPU device (the kernels' plain versions).

A request is traced while ``torch.profiler`` records or after
``qz_trace(True)``, and untraced otherwise: then no layer records
anything.  A traced request's spans form one tree under its ``request``
span, on its own thread; the inflate batch splits into the header parse,
the table regions, the device round and the apply, which cover its wall.
"""
import ctypes
import gzip
import subprocess
import sys
import threading

import pytest
import torch

import qatzip_tpu_torch as qt
from qatzip_tpu_torch.engine import core, flow
from qatzip_tpu_torch.engine.instances import pool
from qatzip_tpu_torch.formats import gzip_fmt
from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import inflate as PI
from torch_conformance import engine_on, port_engine  # noqa: F401

torch.set_num_threads(1)

HW = 4096
INFLATE_PARTS = ("inflate.parse", "inflate.tables", "inflate.device",
                 "inflate.apply")


def _text(n, seed):
    import random

    rng = random.Random(seed)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
             b"dog", b"compression", b"hardware", b"offload"]
    out = bytearray()
    while len(out) < n:
        out += rng.choice(words) + b" " + bytes([rng.randrange(256)])
    return bytes(out[:n])


def _session():
    sess = qt.QzSession()
    p = qt.QzSessionParamsDeflateExt()
    p.deflate_params.common_params.hw_buff_sz = HW
    assert qt.qz_setup_session_deflate_ext(sess, p) == qt.QZ_OK
    return sess


@pytest.fixture
def traced():
    """Every request traced; yields a function giving the spans kept
    since, by request id."""
    n0 = len(qt.qz_trace_spans())
    qt.qz_trace(True)

    def trees():
        out = {}
        for s in qt.qz_trace_spans()[n0:]:
            out.setdefault(s["request"], []).append(s)
        return out

    try:
        yield trees
    finally:
        qt.qz_trace(False)


def _wall(s):
    return s["end_ns"] - s["start_ns"]


def _check_tree(spans):
    """One request's spans: one id, indexes in order, the root first and
    every parent a span of the same request that holds its child."""
    assert len({s["request"] for s in spans}) == 1
    assert [s["index"] for s in spans] == list(range(len(spans)))
    assert spans[0]["name"] == "request" and spans[0]["parent"] == -1
    assert len({s["thread"] for s in spans}) == 1
    for s in spans[1:]:
        assert 0 <= s["parent"] < s["index"]
        p = spans[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert 0 <= s["cpu_ns"] and s["launches"] == 0


def _payloads(comp):
    """Each gzip-ext member's deflate payload."""
    out, pos = [], 0
    while pos < len(comp):
        ext = gzip_fmt.parse_gzipext_header(comp, pos)
        start = pos + gzip_fmt.GZIPEXT_HEADER_SIZE
        out.append(comp[start:start + ext.dest_sz])
        pos = start + ext.dest_sz + 8
    return out


def test_untraced_requests_record_no_span(port_engine, monkeypatch):
    data = _text(2 * HW, 1)
    sess = _session()
    seen = []
    real = PI.decode_blocks

    def decode_blocks(*args):
        seen.append(flow.tls.rec)
        return real(*args)

    monkeypatch.setattr(PI, "decode_blocks", decode_blocks)
    n0 = len(qt.qz_trace_spans())
    comp = qt.qz_compress(sess, data)
    assert qt.qz_decompress(sess, comp.data).data == data
    assert seen and set(seen) == {None} and flow.tls.rec is None
    assert len(qt.qz_trace_spans()) == n0
    assert core.flow.spans_dropped == 0


def test_a_traced_decompress_splits_its_inflate_batch(port_engine, traced):
    data = _text(3 * HW, 2)
    sess = _session()
    comp = qt.qz_compress(sess, data).data
    payloads = _payloads(comp)
    # each member one final dynamic block: the device decodes every stream
    # in one round, two table regions a block
    assert all(p[0] & 1 and (p[0] >> 1) & 3 == 2 for p in payloads)
    trees = traced()
    res = qt.qz_decompress(sess, comp)
    assert res.data == data
    (rid, spans), = [t for t in traced().items() if t[0] not in trees]
    _check_tree(spans)
    names = [s["name"] for s in spans]
    assert names[:3] == ["request", "pool.grab", "inflate.batch"]
    assert spans[0]["value"] == len(comp)
    batch = spans[2]
    parts = [s for s in spans if s["parent"] == batch["index"]]
    assert {s["name"] for s in parts} == set(INFLATE_PARTS)
    assert sum(_wall(s) for s in parts) >= 0.95 * _wall(batch)
    assert batch["value"] == len(payloads)

    def values(name):
        return [s["value"] for s in parts if s["name"] == name]

    assert values("inflate.device") == [len(payloads)]
    assert values("inflate.tables") == [2 * len(payloads)]
    assert values("inflate.apply") == [len(data)]
    assert values("inflate.parse") == [len(payloads), 0]
    assert spans[0]["failover_lanes"] == batch["failover_lanes"] == 0


def test_a_traced_compress_records_its_stages(port_engine, traced):
    data = _text(3 * HW, 3)
    sess = _session()
    trees = traced()
    comp = qt.qz_compress(sess, data)
    assert qt.qz_decompress(sess, comp.data).data == data
    new = [t for t in traced().values() if t[0]["request"] not in trees]
    spans = [t for t in new if t[0]["value"] == len(data)
             and any(s["name"] == "mf" for s in t)][0]
    _check_tree(spans)
    assert [s["name"] for s in spans] == [
        "request", "pool.grab", "staging", "mf", "gather", "assemble"]
    assert all(s["parent"] == 0 for s in spans[1:])
    nchunks = len(data) // HW
    by = {s["name"]: s["value"] for s in spans}
    assert by["staging"] == nchunks * (HW + 8) + 4 * nchunks
    assert by["gather"] == nchunks * HW * 2      # the raw candidate format
    assert by["assemble"] == nchunks


def test_four_threads_keep_their_trees_apart(port_engine, traced):
    trees0 = traced()
    datas = [_text(2 * HW, 10 + i) for i in range(4)]
    ran = {}
    start = threading.Barrier(4)

    def client(i):
        sess = _session()
        start.wait(timeout=60)
        res = qt.qz_compress(sess, datas[i])
        ran[i] = (threading.get_native_id(), res)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(ran) == 4
    new = {r: s for r, s in traced().items() if r not in trees0}
    assert len(new) == 4
    for spans in new.values():
        _check_tree(spans)
        assert spans[0]["value"] == 2 * HW
    assert {s[0]["thread"] for s in new.values()} == {
        tid for tid, _ in ran.values()}
    for i, (_, res) in ran.items():
        assert gzip.decompress(res.data) == datas[i]


def test_the_profiler_switches_tracing_on_and_off(port_engine):
    data = _text(2 * HW, 4)
    sess = _session()
    n0 = len(qt.qz_trace_spans())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        comp = qt.qz_compress(sess, data)
    n1 = len(qt.qz_trace_spans())
    assert n1 > n0
    assert qt.qz_decompress(sess, comp.data).data == data
    assert len(qt.qz_trace_spans()) == n1
    ranges = {e.name for e in prof.events() if e.name.startswith("qz.")}
    assert {"qz.request", "qz.pool.grab", "qz.staging", "qz.mf", "qz.gather",
            "qz.assemble"} <= ranges


def test_the_span_buffer_stops_at_its_cap(port_engine, traced, monkeypatch):
    monkeypatch.setattr(flow, "SPAN_CAP", 4)
    monkeypatch.setattr(core.flow, "spans", [])
    monkeypatch.setattr(core.flow, "spans_dropped", 0)
    sess = _session()
    qt.qz_compress(sess, _text(2 * HW, 5))
    assert len(qt.qz_trace_spans()) == 4
    assert core.flow.spans_dropped == 2
    qt.qz_compress(sess, _text(2 * HW, 6))
    assert len(qt.qz_trace_spans()) == 4
    assert core.flow.spans_dropped == 8
    assert qt.qz_dump_counters()["spans_dropped"] == 8
    assert qt.qz_trace_spans(clear=True) and qt.qz_trace_spans() == []


@pytest.fixture
def fake_kernel(tmp_path, monkeypatch):
    """A kernel of a library built by g++ here, that 'launches' on the
    host: ``qz_fake_launch(x)`` returns 0 for x == 7."""
    src = tmp_path / "fake.c"
    src.write_text('const char *qz_cuda_error_string(int e) { return "x"; }\n'
                   "int qz_fake_launch(int x) { return x == 7 ? 0 : 1; }\n")
    lib = tmp_path / "libqzfake.so"
    subprocess.run(["gcc", "-shared", "-fPIC", str(src), "-o", str(lib)],
                   check=True, timeout=120)
    monkeypatch.setattr(_build, "build",
                        lambda force=False, name=_build.KERNELS: str(lib))
    monkeypatch.setattr(_build, "_libs", dict(_build._libs))
    monkeypatch.setattr(_build, "_kernels", list(_build._kernels))
    return _build.Kernel("qz_fake_launch", [ctypes.c_int], lib="libqzfake.so")


def test_the_setup_record_holds_its_phases(port_engine, fake_kernel):
    n0 = len(qt.qz_trace_setup())
    fake_kernel(7)
    fake_kernel(7)
    phases = qt.qz_trace_setup()
    assert {"setup.import", "setup.native", "setup.engine", "setup.kernels",
            "setup.first_launch"} <= {p["name"] for p in phases}
    new = phases[n0:]
    assert [p["name"] for p in new] == ["setup.kernels", "setup.first_launch"]
    assert new[0]["value"] in (0, 1) and new[1]["value"] == "qz_fake_launch"
    for p in phases:
        assert p["end_ns"] >= p["start_ns"] and p["cpu_ns"] >= 0
    assert fake_kernel.launches == 2
    assert qt.qz_dump_counters()["launches.qz_fake_launch"] == 2


def test_a_launch_is_counted_on_its_span_and_ranged(fake_kernel, traced):
    fake_kernel(7)                      # bound: the first launch is set-up
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rec = core.flow.request()
        with rec.traced(0):
            span = rec.open("inflate.device")
            fake_kernel(7)
            fake_kernel(7)
            rec.close(span)
    assert [(s.name, s.launches) for s in rec.spans] == [
        ("request", 2), ("inflate.device", 2)]
    launches = [e for e in prof.events()
                if e.name == "qz.launch.qz_fake_launch"]
    outer = [e for e in prof.events() if e.name == "qz.inflate.device"]
    assert len(launches) == 2 and len(outer) == 1
    assert all(outer[0].time_range.start <= e.time_range.start
               and e.time_range.end <= outer[0].time_range.end
               for e in launches)
    assert flow.tls.rec is None


def test_dump_counters_has_the_pool_and_its_wait(port_engine):
    sess = _session()
    d0 = qt.qz_dump_counters()
    qt.qz_compress(sess, _text(2 * HW, 7))
    d1 = qt.qz_dump_counters()
    stats = pool.stats()
    assert {f"pool_{k}" for k in stats} | {"pool_grab_wait_ns"} <= set(d1)
    assert d1["pool_grabs"] == d0["pool_grabs"] + 1 == stats["grabs"]
    assert d1["pool_grab_wait_ns"] >= d0["pool_grab_wait_ns"] >= 0
    for key in ("failover_lanes", "failover_blocks", "health_failures",
                "spans_dropped", "hw_requests", "sw_requests"):
        assert isinstance(d1[key], int)
    assert any(k.startswith("launches.") for k in d1)


# -- the LZ4 decompress path ------------------------------------------------
LZ4_PARTS = ("lz4.walk", "lz4.stage", "lz4.device", "lz4.collect",
             "lz4.assemble", "lz4.checksum")


def _lz4_session():
    sess = qt.QzSession()
    common = qt.QzSessionParamsCommon(comp_lvl=1, hw_buff_sz=HW)
    assert qt.qz_setup_session_lz4(
        sess, qt.QzSessionParamsLZ4(common_params=common)) == qt.QZ_OK
    return sess


def _lz4_input(seed):
    """Text chunks with one incompressible chunk among them, so that the
    port's LZ4 frames hold compressed and stored blocks."""
    import random

    noise = random.Random(seed).randbytes(HW)
    return _text(2 * HW, seed) + noise + _text(HW, seed + 1)


def _lz4_blocks(comp):
    """(stored, offset, size) of each block of each LZ4 frame in
    ``comp``."""
    from qatzip_tpu_torch.formats import lz4_fmt

    out, pos = [], 0
    while pos < len(comp):
        hlen, _ = lz4_fmt.parse_lz4_frame_header(comp, pos)
        pos += hlen
        while True:
            word = int.from_bytes(comp[pos:pos + 4], "little")
            pos += 4
            if word == 0:
                break
            out.append((bool(word >> 31), pos, word & 0x7FFFFFFF))
            pos += word & 0x7FFFFFFF
        pos += 4                         # the content checksum
    return out


def _lz4_request(traced, sess, comp):
    trees = traced()
    res = qt.qz_decompress(sess, comp)
    (_, spans), = [t for t in traced().items() if t[0] not in trees]
    return res, spans


def test_a_traced_lz4_decompress_splits_its_batch(port_engine, traced):
    from qatzip_tpu_torch.ops import lz4_decode as ld

    data = _lz4_input(20)
    sess = _lz4_session()
    comp = qt.qz_compress(sess, data).data
    blocks = _lz4_blocks(comp)
    packed = [size for stored, _, size in blocks if not stored]
    assert len(blocks) == 4 and len(packed) == 3
    res, spans = _lz4_request(traced, sess, comp)
    assert res.rc == qt.QZ_OK and res.data == data
    _check_tree(spans)
    top = [s["name"] for s in spans if s["parent"] == 0]
    assert top == ["lz4.walk", "pool.grab", "lz4.batch", "lz4.checksum"]
    batch = [s for s in spans if s["name"] == "lz4.batch"][0]
    parts = [s for s in spans if s["parent"] == batch["index"]]
    # one span of each name a call, and one a request beside the call
    assert [s["name"] for s in parts] == list(LZ4_PARTS)
    assert len(spans) == 1 + len(top) + len(parts)
    assert sum(_wall(s) for s in parts) >= 0.9 * _wall(batch)
    n = ld._next_pow2(max(packed) + 8, 1024)
    by = {s["name"]: s["value"] for s in parts}
    assert by == {"lz4.walk": 4, "lz4.stage": len(packed) * (n + 4),
                  "lz4.device": 1, "lz4.collect": len(packed) * HW,
                  "lz4.assemble": 4, "lz4.checksum": len(data)}
    assert batch["value"] == len(blocks)
    assert [s["value"] for s in spans if s["parent"] == 0
            and s["name"] != "pool.grab"] == [4, len(blocks), len(data)]
    assert spans[0]["failover_lanes"] == batch["failover_lanes"] == 0


def test_an_untraced_lz4_request_records_no_span(port_engine, monkeypatch):
    from qatzip_tpu_torch.ops import lz4_decode as ld

    data = _lz4_input(21)
    sess = _lz4_session()
    comp = qt.qz_compress(sess, data).data
    seen = []
    real = ld._decode_blocks_impl

    def impl(*args):
        seen.append(flow.tls.rec)
        return real(*args)

    monkeypatch.setattr(ld, "_decode_blocks_impl", impl)
    n0 = len(qt.qz_trace_spans())
    assert qt.qz_decompress(sess, comp).data == data
    assert seen == [None] and flow.tls.rec is None
    assert len(qt.qz_trace_spans()) == n0


def test_the_lz4_counters_rise_by_the_blocks_of_a_request(port_engine):
    data = _lz4_input(22)
    sess = _lz4_session()
    comp = qt.qz_compress(sess, data).data
    blocks = _lz4_blocks(comp)
    d0 = qt.qz_dump_counters()
    assert qt.qz_decompress(sess, comp).data == data
    d1 = qt.qz_dump_counters()
    rise = {k: d1[k] - d0[k] for k in ("lz4_blocks_device",
                                       "lz4_blocks_stored",
                                       "failover_blocks")}
    stored = sum(b[0] for b in blocks)
    assert rise == {"lz4_blocks_device": len(blocks) - stored,
                    "lz4_blocks_stored": stored, "failover_blocks": 0}


def test_a_device_failure_shows_on_the_lz4_batch(port_engine, traced):
    from qatzip_tpu_torch.engine import faults

    data = _lz4_input(23)
    sess = _lz4_session()
    comp = qt.qz_compress(sess, data).data
    packed = sum(not b[0] for b in _lz4_blocks(comp))
    faults.inject_error("submit", nth=1, direction="decompress", count=1)
    try:
        res, spans = _lz4_request(traced, sess, comp)
        assert not faults.armed()
    finally:
        faults.clear()
        from qatzip_tpu_torch.engine.health import health

        health.record_success()
    assert res.rc == qt.QZ_OK and res.data == data
    _check_tree(spans)
    batch = [s for s in spans if s["name"] == "lz4.batch"][0]
    assert batch["failover_lanes"] == spans[0]["failover_lanes"] == packed
    # the decoder was never reached: no span of its phases
    assert {s["name"] for s in spans if s["parent"] == batch["index"]} == {
        "lz4.walk", "lz4.assemble", "lz4.checksum"}


def test_a_launch_in_the_lz4_decoder_falls_on_lz4_device(
        port_engine, fake_kernel, traced, monkeypatch):
    from qatzip_tpu_torch.ops import lz4_decode as ld

    fake_kernel(7)                      # bound: the first launch is set-up
    real = ld._decode_blocks_impl

    def impl(*args):
        fake_kernel(7)
        return real(*args)

    monkeypatch.setattr(ld, "_decode_blocks_impl", impl)
    data = _lz4_input(24)
    sess = _lz4_session()
    comp = qt.qz_compress(sess, data).data
    res, spans = _lz4_request(traced, sess, comp)
    assert res.data == data
    launched = {s["name"]: s["launches"] for s in spans if s["launches"]}
    assert launched == {"request": 1, "lz4.batch": 1, "lz4.device": 1}


def test_the_lz4_counters_lose_no_update_under_threads(port_engine):
    from qatzip_tpu_torch.ops import lz4_decode as ld

    sess = _lz4_session()
    comp = qt.qz_compress(sess, _text(2 * HW, 25)).data
    blocks = [comp[at:at + n] for _, at, n in _lz4_blocks(comp)]
    assert len(blocks) == 2
    d0, s0 = ld.device_blocks, ld.stored_blocks
    start = threading.Barrier(8)
    done = []

    def worker():
        start.wait(timeout=60)
        for _ in range(4):
            done.append(ld.decode_blocks(blocks, device=torch.device("cpu")))
            for _ in range(500):
                ld.count_stored(1)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(done) == 32
    assert all(None not in d for d in done)
    assert ld.device_blocks - d0 == 64 and ld.stored_blocks - s0 == 16000

