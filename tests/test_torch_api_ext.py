"""The rest of the port's qz* API against the reference's, on the same inputs.

The CRC and CRC64 variants, session CRC configs, defaults, the memory API,
software components, counters, ``member_boundaries``, the checksum helpers
and the native wrappers.  The port's engine runs on ``torch.device("cpu")``
with the device route forced in both packages (the kernels' plain versions
there); compressed bytes, checksums and return codes must equal the
reference's exactly, and round trips must not fail any lane over to the
CPU.
"""
import contextlib
import copy
import dataclasses
import gzip
import zlib

import numpy as np
import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu import constants as C
from qatzip_tpu.native import qzcore as ref_native
from qatzip_tpu.utils import checksum as ref_ck
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.native import qzcore
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.ops import lz4_decode as ld
from qatzip_tpu_torch.utils import checksum as ck

torch.set_num_threads(1)

HW_BUFF = 16 << 10
PKGS = {"ref": qatzip_tpu, "port": qt}
XZ = dict(initial_value=(1 << 64) - 1, reflect_in=1, reflect_out=1,
          xor_out=(1 << 64) - 1)
MPEG = dict(polynomial=0x04C11DB7, initial_value=0, reflect_in=0,
            reflect_out=0, xor_out=0)


@pytest.fixture
def port(monkeypatch):
    """The port's engine on the CPU device, the device route forced in both
    packages; yields the engine and closes it afterwards."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    core.qz_close_engine()
    assert qt.qz_init(qt.QzSession(), device=torch.device("cpu")) == C.QZ_OK
    yield core.engine()
    core.qz_close_engine()


@contextlib.contextmanager
def device_only(eng):
    """The block's requests run on the device: the engine counts device
    requests and no software request, no lane or LZ4 block fails over, no
    health failure.  The other test_torch_* files of the API import it and
    ``port``."""
    hw0, sw0 = eng.hw_requests, eng.sw_requests
    fail0, blocks0 = dd.failover_lanes, ld.failover_blocks
    failures0 = health.total_failures
    yield
    assert eng.hw_requests > hw0
    assert (eng.sw_requests, dd.failover_lanes, ld.failover_blocks,
            health.total_failures) == (sw0, fail0, blocks0, failures0)


def deflate_session(qz, **common):
    sess = qz.QzSession()
    p = qz.QzSessionParamsDeflate()
    p.common_params.hw_buff_sz = HW_BUFF
    for k, v in common.items():
        setattr(p.common_params, k, v)
    assert qz.qz_setup_session_deflate(sess, p) == C.QZ_OK
    return sess


def mixed(corpus_factory, n: int, seed: int = 0) -> bytes:
    """Text with a seeded random quarter (kept off the device decompress:
    the plain inflate on the CPU costs ~1 ms a step)."""
    rnd = np.random.default_rng(seed).integers(0, 256, n // 4, np.uint8)
    return corpus_factory(n - n // 4) + rnd.tobytes()


def test_api_has_every_reference_name():
    names = set(qatzip_tpu.api.__all__)
    assert names <= set(qt.api.__all__)
    assert all(hasattr(qt, n) for n in names)
    aliases = [n for n in vars(qatzip_tpu.api) if n.startswith("qz")
               and n[2:3].isupper()]
    assert len(aliases) == 49
    for n in aliases:
        assert getattr(qt.api, n).__name__ == getattr(
            qatzip_tpu.api, n).__name__, n


# ---------------------------------------------------------------------------
# CRC and CRC64 variants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", [None, XZ])
def test_crc64_round_trip_equals_reference(corpus_factory, port, config):
    data = corpus_factory(60_000)
    out = {}
    for name, qz in PKGS.items():
        sess, dsess = deflate_session(qz), deflate_session(qz)
        if config is not None:
            for s in (sess, dsess):
                assert qz.qz_set_session_crc64_config(
                    s, qz.Crc64Config(**config)) == C.QZ_OK
        with (device_only(port) if name == "port"
              else contextlib.nullcontext()):
            res = qz.qz_compress_crc64(sess, data)
            dres = qz.qz_decompress_crc64(dsess, res.data)
        assert res.rc == dres.rc == C.QZ_OK
        assert not (res.ext_rc | dres.ext_rc) & C.QZ_SW_EXECUTION_MASK
        assert dres.data == data and dres.crc == res.crc
        out[name] = (res.data, res.crc)
    assert out["port"] == out["ref"]
    want = ck.crc64(data, qt.Crc64Config(**(config or {})))
    assert out["port"][1] == want == ref_ck.crc64(
        data, qatzip_tpu.Crc64Config(**(config or {})))


@pytest.mark.parametrize("config", [None, XZ])
def test_crc64_continuation_equals_reference(corpus_factory, port, config):
    """A running CRC64 carried across two calls, a legitimately-zero one
    included, equals the reference's and the CRC64 of the whole."""
    a, b = corpus_factory(40_000), mixed(corpus_factory, 30_000, 1)
    crcs = {}
    for name, qz in PKGS.items():
        sess = deflate_session(qz)
        if config is not None:
            assert qz.qz_set_session_crc64_config(
                sess, qz.Crc64Config(**config)) == C.QZ_OK
        r1 = qz.qz_compress_crc64(sess, a)
        r2 = qz.qz_compress_crc64_ext(sess, b, crc64=r1.crc)
        r3 = qz.qz_compress_crc64(sess, b, crc64=0)
        crcs[name] = (r1.crc, r2.crc, r3.crc, r2.data)
    assert crcs["port"] == crcs["ref"]
    assert crcs["port"][1] == ck.crc64(
        a + b, qt.Crc64Config(**(config or {})))


def test_crc32_variants_and_session_config_equal_reference(corpus_factory,
                                                           port):
    data = corpus_factory(50_000)
    out = {}
    for name, qz in PKGS.items():
        sess = deflate_session(qz)
        rc, cfg = qz.qz_get_session_crc32_config(sess)
        assert rc == C.QZ_OK and cfg.reflect_in == 1
        base = qz.qz_compress_crc(sess, data, crc_init=0)
        assert qz.qz_set_session_crc32_config(
            sess, qz.Crc32Config(**MPEG)) == C.QZ_OK
        res = qz.qz_compress_crc(sess, data)
        dsess = deflate_session(qz)
        assert qz.qz_set_session_crc32_config(
            dsess, qz.Crc32Config(**MPEG)) == C.QZ_OK
        with (device_only(port) if name == "port"
              else contextlib.nullcontext()):
            dres = qz.qz_decompress_crc(dsess, res.data)
            plain = qz.qz_decompress_crc(deflate_session(qz), base.data)
        assert dres.data == plain.data == data
        out[name] = (base.data, base.crc, res.data, res.crc, dres.crc,
                     plain.crc, qz.qz_get_deflate_end_of_stream(dsess))
    assert out["port"] == out["ref"]
    assert out["port"][1] == zlib.crc32(data)
    assert out["port"][3] == ck.crc32_configured(data, qt.Crc32Config(**MPEG))
    assert out["port"][3] != out["port"][1]


# ---------------------------------------------------------------------------
# Return codes, defaults and configs
# ---------------------------------------------------------------------------
def _decompress_session(qz):
    sess = qz.QzSession()
    p = qz.QzSessionParamsDeflate()
    p.common_params.direction = C.QzDirection.QZ_DIR_DECOMPRESS
    assert qz.qz_setup_session_deflate(sess, p) == C.QZ_OK
    return sess


def _bad_defaults(qz, getter, setter):
    # a deep copy: the getters' copies share common_params with the
    # process defaults, in both packages
    d = copy.deepcopy(getattr(qz, getter)())
    common = getattr(d, "common_params", d)
    common.comp_lvl = 42
    return getattr(qz, setter)(d)


_RC_CASES = {
    "crc64 config, no setup": lambda qz: qz.qz_get_session_crc64_config(
        qz.QzSession())[0],
    "crc32 config, no setup": lambda qz: qz.qz_get_session_crc32_config(
        qz.QzSession())[0],
    "set crc64 config, no setup": lambda qz: qz.qz_set_session_crc64_config(
        qz.QzSession(), qz.Crc64Config()),
    "set crc32 config None": lambda qz: qz.qz_set_session_crc32_config(
        deflate_session(qz), None),
    "set crc64 config, no session": lambda qz:
        qz.qz_set_session_crc64_config(None, qz.Crc64Config()),
    "crc64 config, no session": lambda qz: qz.qz_get_session_crc64_config(
        "sess")[0],
    "compress crc64 on a decompress session": lambda qz:
        qz.qz_compress_crc64(_decompress_session(qz), b"abc").rc,
    "decompress crc64 of garbage": lambda qz: qz.qz_decompress_crc64(
        deflate_session(qz), b"\x1f\x8b garbage").rc,
    "compress crc, no source": lambda qz: qz.qz_compress_crc(
        qz.QzSession(), None).rc,
    "set defaults, level 42": lambda qz: _bad_defaults(
        qz, "qz_get_defaults", "qz_set_defaults"),
    "set deflate defaults, level 42": lambda qz: _bad_defaults(
        qz, "qz_get_defaults_deflate", "qz_set_defaults_deflate"),
    "set lz4 defaults, level 42": lambda qz: _bad_defaults(
        qz, "qz_get_defaults_lz4", "qz_set_defaults_lz4"),
    "set lz4s defaults, level 42": lambda qz: _bad_defaults(
        qz, "qz_get_defaults_lz4s", "qz_set_defaults_lz4s"),
    "set log level 99": lambda qz: qz.qz_set_log_level(99),
    "software component count": lambda qz:
        qz.qz_get_software_component_count()[0],
    "deflate end of stream, fresh": lambda qz:
        qz.qz_get_deflate_end_of_stream(qz.QzSession()),
}


@pytest.mark.parametrize("case", list(_RC_CASES))
def test_return_codes_equal_reference(port, case):
    got = {name: _RC_CASES[case](qz) for name, qz in PKGS.items()}
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("kind", ["legacy", "deflate", "deflate_ext", "lz4",
                                  "lz4s"])
def test_defaults_round_trip_and_feed_setup_as_reference(port, kind):
    """Each defaults pair: a legal change reads back and feeds a session
    set up with params=None, in both packages alike; restored after."""
    getter, setter, setup = {
        "legacy": ("qz_get_defaults", "qz_set_defaults", "qz_setup_session"),
        "deflate": ("qz_get_defaults_deflate", "qz_set_defaults_deflate",
                    "qz_setup_session_deflate"),
        "deflate_ext": ("qz_get_defaults_deflate_ext",
                        "qz_set_defaults_deflate_ext",
                        "qz_setup_session_deflate_ext"),
        "lz4": ("qz_get_defaults_lz4", "qz_set_defaults_lz4",
                "qz_setup_session_lz4"),
        "lz4s": ("qz_get_defaults_lz4s", "qz_set_defaults_lz4s",
                 "qz_setup_session_lz4s"),
    }[kind]
    got = {}
    for name, qz in PKGS.items():
        saved = copy.deepcopy(getattr(qz, getter)())
        d = copy.deepcopy(getattr(qz, getter)())
        if kind == "deflate_ext":
            d.zlib_format = 1
        elif kind == "legacy":
            d.comp_lvl = 6
        else:
            d.common_params.comp_lvl = 6
        try:
            rc = getattr(qz, setter)(d)
            back = dataclasses.asdict(getattr(qz, getter)())
            sess = qz.QzSession()
            rc_setup = getattr(qz, setup)(sess, None)
            deflate = dataclasses.asdict(qz.qz_get_defaults_deflate())
            got[name] = (rc, back, rc_setup, int(sess.params.data_fmt),
                         sess.params.comp_lvl, deflate)
        finally:
            assert getattr(qz, setter)(saved) == C.QZ_OK
    assert got["port"] == got["ref"]
    assert got["port"][0] == C.QZ_OK


def test_log_level_set_as_reference():
    from qatzip_tpu.utils import logging as ref_log
    from qatzip_tpu_torch.utils import logging as port_log

    saved = (ref_log._level, port_log._level)
    try:
        for level in (0, 3, 7, -1, 8):
            assert qt.qz_set_log_level(level) == qatzip_tpu.qz_set_log_level(
                level)
            assert int(port_log._level) == int(ref_log._level)
    finally:
        ref_log._level, port_log._level = saved


def test_software_components_name_torch_where_reference_names_jax():
    rc, n = qt.qz_get_software_component_count()
    rc2, comps = qt.qz_get_software_component_version_list()
    assert rc == rc2 == C.QZ_OK and n == len(comps)
    _, ref = qatzip_tpu.qz_get_software_component_version_list()
    swap = {"qatzip_tpu": ("qatzip_tpu_torch", C.QATZIP_TPU_VERSION)}
    want = []
    for name, version in ref:
        if name == "jax":
            want.append(("torch", torch.__version__))
            if torch.version.cuda:
                want.append(("cuda", torch.version.cuda))
        else:
            want.append(swap.get(name, (name, version)))
    assert comps == want
    assert "jax" not in dict(comps)


# ---------------------------------------------------------------------------
# Memory API, zero-copy sources, status and counters
# ---------------------------------------------------------------------------
def test_memory_api_as_reference():
    got = {}
    for name, qz in PKGS.items():
        buf = qz.qz_malloc(4096)
        common = qz.qz_malloc(16, force_pinned=0)
        st = qz.qz_get_status()
        seen = (len(buf), qz.qz_mem_find_addr(buf),
                qz.qz_mem_find_addr(bytearray(4096)),
                qz.qz_mem_find_addr(common), qz.qz_mem_find_addr(None),
                qz.qz_malloc(-1), st.memory_alloced >= 4112,
                st.qat_mem_drvr >= 2)
        qz.qz_free(buf)
        qz.qz_free(common)
        qz.qz_free(None)
        got[name] = seen + (qz.qz_mem_find_addr(buf),)
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (4096, 1)


def test_zero_copy_sources_equal_reference(corpus_factory, port):
    """A qz_malloc buffer, a memoryview slice and a numpy array compress to
    the reference's bytes on the device route and read back."""
    data = corpus_factory(36_000)
    out = {}
    for name, qz in PKGS.items():
        buf = qz.qz_malloc(len(data))
        buf[:] = data
        srcs = [buf, memoryview(buf)[1000:21000],
                np.frombuffer(data, np.uint8)]
        sess = deflate_session(qz)
        with (device_only(port) if name == "port"
              else contextlib.nullcontext()):
            comps = [qz.qz_compress(sess, s).data for s in srcs]
            assert qz.qz_decompress(sess, bytearray(comps[1])).data == \
                data[1000:21000]
        assert [gzip.decompress(c) for c in comps] == [
            data, data[1000:21000], data]
        qz.qz_free(buf)
        out[name] = comps
    assert out["port"] == out["ref"]


def test_dump_counters_keys_equal_reference(corpus_factory, port):
    data = corpus_factory(40_000)
    sess = deflate_session(qt)
    before = qt.qz_dump_counters()
    comp = qt.qz_compress(sess, data)
    after = qt.qz_dump_counters()
    # the reference's keys, each with its meaning, and the port's own
    # beside them (the pool, failovers, spans and launches)
    assert set(qatzip_tpu.qz_dump_counters()) <= set(after)
    assert after["pool_grabs"] - before["pool_grabs"] == 1
    n = -(-len(data) // HW_BUFF)
    assert after["hw_requests"] - before["hw_requests"] == n
    for stage in ("planned", "submitted", "completed", "reassembled"):
        assert after[stage] - before[stage] == n
    assert after["flow_errors"] == before["flow_errors"]
    assert qt.qz_decompress(sess, comp.data).data == data


_MEMBER_FORMATS = {
    "gzip_ext": ("deflate", C.QzDataFormat.QZ_DEFLATE_GZIP_EXT),
    "gzip": ("deflate", C.QzDataFormat.QZ_DEFLATE_GZIP),
    "4b": ("deflate", C.QzDataFormat.QZ_DEFLATE_4B),
    "raw": ("deflate", C.QzDataFormat.QZ_DEFLATE_RAW),
    "zlib": ("zlib", None),
    "lz4": ("lz4", None),
    "lz4s": ("lz4s", None),
}


@pytest.mark.parametrize("name", list(_MEMBER_FORMATS))
def test_member_boundaries_equal_reference(corpus_factory, name):
    algorithm, fmt = _MEMBER_FORMATS[name]
    data = corpus_factory(70_000)
    comp = qatzip_tpu.compress(data, algorithm, fmt=fmt, hw_buff_sz=HW_BUFF,
                               sw_only=True)
    got = qt.member_boundaries(comp, algorithm, fmt=fmt, hw_buff_sz=HW_BUFF)
    assert got == qatzip_tpu.member_boundaries(comp, algorithm, fmt=fmt,
                                               hw_buff_sz=HW_BUFF)
    assert got and got[-1][1] == len(comp)


# ---------------------------------------------------------------------------
# Checksum helpers and native wrappers
# ---------------------------------------------------------------------------
def test_xxh32_state_incremental_equals_reference(corpus_factory):
    data = corpus_factory(4096, "random")
    for seed, splits in ((0, [0]), (0, [1, 2, 3]), (7, [15, 16, 17]),
                         (0, [5, 16, 32, 1]), (3, [4096])):
        states = [ck.XXH32State(seed), ref_ck.XXH32State(seed)]
        pos = 0
        for s in splits + [len(data)]:
            for st in states:
                st.update(data[pos:pos + s])
            pos += s
        assert states[0].digest() == states[1].digest() == ck.xxh32(
            data, seed)
    for n in range(20):
        st = ck.XXH32State(7)
        for b in data[:n]:
            st.update(bytes([b]))
        assert st.digest() == ck.xxh32(data[:n], 7)


_CRC_CONFIGS = {
    "crc64 ecma": (0x42F0E1EBA9EA3693, 0, 64, 0, 0, 0),
    "crc64 xz": (0x42F0E1EBA9EA3693, (1 << 64) - 1, 64, 1, 1, (1 << 64) - 1),
    "crc32 gzip": (0x04C11DB7, 0xFFFFFFFF, 32, 1, 1, 0xFFFFFFFF),
    "crc32 mpeg": (0x04C11DB7, 0xFFFFFFFF, 32, 0, 0, 0),
    "crc16 arc": (0x8005, 0, 16, 1, 1, 0),
    "crc32 mixed reflection": (0x1EDC6F41, 0xFFFFFFFF, 32, 1, 0, 0),
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", list(_CRC_CONFIGS))
def test_crc_generic_and_continue_equal_reference(corpus_factory, monkeypatch,
                                                  name, native):
    """The Rocksoft-model CRC and its continuation, through the native
    library and through the Python tables, against the reference's."""
    poly, init, width, rin, rout, xor = _CRC_CONFIGS[name]
    if not native:
        monkeypatch.setattr(ck, "_native", None)
        monkeypatch.setattr(ref_ck, "_native", None)
    data = mixed(corpus_factory, 3000, 3)
    got = ck.crc_generic(data, poly, init, width, rin, rout, xor)
    assert got == ref_ck.crc_generic(data, poly, init, width, rin, rout, xor)
    part = ck.crc_generic(data[:1234], poly, init, width, rin, rout, xor)
    cont = ck.crc_continue(data[1234:], part, poly, width, rin, rout, xor)
    assert cont == got == ref_ck.crc_continue(data[1234:], part, poly, width,
                                              rin, rout, xor)


def test_crc_update_helpers_equal_reference(corpus_factory):
    a, b = corpus_factory(5000), mixed(corpus_factory, 3000, 4)
    for cfg in ({}, XZ):
        p, r = ck.Crc64Config(**cfg), ref_ck.Crc64Config(**cfg)
        assert ck.crc64_update(b, ck.crc64_update(a, 0, p, first=True), p) \
            == ref_ck.crc64_update(b, ref_ck.crc64(a, r), r) \
            == ck.crc64(a + b, p)
    for cfg in ({}, MPEG):
        p, r = ck.Crc32Config(**cfg), ref_ck.Crc32Config(**cfg)
        assert ck.crc32_update(b, ck.crc32_update(a, 0, p, first=True), p) \
            == ref_ck.crc32_update(b, ref_ck.crc32_configured(a, r), r) \
            == ck.crc32_configured(a + b, p)
    assert ck.xxh64(a, 9) == ref_ck.xxh64(a, 9)


def test_native_wrappers_equal_reference(corpus_factory):
    data = mixed(corpus_factory, 20_000, 5)
    half = len(data) // 2
    assert qzcore.crc32(data, 0) == ref_native.crc32(data, 0) \
        == zlib.crc32(data)
    assert qzcore.crc32(data[half:], zlib.crc32(data[:half])) \
        == zlib.crc32(data)
    assert qzcore.adler32(data) == ref_native.adler32(data) \
        == zlib.adler32(data)
    a1, a2 = zlib.adler32(data[:half]), zlib.adler32(data[half:])
    assert qzcore.adler32_combine(a1, a2, len(data) - half) \
        == ref_native.adler32_combine(a1, a2, len(data) - half) \
        == zlib.adler32(data)
    for seed in (0, 1, (1 << 64) - 1):
        assert qzcore.xxh64(data, seed) == ref_native.xxh64(data, seed)
    args = (0x42F0E1EBA9EA3693, (1 << 64) - 1, 64, True, True, (1 << 64) - 1)
    assert qzcore.crc_generic(data, *args) == ref_native.crc_generic(
        data, *args)
    for mini_match in (3, 4):
        block = ref_native.lz4s_compress_block(data[:16384], mini_match)
        assert qzcore.lz4s_decompress_block(block, 16384, mini_match) \
            == ref_native.lz4s_decompress_block(block, 16384, mini_match) \
            == data[:16384]
    with pytest.raises(ValueError, match="corrupt lz4s block"):
        qzcore.lz4s_decompress_block(b"\xff" * 9, 100)
