"""The port's DEFLATE device path end to end, through its public API.

The port's engine runs on an explicit ``torch.device("cpu")`` (the seam
that runs the kernels' plain versions) with the device route forced, and
its compressed bytes must equal the reference package's with the same
settings; its decompress must return the input without any lane failing
over to the CPU.  Without CUDA, default init must report QZ_NO_HW and run
the labelled software path.
"""
import gzip
import subprocess
import sys

import pytest
import torch

import qatzip_tpu
import qatzip_tpu_torch as qt
from qatzip_tpu import constants as C
from qatzip_tpu.constants import QzDataFormat
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.ops import deflate_decode as dd
from tests.torch_conformance import engine_on  # noqa: F401 (fixture)

torch.set_num_threads(1)

HW_BUFF = 16 << 10


@pytest.mark.parametrize("level", [1, 6])
def test_gzipext_bytes_equal_reference_and_round_trip(corpus_factory,
                                                      monkeypatch, engine_on,
                                                      level):
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    sess, rc = engine_on(torch.device("cpu"))
    assert rc == C.QZ_OK and sess.hw_session_stat == C.QZ_OK
    eng = core.engine()
    assert eng.hw_present and eng.hw_backend.device.type == "cpu"
    data = corpus_factory(200_000, "text")
    fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
    hw0, sw0, fail0 = eng.hw_requests, eng.sw_requests, dd.failover_lanes
    failures0 = health.total_failures

    comp = qt.compress(data, fmt=fmt, level=level, hw_buff_sz=HW_BUFF)
    assert comp == qatzip_tpu.compress(data, fmt=fmt, level=level,
                                       hw_buff_sz=HW_BUFF)
    assert gzip.decompress(comp) == data
    assert qt.decompress(comp, hw_buff_sz=HW_BUFF) == data

    nchunks = -(-len(data) // HW_BUFF)
    assert eng.hw_requests - hw0 == 2 * nchunks
    assert eng.sw_requests == sw0
    assert dd.failover_lanes == fail0
    assert health.total_failures == failures0


_FORMATS = {"gzip": ("deflate", QzDataFormat.QZ_DEFLATE_GZIP),
            "gzip_ext": ("deflate", QzDataFormat.QZ_DEFLATE_GZIP_EXT),
            "raw": ("deflate", QzDataFormat.QZ_DEFLATE_RAW),
            "4b": ("deflate", QzDataFormat.QZ_DEFLATE_4B),
            "zlib": ("zlib", None)}


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("name", list(_FORMATS))
def test_deflate_formats_bytes_equal_reference(corpus_factory, monkeypatch,
                                               engine_on, name, level):
    """Every deflate wire format at L1 and L9, device route forced in both
    packages: identical bytes, and the port reads them back."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    engine_on(torch.device("cpu"))
    eng = core.engine()
    algorithm, fmt = _FORMATS[name]
    data = corpus_factory(200_000, "text")
    hw0, sw0, failures0 = eng.hw_requests, eng.sw_requests, \
        health.total_failures

    comp = qt.compress(data, algorithm, fmt=fmt, level=level,
                       hw_buff_sz=HW_BUFF)
    assert comp == qatzip_tpu.compress(data, algorithm, fmt=fmt, level=level,
                                       hw_buff_sz=HW_BUFF)
    assert eng.hw_requests - hw0 == -(-len(data) // HW_BUFF)
    assert qt.decompress(comp, algorithm, fmt=fmt, hw_buff_sz=HW_BUFF) == data
    assert eng.sw_requests == sw0
    assert health.total_failures == failures0


def test_no_cuda_default_init_is_labelled_software(corpus_factory,
                                                   monkeypatch, engine_on):
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sess, rc = engine_on()
    assert rc == C.QZ_OK and sess.hw_session_stat == C.QZ_NO_HW
    assert not core.engine().hw_present
    data = corpus_factory(50_000, "text")
    res = qt.qz_compress(sess, data)
    assert res.rc == C.QZ_OK and res.ext_rc & C.QZ_SW_EXECUTION_MASK
    out = qt.qz_decompress(sess, res.data)
    assert out.rc == C.QZ_OK and out.ext_rc & C.QZ_SW_EXECUTION_MASK
    assert out.data == data


@pytest.mark.parametrize("env,value,direction", [
    ("QATZIP_TPU_ENCODER", "device", "compress"),
    ("QATZIP_TPU_INFLATE", "spec", "decompress"),
])
def test_unported_options_raise(corpus_factory, monkeypatch, engine_on, env,
                                value, direction):
    """The parity engines' options run on the device route:
    QATZIP_TPU_ENCODER=device compresses to bytes gzip reads and the
    software path inflates, QATZIP_TPU_INFLATE=spec decompresses with no
    lane failed over; neither raises."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    engine_on(torch.device("cpu"))
    eng = core.engine()
    data = corpus_factory(20_000, "text")
    comp = qt.compress(data, level=1, hw_buff_sz=HW_BUFF)
    monkeypatch.setenv(env, value)
    hw0, sw0, fail0 = eng.hw_requests, eng.sw_requests, dd.failover_lanes
    if direction == "compress":
        out = qt.compress(data, level=1, hw_buff_sz=HW_BUFF)
        assert gzip.decompress(out) == data
        assert qt.decompress(out, hw_buff_sz=HW_BUFF, sw_only=True) == data
    else:
        assert qt.decompress(comp, hw_buff_sz=HW_BUFF) == data
    nchunks = -(-len(data) // HW_BUFF)
    assert eng.hw_requests - hw0 == nchunks
    # the compress's check reads its output once on the software path
    assert eng.sw_requests - sw0 == (nchunks if direction == "compress"
                                     else 0)
    assert dd.failover_lanes == fail0


@pytest.mark.parametrize("direction", ["compress", "decompress",
                                       "lz4_compress"])
def test_kernel_that_cannot_build_raises_instead_of_failing_over(
        corpus_factory, monkeypatch, engine_on, tmp_path, direction):
    """A kernel launch whose build fails must reach the caller: the device
    failover is for device errors, not for a missing kernel."""
    from qatzip_tpu_torch.ops import _build
    from qatzip_tpu_torch.ops import inflate as PI
    from qatzip_tpu_torch.ops import inflate_kernel as K
    from qatzip_tpu_torch.ops import match_finder as mf
    from qatzip_tpu_torch.ops import select as S

    def no_nvcc():
        raise _build.KernelError("nvcc not found")

    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    sess, _ = engine_on(torch.device("cpu"))
    data = corpus_factory(40_000, "text")
    comp = qt.compress(data, level=1, hw_buff_sz=HW_BUFF)

    # route the CPU tensors into the kernels' launches, as a CUDA tensor is
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    for kern in (S.POS_KERNEL, K.KERNEL):
        monkeypatch.setattr(kern, "_fn", None)
    monkeypatch.setattr(mf, "select_to_positions",
                        lambda *a: S.POS_KERNEL(*[0] * 9))
    monkeypatch.setattr(PI, "decode_lockstep",
                        lambda *a: K.KERNEL(*[0] * 15))
    hw0, sw0, failures0 = (core.engine().hw_requests,
                           core.engine().sw_requests, health.total_failures)
    launches0 = S.POS_KERNEL.launches, K.KERNEL.launches
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        if direction == "compress":
            qt.qz_compress(sess, data)
        elif direction == "lz4_compress":
            qt.compress(data, "lz4", hw_buff_sz=HW_BUFF)
        else:
            qt.qz_decompress(sess, comp)
    assert (core.engine().hw_requests, core.engine().sw_requests) == (hw0,
                                                                      sw0)
    assert health.total_failures == failures0
    assert (S.POS_KERNEL.launches, K.KERNEL.launches) == launches0


@pytest.mark.parametrize("level", [1, 6])
def test_packed_bytes_equal_reference(corpus_factory, monkeypatch, engine_on,
                                      level):
    """QATZIP_TPU_PACK=1: the packed candidate format through the API gives
    the reference's bytes, which differ from the raw format's, and reads
    back."""
    from qatzip_tpu_torch.ops import match_finder as mf

    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    engine_on(torch.device("cpu"))
    data = corpus_factory(200_000, "text")
    fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
    raw = qt.compress(data, fmt=fmt, level=level, hw_buff_sz=HW_BUFF)
    monkeypatch.setenv("QATZIP_TPU_PACK", "1")
    calls = []
    packed_fn = mf.find_candidates_packed
    monkeypatch.setattr(mf, "find_candidates_packed",
                        lambda *a: calls.append(1) or packed_fn(*a))
    comp = qt.compress(data, fmt=fmt, level=level, hw_buff_sz=HW_BUFF)
    assert calls
    assert comp == qatzip_tpu.compress(data, fmt=fmt, level=level,
                                       hw_buff_sz=HW_BUFF)
    assert comp != raw
    assert gzip.decompress(comp) == data
    assert qt.decompress(comp, hw_buff_sz=HW_BUFF) == data


@pytest.mark.parametrize("pack_wins", [True, False])
def test_pack_wins_in_the_record_picks_the_format(corpus_factory, monkeypatch,
                                                  engine_on, tmp_path,
                                                  pack_wins):
    """With QATZIP_TPU_DEVICE and QATZIP_TPU_PACK unset, the calibration
    record routes compress to the device and its pack_wins picks the
    candidate format, as the reference's codec does; QATZIP_TPU_PACK still
    overrides the record."""
    import json

    from qatzip_tpu_torch.engine import devcal

    cal = tmp_path / "cal.json"
    cal.write_text(json.dumps({"comp_device_wins": True,
                               "decomp_device_wins": False,
                               "pack_wins": pack_wins}))
    monkeypatch.setenv("QATZIP_TPU_DEVCAL_PATH", str(cal))
    monkeypatch.delenv("QATZIP_TPU_DEVICE", raising=False)
    monkeypatch.delenv("QATZIP_TPU_PACK", raising=False)
    devcal.invalidate()
    engine_on(torch.device("cpu"))
    eng = core.engine()
    data = corpus_factory(100_000, "text")
    fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
    hw0 = eng.hw_requests
    comp = qt.compress(data, fmt=fmt, level=1, hw_buff_sz=HW_BUFF)
    assert eng.hw_requests > hw0
    monkeypatch.setenv("QATZIP_TPU_PACK", "1" if pack_wins else "0")
    want = qt.compress(data, fmt=fmt, level=1, hw_buff_sz=HW_BUFF)
    monkeypatch.setenv("QATZIP_TPU_PACK", "0" if pack_wins else "1")
    other = qt.compress(data, fmt=fmt, level=1, hw_buff_sz=HW_BUFF)
    assert comp == want and comp != other
    # decompress stays on the CPU: the record says the device loses there
    sw0 = eng.sw_requests
    assert qt.decompress(comp, hw_buff_sz=HW_BUFF) == data
    assert eng.sw_requests > sw0
    devcal.invalidate()


def test_lz4_is_routed_to_the_cpu(monkeypatch, engine_on):
    """Named for the routing it pinned before the LZ4 device codec: LZ4 and
    LZ4s now take the device route, like deflate."""
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    sess, _ = engine_on(torch.device("cpu"))
    st = qt.qz_get_status(sess)
    assert st.algo_hw == {"deflate": True, "lz4": True, "lz4s": True}


def test_import_loads_no_jax():
    code = ("import sys; import qatzip_tpu_torch; "
            "from qatzip_tpu_torch.ops import (device_codecs, inflate_kernel, "
            "lz4_decode, sort); "
            "sys.exit(1 if any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules) else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
