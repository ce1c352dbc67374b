"""The port stands alone: it imports nothing of the JAX package.

``qatzip_tpu_torch`` keeps its own copies of the host layers it shares with
``qatzip_tpu`` (constants, sessions, wire formats, engine helpers, the
native codec).  A static scan finds no import of ``qatzip_tpu`` in the
port or in chip_smoke.py, a fresh process that runs requests through the
port loads no module of ``qatzip_tpu`` and no jax, and the port's native
codec builds atomically into its own directory.
"""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

import bench
import qatzip_tpu_torch as qt
from qatzip_tpu.engine import faults as ref_faults
from qatzip_tpu_torch.engine import core, faults
from qatzip_tpu_torch.engine.health import health
from qatzip_tpu_torch.native import qzcore
from qatzip_tpu_torch.tools.corpus import build_corpus

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / "qatzip_tpu_torch").rglob("*.py"))


def _imported(tree: ast.AST) -> list[str]:
    """Every module an import statement names, at any depth."""
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_no_import_of_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text(), path)
    bad = [m for m in _imported(tree)
           if m in ("qatzip_tpu", "jax") or m.startswith(("qatzip_tpu.",
                                                          "jax."))]
    assert not bad, f"{path} imports {bad}"


def test_public_names_of_the_reference_exist_in_the_port(capsys):
    """Every public name of qatzip_tpu and qatzip_tpu.utils (modules
    aside) exists in the port; the enums and ext_rc helpers that only the
    reference's ``from constants import *`` exported are equal, and the
    port's logger levels work as the reference's."""
    import types

    import qatzip_tpu
    import qatzip_tpu.utils
    import qatzip_tpu_torch.utils as port_utils

    for ref, port in ((qatzip_tpu, qt), (qatzip_tpu.utils, port_utils)):
        names = [n for n in dir(ref) if not n.startswith("_")
                 and not isinstance(getattr(ref, n), types.ModuleType)]
        missing = [n for n in names if not hasattr(port, n)]
        assert not missing, f"{port.__name__} lacks {missing}"
    for name in ("PinMem", "QzCrcType", "QzSoftwareComponentType"):
        assert ({m.name: int(m) for m in getattr(qt, name)}
                == {m.name: int(m) for m in getattr(qatzip_tpu, name)})
    masks = [0, qt.QZ_SW_EXECUTION_MASK, qt.QZ_TIMEOUT_MASK,
             qt.QZ_POST_PROCESS_FAIL_MASK]
    for name in ("qz_sw_execution", "qz_hw_timeout", "qz_post_process_fail"):
        for ret in (0, -1, 1):
            for ext in masks + [sum(masks)]:
                assert (getattr(qt, name)(ret, ext)
                        == getattr(qatzip_tpu, name)(ret, ext)), (name, ret,
                                                                   ext)
    level = port_utils.get_log_level()
    try:
        assert port_utils.set_log_level(qt.QzLogLevel.LOG_INFO) == 0
        assert port_utils.get_log_level() == qt.QzLogLevel.LOG_INFO
        port_utils.QZ_INFO("shown %d", 1)
        port_utils.QZ_DEBUG("hidden")
        assert port_utils.set_log_level(99) == -1
    finally:
        port_utils.set_log_level(level)
    out = capsys.readouterr().out
    assert "[INFO]" in out and "shown 1" in out and "hidden" not in out


_SUITES = ["api", "sweep", "fuzz", "negative", "formats", "lz4_interop",
           "health", "device_decode"]


@pytest.mark.parametrize("suite", _SUITES)
def test_each_reference_suite_has_a_port_counterpart(suite):
    """tests/test_<suite>.py, a behavioural suite of the reference, has its
    counterpart tests/test_torch_<suite>.py, which imports both packages
    (only tests may; tests/torch_conformance.py imports both) and holds as
    many test functions as the reference suite, or more."""
    ref = (ROOT / "tests" / f"test_{suite}.py").read_text()
    port = (ROOT / "tests" / f"test_torch_{suite}.py").read_text()
    names = _imported(ast.parse(port))
    assert any(m == "qatzip_tpu" or m.startswith("qatzip_tpu.")
               for m in names)
    assert any(m == "qatzip_tpu_torch" or m.startswith("qatzip_tpu_torch.")
               or m == "tests.torch_conformance" for m in names)
    assert port.count("\ndef test_") >= ref.count("\ndef test_")


_ROUND_TRIPS = textwrap.dedent("""
    import importlib, os, pkgutil, sys
    import torch
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.engine import core
    from qatzip_tpu_torch.native import qzcore

    for m in pkgutil.walk_packages(qt.__path__, "qatzip_tpu_torch."):
        importlib.import_module(m.name)
    os.environ["QATZIP_TPU_DEVICE"] = "1"
    assert qt.qz_init(qt.QzSession(), device=torch.device("cpu")) == qt.QZ_OK
    data = bytes(range(256)) * 40 + b"the quick brown fox " * 1500
    for algorithm in ("deflate", "lz4", "lz4s"):
        hw0 = core.engine().hw_requests
        comp = qt.compress(data, algorithm, hw_buff_sz=16384)
        assert qt.decompress(comp, algorithm, hw_buff_sz=16384) == data
        assert core.engine().hw_requests > hw0, algorithm
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "qatzip_tpu.")) or m == "qatzip_tpu")
    maps = [ln.split()[-1] for ln in open("/proc/self/maps")
            if ln.rstrip().endswith("libqzcore.so")]
    print(repr((loaded, qzcore._path, sorted(set(maps)))))
""")


def test_round_trips_load_no_jax_package_module():
    """gzip-ext, LZ4 and LZ4s round trips through the port's API, its
    device path on the CPU, in a fresh process: no module of qatzip_tpu and
    no jax is loaded, and the native codec is the port's own build."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _ROUND_TRIPS], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    loaded, path, maps = eval(proc.stdout.strip().splitlines()[-1])
    assert loaded == []
    build = str(ROOT / "build" / "qatzip_tpu_torch") + os.sep
    assert path.startswith(build)
    assert maps and all(m.startswith(build) for m in maps)


_BUILD = textwrap.dedent("""
    import ctypes, sys
    from qatzip_tpu_torch.native import build

    build.BUILD_DIR = sys.argv[1]
    build.OUT = sys.argv[1] + "/libqzcore.so"
    lib = ctypes.CDLL(build.build())
    lib.qz_xxh32.restype = ctypes.c_uint32
    lib.qz_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                             ctypes.c_uint32]
    print(lib.qz_xxh32(b"qatzip", 6, 0))
""")


def test_concurrent_native_builds_all_load_a_whole_library(tmp_path):
    """Four processes start the native build at once on an empty build
    directory: each waits for the one build and loads a working library,
    and no temporary file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    want = qzcore.xxh32(b"qatzip", 0)
    assert [int(o.split()[-1]) for o, _ in outs] == [want] * 4
    assert sorted(os.listdir(tmp_path)) == ["libqzcore.so",
                                            "libqzcore.so.lock"]


def test_corpus_copy_equals_the_benchmark_corpus():
    assert build_corpus(1) == bench.build_corpus(1)


def test_fault_sites_take_the_ports_injector(corpus_factory, monkeypatch):
    """The device codecs' fault sites read the port's injector: a submit
    fault armed there fails the decompress batch over to the CPU (one
    health failure, same bytes), and the reference's injector stays
    unarmed."""
    import torch

    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    core.qz_close_engine()
    assert qt.qz_init(qt.QzSession(), device=torch.device("cpu")) == qt.QZ_OK
    try:
        data = corpus_factory(20_000, "text")
        comp = qt.compress(data, hw_buff_sz=16384)
        failures0 = health.total_failures
        faults.inject_error("submit", direction="decompress")
        try:
            assert not ref_faults.armed()
            assert qt.decompress(comp, hw_buff_sz=16384) == data
        finally:
            faults.clear()
        assert health.total_failures == failures0 + 1
    finally:
        health.record_success()
        core.qz_close_engine()
