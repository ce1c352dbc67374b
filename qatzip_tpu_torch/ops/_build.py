"""Build and bind the port's CUDA kernels.

Two libraries, each named in ``LIBRARIES`` with its sources: the path's
kernels, ``libqzkernels.so`` from ``qatzip_tpu_torch/csrc/*.cu`` and
``*.cuh``, and the construct probes (qatzip_tpu_torch/tools/probes.py),
``libqzprobes.so`` from ``tools/probes.cu`` and ``probes.cuh``, apart so
that a probe that does not compile cannot stop the codec.  ``nvcc``
compiles a library's sources for Hopper (``sm_90a``), one process for each
``.cu`` file, all at once, and links them into one shared library with a
plain C interface, which ``ctypes`` loads; no PyTorch header is compiled,
so a build takes seconds.  The libraries go to ``build/qatzip_tpu_torch/``
beside the package and are rebuilt at first use whenever a source is newer
than them (the rule of qatzip_tpu/native/build.py).  A missing ``nvcc`` or
a failed build raises :class:`KernelError` with the compiler's output:
nothing falls back.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises :class:`KernelError` when
that is not 0 and counts the launches that went through.  The engine's
device-to-CPU failover takes only injected faults and an exhausted card
(``engine.faults.FAILOVER``), so a kernel that cannot be built or
launched, or that faults on the card, is an error, never a quiet CPU run.

Set-up (engine/flow.py): a library's build-or-load is the ``setup.kernels``
phase (1 when it compiled), and each kernel's first launch after it
``setup.first_launch`` (the kernel's symbol).  A launch inside a traced
request is counted on its open span, and while the profiler records sits
in a ``qz.launch.<symbol>`` range.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

from qatzip_tpu_torch.engine import flow as _flow

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
TOOLS = os.path.join(PKG, "tools")
BUILD_DIR = os.path.join(os.path.dirname(PKG), "build", "qatzip_tpu_torch")
KERNELS = "libqzkernels.so"
PROBES = "libqzprobes.so"
# library name -> (its directory, the glob of its .cu sources); the glob
# with a "*" after it names every file the library depends on
LIBRARIES = {KERNELS: (CSRC, "*.cu"), PROBES: (TOOLS, "probes.cu")}
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_kernels: list["Kernel"] = []


class KernelError(RuntimeError):
    """A kernel of the port could not be built, loaded or launched, or was
    handed tensors it cannot take."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of qatzip_tpu_torch cannot be built")


def log_path(name: str = KERNELS) -> str:
    """The compiler's output of the last build of library ``name``."""
    return os.path.join(BUILD_DIR, f"{name}.nvcc.log")


def build(force: bool = False, name: str = KERNELS) -> str:
    """Compile library ``name`` of LIBRARIES into BUILD_DIR when it is
    missing or stale; returns its path."""
    where, pattern = LIBRARIES[name]
    srcs = sorted(glob.glob(os.path.join(where, pattern)))
    deps = glob.glob(os.path.join(where, pattern + "*"))
    lib = os.path.join(BUILD_DIR, name)
    if (not force and os.path.exists(lib)
            and all(os.path.getmtime(lib) >= os.path.getmtime(s)
                    for s in deps)):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{lib}.{os.getpid()}.tmp"
    # one nvcc for each source, all started together, then one link
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{os.getpid()}.o")
            for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", s, "-o", o] for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    runs = []
    for c, p in zip(cmds, procs):
        stdout, stderr = p.communicate()
        runs.append((c, p.returncode, stdout, stderr))
    if all(r[1] == 0 for r in runs):
        link = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
        out = subprocess.run(link, capture_output=True, text=True)
        runs.append((link, out.returncode, out.stdout, out.stderr))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    with open(log_path(name), "w") as f:
        for cmd, _, stdout, stderr in runs:
            f.write(" ".join(cmd) + "\n" + stdout + stderr)
    failed = [r for r in runs if r[1] != 0]
    if failed:
        cmd, rc, _, stderr = failed[0]
        raise KernelError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{stderr}")
    os.replace(tmp, lib)
    return lib


def library(name: str = KERNELS) -> ctypes.CDLL:
    """Library ``name`` of LIBRARIES, loaded, built on first use."""
    with _lock:
        if name not in _libs:
            since = _flow.now()
            before = _mtime(os.path.join(BUILD_DIR, name))
            path = build(name=name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                raise KernelError(f"cannot load {path}: {exc}") from exc
            lib.qz_cuda_error_string.restype = ctypes.c_char_p
            lib.qz_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
            _flow.flow.record_setup("setup.kernels", since,
                                    int(_mtime(path) != before))
        return _libs[name]


def kernels() -> list["Kernel"]:
    """Every Kernel made so far, in the order they were made."""
    return list(_kernels)


def _mtime(path: str) -> int | None:
    try:
        return os.stat(path).st_mtime_ns
    except FileNotFoundError:
        return None


class Kernel:
    """One C entry point of a library (the path's unless ``lib`` names
    another of LIBRARIES), with its launch count.

    Calling it launches the kernel; ``launches`` counts the calls whose
    launch the CUDA runtime accepted, and nothing else adds to it."""

    def __init__(self, symbol: str, argtypes: list, lib: str = KERNELS):
        self.symbol = symbol
        self.argtypes = argtypes
        self.lib = lib
        self.launches = 0
        self._fn = None
        self._count = threading.Lock()   # sessions launch from threads
        _kernels.append(self)

    def __call__(self, *args) -> None:
        first = None
        if self._fn is None:
            with self._count:
                if self._fn is None:
                    try:
                        fn = getattr(library(self.lib), self.symbol)
                    except AttributeError as exc:
                        raise KernelError(f"{self.symbol} is not in "
                                          f"{self.lib}") from exc
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    self._fn = fn
                    first = _flow.now()
        rec = _flow.tls.rec
        rc = (self._fn(*args) if rec is None
              else rec.launch(self.symbol, self._fn, args))
        if first is not None:
            _flow.flow.record_setup("setup.first_launch", first, self.symbol)
        if rc != 0:
            msg = library(self.lib).qz_cuda_error_string(rc).decode()
            raise KernelError(f"{self.symbol}: CUDA error {rc} ({msg})")
        with self._count:
            self.launches += 1
