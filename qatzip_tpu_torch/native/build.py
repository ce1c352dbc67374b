"""Build the port's native host codec, libqzcore.so, with g++.

Usage: python -m qatzip_tpu_torch.native.build

A copy of qatzip_tpu/native/build.py with four changes.  It compiles
every ``*.cpp`` beside it, the port's own sources among them.  The library
goes to ``build/qatzip_tpu_torch/`` beside the package, never beside its
sources.  A failed build raises ImportError with g++'s output.  And a
build is atomic: g++ writes a temporary file that ``os.replace`` puts in
place, under an exclusive lock on a file beside the library, so that
processes that start the build at once (test workers on a fresh checkout)
wait for one build and all load a whole library.
"""
from __future__ import annotations

import fcntl
import glob
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRCS = sorted(glob.glob(os.path.join(HERE, "*.cpp")))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "build",
                         "qatzip_tpu_torch")
OUT = os.path.join(BUILD_DIR, "libqzcore.so")


def _fresh() -> bool:
    return (os.path.exists(OUT)
            and all(os.path.getmtime(OUT) >= os.path.getmtime(s)
                    for s in SRCS))


def build(force: bool = False) -> str:
    """The library's path, built first where a source is newer; raises
    ImportError with g++'s output where it cannot be built."""
    if not force and _fresh():
        return OUT
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(OUT + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _fresh():  # built by another process meanwhile
            return OUT
        tmp = f"{OUT}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", "-pthread", *SRCS, "-lz", "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as exc:
            if os.path.exists(tmp):
                os.remove(tmp)
            why = getattr(exc, "stderr", None) or exc
            raise ImportError(
                f"libqzcore.so unavailable: g++ failed:\n{why}") from exc
        os.replace(tmp, OUT)
    return OUT


if __name__ == "__main__":
    try:
        print(f"built {build(force=True)}")
    except ImportError as exc:
        print(exc, file=sys.stderr)
        sys.exit(1)
