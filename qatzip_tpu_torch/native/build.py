"""Build the port's native host codec, libqzcore.so, with g++.

Usage: python -m qatzip_tpu_torch.native.build

A copy of qatzip_tpu/native/build.py with three changes.  It also compiles
``qzregions.cpp``, ``qzrows.cpp`` and ``qzapply.cpp``, the port's own
sources.  The library
goes to ``build/qatzip_tpu_torch/`` beside the package, never beside its
sources.
And a build is atomic: g++ writes a temporary file that ``os.replace``
puts in place, under an exclusive lock on a file beside the library, so
that processes that start the build at once (test workers on a fresh
checkout) wait for one build and all load a whole library.
"""
from __future__ import annotations

import fcntl
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRCS = [os.path.join(HERE, name)
        for name in ("qzcore.cpp", "qzdeflate.cpp", "qzbatch.cpp",
                     "qzregions.cpp", "qzrows.cpp", "qzapply.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "build",
                         "qatzip_tpu_torch")
OUT = os.path.join(BUILD_DIR, "libqzcore.so")


def _fresh() -> bool:
    return (os.path.exists(OUT)
            and all(os.path.getmtime(OUT) >= os.path.getmtime(s)
                    for s in SRCS))


def build(force: bool = False) -> str | None:
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
            print(f"qzcore build failed: {exc}", file=sys.stderr)
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
        os.replace(tmp, OUT)
    return OUT


if __name__ == "__main__":
    path = build(force=True)
    print(f"built {path}" if path else "build FAILED")
    sys.exit(0 if path else 1)
