"""The port's native (C++) host codec: a copy of qatzip_tpu/native.

``qzcore.cpp``, ``qzdeflate.cpp`` and ``qzbatch.cpp`` are the reference's
sources as they are; ``qzheaders.cpp`` (the lockstep inflate's block
headers, a round's streams in one call), ``qzregions.cpp`` (the same
round's table regions, in one call), ``qzapply.cpp`` (its tokens applied
to its streams, in one call) and ``qzrows.cpp`` (an LZ4 request's block
staging and chunk checksums, each in one call) are the port's own.
``build.py`` compiles every ``*.cpp`` here into
``build/qatzip_tpu_torch/libqzcore.so`` at first use and ``qzcore.py``
binds, with ctypes, the entry points the port calls.

The device path requires the library, as it requires the kernels
(ops/_build.py): each module under ``ops/`` that calls it imports
``qzcore`` at its top, with no fallback route, and a host where g++
cannot build it gets g++'s message in an ImportError when the device
codecs register.  Only the copies of the reference's CPU route
(engine/core.py, engine/cpu_backend.py, utils/checksum.py) keep the
reference's optional import.
"""
