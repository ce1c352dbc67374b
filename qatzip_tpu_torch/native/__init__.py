"""The port's native (C++) host codec: a copy of qatzip_tpu/native.

``qzcore.cpp``, ``qzdeflate.cpp`` and ``qzbatch.cpp`` are the reference's
sources as they are; ``qzregions.cpp`` (the lockstep inflate's table
regions, a round in one call), ``qzapply.cpp`` (the same round's tokens
applied to its streams, in one call) and ``qzrows.cpp`` (an LZ4 request's
block staging and chunk checksums, each in one call) are the port's own.
``build.py`` compiles them into ``build/qatzip_tpu_torch/libqzcore.so`` at
first use and ``qzcore.py`` binds, with ctypes, the entry points the port
calls.  Every caller keeps a pure-Python fallback for a missing library.
"""
