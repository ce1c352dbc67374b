"""The port's native (C++) host codec: a copy of qatzip_tpu/native.

``qzcore.cpp``, ``qzdeflate.cpp`` and ``qzbatch.cpp`` are the reference's
sources as they are; ``build.py`` compiles them into
``build/qatzip_tpu_torch/libqzcore.so`` at first use and ``qzcore.py``
binds, with ctypes, the entry points the port calls.  Every caller keeps
the reference's pure-Python fallback for a missing library.
"""
