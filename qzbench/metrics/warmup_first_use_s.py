"""warmup_first_use_s: the program's own first-use set-up phases, the
kernel library's build-or-load (``setup.kernels``) and each kernel's first
launch (``setup.first_launch``), summed; a part of warmup_s (s).  Zero on
a device where no kernel of the program runs."""
from qzbench import program_spans


def read(run):
    return program_spans.setup_s({"setup.kernels", "setup.first_launch"})
