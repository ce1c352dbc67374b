"""init_engine_s: the program's own ``setup.engine`` phase, the engine's
bring-up in ``qz_init`` (the device's discovery); a part of init_s (s)."""
from qzbench import program_spans


def read(run):
    return program_spans.setup_s({"setup.engine"}) or None
