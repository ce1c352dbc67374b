"""compress_ratio: uncompressed bytes over compressed bytes, the framing
included, over every request of the window."""


def read(run):
    if run.direction != "compress" or not run.wire_bytes:
        return None
    return run.raw_bytes / run.wire_bytes
