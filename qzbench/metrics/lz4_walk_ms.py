"""lz4_walk_ms: the program's own spans ``lz4.walk``: the frame walk of an
LZ4 request (``core``'s member walk with each frame's footer search) and
the block-header walk of its ``lz4.batch``, summed over a request and
averaged over the window's requests with an ``lz4.batch`` span (ms)."""
from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "lz4.walk", having="lz4.batch")
