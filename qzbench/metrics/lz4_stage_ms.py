"""lz4_stage_ms: the program's own span ``lz4.stage``: the compressed
blocks padded into the decoder's ``[B, n]`` array and copied to the card,
summed over a request and averaged over the window's requests with an
``lz4.batch`` span (ms)."""
from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "lz4.stage", having="lz4.batch")
