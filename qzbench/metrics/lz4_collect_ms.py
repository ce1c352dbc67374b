"""lz4_collect_ms: the program's own span ``lz4.collect``: the decoded
rows read back from the card and cut into each block's bytes, summed over
a request and averaged over the window's requests with an ``lz4.batch``
span (ms)."""
from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "lz4.collect",
                                        having="lz4.batch")
