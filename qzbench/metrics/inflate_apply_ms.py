"""inflate_apply_ms: the program's own span ``inflate.apply``: each round's
native token apply and push into the streams' output, summed over a request
and averaged over the window's requests with an ``inflate.batch`` span (ms)."""
from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "inflate.apply",
                                        having="inflate.batch")
