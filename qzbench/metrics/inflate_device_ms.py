"""inflate_device_ms: the program's own span ``inflate.device``: each lockstep
round's upload, kernel launch and read-back, summed over a request and
averaged over the window's requests with an ``inflate.batch`` span (ms)."""
from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "inflate.device",
                                        having="inflate.batch")
