"""lz4_device_ms: the program's own span ``lz4.device``: the LZ4 block
kernel's launch to the read-back of each row's size and error flag,
summed over a request and averaged over the window's requests with an
``lz4.batch`` span (ms)."""
from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "lz4.device",
                                        having="lz4.batch")
