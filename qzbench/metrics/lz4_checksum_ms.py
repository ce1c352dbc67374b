"""lz4_checksum_ms: the program's own spans ``lz4.checksum``: each chunk's
XXH32 in the ``lz4.batch`` and the whole output's XXH32 after it, summed
over a request and averaged over the window's requests with an
``lz4.batch`` span (ms)."""
from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "lz4.checksum",
                                        having="lz4.batch")
