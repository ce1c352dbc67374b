"""inflate_tables_ms: the program's own span ``inflate.tables``:
``pack_round``, the table regions built for each round's dynamic blocks and
the lanes packed, summed over a request and averaged over the window's
requests with an ``inflate.batch`` span (ms)."""
from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "inflate.tables",
                                        having="inflate.batch")
