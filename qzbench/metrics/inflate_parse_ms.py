"""inflate_parse_ms: the program's own span ``inflate.parse``: the header parse
of each round, every stream of the batch up to its next Huffman block,
summed over a request and averaged over the window's requests with an
``inflate.batch`` span (ms)."""
from qzbench import program_spans


def read(run):
    return program_spans.per_request_ms(run, "inflate.parse",
                                        having="inflate.batch")
