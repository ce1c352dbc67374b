"""pool_wait_ms.decompress: the program's own ``pool.grab`` spans, the
wait for a device instance slot, summed over a decompress request and
averaged over the window's requests (ms)."""
from qzbench import program_spans


def read(run):
    if run.direction != "decompress":
        return None
    return program_spans.per_request_ms(run, "pool.grab")
