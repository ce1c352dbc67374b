"""compress_gbps: uncompressed bytes of every request of the window over
the window's seconds (GB/s, 10^9 bytes a second)."""
from qzbench import stats


def read(run):
    if run.direction != "compress" or not run.requests:
        return None
    return stats.rate_gbps(run.raw_bytes, run.window_s)
