"""decompress_gbps: uncompressed bytes every request of the window put out,
over the window's seconds (GB/s, 10^9 bytes a second)."""
from qzbench import stats


def read(run):
    if run.direction != "decompress" or not run.requests:
        return None
    return stats.rate_gbps(run.raw_bytes, run.window_s)
