"""request_p95_ms.compress: the 95th percentile (nearest rank) of the
client's clock around qz_compress, over every request of the window (ms)."""
from qzbench import stats


def read(run):
    if run.direction != "compress" or not run.requests:
        return None
    return 1e3 * stats.p95([r.seconds for r in run.requests])
