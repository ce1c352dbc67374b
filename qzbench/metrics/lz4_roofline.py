"""lz4_roofline: the share of the LZ4 kernel's device time (the device work
launched inside lz4_kernel.decode) that moving the window's compressed
bytes in and decompressed bytes out once at the card's peak memory rate
would take (%)."""
from qzbench import stats

SPANS = {"lz4_kernel": "qatzip_tpu_torch.ops.lz4_kernel:decode"}


def read(run):
    peak = run.peaks.get("hbm_bytes_per_s")
    dev = run.device_s("lz4_kernel")
    if run.direction != "decompress" or not peak or dev is None:
        return None
    return stats.roofline_pct(run.raw_bytes + run.wire_bytes, peak, dev)
