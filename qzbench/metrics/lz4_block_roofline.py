"""lz4_block_roofline: the share of the LZ4 block kernel's device time (the
device work launched inside lz4_kernel.decode) that moving the work it is
given once at the card's peak memory rate would take (%): the compressed
blocks' bytes in and their decoded bytes out.  Stored blocks never reach
the kernel, so they are not counted.

The bytes come from the cell's own input, the LZ4 frames the benchmark
made and handed to ``qz_decompress`` (the span ``lz4_request`` keeps each
request's input): each frame's block headers say which blocks are stored,
and its content size, less its stored bytes, is what its compressed
blocks decode to.  The count is the same work whatever decodes it."""
import struct

from qzbench import stats

MAGIC = 0x184D2204
STORED = 0x80000000


def _src(args, kwargs, result):
    return kwargs.get("src", args[1] if len(args) > 1 else None)


SPANS = {"lz4_kernel": "qatzip_tpu_torch.ops.lz4_kernel:decode",
         "lz4_request": ("qatzip_tpu_torch:qz_decompress", _src)}


def kernel_bytes(stream) -> int | None:
    """Bytes in and out of the compressed blocks of the LZ4 frames in
    ``stream``; None where a frame is not one the count can read (no
    content size beside a compressed block, or not an LZ4 frame)."""
    buf = memoryview(stream)
    n = len(buf)
    pos = total = 0
    while pos + 7 <= n:
        magic, flg = struct.unpack_from("<IB", buf, pos)
        if magic != MAGIC:
            return None
        has_size, has_dict = flg >> 3 & 1, flg & 1
        size = (struct.unpack_from("<Q", buf, pos + 6)[0] if has_size
                else None)
        pos += 4 + 2 + 8 * has_size + 4 * has_dict + 1
        packed = stored = 0
        while pos + 4 <= n:
            (word,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            if word == 0:
                break
            ln = word & ~STORED
            if word & STORED:
                stored += ln
            else:
                packed += ln
            pos += ln + 4 * (flg >> 4 & 1)      # the block checksum
        pos += 4 * (flg >> 2 & 1)               # the content checksum
        if packed:
            if size is None:
                return None
            total += packed + size - stored
    return total if pos == n else None


def read(run):
    peak = run.peaks.get("hbm_bytes_per_s")
    dev = run.device_s("lz4_kernel")
    if run.direction != "decompress" or not peak or dev is None:
        return None
    by_input: dict = {}
    moved = 0
    for span in run.span_list("lz4_request"):
        key = id(span.value)
        if key not in by_input:
            by_input[key] = (kernel_bytes(span.value)
                             if span.value is not None else None)
        if by_input[key] is None:
            return None
        moved += by_input[key]
    return stats.roofline_pct(moved, peak, dev) if moved else None
