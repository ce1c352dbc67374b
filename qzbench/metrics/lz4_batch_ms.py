"""lz4_batch_ms: the mean wall of lz4_decode.decode_blocks, one call a
request's compressed blocks: staging, the launch and the read-back (ms)."""

SPANS = {"lz4_batch": "qatzip_tpu_torch.ops.lz4_decode:decode_blocks"}


def read(run):
    spans = run.span_list("lz4_batch")
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
