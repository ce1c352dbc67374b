"""inflate_batch_ms: the mean wall of deflate_decode.inflate_batch, one
call a request's batch of up to 512 streams: the header parse, the table
regions, every lockstep round and its apply (ms)."""

SPANS = {"inflate_batch": "qatzip_tpu_torch.ops.deflate_decode:inflate_batch"}


def read(run):
    spans = run.span_list("inflate_batch")
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
