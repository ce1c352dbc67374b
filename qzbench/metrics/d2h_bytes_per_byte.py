"""d2h_bytes_per_byte: bytes of the arrays shard.gather hands the host (the
candidate arrays, device to host), over the input bytes of the batches
assembled from them (a count, B/B)."""


def _nbytes(args, kwargs, result):
    return int(result.nbytes)


def _batch_bytes(args, kwargs, result):
    # _map_chunks(assemble, [(i, chunk), ...])
    return sum(len(c) for _, c in args[1])


SPANS = {
    "gather": ("qatzip_tpu_torch.parallel.shard:gather", _nbytes),
    "assemble": ("qatzip_tpu_torch.ops.device_codecs:_map_chunks",
                 _batch_bytes),
}


def read(run):
    got = sum(s.value for s in run.span_list("gather"))
    base = sum(s.value for s in run.span_list("assemble"))
    if not got or not base:
        return None
    return got / base
