"""host_assemble_ms: the mean wall of device_codecs._map_chunks, the host's
parse and emit of one batch of up to 128 chunks from its candidates (the
native deflate_candidates or lz4_candidates and the chunk checksum, on the
chunk pool), in ms."""


def _batch_bytes(args, kwargs, result):
    return sum(len(c) for _, c in args[1])


SPANS = {
    "assemble": ("qatzip_tpu_torch.ops.device_codecs:_map_chunks",
                 _batch_bytes),
}


def read(run):
    spans = run.span_list("assemble")
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
