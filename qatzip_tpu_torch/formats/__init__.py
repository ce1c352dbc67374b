"""Wire-format framing of the port: gzip, gzipext, 4B, raw, zlib, LZ4 frame,
LZ4s blocks.  Copies of qatzip_tpu/formats' modules (pure host-side byte
twiddling, reference src/qatzip_gzip.c, src/qatzip_lz4.c,
src/qatzip_utils.c:888-1345).
"""
