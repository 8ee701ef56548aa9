"""The write path's host half (reference ``spark_bam_tpu/compress/``):
the ``Config.deflate`` spec (``config.py``), the literal-only
fixed-Huffman DEFLATE writer that is the byte authority for every
encoder (``huffman.py``), and the zlib-stream encoder behind the
columnar container's ``codec=deflate`` buffers (``codec.py``).

The device lanes and the BGZF member writer come with the write path's
own slice; until then a spec that enables the device raises rather than
quietly taking the host path.
"""

from spark_bam_tpu_torch.compress.codec import encode_zlib_stream
from spark_bam_tpu_torch.compress.config import DeflateConfig
from spark_bam_tpu_torch.compress.huffman import (
    MAX_STORED_PAYLOAD,
    fixed_pack,
    fixed_stream_bits,
    zlib_stream,
)

__all__ = ["DeflateConfig", "MAX_STORED_PAYLOAD", "encode_zlib_stream",
           "fixed_pack", "fixed_stream_bits", "zlib_stream"]
