"""The write path's compression (reference ``spark_bam_tpu/compress/``):
the ``Config.deflate`` spec (``config.py``), the literal-only
fixed-Huffman DEFLATE writer and the BGZF member functions that are the
byte authority for every encoder (``huffman.py``), the card's CRC-32 and
fixed-Huffman lanes (``kernels.py``, CUDA kernels in ``csrc/deflate.cu``),
and the block codecs and zlib-stream encoder built on them
(``codec.py``).
"""

from spark_bam_tpu_torch.compress.codec import encode_zlib_stream, make_codec
from spark_bam_tpu_torch.compress.config import DeflateConfig
from spark_bam_tpu_torch.compress.huffman import (
    MAX_STORED_PAYLOAD,
    fixed_pack,
    fixed_stream_bits,
    zlib_stream,
)

__all__ = ["DeflateConfig", "MAX_STORED_PAYLOAD", "encode_zlib_stream",
           "fixed_pack", "fixed_stream_bits", "make_codec", "zlib_stream"]
