"""The BGZF block layer (reference ``spark_bam_tpu/bgzf/``): block values
and header parsing, block and byte streams over a channel, the block-start
search, and the flat whole-file and windowed inflates the device paths
read (``flat.py``)."""

from spark_bam_tpu_torch.bgzf.block import (
    FOOTER_SIZE,
    MAX_BLOCK_SIZE,
    Block,
    Header,
    HeaderParseException,
    Metadata,
)
from spark_bam_tpu_torch.bgzf.find_block_start import (
    HeaderSearchFailedException,
    find_block_start,
)
from spark_bam_tpu_torch.bgzf.stream import (
    BlockStream,
    MetadataStream,
    SeekableBlockStream,
    SeekableUncompressedBytes,
    UncompressedBytes,
    pos_iterator,
)

__all__ = [
    "Header",
    "HeaderParseException",
    "HeaderSearchFailedException",
    "Block",
    "Metadata",
    "MAX_BLOCK_SIZE",
    "FOOTER_SIZE",
    "BlockStream",
    "SeekableBlockStream",
    "MetadataStream",
    "UncompressedBytes",
    "SeekableUncompressedBytes",
    "pos_iterator",
    "find_block_start",
]
