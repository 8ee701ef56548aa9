"""BAM structure (reference ``spark_bam_tpu/bam/``): the header and its
contig dictionary, the record codec (BAM and SAM text), the ``.bai``
index, the record and position streams, the writer and the
``.records`` index."""

from spark_bam_tpu_torch.bam.bai import BaiIndex, build_bai, index_bam
from spark_bam_tpu_torch.bam.header import BamHeader, ContigLengths, read_header
from spark_bam_tpu_torch.bam.iterators import (
    PosStream,
    RecordStream,
    SeekablePosStream,
    SeekableRecordStream,
)
from spark_bam_tpu_torch.bam.record import BamRecord

__all__ = [
    "BaiIndex",
    "build_bai",
    "index_bam",
    "BamHeader",
    "ContigLengths",
    "read_header",
    "BamRecord",
    "PosStream",
    "RecordStream",
    "SeekablePosStream",
    "SeekableRecordStream",
]
