"""CRAM 3.0: containers, slices and blocks, ITF8/LTF8, the block codecs
(EXTERNAL, HUFFMAN, BETA, GAMMA, BYTE_ARRAY_*), rANS 4x8 (decoded by the
native ``native/rans.cpp``), the reference-based and reference-less record
decode, the reference-less writer and the ``.crai`` (reference
``spark_bam_tpu/cram/``, which builds in what the original delegates to
hadoop-bam's ``CRAMInputFormat``, CanLoadBam.scala:348-382). Records come
out as the port's ``BamRecord``s, decoded on the host.

Containers are self-delimiting, so ``load_cram`` partitions a file by
container byte ranges the way BGZF blocks partition a BAM.
"""

from spark_bam_tpu_torch.cram.reader import CramReader, load_cram_header
from spark_bam_tpu_torch.cram.writer import CramWriter
