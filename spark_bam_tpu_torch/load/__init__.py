"""The user-facing load API (reference ``spark_bam_tpu/load/``): BAM, SAM
and CRAM loaders over split planning, the device load path
(``tpu_load.py``), the split-boundary resolver and the ``Dataset`` they
return."""

from spark_bam_tpu_torch.load.api import (
    load_bam,
    load_bam_intervals,
    load_reads,
    load_reads_and_positions,
    load_sam,
    load_splits_and_reads,
)
from spark_bam_tpu_torch.load.dataset import Dataset
from spark_bam_tpu_torch.load.splits import Split

__all__ = [
    "load_bam",
    "load_bam_intervals",
    "load_reads",
    "load_reads_and_positions",
    "load_sam",
    "load_splits_and_reads",
    "Split",
    "Dataset",
]
