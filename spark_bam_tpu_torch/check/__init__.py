"""Record-boundary checkers (reference ``spark_bam_tpu/check/``): the
flag taxonomy, the ``Checker`` plugin registry (eager, full, indexed,
seqdoop) over a BAM's streams, and the host engine ``vectorized.py``."""

from spark_bam_tpu_torch.check.checker import (
    ALLOWED_NAME_CHAR_MAX,
    ALLOWED_NAME_CHAR_MIN,
    EXCLUDED_NAME_CHAR,
    FIXED_FIELDS_SIZE,
    MAX_CIGAR_OP,
    make_checker,
)
from spark_bam_tpu_torch.check.eager import EagerChecker
from spark_bam_tpu_torch.check.flags import FLAG_NAMES, Flags, Success
from spark_bam_tpu_torch.check.full import FullChecker
from spark_bam_tpu_torch.check.indexed import IndexedChecker

__all__ = [
    "Flags",
    "Success",
    "FLAG_NAMES",
    "FIXED_FIELDS_SIZE",
    "MAX_CIGAR_OP",
    "ALLOWED_NAME_CHAR_MIN",
    "ALLOWED_NAME_CHAR_MAX",
    "EXCLUDED_NAME_CHAR",
    "EagerChecker",
    "FullChecker",
    "IndexedChecker",
    "make_checker",
]
