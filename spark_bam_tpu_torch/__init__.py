"""spark-bam on PyTorch and CUDA: the count-reads and full-check paths of
``spark_bam_tpu`` with their DEFLATE tokenizer, LZ77 resolve, funnel
prefilter and full flag pass as CUDA kernels written for Hopper
(``csrc/``).

The package imports torch, numpy and the standard library only; entry
points run on the CUDA device unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version instead.
"""

from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.tpu.checker import TpuChecker
from spark_bam_tpu_torch.tpu.stream_check import (
    StreamChecker,
    full_check_summary_streaming,
)

__all__ = ["Config", "StreamChecker", "TpuChecker",
           "full_check_summary_streaming"]
