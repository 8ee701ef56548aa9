"""spark-bam on PyTorch and CUDA: the count-reads path of ``spark_bam_tpu``
with its DEFLATE tokenizer, LZ77 resolve and funnel prefilter as CUDA
kernels written for Hopper (``csrc/``).

The package imports torch, numpy and the standard library only; entry
points run on the CUDA device unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version instead.
"""

from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.tpu.stream_check import CountEscaped, StreamChecker

__all__ = ["Config", "CountEscaped", "StreamChecker"]
