"""The device engine (reference ``spark_bam_tpu/tpu/``, on CUDA here):

- ``checker``  — the funnel checker over one device window (``check_window``,
  ``count_window``), the resident chunk counter and ``count_repeat``;
- ``kernels``  — the wrappers of the hand-written CUDA kernels (``csrc/``)
  and their plain PyTorch versions;
- ``inflate``  — host staging and the device inflate (tokenize, LZ77);
- ``parser``   — record fields parsed on the device window;
- ``stream_check`` — the streaming checker over a whole file.
"""

from spark_bam_tpu_torch.tpu.checker import TpuChecker, check_window

__all__ = ["TpuChecker", "check_window"]
