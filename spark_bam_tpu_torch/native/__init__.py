"""Host C++ of the port, built with g++ on first use (``build.py``)."""

from spark_bam_tpu_torch.native.build import load_native

__all__ = ["load_native"]
