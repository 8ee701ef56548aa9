"""Virtual positions, the ``Config`` surface, byte ranges, channels, the
fault and decode-limit taxonomy (reference ``spark_bam_tpu/core/``)."""

from spark_bam_tpu_torch.core.config import Config, default_config
from spark_bam_tpu_torch.core.pos import Pos

__all__ = ["Pos", "Config", "default_config"]
