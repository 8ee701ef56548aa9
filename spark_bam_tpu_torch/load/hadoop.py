"""hadoop-bam's split computation (reference ``spark_bam_tpu/load/
hadoop.py::hadoop_bam_splits``): one seqdoop guess per raw split boundary,
sequentially on the host, so the guesser's false positives surface as
bad split starts (reference LoadReads.scala:176-207)."""

from __future__ import annotations

from spark_bam_tpu_torch.bgzf.find_block_start import find_block_start
from spark_bam_tpu_torch.check.seqdoop import SeqdoopChecker
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.load.splits import Split


def hadoop_bam_splits(path, split_size: int,
                      config: Config = Config()) -> list[Split]:
    """hadoop-bam's splits: each raw boundary's first block, then the
    seqdoop guesser's next read start; ends are ``(raw end, 0xffff)``."""
    checker = SeqdoopChecker.open(path)
    splits: list[Split] = []
    with open_channel(path) as ch:
        size = ch.size
        for s in range(0, size, split_size):
            e = min(s + split_size, size)
            block = find_block_start(ch, s, config.bgzf_blocks_to_check,
                                     path=str(path))
            start = checker.next_read_start(Pos(block, 0),
                                            config.max_read_size)
            if start is None or start.block_pos >= e:
                continue
            splits.append(Split(start, Pos(e, 0xFFFF)))
    return splits
