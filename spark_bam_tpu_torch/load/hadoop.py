"""hadoop-bam's loading (reference ``spark_bam_tpu/load/hadoop.py``;
LoadReads.scala:176-207): its split computation and its strict record
reader, what ``count-reads``, ``time-load`` and ``compare-splits``
compare spark-bam against.

- ``hadoop_bam_splits``: one seqdoop guess per raw split boundary,
  sequentially on the host, so the guesser's false positives surface as
  bad split starts; ends are ``(raw end, 0xffff)``;
- ``hadoop_bam_read_split``: the records of one such split, decoded from
  a flat view with HTSJDK-style validation, so a bad start fails as it
  does under hadoop-bam (``BamFormatError``);
- ``hadoop_bam_count``: the records of every split.
"""

from __future__ import annotations

from spark_bam_tpu_torch.bam.record import BamRecord
from spark_bam_tpu_torch.bgzf.find_block_start import find_block_start
from spark_bam_tpu_torch.check.seqdoop import SeqdoopChecker
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.load.splits import Split


class BamFormatError(Exception):
    pass


def hadoop_bam_splits(path, split_size: int,
                      checker: SeqdoopChecker | None = None,
                      config: Config = Config()) -> list[Split]:
    """hadoop-bam's splits: each raw boundary's first block, then the
    seqdoop guesser's next read start."""
    checker = checker or SeqdoopChecker.open(path)
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


def validate_record(rec: BamRecord, num_contigs: int, index: int) -> None:
    """A few of HTSJDK's SAMRecord validations: enough that a garbage
    split start fails as it does under hadoop-bam."""
    def err(msg: str) -> BamFormatError:
        return BamFormatError(
            f"SAM validation error: ERROR: Record {index}, Read name "
            f"{rec.read_name}, {msg}")

    if not rec.flag & 0x1:
        if rec.next_ref_id != -1:
            raise err("MRNM should not be set for unpaired read.")
        if rec.flag & 0x40 or rec.flag & 0x80:
            raise err("First/second of pair flag should not be set for "
                      "unpaired read.")
    if rec.ref_id < -1 or rec.ref_id >= num_contigs:
        raise err("Reference index out of range.")
    if rec.next_ref_id < -1 or rec.next_ref_id >= num_contigs:
        raise err("Mate reference index out of range.")


def hadoop_bam_read_split(view, num_contigs: int, split: Split,
                          strict: bool = True):
    """``(Pos, BamRecord)`` of one hadoop-style split, decoded from a flat
    view of the file."""
    flat = view.flat_of_pos(split.start.block_pos, split.start.offset)
    n = view.size
    index = 0
    while flat + 4 <= n:
        block, off = view.pos_of_flat(flat)
        if (block, off) >= (split.end.block_pos, split.end.offset):
            break
        index += 1
        try:
            rec, consumed = BamRecord.decode(view.data, flat)
        except Exception as e:
            raise BamFormatError(
                f"Failed to decode record {index} at {block}:{off}: {e}")
        if strict:
            validate_record(rec, num_contigs, index)
        yield Pos(block, off), rec
        flat += consumed


def hadoop_bam_count(path, split_size: int, config: Config = Config()) -> int:
    checker = SeqdoopChecker.open(path)
    total = 0
    for split in hadoop_bam_splits(path, split_size, checker, config):
        for _ in hadoop_bam_read_split(checker.view, checker.num_contigs,
                                       split):
            total += 1
    return total
