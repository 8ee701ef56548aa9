"""Block partition planning: BGZF blocks into partitions of about a split
size (reference ``spark_bam_tpu/check/blocks.py``, Blocks.scala:22-214).
Two paths:

- **Indexed** (``.blocks`` sidecar exists): parse block metadata, filter by
  byte ranges, prefix-sum compressed sizes, assign each block to partition
  ``cum_offset // split_size`` (ref :70-140).
- **Search**: split the file into ``split_size`` byte ranges; per range, find
  the first block boundary then stream metadata while inside the range
  (ref :141-207). Ranges are resolved in parallel on the host.

Default split size 2 MB (ref :64).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from spark_bam_tpu_torch.bgzf.block import Metadata
from spark_bam_tpu_torch.bgzf.find_block_start import find_block_start
from spark_bam_tpu_torch.bgzf.index_blocks import read_blocks_index
from spark_bam_tpu_torch.bgzf.stream import MetadataStream
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.ranges import RangeSet
from spark_bam_tpu_torch.parallel.executor import ParallelConfig, map_partitions


@dataclass
class Blocks:
    """Partitioned block metadata + per-partition byte bounds."""

    partitions: list[list[Metadata]]
    bounds: list[tuple[int, int]]

    @property
    def num_blocks(self) -> int:
        return sum(len(p) for p in self.partitions)

    def all_blocks(self) -> list[Metadata]:
        return [m for p in self.partitions for m in p]


def plan_blocks(
    path,
    config: Config = Config(),
    ranges: RangeSet | None = None,
    blocks_path=None,
    parallel: ParallelConfig = ParallelConfig(),
) -> Blocks:
    split_size = config.split_size_or(Config.CHECK_SPLIT_SIZE_DEFAULT)
    blocks_path = str(blocks_path) if blocks_path else str(path) + ".blocks"

    if os.path.exists(blocks_path):
        metas = [
            m
            for m in read_blocks_index(blocks_path)
            if ranges is None or m.start in ranges
        ]
        # Exclusive prefix sum of compressed sizes over the *filtered* blocks
        # (the reference scans after filtering, Blocks.scala:89-107).
        partitions: dict[int, list[Metadata]] = {}
        offset = 0
        last_partition = -1
        for m in metas:
            last_partition = offset // split_size
            partitions.setdefault(last_partition, []).append(m)
            offset += m.compressed_size
        # Partition count runs through the *last block's* partition (pinned
        # by the reference's BlocksTest boundaries golden: trailing empties
        # beyond it are not materialized).
        num_partitions = last_partition + 1
        return Blocks(
            partitions=[partitions.get(i, []) for i in range(num_partitions)],
            bounds=[
                (i * split_size, (i + 1) * split_size) for i in range(num_partitions)
            ],
        )

    size = os.path.getsize(path)
    num_splits = math.ceil(size / split_size)
    split_idxs = [
        i
        for i in range(num_splits)
        if ranges is None or ranges.overlaps(i * split_size, (i + 1) * split_size)
    ]

    def resolve(idx: int) -> list[Metadata]:
        start, end = idx * split_size, (idx + 1) * split_size
        with open_channel(path) as ch:
            block_start = find_block_start(
                ch, start, config.bgzf_blocks_to_check, path=str(path)
            )
            out = []
            for m in MetadataStream(ch, block_start):
                if m.start >= end:
                    break
                if ranges is None or m.start in ranges:
                    out.append(m)
            return out

    partitions = map_partitions(resolve, split_idxs, parallel)
    return Blocks(
        partitions=partitions,
        bounds=[(i * split_size, (i + 1) * split_size) for i in split_idxs],
    )


def align_indexed_records(
    blocks: Blocks, records_path, strict: bool = True
) -> "list[np.ndarray]":
    """Partition-align the ``.records`` ground truth with a block plan.

    The reference pairs its blocks RDD with the sorted record-position RDD
    partition-by-partition so each task scores its own blocks against its
    own slice of the truth (IndexedRecordPositions.scala:57-117 ``toSets`` +
    BlocksAndIndexedRecords.scala:134-180). Here the sidecar positions
    bucket by their block's partition with one global sort; the returned
    list matches ``blocks.partitions`` index-for-index, each entry a sorted
    ``(n, 2)`` int64 array of (block_pos, offset) rows.

    ``strict`` (default): a truth position whose block is absent from the
    plan raises — a stale sidecar or planner hole must not silently shrink
    the ground truth. Pass ``strict=False`` when the plan was legitimately
    filtered with ``ranges``.
    """
    from spark_bam_tpu_torch.bam.index_records import read_records_index

    pos = np.array(
        [(p.block_pos, p.offset) for p in read_records_index(records_path)],
        dtype=np.int64,
    ).reshape(-1, 2)

    starts = []
    part_of_block = []
    for i, part in enumerate(blocks.partitions):
        for m in part:
            starts.append(m.start)
            part_of_block.append(i)
    starts = np.array(starts, dtype=np.int64)
    part_of_block = np.array(part_of_block, dtype=np.int64)
    order = np.argsort(starts)
    starts, part_of_block = starts[order], part_of_block[order]

    n_parts = len(blocks.partitions)
    out: list[np.ndarray] = [
        np.empty((0, 2), dtype=np.int64) for _ in range(n_parts)
    ]
    if not len(pos) or not len(starts):
        if strict and len(pos):
            raise ValueError(
                f"{len(pos)} .records positions reference blocks missing "
                "from the plan (stale sidecar?)"
            )
        return out
    idx = np.searchsorted(starts, pos[:, 0])
    known = (idx < len(starts)) & (
        starts[np.clip(idx, 0, len(starts) - 1)] == pos[:, 0]
    )
    if strict and not known.all():
        bad = pos[~known][:5, 0].tolist()
        raise ValueError(
            f"{int((~known).sum())} .records positions reference blocks "
            f"missing from the plan (first: {bad}; stale sidecar?)"
        )
    pos, idx = pos[known], idx[known]
    parts = part_of_block[idx]
    # One global (partition, block, offset) sort, then split — O(N log N).
    order = np.lexsort((pos[:, 1], pos[:, 0], parts))
    pos, parts = pos[order], parts[order]
    cuts = np.searchsorted(parts, np.arange(1, n_parts))
    for i, rows in enumerate(np.split(pos, cuts)):
        out[i] = rows
    return out
