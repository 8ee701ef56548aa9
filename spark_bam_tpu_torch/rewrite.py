"""The rewrite transform (reference ``spark_bam_tpu/cli/rewrite.py``, the
htsjdk-rewrite analog): every record of a BAM decoded and written again
through the port's BGZF writer, so record starts stop being
block-aligned. ``block_payload`` re-blocks, ``deflate`` picks the block
codec (host zlib, or stored / fixed-Huffman members from the card's
lanes), the output lands atomically, and ``index`` writes the ``.blocks``,
``.records`` and ``.sbi`` sidecars from the packing metadata, with no
re-read: the ``.sbi`` holds the blocks, the record starts and the split
plan of the config's load split size, so a warm load of the output
resolves no boundary.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from spark_bam_tpu_torch.bam.index_records import format_record_line
from spark_bam_tpu_torch.bam.iterators import RecordStream
from spark_bam_tpu_torch.bam.writer import (
    DEFAULT_BLOCK_PAYLOAD,
    WriteResult,
    write_bam_result,
)
from spark_bam_tpu_torch.bgzf.index_blocks import format_block_line
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.load.splits import file_splits
from spark_bam_tpu_torch.sbi.format import (
    PLAN_NONE,
    PLAN_POS,
    PlanEntry,
    SbiIndex,
    fingerprint_of,
)
from spark_bam_tpu_torch.sbi.store import CacheStore


@dataclass
class RewriteResult:
    count: int = 0
    bytes_out: int = 0
    n_blocks: int = 0
    #: sidecar kind ("blocks", "records", "sbi") → the path written
    sidecars: "dict[str, str]" = field(default_factory=dict)


def _flat_to_pos(blocks, flats: "list[int]") -> "list[Pos]":
    """Flat uncompressed offsets → virtual positions, from the writer's
    own block table."""
    starts = np.array([m.start for m in blocks], dtype=np.int64)
    flat0 = np.cumsum([0] + [m.uncompressed_size for m in blocks])[:-1]
    f = np.asarray(flats, dtype=np.int64)
    idx = np.searchsorted(flat0, f, side="right") - 1
    return [Pos(int(b), int(o))
            for b, o in zip(starts[idx], f - flat0[idx])]


def _synth_split_plan(blocks, positions: "list[Pos]", splits):
    """The split plan that live resolution gives, from the write-time
    block table and record starts: the first block boundary at or after
    the split's start, then the first record start at or after that
    block; a split holding the first record resolves to it."""
    block_starts = np.asarray([m.start for m in blocks], dtype=np.int64)
    # A record at (block, offset) is at or after Pos(b, 0) iff block >= b.
    rec_blocks = np.asarray([p.block_pos for p in positions], dtype=np.int64)
    entries = []
    first = positions[0] if positions else None
    for split in splits:
        if first is not None and split.start <= first.block_pos < split.end:
            entries.append(PlanEntry(split.start, PLAN_POS, first))
            continue
        i = int(np.searchsorted(block_starts, split.start, side="left"))
        if i >= len(block_starts) or block_starts[i] >= split.end:
            entries.append(PlanEntry(split.start, PLAN_NONE, None))
            continue
        j = int(np.searchsorted(rec_blocks, block_starts[i], side="left"))
        if j >= len(positions):
            entries.append(PlanEntry(split.start, PLAN_NONE, None))
        else:
            entries.append(PlanEntry(split.start, PLAN_POS, positions[j]))
    return entries


def _atomic_text(path: str, lines) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            for line in lines:
                f.write(line + "\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # the failure path only
            os.unlink(tmp)


def emit_sidecars(out_path, result: WriteResult, config: Config
                  ) -> "dict[str, str]":
    """The ``.blocks``, ``.records`` and ``.sbi`` of a BAM just written,
    all from its ``WriteResult``. The ``.sbi`` goes where the cache store
    puts it (beside the BAM, or under ``SPARK_BAM_CACHE_DIR``)."""
    out_path = str(out_path)
    positions = _flat_to_pos(result.blocks, result.record_flats)
    written: dict[str, str] = {}
    blocks_path = out_path + ".blocks"
    _atomic_text(blocks_path, (format_block_line(m) for m in result.blocks))
    written["blocks"] = blocks_path
    records_path = out_path + ".records"
    _atomic_text(records_path, (format_record_line(p) for p in positions))
    written["records"] = records_path

    size = config.split_size_or(Config.LOAD_SPLIT_SIZE_DEFAULT)
    virtual = np.array([(p.block_pos << 16) | p.offset for p in positions],
                       dtype=np.uint64)
    index = SbiIndex(
        fingerprint_of(out_path, config),
        blocks=list(result.blocks),
        split_plans={size: _synth_split_plan(
            result.blocks, positions, file_splits(out_path, size))},
        record_starts=virtual,
    )
    sbi_path = CacheStore.from_env().store(out_path, index)
    if sbi_path:
        written["sbi"] = sbi_path
    return written


def rewrite_bam(in_path, out_path, block_payload: int = DEFAULT_BLOCK_PAYLOAD,
                level: int = 6, deflate: "str | None" = None,
                index: bool = False, config: Config = Config(),
                device=None) -> RewriteResult:
    """Stream the records of ``in_path`` into ``out_path`` (atomic),
    re-blocked at ``block_payload`` and compressed by the ``deflate`` spec
    (``None``: ``config.deflate``), its lanes on ``device``; with
    ``index``, the sidecars from the packing metadata."""
    spec = deflate if deflate is not None else config.deflate
    with open_channel(in_path) as ch:
        stream = RecordStream.open(ch)
        result = write_bam_result(
            out_path, stream.header, stream, block_payload=block_payload,
            level=level, deflate=spec, device=device,
        )
    out = RewriteResult(count=result.count, bytes_out=result.bytes_out,
                        n_blocks=len(result.blocks))
    if index:
        out.sidecars = emit_sidecars(out_path, result, config)
    return out
