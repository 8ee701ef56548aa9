"""Record indexer → ``.records`` sidecar, check-bam's ground truth
(reference ``spark_bam_tpu/bam/index_records.py``).

One line ``blockPos,offset`` per record start, found by walking the
records' length prefixes from the end of the header (reference
IndexRecords.scala:107-180; line format :149). A position at a block
boundary belongs to the block that starts there. Tolerant of truncated
files by default: a length prefix cut by EOF ends the walk with the
records seen (reference :160-174), unless ``strict``; a record whose body
EOF cuts is listed, as the reference's walk lists it.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bgzf.flat import (
    inflate_blocks,
    metas_block_table,
    pos_of_flat_tables,
)
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.guard import (
    LimitExceeded,
    StructurallyInvalid,
    current_limits,
)
from spark_bam_tpu_torch.core.pos import Pos

#: Smallest well-formed record body: 32 fixed field bytes + the name's NUL.
MIN_RECORD_BODY = 33
#: Blocks inflated at a time by the walk (about 16 MiB of records).
_WALK_BLOCKS = 256


def format_record_line(pos: Pos) -> str:
    return f"{pos.block_pos},{pos.offset}"


def parse_record_line(line: str) -> Pos:
    block, off = line.strip().split(",")
    return Pos(int(block), int(off))


def read_records_index(path) -> list[Pos]:
    with open(path) as f:
        return [parse_record_line(line) for line in f if line.strip()]


def read_records_table(path) -> tuple[np.ndarray, np.ndarray]:
    """``(block_pos, offset)`` int64 arrays of a ``.records`` sidecar: the
    same positions as ``read_records_index``, parsed in bulk."""
    with open(path) as f:
        text = f.read()
    vals = np.array(text.replace(",", " ").split(), dtype=np.int64)
    if len(vals) % 2:
        raise ValueError(f"{path}: a line without its offset")
    return vals[0::2], vals[1::2]


def _pos_at(metas, flat: int) -> Pos:
    return Pos(*pos_of_flat_tables(*metas_block_table(metas), flat))


def record_start_flats(bam_path, metas=None, strict: bool = False
                       ) -> np.ndarray:
    """Flat (uncompressed) offsets of every record start, by the
    length-prefix walk over host-inflated runs of blocks. A length prefix out
    of bounds raises the typed error the reference's record walk raises
    (``StructurallyInvalid`` below the fixed fields, ``LimitExceeded``
    past the decode limit), at the record's position."""
    metas = blocks_metadata(bam_path) if metas is None else metas
    lim = current_limits()
    total = sum(m.uncompressed_size for m in metas)
    at = read_header(bam_path).uncompressed_size   # the next record start
    starts: list[int] = []
    tail = b""          # the < 4 bytes of a prefix that a run boundary cut
    base = 0            # flat offset of the next run's first byte
    with open_channel(bam_path) as ch:
        for i in range(0, len(metas), _WALK_BLOCKS):
            run = metas[i: i + _WALK_BLOCKS]
            data = inflate_blocks(ch, run).data
            buf_base = base - len(tail)
            buf = tail + data.tobytes() if tail else data.tobytes()
            base += len(data)
            end = buf_base + len(buf)
            while at + 4 <= end:
                (size,) = struct.unpack_from("<i", buf, at - buf_base)
                if size < MIN_RECORD_BODY:
                    raise StructurallyInvalid(
                        f"BAM record block_size {size} smaller than its "
                        f"fixed fields", pos=_pos_at(metas, at))
                if size > lim.max_record_bytes:
                    raise LimitExceeded(
                        f"BAM record block_size {size} exceeds limit "
                        f"{lim.max_record_bytes}", pos=_pos_at(metas, at))
                starts.append(at)
                at += 4 + size
            tail = buf[at - buf_base:] if at < end else b""
    if at < total and strict:
        raise EOFError(f"truncated BAM: a length prefix at flat offset {at} "
                       f"runs past the end ({total})")
    return np.array(starts, dtype=np.int64)


def index_records(bam_path, out_path=None, strict: bool = False
                  ) -> tuple[str, int]:
    """Write the ``.records`` sidecar for ``bam_path``; returns (path,
    #records). The file is written beside its final name and renamed into
    place, so a crash never leaves a truncated sidecar."""
    out_path = (str(out_path) if out_path is not None
                else str(bam_path) + ".records")
    metas = blocks_metadata(bam_path)
    flats = record_start_flats(bam_path, metas, strict)
    block_starts, block_flat = metas_block_table(metas)
    idx = np.searchsorted(block_flat, flats, side="right") - 1
    blocks = block_starts[idx].tolist()
    offsets = (flats - block_flat[idx]).tolist()
    tmp_path = f"{out_path}.tmp{os.getpid()}"
    try:
        with open(tmp_path, "w") as out:
            out.writelines(f"{b},{o}\n" for b, o in zip(blocks, offsets))
        os.replace(tmp_path, out_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return out_path, len(flats)
