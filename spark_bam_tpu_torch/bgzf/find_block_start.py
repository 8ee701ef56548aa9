"""BGZF block-boundary search from an arbitrary compressed offset
(reference ``spark_bam_tpu/bgzf/find_block_start.py``), host code.

The first offset ≥ ``start`` where ``bgzf_blocks_to_check`` consecutive
block headers parse wins (reference FindBlockStart.scala:8-36). One NumPy
mask of the 7 fixed header bytes over the ≤ 64 KiB scan window picks the
offsets that could parse; only those run the sequential chain check, so
the result equals the per-offset scan's.
"""

from __future__ import annotations

import numpy as np

from spark_bam_tpu_torch.bgzf.block import HEADER_SIZE, MAX_BLOCK_SIZE, BgzfError, parse_header


class HeaderSearchFailedException(Exception):
    """No valid BGZF block start within a full block size of scanning."""

    def __init__(self, path, start: int, positions_attempted: int):
        super().__init__(
            f"Failed to find BGZF block boundary in {path} starting from "
            f"{start} ({positions_attempted} positions attempted)"
        )
        self.path = path
        self.start = start
        self.positions_attempted = positions_attempted


def _check_chain(ch, pos: int, n: int) -> None:
    """Parse up to ``n`` consecutive headers from ``pos``; EOF after the
    first is fine (the reference's ``MetadataStream.take(n)``). Raises
    ``BgzfError`` or ``EOFError`` when ``pos`` is no block start."""
    for i in range(n):
        head = ch.read_at(pos, HEADER_SIZE)
        if len(head) < HEADER_SIZE:
            if i == 0:
                raise EOFError(f"Expected {HEADER_SIZE} header bytes, got "
                               f"{len(head)}")
            return
        _, csize = parse_header(head)
        pos += csize


def find_block_start(ch, start: int, bgzf_blocks_to_check: int = 5,
                     path: str = "<channel>") -> int:
    """First valid block-start offset ≥ ``start`` of channel ``ch``."""
    size = ch.size
    remaining = max(size - start, 0)
    window = np.frombuffer(
        ch.read_at(start, min(min(MAX_BLOCK_SIZE, remaining) + 17, remaining)),
        dtype=np.uint8)
    m = len(window) - 17
    if m > 0:
        w = window
        ok = ((w[0:m] == 31) & (w[1:m + 1] == 139) & (w[2:m + 2] == 8)
              & (w[3:m + 3] == 4) & (w[12:m + 12] == 66)
              & (w[13:m + 13] == 67) & (w[14:m + 14] == 2))
        for off in np.flatnonzero(ok).tolist():
            try:
                _check_chain(ch, start + off, bgzf_blocks_to_check)
                return start + off
            except (BgzfError, EOFError):
                continue
    raise HeaderSearchFailedException(path, start,
                                      min(MAX_BLOCK_SIZE, size - start))
