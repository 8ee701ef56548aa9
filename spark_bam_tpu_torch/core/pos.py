"""Virtual positions in a BGZF file (reference ``spark_bam_tpu/core/
pos.py``): the compressed offset of a block's start and an offset into
that block's uncompressed payload, with HTSJDK's packed 64-bit form."""

from __future__ import annotations

from typing import NamedTuple


class Pos(NamedTuple):
    block_pos: int  # byte offset of the BGZF block start in the compressed file
    offset: int     # offset into the block's uncompressed payload (< 65536)

    def __str__(self) -> str:
        return f"{self.block_pos}:{self.offset}"

    def to_htsjdk(self) -> int:
        """Pack into the HTSJDK-style 64-bit virtual offset."""
        return (self.block_pos << 16) | self.offset

    @staticmethod
    def from_htsjdk(vpos: int) -> "Pos":
        return Pos(vpos >> 16, vpos & 0xFFFF)

    def distance(self, other: "Pos",
                 estimated_compression_ratio: float = 3.0) -> int:
        """Approximate compressed-byte distance ``self - other``: the
        in-block offsets scaled down by the estimated compression ratio
        (reference Pos.scala:17-22)."""
        return max(
            0,
            self.block_pos
            - other.block_pos
            + int((self.offset - other.offset) / estimated_compression_ratio),
        )
