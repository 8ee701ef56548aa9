"""Block metadata of a local BGZF file, by a header walk."""

from __future__ import annotations

from spark_bam_tpu_torch.bgzf.block import (
    FOOTER_SIZE,
    HEADER_SIZE,
    MAX_BLOCK_SIZE,
    BgzfError,
    Metadata,
    parse_header,
)
from spark_bam_tpu_torch.core.channel import open_channel


def blocks_metadata(path) -> list[Metadata]:
    """Every block's ``Metadata`` in file order, without inflating. The
    28-byte EOF sentinel (an empty payload) ends the walk and is not
    listed; a file that ends without one ends at its last whole block."""
    out: list[Metadata] = []
    with open_channel(path) as ch:
        pos = 0
        while pos + HEADER_SIZE <= ch.size:
            header_size, csize = parse_header(ch.read_at(pos, HEADER_SIZE))
            if pos + csize > ch.size:
                break
            footer = ch.read_at(pos + csize - 4, 4)
            usize = int.from_bytes(footer, "little")
            if usize > MAX_BLOCK_SIZE:
                raise BgzfError(
                    f"BGZF ISIZE {usize} at {pos} exceeds {MAX_BLOCK_SIZE}"
                )
            if csize - header_size - FOOTER_SIZE == 2:
                break
            out.append(Metadata(pos, csize, usize))
            pos += csize
    return out
