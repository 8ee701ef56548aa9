"""BGZF block values and header parsing (reference Block.scala,
Metadata.scala, Header.scala)."""

from __future__ import annotations

from dataclasses import dataclass

MAX_BLOCK_SIZE = 64 * 1024  # uncompressed payload never exceeds 64 KiB
FOOTER_SIZE = 8             # CRC32 + uncompressed size, both u32
HEADER_SIZE = 18            # fixed gzip header + the 6-byte "BC" subfield
# A member's raw-DEFLATE payload cannot exceed BSIZE's u16 ceiling minus the
# minimal wrapper; the staged tokenizer row width is sized against it.
MAX_COMPRESSED_PAYLOAD = (1 << 16) - HEADER_SIZE - FOOTER_SIZE


class BgzfError(IOError):
    """A BGZF header or footer that cannot describe a block."""


@dataclass(frozen=True)
class Metadata:
    """Block coordinates without the payload."""
    start: int             # compressed-file offset of the block start
    compressed_size: int
    uncompressed_size: int


def parse_header(buf) -> tuple[int, int]:
    """``(header_size, compressed_size)`` from ≥ 18 header bytes."""
    if len(buf) < HEADER_SIZE:
        raise EOFError(f"Expected {HEADER_SIZE} header bytes, got {len(buf)}")
    for idx, expected in ((0, 31), (1, 139), (2, 8), (3, 4)):
        if buf[idx] != expected:
            raise BgzfError(f"Position {idx}: {buf[idx]} != {expected}")
    xlen = buf[10] | (buf[11] << 8)
    if xlen < 6:
        raise BgzfError(f"BGZF XLEN {xlen} < 6: no BC subfield")
    for idx, expected in ((12, 66), (13, 67), (14, 2)):
        if buf[idx] != expected:
            raise BgzfError(f"Position {idx}: {buf[idx]} != {expected}")
    header_size = HEADER_SIZE + xlen - 6
    compressed_size = (buf[16] | (buf[17] << 8)) + 1
    if compressed_size < header_size + FOOTER_SIZE:
        raise BgzfError(
            f"BGZF BSIZE {compressed_size - 1} too small for its own header "
            f"({header_size} bytes) + footer"
        )
    return header_size, compressed_size
