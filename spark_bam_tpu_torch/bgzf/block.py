"""BGZF block values and header parsing (reference Block.scala,
Metadata.scala, Header.scala)."""

from __future__ import annotations

from dataclasses import dataclass, field

from spark_bam_tpu_torch.core.guard import StructurallyInvalid
from spark_bam_tpu_torch.core.pos import Pos

MAX_BLOCK_SIZE = 64 * 1024  # uncompressed payload never exceeds 64 KiB
FOOTER_SIZE = 8             # CRC32 + uncompressed size, both u32
HEADER_SIZE = 18            # fixed gzip header + the 6-byte "BC" subfield
# A member's raw-DEFLATE payload cannot exceed BSIZE's u16 ceiling minus the
# minimal wrapper; the staged tokenizer row width is sized against it.
MAX_COMPRESSED_PAYLOAD = (1 << 16) - HEADER_SIZE - FOOTER_SIZE


class BgzfError(IOError):
    """A BGZF footer or block run that cannot describe a block."""


class HeaderParseException(StructurallyInvalid):
    """A fixed BGZF header byte does not match (the reference's
    ``Position %d: %d != %d``, HeaderParseException.scala:5-11)."""

    def __init__(self, idx: int, actual: int, expected: int):
        super().__init__(f"Position {idx}: {actual} != {expected}")
        self.idx = idx
        self.actual = actual
        self.expected = expected


def check_isize(uncompressed_size: int, start: int) -> int:
    """A block footer's ISIZE, checked before anything is sized by it."""
    if uncompressed_size > MAX_BLOCK_SIZE:
        raise StructurallyInvalid(
            f"BGZF ISIZE {uncompressed_size} exceeds the "
            f"{MAX_BLOCK_SIZE}-byte block limit", pos=start)
    return uncompressed_size


@dataclass(frozen=True)
class Metadata:
    """Block coordinates without the payload."""
    start: int             # compressed-file offset of the block start
    compressed_size: int
    uncompressed_size: int


@dataclass
class Block:
    """An inflated block's payload and coordinates, with a read cursor
    ``idx`` (what ``BlockStream`` iteration yields)."""
    data: bytes
    start: int
    compressed_size: int
    idx: int = field(default=0, compare=False)

    @property
    def uncompressed_size(self) -> int:
        return len(self.data)

    @property
    def pos(self) -> Pos:
        return Pos(self.start, self.idx)

    @property
    def next_start(self) -> int:
        return self.start + self.compressed_size

    def metadata(self) -> Metadata:
        return Metadata(self.start, self.compressed_size,
                        self.uncompressed_size)


@dataclass(frozen=True)
class Header:
    """A block's header size (18 + the extra subfields' bytes) and whole
    compressed size (reference Header.scala:14-88)."""
    size: int
    compressed_size: int

    @staticmethod
    def parse(buf) -> "Header":
        """From ≥ 18 bytes; raises as ``parse_header`` does."""
        return Header(*parse_header(buf))

    @staticmethod
    def read(ch) -> "Header":
        """From a channel at a block start, consuming the header."""
        header = Header.parse(ch.read_fully(HEADER_SIZE))
        ch.skip(header.size - HEADER_SIZE)
        return header


def parse_header(buf) -> tuple[int, int]:
    """``(header_size, compressed_size)`` from ≥ 18 header bytes. A bad
    magic byte raises ``HeaderParseException``, an XLEN or BSIZE that
    cannot hold the block ``StructurallyInvalid`` (both
    ``MalformedInputError``s, as the reference's), too few bytes
    ``EOFError``."""
    if len(buf) < HEADER_SIZE:
        raise EOFError(f"Expected {HEADER_SIZE} header bytes, got {len(buf)}")
    for idx, expected in ((0, 31), (1, 139), (2, 8), (3, 4)):
        if buf[idx] != expected:
            raise HeaderParseException(idx, buf[idx], expected)
    xlen = buf[10] | (buf[11] << 8)
    if xlen < 6:
        raise StructurallyInvalid(f"BGZF XLEN {xlen} < 6: no BC subfield")
    for idx, expected in ((12, 66), (13, 67), (14, 2)):
        if buf[idx] != expected:
            raise HeaderParseException(idx, buf[idx], expected)
    header_size = HEADER_SIZE + xlen - 6
    compressed_size = (buf[16] | (buf[17] << 8)) + 1
    if compressed_size < header_size + FOOTER_SIZE:
        raise StructurallyInvalid(
            f"BGZF BSIZE {compressed_size - 1} too small for its own header "
            f"({header_size} bytes) + footer"
        )
    return header_size, compressed_size
