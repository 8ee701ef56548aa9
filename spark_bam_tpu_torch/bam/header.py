"""BAM header: magic, SAM text, contig dictionary (reference
bam/header/Header.scala). Only what the port's paths need is kept: the
contig names and lengths, the header's size in uncompressed bytes (the
flat offset of the first record), ``end_pos``, the first record's
virtual position, which owns the first split, and the SAM text, which the
write path copies."""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

from spark_bam_tpu_torch.bgzf.block import FOOTER_SIZE, HEADER_SIZE, parse_header
from spark_bam_tpu_torch.core.channel import FileChannel, open_channel
from spark_bam_tpu_torch.core.pos import Pos


class BamHeaderError(IOError):
    """Bytes that cannot be a BAM header."""


@dataclass(frozen=True)
class BamHeader:
    contig_names: tuple[str, ...]
    contig_lengths: np.ndarray  # int32, index order
    uncompressed_size: int      # uncompressed bytes the header occupies
    # Virtual position of the first record: the next non-empty block's
    # start when the header ends on a block's end; Pos(0, 0) for a BAM
    # with no records (the reference's convention).
    end_pos: Pos = Pos(0, 0)
    text: str = ""              # the SAM text, trailing NULs stripped


class _Inflated:
    """Uncompressed bytes of a BGZF file, inflated block by block on demand."""

    def __init__(self, ch):
        self.ch = ch
        self.pos = 0          # compressed offset of the next block
        self.buf = bytearray()
        self.off = 0          # read cursor into buf
        self.blocks = []      # (compressed start, buf offset) per block

    def _more(self) -> bool:
        if self.pos + HEADER_SIZE > self.ch.size:
            return False
        header_size, csize = parse_header(self.ch.read_at(self.pos, HEADER_SIZE))
        payload = self.ch.read_at(self.pos + header_size,
                                  csize - header_size - FOOTER_SIZE)
        self.blocks.append((self.pos, len(self.buf)))
        self.buf += zlib.decompress(bytes(payload), wbits=-15)
        self.pos += csize
        return True

    def cur_pos(self) -> Pos:
        """The cursor's virtual position, in the first block that holds
        the byte at the cursor; Pos(0, 0) when no byte follows it."""
        while self.off >= len(self.buf):
            if not self._more():
                return Pos(0, 0)
        for start, base in reversed(self.blocks):
            if base <= self.off:
                return Pos(start, self.off - base)
        raise AssertionError("cursor before the first block")

    def read(self, n: int) -> bytes:
        while len(self.buf) - self.off < n:
            if not self._more():
                raise BamHeaderError(
                    f"BAM header truncated: wanted {n} bytes at {self.off}"
                )
        out = bytes(self.buf[self.off: self.off + n])
        self.off += n
        return out

    def i32(self) -> int:
        return struct.unpack("<i", self.read(4))[0]


def read_header(path) -> BamHeader:
    """The header of the BAM at ``path`` (or on an open channel)."""
    if isinstance(path, FileChannel):
        return _parse(path, path.path)
    with open_channel(path) as ch:
        return _parse(ch, path)


def _parse(ch, path) -> BamHeader:
    u = _Inflated(ch)
    if u.read(4) != b"BAM\x01":
        raise BamHeaderError(f"{path}: not a BAM (bad magic)")
    text_len = u.i32()
    if text_len < 0:
        raise BamHeaderError(f"negative header text length {text_len}")
    text = u.read(text_len).decode("latin-1").rstrip("\x00")
    num_refs = u.i32()
    if num_refs < 0:
        raise BamHeaderError(f"negative reference count {num_refs}")
    names, lengths = [], []
    for _ in range(num_refs):
        name_len = u.i32()
        if name_len < 0:
            raise BamHeaderError(f"negative name length {name_len}")
        names.append(u.read(name_len).rstrip(b"\x00").decode("latin-1"))
        lengths.append(u.i32())
    return BamHeader(tuple(names), np.array(lengths, dtype=np.int32),
                     u.off, u.cur_pos(), text)
