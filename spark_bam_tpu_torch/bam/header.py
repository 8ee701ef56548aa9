"""BAM header: magic, SAM text, contig dictionary (reference
bam/header/Header.scala). Only what the count path needs is kept: the
contig lengths and the header's size in uncompressed bytes, which is the
flat offset of the first record."""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

from spark_bam_tpu_torch.bgzf.block import FOOTER_SIZE, HEADER_SIZE, parse_header
from spark_bam_tpu_torch.core.channel import open_channel


class BamHeaderError(IOError):
    """Bytes that cannot be a BAM header."""


@dataclass(frozen=True)
class BamHeader:
    contig_names: tuple[str, ...]
    contig_lengths: np.ndarray  # int32, index order
    uncompressed_size: int      # uncompressed bytes the header occupies


class _Inflated:
    """Uncompressed bytes of a BGZF file, inflated block by block on demand."""

    def __init__(self, ch):
        self.ch = ch
        self.pos = 0          # compressed offset of the next block
        self.buf = bytearray()
        self.off = 0          # read cursor into buf

    def _more(self) -> bool:
        if self.pos + HEADER_SIZE > self.ch.size:
            return False
        header_size, csize = parse_header(self.ch.read_at(self.pos, HEADER_SIZE))
        payload = self.ch.read_at(self.pos + header_size,
                                  csize - header_size - FOOTER_SIZE)
        self.buf += zlib.decompress(bytes(payload), wbits=-15)
        self.pos += csize
        return True

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
    with open_channel(path) as ch:
        u = _Inflated(ch)
        if u.read(4) != b"BAM\x01":
            raise BamHeaderError(f"{path}: not a BAM (bad magic)")
        text_len = u.i32()
        if text_len < 0:
            raise BamHeaderError(f"negative header text length {text_len}")
        u.read(text_len)
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
        return BamHeader(tuple(names), np.array(lengths, dtype=np.int32), u.off)
