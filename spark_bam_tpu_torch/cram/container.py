"""CRAM 3.0 physical structure: file definition, blocks, containers.

File layout (CRAM 3.0 spec):

    file definition   "CRAM" major minor file-id[20]
    container*        header + blocks
    EOF container     fixed 38-byte sentinel

Container header: length (i32le, byte size of the blocks that follow),
ref seq id / start / span / n_records (itf8), record counter & bases
(ltf8), n_blocks (itf8), landmark array (itf8 count + offsets), crc32.

Block: method u8, content type u8, content id (itf8), compressed and raw
sizes (itf8), payload, crc32 over everything before the crc.
"""

from __future__ import annotations

import bz2
import lzma
import struct
import zlib
from dataclasses import dataclass, field

from spark_bam_tpu_torch.core.guard import (
    LimitExceeded,
    MalformedInputError,
    StructurallyInvalid,
    TruncatedInput,
    check_count,
    current_limits,
)
from spark_bam_tpu_torch.cram import rans
from spark_bam_tpu_torch.cram.nums import Cursor, i32le, itf8, ltf8, u32le

MAGIC = b"CRAM"
VERSION = (3, 0)

# Block compression methods.
RAW = 0
GZIP = 1
BZIP2 = 2
LZMA = 3
RANS4x8 = 4

# Block content types.
FILE_HEADER = 0
COMPRESSION_HEADER = 1
MAPPED_SLICE = 2
EXTERNAL = 4
CORE = 5

EOF_START = 4542278  # "EOF" packed big-endian — the sentinel's start field


def file_definition(file_id: bytes = b"") -> bytes:
    fid = (file_id or b"spark-bam-tpu")[:20].ljust(20, b"\x00")
    return MAGIC + bytes(VERSION) + fid


def parse_file_definition(buf: bytes) -> tuple[int, int]:
    if buf[:4] != MAGIC:
        raise StructurallyInvalid(f"Not a CRAM: bad magic {buf[:4]!r}")
    if len(buf) < 6:
        raise TruncatedInput(
            f"CRAM file definition cut short: {len(buf)} of 6 bytes"
        )
    return buf[4], buf[5]


@dataclass
class Block:
    content_type: int
    content_id: int
    data: bytes           # uncompressed payload
    method: int = RAW     # requested/observed wire compression

    def serialize(self, method: int | None = None) -> bytes:
        method = self.method if method is None else method
        if method == GZIP:
            comp = zlib.compress(self.data, 6)
        elif method == RANS4x8:
            comp = rans.compress(self.data, order=1 if len(self.data) >= 4 else 0)
        elif method == BZIP2:
            comp = bz2.compress(self.data)
        elif method == LZMA:
            comp = lzma.compress(self.data)
        else:
            method, comp = RAW, self.data
        if len(comp) >= len(self.data):
            method, comp = RAW, self.data  # never pay to compress
        head = (
            bytes([method, self.content_type])
            + itf8(self.content_id)
            + itf8(len(comp))
            + itf8(len(self.data))
            + comp
        )
        return head + u32le(zlib.crc32(head))

    @staticmethod
    def parse(cur: Cursor) -> "Block":
        start = cur.pos
        method = cur.u8()
        content_type = cur.u8()
        content_id = cur.itf8()
        # Both size fields come from untrusted bytes: validate before they
        # size a read (comp_size) or a decompression buffer (raw_size).
        lim = current_limits()
        comp_size = check_count(
            cur.itf8(), "CRAM block comp_size", pos=start
        )
        raw_size = check_count(
            cur.itf8(), "CRAM block raw_size", lim.alloc_budget, pos=start
        )
        comp = cur.read(comp_size)
        crc = cur.u32()
        actual = zlib.crc32(bytes(cur.buf[start: cur.pos - 4]))
        if crc != actual:
            raise StructurallyInvalid(
                f"block crc mismatch: stored {crc:#x}, computed {actual:#x}",
                pos=start,
            )
        data = _decompress(method, comp, raw_size, start)
        if len(data) != raw_size:
            raise StructurallyInvalid(
                f"block inflated to {len(data)} bytes, header said {raw_size}",
                pos=start,
            )
        return Block(content_type, content_id, data, method)


def _decompress(method: int, comp: bytes, raw_size: int, start: int) -> bytes:
    """Inflate one block payload, never producing more than ``raw_size + 1``
    bytes regardless of what the compressed stream claims (a zip-bomb
    payload fails the post-inflate size check without the allocation)."""
    try:
        if method == RAW:
            return comp
        if method == GZIP:
            return zlib.decompressobj(zlib.MAX_WBITS | 32).decompress(
                comp, raw_size + 1
            )
        if method == RANS4x8:
            return rans.decompress(comp, max_out=raw_size)
        if method == BZIP2:
            return bz2.BZ2Decompressor().decompress(comp, raw_size + 1)
        if method == LZMA:
            return lzma.LZMADecompressor().decompress(comp, raw_size + 1)
    except (zlib.error, OSError, lzma.LZMAError, ValueError, IndexError, EOFError) as e:
        if isinstance(e, MalformedInputError):
            raise  # already typed (rans guards, cursor truncation)
        raise StructurallyInvalid(
            f"block decompress (method {method}) failed: {e}", pos=start
        ) from e
    raise StructurallyInvalid(
        f"unknown block compression method {method}", pos=start
    )


def gzip_maybe(data: bytes) -> int:
    """Pick GZIP for payloads long enough to plausibly win."""
    return GZIP if len(data) >= 64 else RAW


@dataclass
class ContainerHeader:
    length: int                 # byte size of the container's blocks
    ref_seq_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    bases: int
    n_blocks: int
    landmarks: list[int] = field(default_factory=list)

    def serialize(self) -> bytes:
        body = (
            i32le(self.length)
            + itf8(self.ref_seq_id)
            + itf8(self.start)
            + itf8(self.span)
            + itf8(self.n_records)
            + ltf8(self.record_counter)
            + ltf8(self.bases)
            + itf8(self.n_blocks)
            + itf8(len(self.landmarks))
            + b"".join(itf8(x) for x in self.landmarks)
        )
        return body + u32le(zlib.crc32(body))

    @staticmethod
    def parse(cur: Cursor) -> "ContainerHeader":
        start = cur.pos
        length = cur.i32()
        ref_seq_id = cur.itf8()
        align_start = cur.itf8()
        span = cur.itf8()
        n_records = cur.itf8()
        record_counter = cur.ltf8()
        bases = cur.ltf8()
        n_blocks = cur.itf8()
        # Landmarks are ≥ 1 byte each: a count past the remaining bytes is
        # provably corrupt before the loop runs (2³¹ itf8 reads otherwise).
        n_landmarks = check_count(
            cur.itf8(), "CRAM landmark count", cur.remaining(), pos=start
        )
        landmarks = [cur.itf8() for _ in range(n_landmarks)]
        crc = cur.u32()
        actual = zlib.crc32(bytes(cur.buf[start: cur.pos - 4]))
        if crc != actual:
            raise StructurallyInvalid(
                f"container crc mismatch: stored {crc:#x}, computed {actual:#x}",
                pos=start,
            )
        return ContainerHeader(
            length, ref_seq_id, align_start, span, n_records,
            record_counter, bases, n_blocks, landmarks,
        )

    @property
    def is_eof(self) -> bool:
        return self.ref_seq_id == -1 and self.start == EOF_START and self.n_records == 0


def eof_container() -> bytes:
    """The 38-byte v3 EOF sentinel: an empty compression-header container
    with the magic (-1, "EOF") coordinates."""
    block = Block(COMPRESSION_HEADER, 0, b"\x01\x00\x01\x00\x01\x00").serialize(RAW)
    header = ContainerHeader(
        length=len(block),
        ref_seq_id=-1,
        start=EOF_START,
        span=0,
        n_records=0,
        record_counter=0,
        bases=0,
        n_blocks=1,
        landmarks=[],
    )
    return header.serialize() + block


def sam_header_container(sam_text: str, pad: int = 1024) -> bytes:
    """The leading container holding the SAM header text, padded so tools
    can rewrite headers in place (the usual writer convention)."""
    payload = sam_text.encode("latin-1")
    data = struct.pack("<i", len(payload)) + payload + b"\x00" * pad
    block = Block(FILE_HEADER, 0, data).serialize(gzip_maybe(data))
    header = ContainerHeader(
        length=len(block),
        ref_seq_id=0,
        start=0,
        span=0,
        n_records=0,
        record_counter=0,
        bases=0,
        n_blocks=1,
        landmarks=[0],
    )
    return header.serialize() + block
