"""BGZF and BAM writing (reference ``spark_bam_tpu/bam/writer.py``): the
BGZF writer over a pluggable block codec, the BAM header and record
encoder, and ``write_bam_result``, which the rewrite command drives.

``BgzfWriter`` cuts the uncompressed stream into ``block_payload``-byte
payloads, hands them to its codec (``compress/codec.py``) ``codec.lanes``
at a time, and keeps at most two batches in flight: it dispatches batch N
before it frames and writes batch N - 1. It records one ``Metadata`` row
per member as it writes, so the sidecars of the output need no re-read.
"""

from __future__ import annotations

import struct
from collections import deque
from dataclasses import dataclass, field

from spark_bam_tpu_torch.bam.header import BamHeader
from spark_bam_tpu_torch.bam.record import BamRecord
from spark_bam_tpu_torch.bgzf.block import Metadata
from spark_bam_tpu_torch.compress.codec import HostZlibCodec, make_codec
from spark_bam_tpu_torch.compress.huffman import zlib_member
from spark_bam_tpu_torch.core.atomic import AtomicFile

#: The standard 28-byte BGZF EOF block.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
#: Uncompressed bytes a block: compressed members stay inside BSIZE's u16.
DEFAULT_BLOCK_PAYLOAD = 0xFF00


def compress_block(payload: bytes, level: int = 6) -> bytes:
    """One complete BGZF block by host zlib; stored where zlib's output
    would overflow BSIZE (``LimitExceeded`` only past what stored holds)."""
    return zlib_member(payload, level)


@dataclass
class WriteResult:
    """What ``write_bam_result`` learned while packing: enough to build
    the ``.blocks``, ``.records`` and ``.sbi`` sidecars in memory."""

    count: int = 0
    header_len: int = 0
    blocks: "list[Metadata]" = field(default_factory=list)
    #: Flat (uncompressed-stream) offset of each record start, in order.
    record_flats: "list[int]" = field(default_factory=list)
    bytes_out: int = 0


class BgzfWriter:
    """Buffers bytes and writes complete BGZF members to ``fobj``, ending
    with the EOF block on ``close``. ``blocks`` holds one ``Metadata`` per
    member in file order; ``flat_tell`` is the uncompressed offset of the
    next byte written."""

    def __init__(self, fobj, block_payload: int = DEFAULT_BLOCK_PAYLOAD,
                 level: int = 6, codec=None):
        self.f = fobj
        self.block_payload = block_payload
        self.level = level
        self.codec = codec if codec is not None else HostZlibCodec(level)
        self.buf = bytearray()
        self.blocks: "list[Metadata]" = []
        self._batch: "list[bytes]" = []
        self._pending: "deque[tuple[list[int], object]]" = deque()
        self._offset = 0
        self._flat = 0

    @property
    def flat_tell(self) -> int:
        return self._flat

    @property
    def bytes_out(self) -> int:
        """Compressed bytes written so far."""
        return self._offset

    def write(self, data: bytes) -> None:
        self._flat += len(data)
        self.buf += data
        while len(self.buf) >= self.block_payload:
            payload = bytes(self.buf[: self.block_payload])
            del self.buf[: self.block_payload]
            self._enqueue(payload)

    def _enqueue(self, payload: bytes) -> None:
        self._batch.append(payload)
        if len(self._batch) >= max(int(self.codec.lanes), 1):
            self._dispatch_batch()

    def _dispatch_batch(self) -> None:
        if not self._batch:
            return
        plens = [len(p) for p in self._batch]
        handle = self.codec.dispatch(self._batch)
        self._batch = []
        self._pending.append((plens, handle))
        while len(self._pending) > 1:
            self._write_oldest()

    def _write_oldest(self) -> None:
        plens, handle = self._pending.popleft()
        for n, member in zip(plens, self.codec.materialize(handle)):
            self.f.write(member)
            self.blocks.append(Metadata(self._offset, len(member), n))
            self._offset += len(member)

    def close(self) -> None:
        if self.buf:
            payload = bytes(self.buf)
            self.buf = bytearray()
            self._enqueue(payload)
        self._dispatch_batch()
        while self._pending:
            self._write_oldest()
        self.f.write(BGZF_EOF)
        self._offset += len(BGZF_EOF)
        self.f.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def encode_bam_header(header: BamHeader) -> bytes:
    """The uncompressed BAM header: magic, SAM text (newline-terminated
    when not empty), and the contig dictionary."""
    text = header.text.encode("latin-1")
    if text and not text.endswith(b"\n"):
        text += b"\n"
    out = bytearray(b"BAM\x01")
    out += struct.pack("<i", len(text))
    out += text
    out += struct.pack("<i", len(header.contig_names))
    for name, length in zip(header.contig_names, header.contig_lengths):
        name_b = name.encode("latin-1") + b"\x00"
        out += struct.pack("<i", len(name_b)) + name_b
        out += struct.pack("<i", int(length))
    return bytes(out)


def write_bam_result(path, header: BamHeader, records,
                     block_payload: int = DEFAULT_BLOCK_PAYLOAD,
                     level: int = 6, deflate=None, codec=None,
                     device=None) -> WriteResult:
    """Write a BAM of ``header`` and ``records`` (``BamRecord``s or
    ``(Pos, BamRecord)`` pairs) to ``path`` atomically, and return what
    the packing learned. ``deflate`` is a deflate spec or
    ``DeflateConfig`` (""/None/mode=off: host zlib at ``level``), its
    lanes on ``device``; ``codec`` takes a built codec instead. On any
    error, an ``OSError`` included, the temp file is removed and the
    error raised as it is."""
    if codec is None:
        codec = make_codec(deflate, level=level, device=device)
    result = WriteResult()
    out = AtomicFile(path)
    try:
        with BgzfWriter(out.f, block_payload, level, codec=codec) as w:
            w.write(encode_bam_header(header))
            result.header_len = w.flat_tell
            for rec in records:
                rec = rec[1] if isinstance(rec, tuple) else rec
                if not isinstance(rec, BamRecord):
                    raise TypeError(f"not a BamRecord: {type(rec).__name__}")
                result.record_flats.append(w.flat_tell)
                w.write(rec.encode())
                result.count += 1
        result.blocks = w.blocks
        result.bytes_out = w.bytes_out
        out.commit()
    except BaseException:
        out.abort()
        raise
    return result


def write_bam(path, header: BamHeader, records,
              block_payload: int = DEFAULT_BLOCK_PAYLOAD, level: int = 6,
              deflate=None, codec=None, device=None) -> int:
    """``write_bam_result``'s record count. Records are packed back to
    back into fixed-size payloads, so their starts are not block-aligned."""
    return write_bam_result(path, header, records, block_payload, level,
                            deflate, codec, device).count
