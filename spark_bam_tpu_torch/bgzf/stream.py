"""BGZF block streams and uncompressed-byte views over a local file
(reference ``spark_bam_tpu/bgzf/stream.py``), inflated block by block with
host zlib: what the record path, the write path's record stream, the
host checkers and the exact decode of spilled records read from.

- ``inflate_block_payload`` / ``read_block``: one block, checked against
  its ISIZE and CRC-32 (a damaged block raises ``BlockCorruptionError``);
- ``BlockStream``: the inflated blocks in file order. Strict (the default)
  raises on a damaged block; ``tolerant=True`` quarantines it instead:
  the stream resyncs to the next sound block header, records the gap in
  ``quarantined`` and raises one ``BlockGapError`` (the caller may go on
  reading: the stream already stands at the resync point);
- ``SeekableBlockStream``: the same from any compressed offset, through an
  LRU cache of 100 inflated blocks (reference Stream.scala:83-92);
- ``MetadataStream``: block coordinates without inflating;
  ``pos_iterator``: every candidate position of a block;
- ``UncompressedBytes``: the uncompressed bytes across block boundaries,
  with the virtual position of the next byte (``cur_pos``);
- ``SeekableUncompressedBytes``: the same from a virtual position
  ``Pos(block, offset)`` on.

A block cut short by the end of the file ends the stream in either mode,
as the reference's does: the bytes that would complete it never existed.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Iterator

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.bgzf.block import (
    FOOTER_SIZE,
    HEADER_SIZE,
    BgzfError,
    Metadata,
    parse_header,
)
from spark_bam_tpu_torch.core import guard
from spark_bam_tpu_torch.core.faults import BlockCorruptionError, BlockGapError
from spark_bam_tpu_torch.core.guard import MalformedInputError
from spark_bam_tpu_torch.core.pos import Pos


def inflate_block_payload(comp, uncompressed_size: int) -> bytes:
    """Raw-DEFLATE inflate of one block payload (reference
    Stream.scala:49-54); a payload that does not inflate to exactly
    ``uncompressed_size`` bytes raises ``BlockCorruptionError``."""
    try:
        data = zlib.decompress(bytes(comp), wbits=-15,
                               bufsize=max(uncompressed_size, 1))
    except zlib.error as e:
        raise BlockCorruptionError(f"BGZF payload inflate failed: {e}") from e
    if len(data) != uncompressed_size:
        raise BlockCorruptionError(
            f"Expected {uncompressed_size} decompressed bytes, found "
            f"{len(data)}")
    return data


def read_block(ch, start: int) -> tuple[bytes, int] | None:
    """``(data, compressed_size)`` of the block at ``start``; None at the
    end of the file or at the 28-byte EOF block. A header that cannot
    describe a block raises ``BgzfError``, a damaged payload
    ``BlockCorruptionError``; a block cut short by the end of the file
    reads as the end."""
    if start + HEADER_SIZE > ch.size:
        return None
    header_size, csize = parse_header(ch.read_at(start, HEADER_SIZE))
    block = ch.read_at(start, csize)
    if len(block) != csize:
        return None
    payload = block[header_size: csize - FOOTER_SIZE]
    if len(payload) == 2:
        return None
    crc = int.from_bytes(block[csize - 8: csize - 4], "little")
    isize = int.from_bytes(block[csize - 4:], "little")
    data = inflate_block_payload(payload, isize)
    if zlib.crc32(data) & 0xFFFFFFFF != crc:
        raise BlockCorruptionError(
            f"BGZF block at {start}: CRC32 mismatch (stored {crc:#010x}, "
            f"computed {zlib.crc32(data) & 0xFFFFFFFF:#010x})")
    return data, csize


class BlockStream:
    """Inflated blocks of a channel from a compressed offset on.
    ``next_block`` returns ``(data, start)`` of the block at the cursor and
    moves past it, or None at the file's end or its empty EOF block."""

    def __init__(self, ch, tolerant: bool = False):
        self.ch = ch
        self.pos = 0
        self.tolerant = tolerant
        self.quarantined: list[BlockGapError] = []

    def _read_block(self, start: int) -> tuple[bytes, int] | None:
        if not self.tolerant:
            return read_block(self.ch, start)
        try:
            return read_block(self.ch, start)
        except (BlockCorruptionError, BgzfError, MalformedInputError) as e:
            self._resync(start, e)

    def _resync(self, damaged_start: int, err: Exception) -> None:
        """Quarantine the damaged block: move the cursor to the next sound
        block header (or the end of the file) and raise ``BlockGapError``
        describing the gap."""
        from spark_bam_tpu_torch.bgzf.find_block_start import (
            HeaderSearchFailedException,
            find_block_start,
        )

        try:
            resync = find_block_start(self.ch, damaged_start + 1)
        except (HeaderSearchFailedException, EOFError):
            resync = None
        self.pos = resync if resync is not None else self.ch.size
        gap = BlockGapError(damaged_start, resync,
                            f"{type(err).__name__}: {err}")
        self.quarantined.append(gap)
        obs.count("faults.quarantined_blocks")
        guard.note_quarantined_block()
        raise gap from err

    def seek(self, block_pos: int) -> None:
        self.pos = block_pos

    def next_block(self) -> tuple[bytes, int] | None:
        start = self.pos
        hit = self._read_block(start)
        if hit is None:
            return None
        data, csize = hit
        self.pos = start + csize
        return data, start

    def close(self) -> None:
        self.ch.close()


class SeekableBlockStream(BlockStream):
    """``BlockStream`` with an LRU cache of inflated blocks, for readers
    that seek back and forth."""

    MAX_CACHE_SIZE = 100

    def __init__(self, ch, tolerant: bool = False):
        super().__init__(ch, tolerant=tolerant)
        self._cache: OrderedDict[int, tuple[bytes, int]] = OrderedDict()

    def next_block(self) -> tuple[bytes, int] | None:
        start = self.pos
        hit = self._cache.get(start)
        if hit is None:
            hit = self._read_block(start)
            if hit is None:
                return None
            self._cache[start] = hit
            if len(self._cache) > self.MAX_CACHE_SIZE:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(start)
        data, csize = hit
        self.pos = start + csize
        return data, start


class MetadataStream:
    """Block coordinates from a compressed offset on, without inflating
    (reference MetadataStream.scala); stops at the EOF block or the end
    of the file."""

    def __init__(self, ch, start: int = 0):
        self.ch = ch
        self.start = start

    def __iter__(self) -> Iterator[Metadata]:
        pos = self.start
        while pos + HEADER_SIZE <= self.ch.size:
            header_size, csize = parse_header(
                self.ch.read_at(pos, HEADER_SIZE))
            footer = self.ch.read_at(pos + csize - 4, 4)
            if len(footer) != 4:
                raise EOFError(f"BGZF block at {pos} is cut short")
            if csize - header_size - FOOTER_SIZE == 2:
                return   # the EOF block
            obs.count("bgzf.blocks_scanned")
            yield Metadata(pos, csize, int.from_bytes(footer, "little"))
            pos += csize

    def close(self) -> None:
        self.ch.close()


def pos_iterator(meta: Metadata) -> Iterator[Pos]:
    """Every candidate virtual position of a block (reference
    PosIterator.scala)."""
    for offset in range(meta.uncompressed_size):
        yield Pos(meta.start, offset)


class UncompressedBytes:
    """The uncompressed bytes of a block stream, read across block
    boundaries (empty blocks skipped). ``tell`` counts the bytes read or
    skipped since construction (or the last seek)."""

    def __init__(self, stream: BlockStream):
        self.stream = stream
        self._data = b""
        self._start = stream.pos
        self._next_start = stream.pos
        self._idx = 0
        self._linear = 0

    def _advance(self) -> bool:
        blk = self.stream.next_block()
        if blk is None:
            return False
        self._data, self._start = blk
        self._next_start = self.stream.pos
        self._idx = 0
        return True

    def cur_pos(self) -> Pos | None:
        """The virtual position of the next byte; None at the end."""
        while self._idx >= len(self._data):
            if not self._advance():
                return None
        return Pos(self._start, self._idx)

    def tell_after(self) -> Pos | None:
        """Where the cursor stands as htslib's ``bgzf_tell`` reports it,
        without reading on: a block read to its end gives the next
        block's start with offset 0. None before any block was read."""
        if not self._data:
            return None
        if self._idx >= len(self._data):
            return Pos(self._next_start, 0)
        return Pos(self._start, self._idx)

    def tell(self) -> int:
        return self._linear

    def has_next(self) -> bool:
        return self.cur_pos() is not None

    def skip(self, n: int) -> int:
        """Move up to ``n`` bytes on without copying them; returns the
        bytes skipped (short at the end of file)."""
        skipped = 0
        while n > 0:
            if self._idx >= len(self._data):
                if not self._advance():
                    break
                continue
            take = min(n, len(self._data) - self._idx)
            self._idx += take
            n -= take
            skipped += take
        self._linear += skipped
        return skipped

    def read(self, n: int) -> bytes:
        """Up to ``n`` bytes from the cursor (short at the end of file)."""
        idx = self._idx
        if idx + n <= len(self._data):   # inside the current block
            self._idx = idx + n
            self._linear += n
            return self._data[idx: idx + n]
        out = bytearray()
        while n > 0:
            if self._idx >= len(self._data):
                if not self._advance():
                    break
                continue
            take = min(n, len(self._data) - self._idx)
            out += self._data[self._idx: self._idx + take]
            self._idx += take
            n -= take
        self._linear += len(out)
        return bytes(out)

    def read_fully(self, n: int) -> bytes:
        data = self.read(n)
        if len(data) != n:
            raise EOFError(f"wanted {n} bytes, got {len(data)}")
        return data

    def read_i32(self) -> int:
        return int.from_bytes(self.read_fully(4), "little", signed=True)

    def next_byte(self) -> int:
        if self.cur_pos() is None:
            raise EOFError("at end of stream")
        b = self._data[self._idx]
        self._idx += 1
        self._linear += 1
        return b

    def close(self) -> None:
        self.stream.close()


class SeekableUncompressedBytes(UncompressedBytes):
    """``UncompressedBytes`` addressable by virtual position."""

    @staticmethod
    def open(ch, tolerant: bool = False) -> "SeekableUncompressedBytes":
        return SeekableUncompressedBytes(
            SeekableBlockStream(ch, tolerant=tolerant))

    def seek(self, pos: Pos) -> None:
        self.stream.seek(pos.block_pos)
        blk = self.stream.next_block()
        self._data, self._start = blk if blk is not None else (b"", pos.block_pos)
        self._next_start = self.stream.pos
        self._idx = pos.offset
        self._linear = 0
