"""BGZF block streams and uncompressed-byte views over a local file
(reference ``spark_bam_tpu/bgzf/stream.py``), inflated block by block with
host zlib: what the write path's record stream and the exact decode of
spilled records read from.

- ``BlockStream``: the inflated blocks in file order, each checked against
  its ISIZE and CRC-32 (strict: a damaged block raises);
- ``SeekableBlockStream``: the same from any compressed offset, through an
  LRU cache of 100 inflated blocks (reference Stream.scala:83-92);
- ``UncompressedBytes``: the uncompressed bytes across block boundaries,
  with the virtual position of the next byte (``cur_pos``);
- ``SeekableUncompressedBytes``: the same from a virtual position
  ``Pos(block, offset)`` on.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict

from spark_bam_tpu_torch.bgzf.block import FOOTER_SIZE, HEADER_SIZE, BgzfError, parse_header
from spark_bam_tpu_torch.core.pos import Pos


class BlockStream:
    """Inflated blocks of a channel from a compressed offset on.
    ``next_block`` returns ``(data, start)`` of the block at the cursor and
    moves past it, or None at the file's end or its empty EOF block."""

    def __init__(self, ch):
        self.ch = ch
        self.pos = 0

    def _read_block(self, start: int) -> tuple[bytes, int] | None:
        """``(data, compressed_size)`` of the block at ``start``; None at the
        end of the file or at the 28-byte EOF block."""
        if start + HEADER_SIZE > self.ch.size:
            return None
        header_size, csize = parse_header(self.ch.read_at(start, HEADER_SIZE))
        block = self.ch.read_at(start, csize)
        if len(block) != csize:
            raise EOFError(f"BGZF block at {start} is cut short")
        payload = block[header_size: csize - FOOTER_SIZE]
        if len(payload) == 2:
            return None
        crc = int.from_bytes(block[csize - 8: csize - 4], "little")
        isize = int.from_bytes(block[csize - 4:], "little")
        data = zlib.decompress(bytes(payload), wbits=-15,
                               bufsize=max(isize, 1))
        if len(data) != isize:
            raise BgzfError(f"BGZF block at {start}: expected {isize} "
                            f"decompressed bytes, found {len(data)}")
        if zlib.crc32(data) & 0xFFFFFFFF != crc:
            raise BgzfError(f"BGZF block at {start}: CRC32 mismatch")
        return data, csize

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

    def __init__(self, ch):
        super().__init__(ch)
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


class UncompressedBytes:
    """The uncompressed bytes of a block stream, read across block
    boundaries (empty blocks skipped). ``tell`` counts the bytes read or
    skipped since construction (or the last seek)."""

    def __init__(self, stream: BlockStream):
        self.stream = stream
        self._data = b""
        self._start = stream.pos
        self._idx = 0
        self._linear = 0

    def _advance(self) -> bool:
        blk = self.stream.next_block()
        if blk is None:
            return False
        self._data, self._start = blk
        self._idx = 0
        return True

    def cur_pos(self) -> Pos | None:
        """The virtual position of the next byte; None at the end."""
        while self._idx >= len(self._data):
            if not self._advance():
                return None
        return Pos(self._start, self._idx)

    def tell(self) -> int:
        return self._linear

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

    def close(self) -> None:
        self.stream.close()


class SeekableUncompressedBytes(UncompressedBytes):
    """``UncompressedBytes`` addressable by virtual position."""

    def seek(self, pos: Pos) -> None:
        self.stream.seek(pos.block_pos)
        blk = self.stream.next_block()
        self._data, self._start = blk if blk is not None else (b"", pos.block_pos)
        self._idx = pos.offset
        self._linear = 0
