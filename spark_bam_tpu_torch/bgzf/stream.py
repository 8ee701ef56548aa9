"""Seekable BGZF byte streams over a local file (reference ``spark_bam_tpu/
bgzf/stream.py``), inflated block by block with host zlib: what the exact
decode of spilled records reads from.

- ``SeekableBlockStream``: the block at a compressed offset, and the ones
  after it, through an LRU cache of 100 inflated blocks (reference
  Stream.scala:83-92).
- ``SeekableUncompressedBytes``: the uncompressed bytes from a virtual
  position ``Pos(block, offset)`` on, across block boundaries.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict

from spark_bam_tpu_torch.bgzf.block import FOOTER_SIZE, HEADER_SIZE, BgzfError, parse_header
from spark_bam_tpu_torch.core.pos import Pos


class SeekableBlockStream:
    """Inflated blocks of a channel by compressed offset. ``next_block``
    returns ``(data, start)`` of the block at the cursor and moves past it,
    or None at the file's end or its empty EOF block."""

    MAX_CACHE_SIZE = 100

    def __init__(self, ch):
        self.ch = ch
        self.pos = 0
        self._cache: OrderedDict[int, tuple[bytes, int]] = OrderedDict()

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

    def close(self) -> None:
        self.ch.close()


class SeekableUncompressedBytes:
    """The uncompressed bytes of a block stream, addressable by virtual
    position; reads cross block boundaries and skip empty blocks."""

    def __init__(self, stream: SeekableBlockStream):
        self.stream = stream
        self._data = b""
        self._idx = 0
        self._linear = 0

    def seek(self, pos: Pos) -> None:
        self.stream.seek(pos.block_pos)
        blk = self.stream.next_block()
        self._data = blk[0] if blk is not None else b""
        self._idx = pos.offset
        self._linear = 0

    def tell(self) -> int:
        """Bytes read or skipped since the last ``seek``."""
        return self._linear

    def skip(self, n: int) -> int:
        """Move up to ``n`` bytes on without copying them; returns the
        bytes skipped (short at the end of file)."""
        skipped = 0
        while n > 0:
            if self._idx >= len(self._data):
                blk = self.stream.next_block()
                if blk is None:
                    break
                self._data, self._idx = blk[0], 0
                continue
            take = min(n, len(self._data) - self._idx)
            self._idx += take
            n -= take
            skipped += take
        self._linear += skipped
        return skipped

    def read(self, n: int) -> bytes:
        """Up to ``n`` bytes from the cursor (short at the end of file)."""
        out = bytearray()
        while n > 0:
            if self._idx >= len(self._data):
                blk = self.stream.next_block()
                if blk is None:
                    break
                self._data, self._idx = blk[0], 0
                continue
            take = min(n, len(self._data) - self._idx)
            out += self._data[self._idx: self._idx + take]
            self._idx += take
            n -= take
        self._linear += len(out)
        return bytes(out)

    def close(self) -> None:
        self.stream.close()
