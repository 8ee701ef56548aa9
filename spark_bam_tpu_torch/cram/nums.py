"""CRAM integer primitives: ITF8 / LTF8 varints and little-endian helpers.

ITF8 encodes an int32 in 1-5 bytes with a UTF8-like length prefix in the
first byte; LTF8 extends the scheme to int64 in 1-9 bytes. Negative values
occupy the maximal form (their unsigned two's-complement pattern).
"""

from __future__ import annotations

import struct

from spark_bam_tpu_torch.core.guard import StructurallyInvalid, TruncatedInput


class Cursor:
    """A positioned view over bytes; every CRAM structure parses off one.

    Truncation raises ``TruncatedInput`` (an ``EOFError`` subclass, so
    legacy ``except EOFError`` handlers keep working); a negative read
    size — always a corrupt length field — raises ``StructurallyInvalid``.
    """

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def u8(self) -> int:
        try:
            v = self.buf[self.pos]
        except IndexError:
            raise TruncatedInput(f"truncated stream at byte {self.pos}") from None
        self.pos += 1
        return v

    def peek_u8(self) -> int:
        """Next byte without advancing; clean TruncatedInput when truncated."""
        try:
            return self.buf[self.pos]
        except IndexError:
            raise TruncatedInput(f"truncated stream at byte {self.pos}") from None

    def read(self, n: int) -> bytes:
        if n < 0:
            raise StructurallyInvalid(
                f"negative read of {n} bytes", pos=self.pos
            )
        v = bytes(self.buf[self.pos: self.pos + n])
        if len(v) != n:
            raise TruncatedInput(
                f"wanted {n} bytes at {self.pos}, got {len(v)}"
            )
        self.pos += n
        return v

    def i32(self) -> int:
        try:
            v = struct.unpack_from("<i", self.buf, self.pos)[0]
        except struct.error:
            raise TruncatedInput(f"truncated stream at byte {self.pos}") from None
        self.pos += 4
        return v

    def u32(self) -> int:
        try:
            v = struct.unpack_from("<I", self.buf, self.pos)[0]
        except struct.error:
            raise TruncatedInput(f"truncated stream at byte {self.pos}") from None
        self.pos += 4
        return v

    def itf8(self) -> int:
        b0 = self.u8()
        if b0 < 0x80:
            u = b0
        elif b0 < 0xC0:
            u = ((b0 << 8) | self.u8()) & 0x3FFF
        elif b0 < 0xE0:
            u = ((b0 << 16) | (self.u8() << 8) | self.u8()) & 0x1FFFFF
        elif b0 < 0xF0:
            u = (
                (b0 << 24) | (self.u8() << 16) | (self.u8() << 8) | self.u8()
            ) & 0x0FFFFFFF
        else:
            u = (
                ((b0 & 0x0F) << 28)
                | (self.u8() << 20)
                | (self.u8() << 12)
                | (self.u8() << 4)
                | (self.u8() & 0x0F)
            )
        return u - (1 << 32) if u >= 1 << 31 else u

    def ltf8(self) -> int:
        b0 = self.u8()
        if b0 < 0x80:
            return b0
        if b0 < 0xC0:
            u = ((b0 & 0x3F) << 8) | self.u8()
        elif b0 < 0xE0:
            u = ((b0 & 0x1F) << 16) | int.from_bytes(self.read(2), "big")
        elif b0 < 0xF0:
            u = ((b0 & 0x0F) << 24) | int.from_bytes(self.read(3), "big")
        elif b0 < 0xF8:
            u = ((b0 & 0x07) << 32) | int.from_bytes(self.read(4), "big")
        elif b0 < 0xFC:
            u = ((b0 & 0x03) << 40) | int.from_bytes(self.read(5), "big")
        elif b0 < 0xFE:
            u = ((b0 & 0x01) << 48) | int.from_bytes(self.read(6), "big")
        elif b0 < 0xFF:
            u = int.from_bytes(self.read(7), "big")
        else:
            u = int.from_bytes(self.read(8), "big")
        return u - (1 << 64) if u >= 1 << 63 else u

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)


def itf8(v: int) -> bytes:
    u = v & 0xFFFFFFFF
    if u < 0x80:
        return bytes([u])
    if u < 0x4000:
        return bytes([0x80 | (u >> 8), u & 0xFF])
    if u < 0x200000:
        return bytes([0xC0 | (u >> 16), (u >> 8) & 0xFF, u & 0xFF])
    if u < 0x10000000:
        return bytes(
            [0xE0 | (u >> 24), (u >> 16) & 0xFF, (u >> 8) & 0xFF, u & 0xFF]
        )
    return bytes(
        [
            0xF0 | (u >> 28),
            (u >> 20) & 0xFF,
            (u >> 12) & 0xFF,
            (u >> 4) & 0xFF,
            u & 0x0F,
        ]
    )


def ltf8(v: int) -> bytes:
    u = v & 0xFFFFFFFFFFFFFFFF
    if u < 0x80:
        return bytes([u])
    if u < 0x4000:
        return bytes([0x80 | (u >> 8), u & 0xFF])
    if u < 0x200000:
        return bytes([0xC0 | (u >> 16)]) + (u & 0xFFFF).to_bytes(2, "big")
    if u < 0x10000000:
        return bytes([0xE0 | (u >> 24)]) + (u & 0xFFFFFF).to_bytes(3, "big")
    if u < 1 << 35:
        return bytes([0xF0 | (u >> 32)]) + (u & 0xFFFFFFFF).to_bytes(4, "big")
    if u < 1 << 42:
        return bytes([0xF8 | (u >> 40)]) + (u & ((1 << 40) - 1)).to_bytes(5, "big")
    if u < 1 << 49:
        return bytes([0xFC | (u >> 48)]) + (u & ((1 << 48) - 1)).to_bytes(6, "big")
    if u < 1 << 56:
        return b"\xfe" + u.to_bytes(7, "big")
    return b"\xff" + u.to_bytes(8, "big")


def i32le(v: int) -> bytes:
    return struct.pack("<i", v)


def u32le(v: int) -> bytes:
    return struct.pack("<I", v)
