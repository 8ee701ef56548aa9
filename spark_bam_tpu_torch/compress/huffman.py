"""Literal-only fixed-Huffman DEFLATE on the host and the BGZF member
functions (reference ``spark_bam_tpu/compress/huffman.py``): the byte
authority that every encoder of the write path, the device lanes
included, reproduces bit for bit.

Each of them returns one complete BGZF member: the 18-byte gzip header
(FEXTRA "BC" subfield carrying BSIZE), a raw-DEFLATE body, and the 8-byte
footer (CRC-32 of the payload, ISIZE), with ``BSIZE = member size - 1`` a
u16. A *stored* body is ``\\x01 LEN NLEN payload``, so any payload up to
:data:`MAX_STORED_PAYLOAD` fits whatever its entropy: stored is the
fallback wherever fixed-Huffman or zlib output would be larger.

Each byte costs 8 bits (0–143) or 9 bits (144–255) under the RFC 1951
fixed literal alphabet, plus a 3-bit block header and the 7-bit
end-of-block code; no LZ77 match search. Huffman codes are written
MSB-first into DEFLATE's LSB-first bitstream, so the tables store
bit-reversed codes and the writers emit them LSB-first.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from spark_bam_tpu_torch.core.guard import LimitExceeded

#: Largest payload a stored-block BGZF member can carry:
#: 18 (header) + 5 (stored framing) + payload + 8 (footer) ≤ 65536. The
#: zlib stream's window (one fixed block per window) is this size too.
MAX_STORED_PAYLOAD = 0x10000 - 18 - 5 - 8

_HEADER_PREFIX = (
    b"\x1f\x8b\x08\x04"        # gzip magic, deflate, FEXTRA
    b"\x00\x00\x00\x00"        # mtime
    b"\x00\xff"                # XFL, OS
    b"\x06\x00"                # XLEN = 6
    b"BC\x02\x00"              # BC subfield
)


def _fixed_tables() -> "tuple[np.ndarray, np.ndarray]":
    """(nbits[256] u8, bit-reversed code[256] u16) of the fixed literal
    alphabet restricted to byte values."""
    nbits = np.where(np.arange(256) < 144, 8, 9).astype(np.uint8)
    rcode = np.empty(256, dtype=np.uint16)
    for b in range(256):
        code = 0x30 + b if b < 144 else 0x190 + (b - 144)
        n = int(nbits[b])
        rev = 0
        for _ in range(n):
            rev = (rev << 1) | (code & 1)
            code >>= 1
        rcode[b] = rev
    return nbits, rcode


NBITS, RCODE = _fixed_tables()


def bgzf_member(body: bytes, crc: int, isize: int) -> bytes:
    """Frame a raw-DEFLATE body into one BGZF member."""
    bsize = 18 + len(body) + 8
    if bsize > 0x10000:
        raise LimitExceeded(
            f"BGZF member would be {bsize} bytes; the BSIZE field caps "
            f"members at 65536 (body {len(body)}B)"
        )
    return (
        _HEADER_PREFIX
        + struct.pack("<H", bsize - 1)
        + body
        + struct.pack("<II", crc & 0xFFFFFFFF, isize)
    )


def stored_body(payload: bytes) -> bytes:
    """A final stored DEFLATE block: the BFINAL=1/BTYPE=00 byte, LEN/NLEN
    and the raw bytes."""
    n = len(payload)
    return b"\x01" + struct.pack("<HH", n, n ^ 0xFFFF) + payload


def _check_stored(payload: bytes) -> None:
    if len(payload) > MAX_STORED_PAYLOAD:
        raise LimitExceeded(
            f"{len(payload)}-byte payload cannot fit a stored BGZF member "
            f"(max {MAX_STORED_PAYLOAD})"
        )


def stored_member(payload: bytes, crc: "int | None" = None) -> bytes:
    """One stored-block BGZF member; ``crc`` takes an already computed
    CRC-32 (a device batch's)."""
    _check_stored(payload)
    if crc is None:
        crc = zlib.crc32(payload)
    return bgzf_member(stored_body(payload), crc, len(payload))


def fixed_pack(payload: bytes) -> "tuple[bytes, int]":
    """One final fixed-Huffman DEFLATE block over ``payload``; returns
    ``(packed_bytes, total_bits)``. Bits, LSB-first within bytes: the
    header (BFINAL=1, BTYPE=01 → 1, 1, 0), each byte's bit-reversed code,
    then the 7-bit all-zero end-of-block code; the last byte is padded
    with zeros. A code of at most 9 bits at bit offset ``pos`` lands in
    bytes ``pos >> 3`` and ``(pos >> 3) + 1``; bits are unique, so the
    per-byte sums of those pieces are their ORs."""
    arr = np.frombuffer(payload, dtype=np.uint8)
    nb = NBITS[arr].astype(np.int64)
    total = 3 + int(nb.sum()) + 7
    nbytes = (total + 7) // 8
    pos = 3 + np.cumsum(nb) - nb
    v = RCODE[arr].astype(np.int64) << (pos & 7)
    at = pos >> 3
    out = (np.bincount(at, weights=v & 0xFF, minlength=nbytes)
           + np.bincount(at + 1, weights=v >> 8, minlength=nbytes + 1)[:nbytes])
    out = out.astype(np.uint8)
    out[0] |= 3   # BFINAL=1, BTYPE=01; the end-of-block code is 7 zero bits
    return out.tobytes(), total


def fixed_member(
    payload: bytes,
    crc: "int | None" = None,
    packed: "bytes | None" = None,
) -> bytes:
    """One fixed-Huffman BGZF member, or a stored one where stored is no
    larger (zlib's own pick-smaller rule). ``crc`` and ``packed`` take an
    already computed CRC-32 and body."""
    _check_stored(payload)
    if packed is None:
        packed, _ = fixed_pack(payload)
    if crc is None:
        crc = zlib.crc32(payload)
    if len(packed) >= len(payload) + 5:
        return bgzf_member(stored_body(payload), crc, len(payload))
    return bgzf_member(packed, crc, len(payload))


def fixed_stream_bits(
    payload: bytes,
    final: bool,
    packed: "bytes | None" = None,
    total_bits: "int | None" = None,
) -> np.ndarray:
    """One fixed-Huffman block as a u8 array of bits (LSB-first order),
    BFINAL set per ``final``: the unit multi-block streams are stitched
    from. ``packed``/``total_bits`` take an already packed body in
    :func:`fixed_pack`'s layout. It holds one byte a bit: 8× the
    payload's bytes."""
    if packed is None:
        packed, total_bits = fixed_pack(payload)
    bits = np.unpackbits(
        np.frombuffer(packed, dtype=np.uint8), bitorder="little"
    )[:total_bits].copy()
    bits[0] = 1 if final else 0
    return bits


def zlib_stream(payload: bytes, window: int = MAX_STORED_PAYLOAD) -> bytes:
    """An RFC 1950 zlib stream over ``payload``: the ``0x78 0x01`` header,
    one fixed-Huffman block per ``window`` bytes (BFINAL on the last
    only) and the Adler-32 trailer. ``zlib.decompress`` reads it."""
    mv = memoryview(payload)
    nwin = max(1, (len(mv) + window - 1) // window)
    bits = np.concatenate([
        fixed_stream_bits(bytes(mv[i * window:(i + 1) * window]),
                          final=(i == nwin - 1))
        for i in range(nwin)
    ])
    body = np.packbits(bits, bitorder="little").tobytes()
    return (
        b"\x78\x01" + body
        + struct.pack(">I", zlib.adler32(payload) & 0xFFFFFFFF)
    )


def zlib_member(payload: bytes, level: int = 6) -> bytes:
    """One BGZF member by host zlib (dynamic Huffman), or a stored one
    where zlib's output would overflow BSIZE; only a payload too big even
    for stored raises :class:`LimitExceeded`."""
    compressor = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = compressor.compress(payload) + compressor.flush()
    crc = zlib.crc32(payload)
    if 18 + len(comp) + 8 > 0x10000:
        return stored_member(payload, crc)
    return bgzf_member(comp, crc, len(payload))
