"""Literal-only fixed-Huffman DEFLATE on the host (reference
``spark_bam_tpu/compress/huffman.py``): the bit layout every encoder of
the write path reproduces.

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

#: Largest payload a stored-block BGZF member can carry:
#: 18 (header) + 5 (stored framing) + payload + 8 (footer) ≤ 65536. The
#: zlib stream's window (one fixed block per window) is this size too.
MAX_STORED_PAYLOAD = 0x10000 - 18 - 5 - 8


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


def fixed_pack(payload: bytes) -> "tuple[bytes, int]":
    """One final fixed-Huffman DEFLATE block over ``payload``; returns
    ``(packed_bytes, total_bits)``. Bits, LSB-first within bytes: the
    header (BFINAL=1, BTYPE=01 → 1, 1, 0), each byte's bit-reversed code,
    then the 7-bit all-zero end-of-block code; the last byte is padded
    with zeros."""
    arr = np.frombuffer(payload, dtype=np.uint8)
    nb = NBITS[arr].astype(np.int64)
    total = 3 + int(nb.sum()) + 7
    bits = np.zeros(total, dtype=np.uint8)
    bits[0] = 1
    bits[1] = 1
    if len(arr):
        pos = 3 + np.cumsum(nb) - nb
        span = np.arange(9)
        idx = pos[:, None] + span[None, :]
        sel = span[None, :] < nb[:, None]
        vals = (RCODE[arr][:, None].astype(np.int64) >> span[None, :]) & 1
        bits[idx[sel]] = vals[sel]
    # The end-of-block code is 7 zero bits: counted in ``total`` only.
    return np.packbits(bits, bitorder="little").tobytes(), total


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
