"""BAM records on the host (reference ``spark_bam_tpu/bam/record.py``):
``BamRecord`` with its decode and encode (what the rewrite command
round-trips), and the reference span of one record read straight from its
cigar words (what the load path needs, without decoding the rest).

One record::

    block_size i32            # bytes that follow
    refID i32, pos i32
    l_read_name u8, mapq u8, bin u16
    n_cigar_op u16, flag u16
    l_seq i32
    next_refID i32, next_pos i32, tlen i32
    read_name  l_read_name bytes (NUL-terminated)
    cigar      n_cigar_op × u32 (len<<4 | op)
    seq        (l_seq+1)//2 bytes of 4-bit codes
    qual       l_seq bytes
    tags       rest

Decode and encode give the reference's values and bytes; they differ from
it only in speed (the sequence goes through byte tables, not a loop over
bases).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from spark_bam_tpu_torch.core.guard import (
    DecodeLimits,
    LimitExceeded,
    StructurallyInvalid,
    TruncatedInput,
    current_limits,
)

#: Cigar ops that consume reference bases: M, D, N, =, X.
REF_CONSUMING = (0, 2, 3, 7, 8)
SEQ_CODES = "=ACMGRSVTWYHKDBN"

_FIXED = struct.Struct("<iiiBBHHHiiii")  # block_size..tlen (36 bytes)
_BODY = struct.Struct("<iiBBHHHiiii")
# Sequence bytes → the letters of their high and low nibbles; letters →
# codes (15, "N", for any other character), and codes → high nibbles.
_HI = bytes(ord(SEQ_CODES[b >> 4]) for b in range(256))
_LO = bytes(ord(SEQ_CODES[b & 0xF]) for b in range(256))
_CODE = bytes(SEQ_CODES.index(chr(c)) if chr(c) in SEQ_CODES else 15
              for c in range(256))
_SHIFT4 = bytes((c << 4) & 0xFF for c in range(256))


def reference_span(buf, offset: int) -> int:
    """Bases of reference that the cigar of the record at ``offset`` of
    ``buf`` consumes, as an unbounded int. Raises ``struct.error`` when the
    cigar runs past the buffer."""
    l_read_name = int(buf[offset + 12])
    n_cigar = struct.unpack_from("<H", buf, offset + 16)[0]
    words = struct.unpack_from(f"<{n_cigar}I", buf, offset + 36 + l_read_name)
    return sum(w >> 4 for w in words if (w & 0xF) in REF_CONSUMING)


def _decode_seq(packed: bytes, l_seq: int) -> str:
    letters = bytearray(2 * len(packed))
    letters[0::2] = packed.translate(_HI)
    letters[1::2] = packed.translate(_LO)
    return letters[:l_seq].decode("latin-1")


def _encode_seq(seq: str) -> bytes:
    try:
        codes = seq.encode("latin-1").translate(_CODE)
    except UnicodeEncodeError:   # letters past latin-1 are code 15 too
        codes = bytes(_CODE[ord(c)] if ord(c) < 256 else 15 for c in seq)
    if len(codes) % 2:
        codes += b"\x00"
    hi, lo = codes[0::2].translate(_SHIFT4), codes[1::2]
    # Disjoint nibbles: the sum of the two byte strings is their OR.
    n = len(hi)
    return (int.from_bytes(hi, "big") + int.from_bytes(lo, "big")).to_bytes(
        n, "big")


@dataclass
class BamRecord:
    ref_id: int
    pos: int          # 0-based
    mapq: int
    bin: int
    flag: int
    next_ref_id: int
    next_pos: int
    tlen: int
    read_name: str
    cigar: list[tuple[int, int]] = field(default_factory=list)  # (length, op)
    seq: str = ""
    qual: bytes = b""
    tags: bytes = b""

    @staticmethod
    def decode(buf, offset: int = 0, limits: DecodeLimits | None = None
               ) -> tuple["BamRecord", int]:
        """Decode one record; returns (record, bytes consumed including the
        length prefix). Every length field is checked before it sizes a
        slice or a loop: truncation raises ``TruncatedInput``,
        contradictory fields ``StructurallyInvalid``, fields beyond
        ``limits`` ``LimitExceeded``."""
        lim = limits or current_limits()
        avail = len(buf) - offset
        if avail < 36:  # length prefix + the 32 fixed field bytes
            raise TruncatedInput(
                f"BAM record fixed section: need 36 bytes, have {avail}"
            )
        (block_size, ref_id, pos, l_read_name, mapq, bin_, n_cigar, flag,
         l_seq, next_ref_id, next_pos, tlen) = _FIXED.unpack_from(buf, offset)
        if block_size < 32 + 1:  # fixed fields + the name's NUL
            raise StructurallyInvalid(
                f"BAM record block_size {block_size} smaller than its "
                f"fixed fields"
            )
        if block_size > lim.max_record_bytes:
            raise LimitExceeded(
                f"BAM record block_size {block_size} exceeds limit "
                f"{lim.max_record_bytes}"
            )
        if 4 + block_size > avail:
            raise TruncatedInput(
                f"BAM record: declared {4 + block_size} bytes, have {avail}"
            )
        if l_read_name == 0:
            raise StructurallyInvalid(
                "BAM record l_read_name is 0 (name must be NUL-terminated)"
            )
        if l_seq < 0:
            raise StructurallyInvalid(f"BAM record l_seq is negative ({l_seq})")
        if l_seq > lim.max_seq_len:
            raise LimitExceeded(
                f"BAM record l_seq {l_seq} exceeds limit {lim.max_seq_len}"
            )
        if n_cigar > lim.max_cigar_ops:
            raise LimitExceeded(
                f"BAM record n_cigar {n_cigar} exceeds limit "
                f"{lim.max_cigar_ops}"
            )
        need = 32 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
        if need > block_size:
            raise StructurallyInvalid(
                f"BAM record fields need {need} bytes but block_size is "
                f"{block_size}"
            )
        p = offset + 36
        read_name = bytes(buf[p: p + l_read_name - 1]).decode("latin-1")
        p += l_read_name
        words = struct.unpack_from(f"<{n_cigar}I", buf, p)
        cigar = [(w >> 4, w & 0xF) for w in words]
        p += 4 * n_cigar
        n_seq_bytes = (l_seq + 1) // 2
        seq = _decode_seq(bytes(buf[p: p + n_seq_bytes]), l_seq)
        p += n_seq_bytes
        qual = bytes(buf[p: p + l_seq])
        p += l_seq
        tags = bytes(buf[p: offset + 4 + block_size])
        rec = BamRecord(ref_id, pos, mapq, bin_, flag, next_ref_id, next_pos,
                        tlen, read_name, cigar, seq, qual, tags)
        return rec, 4 + block_size

    def encode(self) -> bytes:
        name_bytes = self.read_name.encode("latin-1") + b"\x00"
        cigar_bytes = struct.pack(f"<{len(self.cigar)}I", *(
            (length << 4) | op for length, op in self.cigar))
        l_seq = len(self.seq)
        qual = self.qual if len(self.qual) == l_seq else b"\xff" * l_seq
        body = b"".join((
            _BODY.pack(self.ref_id, self.pos, len(name_bytes), self.mapq,
                       self.bin, len(self.cigar), self.flag, l_seq,
                       self.next_ref_id, self.next_pos, self.tlen),
            name_bytes, cigar_bytes, _encode_seq(self.seq), qual, self.tags,
        ))
        return struct.pack("<i", len(body)) + body

    def reference_span(self) -> int:
        """Bases of reference consumed (cigar ops M/D/N/=/X)."""
        return sum(length for length, op in self.cigar
                   if op in REF_CONSUMING)
