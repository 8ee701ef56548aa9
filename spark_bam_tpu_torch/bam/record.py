"""BAM records on the host (reference ``spark_bam_tpu/bam/record.py``):
``BamRecord`` with its decode and encode (what the rewrite command
round-trips), its SAM line (``to_sam``, ``parse_sam_line``, the tag
renderer and encoder: what the SAM loader and the tag filter of SAM and
CRAM queries read), and the reference span of one record read straight
from its cigar words (what the load path needs, without decoding the
rest).

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

from typing import Sequence

from spark_bam_tpu_torch.core.guard import (
    DecodeLimits,
    LimitExceeded,
    StructurallyInvalid,
    TruncatedInput,
    current_limits,
)

#: Cigar ops that consume reference bases: M, D, N, =, X.
REF_CONSUMING = (0, 2, 3, 7, 8)
CIGAR_OPS = "MIDNSHP=X"
FLAG_UNMAPPED = 0x4
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

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def read_length(self) -> int:
        return len(self.seq)

    def cigar_string(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{length}{CIGAR_OPS[op]}"
                       for length, op in self.cigar)

    def reference_span(self) -> int:
        """Bases of reference consumed (cigar ops M/D/N/=/X)."""
        return sum(length for length, op in self.cigar
                   if op in REF_CONSUMING)

    def end_pos(self) -> int:
        """0-based exclusive reference end (pos + 1 for an unmapped record
        or an empty cigar)."""
        span = self.reference_span()
        return self.pos + (span if span else 1)

    # ------------------------------------------------------------------ SAM
    def to_sam(self, contig_names: Sequence[str]) -> str:
        """The record as one SAM line (no newline); ``contig_names`` in
        reference-index order, as ``BamHeader.contig_names`` holds them."""
        rname = _contig_name(contig_names, self.ref_id)
        if self.next_ref_id < 0:
            rnext = "*"
        elif self.next_ref_id == self.ref_id:
            rnext = "="
        else:
            rnext = _contig_name(contig_names, self.next_ref_id)
        qual = ("*" if not self.qual or all(q == 0xFF for q in self.qual)
                else "".join(chr(q + 33) for q in self.qual))
        fields = [
            self.read_name or "*",
            str(self.flag),
            rname,
            str(self.pos + 1),
            str(self.mapq),
            self.cigar_string(),
            rnext,
            str(self.next_pos + 1),
            str(self.tlen),
            self.seq or "*",
            qual,
        ]
        return "\t".join(fields + render_tags(self.tags))


def _contig_name(names: Sequence[str], idx: int) -> str:
    return "*" if idx < 0 else names[idx]


_INT_TYPES = {"c": ("<b", 1), "C": ("<B", 1), "s": ("<h", 2),
              "S": ("<H", 2), "i": ("<i", 4), "I": ("<I", 4)}
_ARRAY_TYPES = {**_INT_TYPES, "f": ("<f", 4)}


def render_tags(raw: bytes) -> list[str]:
    """The raw tag block as SAM ``TAG:TYPE:VALUE`` strings.

    Total on arbitrary bytes: any inconsistency (a short value, a missing
    NUL, a negative or overflowing B-array count, an unknown subtype)
    stops rendering at that tag, never an unbounded loop or an untyped
    crash (the raw bytes stay on the record either way)."""
    out = []
    p = 0
    n = len(raw)
    while p + 3 <= n:
        tag = raw[p: p + 2].decode("latin-1")
        typ = chr(raw[p + 2])
        p += 3
        if typ == "A":
            if p >= n:
                break
            out.append(f"{tag}:A:{chr(raw[p])}")
            p += 1
        elif typ in _INT_TYPES:
            fmt, size = _INT_TYPES[typ]
            if p + size > n:
                break
            out.append(f"{tag}:i:{struct.unpack_from(fmt, raw, p)[0]}")
            p += size
        elif typ == "f":
            if p + 4 > n:
                break
            out.append(f"{tag}:f:{struct.unpack_from('<f', raw, p)[0]:g}")
            p += 4
        elif typ in "ZH":
            end = raw.find(b"\x00", p)
            if end < 0:
                break
            out.append(f"{tag}:{typ}:{raw[p:end].decode('latin-1')}")
            p = end + 1
        elif typ == "B":
            if p + 5 > n:
                break
            sub = chr(raw[p])
            count = struct.unpack_from("<i", raw, p + 1)[0]
            p += 5
            entry = _ARRAY_TYPES.get(sub)
            if entry is None or count < 0 or p + count * entry[1] > n:
                break
            fmt, size = entry
            vals = [str(struct.unpack_from(fmt, raw, p + i * size)[0])
                    for i in range(count)]
            out.append(f"{tag}:B:{sub},{','.join(vals)}")
            p += count * size
        else:
            break  # unknown type: stop rendering (raw bytes still kept)
    return out


def parse_sam_line(line: str, contigs_by_name: dict[str, int]) -> BamRecord:
    """One SAM alignment line as a ``BamRecord`` (tags re-encoded; ``bin``
    0, as the reference leaves it)."""
    parts = line.rstrip("\n").split("\t")
    (qname, flag, rname, pos, mapq, cigar_s, rnext, pnext, tlen, seq,
     qual) = parts[:11]
    ref_id = -1 if rname == "*" else contigs_by_name[rname]
    if rnext == "*":
        next_ref = -1
    elif rnext == "=":
        next_ref = ref_id
    else:
        next_ref = contigs_by_name[rnext]
    cigar = []
    if cigar_s != "*":
        num = ""
        for c in cigar_s:
            if c.isdigit():
                num += c
            else:
                cigar.append((int(num), CIGAR_OPS.index(c)))
                num = ""
    return BamRecord(
        ref_id=ref_id,
        pos=int(pos) - 1,
        mapq=int(mapq),
        bin=0,
        flag=int(flag),
        next_ref_id=next_ref,
        next_pos=int(pnext) - 1,
        tlen=int(tlen),
        read_name=qname if qname != "*" else "",
        cigar=cigar,
        seq=seq if seq != "*" else "",
        qual=b"" if qual == "*" else bytes(ord(c) - 33 for c in qual),
        tags=b"".join(encode_tag(t) for t in parts[11:]),
    )


def encode_tag(s: str) -> bytes:
    """One SAM ``TAG:TYPE:VALUE`` as BAM tag bytes (integers as ``i``)."""
    tag, typ, value = s.split(":", 2)
    head = tag.encode("latin-1")
    if typ == "A":
        return head + b"A" + value.encode("latin-1")
    if typ == "i":
        return head + b"i" + struct.pack("<i", int(value))
    if typ == "f":
        return head + b"f" + struct.pack("<f", float(value))
    if typ in ("Z", "H"):
        return head + typ.encode() + value.encode("latin-1") + b"\x00"
    if typ == "B":
        sub = value[0]
        vals = value[2:].split(",") if len(value) > 2 else []
        fmt = _ARRAY_TYPES[sub][0]
        body = b"".join(struct.pack(fmt, float(v) if sub == "f" else int(v))
                        for v in vals)
        return (head + b"B" + sub.encode() + struct.pack("<i", len(vals))
                + body)
    raise ValueError(f"Unknown tag type: {s}")
