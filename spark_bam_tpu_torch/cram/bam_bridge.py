"""BAM↔CRAM record bridging: tag splitting, binning, cigar↔features.

The writer lowers ``BamRecord``s into CRAM data series without needing the
reference genome: every M/=/X cigar run is stored as an explicit-bases
``b`` feature, so the reader reconstructs sequence and cigar from the
stream alone (the htslib ``no_ref`` convention). ``=``/``X`` runs decode
back as ``M`` — the one lossy corner, inherent to reference-less features.
"""

from __future__ import annotations

import struct

from spark_bam_tpu_torch.core.guard import StructurallyInvalid, TruncatedInput

# BAM tag value byte-lengths by type char (value excludes tag+type).
_FIXED_TAG = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
_SUB_SIZE = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}


def split_tags(raw: bytes) -> list[tuple[bytes, int, bytes]]:
    """Split a BAM tag blob into (tag, type char, raw value bytes) triples.

    Z/H values keep their NUL terminator out of the value (re-added on
    rebuild); B values keep subtype+count+payload.

    The blob comes off disk (or a CRAM stream), so every length and
    offset is untrusted: damage raises the core/guard.py taxonomy —
    :class:`TruncatedInput` when a declared value runs past the blob,
    :class:`StructurallyInvalid` for unknown type/subtype codes or a
    negative B-array count — never a bare ``struct.error``/``ValueError``.
    """
    out = []
    p = 0
    n = len(raw)
    while p + 3 <= n:
        tag = bytes(raw[p: p + 2])
        typ = raw[p + 2]
        p += 3
        t = chr(typ)
        if t in _FIXED_TAG:
            size = _FIXED_TAG[t]
            if p + size > n:
                raise TruncatedInput(
                    f"tag {tag!r}:{t} value runs past blob end "
                    f"(need {size} bytes at {p}, have {n - p})"
                )
            out.append((tag, typ, bytes(raw[p: p + size])))
            p += size
        elif t in "ZH":
            end = raw.find(b"\x00", p)
            if end < 0:
                raise TruncatedInput(
                    f"tag {tag!r}:{t} string missing NUL terminator"
                )
            out.append((tag, typ, bytes(raw[p:end])))
            p = end + 1
        elif t == "B":
            if p + 5 > n:
                raise TruncatedInput(
                    f"tag {tag!r}:B header runs past blob end"
                )
            sub = chr(raw[p])
            if sub not in _SUB_SIZE:
                raise StructurallyInvalid(
                    f"tag {tag!r}:B has unknown subtype {sub!r}"
                )
            count = struct.unpack_from("<i", raw, p + 1)[0]
            if count < 0:
                raise StructurallyInvalid(
                    f"tag {tag!r}:B declares negative count {count}"
                )
            size = 5 + count * _SUB_SIZE[sub]
            if p + size > n:
                raise TruncatedInput(
                    f"tag {tag!r}:B[{sub}] x{count} runs past blob end "
                    f"(need {size} bytes at {p}, have {n - p})"
                )
            out.append((tag, typ, bytes(raw[p: p + size])))
            p += size
        else:
            raise StructurallyInvalid(f"unknown tag type {t!r}")
    return out


def join_tags(entries: list[tuple[bytes, int, bytes]]) -> bytes:
    out = bytearray()
    for tag, typ, value in entries:
        out += tag
        out.append(typ)
        out += value
        if chr(typ) in "ZH":
            out.append(0)
    return bytes(out)


def reg2bin(beg: int, end: int) -> int:
    """BAM bin for [beg, end) (SAM spec §4.2.1)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


# Cigar op codes (bam/record.py CIGAR_OPS = "MIDNSHP=X").
_OP_M, _OP_I, _OP_D, _OP_N, _OP_S, _OP_H, _OP_P, _OP_EQ, _OP_X = range(9)


def features_from_record(cigar, seq: str):
    """(feature code, 1-based read pos, payload) triples for a mapped read.

    Payloads: bases bytes for b/I/S, run length for D/N/H/P.
    """
    feats = []
    read_pos = 1
    for length, op in cigar:
        if op in (_OP_M, _OP_EQ, _OP_X):
            bases = seq[read_pos - 1: read_pos - 1 + length].encode("latin-1")
            feats.append((ord("b"), read_pos, bases))
            read_pos += length
        elif op == _OP_I:
            bases = seq[read_pos - 1: read_pos - 1 + length].encode("latin-1")
            feats.append((ord("I"), read_pos, bases))
            read_pos += length
        elif op == _OP_S:
            bases = seq[read_pos - 1: read_pos - 1 + length].encode("latin-1")
            feats.append((ord("S"), read_pos, bases))
            read_pos += length
        elif op == _OP_D:
            feats.append((ord("D"), read_pos, length))
        elif op == _OP_N:
            feats.append((ord("N"), read_pos, length))
        elif op == _OP_H:
            feats.append((ord("H"), read_pos, length))
        elif op == _OP_P:
            feats.append((ord("P"), read_pos, length))
        else:
            raise ValueError(f"cigar op {op} out of range")
    return feats


def subst_tables(sm: bytes):
    """Decode the 5-byte substitution matrix: table[ref base][code] → base.

    For each reference base (A,C,G,T,N order) the byte assigns a 2-bit code
    to each of the other four bases, in base order.
    """
    bases = "ACGTN"
    table: dict[str, list[str]] = {}
    for i, ref in enumerate(bases):
        alts = [b for b in bases if b != ref]
        by_code = [""] * 4
        byte = sm[i]
        for k, alt in enumerate(alts):
            code = (byte >> (6 - 2 * k)) & 0x3
            by_code[code] = alt
        table[ref] = by_code
    return table
