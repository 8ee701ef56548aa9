"""What the load path needs of a BAM record on the host (reference
``spark_bam_tpu/bam/record.py``): the reference span of one record, read
straight from its cigar words (``BamRecord.decode(...).reference_span()``
without decoding the rest)."""

from __future__ import annotations

import struct

#: Cigar ops that consume reference bases: M, D, N, =, X.
REF_CONSUMING = (0, 2, 3, 7, 8)


def reference_span(buf, offset: int) -> int:
    """Bases of reference that the cigar of the record at ``offset`` of
    ``buf`` consumes, as an unbounded int. Raises ``struct.error`` when the
    cigar runs past the buffer."""
    l_read_name = int(buf[offset + 12])
    n_cigar = struct.unpack_from("<H", buf, offset + 16)[0]
    words = struct.unpack_from(f"<{n_cigar}I", buf, offset + 36 + l_read_name)
    return sum(w >> 4 for w in words if (w & 0xF) in REF_CONSUMING)
