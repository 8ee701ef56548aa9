"""CRAM index (.crai): the CRAM analog of the .bai for interval queries.

A .crai is gzip-compressed text, one line per (slice × reference) with six
tab-separated fields:

    ref_seq_id  alignment_start(1-based)  alignment_span
    container_offset(file bytes)  slice_offset(bytes into container data)
    slice_size(bytes)

Multiref slices appear as one line per reference they touch (the htslib
convention); seeking lands on the container, and decode + overlap filtering
narrows to the requested loci.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass


@dataclass(frozen=True)
class CraiEntry:
    ref_seq_id: int
    start: int          # 1-based alignment start (0 for unmapped lines)
    span: int
    container_offset: int
    slice_offset: int
    slice_size: int

    def overlaps(self, ref: int, start0: int, end0: int) -> bool:
        """Half-open 0-based [start0, end0) query against this line."""
        if self.ref_seq_id != ref or self.span <= 0:
            return False
        s = self.start - 1
        return s < end0 and start0 < s + self.span


def write_crai(path, entries: list[CraiEntry]) -> None:
    with gzip.open(path, "wt") as f:
        for e in entries:
            f.write(
                f"{e.ref_seq_id}\t{e.start}\t{e.span}\t"
                f"{e.container_offset}\t{e.slice_offset}\t{e.slice_size}\n"
            )


def read_crai(path) -> list[CraiEntry]:
    entries = []
    with gzip.open(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split("\t")
            entries.append(CraiEntry(*(int(x) for x in fields[:6])))
    return entries
