"""Byte-range grammar and range sets (reference ``spark_bam_tpu/core/
ranges.py``): comma-separated ranges ``start-end``, ``start+length`` and
``point``, each value in the byte-size shorthand (Range.scala:100-234,
Ranges.scala:244-309), as ``check-bam -i`` and ``check-blocks -i`` take
them, and a normalized interval set with point membership and window
overlap. The reference's fetch planner of ranged reads comes with the
remote channels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

from spark_bam_tpu_torch.core.config import parse_bytes


@dataclass(frozen=True)
class ByteRange:
    """Half-open byte range [start, end)."""
    start: int
    end: int

    def __post_init__(self):
        if self.end < self.start:
            raise ValueError(f"Bad range: {self.start}-{self.end}")

    def __contains__(self, pos: int) -> bool:
        return self.start <= pos < self.end

    def overlaps(self, start: int, end: int) -> bool:
        return self.start < end and start < self.end


class RangeSet:
    """Normalized union of half-open byte ranges."""

    def __init__(self, ranges: Iterable[ByteRange]):
        merged: list[ByteRange] = []
        for r in sorted(ranges, key=lambda r: (r.start, r.end)):
            if merged and r.start <= merged[-1].end:
                merged[-1] = ByteRange(merged[-1].start, max(merged[-1].end, r.end))
            else:
                merged.append(r)
        self.ranges: Sequence[ByteRange] = tuple(merged)

    def __contains__(self, pos: int) -> bool:
        return any(pos in r for r in self.ranges)

    def overlaps(self, start: int, end: int) -> bool:
        return any(r.overlaps(start, end) for r in self.ranges)

    def __bool__(self) -> bool:
        return bool(self.ranges)

    def __eq__(self, other) -> bool:
        return isinstance(other, RangeSet) and self.ranges == other.ranges

    def __repr__(self) -> str:
        return "RangeSet(%s)" % ",".join(f"{r.start}-{r.end}" for r in self.ranges)


def parse_range(s: str) -> ByteRange:
    """One range: ``start-end`` | ``start+length`` | ``point``."""
    s = s.strip()
    for sep in ("-", "+"):
        # Split on the grammar separator, but not inside a leading number.
        idx = s.find(sep, 1)
        if idx > 0:
            left, right = s[:idx], s[idx + 1:]
            start = parse_bytes(left)
            other = parse_bytes(right)
            return ByteRange(start, other if sep == "-" else start + other)
    point = parse_bytes(s)
    return ByteRange(point, point + 1)


def parse_ranges(s: str | None) -> RangeSet | None:
    """Comma-separated list of ranges, or None for "unrestricted"."""
    if s is None or not s.strip():
        return None
    return RangeSet(parse_range(part) for part in s.split(",") if part.strip())
