"""Byte-range grammar and range sets (reference ``spark_bam_tpu/core/
ranges.py``): comma-separated ranges ``start-end``, ``start+length`` and
``point``, each value in the byte-size shorthand (Range.scala:100-234,
Ranges.scala:244-309), as ``check-bam -i`` and ``check-blocks -i`` take
them, and a normalized interval set with point membership and window
overlap, and the fetch planner (``plan_fetches``) that coalesces the
byte ranges a job will touch into ranged GETs for the remote data plane
(``core/remote_plan.py``).
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


# ------------------------------------------------------------- fetch planner
def _split_run(start: int, end: int, max_request: int) -> list[ByteRange]:
    """One coalesced run as near-equal fetches of at most ``max_request``
    bytes (ceil-divided: a run just over the cap becomes two halves, not
    a full request and a sliver)."""
    length = end - start
    n = -(-length // max_request)
    step = -(-length // n)
    return [ByteRange(s, min(s + step, end)) for s in range(start, end, step)]


def plan_fetches(ranges: "RangeSet | Iterable[ByteRange]", *,
                 gap: int = 128 << 10, max_request: int = 512 << 10
                 ) -> list[ByteRange]:
    """The ranged GETs that cover ``ranges``: ranges at most ``gap`` cold
    bytes apart merge into one run (a small gap costs less than another
    round trip), and a run longer than ``max_request`` splits into
    near-equal fetches that can pipeline. Sorted and non-overlapping; every
    input byte is covered, every fetch is at most ``max_request`` long,
    and every fetched byte outside the input lies in a gap of at most
    ``gap`` bytes."""
    if gap < 0:
        raise ValueError(f"gap must be >= 0: {gap}")
    if max_request <= 0:
        raise ValueError(f"max_request must be > 0: {max_request}")
    rs = ranges if isinstance(ranges, RangeSet) else RangeSet(ranges)
    fetches: list[ByteRange] = []
    run_start = run_end = None
    for r in rs.ranges:
        if r.start == r.end:
            continue
        if run_start is None:
            run_start, run_end = r.start, r.end
        elif r.start - run_end <= gap:
            run_end = max(run_end, r.end)
        else:
            fetches.extend(_split_run(run_start, run_end, max_request))
            run_start, run_end = r.start, r.end
    if run_start is not None:
        fetches.extend(_split_run(run_start, run_end, max_request))
    return fetches


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
