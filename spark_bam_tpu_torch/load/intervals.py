"""Loci sets: genomic interval collections for filtered loads (reference
``spark_bam_tpu/load/intervals.py``).

Parses ``chr1:100-200,chr2,chr3:5k-10k``. Coordinates take decimal
suffixes (``k``/``m``/``g`` = 1e3/1e6/1e9): ``chr1:5k-10k`` means positions
5,000–10,000. Malformed ranges (no ``-``, ``lo > hi``, negative or
non-integral coordinates) raise :class:`BadLociError`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


class BadLociError(ValueError):
    """Malformed loci string (bad coordinate, bad range, lo > hi)."""


_LOCUS_RE = re.compile(r"^(\d+(?:\.\d+)?)([kKmMgG]?)$")

#: Decimal multipliers: genomic positions are base counts, not bytes.
_LOCUS_FACTORS = {"": 1, "k": 1_000, "m": 1_000_000, "g": 1_000_000_000}


def parse_locus(s: str) -> int:
    """One genomic coordinate: ``100``, ``5k``, ``1.5m``. Decimal suffixes;
    the value must come out a non-negative integer."""
    m = _LOCUS_RE.match(str(s).strip())
    if not m:
        raise BadLociError(
            f"bad genomic coordinate {s!r}: expected an integer with an "
            "optional decimal k/m/g suffix (e.g. 100, 5k, 1.5m)"
        )
    value, unit = m.groups()
    n = float(value) * _LOCUS_FACTORS[unit.lower()]
    if n != int(n):
        raise BadLociError(
            f"bad genomic coordinate {s!r}: {value}{unit} is not a whole "
            "number of positions"
        )
    return int(n)


@dataclass
class LociSet:
    # contig name → list of half-open (start, end); empty list ⇒ whole contig
    intervals: dict[str, list[tuple[int, int]]] = field(default_factory=dict)

    @staticmethod
    def parse(s: str, header=None) -> "LociSet":
        """Parse a loci string. With a ``header`` (anything with
        ``contig_names`` and ``contig_lengths``, as ``bam.header.BamHeader``
        has), a bare contig name becomes ``(0, length)`` of the first
        contig of that name; a name the header lacks stays whole-contig."""
        out: dict[str, list[tuple[int, int]]] = {}
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" in part:
                name, rng = part.split(":", 1)
                if "-" not in rng:
                    raise BadLociError(
                        f"bad range {part!r}: expected contig:lo-hi"
                    )
                lo_s, hi_s = rng.split("-", 1)
                lo, hi = parse_locus(lo_s), parse_locus(hi_s)
                if lo > hi:
                    raise BadLociError(
                        f"bad range {part!r}: start {lo} is past end {hi}"
                    )
                out.setdefault(name, []).append((lo, hi))
            else:
                out.setdefault(part, [])
        if header is not None:
            contigs = list(zip(header.contig_names,
                               (int(n) for n in header.contig_lengths)))
            for name, ivs in out.items():
                if not ivs:
                    length = next((ln for n, ln in contigs if n == name), None)
                    if length is not None:
                        ivs.append((0, length))
        return LociSet(out)

    def overlaps(self, contig: str, start: int, end: int) -> bool:
        if contig not in self.intervals:
            return False
        ivs = self.intervals[contig]
        if not ivs:
            return True  # whole contig
        return any(s < end and start < e for s, e in ivs)

    def ranges_for(self, contig: str) -> list[tuple[int, int]] | None:
        return self.intervals.get(contig)

    def __bool__(self) -> bool:
        return bool(self.intervals)
