"""Descriptive-stats pretty printing, reference-format-exact (reference
``spark_bam_tpu/core/stats.py``).

The reference reports N/μ/σ, med/mad, run-length-encoded element lists and a
percentile ladder everywhere results are summarized (org.hammerlab.stats).
Format contracts pinned by goldens (bgzf StreamTest.scala:36-58, CLI golden
outputs): R-6/Weibull quantiles (rank = p·(n+1) − 1), percentile p shown iff
``n·min(p,100−p)/100 ≥ 1``, values rounded to 1 decimal with trailing ``.0``
dropped, head…tail RLE truncation at 10 runs each side.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def fmt_num(x, round_digits: int = 1) -> str:
    """Round to 1 decimal; drop a trailing .0 (reference show for doubles)."""
    if isinstance(x, float):
        r = round(x, round_digits)
        if r == int(r):
            return str(int(r))
        return f"{r:.{round_digits}f}"
    return str(x)


def _rle(values: Sequence, limit: int = 10, fmt=fmt_num) -> str:
    runs: list[tuple[object, int]] = []
    for v in values:
        if runs and runs[-1][0] == v:
            runs[-1] = (v, runs[-1][1] + 1)
        else:
            runs.append((v, 1))

    def show(run):
        v, n = run
        return f"{fmt(v)}×{n}" if n > 1 else fmt(v)

    if len(runs) > 2 * limit:
        head = " ".join(show(r) for r in runs[:limit])
        tail = " ".join(show(r) for r in runs[-limit:])
        return f"{head} … {tail}"
    return " ".join(show(r) for r in runs)


def _quantile(sorted_vals: Sequence[float], p: float) -> float:
    """R-6 (Weibull) quantile: rank = p/100·(n+1) − 1, linear interpolation."""
    n = len(sorted_vals)
    rank = p / 100 * (n + 1) - 1
    if rank <= 0:
        return sorted_vals[0]
    if rank >= n - 1:
        return sorted_vals[-1]
    lo = int(math.floor(rank))
    frac = rank - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[lo + 1] * frac


def percentile_ladder(n: int) -> list[float]:
    """p included iff n·min(p, 100−p)/100 ≥ 1; a [50]-only ladder is empty."""
    candidates = [0.01, 0.1, 1, 5, 10, 25, 50, 75, 90, 95, 99, 99.9, 99.99]
    ladder = [p for p in candidates if n * min(p, 100 - p) / 100 >= 1 or p == 50]
    return [] if ladder == [50] else ladder


class Stats:
    """Summary statistics of a numeric sample, reference-style rendering."""

    def __init__(self, values: Iterable[float]):
        self.values = list(values)
        self.n = len(self.values)
        if self.n:
            self.mean = sum(self.values) / self.n
            self.stddev = math.sqrt(
                sum((v - self.mean) ** 2 for v in self.values) / self.n
            )
            self.sorted = sorted(self.values)
            self.median = _quantile(self.sorted, 50)
            self.mad = _quantile(sorted(abs(v - self.median) for v in self.values), 50)

    def show(self) -> str:
        if not self.n:
            return "(empty)"
        f = fmt_num
        lines = [
            f"N: {self.n},"
            f" μ/σ: {f(round(self.mean, 1))}/{f(round(self.stddev, 1))},"
            f" med/mad: {f(self.median)}/{f(self.mad)}"
        ]
        if self.n > 1:
            lines.append(f" elems: {_rle(self.values, fmt=f)}")
            if self.sorted != self.values and len(set(self.values)) > 1:
                lines.append(f"sorted: {_rle(self.sorted, fmt=f)}")
            for p in percentile_ladder(self.n):
                val = round(_quantile(self.sorted, p), 1)
                pname = fmt_num(float(p), 2) if p != int(p) else str(int(p))
                lines.append(f"{pname:>4}:\t{f(val)}")
        return "\n".join(lines)


def format_bytes_binary(n: int) -> str:
    """hammerlab-bytes format: 1024-based, 3 significant figures, K/M/G/T
    suffix ("583K", "25.6K")."""
    for unit, shift in (("E", 60), ("P", 50), ("T", 40), ("G", 30), ("M", 20), ("K", 10)):
        if n >= (1 << shift):
            v = n / (1 << shift)
            if v < 10:
                s = f"{v:.2f}".rstrip("0").rstrip(".")
            elif v < 100:
                s = f"{v:.1f}".rstrip("0").rstrip(".")
            else:
                s = str(round(v))
            return f"{s}{unit}"
    return str(n)
