"""The ``indexed`` checker (reference ``spark_bam_tpu/check/indexed.py``,
indexed/Checker.scala:12-34): ground truth from a ``.records`` sidecar.
A position passes when it is one of the true record starts;
``next_read_start`` is the first one at or after the query."""

from __future__ import annotations

import bisect

from spark_bam_tpu_torch.bam.index_records import read_records_index
from spark_bam_tpu_torch.check.checker import register_checker
from spark_bam_tpu_torch.core.pos import Pos


class IndexedChecker:
    def __init__(self, positions: list[Pos]):
        self.positions = sorted(positions)

    @staticmethod
    def open(path, config=None) -> "IndexedChecker":
        return IndexedChecker(read_records_index(str(path) + ".records"))

    def __call__(self, pos: Pos) -> bool:
        i = bisect.bisect_left(self.positions, pos)
        return i < len(self.positions) and self.positions[i] == pos

    def next_read_start(self, start: Pos, max_read_size: int | None = None
                        ) -> Pos | None:
        i = bisect.bisect_left(self.positions, start)
        return self.positions[i] if i < len(self.positions) else None

    def close(self) -> None:
        pass


@register_checker("indexed")
def _make_indexed(path, config, **kw):
    return IndexedChecker.open(path, config)
