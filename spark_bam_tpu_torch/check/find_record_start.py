"""Split-point resolution on the host (reference ``spark_bam_tpu/check/
find_record_start.py``, FindRecordStart.scala:9-71): the first record
start at or after a block start.

- ``find_record_start``: the sequential oracle scan of an
  ``EagerChecker``;
- ``find_record_starts_flat``: every queried block start of a flat view
  from one chain walk over it (``check_flat``).

The load path resolves its strict split starts on the device
(``load/boundary.py``); these are the oracles it is held against and the
tolerant mode's resolver.
"""

from __future__ import annotations

import numpy as np

from spark_bam_tpu_torch.bgzf.flat import FlatView
from spark_bam_tpu_torch.check.checker import NoReadFoundException
from spark_bam_tpu_torch.check.eager import EagerChecker
from spark_bam_tpu_torch.check.vectorized import check_flat
from spark_bam_tpu_torch.core.pos import Pos


def find_record_start(checker: EagerChecker, block_start: int,
                      max_read_size: int = 10_000_000,
                      path: str = "<channel>") -> Pos:
    found = checker.next_read_start(Pos(block_start, 0), max_read_size)
    if found is None:
        raise NoReadFoundException(path, block_start, max_read_size)
    return found


def find_record_starts_flat(view: FlatView, contig_lengths: np.ndarray,
                            block_starts: list[int] | None = None,
                            max_read_size: int = 10_000_000,
                            reads_to_check: int = 10
                            ) -> dict[int, Pos | None]:
    """The first record start at or after each block start, from one
    check of every position of the view. None marks a block start whose
    budget ran out inside the view; a start whose answer could lie past
    the view (not ``at_eof``, budget beyond its end) is absent."""
    if block_starts is None:
        block_starts = [int(s) for s in view.block_starts]
    result = check_flat(view.data, contig_lengths, at_eof=view.at_eof,
                        reads_to_check=reads_to_check)
    true_flat = np.flatnonzero(result.verdict & result.exact)
    out: dict[int, Pos | None] = {}
    for start in block_starts:
        flat = view.flat_of_pos(start, 0)
        j = int(np.searchsorted(true_flat, flat))
        if j < len(true_flat) and true_flat[j] - flat < max_read_size:
            out[start] = Pos(*view.pos_of_flat(int(true_flat[j])))
        elif view.at_eof or flat + max_read_size <= view.size:
            out[start] = None   # the budget ran out inside the view
    return out
