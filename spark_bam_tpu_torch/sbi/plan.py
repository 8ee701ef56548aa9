"""Split-plan build/consume (reference ``spark_bam_tpu/sbi/plan.py``):
the bridge between ``.sbi`` sidecars and the per-split record-start
resolution (``load/boundary.py``, on the device).

A plan is the *raw* per-boundary resolution for one split size: one
``PlanEntry`` per file split, pre-dedup, so warm consumers reconstruct
exactly what live resolution would have produced. Unresolvable
boundaries (``NoReadFoundException`` — scan budget exhausted mid-file)
are stored as ``PLAN_UNRESOLVED`` and re-resolved live on every load:
the cache must never convert an error into silence.
"""

from __future__ import annotations

from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.sbi.format import (
    PLAN_NONE,
    PLAN_POS,
    PLAN_UNRESOLVED,
    PlanEntry,
)


def build_split_plan(path, splits, header, config, device=None
                     ) -> list[PlanEntry]:
    """Resolve every split boundary into a raw plan, each through the
    boundary resolver on ``device``."""
    from spark_bam_tpu_torch.load.boundary import (
        NoReadFoundException,
        resolve_split_start,
    )

    entries: list[PlanEntry] = []
    for split in splits:
        try:
            pos = resolve_split_start(path, split, header, config,
                                      device=device)
        except NoReadFoundException:
            entries.append(PlanEntry(split.start, PLAN_UNRESOLVED, None))
            continue
        entries.append(
            PlanEntry(
                split.start,
                PLAN_NONE if pos is None else PLAN_POS,
                pos,
            )
        )
    return entries


def plan_to_starts(splits, entries: list[PlanEntry]) -> dict | None:
    """``{split: Pos | None}`` for the splits a plan covers.

    ``PLAN_UNRESOLVED`` boundaries are *absent* from the result — the
    consumer resolves those live (and re-raises what the build saw).
    Returns None when the plan doesn't line up with ``splits`` (e.g. a
    sidecar built under a different splitter): callers treat that as a
    miss rather than guess."""
    by_start = {e.file_start: e for e in entries}
    starts: dict = {}
    for split in splits:
        e = by_start.get(split.start)
        if e is None:
            return None
        if e.kind == PLAN_POS:
            starts[split] = e.pos
        elif e.kind == PLAN_NONE:
            starts[split] = None
    return starts


def plan_split_starts(entries: list[PlanEntry], file_size: int):
    """Deduped ``(starts, ends)`` the way ``cli/splits_util`` computes
    them live: consecutive boundaries resolving to the same position
    collapse, unresolved boundaries are skipped (matching the native
    splitter's per-boundary ``continue``), ends tile to the next start
    with EOF = ``Pos(file_size, 0)``."""
    starts: list[Pos] = []
    for e in entries:
        if e.kind != PLAN_POS:
            continue
        if not starts or starts[-1] != e.pos:
            starts.append(e.pos)
    ends = starts[1:] + [Pos(file_size, 0)]
    return starts, ends
