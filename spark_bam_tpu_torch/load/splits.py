"""File splits and resolved record-boundary splits (reference
``spark_bam_tpu/load/splits.py``) and the split plans of the reference's
``cli/splits_util.py``.

- ``file_splits``: the raw compressed byte ranges ``[start, end)`` of a
  file (hadoop ``FileSplits``);
- ``split_plan``: the raw per-boundary ``PlanEntry`` plan for one split
  size, every boundary resolved on the device (``load/boundary.py``),
  cache-aware: a valid ``.sbi`` sidecar serves it with no checker work,
  a miss computes it and, in a write mode, persists it;
- ``spark_bam_splits``: the plan deduped into ``Split(start, end)``s whose
  ends tile to the next start (reference LoadReads.scala:164-174);
- ``diff_splits``: the ordered symmetric difference of two split lists
  keyed on start (reference ComputeSplits.scala:111-121).

The plan follows the per-boundary semantics (``sbi/plan.py``), never the
reference's whole-file ``_plan_vectorized``, which raises ``KeyError`` on
a last split that holds only the EOF sentinel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from spark_bam_tpu_torch.core.channel import path_size
from spark_bam_tpu_torch.core.pos import Pos


@dataclass(frozen=True)
class FileSplit:
    """A compressed byte range [start, end) of one file."""
    path: str
    start: int
    end: int


@dataclass(frozen=True)
class Split:
    """A resolved split: record-boundary virtual positions [start, end)."""
    start: Pos
    end: Pos

    def length(self, estimated_compression_ratio: float = 3.0) -> int:
        return self.end.distance(self.start, estimated_compression_ratio)


def file_splits(path, split_size: int) -> list[FileSplit]:
    size = path_size(path)
    return [
        FileSplit(str(path), start, min(start + split_size, size))
        for start in range(0, size, split_size)
    ]


_LOCALITY_PROVIDER: Callable[[str, int, int], list] | None = None


def set_locality_provider(fn: Callable[[str, int, int], list] | None
                          ) -> None:
    """Register ``fn(path, start, end) -> [host, ...]`` (None clears it):
    where a deployment's storage holds a byte range (the reference's
    ``SplitRDD.preferredLocations`` analogue, SplitRDD.scala:43-79)."""
    global _LOCALITY_PROVIDER
    _LOCALITY_PROVIDER = fn


def preferred_hosts(split: FileSplit) -> list:
    """The hosts that hold ``split``'s byte range; empty = anywhere."""
    if _LOCALITY_PROVIDER is None:
        return []
    return list(_LOCALITY_PROVIDER(split.path, split.start, split.end))


def split_plan(path, split_size: int, config, device=None) -> list:
    """The raw per-boundary plan of ``path`` at ``split_size``: from a
    valid ``.sbi`` sidecar when ``config.cache`` reads, else every
    boundary resolved on ``device`` and, when it writes, persisted."""
    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.device import resolve_device
    from spark_bam_tpu_torch.sbi.format import SbiIndex, fingerprint_of
    from spark_bam_tpu_torch.sbi.plan import build_split_plan
    from spark_bam_tpu_torch.sbi.store import CacheStore

    dev = resolve_device(device)
    mode = config.cache_mode
    store = CacheStore.from_env() if mode.enabled else None
    if store is not None and mode.read:
        index = store.load(path, config, strict=mode.strict)
        if index is not None and split_size in index.split_plans:
            return index.split_plans[split_size]
    entries = build_split_plan(path, file_splits(path, split_size),
                               read_header(path), config, device=dev)
    if store is not None and mode.write:
        store.merge_and_store(
            path, config,
            SbiIndex(fingerprint_of(path, config),
                     split_plans={split_size: entries}),
        )
    return entries


def spark_bam_splits(path, split_size: int, config, device=None
                     ) -> list[Split]:
    """spark-bam's splits of ``path``: the plan's resolved starts, deduped,
    each ending at the next (the last at ``Pos(file size, 0)``)."""
    from spark_bam_tpu_torch.sbi.plan import plan_split_starts

    entries = split_plan(path, split_size, config, device=device)
    starts, ends = plan_split_starts(entries, path_size(path))
    return [Split(s, e) for s, e in zip(starts, ends)]


def diff_splits(ours: list[Split], theirs: list[Split]
                ) -> list[tuple[str, Split]]:
    """Ordered symmetric difference keyed on split start, each tagged
    ``"ours"`` or ``"theirs"``."""
    our_by_start = {s.start: s for s in ours}
    their_by_start = {s.start: s for s in theirs}
    out: list[tuple[str, Split]] = []
    for start in sorted(set(our_by_start) | set(their_by_start)):
        o, t = our_by_start.get(start), their_by_start.get(start)
        if o is not None and t is not None:
            continue
        out.append(("theirs", t) if t is not None else ("ours", o))
    return out
