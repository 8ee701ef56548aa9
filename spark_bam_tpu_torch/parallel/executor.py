"""The executor's job ledger (reference ``spark_bam_tpu/parallel/
executor.py``): one ``PartitionReport`` per partition with its
``Attempt``s, under a ``JobReport``.

Only the ledger is here: the scrubber (``jobs/scrub.py``) reports one
partition per artifact in it. The partition executor itself (retries,
hedges, quarantine) comes with the port's record path (ROADMAP Queue 1
item 14) and belongs in this module.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Attempt:
    """One execution attempt of one partition."""

    partition: int
    number: int          # 0-based attempt index (hedges share the primary's)
    speculative: bool
    outcome: str         # ok | error | timeout | lost
    ms: float
    error: str | None = None


@dataclass
class PartitionReport:
    index: int
    status: str = "pending"   # pending | ok | quarantined
    attempts: list[Attempt] = field(default_factory=list)
    error: str | None = None


@dataclass
class JobReport:
    """Per-partition attempt and outcome ledger of one job."""

    partitions: list[PartitionReport]

    @property
    def quarantined(self) -> list[int]:
        return [p.index for p in self.partitions if p.status == "quarantined"]
