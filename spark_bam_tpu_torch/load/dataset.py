"""A partitioned lazy dataset, the RDD's analog (reference
``spark_bam_tpu/load/dataset.py``): partition descriptors and a compute
function. Actions (``count``, ``collect``, ``partition_sizes``,
``first_per_partition``, ``aggregate``) run the partitions through the
executor (``parallel/executor.py``) under the dataset's ``FaultPolicy``,
so retries, deadlines, hedges and the strict/tolerant quarantine apply;
``last_report`` then holds the action's ``JobReport`` (a quarantined
partition contributes nothing to a tolerant action's result).
"""

from __future__ import annotations

from typing import Callable, Generic, Iterable, Iterator, Sequence, TypeVar

from spark_bam_tpu_torch.core.faults import FaultPolicy
from spark_bam_tpu_torch.parallel.executor import (
    JobReport,
    ParallelConfig,
    run_partitions,
)

T = TypeVar("T")
P = TypeVar("P")


class Dataset(Generic[P, T]):
    def __init__(self, partitions: Sequence[P],
                 compute: Callable[[P], Iterable[T]],
                 parallel: ParallelConfig = ParallelConfig(),
                 policy: FaultPolicy | None = None):
        self.partitions = list(partitions)
        self.compute = compute
        self.parallel = parallel
        self.policy = policy
        self.last_report: JobReport | None = None

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    def _execute(self, fn: Callable[[P], object]) -> list:
        results, report = run_partitions(fn, self.partitions, self.parallel,
                                         self.policy)
        self.last_report = report
        return results

    def map_partitions(self, fn: Callable[[Iterable[T]], Iterable]
                       ) -> "Dataset":
        compute = self.compute
        return Dataset(self.partitions, lambda p: fn(compute(p)),
                       self.parallel, policy=self.policy)

    def map(self, fn: Callable[[T], object]) -> "Dataset":
        return self.map_partitions(lambda it: (fn(x) for x in it))

    def filter(self, pred: Callable[[T], bool]) -> "Dataset":
        return self.map_partitions(lambda it: (x for x in it if pred(x)))

    def count(self) -> int:
        return sum(n for n in self._execute(
            lambda p: sum(1 for _ in self.compute(p))) if n is not None)

    def collect(self) -> list[T]:
        out: list[T] = []
        for part in self._execute(lambda p: list(self.compute(p))):
            if part is not None:
                out.extend(part)
        return out

    def partition_sizes(self) -> list[int | None]:
        """Records a partition (None marks a quarantined one)."""
        return self._execute(lambda p: sum(1 for _ in self.compute(p)))

    def first_per_partition(self) -> list[T | None]:
        def first(p):
            for x in self.compute(p):
                return x
            return None

        return self._execute(first)

    def aggregate(self, plan, nc: int) -> dict:
        """This dataset's records reduced into ``plan``'s int64 metric
        vectors (``agg/plan.py``): each partition through the int64 oracle
        (``agg/host.py``), the partials summed with ``combine``. Byte-equal
        to the device reduction of the same records; a quarantined
        partition contributes nothing (its loss shows in
        ``last_report``)."""
        from spark_bam_tpu_torch.agg.host import (
            columns_from_records,
            combine,
            host_aggregate,
        )
        from spark_bam_tpu_torch.agg.plan import AggConfig

        if not isinstance(plan, AggConfig):
            plan = AggConfig.parse(plan)
        parts = self._execute(lambda p: host_aggregate(
            columns_from_records(list(self.compute(p))), plan, nc))
        return combine(parts, plan, nc)

    def to_batches(self, batch_rows: int = 8192, columns=None):
        """Lazy columnar record batches of this dataset's records. Items
        may be bare ``BamRecord``s or tuples whose last element is one.
        Sequential: batch boundaries are a function of the row stream
        only."""
        from spark_bam_tpu_torch.columnar.schema import batches_from_records

        return batches_from_records(iter(self), batch_rows, columns=columns)

    def __iter__(self) -> Iterator[T]:
        for p in self.partitions:
            yield from self.compute(p)
