"""Host-side partition execution with retries, deadlines, hedges and the
strict/tolerant quarantine (reference ``spark_bam_tpu/parallel/
executor.py``): what the record loaders' ``Dataset`` actions, the
``compare-splits`` command and the block planner run their partitions
through, and the ``JobReport`` ledger the scrubber fills in too.

``run_partitions`` applies a function to every partition under a
``FaultPolicy``, in order:

- transient failures (the OSError family, timeouts) retry after a jittered
  exponential backoff, up to ``max_retries`` a partition; ``Unrecoverable``
  errors (a corrupt block, malformed bytes) fail at once;
- an attempt past ``deadline`` seconds is written off and a fresh one
  launched (a late success of the stale one still counts);
- with ``hedge_after``, a partition running longer than N× the median
  successful attempt gets a speculative twin, and the first to finish wins;
- exhausted retries raise (``strict``) or quarantine the partition and go
  on (``tolerant``), its result then None; every attempt lands in the
  ``JobReport`` returned beside the results (``last_report`` keeps the
  most recent one).

``ParallelConfig`` picks the pool: ``sequential``, ``threads`` (zlib and
NumPy release the GIL) or ``processes``. A ``processes`` pool uses the
``spawn`` start method, never ``fork``: a forked child of a process that
has touched CUDA cannot use the card ("Cannot re-initialize CUDA in forked
subprocess"), and no partition launches a kernel anyway: the loaders
resolve every strict split start on the card in the calling process,
before any partition runs.
"""

from __future__ import annotations

import multiprocessing
import os
import statistics
import time
from concurrent.futures import (
    FIRST_COMPLETED,
    Future,
    ProcessPoolExecutor,
    ThreadPoolExecutor,
    wait,
)
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence, TypeVar

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core import guard
from spark_bam_tpu_torch.core.faults import FaultPolicy, retryable

T = TypeVar("T")
R = TypeVar("R")

_MODES = ("sequential", "threads", "processes")

#: Coordinator wake interval when deadlines or hedges need a clock (s).
_WATCH_TICK = 0.02
#: Successful attempts a hedge needs before their median means much.
_HEDGE_MIN_SAMPLES = 3


@dataclass(frozen=True)
class ParallelConfig:
    mode: str = "threads"   # sequential | threads | processes
    workers: int = 0        # 0: os.cpu_count()

    @property
    def num_workers(self) -> int:
        return self.workers or os.cpu_count() or 1

    @staticmethod
    def parse(s: str) -> "ParallelConfig":
        """``"sequential"`` | ``"threads[=N]"`` | ``"processes[=N]"``."""
        mode, _, n = s.partition("=")
        workers = 0
        if n:
            try:
                workers = int(n)
            except ValueError:
                raise ValueError(
                    f"Bad parallel worker count {n!r} in {s!r}: want an "
                    "integer")
        if mode not in _MODES:
            raise ValueError(
                f"Unknown parallel mode {mode!r} in {s!r}: expected one of "
                f"{', '.join(_MODES)}")
        if workers < 0:
            raise ValueError(
                f"Parallel worker count must be >= 0 (0 = all cores): {s!r}")
        return ParallelConfig(mode, workers)


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
    #: Records and blocks the tolerant decode quarantined while the job
    #: ran (``core/guard.py``'s tallies): finer than a partition's loss.
    lost_records: int = 0
    lost_blocks: int = 0

    @property
    def quarantined(self) -> list[int]:
        return [p.index for p in self.partitions if p.status == "quarantined"]

    @property
    def retries(self) -> int:
        return sum(1 for p in self.partitions for a in p.attempts
                   if a.number > 0 and not a.speculative)

    @property
    def hedges(self) -> int:
        return len({(a.partition, a.number) for p in self.partitions
                    for a in p.attempts if a.speculative})

    def summary(self) -> str:
        lines = [
            f"fault tolerance: {len(self.partitions)} partitions, "
            f"{self.retries} retries, {self.hedges} hedges, "
            f"{len(self.quarantined)} quarantined"
        ]
        if self.lost_records or self.lost_blocks:
            lines.append(
                f"\tmalformed input: {self.lost_records} records and "
                f"{self.lost_blocks} blocks quarantined by decode guards")
        for p in self.partitions:
            if p.status == "quarantined":
                lines.append(f"\tquarantined partition {p.index}: {p.error}")
        return "\n".join(lines)


_last_report: JobReport | None = None


def last_report() -> JobReport | None:
    """The most recent ``run_partitions`` call's report, whichever layer
    made the call (the CLI prints its quarantine summary from it)."""
    return _last_report


def reset_last_report() -> None:
    global _last_report
    _last_report = None


def _errstr(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


def _record(report: PartitionReport, attempt: Attempt) -> None:
    report.attempts.append(attempt)
    obs.observe("faults.attempt_ms", attempt.ms)


def _fail_partition(report: PartitionReport, err: BaseException,
                    policy: FaultPolicy) -> None:
    """Exhausted retries: quarantine (tolerant) or raise (strict)."""
    if policy.tolerant:
        report.status = "quarantined"
        report.error = _errstr(err)
        obs.count("faults.quarantined")
    else:
        raise err


def run_partitions(
    fn: Callable[[T], R],
    items: Sequence[T],
    config: ParallelConfig = ParallelConfig(),
    policy: FaultPolicy | None = None,
    pool=None,
) -> tuple[list[R | None], JobReport]:
    """``fn`` over every partition under ``policy``, in order. Returns
    ``(results, report)``; a quarantined partition (tolerant mode) holds
    None in ``results``. Strict mode raises a partition's last error once
    its retries are spent. ``pool`` lends a running executor for the
    pooled modes; a lent pool is never shut down here."""
    global _last_report
    policy = policy or FaultPolicy()
    if config.mode not in _MODES:
        raise ValueError(f"Unknown parallel mode: {config.mode} (expected "
                         f"one of {', '.join(_MODES)})")
    reports = [PartitionReport(i) for i in range(len(items))]
    report = JobReport(reports)
    _last_report = report
    # The loss tallies are process-wide: this job's share is the delta
    # (thread workers land in it; process workers do not).
    rec0, blk0 = guard.loss_totals()
    if config.mode == "sequential" or len(items) <= 1:
        results = _run_sequential(fn, items, policy, reports)
    else:
        results = _run_pooled(fn, items, config, policy, reports, pool=pool)
    rec1, blk1 = guard.loss_totals()
    report.lost_records = rec1 - rec0
    report.lost_blocks = blk1 - blk0
    return results, report


def map_partitions(fn: Callable[[T], R], items: Sequence[T],
                   config: ParallelConfig = ParallelConfig(),
                   policy: FaultPolicy | None = None) -> list[R]:
    """``fn`` over every partition, in order (results only)."""
    results, _ = run_partitions(fn, items, config, policy)
    return results


def _run_sequential(fn, items, policy, reports) -> list:
    results: list = [None] * len(items)
    for i, item in enumerate(items):
        last: BaseException | None = None
        for attempt in range(policy.max_retries + 1):
            t0 = time.perf_counter()
            try:
                value = fn(item)
            except Exception as e:
                ms = (time.perf_counter() - t0) * 1e3
                _record(reports[i], Attempt(i, attempt, False, "error", ms,
                                            _errstr(e)))
                last = e
                if not retryable(e) or attempt == policy.max_retries:
                    break
                obs.count("faults.retries")
                time.sleep(policy.backoff_delay(attempt))
            else:
                ms = (time.perf_counter() - t0) * 1e3
                _record(reports[i], Attempt(i, attempt, False, "ok", ms))
                reports[i].status = "ok"
                results[i] = value
                last = None
                break
        if last is not None:
            _fail_partition(reports[i], last, policy)
    return results


def _make_pool(config: ParallelConfig):
    if config.mode == "threads":
        return ThreadPoolExecutor(max_workers=config.num_workers)
    return ProcessPoolExecutor(max_workers=config.num_workers,
                               mp_context=multiprocessing.get_context("spawn"))


def _run_pooled(fn, items, config, policy, reports, pool=None) -> list:
    n = len(items)
    owns_pool = pool is None
    results: list = [None] * n
    resolved = [False] * n
    attempts_started = [0] * n          # non-speculative attempts submitted
    hedged = [False] * n
    completed_ms: list[float] = []      # successful latencies (hedge median)
    inflight: dict[Future, tuple[int, int, bool, float]] = {}
    abandoned: set[Future] = set()      # past their deadline, still running
    retry_due: list[tuple[float, int, int]] = []  # (due, partition, attempt)
    unresolved = n
    if owns_pool:
        pool = _make_pool(config)

    def submit(i: int, attempt_no: int, speculative: bool) -> None:
        if not speculative:
            attempts_started[i] += 1
        fut = pool.submit(fn, items[i])
        inflight[fut] = (i, attempt_no, speculative, time.monotonic())

    def inflight_attempts(i: int) -> int:
        return sum(1 for fut, (j, _, _, _) in inflight.items()
                   if j == i and fut not in abandoned)

    def after_failure(i: int, attempt_no: int, err: BaseException) -> None:
        """A live attempt of unresolved partition ``i`` failed: retry when
        the budget and the error allow, else (once nothing else runs for
        it) quarantine or raise."""
        nonlocal unresolved
        reports[i].error = _errstr(err)
        if retryable(err) and attempts_started[i] <= policy.max_retries:
            retry_due.append((time.monotonic()
                              + policy.backoff_delay(attempt_no), i,
                              attempts_started[i]))
            return
        if inflight_attempts(i) or any(j == i for _, j, _ in retry_due):
            return   # a twin or a retry is still in play; it decides
        resolved[i] = True
        unresolved -= 1
        _fail_partition(reports[i], err, policy)

    # A bounded backlog instead of every partition at once, so queued
    # futures do not age past their deadline before they run.
    backlog_cap = max(2 * config.num_workers, 4)
    next_to_submit = 0

    def feed() -> None:
        nonlocal next_to_submit
        while (next_to_submit < n
               and len(inflight) - len(abandoned) < backlog_cap):
            submit(next_to_submit, 0, speculative=False)
            next_to_submit += 1

    try:
        watch = policy.deadline is not None or policy.hedge_after is not None
        while unresolved:
            feed()
            now = time.monotonic()
            for entry in [e for e in retry_due if e[0] <= now]:
                retry_due.remove(entry)
                _, i, attempt_no = entry
                if not resolved[i]:
                    obs.count("faults.retries")
                    submit(i, attempt_no, speculative=False)
            timeout = None
            if retry_due:
                timeout = max(0.0, min(d for d, _, _ in retry_due) - now)
            if watch:
                timeout = (_WATCH_TICK if timeout is None
                           else min(timeout, _WATCH_TICK))
            if not inflight:
                if not retry_due:
                    break
                time.sleep(timeout or _WATCH_TICK)
                continue
            done, _ = wait(list(inflight), timeout=timeout,
                           return_when=FIRST_COMPLETED)
            now = time.monotonic()
            for fut in done:
                i, attempt_no, speculative, t0 = inflight.pop(fut)
                stale = fut in abandoned
                abandoned.discard(fut)
                ms = (now - t0) * 1e3
                err = fut.exception()
                if err is None:
                    if resolved[i]:
                        _record(reports[i], Attempt(i, attempt_no,
                                                    speculative, "lost", ms))
                        continue
                    _record(reports[i], Attempt(i, attempt_no, speculative,
                                                "ok", ms))
                    reports[i].status = "ok"
                    results[i] = fut.result()
                    resolved[i] = True
                    unresolved -= 1
                    completed_ms.append(ms)
                else:
                    _record(reports[i], Attempt(i, attempt_no, speculative,
                                                "error", ms, _errstr(err)))
                    if resolved[i] or stale:
                        # A stale attempt's deadline already scheduled its
                        # recovery: do not spend the budget twice.
                        continue
                    after_failure(i, attempt_no, err)
            if policy.deadline is not None:
                for fut, (i, attempt_no, speculative, t0) in list(
                        inflight.items()):
                    if fut in abandoned or resolved[i]:
                        continue
                    if now - t0 > policy.deadline:
                        abandoned.add(fut)
                        _record(reports[i], Attempt(
                            i, attempt_no, speculative, "timeout",
                            (now - t0) * 1e3, "partition deadline exceeded"))
                        if not speculative:
                            after_failure(i, attempt_no, TimeoutError(
                                f"partition {i} attempt {attempt_no} "
                                f"exceeded deadline {policy.deadline}s"))
            if (policy.hedge_after is not None
                    and len(completed_ms) >= _HEDGE_MIN_SAMPLES):
                median = statistics.median(completed_ms)
                for fut, (i, attempt_no, speculative, t0) in list(
                        inflight.items()):
                    if (speculative or resolved[i] or hedged[i]
                            or fut in abandoned):
                        continue
                    if (now - t0) * 1e3 > policy.hedge_after * median:
                        hedged[i] = True
                        obs.count("faults.hedges")
                        submit(i, attempt_no, speculative=True)
    except BaseException:
        # A strict failure or an interrupt: stop feeding the pool and
        # discard the running attempts; a lent pool only loses ours.
        if owns_pool:
            pool.shutdown(wait=False, cancel_futures=True)
        else:
            for fut in inflight:
                fut.cancel()
        raise
    if owns_pool:
        pool.shutdown(wait=False)
    return results


def fold_results(results: Iterable[R], zero, merge) -> object:
    """The accumulator's analog: a host-side fold of partition results."""
    acc = zero
    for r in results:
        acc = merge(acc, r)
    return acc
