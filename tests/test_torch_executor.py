"""The partition executor (``parallel/executor.py``) against the JAX
package's: the same partition functions under the same fault policies give
the same results and the same ``JobReport`` ledger (statuses, attempts and
their outcomes, quarantines, retries, hedges), and the retry rules agree
(an ``Unrecoverable`` corruption is never retried)."""

import multiprocessing
import threading
import time

import pytest

from spark_bam_tpu.core import faults as jfaults
from spark_bam_tpu.parallel import executor as jex
from spark_bam_tpu_torch.core import faults
from spark_bam_tpu_torch.core.guard import MalformedInputError, RecordGapError
from spark_bam_tpu_torch.parallel import executor as ex

MODES = ["sequential", "threads"]


def _policies(**kw):
    """The same zero-backoff policy in both packages."""
    kw = dict(backoff_base=0.0, jitter=0.0, **kw)
    return faults.FaultPolicy(**kw), jfaults.FaultPolicy(**kw)


def _ledger(report):
    return (
        [(p.index, p.status, p.error,
          [(a.number, a.speculative, a.outcome, a.error) for a in p.attempts])
         for p in report.partitions],
        report.quarantined, report.retries, report.hedges,
        report.lost_records, report.lost_blocks,
    )


def _both(make_fn, items, pool_mode, workers=3, **policy):
    """Run ``make_fn()``'s function through both executors; returns the
    port's and the JAX package's ``(results, report)`` (or the exception
    each raised)."""
    pp, jp = _policies(**policy)
    out = []
    for run, cfg, pol in ((ex.run_partitions,
                           ex.ParallelConfig(pool_mode, workers), pp),
                          (jex.run_partitions,
                           jex.ParallelConfig(pool_mode, workers), jp)):
        try:
            out.append(run(make_fn(), items, cfg, pol))
        except Exception as e:   # the strict raise under test
            out.append(e)
    return out


def _flaky():
    calls = {}
    lock = threading.Lock()

    def flaky(i):
        with lock:
            calls[i] = calls.get(i, 0) + 1
            n = calls[i]
        if i % 2 == 0 and n <= 2:
            raise OSError(f"transient #{n} on {i}")
        return i * 10
    return flaky


def _always():
    def always(i):
        raise OSError(f"always failing {i}")
    return always


def _poisoned():
    def poisoned(i):
        if i == 1:
            raise OSError("always failing")
        return i
    return poisoned


@pytest.mark.parametrize("mode", MODES)
def test_transient_errors_recover_within_budget(mode):
    (pr, prep), (jr, jrep) = _both(_flaky, list(range(6)), mode)
    assert pr == jr == [i * 10 for i in range(6)]
    assert prep.retries == 6 and not prep.quarantined
    assert _ledger(prep) == _ledger(jrep)


@pytest.mark.parametrize("mode", MODES)
def test_strict_raises_when_budget_exhausted(mode):
    pe, je = _both(_always, [0, 1], mode, workers=2)
    assert isinstance(pe, OSError) and isinstance(je, OSError)
    assert str(pe).startswith("always failing")
    assert str(pe) == str(je)


@pytest.mark.parametrize("mode", MODES)
def test_tolerant_quarantines_and_continues(mode):
    (pr, prep), (jr, jrep) = _both(_poisoned, [0, 1, 2, 3], mode, workers=2,
                                   mode="tolerant")
    assert pr == jr == [0, None, 2, 3]
    assert prep.quarantined == [1]
    assert len(prep.partitions[1].attempts) == faults.FaultPolicy().max_retries + 1
    assert _ledger(prep) == _ledger(jrep)
    assert prep.summary() == jrep.summary()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("make_error", [
    lambda: ValueError("deterministic bug"),
    lambda: MalformedInputError("bad record", pos=7),
], ids=["value_error", "malformed"])
def test_nonretryable_error_fails_in_one_attempt(mode, make_error):
    def make():
        def bad(i):
            raise make_error()
        return bad

    (pr, prep), (jr, jrep) = _both(make, [0], mode, workers=2,
                                   mode="tolerant")
    assert prep.quarantined == jrep.quarantined == [0]
    assert len(prep.partitions[0].attempts) == 1
    assert _ledger(prep) == _ledger(jrep)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["corrupt", "gap", "record_gap"])
def test_unrecoverable_corruption_not_retried(mode, kind):
    """A corrupt block, a block gap and a record gap are ``IOError``s
    that no retry fixes: one attempt, then the quarantine."""
    errors = {
        "corrupt": (lambda: faults.BlockCorruptionError("CRC mismatch"),
                    lambda: jfaults.BlockCorruptionError("CRC mismatch")),
        "gap": (lambda: faults.BlockGapError(10, None, "x"),
                lambda: jfaults.BlockGapError(10, None, "x")),
        "record_gap": (lambda: RecordGapError("0:5", "x"), None),
    }
    port_err, jax_err = errors[kind]
    attempts = []

    def corrupt(i):
        attempts.append(i)
        raise port_err()

    pp, jp = _policies(mode="tolerant")
    _, report = ex.run_partitions(corrupt, [0], ex.ParallelConfig(mode, 2),
                                  pp)
    assert attempts == [0]
    assert report.quarantined == [0]
    assert not faults.retryable(port_err())
    if jax_err is not None:
        def jcorrupt(i):
            raise jax_err()

        _, jreport = jex.run_partitions(jcorrupt, [0],
                                        jex.ParallelConfig(mode, 2), jp)
        assert _ledger(report) == _ledger(jreport)


@pytest.mark.parametrize("exc,want", [
    (OSError("transient"), True), (TimeoutError(), True),
    (FileNotFoundError(), False), (PermissionError(), False),
    (faults.BlockCorruptionError(), False), (ValueError(), False),
    (EOFError(), False), (MalformedInputError("x"), False),
])
def test_retryable_classification(exc, want):
    assert faults.retryable(exc) is want


def test_map_partitions_and_fold():
    assert ex.map_partitions(lambda x: x + 1, [1, 2, 3],
                             ex.ParallelConfig("sequential")) == [2, 3, 4]
    assert ex.fold_results([1, 2, 3], 0, lambda a, b: a + b) == 6
    assert ex.last_report() is not None
    ex.reset_last_report()
    assert ex.last_report() is None


@pytest.mark.parametrize("spec", ["threads=4", "sequential", "processes",
                                  "threads", "processes=2"])
def test_parallel_config_parse_equals_jax(spec):
    got, want = ex.ParallelConfig.parse(spec), jex.ParallelConfig.parse(spec)
    assert (got.mode, got.workers) == (want.mode, want.workers)


@pytest.mark.parametrize("spec,match", [("spark", "sequential, threads, "
                                                   "processes"),
                                        ("threads=-2", ">= 0"),
                                        ("threads=four", "integer")])
def test_parallel_config_parse_rejects(spec, match):
    with pytest.raises(ValueError, match=match):
        ex.ParallelConfig.parse(spec)
    with pytest.raises(ValueError, match="Unknown parallel mode"):
        ex.run_partitions(lambda x: x, [1, 2], ex.ParallelConfig("spark", 2))


def test_process_pools_spawn():
    """A process pool never forks: a forked child of a process that has
    touched CUDA cannot use the card."""
    pool = ex._make_pool(ex.ParallelConfig("processes", 2))
    try:
        assert pool._mp_context.get_start_method() == "spawn"
        assert pool.submit(abs, -3).result(timeout=120) == 3
    finally:
        pool.shutdown()
    assert multiprocessing.get_context("spawn").get_start_method() == "spawn"


def test_hedge_fires_on_straggler():
    """A partition past ``hedge_after`` × the median latency gets a
    speculative twin, whose finish resolves it without the straggler."""
    for run, cfg, pol in (
            (ex.run_partitions, ex.ParallelConfig("threads", 5),
             faults.FaultPolicy(hedge_after=3.0, backoff_base=0.0)),
            (jex.run_partitions, jex.ParallelConfig("threads", 5),
             jfaults.FaultPolicy(hedge_after=3.0, backoff_base=0.0))):
        calls = {}
        lock = threading.Lock()

        def work(i):
            with lock:
                calls[i] = calls.get(i, 0) + 1
                first = calls[i] == 1
            time.sleep(1.0 if i == 3 and first else 0.02)
            return i

        t0 = time.monotonic()
        results, report = run(work, list(range(4)), cfg, pol)
        assert results == [0, 1, 2, 3]
        assert report.hedges == 1
        spec = [a for a in report.partitions[3].attempts if a.speculative]
        assert spec and spec[0].outcome == "ok"
        assert time.monotonic() - t0 < 0.95


def test_deadline_times_out_and_retries():
    """An attempt past the deadline is written off as a timeout and a
    fresh one launched."""
    for run, cfg, pol in (
            (ex.run_partitions, ex.ParallelConfig("threads", 4),
             faults.FaultPolicy(deadline=0.2, backoff_base=0.0)),
            (jex.run_partitions, jex.ParallelConfig("threads", 4),
             jfaults.FaultPolicy(deadline=0.2, backoff_base=0.0))):
        calls = {}
        lock = threading.Lock()

        def work(i):
            with lock:
                calls[i] = calls.get(i, 0) + 1
                first = calls[i] == 1
            if first:
                time.sleep(1.0)
            return i

        results, report = run(work, [0, 1], cfg, pol)
        assert results == [0, 1]
        outcomes = [a.outcome for a in report.partitions[0].attempts]
        assert "timeout" in outcomes and outcomes[-1] == "ok"
