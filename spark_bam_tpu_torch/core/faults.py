"""Fault policy (reference ``spark_bam_tpu/core/faults.py``): the retry
schedule a header or split read runs under (``with_retries``), the policy the
serve daemon's deadlines and its client's ``Overloaded`` retries read
(``FaultPolicy``), and the rolling latency median behind the daemon's
Retry-After hint (``LatencyTracker``).

``FaultPolicy`` parses the same compact ``k=v,...`` spec as the
reference's (``Config.faults`` / ``SPARK_BAM_FAULTS``). ``_mix`` and
``_roll`` are the reference's splitmix64 fault rolls, bit for bit: the
fabric's seeded chaos (``fabric/chaos.py``) draws with them, so one seed
gives both packages the same faults. The reference's chaos channels and
disk chaos are not part of this port.
"""

from __future__ import annotations

import random
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass
from functools import lru_cache

from spark_bam_tpu_torch import obs


#: OSError subclasses that are deterministic in practice: retrying a
#: missing file only delays the real error.
_NONRETRYABLE_OS = (
    FileNotFoundError,
    PermissionError,
    IsADirectoryError,
    NotADirectoryError,
)


def retryable(exc: BaseException) -> bool:
    """Transient transport errors (the OSError family, timeouts) are worth
    a fresh attempt; deterministic filesystem errors and everything else
    are not."""
    if isinstance(exc, _NONRETRYABLE_OS):
        return False
    return isinstance(exc, (OSError, TimeoutError))


@dataclass(frozen=True)
class FaultPolicy:
    """Bounded retries with jittered exponential backoff, a per-attempt
    deadline, a hedge factor and the ``strict`` | ``tolerant`` mode, with
    the reference's defaults."""

    max_retries: int = 3        # retries beyond the first attempt
    backoff_base: float = 0.05  # s; doubles per retry
    backoff_max: float = 5.0    # s; backoff ceiling
    jitter: float = 0.5         # fraction of each delay randomized away
    deadline: float | None = None     # s per attempt; None = unbounded
    hedge_after: float | None = None  # a twin at N× median latency
    mode: str = "strict"        # strict (raise) | tolerant (quarantine)

    MODES = ("strict", "tolerant")

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(
                f"Unknown fault mode {self.mode!r}: expected one of "
                f"{', '.join(self.MODES)}"
            )
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0: {self.max_retries}")

    @property
    def tolerant(self) -> bool:
        return self.mode == "tolerant"

    def backoff_delay(self, attempt: int, rng=random) -> float:
        """Jittered exponential backoff before retry ``attempt + 1``."""
        d = min(self.backoff_max, self.backoff_base * (2 ** attempt))
        return d * (1 - self.jitter + self.jitter * rng.random())

    _KEYS = {
        "retries": "max_retries",
        "max_retries": "max_retries",
        "backoff": "backoff_base",
        "backoff_base": "backoff_base",
        "backoff_max": "backoff_max",
        "jitter": "jitter",
        "deadline": "deadline",
        "hedge": "hedge_after",
        "hedge_after": "hedge_after",
        "mode": "mode",
    }

    @staticmethod
    @lru_cache(maxsize=64)
    def parse(spec: str) -> "FaultPolicy":
        """``"retries=3,backoff=0.05,deadline=60,hedge=2,mode=tolerant"``
        (any subset; ``""``: defaults). ``hedge`` and ``deadline`` take
        ``off`` / ``none`` to disable them."""
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"Bad fault-policy entry {part!r} in {spec!r}")
            key, value = (t.strip() for t in part.split("=", 1))
            field = FaultPolicy._KEYS.get(key.replace("-", "_"))
            if field is None:
                raise ValueError(
                    f"Unknown fault-policy key {key!r}: expected one of "
                    f"{', '.join(sorted(set(FaultPolicy._KEYS)))}"
                )
            if field == "mode":
                kw[field] = value
            elif field == "max_retries":
                kw[field] = int(value)
            elif field in ("deadline", "hedge_after") and value.lower() in (
                "off", "none", ""
            ):
                kw[field] = None
            else:
                kw[field] = float(value)
        return FaultPolicy(**kw)


def with_retries(fn, policy: FaultPolicy, what: str = "operation"):
    """``fn()`` under the policy's retry schedule: a retryable error is
    retried after the backoff delay, up to ``max_retries`` times; anything
    else, or the last failure, raises."""
    for attempt in range(policy.max_retries + 1):
        try:
            return fn()
        except Exception as e:
            if not retryable(e) or attempt == policy.max_retries:
                raise
            obs.count("faults.retries")
            time.sleep(policy.backoff_delay(attempt))
    raise AssertionError(f"{what}: unreachable")


class LatencyTracker:
    """Thread-safe rolling median of recent latencies, refusing to guess
    below ``MIN_SAMPLES``."""

    MIN_SAMPLES = 3

    def __init__(self, window: int = 64):
        self._samples: "deque[float]" = deque(maxlen=window)
        self._lock = threading.Lock()

    def record(self, ms: float) -> None:
        with self._lock:
            self._samples.append(ms)

    def median(self) -> float | None:
        """Median of the recent window, or None below ``MIN_SAMPLES``."""
        with self._lock:
            if len(self._samples) < self.MIN_SAMPLES:
                return None
            return statistics.median(self._samples)


# ------------------------------------------------------------------- chaos
_M64 = (1 << 64) - 1


def _mix(seed: int, kind: int, x: int) -> int:
    """splitmix64 finalizer over (seed, kind, index): the deterministic
    per-event randomness source, reproducible across runs and platforms."""
    z = (x + seed * 0x9E3779B97F4A7C15 + kind * 0xD1B54A32D192ED03) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def _roll(seed: int, kind: int, x: int, rate: float) -> bool:
    return rate > 0 and (_mix(seed, kind, x) >> 11) < rate * (1 << 53)
