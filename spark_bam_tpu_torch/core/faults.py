"""Fault policy (reference ``spark_bam_tpu/core/faults.py``): the error
classes a retry can never fix (``Unrecoverable``, ``BlockCorruptionError``
and the tolerant stream's ``BlockGapError``), the retry schedule a header
or split read runs under (``with_retries``), the policy the partition
executor, the serve daemon's deadlines and its client's ``Overloaded``
retries read (``FaultPolicy``), and the rolling latency median behind the
daemon's Retry-After hint (``LatencyTracker``).

``FaultPolicy`` parses the same compact ``k=v,...`` spec as the
reference's (``Config.faults`` / ``SPARK_BAM_FAULTS``). ``_mix`` and
``_roll`` are the reference's splitmix64 fault rolls, bit for bit: the
fabric's seeded chaos (``fabric/chaos.py``) and the disk-fault seam below
draw with them, so one seed gives both packages the same faults at the
same writes. The reference's chaos channels (read-side faults) are not
part of this port.
"""

from __future__ import annotations

import contextlib
import errno
import os
import random
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass
from functools import lru_cache

from spark_bam_tpu_torch import obs


class Unrecoverable:
    """Marker mixin: errors no retry can fix (corruption, parse failures
    of deterministic inputs). The partition executor fails such an
    attempt at once instead of spending its retry budget on it."""


class BlockCorruptionError(IOError, Unrecoverable):
    """A BGZF block failed its inflate, ISIZE or CRC-32 check:
    deterministic damage. Strict mode raises it; tolerant mode
    quarantines the block."""


class BlockGapError(IOError, Unrecoverable):
    """Tolerant-mode resync marker: the block at ``damaged_start`` was
    unreadable and the stream's next sound block starts at ``resync``
    (None when no later block header chains: the damage runs to EOF).
    A tolerant ``BlockStream`` raises it once so the record layer can
    find a record boundary past the gap and go on (``load/api.py``)."""

    def __init__(self, damaged_start: int, resync: int | None, reason: str):
        super().__init__(
            f"unreadable BGZF block at {damaged_start} "
            f"(resync at {resync}): {reason}"
        )
        self.damaged_start = damaged_start
        self.resync = resync
        self.reason = reason


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
    a fresh attempt; corruption (``Unrecoverable``), deterministic
    filesystem errors and everything else are not."""
    if isinstance(exc, Unrecoverable):
        return False
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


# -------------------------------------------------------------- disk chaos
# The filesystem seam: the job plane's journal and segments, AtomicFile and
# the .sbi store route their writes and renames through these hooks, so an
# ENOSPC mid-segment, a torn journal append or a failed commit rename
# replays from one seed. Decisions are indexed by operation (the Nth write
# or rename of the process rolls a kind-keyed splitmix64), as the
# reference's are.
_K_ENOSPC, _K_EIO, _K_SHORTW, _K_TORN, _K_RENAME = 21, 22, 23, 24, 25


@dataclass(frozen=True)
class DiskChaosSpec:
    """Which filesystem faults to inject and how often: per write call for
    the first four kinds, per rename for the last."""

    enospc: float = 0.0   # raise ENOSPC before writing anything
    eio: float = 0.0      # raise EIO before writing anything
    short: float = 0.0    # write a prefix, then raise EIO
    torn: float = 0.0     # write a prefix, report success (power-loss tail)
    rename: float = 0.0   # os.replace raises EIO

    _KINDS = {
        "enospc": _K_ENOSPC, "eio": _K_EIO, "short": _K_SHORTW,
        "torn": _K_TORN, "rename": _K_RENAME,
    }

    @staticmethod
    def parse(spec: str) -> "DiskChaosSpec":
        """``"enospc=0.05+eio=0.02+short=0.02+torn=0.01+rename=0.1"``:
        ``+``-separated, so the spec embeds in ``,``-separated config
        strings."""
        kw: dict = {}
        for part in (spec or "").split("+"):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"Bad disk-chaos entry {part!r} in {spec!r}")
            key, value = (t.strip() for t in part.split("=", 1))
            if key not in DiskChaosSpec._KINDS:
                raise ValueError(
                    f"Unknown disk-chaos key {key!r}: expected one of "
                    f"{', '.join(sorted(DiskChaosSpec._KINDS))}"
                )
            kw[key] = float(value)
        return DiskChaosSpec(**kw)


def parse_disk_chaos(arg: str) -> "tuple[int, DiskChaosSpec]":
    """``"SEED:SPEC"``, the ``--disk-chaos`` argument."""
    seed, _, spec = arg.partition(":")
    try:
        seed_i = int(seed)
    except ValueError:
        raise ValueError(
            f"Bad disk-chaos seed {seed!r} in {arg!r} (want SEED:SPEC)"
        )
    return seed_i, DiskChaosSpec.parse(spec)


class DiskChaosState:
    """One installation's decisions: a monotone counter per kind (the fault
    schedule is a function of the seed and the process's order of
    operations) and the injected tallies."""

    def __init__(self, seed: int, spec: DiskChaosSpec):
        self.seed = seed
        self.spec = spec
        self.lock = threading.Lock()
        self._n = {k: 0 for k in DiskChaosSpec._KINDS.values()}
        self.injected: dict[str, int] = {k: 0 for k in DiskChaosSpec._KINDS}

    def roll(self, name: str) -> bool:
        rate = getattr(self.spec, name)
        kind = DiskChaosSpec._KINDS[name]
        with self.lock:
            n = self._n[kind]
            self._n[kind] = n + 1
        if not _roll(self.seed, kind, n, rate):
            return False
        with self.lock:
            self.injected[name] += 1
        return True


_disk: DiskChaosState | None = None


def install_disk_chaos(arg: "str | tuple[int, DiskChaosSpec]") -> DiskChaosState:
    global _disk
    seed, spec = parse_disk_chaos(arg) if isinstance(arg, str) else arg
    _disk = DiskChaosState(seed, spec)
    from spark_bam_tpu_torch.obs import flight

    flight.set_context(
        disk_chaos_seed=seed,
        disk_chaos_spec=arg if isinstance(arg, str) else f"{seed}:{spec}",
    )
    return _disk


def uninstall_disk_chaos() -> None:
    global _disk
    _disk = None
    from spark_bam_tpu_torch.obs import flight

    flight.clear_context("disk_chaos_seed", "disk_chaos_spec")


def installed_disk_chaos() -> DiskChaosState | None:
    return _disk


def maybe_install_disk_chaos_from_env(env=None) -> DiskChaosState | None:
    """Install from ``SPARK_BAM_DISK_CHAOS`` when it is set (how fabric
    workers inherit the seam from the pool's environment)."""
    arg = (env or os.environ).get("SPARK_BAM_DISK_CHAOS", "")
    return install_disk_chaos(arg) if arg else None


@contextlib.contextmanager
def disk_chaos(arg: "str | tuple[int, DiskChaosSpec]"):
    """``with disk_chaos("7:enospc=0.1"): ...``, scoped."""
    state = install_disk_chaos(arg)
    try:
        yield state
    finally:
        uninstall_disk_chaos()


class _DiskChaosFile:
    """Write-through wrapper applying the installed disk faults to one file
    object; only built while chaos is installed (``wrap_disk``)."""

    def __init__(self, f, state: DiskChaosState):
        self._f = f
        self._state = state

    def write(self, data) -> int:
        state = self._state
        n = len(data)
        if n and state.roll("enospc"):
            obs.count("chaos.disk_enospc")
            raise OSError(
                errno.ENOSPC,
                f"disk chaos(seed={state.seed}): injected ENOSPC",
            )
        if n and state.roll("eio"):
            obs.count("chaos.disk_eio")
            raise OSError(
                errno.EIO, f"disk chaos(seed={state.seed}): injected EIO"
            )
        if n > 1 and state.roll("short"):
            obs.count("chaos.disk_short_writes")
            self._f.write(data[: n // 2])
            raise OSError(
                errno.EIO,
                f"disk chaos(seed={state.seed}): write failed after "
                f"{n // 2}/{n} bytes",
            )
        if n > 1 and state.roll("torn"):
            # The call succeeds but only a prefix lands: only the journal's
            # frame CRCs and the segments' size check can see it.
            obs.count("chaos.disk_torn_writes")
            self._f.write(data[: n // 2])
            return n
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()


def wrap_disk(f):
    """``f`` behind the installed disk-chaos seam; ``f`` itself when none
    is installed."""
    return f if _disk is None else _DiskChaosFile(f, _disk)


def disk_replace(src, dst) -> None:
    """``os.replace`` through the rename-fault seam."""
    if _disk is not None and _disk.roll("rename"):
        obs.count("chaos.disk_rename_fails")
        raise OSError(
            errno.EIO,
            f"disk chaos(seed={_disk.seed}): injected rename failure "
            f"({src} -> {dst})",
        )
    os.replace(src, dst)
