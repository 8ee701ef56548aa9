"""The plan-driven remote data plane (reference ``spark_bam_tpu/core/
remote_plan.py``): coalesced range fetches over one shared pool.

- **Plan-driven fetches.** ``PlannedChannel.set_plan`` takes the byte
  ranges a job will read (the block table an ``InflatePipeline`` or the
  streaming count holds) and turns them into coalesced ranged GETs with
  ``core/ranges.py::plan_fetches``. Without a plan the channel derives a
  whole-file one on its first read, so the metadata scan's two small
  reads a block are served from a few large GETs.
- **Adaptive depth.** Read-ahead keeps ``depth`` plan segments in flight
  past the consumer; ``depth=0`` (the default) doubles the window at each
  stall, up to ``max_depth``; a nonzero ``depth`` pins it.
- **Hedged GETs.** A fetch running longer than ``hedge`` times the rolling
  median GET latency (``LatencyTracker``) gets a twin; the first success
  wins. ``FaultPolicy.hedge_after`` overrides the multiplier when set, and
  transport retries come from the policy (``with_retries``).
- **One shared pool** bounded by a process-wide in-flight quota (``pool``)
  and an optional per-bucket quota (``bucket``), so a fleet load of many
  BAMs (``load/api.py::load_fleet``) cannot stampede a store.

``RemoteConfig`` parses the compact ``k=v,...`` spec of ``Config.remote``
/ ``SPARK_BAM_REMOTE`` / ``--remote``; ``mode=legacy`` takes the
cursor-relative ``PrefetchChannel`` instead. The counters ``remote.gets``,
``remote.bytes``, ``remote.hedges``, ``remote.stalls`` and the gauge
``remote.depth`` go to the ``obs`` registry when one is configured.
"""


from __future__ import annotations

import bisect
import os
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from concurrent.futures import wait as wait_futures
from dataclasses import dataclass
from functools import lru_cache
from typing import Iterable

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core.channel import ByteChannel
from spark_bam_tpu_torch.core.config import parse_bytes
from spark_bam_tpu_torch.core.faults import FaultPolicy, LatencyTracker, with_retries
from spark_bam_tpu_torch.core.ranges import ByteRange, RangeSet, plan_fetches


# ------------------------------------------------------------------- config
@dataclass(frozen=True)
class RemoteConfig:
    """Data-plane knobs, parseable from a compact ``k=v,...`` spec so they
    thread through config/env/CLI unchanged (``Config.remote`` /
    ``SPARK_BAM_REMOTE`` / ``--remote``)."""

    mode: str = "auto"            # auto | plan | legacy (PrefetchChannel)
    depth: int = 0                # in-flight segments; 0 = adaptive
    max_depth: int = 64           # adaptive-depth ceiling
    coalesce_gap: int = 128 << 10  # merge ranges separated by ≤ this
    max_request: int = 512 << 10   # split coalesced runs beyond this
    hedge: float = 3.0            # hedge a GET at N× median latency; 0 = off
    pool: int = 64                # process-wide in-flight GET quota
    bucket_quota: int = 0         # per-bucket in-flight GET cap; 0 = off
    cache_bytes: int = 256 << 20  # completed-segment retention budget

    MODES = ("auto", "plan", "legacy")

    def __post_init__(self):
        if self.mode not in self.MODES:
            raise ValueError(
                f"Unknown remote mode {self.mode!r}: expected one of "
                f"{', '.join(self.MODES)}"
            )
        if self.depth < 0 or self.max_depth < 1:
            raise ValueError(
                f"Bad remote depth {self.depth}/{self.max_depth}: depth must "
                "be >= 0 (0 = adaptive) and max_depth >= 1"
            )
        if self.max_request <= 0 or self.coalesce_gap < 0:
            raise ValueError(
                f"Bad remote request shape: max_request {self.max_request} "
                f"must be > 0 and coalesce_gap {self.coalesce_gap} >= 0"
            )
        if self.pool < 1:
            raise ValueError(f"remote pool must be >= 1: {self.pool}")
        if self.bucket_quota < 0:
            raise ValueError(
                f"remote bucket quota must be >= 0 (0 = off): {self.bucket_quota}"
            )
        if self.hedge < 0:
            raise ValueError(f"remote hedge must be >= 0 (0 = off): {self.hedge}")

    _KEYS = {
        "mode": "mode",
        "depth": "depth",
        "max_depth": "max_depth",
        "gap": "coalesce_gap",
        "coalesce_gap": "coalesce_gap",
        "request": "max_request",
        "max_request": "max_request",
        "hedge": "hedge",
        "pool": "pool",
        "bucket": "bucket_quota",
        "bucket_quota": "bucket_quota",
        "cache": "cache_bytes",
        "cache_bytes": "cache_bytes",
    }
    _BYTE_KEYS = ("coalesce_gap", "max_request", "cache_bytes")

    @staticmethod
    @lru_cache(maxsize=64)
    def parse(spec: str) -> "RemoteConfig":
        """``"mode=plan,depth=8,gap=128KB,request=512KB,hedge=3,pool=64"``
        (any subset; ``""`` ⇒ defaults). ``hedge`` accepts ``off``/``none``
        to disable explicitly; byte-valued keys take size shorthand."""
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"Bad remote-config entry {part!r} in {spec!r}")
            key, value = (t.strip() for t in part.split("=", 1))
            field = RemoteConfig._KEYS.get(key.replace("-", "_"))
            if field is None:
                raise ValueError(
                    f"Unknown remote-config key {key!r}: expected one of "
                    f"{', '.join(sorted(set(RemoteConfig._KEYS)))}"
                )
            if field == "mode":
                kw[field] = value
            elif field in RemoteConfig._BYTE_KEYS:
                kw[field] = parse_bytes(value)
            elif field == "hedge":
                kw[field] = (
                    0.0 if value.lower() in ("off", "none", "") else float(value)
                )
            else:
                kw[field] = int(value)
        return RemoteConfig(**kw)

    @staticmethod
    def from_env(env=None) -> "RemoteConfig":
        return RemoteConfig.parse(
            (env or os.environ).get("SPARK_BAM_REMOTE", "")
        )


# Process-wide override (the --remote CLI flag installs here); None falls
# back to SPARK_BAM_REMOTE. Same seam shape as faults.install_chaos.
_INSTALLED: RemoteConfig | None = None


def set_remote_config(spec: "str | RemoteConfig | None") -> None:
    """Install a process-wide ``RemoteConfig`` override (``--remote``);
    ``None`` uninstalls (environment resumes governing)."""
    global _INSTALLED
    _INSTALLED = RemoteConfig.parse(spec) if isinstance(spec, str) else spec


def active_remote_config() -> RemoteConfig:
    return _INSTALLED if _INSTALLED is not None else RemoteConfig.from_env()


# -------------------------------------------------- shared pool + GET quota
#: One fetch pool for the whole process: fleet loads (many channels) share
#: it instead of spawning workers per channel, and the per-size quota
#: semaphores bound how many GETs are actually on the wire at once.
_POOL_WORKERS = 64
_pool_lock = threading.Lock()
_pool: ThreadPoolExecutor | None = None
_quotas: dict[int, threading.BoundedSemaphore] = {}


def _shared_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=_POOL_WORKERS, thread_name_prefix="sbt-remote"
            )
        return _pool


def _quota_sem(n: int) -> threading.BoundedSemaphore:
    with _pool_lock:
        sem = _quotas.get(n)
        if sem is None:
            sem = _quotas[n] = threading.BoundedSemaphore(n)
        return sem


# The global quota bounds TOTAL wire concurrency; per-bucket quotas bound
# each origin's share of it, so one hot bucket in a fleet load cannot
# monopolize the pool (and cannot trip one store's rate limiting while
# the others idle). A bucket is the origin of the channel's URL
# (scheme://netloc); channels without a URL share the anonymous bucket "".
_bucket_sems: "dict[tuple[str, int], threading.BoundedSemaphore]" = {}
_bucket_inflight: "dict[str, dict[str, int]]" = {}


def _bucket_of(inner) -> str:
    url = getattr(inner, "url", "") or ""
    if "://" not in url:
        return ""
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    return f"{parts.scheme}://{parts.netloc}"


def _bucket_sem(bucket: str, n: int) -> threading.BoundedSemaphore:
    with _pool_lock:
        sem = _bucket_sems.get((bucket, n))
        if sem is None:
            sem = _bucket_sems[(bucket, n)] = threading.BoundedSemaphore(n)
        return sem


def _bucket_enter(bucket: str) -> None:
    with _pool_lock:
        st = _bucket_inflight.setdefault(bucket, {"cur": 0, "high": 0})
        st["cur"] += 1
        if st["cur"] > st["high"]:
            st["high"] = st["cur"]


def _bucket_exit(bucket: str) -> None:
    with _pool_lock:
        _bucket_inflight[bucket]["cur"] -= 1


def bucket_inflight_stats() -> "dict[str, dict[str, int]]":
    """Per-bucket in-flight GET counters: {bucket: {cur, high}} (tests,
    operator stats)."""
    with _pool_lock:
        return {b: dict(st) for b, st in _bucket_inflight.items()}


def reset_bucket_stats() -> None:
    with _pool_lock:
        _bucket_inflight.clear()


# ------------------------------------------------------------------ channel
class PlannedChannel(ByteChannel):
    """Plan-driven read-ahead over a remote ``ByteChannel``.

    ``set_plan`` (before the first read) pins the request plan; reads then
    map onto plan segments, are served from in-flight/completed fetches,
    and trigger read-ahead of the next ``depth`` segments *in plan order*
    — read-ahead follows the job's byte ranges across gaps instead of the
    cursor. Reads outside the plan fall through to the inner channel
    (counted, not cached): plans cover the data a job touches, so off-plan
    reads are metadata probes and EOF sentinels.

    Segments with outstanding readers are pinned; completed unpinned
    segments are evicted oldest-first past ``cache_bytes`` (pending
    fetches are never evicted — discarding an in-flight GET just re-pays
    it). Thread-safe: the inflate fan-out calls ``read_at`` from many
    threads.
    """

    def __init__(
        self,
        inner: ByteChannel,
        plan: "Iterable[ByteRange | tuple[int, int]] | None" = None,
        config: RemoteConfig | None = None,
        policy: FaultPolicy | None = None,
    ):
        super().__init__()
        self.inner = inner
        self.cfg = config or active_remote_config()
        self.policy = policy or FaultPolicy.from_env()
        self._lock = threading.RLock()
        self._segments: list[ByteRange] = []
        self._starts: list[int] = []
        self._futs: dict[int, Future] = {}
        self._order: list[int] = []        # submission order (eviction scan)
        self._sizes: dict[int, int] = {}   # completed-segment byte sizes
        self._cached_bytes = 0
        self._pins: dict[int, int] = {}
        self._fetched_any = False
        self._closed = False
        self._depth = self.cfg.depth or 8
        self._latency = LatencyTracker()
        self._quota = _quota_sem(self.cfg.pool)
        self._bucket = _bucket_of(inner)
        self._bucket_quota = (
            _bucket_sem(self._bucket, self.cfg.bucket_quota)
            if self.cfg.bucket_quota else None
        )
        if plan is not None:
            self.set_plan(plan)

    # ------------------------------------------------------------- planning
    def set_plan(self, ranges: "Iterable[ByteRange | tuple[int, int]]") -> None:
        """Install the byte ranges this channel will be asked for. A no-op
        after the first fetch: by then the whole-file fallback plan is live
        and replacing it would orphan in-flight segments."""
        with self._lock:
            if self._fetched_any:
                return
            rs = RangeSet(
                r if isinstance(r, ByteRange) else ByteRange(*r)
                for r in ranges
            )
            self._install_plan(rs)

    def _install_plan(self, rs: RangeSet) -> None:
        self._segments = plan_fetches(
            rs, gap=self.cfg.coalesce_gap, max_request=self.cfg.max_request
        )
        self._starts = [s.start for s in self._segments]
        obs.gauge("remote.plan_segments").set(len(self._segments))

    def _ensure_plan(self) -> None:
        """Whole-file fallback plan on first read when no plan was given
        (metadata scans touch everything; the size probe is one HEAD)."""
        with self._lock:
            if self._segments or self._fetched_any:
                return
        size = self.inner.size  # outside the lock: may be a HEAD round-trip
        with self._lock:
            if not self._segments and not self._fetched_any:
                self._install_plan(RangeSet([ByteRange(0, max(size, 1))]))

    # ------------------------------------------------------------- fetching
    def _fetch_job(self, start: int, length: int) -> bytes:
        t0 = time.perf_counter()
        # Bucket quota OUTSIDE the global quota: a hot bucket's excess GETs
        # queue on their own semaphore without pinning pool-wide slots, so
        # other buckets' fetches keep flowing.
        if self._bucket_quota is not None:
            self._bucket_quota.acquire()
            waited_ms = (time.perf_counter() - t0) * 1e3
            if waited_ms > 1.0:
                obs.observe("remote.bucket_wait_ms", waited_ms)
        try:
            t0 = time.perf_counter()
            with self._quota:
                waited_ms = (time.perf_counter() - t0) * 1e3
                if waited_ms > 1.0:
                    obs.observe("remote.quota_wait_ms", waited_ms)
                t1 = time.perf_counter()
                _bucket_enter(self._bucket)
                try:
                    data = with_retries(
                        lambda: self.inner._read_at(start, length), self.policy,
                        "remote GET",
                    )
                finally:
                    _bucket_exit(self._bucket)
                ms = (time.perf_counter() - t1) * 1e3
        finally:
            if self._bucket_quota is not None:
                self._bucket_quota.release()
        self._latency.record(ms)
        obs.count("remote.gets")
        obs.count("remote.bytes", len(data))
        obs.observe("remote.get_ms", ms)
        return data

    def _submit_locked(self, idx: int) -> Future:
        """Ensure segment ``idx`` has a fetch in flight (lock held)."""
        fut = self._futs.get(idx)
        if fut is None:
            seg = self._segments[idx]
            self._fetched_any = True
            fut = _shared_pool().submit(
                self._fetch_job, seg.start, seg.end - seg.start
            )
            self._futs[idx] = fut
            self._order.append(idx)
            fut.add_done_callback(lambda f, i=idx: self._on_done(i, f))
        return fut

    def _on_done(self, idx: int, fut: Future) -> None:
        if fut.cancelled() or fut.exception() is not None:
            return
        with self._lock:
            if idx in self._futs and idx not in self._sizes:
                self._sizes[idx] = len(fut.result())
                self._cached_bytes += self._sizes[idx]

    def _evict_locked(self) -> None:
        """Drop completed unpinned segments oldest-first past the budget.
        Pending fetches and pinned segments survive, so the retained set
        can transiently exceed the budget by the in-flight window."""
        if self._cached_bytes <= self.cfg.cache_bytes:
            return
        for idx in self._order:
            if self._cached_bytes <= self.cfg.cache_bytes:
                break
            fut = self._futs.get(idx)
            if fut is None:
                continue
            if self._pins.get(idx) or not fut.done() or idx not in self._sizes:
                continue
            del self._futs[idx]
            self._cached_bytes -= self._sizes.pop(idx)
            obs.count("remote.evictions")
        self._order = [i for i in self._order if i in self._futs]

    def _grow_depth(self) -> None:
        """Consumer stalled on an unfetched-or-pending segment: the window
        is smaller than the bandwidth-delay product. Double it (the
        slow-start analog — each stall costs one RTT, so a multiplicative
        ramp reaches the BDP in O(log) stalls) unless depth is pinned."""
        if self.cfg.depth:
            return
        grown = min(self.cfg.max_depth, self._depth * 2)
        if grown != self._depth:
            self._depth = grown
            obs.gauge("remote.depth").set(grown)

    def _await(self, idx: int) -> bytes:
        """Block for segment ``idx``, hedging a straggler fetch."""
        with self._lock:
            fut = self._submit_locked(idx)
        if not fut.done():
            obs.count("remote.stalls")
            self._grow_depth()
        hedge_mult = (
            self.policy.hedge_after
            if self.policy.hedge_after is not None
            else self.cfg.hedge
        )
        median = self._latency.median() if hedge_mult else None
        if median is None:
            return fut.result()
        try:
            return fut.result(timeout=hedge_mult * median / 1e3)
        except FutureTimeoutError:
            pass
        obs.count("remote.hedges")
        seg = self._segments[idx]
        twin = _shared_pool().submit(
            self._fetch_job, seg.start, seg.end - seg.start
        )
        pending = {fut, twin}
        err: BaseException | None = None
        while pending:
            done, pending = wait_futures(pending, return_when=FIRST_COMPLETED)
            for f in done:
                if f.exception() is None:
                    if f is twin:
                        obs.count("remote.hedge_wins")
                        with self._lock:
                            # The twin becomes the cached copy (the
                            # straggler may never land).
                            if self._futs.get(idx) is fut:
                                self._futs[idx] = twin
                                if idx in self._sizes:
                                    self._cached_bytes -= self._sizes.pop(idx)
                                self._on_done_inline(idx, twin)
                    return f.result()
                err = f.exception()
        raise err  # both the primary and the hedge failed

    def _on_done_inline(self, idx: int, fut: Future) -> None:
        if idx in self._futs and idx not in self._sizes:
            self._sizes[idx] = len(fut.result())
            self._cached_bytes += self._sizes[idx]

    # -------------------------------------------------------------- reading
    def _segment_at(self, pos: int) -> int | None:
        """Index of the plan segment containing ``pos``, or None."""
        i = bisect.bisect_right(self._starts, pos) - 1
        if i >= 0 and self._segments[i].end > pos:
            return i
        return None

    def _read_at(self, pos: int, n: int) -> bytes:
        if n <= 0:
            return b""
        self._ensure_plan()
        with self._lock:
            first = self._segment_at(pos)
            last_pos = pos + n - 1
            last = self._segment_at(last_pos)
            window = []
            if first is not None:
                j = first
                while j < len(self._segments) and self._segments[j].start <= last_pos:
                    window.append(j)
                    j += 1
                for idx in window:
                    self._pins[idx] = self._pins.get(idx, 0) + 1
                    self._submit_locked(idx)
                # Read-ahead: the next ``depth`` plan segments past the
                # request, in plan order (gap-skipping by construction).
                ahead_from = window[-1] + 1
                for idx in range(
                    ahead_from, min(ahead_from + self._depth,
                                    len(self._segments))
                ):
                    self._submit_locked(idx)
            del last
        try:
            out = []
            cur = pos
            remaining = n
            wi = 0
            while remaining > 0:
                idx = window[wi] if wi < len(window) else None
                seg = self._segments[idx] if idx is not None else None
                if seg is not None and seg.start <= cur < seg.end:
                    chunk = self._await(idx)
                    off = cur - seg.start
                    piece = chunk[off: off + remaining]
                    if not piece:
                        break  # EOF inside the segment
                    out.append(piece)
                    cur += len(piece)
                    remaining -= len(piece)
                    if cur >= seg.end:
                        wi += 1
                    elif remaining > 0:
                        break  # short segment: EOF
                else:
                    # Off-plan bytes (gaps, EOF sentinels, probe reads):
                    # direct inner read up to the next planned segment.
                    nxt = bisect.bisect_right(self._starts, cur)
                    limit = (
                        self._segments[nxt].start
                        if nxt < len(self._segments) else cur + remaining
                    )
                    take = min(remaining, limit - cur)
                    if take <= 0:
                        # cur sits inside a segment not in the window —
                        # possible only on concurrent plan swap; re-resolve.
                        with self._lock:
                            ridx = self._segment_at(cur)
                        if ridx is None:
                            break
                        window.append(ridx)
                        with self._lock:
                            self._pins[ridx] = self._pins.get(ridx, 0) + 1
                            self._submit_locked(ridx)
                        wi = len(window) - 1
                        continue
                    obs.count("remote.unplanned_gets")
                    piece = self.inner._read_at(cur, take)
                    if not piece:
                        break
                    out.append(piece)
                    cur += len(piece)
                    remaining -= len(piece)
                    if len(piece) < take:
                        break
                    # Landed at a segment start: resolve it for next loop.
                    with self._lock:
                        ridx = self._segment_at(cur)
                        if ridx is not None:
                            window.append(ridx)
                            self._pins[ridx] = self._pins.get(ridx, 0) + 1
                            self._submit_locked(ridx)
                            wi = len(window) - 1
            return b"".join(out)
        finally:
            with self._lock:
                for idx in window:
                    left = self._pins.get(idx, 0) - 1
                    if left <= 0:
                        self._pins.pop(idx, None)
                    else:
                        self._pins[idx] = left
                self._evict_locked()

    @property
    def depth(self) -> int:
        """Current read-ahead window (adaptive unless pinned by config)."""
        return self._depth

    @property
    def size(self) -> int:
        return self.inner.size

    def close(self) -> None:
        self._closed = True
        with self._lock:
            futs = list(self._futs.values())
            self._futs.clear()
            self._order.clear()
            self._sizes.clear()
            self._cached_bytes = 0
        for f in futs:
            f.cancel()  # queued fetches die; running ones are abandoned
        self.inner.close()


# ------------------------------------------------------------------ routing
def wrap_remote(
    inner: ByteChannel,
    plan: "Iterable[ByteRange | tuple[int, int]] | None" = None,
    policy: FaultPolicy | None = None,
) -> ByteChannel:
    """The remote read-path wrapper ``open_channel``/cloud factories use:
    ``PlannedChannel`` under the active ``RemoteConfig``, or the legacy
    cursor-relative ``PrefetchChannel`` when ``mode=legacy`` (bench A/B)."""
    cfg = active_remote_config()
    if cfg.mode == "legacy":
        from spark_bam_tpu_torch.core.prefetch import PrefetchChannel

        return PrefetchChannel(inner, chunk_size=1 << 20, depth=4, workers=8)
    return PlannedChannel(inner, plan=plan, config=cfg, policy=policy)
