"""Sidecar resolution, validation, atomic writes and LRU eviction
(reference ``spark_bam_tpu/sbi/store.py``), for local BAMs.

``CacheStore`` is the one place ``.sbi`` sidecars are read and written:

- **Resolution**: next to the BAM (``<path>.sbi``) by default, or
  content-addressed under a shared ``SPARK_BAM_CACHE_DIR`` (the same
  digest path as the reference's, so both packages share one cache).
- **Validation**: every read re-fingerprints the BAM (size, mtime,
  head-CRC, checker-config digest) and CRC-checks the sidecar bytes. Any
  mismatch or corruption invalidates: the cache recomputes, it never
  changes results. Strict mode (``--cache readwrite,strict``) raises
  ``StaleCacheError`` instead.
- **Atomicity**: write to a pid + sequence tmp name, then ``os.replace``:
  racing writers never leave a torn file.
- **Eviction**: shared-dir caches keep a byte budget
  (``SPARK_BAM_CACHE_BUDGET``, byte shorthand ok); least-recently-used
  sidecars go after each write (reads touch mtime).

Every status string is the reference's, so the CLI's ``cache:`` lines
match. A remote (URL) BAM raises ``NotImplementedError``: the port has no
remote byte channel yet.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
import threading
from dataclasses import dataclass

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core import faults
from spark_bam_tpu_torch.core.atomic import ResourceExhausted, map_write_error
from spark_bam_tpu_torch.sbi.format import (
    SbiFormatError,
    SbiIndex,
    _local_only,
    decode_sbi,
    encode_sbi,
    fingerprint_of,
)

log = logging.getLogger(__name__)


class StaleCacheError(IOError):
    """Strict cache mode: the sidecar exists but is stale or corrupt."""


@dataclass(frozen=True)
class CacheMode:
    """Parsed ``--cache`` / ``Config.cache`` / ``SPARK_BAM_CACHE`` spec."""

    read: bool = False
    write: bool = False
    strict: bool = False

    @property
    def enabled(self) -> bool:
        return self.read or self.write

    _NAMES = ("off", "read", "write", "readwrite")

    @staticmethod
    def parse(spec: str) -> "CacheMode":
        """``off | read | write | readwrite`` with an optional ``,strict``
        suffix; ``""`` ⇒ off."""
        tokens = [t.strip() for t in (spec or "").split(",") if t.strip()]
        mode, strict = "off", False
        for tok in tokens:
            if tok == "strict":
                strict = True
            elif tok in CacheMode._NAMES:
                mode = tok
            else:
                raise ValueError(
                    f"Unknown cache mode {tok!r}: expected one of "
                    f"{', '.join(CacheMode._NAMES)} (+ optional ',strict')"
                )
        return CacheMode(
            read=mode in ("read", "readwrite"),
            write=mode in ("write", "readwrite"),
            strict=strict,
        )


# ------------------------------------------------------------ status events
@dataclass(frozen=True)
class CacheEvent:
    """One cache interaction, kept for the CLI status line."""

    state: str   # hit | miss | invalidated | written | skipped | evicted
    reason: str
    path: str


_events: list[CacheEvent] = []
_events_lock = threading.Lock()


def _record(state: str, reason: str, path: str) -> None:
    with _events_lock:
        _events.append(CacheEvent(state, reason, path))


def cache_events() -> list[CacheEvent]:
    with _events_lock:
        return list(_events)


def reset_cache_events() -> None:
    with _events_lock:
        _events.clear()


def cache_status_line(path, config) -> str:
    """One operator-facing line: why this run's load was warm or cold.
    When the run never consulted the cache (check-bam), probes the sidecar
    so the line still says what a load would find."""
    mode = config.cache_mode
    if not mode.enabled:
        return "cache: off (enable with --cache readwrite; docs/caching.md)"
    events = cache_events()
    if not events:
        state, reason = CacheStore.from_env().probe(path, config)
        return f"cache: {state} ({reason})"
    return "cache: " + "; ".join(f"{e.state} ({e.reason})" for e in events)


# ------------------------------------------------------------------- store
_TMP_SEQ = itertools.count()
_write_disabled = False
_write_disabled_lock = threading.Lock()


def cache_writes_disabled() -> bool:
    """Whether a full or failing disk latched write-through off."""
    return _write_disabled


def reset_cache_write_degrade() -> None:
    """Re-arm write-through (after freeing space)."""
    global _write_disabled
    with _write_disabled_lock:
        _write_disabled = False


class CacheStore:
    def __init__(self, cache_dir: str | None = None,
                 budget_bytes: int | None = None):
        self.cache_dir = str(cache_dir) if cache_dir else None
        self.budget_bytes = budget_bytes

    @staticmethod
    def from_env(env=None) -> "CacheStore":
        from spark_bam_tpu_torch.core.config import parse_bytes

        env = env if env is not None else os.environ
        budget = env.get("SPARK_BAM_CACHE_BUDGET")
        return CacheStore(
            cache_dir=env.get("SPARK_BAM_CACHE_DIR") or None,
            budget_bytes=parse_bytes(budget) if budget else None,
        )

    # ------------------------------------------------------------ locate
    def sidecar_path(self, bam_path) -> str:
        """Where ``bam_path``'s index lives: content-addressed under the
        shared dir when configured, else adjacent to the BAM."""
        s = os.fspath(bam_path)
        _local_only(s)
        if self.cache_dir:
            digest = hashlib.sha256(
                os.path.abspath(s).encode()).hexdigest()[:32]
            return os.path.join(self.cache_dir, digest + ".sbi")
        return s + ".sbi"

    # -------------------------------------------------------------- read
    @staticmethod
    def _read_bytes(sidecar: str) -> bytes:
        with open(sidecar, "rb") as f:
            return f.read()

    def load(self, bam_path, config, strict: bool = False,
             _quiet: bool = False) -> SbiIndex | None:
        """The validated index for ``bam_path``, or None (miss, stale or
        corrupt, recorded; ``strict`` raises on the latter two). A hit
        touches a shared-dir sidecar's mtime so eviction tracks use."""
        sidecar = self.sidecar_path(bam_path)
        if not os.path.exists(sidecar):
            if not _quiet:
                _record("miss", "no .sbi sidecar", sidecar)
            return None
        try:
            index = decode_sbi(self._read_bytes(sidecar))
        except SbiFormatError as e:
            return self._invalid(f"corrupt sidecar: {e}", sidecar, strict,
                                 _quiet)
        reason = index.fingerprint.mismatch(fingerprint_of(bam_path, config))
        if reason is not None:
            return self._invalid(f"stale sidecar: {reason}", sidecar, strict,
                                 _quiet)
        if not _quiet:
            _record("hit", "fingerprint ok", sidecar)
            if self.cache_dir:
                try:
                    os.utime(sidecar)
                except OSError:
                    pass
        return index

    @staticmethod
    def _invalid(reason: str, sidecar: str, strict: bool,
                 quiet: bool) -> None:
        if not quiet:
            _record("invalidated", reason, sidecar)
        if strict:
            raise StaleCacheError(f"{sidecar}: {reason}")
        log.info("split-index cache invalidated: %s (%s)", sidecar, reason)
        return None

    def probe(self, bam_path, config) -> tuple[str, str]:
        """Validation-only peek (no status events): the (state, reason) a
        real load would see."""
        sidecar = self.sidecar_path(bam_path)
        if not os.path.exists(sidecar):
            return "miss", f"no sidecar at {sidecar}; build with 'index'"
        try:
            index = decode_sbi(self._read_bytes(sidecar))
        except SbiFormatError as e:
            return "invalidated", f"corrupt sidecar: {e}"
        reason = index.fingerprint.mismatch(fingerprint_of(bam_path, config))
        if reason is not None:
            return "invalidated", f"stale sidecar: {reason}"
        sections = []
        if index.blocks is not None:
            sections.append(f"{len(index.blocks)} blocks")
        if index.split_plans:
            sections.append(
                "split plans for "
                + "/".join(str(s) for s in sorted(index.split_plans))
            )
        if index.record_starts is not None:
            sections.append(f"{len(index.record_starts)} record starts")
        return "hit", "; ".join(sections) or "empty index"

    # ------------------------------------------------------------- write
    def store(self, bam_path, index: SbiIndex) -> str | None:
        """Atomic write-through; returns the sidecar path, or None when the
        write failed or writes are latched off. Evicts over-budget
        shared-dir entries afterwards."""
        global _write_disabled
        sidecar = self.sidecar_path(bam_path)
        if _write_disabled:
            _record("skipped",
                    "cache writes disabled after earlier write error",
                    os.fspath(bam_path))
            return None
        blob = encode_sbi(index)
        # pid + in-process sequence: unique even for threads racing on the
        # same sidecar; os.replace keeps every reader's view untorn.
        tmp = f"{sidecar}.tmp{os.getpid()}.{next(_TMP_SEQ)}"
        try:
            if self.cache_dir:
                os.makedirs(self.cache_dir, exist_ok=True)
            with faults.wrap_disk(open(tmp, "wb")) as f:
                f.write(blob)
            faults.disk_replace(tmp, sidecar)
        except OSError as exc:
            # A cache write never fails the run it accelerates; a full or
            # failing disk latches the cache to read-only.
            obs.count("cache.write_errors")
            mapped = map_write_error(exc, "sidecar write", path=sidecar)
            if isinstance(mapped, ResourceExhausted):
                with _write_disabled_lock:
                    _write_disabled = True
                log.warning("split-index cache degraded to read-only: %s",
                            mapped)
                _record("skipped", f"write degraded to cache-off: {mapped}",
                        sidecar)
            else:
                log.info("split-index cache write failed: %s", mapped)
                _record("skipped", f"write failed: {mapped}", sidecar)
            return None
        finally:
            if os.path.exists(tmp):  # failure path only; replace moved it
                os.unlink(tmp)
        _record("written", f"{len(blob)} bytes", sidecar)
        self._evict(keep=sidecar)
        return sidecar

    def merge_and_store(self, bam_path, config, index: SbiIndex) -> str | None:
        """Write-through that keeps the sections an existing valid sidecar
        already holds (a quiet reload: no hit or miss recorded)."""
        try:
            existing = self.load(bam_path, config, _quiet=True)
        except OSError:  # an unreadable existing index: overwrite it
            existing = None
        if existing is not None:
            index.merge_from(existing)
        return self.store(bam_path, index)

    # ----------------------------------------------------------- evict
    def _evict(self, keep: str | None = None) -> None:
        """Drop least-recently-used shared-dir sidecars past the budget;
        the entry just written is exempt."""
        if not (self.cache_dir and self.budget_bytes):
            return
        try:
            stats = []
            for name in os.listdir(self.cache_dir):
                if not name.endswith(".sbi"):
                    continue
                p = os.path.join(self.cache_dir, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                stats.append((st.st_mtime_ns, st.st_size, p))
            total = sum(s for _, s, _ in stats)
            if total <= self.budget_bytes:
                return
            for _, size, p in sorted(stats):
                if p == keep:
                    continue
                try:
                    os.unlink(p)
                except OSError:
                    continue
                _record("evicted", f"{size} bytes over budget", p)
                total -= size
                if total <= self.budget_bytes:
                    break
        except OSError:
            pass  # eviction is best-effort; the cache stays correct


# ------------------------------------------------------- block-table tier
def cached_blocks(bam_path, config=None):
    """The ``.sbi`` block table of ``bam_path``, or None (cache off, miss,
    or a sidecar without a block section)."""
    from spark_bam_tpu_torch.core.config import Config

    config = config or Config.from_env()
    mode = config.cache_mode
    if not (mode.enabled and mode.read):
        return None
    index = CacheStore.from_env().load(bam_path, config, strict=mode.strict)
    if index is None or index.blocks is None:
        return None
    return list(index.blocks)


def store_blocks(bam_path, blocks, config=None) -> str | None:
    """Write-through of a freshly scanned block table into the ``.sbi``
    tier, keeping the sidecar's other sections; the sidecar path, or None
    when caching is off or the write did not happen."""
    from spark_bam_tpu_torch.core.config import Config

    config = config or Config.from_env()
    mode = config.cache_mode
    if not (mode.enabled and mode.write):
        return None
    index = SbiIndex(fingerprint=fingerprint_of(bam_path, config),
                     blocks=list(blocks))
    return CacheStore.from_env().merge_and_store(bam_path, config, index)
