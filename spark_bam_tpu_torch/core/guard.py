"""The decoder's typed errors and limits (reference ``spark_bam_tpu/core/
guard.py``): what the record decoder and the write path raise on bytes
that cannot be what they claim.

- ``TruncatedInput``: the bytes end before the declared structure does
  (also an ``EOFError``, so truncation handlers keep catching it);
- ``StructurallyInvalid``: a field contradicts the format;
- ``LimitExceeded``: well-formed but beyond ``DecodeLimits``.

All three are ``MalformedInputError``, a ``ValueError`` and
``Unrecoverable``: no retry re-reads other bytes. ``RecordGapError`` is the
tolerant record stream's resync marker (a garbage length prefix), and the
loss tallies (``note_quarantined_records``, ``note_quarantined_block``,
``loss_totals``) count what a tolerant load quarantined, for the
executor's ``JobReport``. ``current_limits`` gives the active limits: an
override installed by ``set_limits`` (the ``--limits`` flag) or
``scoped_limits`` (a test, the decode fuzz), else the
``SPARK_BAM_LIMITS`` spec parsed by ``DecodeLimits.parse``; the decoders
fence their length fields with ``check_count`` and ``check_available``.
The write errors' ``ResourceExhausted`` and ``map_write_error`` live in
``core/atomic.py``; ``preflight_space`` refuses to start a write that
cannot fit.
"""

from __future__ import annotations

import contextlib
import errno
import os
import threading
from dataclasses import dataclass, fields
from functools import lru_cache

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core.atomic import ResourceExhausted
from spark_bam_tpu_torch.core.config import parse_bytes
from spark_bam_tpu_torch.core.faults import Unrecoverable


class MalformedInputError(ValueError, Unrecoverable):
    """The bytes are not a well-formed instance of the format. ``path`` and
    ``pos`` locate the damage where the parser knows them."""

    def __init__(self, msg: str, *, path=None, pos=None):
        self.path = path
        self.pos = pos
        ctx = []
        if path is not None:
            ctx.append(str(path))
        if pos is not None:
            ctx.append(f"at {pos}")
        super().__init__(f"{msg} [{', '.join(ctx)}]" if ctx else msg)


class TruncatedInput(MalformedInputError, EOFError):
    """The input ends before the declared structure does."""


class StructurallyInvalid(MalformedInputError):
    """A field contradicts the format itself (a negative size, declared
    sub-regions overflowing the declared extent)."""


class LimitExceeded(MalformedInputError):
    """Structurally plausible but beyond the active ``DecodeLimits``, or a
    payload no BGZF member can carry."""


class RecordGapError(IOError, Unrecoverable):
    """Tolerant-mode record resync marker: the record at virtual position
    ``pos`` declared a length prefix no record can have, so the stream
    cannot skip it locally. A tolerant record stream raises it once; the
    load layer finds the next provable record boundary with the checker
    and resumes (the block layer's analog is ``BlockGapError``)."""

    def __init__(self, pos, reason: str):
        super().__init__(f"unreadable BAM record at {pos}: {reason}")
        self.pos = pos
        self.reason = reason


@dataclass(frozen=True)
class DecodeLimits:
    """Resource ceilings of the untrusted-byte parsers, far above anything
    a well-formed file holds."""

    max_record_bytes: int = 64 << 20   # one BAM record (block_size)
    max_header_text: int = 64 << 20    # SAM header text bytes
    max_refs: int = 1 << 20            # reference-dictionary entries
    max_name_len: int = 4096           # one reference or read name
    max_cigar_ops: int = 1 << 16       # CIGAR ops per record (u16 in BAM)
    max_seq_len: int = 1 << 28         # bases per record
    alloc_budget: int = 1 << 30        # per-partition allocation ceiling

    def __post_init__(self):
        for f in fields(self):
            if getattr(self, f.name) <= 0:
                raise ValueError(f"DecodeLimits.{f.name} must be > 0: "
                                 f"{getattr(self, f.name)}")

    _KEYS = {
        "record": "max_record_bytes",
        "max_record_bytes": "max_record_bytes",
        "header_text": "max_header_text",
        "text": "max_header_text",
        "max_header_text": "max_header_text",
        "refs": "max_refs",
        "max_refs": "max_refs",
        "name": "max_name_len",
        "max_name_len": "max_name_len",
        "cigar": "max_cigar_ops",
        "max_cigar_ops": "max_cigar_ops",
        "seq": "max_seq_len",
        "max_seq_len": "max_seq_len",
        "alloc": "alloc_budget",
        "alloc_budget": "alloc_budget",
    }

    @staticmethod
    @lru_cache(maxsize=64)
    def parse(spec: str) -> "DecodeLimits":
        """``"record=32MB,refs=1000,alloc=512MB"`` (any subset; ``""``:
        the defaults), values in the byte-size shorthand."""
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"Bad decode-limit entry {part!r} in {spec!r}")
            key, value = (t.strip() for t in part.split("=", 1))
            field = DecodeLimits._KEYS.get(key.replace("-", "_"))
            if field is None:
                raise ValueError(
                    f"Unknown decode-limit key {key!r}: expected one of "
                    f"{', '.join(sorted(set(DecodeLimits._KEYS)))}"
                )
            kw[field] = parse_bytes(value)
        return DecodeLimits(**kw)

    @staticmethod
    def from_env(env=None) -> "DecodeLimits":
        return DecodeLimits.parse(
            (env or os.environ).get("SPARK_BAM_LIMITS", ""))


# The process-wide override (``--limits``, ``scoped_limits``); None: the
# ``SPARK_BAM_LIMITS`` spec.
_active: "DecodeLimits | None" = None


def current_limits() -> DecodeLimits:
    """The active limits: the installed override, else
    ``SPARK_BAM_LIMITS``'s."""
    return _active if _active is not None else DecodeLimits.from_env()


def set_limits(limits: "DecodeLimits | str | None") -> None:
    """Install a process-wide override (``None`` uninstalls it)."""
    global _active
    _active = DecodeLimits.parse(limits) if isinstance(limits, str) else limits


@contextlib.contextmanager
def scoped_limits(limits: "DecodeLimits | str"):
    """``with scoped_limits("record=1MB"): ...``: an override for the
    block, the previous one restored after it."""
    global _active
    prev = _active
    _active = DecodeLimits.parse(limits) if isinstance(limits, str) else limits
    try:
        yield _active
    finally:
        _active = prev


def check_count(n: int, what: str, limit: "int | None" = None, *,
                path=None, pos=None) -> int:
    """A count or length read from untrusted bytes: negative raises
    ``StructurallyInvalid``, past ``limit`` ``LimitExceeded``."""
    if n < 0:
        raise StructurallyInvalid(f"{what} is negative ({n})",
                                  path=path, pos=pos)
    if limit is not None and n > limit:
        raise LimitExceeded(f"{what} {n} exceeds limit {limit}",
                            path=path, pos=pos)
    return n


def check_available(have: int, need: int, what: str, *,
                    path=None, pos=None) -> None:
    """Truncation check before ``need`` bytes are consumed."""
    if have < need:
        raise TruncatedInput(f"{what}: need {need} bytes, have {have}",
                             path=path, pos=pos)


def preflight_space(path, need_bytes: int, margin: float = 1.1) -> None:
    """Refuse to start a write that cannot fit: ``need_bytes`` (the
    caller's estimate) times ``margin`` against the free space of the
    filesystem that will hold ``path``. A filesystem without ``statvfs``
    skips the check and relies on the mid-write mapping."""
    if need_bytes <= 0:
        return
    target = os.path.dirname(os.path.abspath(str(path))) or "."
    try:
        st = os.statvfs(target)
    except (OSError, AttributeError):
        return
    free = st.f_bavail * st.f_frsize
    if free < need_bytes * margin:
        raise ResourceExhausted(
            f"preflight: {path} needs ~{int(need_bytes * margin)} bytes, "
            f"filesystem has {free} free",
            errno_=errno.ENOSPC, path=path,
        )


class _LossTally:
    """Process-wide quarantine counts, read around a ``run_partitions``
    call so its ``JobReport`` states what a tolerant load lost."""

    __slots__ = ("lock", "records", "blocks")

    def __init__(self):
        self.lock = threading.Lock()
        self.records = 0
        self.blocks = 0


_loss = _LossTally()


def note_quarantined_records(n: int = 1) -> None:
    obs.count("guard.quarantined_records", n)
    with _loss.lock:
        _loss.records += n


def note_quarantined_block() -> None:
    obs.count("guard.quarantined_blocks")
    with _loss.lock:
        _loss.blocks += 1


def loss_totals() -> tuple[int, int]:
    """(quarantined records, quarantined blocks) since process start."""
    with _loss.lock:
        return _loss.records, _loss.blocks
