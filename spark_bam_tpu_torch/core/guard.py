"""The decoder's typed errors and limits (reference ``spark_bam_tpu/core/
guard.py``): what the record decoder and the write path raise on bytes
that cannot be what they claim.

- ``TruncatedInput``: the bytes end before the declared structure does
  (also an ``EOFError``, so truncation handlers keep catching it);
- ``StructurallyInvalid``: a field contradicts the format;
- ``LimitExceeded``: well-formed but beyond ``DecodeLimits``.

All three are ``MalformedInputError``, a ``ValueError``. ``current_limits``
gives the defaults: the reference's ``SPARK_BAM_LIMITS`` and scoped
overrides, the write errors' ``ResourceExhausted`` mapping and the
tolerant quarantine come with the port of ``obs`` and the guard.
"""

from __future__ import annotations

from dataclasses import dataclass, fields


class MalformedInputError(ValueError):
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


DEFAULT_LIMITS = DecodeLimits()


def current_limits() -> DecodeLimits:
    """The active limits: the defaults."""
    return DEFAULT_LIMITS
