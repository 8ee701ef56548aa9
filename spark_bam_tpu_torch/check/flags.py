"""The 19-check error model's bit layout (reference full/error/Flags.scala
bit order), the two masks the chain walk splits it into, the full-check
report's per-position rules and bit counts, and the host ``full``
checker's results (``Success``, ``Flags``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FLAG_NAMES = (
    "tooFewFixedBlockBytes",        # bit 0
    "negativeReadIdx",              # bit 1
    "tooLargeReadIdx",              # bit 2
    "negativeReadPos",              # bit 3
    "tooLargeReadPos",              # bit 4
    "negativeNextReadIdx",          # bit 5
    "tooLargeNextReadIdx",          # bit 6
    "negativeNextReadPos",          # bit 7
    "tooLargeNextReadPos",          # bit 8
    "tooFewBytesForReadName",       # bit 9
    "nonNullTerminatedReadName",    # bit 10
    "nonASCIIReadName",             # bit 11
    "noReadName",                   # bit 12
    "emptyReadName",                # bit 13
    "tooFewBytesForCigarOps",       # bit 14
    "invalidCigarOp",               # bit 15
    "emptyMappedCigar",             # bit 16
    "emptyMappedSeq",               # bit 17
    "tooFewRemainingBytesImplied",  # bit 18
)

BIT = {name: 1 << i for i, name in enumerate(FLAG_NAMES)}

# Bits that can only fire because the *buffer* ended (an escape when the
# window does not end at EOF).
ESCAPE_MASK = (
    BIT["tooFewFixedBlockBytes"]
    | BIT["tooFewBytesForReadName"]
    | BIT["tooFewBytesForCigarOps"]
)
DEFINITIVE_MASK = (1 << 19) - 1 - ESCAPE_MASK


def considered_mask(fail_mask, reads_before):
    """FullCheck's "considered" rule over numpy arrays: failing positions
    minus the bare at-EOF marker (reference FullCheck.scala:144-147)."""
    bit0 = BIT["tooFewFixedBlockBytes"]
    return (fail_mask != 0) & ~((fail_mask == bit0) & (reads_before == 0))


_NBITS = len(FLAG_NAMES)
# Set bits of every 19-bit mask value (512 KiB).
_POPCOUNT = sum((np.arange(1 << _NBITS) >> i) & 1
                for i in range(_NBITS)).astype(np.uint8)


def bit_counts(masks) -> np.ndarray:
    """(19,) int64: how many of the 19-bit ``masks`` set each flag bit, from
    one histogram over all mask values viewed as a 2 x ... x 2 array (its
    last axis is bit 0)."""
    hist = np.bincount(np.asarray(masks), minlength=1 << _NBITS)
    hist = hist.reshape((2,) * _NBITS)
    return np.array([hist.take(1, axis=_NBITS - 1 - i).sum()
                     for i in range(_NBITS)], dtype=np.int64)


def num_failing_fields(fail_mask, reads_before):
    """Failing-field count per position: the mask's popcount plus one when
    records chained before the failure (reference Flags.scala:118-124)."""
    return _POPCOUNT[fail_mask] + (np.asarray(reads_before) > 0)


@dataclass(frozen=True)
class Success:
    """A position that chained ``reads_parsed`` valid records (or met EOF
    after at least one)."""
    reads_parsed: int

    @property
    def call(self) -> bool:
        return True


@dataclass(frozen=True)
class Flags:
    """Every failing check of a position's first bad record, with the
    records chained before it."""
    tooFewFixedBlockBytes: bool = False
    negativeReadIdx: bool = False
    tooLargeReadIdx: bool = False
    negativeReadPos: bool = False
    tooLargeReadPos: bool = False
    negativeNextReadIdx: bool = False
    tooLargeNextReadIdx: bool = False
    negativeNextReadPos: bool = False
    tooLargeNextReadPos: bool = False
    tooFewBytesForReadName: bool = False
    nonNullTerminatedReadName: bool = False
    nonASCIIReadName: bool = False
    noReadName: bool = False
    emptyReadName: bool = False
    tooFewBytesForCigarOps: bool = False
    invalidCigarOp: bool = False
    emptyMappedCigar: bool = False
    emptyMappedSeq: bool = False
    tooFewRemainingBytesImplied: bool = False
    readsBeforeError: int = 0

    @property
    def call(self) -> bool:
        return False

    def to_mask(self) -> int:
        return sum(1 << i for i, name in enumerate(FLAG_NAMES)
                   if getattr(self, name))

    @staticmethod
    def from_mask(mask: int, reads_before_error: int = 0) -> "Flags":
        return Flags(**{name: bool(mask & (1 << i))
                        for i, name in enumerate(FLAG_NAMES)},
                     readsBeforeError=reads_before_error)

    def true_flags(self) -> list[str]:
        return [name for name in FLAG_NAMES if getattr(self, name)]

    def __str__(self) -> str:
        return ",".join(self.true_flags())
