"""The 19-check error model's bit layout (reference full/error/Flags.scala
bit order) and the two masks the chain walk splits it into."""

from __future__ import annotations

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
