"""BAM header: magic, SAM text, contig dictionary (reference
bam/header/Header.scala). Only what the port's paths need is kept: the
contig names and lengths, the header's size in uncompressed bytes (the
flat offset of the first record), ``end_pos``, the first record's
virtual position, which owns the first split, and the SAM text, which the
write path copies. Hostile bytes raise the reference's typed errors
(``core/guard.py``), so the decode fuzz classes both packages alike."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np

from spark_bam_tpu_torch.bgzf.stream import BlockStream, UncompressedBytes
from spark_bam_tpu_torch.core.channel import ByteChannel, open_channel
from spark_bam_tpu_torch.core.guard import (
    StructurallyInvalid,
    TruncatedInput,
    check_count,
    current_limits,
)
from spark_bam_tpu_torch.core.pos import Pos


class ContigLengths(Mapping[int, tuple[str, int]]):
    """The reference's contig dictionary: reference index → (name, length),
    in index order (reference ContigLengths.scala). The port's
    ``BamHeader`` carries ``contig_names`` and the int32 ``contig_lengths``
    array the device path uploads; ``contig_lengths(path)`` or
    ``ContigLengths.of(header)`` gives this mapping."""

    def __init__(self, entries):
        self._entries: dict[int, tuple[str, int]] = dict(entries)

    @staticmethod
    def of(header: "BamHeader") -> "ContigLengths":
        return ContigLengths(enumerate(zip(
            header.contig_names, (int(n) for n in header.contig_lengths))))

    def __getitem__(self, idx: int) -> tuple[str, int]:
        return self._entries[idx]

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def name(self, idx: int) -> str:
        return "*" if idx < 0 else self._entries[idx][0]

    def lengths_list(self) -> list[int]:
        """Lengths in index order."""
        return [self._entries[i][1] for i in range(len(self._entries))]

    def __repr__(self) -> str:
        items = ", ".join(f"{i}:{n}({ln})"
                          for i, (n, ln) in self._entries.items())
        return f"ContigLengths({items})"

    def __eq__(self, other):
        return isinstance(other, ContigLengths) \
            and self._entries == other._entries


@dataclass(frozen=True)
class BamHeader:
    contig_names: tuple[str, ...]
    contig_lengths: np.ndarray  # int32, index order
    uncompressed_size: int      # uncompressed bytes the header occupies
    # Virtual position of the first record: the next non-empty block's
    # start when the header ends on a block's end; Pos(0, 0) for a BAM
    # with no records (the reference's convention).
    end_pos: Pos = Pos(0, 0)
    text: str = ""              # the SAM text, trailing NULs stripped


def read_header(path) -> BamHeader:
    """The header of the BAM at ``path`` (a local path or a URL), or on an
    open channel of any kind."""
    if isinstance(path, ByteChannel):
        return _parse(path)
    with open_channel(path) as ch:
        return _parse(ch)


def _parse(ch) -> BamHeader:
    """The header from the block stream of ``ch`` (left open), as the
    reference's ``parse_header`` reads it: every length and count is
    checked against the active ``DecodeLimits`` before it sizes a read or
    a loop, bad magic raises ``StructurallyInvalid``, and bytes that end
    inside the header ``TruncatedInput``; a damaged block raises what the
    block stream raises."""
    lim = current_limits()
    u = UncompressedBytes(BlockStream(ch))
    magic = u.read_fully(4)
    if magic != b"BAM\x01":
        raise StructurallyInvalid(f"Not a BAM: bad magic {magic!r}")
    try:
        text_len = check_count(u.read_i32(), "BAM header text_len",
                               lim.max_header_text)
        text = u.read_fully(text_len).decode("latin-1").rstrip("\x00")
        num_refs = check_count(u.read_i32(), "BAM header num_refs",
                               lim.max_refs)
        names, lengths = [], []
        for idx in range(num_refs):
            name_len = check_count(u.read_i32(), f"BAM ref {idx} name_len",
                                   lim.max_name_len)
            names.append(
                u.read_fully(name_len).rstrip(b"\x00").decode("latin-1"))
            lengths.append(check_count(u.read_i32(), f"BAM ref {idx} length"))
    except EOFError as e:
        # A header is never optional: bytes that end inside it are a
        # malformed file, not a clean truncation.
        raise TruncatedInput(f"BAM header truncated: {e}") from e
    end_pos = u.cur_pos()
    return BamHeader(tuple(names), np.array(lengths, dtype=np.int32),
                     u.tell(), end_pos if end_pos is not None else Pos(0, 0),
                     text)


def contig_lengths(path) -> ContigLengths:
    """The contig dictionary of the BAM at ``path`` (reference
    ``bam/header.py::contig_lengths``)."""
    return ContigLengths.of(read_header(path))
