"""Record and record-position streams of a BAM (reference
``spark_bam_tpu/bam/iterators.py``; RecordIterator, PosStream,
RecordStream and SeekableRecordIterator.scala): every record after the
header in file order, with its virtual position.

- ``PosStream`` walks the records' length prefixes without decoding;
- ``RecordStream`` decodes each record. Strict (over a strict block
  stream) it raises the guard's typed error with the record's position.
  Over a tolerant block stream a record whose body fails to decode is
  quarantined (its length prefix already put the stream at the next
  record: ``quarantined`` lists it and ``guard.quarantined_records``
  counts it), and a length prefix no record can have raises one
  ``RecordGapError``, so the load layer finds the next provable record
  boundary with the checker (``load/api.py``);
- ``SeekablePosStream`` / ``SeekableRecordStream`` add ``seek``, clamped
  so a position inside the header reads from the first record.

A record cut by the end of the file ends the stream, as in the reference.
"""

from __future__ import annotations

from typing import Iterator

from spark_bam_tpu_torch.bam.header import BamHeader, read_header
from spark_bam_tpu_torch.bam.record import BamRecord
from spark_bam_tpu_torch.bgzf.stream import (
    BlockStream,
    SeekableBlockStream,
    SeekableUncompressedBytes,
    UncompressedBytes,
)
from spark_bam_tpu_torch.core import guard
from spark_bam_tpu_torch.core.guard import (
    LimitExceeded,
    MalformedInputError,
    RecordGapError,
    StructurallyInvalid,
    current_limits,
)
from spark_bam_tpu_torch.core.pos import Pos

#: Smallest well-formed record body: 32 fixed field bytes + the name's NUL.
MIN_RECORD_BODY = 33


def _check_length_prefix(remaining: int, lim, pos: Pos) -> int:
    """Validate a record's length prefix before it sizes a read."""
    if remaining < MIN_RECORD_BODY:
        raise StructurallyInvalid(
            f"BAM record block_size {remaining} smaller than its fixed "
            f"fields", pos=pos,
        )
    if remaining > lim.max_record_bytes:
        raise LimitExceeded(
            f"BAM record block_size {remaining} exceeds limit "
            f"{lim.max_record_bytes}", pos=pos,
        )
    return remaining


def _after_header(ch, u: UncompressedBytes) -> BamHeader:
    """Read the header of ``ch`` and move ``u`` past it."""
    header = read_header(ch)
    if u.skip(header.uncompressed_size) != header.uncompressed_size:
        raise EOFError("BAM header runs past the end of the file")
    return header


class _RecordStreamBase:
    """Owns the uncompressed stream and the header."""

    def __init__(self, u: UncompressedBytes, header: BamHeader):
        self.u = u
        self.header = header

    def cur_pos(self) -> Pos | None:
        return self.u.cur_pos()

    def close(self) -> None:
        self.u.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PosStream(_RecordStreamBase):
    """Yields the virtual position of every record start, without
    decoding. A length prefix cut by the end of the file raises
    ``EOFError`` (the reference's getInt, PosStream.scala:18); a cut
    elsewhere ends the stream."""

    @classmethod
    def open(cls, ch) -> "PosStream":
        u = UncompressedBytes(BlockStream(ch))
        return cls(u, _after_header(ch, u))

    def __iter__(self) -> Iterator[Pos]:
        lim = current_limits()
        u = self.u
        while True:
            pos = u.cur_pos()
            if pos is None:
                return
            remaining = _check_length_prefix(u.read_i32(), lim, pos)
            u.skip(remaining)
            yield pos


class RecordStream(_RecordStreamBase):
    """Yields ``(Pos, BamRecord)`` for every record after the header."""

    def __init__(self, u: UncompressedBytes, header: BamHeader):
        super().__init__(u, header)
        self.quarantined: list[tuple[Pos, MalformedInputError]] = []

    @classmethod
    def open(cls, ch) -> "RecordStream":
        u = UncompressedBytes(BlockStream(ch))
        return cls(u, _after_header(ch, u))

    def __iter__(self) -> Iterator[tuple[Pos, BamRecord]]:
        lim = current_limits()
        u = self.u
        tolerant = getattr(u.stream, "tolerant", False)
        while True:
            pos = u.cur_pos()
            if pos is None:
                return
            try:
                prefix = u.read_fully(4)
            except EOFError:
                return
            remaining = int.from_bytes(prefix, "little", signed=True)
            try:
                _check_length_prefix(remaining, lim, pos)
            except MalformedInputError as e:
                if not tolerant:
                    raise
                self.quarantined.append((pos, e))
                guard.note_quarantined_records()
                raise RecordGapError(pos, str(e)) from e
            try:
                body = u.read_fully(remaining)
            except EOFError:
                return
            try:
                rec, _ = BamRecord.decode(prefix + body, limits=lim)
            except MalformedInputError as e:
                if not tolerant:
                    if e.pos is None:
                        e.pos = pos
                        e.args = (f"{e} [at {pos}]",)
                    raise
                # The prefix was sane, so the stream already stands at
                # the next record: lose exactly this one and go on.
                self.quarantined.append((pos, e))
                guard.note_quarantined_records()
                continue
            yield pos, rec


class _Seekable:
    u: SeekableUncompressedBytes
    header: BamHeader

    @classmethod
    def open(cls, ch, tolerant: bool = False):
        u = SeekableUncompressedBytes(SeekableBlockStream(ch,
                                                          tolerant=tolerant))
        return cls(u, _after_header(ch, u))

    def seek(self, pos: Pos) -> None:
        """Seek, clamped so positions inside the header read from the
        first record (reference SeekableRecordIterator.scala:183-198)."""
        end = self.header.end_pos
        if (pos.block_pos, pos.offset) < (end.block_pos, end.offset):
            pos = end
        self.u.seek(pos)


class SeekablePosStream(_Seekable, PosStream):
    pass


class SeekableRecordStream(_Seekable, RecordStream):
    pass
