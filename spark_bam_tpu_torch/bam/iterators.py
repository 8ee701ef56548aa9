"""The record stream of a BAM (reference ``spark_bam_tpu/bam/
iterators.py::RecordStream``, strict): every record decoded in file order,
with its virtual position, as the write path's rewrite reads them.

A record whose length prefix or body is malformed raises the guard's typed
error with its position; the reference's tolerant quarantine and resync
come with the port's record path.
"""

from __future__ import annotations

from typing import Iterator

from spark_bam_tpu_torch.bam.header import BamHeader, read_header
from spark_bam_tpu_torch.bam.record import BamRecord
from spark_bam_tpu_torch.bgzf.stream import BlockStream, UncompressedBytes
from spark_bam_tpu_torch.core.guard import (
    LimitExceeded,
    MalformedInputError,
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


class RecordStream:
    """Yields ``(Pos, BamRecord)`` for every record after the header. A
    record cut by the end of the file ends the stream, as in the
    reference."""

    def __init__(self, u: UncompressedBytes, header: BamHeader):
        self.u = u
        self.header = header

    @staticmethod
    def open(ch) -> "RecordStream":
        header = read_header(ch)
        u = UncompressedBytes(BlockStream(ch))
        if u.skip(header.uncompressed_size) != header.uncompressed_size:
            raise EOFError("BAM header runs past the end of the file")
        return RecordStream(u, header)

    def __iter__(self) -> Iterator[tuple[Pos, BamRecord]]:
        lim = current_limits()
        u = self.u
        while True:
            pos = u.cur_pos()
            if pos is None:
                return
            try:
                prefix = u.read_fully(4)
            except EOFError:
                return
            remaining = _check_length_prefix(
                int.from_bytes(prefix, "little", signed=True), lim, pos)
            try:
                body = u.read_fully(remaining)
            except EOFError:
                return
            try:
                rec, _ = BamRecord.decode(prefix + body, limits=lim)
            except MalformedInputError as e:
                if e.pos is None:
                    e.pos = pos
                    e.args = (f"{e} [at {pos}]",)
                raise
            yield pos, rec

    def close(self) -> None:
        self.u.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
