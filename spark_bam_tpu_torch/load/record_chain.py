"""The export's record set: the record path's chains over the checker's
starts (reference ``spark_bam_tpu/load/api.py::_iter_split_records``).

The reference exports what its record path reads: each file split (32 MiB
of compressed bytes unless ``Config.split_size`` says otherwise) starts at
its first record start (the header's end in the split that holds it, else
the first checker-accepted position at or past the split's first block)
and follows the records by their ``block_size`` until a record's block
lies at or past the split's end. A record the checker refuses is still
read when a chain runs through it, and an accepted position that no chain
reaches is not.

``RecordChain.follow`` applies that rule to the checker's ordered pieces
(``StreamChecker.ordered_read_batches``): it holds the pieces until their
floor has passed them, walks each split's chain over their rows in file
order, marks accepted rows that lie off the chain invalid, and decodes the
chained records the checker refused from the seekable stream, as extra
pieces. Where every record is accepted, the chain runs through every row
and the walk is a vectorized comparison of each row's end with the next
row's start.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from spark_bam_tpu_torch.bam.iterators import _check_length_prefix
from spark_bam_tpu_torch.bgzf.flat import metas_block_table, pos_of_flat_tables
from spark_bam_tpu_torch.bgzf.stream import (
    SeekableBlockStream,
    SeekableUncompressedBytes,
)
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.guard import current_limits
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.load.splits import file_splits

#: Past every flat offset: a chain that the end of the file cut.
_END = np.iinfo(np.int64).max


class RecordChain:
    """The record path's split chains over one ``StreamChecker``'s
    pieces; ``split_size`` is the record loader's raw split size."""

    def __init__(self, checker, split_size: int):
        self.checker = checker
        self.total = checker.total
        metas = checker.pipeline.metas
        self.block_starts, self.block_flat = metas_block_table(metas)
        header = checker.header
        he_block = header.end_pos.block_pos
        #: Per split with a block: ``(fixed start or None, lo, hi)``: the
        #: chain starts at ``fixed`` or at the first accepted row at or
        #: past ``lo``, and reads records below ``hi``.
        self.segments: list[tuple[int | None, int, int]] = []
        for split in file_splits(checker.path, split_size):
            hi = self._flat_of_block_at(split.end)
            if split.start <= he_block < split.end:
                self.segments.append((checker.header_end_abs, 0, hi))
                continue
            i = int(np.searchsorted(self.block_starts, split.start))
            if i == len(self.block_starts) or \
                    self.block_starts[i] >= split.end:
                continue
            self.segments.append((None, int(self.block_flat[i]), hi))
        self._seg = 0
        self._nxt: int | None = None
        self._stream = None
        self._low = 0             # the floor of the last item yielded

    def _flat_of_block_at(self, compressed: int) -> int:
        """The flat offset of the first block starting at or past
        ``compressed`` (the file's end when none does)."""
        i = int(np.searchsorted(self.block_starts, compressed))
        return self.total if i == len(self.block_starts) \
            else int(self.block_flat[i])

    def _size_at(self, flat: int) -> int | None:
        """The ``block_size`` of the record at ``flat``, validated as the
        strict record stream validates it; None when the file ends inside
        the record (the stream ends there)."""
        if flat + 4 > self.total:
            return None
        if self._stream is None:
            self._stream = SeekableUncompressedBytes(
                SeekableBlockStream(open_channel(self.checker.path)))
        pos = Pos(*pos_of_flat_tables(self.block_starts, self.block_flat,
                                      flat))
        self._stream.seek(pos)
        size = _check_length_prefix(
            int.from_bytes(self._stream.read(4), "little", signed=True),
            current_limits(), pos)
        return size if flat + 4 + size <= self.total else None

    def _walk(self, a: np.ndarray, z: np.ndarray, floor: int | None
              ) -> tuple[np.ndarray, list[int]]:
        """Advance the chains over the sorted accepted rows ``a`` (sizes
        ``z``), every row below ``floor`` (``None``: the end of the file)
        known. Returns the rows to keep and the refused records read."""
        keep = np.ones(len(a), dtype=bool)
        extras: list[int] = []
        ends = a + 4 + z
        # Rows whose record does not end where the next row starts.
        breaks = np.flatnonzero(ends[:-1] != a[1:])
        limit = _END if floor is None else floor
        i = 0
        while self._seg < len(self.segments):
            fixed, lo, hi = self.segments[self._seg]
            if self._nxt is None:
                if fixed is not None:
                    self._nxt = fixed
                else:
                    j = i + int(np.searchsorted(a[i:], lo))
                    keep[i:j] = False
                    i = j
                    if j == len(a):
                        if floor is None:   # no accepted row: no records
                            self._seg += 1
                            continue
                        return keep, extras
                    self._nxt = int(a[j])
                if self._nxt >= hi:
                    self._seg += 1
                    self._nxt = None
                    continue
            while self._nxt < hi:
                if self._nxt >= limit:
                    keep[i:] = False  # every row left lies below the chain
                    return keep, extras
                j = i + int(np.searchsorted(a[i:], self._nxt))
                keep[i:j] = False     # accepted, but inside a chained record
                i = j
                if i < len(a) and a[i] == self._nxt:
                    # A run of rows that chain into each other, cut before
                    # the split's end.
                    b = int(np.searchsorted(breaks, i))
                    t = int(breaks[b]) if b < len(breaks) else len(a) - 1
                    t = min(t, i + int(np.searchsorted(a[i:], hi)) - 1)
                    self._nxt = int(ends[t])
                    i = t + 1
                else:
                    size = self._size_at(self._nxt)
                    if size is None:
                        self._nxt = _END
                        break
                    extras.append(self._nxt)
                    self._nxt += 4 + size
            self._seg += 1
            self._nxt = None
        keep[i:] = False
        return keep, extras

    def follow(self, pieces) -> Iterator[tuple]:
        """``(abs_starts, batch, floor)`` pieces of the chained records:
        the checker's pieces, each yielded once its floor has passed all
        its rows, with off-chain rows marked invalid, and the refused
        chained records decoded from the stream. Pieces come in the order
        their rows are settled, each with a floor below which no later
        piece holds a row."""
        held: list[list] = []     # [abs_starts, batch, rows settled]
        settled = 0               # every row below it has been walked
        try:
            for abs_starts, batch, floor in pieces:
                held.append([np.asarray(abs_starts, dtype=np.int64),
                             batch, 0])
                yield from self._settle(held, max(settled, floor))
                settled = max(settled, floor)
            yield from self._settle(held, None)
        finally:
            if self._stream is not None:
                self._stream.close()
                self._stream = None

    def _settle(self, held: list, floor: int | None) -> Iterator[tuple]:
        parts = []
        for k, (starts, batch, done) in enumerate(held):
            cut = len(starts) if floor is None else int(
                np.searchsorted(starts, floor))
            if cut > done:
                parts.append((k, done, cut))
        none = [np.empty(0, np.int64)]
        a = np.concatenate([held[k][0][d:c] for k, d, c in parts] + none)
        z = np.concatenate([
            np.asarray(held[k][1].columns["block_size"][d:c], np.int64)
            for k, d, c in parts] + none)
        order = np.argsort(a, kind="stable")
        keep_sorted, extras = self._walk(a[order], z[order], floor)
        keep = np.empty_like(keep_sorted)
        keep[order] = keep_sorted
        at = 0
        for k, d, c in parts:
            drop = ~keep[at: at + c - d]
            at += c - d
            if drop.any():
                cols = held[k][1].columns
                valid = np.array(cols["valid"], dtype=bool)
                valid[d:c] &= ~drop
                cols["valid"] = valid
            held[k][2] = c
        out = []
        if extras:
            at = 0
            for batch in self.checker._decode_spills(extras):
                n = len(batch.starts)
                out.append((np.asarray(extras[at: at + n]), batch))
                at += n
        out += [(p[0], p[1]) for p in held if p[2] == len(p[0])]
        held[:] = [p for p in held if p[2] < len(p[0])]
        # No later piece holds a row below the floor or below a held
        # piece's first row.
        low = self.total if floor is None else floor
        for starts, _batch, _done in held:
            low = min(low, int(starts[0]))
        # Every item but the last keeps the previous floor: the rows of
        # this round come in several items.
        for k, (starts, batch) in enumerate(out):
            yield starts, batch, low if k == len(out) - 1 else self._low
        if out:
            self._low = low
