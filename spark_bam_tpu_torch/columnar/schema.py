"""The columnar record schema and its host batches (reference
``spark_bam_tpu/columnar/schema.py``).

Fixed fields are int32 planes; variable-length fields use the Arrow
large-offset layout, an ``int64 (n+1)`` offsets array into one
contiguous ``uint8`` values buffer, so conversion to ``large_utf8`` /
``large_binary`` is zero-copy. ``bin`` is not a column: it derives from
``pos`` and the end, and BAM files may carry stale values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

SCHEMA_VERSION = 1

#: Fixed int32 columns, in canonical order.
FIXED_COLUMNS = (
    "flag", "ref_id", "pos", "mapq", "next_ref_id", "next_pos", "tlen",
)
#: Variable-length columns rendered as text (latin-1).
VAR_STR_COLUMNS = ("name", "cigar", "seq")
#: Variable-length columns kept as raw bytes.
VAR_BYTES_COLUMNS = ("qual", "tags")
VAR_COLUMNS = VAR_STR_COLUMNS + VAR_BYTES_COLUMNS
#: Canonical column order; projections keep it.
COLUMNS = FIXED_COLUMNS + VAR_COLUMNS


def normalize_columns(columns) -> "tuple[str, ...]":
    """A validated projection in canonical order; None or empty gives
    every column."""
    if not columns:
        return COLUMNS
    if isinstance(columns, str):
        columns = [c for c in columns.replace("+", ",").split(",") if c]
    wanted = set()
    for c in columns:
        if c not in COLUMNS:
            raise ValueError(
                f"unknown column {c!r}: expected a subset of "
                f"{', '.join(COLUMNS)}"
            )
        wanted.add(c)
    return tuple(c for c in COLUMNS if c in wanted)


@dataclass
class VarColumn:
    """Arrow-style large-offset layout: values[offsets[i]:offsets[i+1]]."""

    offsets: np.ndarray  # (n+1,) int64
    values: np.ndarray   # (total,) uint8

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def value(self, i: int) -> bytes:
        return bytes(self.values[int(self.offsets[i]): int(self.offsets[i + 1])])


@dataclass
class RecordBatch:
    """One batch: column name → int32 array or :class:`VarColumn`."""

    columns: "dict[str, np.ndarray | VarColumn]"
    num_rows: int

    @property
    def column_names(self) -> "tuple[str, ...]":
        return tuple(self.columns)

    def nbytes(self) -> int:
        total = 0
        for col in self.columns.values():
            if isinstance(col, VarColumn):
                total += col.offsets.nbytes + col.values.nbytes
            else:
                total += col.nbytes
        return total


class BatchBuilder:
    """Row-at-a-time accumulator of ``BamRecord``s: ``append`` a record,
    ``build`` a batch of the rows so far (and start over). Its renderings
    equal the parser-plane producer's (``columnar/from_parser.py``) byte
    for byte."""

    def __init__(self, columns=None):
        self.columns = normalize_columns(columns)
        self._fixed = {c: [] for c in self.columns if c in FIXED_COLUMNS}
        self._var = {c: bytearray() for c in self.columns if c in VAR_COLUMNS}
        self._offsets = {c: [0] for c in self._var}
        self._rows = 0

    def __len__(self) -> int:
        return self._rows

    def append(self, rec) -> None:
        for c, acc in self._fixed.items():
            acc.append(getattr(rec, c))
        for c, buf in self._var.items():
            if c == "name":
                piece = rec.read_name.encode("latin-1")
            elif c == "cigar":
                piece = rec.cigar_string().encode("latin-1")
            elif c == "seq":
                piece = rec.seq.encode("latin-1")
            elif c == "qual":
                piece = bytes(rec.qual)
            else:  # tags
                piece = bytes(rec.tags)
            buf.extend(piece)
            self._offsets[c].append(len(buf))
        self._rows += 1

    def build(self) -> RecordBatch:
        cols: "dict[str, np.ndarray | VarColumn]" = {}
        for c in self.columns:
            if c in self._fixed:
                cols[c] = np.asarray(self._fixed[c], dtype=np.int32)
            else:
                cols[c] = VarColumn(
                    np.asarray(self._offsets[c], dtype=np.int64),
                    np.frombuffer(bytes(self._var[c]), dtype=np.uint8),
                )
        batch = RecordBatch(cols, self._rows)
        self.__init__(self.columns)
        return batch


def batches_from_records(records: Iterable, batch_rows: int, columns=None
                         ) -> Iterator[RecordBatch]:
    """Lazy batches of a record iterator; items may be bare
    ``BamRecord``s or tuples whose last element is one."""
    builder = BatchBuilder(columns)
    for item in records:
        builder.append(item[-1] if isinstance(item, tuple) else item)
        if len(builder) >= batch_rows:
            yield builder.build()
    if len(builder):
        yield builder.build()


def empty_batch(columns) -> RecordBatch:
    """A zero-row batch of ``columns`` (the reference builds it through
    ``BatchBuilder``, which comes with the record path)."""
    cols: "dict[str, np.ndarray | VarColumn]" = {}
    for c in normalize_columns(columns):
        cols[c] = (VarColumn(np.zeros(1, dtype=np.int64),
                             np.zeros(0, dtype=np.uint8))
                   if c in VAR_COLUMNS else np.zeros(0, dtype=np.int32))
    return RecordBatch(cols, 0)


def slice_batch(batch: RecordBatch, lo: int, hi: int) -> RecordBatch:
    """Rows [lo, hi) of ``batch`` (values buffers re-based to 0)."""
    cols: "dict[str, np.ndarray | VarColumn]" = {}
    for name, col in batch.columns.items():
        if isinstance(col, VarColumn):
            offs = col.offsets[lo: hi + 1]
            base = int(offs[0]) if len(offs) else 0
            cols[name] = VarColumn(
                (offs - base).astype(np.int64),
                col.values[base: int(offs[-1]) if len(offs) else 0],
            )
        else:
            cols[name] = col[lo:hi]
    return RecordBatch(cols, max(hi - lo, 0))


def take_rows(batch: RecordBatch, rows: np.ndarray) -> RecordBatch:
    """The rows ``rows`` of ``batch``, in that order, with one gather per
    column (var columns: their values through a run-length index)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols: "dict[str, np.ndarray | VarColumn]" = {}
    for name, col in batch.columns.items():
        if isinstance(col, VarColumn):
            starts = col.offsets[:-1][rows]
            lens = col.offsets[1:][rows] - starts
            offsets = np.zeros(len(rows) + 1, dtype=np.int64)
            np.cumsum(lens, out=offsets[1:])
            idx = (np.repeat(starts - offsets[:-1], lens)
                   + np.arange(int(offsets[-1]), dtype=np.int64))
            cols[name] = VarColumn(offsets, col.values[idx])
        else:
            cols[name] = col[rows]
    return RecordBatch(cols, len(rows))


def concat_batches(batches: "list[RecordBatch]") -> RecordBatch:
    if len(batches) == 1:
        return batches[0]
    names = batches[0].column_names
    cols: "dict[str, np.ndarray | VarColumn]" = {}
    for name in names:
        parts = [b.columns[name] for b in batches]
        if isinstance(parts[0], VarColumn):
            offsets = [parts[0].offsets]
            base = int(parts[0].offsets[-1])
            for p in parts[1:]:
                offsets.append(p.offsets[1:] + base)
                base += int(p.offsets[-1])
            cols[name] = VarColumn(
                np.concatenate(offsets),
                np.concatenate([p.values for p in parts]),
            )
        else:
            cols[name] = np.concatenate(parts)
    return RecordBatch(cols, sum(b.num_rows for b in batches))


class Rebatcher:
    """Re-segment a batch stream into frames of exactly ``batch_rows``
    rows (the last one partial), so frame boundaries depend only on the
    row stream and the container's bytes are reproducible."""

    def __init__(self, batch_rows: int):
        self.batch_rows = max(int(batch_rows), 1)
        self._pending: "list[RecordBatch]" = []
        self._rows = 0

    def feed(self, batch: RecordBatch) -> Iterator[RecordBatch]:
        if batch.num_rows == 0:
            return
        self._pending.append(batch)
        self._rows += batch.num_rows
        while self._rows >= self.batch_rows:
            merged = concat_batches(self._pending)
            yield slice_batch(merged, 0, self.batch_rows)
            rest = slice_batch(merged, self.batch_rows, merged.num_rows)
            self._pending = [rest] if rest.num_rows else []
            self._rows = rest.num_rows

    def flush(self) -> Iterator[RecordBatch]:
        if self._rows:
            yield concat_batches(self._pending)
        self._pending, self._rows = [], 0


def project(batch: RecordBatch, columns) -> RecordBatch:
    cols = normalize_columns(columns)
    return RecordBatch({c: batch.columns[c] for c in cols}, batch.num_rows)


def iter_rows(batch: RecordBatch) -> Iterator[dict]:
    """Row dicts (str columns decoded latin-1)."""
    for i in range(batch.num_rows):
        row = {}
        for name, col in batch.columns.items():
            if isinstance(col, VarColumn):
                v = col.value(i)
                row[name] = v.decode("latin-1") if name in VAR_STR_COLUMNS else v
            else:
                row[name] = int(col[i])
        yield row
