"""The export loop (reference ``spark_bam_tpu/columnar/export.py::
export_dataset``) over the device parse: record pieces in, a file out.

The pieces come from ``StreamChecker.ordered_read_batches`` (filtered by
``load.tpu_load.stream_ordered_batches``): each is a parsed
``ReadBatch``, its rows' absolute flat offsets and a floor below which
no later piece holds a row. The valid rows are rendered into schema
batches (``from_parser.render_columns``), held in :class:`FileOrder`
until the floor passes them, and released in file order into the
``Rebatcher``, whose frames go to the sink. Spilled records and deferred
resolutions can arrive after later rows of the stream; the merge puts
them back, so the bytes equal the reference's record-path export.

There is no executor here: nothing is retried or quarantined, so the
summary's loss fields are 0, as the reference's are under its strict
policy.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np

from spark_bam_tpu_torch.columnar.config import ColumnarConfig
from spark_bam_tpu_torch.columnar.from_parser import render_columns
from spark_bam_tpu_torch.columnar.native import container_meta
from spark_bam_tpu_torch.columnar.schema import (
    RecordBatch,
    Rebatcher,
    concat_batches,
    normalize_columns,
    slice_batch,
    take_rows,
)
from spark_bam_tpu_torch.columnar.sink import open_sink


class FileOrder:
    """Rendered rows held until no row below them can arrive, released
    in ascending flat offset."""

    def __init__(self):
        self._pos: "list[np.ndarray]" = []
        self._held: "list[RecordBatch]" = []
        self._released = -1      # the highest offset released so far

    def add(self, positions: np.ndarray, batch: RecordBatch) -> None:
        if not batch.num_rows:
            return
        positions = np.asarray(positions, dtype=np.int64)
        if int(positions.min()) <= self._released:
            raise RuntimeError(
                f"a row at {int(positions.min())} arrived after rows up to "
                f"{self._released} were released")
        self._pos.append(positions)
        self._held.append(batch)

    def release(self, floor: "int | None" = None) -> Iterator[RecordBatch]:
        """Every held row below ``floor`` (all of them for ``None``), in
        offset order, as one batch."""
        if not self._held or (floor is not None and min(
                int(p.min()) for p in self._pos) >= floor):
            return
        pos = np.concatenate(self._pos) if len(self._pos) > 1 else self._pos[0]
        merged = concat_batches(self._held)
        ordered = bool((np.diff(pos) > 0).all())
        order = None if ordered else np.argsort(pos, kind="stable")
        if order is not None:
            pos = pos[order]
        n = len(pos) if floor is None else int(np.searchsorted(pos, floor))
        if order is None:
            out = slice_batch(merged, 0, n)
            rest = slice_batch(merged, n, len(pos)) if n < len(pos) else None
        else:
            out = take_rows(merged, order[:n])
            rest = take_rows(merged, order[n:]) if n < len(pos) else None
        self._pos, self._held = (([pos[n:]], [rest]) if rest is not None
                                  else ([], []))
        self._released = int(pos[n - 1])
        yield out


def ordered_record_batches(pieces, columns) -> Iterator[RecordBatch]:
    """Schema batches of ``pieces``' valid rows (``(abs_starts, ReadBatch,
    floor)`` items), in file order."""
    order = FileOrder()
    for abs_starts, batch, floor in pieces:
        rows = np.flatnonzero(np.asarray(batch.columns["valid"]))
        if len(rows):
            order.add(np.asarray(abs_starts)[rows], RecordBatch(
                render_columns(batch, rows, columns), len(rows)))
        yield from order.release(floor)
    yield from order.release()


def export_dataset(
    pieces,
    out,
    fmt: str = "native",
    columns=None,
    ccfg: ColumnarConfig = ColumnarConfig(),
    contigs=None,
) -> dict:
    """Export the records of ``pieces`` to ``out`` in ``fmt``; returns
    the reference's summary (rows, batches, bytes, format, path, seconds
    and the loss fields). ``pieces`` is iterated only once the sink is
    open, so a bad format fails before any work."""
    columns = normalize_columns(columns if columns is not None else ccfg.columns)
    meta = container_meta(
        columns, codec=ccfg.codec, level=ccfg.level, contigs=contigs
    )
    rebatcher = Rebatcher(ccfg.batch_rows)
    sink = open_sink(str(out), fmt, meta)
    t0 = time.monotonic()
    try:
        for batch in ordered_record_batches(pieces, columns):
            for frame in rebatcher.feed(batch):
                sink.write(frame)
        for frame in rebatcher.flush():
            sink.write(frame)
        sink.close()
    except BaseException:
        sink.abort()
        raise
    return {
        "path": str(out),
        "format": fmt,
        "columns": list(columns),
        "rows": int(sink.rows),
        "batches": int(sink.batches),
        "bytes": int(sink.bytes_out),
        "seconds": time.monotonic() - t0,
        "lost_records": 0,
        "quarantined": 0,
        "retries": 0,
    }
