"""The export loops (reference ``spark_bam_tpu/columnar/export.py``):
record pieces of the device parse in, or a record ``Dataset`` through the
partition executor; a file out.

``export_dataset`` takes the device parse:

The pieces come from ``StreamChecker.ordered_read_batches`` (filtered by
``load.tpu_load.stream_ordered_batches``): each is a parsed
``ReadBatch``, its rows' absolute flat offsets and a floor below which
no later piece holds a row. The valid rows are rendered into schema
batches (``from_parser.render_columns``), held in :class:`FileOrder`
until the floor passes them, and released in file order into the
``Rebatcher``, whose frames go to the sink. Spilled records and deferred
resolutions can arrive after later rows of the stream; the merge puts
them back, so the bytes equal the reference's record-path export.

There is no executor on that route: nothing is retried or quarantined,
so the summary's loss fields are 0, as the reference's are under a strict
policy that meets no fault.

``export_records`` is the reference's ``export_dataset``: each
partition's records become schema batches through ``run_partitions``
under the dataset's ``FaultPolicy`` (retries, hedges, the tolerant
quarantine), a window of about twice the workers' partitions at a time,
re-segmented by the ``Rebatcher``; the summary carries the merged
``JobReport``'s loss fields. ``load/api.py::export`` picks the route from
the policy the caller asked for, before any work.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.columnar.config import ColumnarConfig
from spark_bam_tpu_torch.columnar.from_parser import render_columns
from spark_bam_tpu_torch.columnar.native import container_meta
from spark_bam_tpu_torch.columnar.schema import (
    RecordBatch,
    Rebatcher,
    batches_from_records,
    concat_batches,
    normalize_columns,
    slice_batch,
    take_rows,
)
from spark_bam_tpu_torch.columnar.sink import open_sink
from spark_bam_tpu_torch.parallel.executor import JobReport, run_partitions


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


def _merge_reports(reports: "list[JobReport]") -> JobReport:
    merged = JobReport(partitions=[])
    for rep in reports:
        merged.partitions.extend(rep.partitions)
        merged.lost_records += rep.lost_records
        merged.lost_blocks += rep.lost_blocks
    return merged


def _partition_batch_stream(ds, batch_rows: int, columns, reports: list):
    """Schema batches of every partition of ``ds``, a window of partitions
    at a time through ``run_partitions``; a quarantined partition yields
    nothing (its loss is in the merged report)."""
    compute = ds.compute

    def build(p):
        return list(batches_from_records(compute(p), batch_rows, columns))

    window = max(2 * ds.parallel.num_workers, 4)
    for lo in range(0, len(ds.partitions), window):
        results, report = run_partitions(build, ds.partitions[lo: lo + window],
                                         ds.parallel, ds.policy)
        reports.append(report)
        for part in results:
            if part is not None:
                yield from part


def _write(batches, out, fmt: str, columns, ccfg: ColumnarConfig, contigs,
           report: "JobReport | None") -> dict:
    """``batches`` (a generator, started only once the sink is open, so a
    bad format fails before any work) re-segmented into ``out``; the
    reference's summary, its loss fields from ``report()``'s merged
    report (0 without one)."""
    meta = container_meta(
        columns, codec=ccfg.codec, level=ccfg.level, contigs=contigs
    )
    rebatcher = Rebatcher(ccfg.batch_rows)
    sink = open_sink(str(out), fmt, meta)
    t0 = time.monotonic()
    try:
        for batch in batches:
            for frame in rebatcher.feed(batch):
                sink.write(frame)
        for frame in rebatcher.flush():
            sink.write(frame)
        sink.close()
    except BaseException:
        sink.abort()
        raise
    rep = report() if report is not None else JobReport(partitions=[])
    obs.count("columnar.rows", sink.rows)
    obs.count("columnar.bytes_out", sink.bytes_out)
    return {
        "path": str(out),
        "format": fmt,
        "columns": list(columns),
        "rows": int(sink.rows),
        "batches": int(sink.batches),
        "bytes": int(sink.bytes_out),
        "seconds": time.monotonic() - t0,
        "lost_records": int(rep.lost_records),
        "quarantined": len(rep.quarantined),
        "retries": int(rep.retries),
    }


def export_dataset(
    pieces,
    out,
    fmt: str = "native",
    columns=None,
    ccfg: ColumnarConfig = ColumnarConfig(),
    contigs=None,
) -> dict:
    """Export the records of ``pieces`` (the device parse) to ``out`` in
    ``fmt``; returns the reference's summary (rows, batches, bytes,
    format, path, seconds and the loss fields, 0 here)."""
    columns = normalize_columns(columns if columns is not None else ccfg.columns)
    return _write(ordered_record_batches(pieces, columns), out, fmt, columns,
                  ccfg, contigs, None)


def export_records(
    ds,
    out,
    fmt: str = "native",
    columns=None,
    ccfg: ColumnarConfig = ColumnarConfig(),
    contigs=None,
) -> dict:
    """Export ``ds``'s records to ``out`` in ``fmt`` through the partition
    executor (the reference's ``export_dataset``); the summary's loss
    fields come from the merged ``JobReport``, which ``ds.last_report``
    holds afterwards."""
    columns = normalize_columns(columns if columns is not None else ccfg.columns)
    reports: "list[JobReport]" = []

    def merged() -> JobReport:
        ds.last_report = _merge_reports(reports)
        return ds.last_report

    return _write(_partition_batch_stream(ds, ccfg.batch_rows, columns,
                                          reports),
                  out, fmt, columns, ccfg, contigs, merged)
