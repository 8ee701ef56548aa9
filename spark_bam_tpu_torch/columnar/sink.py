"""File sinks: the native container, Arrow IPC and Parquet (reference
``spark_bam_tpu/columnar/sink.py``).

Each writes one record batch at a time into a same-directory temp file
that is renamed into place on close (``core/atomic.AtomicFile``), so a
failed export never leaves a half-written file at the target path.
Arrow and Parquet need ``pyarrow``, imported only when one of them is
asked for; the native container needs nothing.
"""

from __future__ import annotations

import contextlib

from spark_bam_tpu_torch.columnar.native import (
    batch_frame,
    container_head,
    end_frame,
)
from spark_bam_tpu_torch.columnar.schema import (
    VAR_STR_COLUMNS,
    RecordBatch,
    VarColumn,
    empty_batch,
)
from spark_bam_tpu_torch.core.atomic import AtomicFile, map_write_error

FORMATS = ("native", "arrow", "parquet")


class ColumnarUnavailable(RuntimeError):
    """An Arrow or Parquet sink was asked for without pyarrow."""


@contextlib.contextmanager
def _guarded(what: str, path: str):
    """OSErrors escaping a sink's write or commit, classified (the
    exhaustion errnos become ``ResourceExhausted``)."""
    try:
        yield
    except OSError as exc:
        raise map_write_error(exc, what, path=path) from exc


def _pyarrow():
    try:
        import pyarrow
    except ImportError as exc:
        raise ColumnarUnavailable(
            "pyarrow is not installed: arrow/parquet sinks need the "
            "optional extra (pip install spark-bam-tpu[arrow]); the "
            "'native' format has no dependencies"
        ) from exc
    return pyarrow


class NativeSink:
    """Streaming writer of the native container."""

    def __init__(self, out_path: str, meta: dict):
        self.meta = meta
        self.out_path = str(out_path)
        self._file = AtomicFile(out_path)
        head = container_head(meta)
        with _guarded("container write", self.out_path):
            self._file.f.write(head)
        self.rows = 0
        self.batches = 0
        self.bytes_out = len(head)

    def write(self, batch: RecordBatch) -> None:
        frame = batch_frame(batch, self.meta)
        with _guarded("container write", self.out_path):
            self._file.f.write(frame)
        self.rows += batch.num_rows
        self.batches += 1
        self.bytes_out += len(frame)

    def close(self) -> None:
        tail = end_frame(self.rows, self.batches)
        with _guarded("container commit", self.out_path):
            self._file.f.write(tail)
            self.bytes_out += len(tail)
            self._file.commit()

    def abort(self) -> None:
        self._file.abort()


def to_arrow_batch(batch: RecordBatch):
    """Zero-copy RecordBatch → ``pyarrow.RecordBatch``."""
    pa = _pyarrow()
    arrays = []
    fields = []
    for name, col in batch.columns.items():
        if isinstance(col, VarColumn):
            typ = pa.large_utf8() if name in VAR_STR_COLUMNS else pa.large_binary()
            arrays.append(pa.Array.from_buffers(
                typ, batch.num_rows,
                [None, pa.py_buffer(col.offsets), pa.py_buffer(col.values)],
            ))
            fields.append(pa.field(name, typ))
        else:
            arrays.append(pa.array(col, type=pa.int32()))
            fields.append(pa.field(name, pa.int32()))
    return pa.record_batch(arrays, schema=pa.schema(fields))


class ArrowSink:
    """Arrow IPC file (Feather v2) through ``RecordBatchFileWriter``."""

    def __init__(self, out_path: str, meta: dict):
        self.pa = _pyarrow()
        self.meta = meta
        self.out_path = str(out_path)
        self._file = AtomicFile(out_path)
        self._writer = None
        self.rows = 0
        self.batches = 0
        self.bytes_out = 0

    def write(self, batch: RecordBatch) -> None:
        ab = to_arrow_batch(batch)
        with _guarded("arrow write", self.out_path):
            if self._writer is None:
                self._writer = self.pa.ipc.new_file(self._file.f, ab.schema)
            self._writer.write_batch(ab)
        self.rows += batch.num_rows
        self.batches += 1

    def close(self) -> None:
        with _guarded("arrow commit", self.out_path):
            if self._writer is None:
                # No batch: still a valid (empty) IPC file with the schema.
                empty = to_arrow_batch(empty_batch(self.meta["columns"]))
                self._writer = self.pa.ipc.new_file(self._file.f, empty.schema)
            self._writer.close()
            self.bytes_out = self._file.f.tell()
            self._file.commit()

    def abort(self) -> None:
        self._file.abort()


class ParquetSink:
    """Parquet through ``pyarrow.parquet.ParquetWriter``, one row group a
    record batch."""

    def __init__(self, out_path: str, meta: dict):
        self.pa = _pyarrow()
        import pyarrow.parquet as pq

        self.pq = pq
        self.meta = meta
        self.out_path = str(out_path)
        self._file = AtomicFile(out_path)
        self._writer = None
        self.rows = 0
        self.batches = 0
        self.bytes_out = 0

    def write(self, batch: RecordBatch) -> None:
        ab = to_arrow_batch(batch)
        with _guarded("parquet write", self.out_path):
            if self._writer is None:
                self._writer = self.pq.ParquetWriter(self._file.f, ab.schema)
            self._writer.write_table(self.pa.Table.from_batches([ab]))
        self.rows += batch.num_rows
        self.batches += 1

    def close(self) -> None:
        with _guarded("parquet commit", self.out_path):
            if self._writer is None:
                ab = to_arrow_batch(empty_batch(self.meta["columns"]))
                self._writer = self.pq.ParquetWriter(self._file.f, ab.schema)
                self._writer.write_table(self.pa.Table.from_batches([ab]))
            self._writer.close()
            self.bytes_out = self._file.f.tell()
            self._file.commit()

    def abort(self) -> None:
        self._file.abort()


def open_sink(out_path: str, fmt: str, meta: dict):
    """The sink of ``fmt``, one of :data:`FORMATS`."""
    if fmt == "native":
        return NativeSink(out_path, meta)
    if fmt == "arrow":
        return ArrowSink(out_path, meta)
    if fmt == "parquet":
        return ParquetSink(out_path, meta)
    raise ValueError(
        f"unknown export format {fmt!r}: expected {' | '.join(FORMATS)}"
    )
