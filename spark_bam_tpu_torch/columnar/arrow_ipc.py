"""The Arrow IPC *stream* format of record batches (reference
``spark_bam_tpu/columnar/arrow_ipc.py``): one message per frame, the
schema first, then a message per record batch, then the 8-byte
end-of-stream marker. ``b"".join(frames)`` opens with
``pyarrow.ipc.open_stream``. Needs ``pyarrow``, imported when called.
"""

from __future__ import annotations

from spark_bam_tpu_torch.columnar.schema import (
    VAR_BYTES_COLUMNS,
    VAR_STR_COLUMNS,
)
from spark_bam_tpu_torch.columnar.sink import _pyarrow, to_arrow_batch

#: Arrow IPC end-of-stream marker (continuation sentinel and a zero
#: metadata length).
EOS = b"\xff\xff\xff\xff\x00\x00\x00\x00"


def arrow_available() -> bool:
    try:
        _pyarrow()
    except Exception:
        return False
    return True


def arrow_schema(columns):
    """The projection's Arrow schema from the static type tables: int32
    fixed planes, ``large_utf8`` / ``large_binary`` var planes."""
    pa = _pyarrow()
    fields = []
    for name in columns:
        if name in VAR_STR_COLUMNS:
            typ = pa.large_utf8()
        elif name in VAR_BYTES_COLUMNS:
            typ = pa.large_binary()
        else:
            typ = pa.int32()
        fields.append(pa.field(name, typ))
    return pa.schema(fields)


def stream_frames(batch, batch_rows: int,
                  columns) -> "tuple[list[bytes], int]":
    """``batch``'s valid rows (a ReadBatch) as IPC stream frames:
    ``[schema, record-batch..., EOS]``. Returns ``(frames, rows)``."""
    from spark_bam_tpu_torch.columnar.from_parser import (
        read_batch_to_record_batches,
    )

    frames = [bytes(arrow_schema(columns).serialize())]
    rows = 0
    for rb in read_batch_to_record_batches(batch, batch_rows, columns):
        frames.append(bytes(to_arrow_batch(rb).serialize()))
        rows += rb.num_rows
    frames.append(EOS)
    return frames, rows


def open_stream(buf):
    """``open_stream(b"".join(frames))``, zero-copy over bytes or a
    memoryview."""
    pa = _pyarrow()
    return pa.ipc.open_stream(pa.py_buffer(buf))
