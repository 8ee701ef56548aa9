"""The columnar outlets (reference ``spark_bam_tpu/columnar/``): record
batches with one schema, built from the device parse, and three file
sinks: the zero-dependency native container (``native.py``), Arrow IPC
and Parquet (``sink.py``; those two need ``pyarrow``), each written
streamingly with an atomic temp file and replace.

``load.api.export`` and the ``export`` command drive it: the streaming
check and parse on the device, the renderings on the host
(``from_parser.py``, vectorized over each batch), rows put back in file
order (``export.FileOrder``), frames of ``Config.columnar``'s row target
(``schema.Rebatcher``) and the sink.

``bin`` is not a column: it derives from ``pos`` and the end, and BAM
files may carry stale values.
"""

from spark_bam_tpu_torch.columnar.config import ColumnarConfig
from spark_bam_tpu_torch.columnar.native import (
    ColumnarFormatError,
    NativeReader,
    batch_frame,
    container_head,
    container_meta,
    end_frame,
    read_container,
)
from spark_bam_tpu_torch.columnar.schema import (
    COLUMNS,
    SCHEMA_VERSION,
    BatchBuilder,
    RecordBatch,
    Rebatcher,
    VarColumn,
    batches_from_records,
    concat_batches,
    iter_rows,
    normalize_columns,
    project,
    slice_batch,
)

__all__ = [
    "COLUMNS",
    "SCHEMA_VERSION",
    "BatchBuilder",
    "ColumnarConfig",
    "ColumnarFormatError",
    "NativeReader",
    "Rebatcher",
    "RecordBatch",
    "VarColumn",
    "batch_frame",
    "batches_from_records",
    "concat_batches",
    "container_head",
    "container_meta",
    "end_frame",
    "iter_rows",
    "normalize_columns",
    "project",
    "read_container",
    "slice_batch",
]
