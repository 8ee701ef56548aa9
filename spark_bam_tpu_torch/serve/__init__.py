"""The split service: a long-running daemon over the device mesh
(reference ``spark_bam_tpu/serve/``; its newline-JSON protocol unchanged).

It keeps the mesh's steps, flat views, parsed records and the ``.sbi``
index tier warm across requests, coalesces concurrent count rows into one
device dispatch per tick, and sheds load with typed responses when a
queue is full. ``python -m spark_bam_tpu_torch serve --listen ADDR``
starts it; ``ServeClient`` queries it.
"""

from spark_bam_tpu_torch.serve.admission import AdmissionGate, Overloaded
from spark_bam_tpu_torch.serve.batcher import Batcher, RowTask
from spark_bam_tpu_torch.serve.client import ServeClient, ServeClientError
from spark_bam_tpu_torch.serve.config import MAX_CONTIGS, ServeConfig
from spark_bam_tpu_torch.serve.protocol import (
    OPS,
    ProtocolError,
    decode_request,
    encode,
    error_response,
    ok_response,
)
from spark_bam_tpu_torch.serve.server import (
    ServeAddress,
    ServerThread,
    serve_forever,
    start_server,
)
from spark_bam_tpu_torch.serve.service import ServiceError, SplitService
from spark_bam_tpu_torch.serve.shm import (
    SegmentReader,
    SegmentWriter,
    ShmError,
    sweep_orphans,
)

__all__ = [
    "AdmissionGate",
    "Batcher",
    "MAX_CONTIGS",
    "OPS",
    "Overloaded",
    "ProtocolError",
    "RowTask",
    "SegmentReader",
    "SegmentWriter",
    "ServeAddress",
    "ServeClient",
    "ServeClientError",
    "ServeConfig",
    "ServerThread",
    "ServiceError",
    "ShmError",
    "SplitService",
    "decode_request",
    "encode",
    "error_response",
    "ok_response",
    "serve_forever",
    "start_server",
    "sweep_orphans",
]
