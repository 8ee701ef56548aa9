"""Host orchestration (reference ``spark_bam_tpu/parallel/``): the
partition executor with retries, hedges and quarantine (``executor.py``),
device meshes over ``torch.distributed`` (``mesh.py``, ``multihost.py``)
and the sharded workloads (``stream_mesh.py``)."""

from spark_bam_tpu_torch.parallel.executor import (
    Attempt,
    JobReport,
    ParallelConfig,
    PartitionReport,
    last_report,
    map_partitions,
    reset_last_report,
    run_partitions,
)

__all__ = [
    "Attempt",
    "JobReport",
    "ParallelConfig",
    "PartitionReport",
    "last_report",
    "map_partitions",
    "reset_last_report",
    "run_partitions",
]
