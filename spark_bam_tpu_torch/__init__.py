"""spark-bam on PyTorch and CUDA: the count-reads, full-check and load
paths of ``spark_bam_tpu`` with their DEFLATE tokenizer, LZ77 resolve,
funnel prefilter and full flag pass as CUDA kernels written for Hopper
(``csrc/``).

The load path (``load/tpu_load.py``) parses each window's records on the
device window the check already holds, filters them by loci, flags and
tags, and decodes records that outrun their window exactly on the host:
``stream_read_batches``, ``load_reads_columnar``, ``record_starts``,
``record_starts_streaming`` and ``count_reads_tpu``.

The resident count (``StreamChecker.count_reads_resident``) packs windows
into device-resident chunks and counts each chunk with one dispatch:
``count_scan``, which ``make_count_scan`` runs on a CUDA device as one
CUDA graph replay a chunk (``CountScanGraphs``).

The sharded workloads (``parallel/``) spread one BAM over a mesh of
devices and processes (``torch.distributed``): ``count_reads_sharded``,
``check_bam_sharded``, ``full_check_summary_sharded`` (the full-check
report reduced on the devices) and ``host_shard_plan``, over ``make_mesh``'s
``Mesh``.

The aggregate (``load/api.py``: ``aggregate``; ``agg/``) reduces a BAM
query to count, flagstat, MAPQ, template-length and binned coverage
vectors on the device, one window of parsed records at a time, or across
a mesh through ``MeshSteps.agg_step``.

The export (``load/api.py``: ``export``; ``columnar/``) writes a BAM
query's records as columnar record batches (the native container, Arrow
IPC or Parquet), built from each window's device parse and put back in
file order.

Split planning (``load/splits.py``: ``split_plan``, ``spark_bam_splits``;
``load/boundary.py``) resolves each raw split's first record start on the
device, and the ``.sbi`` split-index cache (``sbi/``) keeps plans, block
tables and record starts, so warm ``compute-splits``, ``record_starts``
and ``aggregate`` calls do no checker work.

The package imports torch, numpy and the standard library only; entry
points run on the CUDA device unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version instead.
"""

from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.load.api import aggregate, export
from spark_bam_tpu_torch.load.splits import spark_bam_splits, split_plan
from spark_bam_tpu_torch.load.tpu_load import (
    count_reads_tpu,
    load_reads_columnar,
    record_starts,
    record_starts_streaming,
    stream_read_batches,
)
from spark_bam_tpu_torch.parallel.mesh import Mesh, make_mesh
from spark_bam_tpu_torch.parallel.stream_mesh import (
    check_bam_sharded,
    count_reads_sharded,
    full_check_summary_sharded,
    host_shard_plan,
)
from spark_bam_tpu_torch.tpu.checker import (
    CountScanGraphs,
    TpuChecker,
    count_scan,
    make_count_scan,
)
from spark_bam_tpu_torch.tpu.stream_check import (
    StreamChecker,
    full_check_summary_streaming,
)

__all__ = ["Config", "CountScanGraphs", "Mesh", "Pos", "StreamChecker",
           "TpuChecker", "aggregate", "check_bam_sharded",
           "count_reads_sharded", "count_reads_tpu", "count_scan", "export",
           "full_check_summary_sharded", "full_check_summary_streaming", "host_shard_plan",
           "load_reads_columnar", "make_count_scan", "make_mesh",
           "record_starts", "record_starts_streaming", "spark_bam_splits",
           "split_plan", "stream_read_batches"]
