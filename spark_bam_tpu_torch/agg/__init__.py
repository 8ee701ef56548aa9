"""The aggregation plane: ``plan`` holds the ``AggSpec`` grammar and the
JSON + binary result schema, ``kernels`` the reduction over the parser's
flat planes (the plain carry step; the mesh's agg step is
``parallel.mesh.make_shard_map_agg_step``), ``host`` the int64 oracle.
The entry points are ``load.api.aggregate`` and the ``aggregate``
command."""

from spark_bam_tpu_torch.agg.host import combine, host_aggregate
from spark_bam_tpu_torch.agg.kernels import aggregate_planes
from spark_bam_tpu_torch.agg.plan import (
    DEFAULT_SPEC,
    AggConfig,
    AggSpec,
    decode_result,
    encode_result,
)

__all__ = ["AggConfig", "AggSpec", "DEFAULT_SPEC", "aggregate_planes",
           "combine", "decode_result", "encode_result", "host_aggregate"]
