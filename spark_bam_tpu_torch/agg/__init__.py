"""The aggregation plane: ``plan`` holds the ``AggSpec`` grammar and the
JSON + binary result schema, ``kernels`` the reduction over the parser's
flat planes (the plain carry step; the mesh's agg step is
``parallel.mesh.make_shard_map_agg_step``, exported here too), ``host``
the int64 oracle. The entry points are ``load.api.aggregate`` and the
``aggregate`` command."""

from spark_bam_tpu_torch.agg.host import (
    columns_from_records,
    combine,
    host_aggregate,
)
from spark_bam_tpu_torch.agg.kernels import aggregate_planes
from spark_bam_tpu_torch.agg.plan import (
    DEFAULT_SPEC,
    AggConfig,
    AggSpec,
    decode_result,
    encode_result,
)

__all__ = ["AggConfig", "AggSpec", "DEFAULT_SPEC", "aggregate_planes",
           "columns_from_records", "combine", "decode_result",
           "encode_result", "host_aggregate", "make_shard_map_agg_step"]


def __getattr__(name):
    # The mesh's agg step lives in parallel/mesh.py, which imports this
    # package: bound on first use.
    if name == "make_shard_map_agg_step":
        from spark_bam_tpu_torch.parallel.mesh import make_shard_map_agg_step

        return make_shard_map_agg_step
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
