"""Library entry points over whole files (the JAX package's
``spark_bam_tpu/load/api.py``); for now the aggregate alone.

``aggregate`` reduces a query over a BAM to kilobytes of statistics
without materializing records: the whole-file flat view, the boundary
check at every position (``record_starts``: ``full_check_flags`` windows
on the device, or a valid ``.sbi`` sidecar's starts when ``config.cache``
reads), the record parse on the device, the interval and flag
filters on the device (tags on the host), and the fused reduction
(``agg.kernels.aggregate_planes``). It runs on the CUDA device unless
``device`` names another; nothing gives way to the CPU or to the int64
oracle.
"""

from __future__ import annotations

import numpy as np

from spark_bam_tpu_torch.agg.kernels import aggregate_planes
from spark_bam_tpu_torch.agg.plan import AggConfig
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.load.intervals import LociSet
from spark_bam_tpu_torch.load.tpu_load import _apply_filter, record_starts
from spark_bam_tpu_torch.tpu.parser import parse_flat_records


def aggregate(
    path,
    agg: str = "",
    loci: "LociSet | str | None" = None,
    flags_required: int = 0,
    flags_forbidden: int = 0,
    tags_required=(),
    config: Config = Config(),
    chunk: "int | None" = None,
    device=None,
) -> dict:
    """Aggregate statistics of a BAM query. ``agg`` is the compact
    :class:`~spark_bam_tpu_torch.agg.plan.AggConfig` spec (``""``: the
    config's ``agg``, and when that is empty every metric at defaults);
    ``loci``, the flag masks and ``tags_required`` (two-character tag
    names that must all be present) narrow the records. ``chunk`` bounds
    the records a reduction window takes.

    Returns ``{"agg", "rows", "contigs", "metrics"}``: the canonical
    spec, the records selected, ``(name, length)`` per contig and metric
    name → int64 vector, as the JAX package's ``aggregate`` returns."""
    plan = AggConfig.parse(agg or config.agg)
    tags_required = tuple(tags_required or ())
    for t in tags_required:
        if not isinstance(t, str) or len(t) != 2:
            raise ValueError(f"tag names are exactly two chars: {t!r}")
    s = str(path)
    if s.endswith(".cram"):
        raise NotImplementedError(
            "aggregate over CRAM needs the CRAM record loader, which this "
            "port does not have yet")
    if s.endswith(".sam"):
        raise NotImplementedError(
            "aggregate over SAM needs the SAM record loader, which this "
            "port does not have yet")
    if not s.endswith(".bam"):
        raise ValueError(f"Can't tell format of path: {s}")
    dev = resolve_device(device)
    header = read_header(path)
    nc = len(header.contig_lengths)
    view = flatten_file(path)
    starts = np.asarray(
        record_starts(path, config, device=dev, view=view).starts,
        dtype=np.int64)
    batch = parse_flat_records(view.data, starts, device=dev)
    if loci or flags_required or flags_forbidden or tags_required:
        _apply_filter(batch, header, loci, flags_required, flags_forbidden,
                      tags_required=tags_required, device=dev)
    rows = int(np.count_nonzero(batch.columns["valid"]))
    metrics = aggregate_planes(batch.columns, plan, nc, chunk=chunk,
                               device=dev)
    contigs = [(name, int(length)) for name, length in
               zip(header.contig_names, header.contig_lengths)]
    return {
        "agg": plan.canonical(),
        "rows": rows,
        "contigs": contigs,
        "metrics": metrics,
    }
