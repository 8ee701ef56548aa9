"""Library entry points over whole files (the JAX package's
``spark_bam_tpu/load/api.py``): the aggregate, the columnar export and
the resolved split starts.

``aggregate`` reduces a query over a BAM to kilobytes of statistics
without materializing records: the whole-file flat view, the boundary
check at every position (``record_starts``: ``full_check_flags`` windows
on the device, or a valid ``.sbi`` sidecar's starts when ``config.cache``
reads), the record parse on the device, the interval and flag
filters on the device (tags on the host), and the fused reduction
(``agg.kernels.aggregate_planes``). It runs on the CUDA device unless
``device`` names another; nothing gives way to the CPU or to the int64
oracle.

``export`` writes a BAM query's records as columnar record batches (the
native container, Arrow IPC or Parquet): the streaming check and record
parse of every window on the device with the interval and flag filters
there (``stream_ordered_batches``), the renderings and encoding on the
host (``columnar/``).

``split_starts`` gives every raw file split its first record start, what
the serve daemon answers ``plan`` with: from a valid ``.sbi`` split plan
when ``config.cache`` reads (no resolution at all), else each split
resolved on the device (``load/boundary.py``), written through when the
cache writes.
"""

from __future__ import annotations

import numpy as np

from spark_bam_tpu_torch.agg.kernels import aggregate_planes
from spark_bam_tpu_torch.agg.plan import AggConfig
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.core.config import Config, parse_bytes
from spark_bam_tpu_torch.core.faults import with_retries
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.load.intervals import LociSet
from spark_bam_tpu_torch.load.splits import FileSplit, file_splits
from spark_bam_tpu_torch.load.tpu_load import (
    _apply_filter,
    record_starts,
    stream_ordered_batches,
)
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


def export(
    path,
    out,
    loci: "LociSet | str | None" = None,
    fmt: str = "native",
    columns=None,
    config: Config = Config(),
    flags_required: int = 0,
    flags_forbidden: int = 0,
    device=None,
) -> dict:
    """Export a BAM's records as columnar record batches to ``out``:
    ``fmt`` is ``native`` (the zero-dependency container), ``arrow`` (an
    IPC file) or ``parquet`` (those two need ``pyarrow``). ``loci`` keeps
    the records that overlap it, the flag masks narrow them, ``columns``
    projects the schema and ``config.columnar`` sets the row target and
    the container's codec. The bytes equal the JAX package's ``export``
    of the same query. Returns its summary: path, format, columns, rows,
    batches, bytes, seconds and the loss fields (0: nothing is retried or
    quarantined)."""
    from spark_bam_tpu_torch.columnar.export import export_dataset

    s = str(path)
    if s.endswith((".cram", ".sam")):
        raise NotImplementedError(
            f"export of {s.rsplit('.', 1)[-1].upper()} needs the SAM and "
            "CRAM loaders (ROADMAP Queue 1 item 16), which this port does "
            "not have yet")
    dev = resolve_device(device)
    header = read_header(path)
    contigs = [(str(name), int(length)) for name, length in
               zip(header.contig_names, header.contig_lengths)]
    ccfg = config.columnar_config
    pieces = stream_ordered_batches(path, config, loci, flags_required,
                                    flags_forbidden, dev)
    return export_dataset(pieces, out, fmt=fmt, columns=columns, ccfg=ccfg,
                          contigs=contigs)


def _consult_split_cache(path, splits, header, config: Config, size: int,
                         device) -> dict:
    """``{split: Pos | None}`` of cache-served (or freshly built and
    written-through) record starts; ``{}`` when the cache is off or cannot
    serve these splits: those resolve live."""
    mode = config.cache_mode
    if not mode.enabled:
        return {}
    from spark_bam_tpu_torch.sbi import plan as sbi_plan
    from spark_bam_tpu_torch.sbi.format import SbiIndex, fingerprint_of
    from spark_bam_tpu_torch.sbi.store import CacheStore

    store = CacheStore.from_env()
    if mode.read:
        index = store.load(path, config, strict=mode.strict)
        if index is not None and size in index.split_plans:
            starts = sbi_plan.plan_to_starts(splits, index.split_plans[size])
            if starts is not None:
                return starts
    if not mode.write:
        return {}
    # A miss with write-through: resolve the whole plan and persist it.
    entries = sbi_plan.build_split_plan(path, splits, header, config,
                                        device=device)
    store.merge_and_store(
        path, config,
        SbiIndex(fingerprint_of(path, config), split_plans={size: entries}),
    )
    return sbi_plan.plan_to_starts(splits, entries) or {}


def split_starts(path, split_size=None, config: Config = Config(),
                 pool=None, device=None) -> "list[tuple[FileSplit, object]]":
    """``[(FileSplit, Pos | None)]``: the resolved first record start of
    every file split of ``path`` (``split_size``, default the config's or
    32 MiB), equal to the JAX package's ``split_starts``. A warm ``.sbi``
    plan serves every split with no resolution (``load.split_resolutions``
    stays flat); the others resolve on ``device`` under the config's fault
    policy, through ``pool`` (an executor) when given. None marks a split
    that owns no record start or whose scan budget ran out."""
    from spark_bam_tpu_torch.load.boundary import (
        NoReadFoundException,
        resolve_split_start,
    )

    dev = resolve_device(device)
    size = (parse_bytes(split_size) if split_size is not None
            else config.split_size_or(Config.LOAD_SPLIT_SIZE_DEFAULT))
    policy = config.fault_policy
    header = with_retries(lambda: read_header(path), policy, "read_header")
    splits = with_retries(lambda: file_splits(path, size), policy,
                          "file_splits")
    resolved = dict(_consult_split_cache(path, splits, header, config, size,
                                         dev))
    missing = [s for s in splits if s not in resolved]

    def resolve(split):
        def once():
            try:
                return resolve_split_start(path, split, header, config,
                                           device=dev)
            except NoReadFoundException:
                return None
        return with_retries(once, policy, "resolve_split_start")

    if missing:
        results = (list(pool.map(resolve, missing)) if pool is not None
                   else [resolve(s) for s in missing])
        resolved.update(zip(missing, results))
    return [(s, resolved.get(s)) for s in splits]
