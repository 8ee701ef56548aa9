"""Library entry points over whole files (the JAX package's
``spark_bam_tpu/load/api.py``): the record loaders, the aggregate, the
columnar export and the resolved split starts.

The record loaders (``load_bam``, ``load_reads_and_positions``,
``load_splits_and_reads``, ``load_reads``, ``load_bam_intervals``) return
lazy ``Dataset``s partitioned as the reference partitions its RDDs
(CanLoadBam.scala:59-382): one partition a raw file split, its records
streamed from its first record start up to the next split's range, each
decoded on the host from a seekable record stream (host zlib, as the
reference reads them). Their strict split starts come from the device:
every one is resolved by the calling process before any partition runs, by
``resolve_split_start`` (``load/boundary.py``: the ``prefilter_check_flags``
kernel) on ``device``, or served by a warm ``.sbi`` plan. A split whose
resolution raised re-raises inside its own partition, so the executor's
retries and quarantine see it as the reference's do. Tolerant mode
(``FaultPolicy.mode=tolerant``) resolves inside the partition on the host
with the eager checker over a tolerant stream, the reference's semantics
there: a damaged block inside the boundary scan surfaces as a
``BlockGapError`` to resync past, and a garbage length prefix as a
``RecordGapError``. No partition touches the device.

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
native container, Arrow IPC or Parquet). The route follows the fault
policy the caller asked for, decided before any work (it is never a
demotion after a device failure): with no ``faults`` spec, or a strict
one with ``retries=0``, the streaming check and record parse of every
window run on the device with the interval and flag filters there
(``stream_ordered_batches``); with a tolerant policy or retries, the
records come from the record path (``load_bam``, or
``load_bam_intervals`` for loci; strict split starts on the device)
through the partition executor, which retries and quarantines as the
reference's export does (``columnar/export.py::export_records``). The
renderings and encoding are on the host (``columnar/``) either way.

SAM and CRAM (``load_sam``, ``load_cram``, ``load_cram_intervals`` and
the ``.sam`` / ``.cram`` branches of ``load_reads``, ``load_bam_intervals``,
``aggregate`` and ``export``) are host code, as in the reference: the SAM
text is parsed line by line over newline-aligned byte ranges, CRAM
containers are decoded by ``cram/`` (its rANS blocks by the native
decoder), ``aggregate`` reduces them through the int64 oracle
(``Dataset.aggregate``) and ``export`` goes through the partition executor
(``export_records``). Nothing of them runs on the card, which the
reference's do not either; ``aggregate`` and ``export`` still resolve
``device`` as every entry point does. A CRAM written reference-based
(``RR=true``) needs ``reference``, a FASTA path or ``{name: bytes}``.

Every BAM entry point takes a local path or a URL (``core/channel.py``:
``http(s)://``, ``gs://``, ``s3://``, registered schemes); ``load_fleet``
loads many BAMs as one dataset, a partition a file.

``split_starts`` gives every raw file split its first record start, what
the serve daemon answers ``plan`` with: from a valid ``.sbi`` split plan
when ``config.cache`` reads (no resolution at all), else each split
resolved on the device (``load/boundary.py``), written through when the
cache writes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.agg.kernels import aggregate_planes
from spark_bam_tpu_torch.agg.plan import AggConfig
from spark_bam_tpu_torch.bam.bai import BaiIndex, Chunk, merge_chunks
from spark_bam_tpu_torch.bam.header import BamHeader, read_header
from spark_bam_tpu_torch.bam.iterators import SeekableRecordStream
from spark_bam_tpu_torch.bgzf.find_block_start import find_block_start
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.bgzf.stream import (
    SeekableBlockStream,
    SeekableUncompressedBytes,
)
from spark_bam_tpu_torch.check.checker import NoReadFoundException
from spark_bam_tpu_torch.check.eager import EagerChecker
from spark_bam_tpu_torch.core.channel import (
    open_channel,
    path_exists,
    path_size,
)
from spark_bam_tpu_torch.core.config import Config, parse_bytes
from spark_bam_tpu_torch.core.faults import (
    BlockCorruptionError,
    BlockGapError,
    with_retries,
)
from spark_bam_tpu_torch.core.guard import MalformedInputError, RecordGapError
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.load.dataset import Dataset
from spark_bam_tpu_torch.load.intervals import LociSet
from spark_bam_tpu_torch.load.splits import FileSplit, Split, file_splits
from spark_bam_tpu_torch.parallel.executor import ParallelConfig
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
    reference=None,
    parallel: ParallelConfig = ParallelConfig(),
) -> dict:
    """Aggregate statistics of a BAM, CRAM or SAM query. ``agg`` is the
    compact :class:`~spark_bam_tpu_torch.agg.plan.AggConfig` spec (``""``:
    the config's ``agg``, and when that is empty every metric at defaults);
    ``loci``, the flag masks and ``tags_required`` (two-character tag
    names that must all be present) narrow the records. ``chunk`` bounds
    the records a reduction window takes. A BAM reduces on ``device``; a
    CRAM (decoded with ``reference`` when it needs one) or a SAM through
    the record loaders and the int64 oracle, partitions pooled by
    ``parallel``, as the reference's do.

    Returns ``{"agg", "rows", "contigs", "metrics"}``: the canonical
    spec, the records selected, ``(name, length)`` per contig and metric
    name → int64 vector, as the JAX package's ``aggregate`` returns."""
    plan = AggConfig.parse(agg or config.agg)
    tags_required = tuple(tags_required or ())
    for t in tags_required:
        if not isinstance(t, str) or len(t) != 2:
            raise ValueError(f"tag names are exactly two chars: {t!r}")
    s = str(path)
    if s.endswith((".cram", ".sam")):
        resolve_device(device)
        return _aggregate_records(path, plan, loci, flags_required,
                                  flags_forbidden, tags_required, config,
                                  parallel, reference)
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
    return {
        "agg": plan.canonical(),
        "rows": rows,
        "contigs": _contig_pairs(header),
        "metrics": metrics,
    }


def _sam_or_cram_dataset(path, loci, config: Config, parallel, reference
                         ) -> "tuple[BamHeader, Dataset]":
    """The header and the records (narrowed to ``loci`` when given) of a
    ``.cram`` or ``.sam`` path, as the reference's ``export`` and
    ``aggregate`` load them."""
    if str(path).endswith(".cram"):
        from spark_bam_tpu_torch.cram import load_cram_header

        header = load_cram_header(path)
        ds = (load_cram_intervals(path, loci, None, config, parallel,
                                  reference=reference) if loci
              else load_cram(path, None, config, parallel,
                             reference=reference))
    else:
        header = _scan_sam_header(path)
        ds = (_load_sam_intervals(path, loci, None, config, parallel) if loci
              else load_sam(path, None, config, parallel))
    return header, ds


def _flag_filtered(ds: Dataset, flags_required: int, flags_forbidden: int
                   ) -> Dataset:
    """The flag half of the device filter as a record predicate: unmapped
    reads pass unless a flag bit excludes them."""
    if not (flags_required or flags_forbidden):
        return ds
    return ds.filter(lambda rec: (rec.flag & flags_required) == flags_required
                     and (rec.flag & flags_forbidden) == 0)


def _contig_pairs(header: BamHeader) -> list[tuple[str, int]]:
    return [(str(name), int(length)) for name, length in
            zip(header.contig_names, header.contig_lengths)]


def _aggregate_records(path, plan: AggConfig, loci, flags_required: int,
                       flags_forbidden: int, tags_required: tuple,
                       config: Config, parallel: ParallelConfig, reference
                       ) -> dict:
    """``aggregate`` of a CRAM or SAM (reference load/api.py:869-899): the
    record loaders, the predicates on the host, each partition through the
    int64 oracle, the partials summed."""
    from spark_bam_tpu_torch.bam.record import render_tags

    header, ds = _sam_or_cram_dataset(path, loci, config, parallel,
                                      reference)
    ds = _flag_filtered(ds, flags_required, flags_forbidden)
    if tags_required:
        # Presence through the total tag renderer: a damaged entry reads
        # as absent, the plane scan's stop-clean semantics.
        prefixes = tuple(t + ":" for t in tags_required)

        def has_tags(rec) -> bool:
            rendered = render_tags(rec.tags)
            return all(any(r.startswith(p) for r in rendered)
                       for p in prefixes)

        ds = ds.filter(has_tags)
    metrics = ds.aggregate(plan, len(header.contig_names))
    # count[0] and flagstat[0] both count the records seen.
    if "count" in metrics:
        rows = int(metrics["count"][0])
    elif "flagstat" in metrics:
        rows = int(metrics["flagstat"][0])
    else:
        rows = None
    return {
        "agg": plan.canonical(),
        "rows": rows,
        "contigs": _contig_pairs(header),
        "metrics": metrics,
    }


def export_takes_record_path(config: Config) -> bool:
    """Whether ``export`` runs through the partition executor: a tolerant
    policy, or a ``faults`` spec that leaves retries on."""
    policy = config.fault_policy
    return policy.tolerant or (bool(config.faults.strip())
                               and policy.max_retries > 0)


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
    parallel: ParallelConfig = ParallelConfig(),
    reference=None,
) -> dict:
    """Export a BAM's, CRAM's or SAM's records as columnar record batches
    to ``out``: ``fmt`` is ``native`` (the zero-dependency container),
    ``arrow`` (an IPC file) or ``parquet`` (those two need ``pyarrow``). ``loci`` keeps
    the records that overlap it, the flag masks narrow them, ``columns``
    projects the schema and ``config.columnar`` sets the row target and
    the container's codec. The bytes equal the JAX package's ``export``
    of the same query. Returns its summary: path, format, columns, rows,
    batches, bytes, seconds and the loss fields (0 on the device route;
    the executor's on the record route, which ``parallel`` pools). A CRAM
    (decoded with ``reference`` when it needs one) or a SAM always takes
    the record route, as in the reference."""
    from spark_bam_tpu_torch.columnar.export import (
        export_dataset,
        export_records,
    )

    dev = resolve_device(device)
    ccfg = config.columnar_config
    if str(path).endswith((".cram", ".sam")):
        header, ds = _sam_or_cram_dataset(path, loci, config, parallel,
                                          reference)
        return export_records(
            _flag_filtered(ds, flags_required, flags_forbidden), out,
            fmt=fmt, columns=columns, ccfg=ccfg,
            contigs=_contig_pairs(header))
    header = with_retries(lambda: read_header(path), config.fault_policy,
                          "read_header")
    contigs = _contig_pairs(header)
    if export_takes_record_path(config):
        ds = (load_bam_intervals(path, loci, None, config, parallel) if loci
              else load_bam(path, None, config, parallel, dev))
        return export_records(
            _flag_filtered(ds, flags_required, flags_forbidden), out,
            fmt=fmt, columns=columns, ccfg=ccfg, contigs=contigs)
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
    from spark_bam_tpu_torch.load.boundary import resolve_split_start

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


# ------------------------------------------------------------ record loaders
def _tolerant_checker(path, header: BamHeader, config: Config) -> EagerChecker:
    return EagerChecker(
        SeekableUncompressedBytes(
            SeekableBlockStream(open_channel(path), tolerant=True)),
        header.contig_lengths, config.reads_to_check)


def _tolerant_next_start(path, start: Pos, header: BamHeader,
                         config: Config) -> Pos | None:
    """The first provable record boundary at or past ``start`` on a
    tolerant stream; None when the damage runs to EOF or no boundary can
    be proven (the rest of the partition is lost with it)."""
    checker = _tolerant_checker(path, header, config)
    try:
        return checker.next_read_start(start, config.max_read_size)
    except BlockGapError as nxt:
        # The scan region is damaged too: chase the next gap (resync
        # offsets strictly increase, so this ends).
        if nxt.resync is None or nxt.resync <= start.block_pos:
            return None
        return _tolerant_next_start(path, Pos(nxt.resync, 0), header, config)
    except (NoReadFoundException, BlockCorruptionError, MalformedInputError,
            EOFError):
        return None
    finally:
        checker.close()


def _tolerant_record_resync(path, gap: BlockGapError, header: BamHeader,
                            config: Config) -> Pos | None:
    """After a quarantined block: the first provable record boundary at
    or past the resynced block (the stream's resync found the block)."""
    if gap.resync is None:
        return None
    return _tolerant_next_start(path, Pos(gap.resync, 0), header, config)


def _resolve_split_start_host(path, split: FileSplit, header: BamHeader,
                              config: Config) -> Pos | None:
    """Tolerant mode's split start, inside the partition (reference
    ``_resolve_split_start``, load/api.py:44-115): find-block-start, then
    the eager checker over a tolerant stream; a damaged block inside the
    scan resyncs past it."""
    obs.count("load.split_resolutions")
    first = header.end_pos
    if split.start <= first.block_pos < split.end:
        return first
    with obs.span("bgzf.read", kind="find_block_start", split=split.start):
        with open_channel(path) as ch:
            block_start = find_block_start(ch, split.start,
                                           config.bgzf_blocks_to_check,
                                           path=str(path))
    if block_start >= split.end:
        return None
    checker = _tolerant_checker(path, header, config)
    try:
        return checker.next_read_start(Pos(block_start, 0),
                                       config.max_read_size)
    except BlockGapError as gap:
        pos = _tolerant_record_resync(path, gap, header, config)
        if pos is None or pos.block_pos >= split.end:
            return None
        return pos
    finally:
        checker.close()


#: No start resolved for this split yet (distinct from None: a resolved
#: "this split owns no record start").
_UNRESOLVED = object()


class _Raised:
    """A resolution that raised before the partitions ran: its partition
    re-raises it."""

    def __init__(self, error: BaseException):
        self.error = error


def _iter_split_records(path, split: FileSplit, header: BamHeader,
                        config: Config, start_pos=_UNRESOLVED):
    """``(Pos, BamRecord)`` of one split: from its first record start to
    the first record at or past the split's end."""
    if isinstance(start_pos, _Raised):
        raise start_pos.error
    if start_pos is _UNRESOLVED:
        with obs.span("load.partition", split=split.start):
            start_pos = _resolve_split_start_host(path, split, header,
                                                  config)
    if start_pos is None:
        return
    tolerant = config.fault_policy.tolerant
    stream = SeekableRecordStream(
        SeekableUncompressedBytes(
            SeekableBlockStream(open_channel(path), tolerant=tolerant)),
        header)
    records = 0
    try:
        stream.seek(start_pos)
        it = iter(stream)
        while True:
            try:
                pos, rec = next(it)
            except StopIteration:
                break
            except BlockGapError as gap:
                # Tolerant only: the damaged block is quarantined; resume
                # at the next provable record boundary past it. Records
                # overlapping the damage are lost with it.
                resume = _tolerant_record_resync(path, gap, header, config)
                if resume is None or resume.block_pos >= split.end:
                    break
                stream.seek(resume)
                it = iter(stream)
                continue
            except RecordGapError as gap:
                # Tolerant only: a garbage length prefix; prove a boundary
                # with the checker just past it.
                resume = _tolerant_next_start(
                    path, Pos(gap.pos.block_pos, gap.pos.offset + 1),
                    header, config)
                if resume is None or resume.block_pos >= split.end:
                    break
                stream.seek(resume)
                it = iter(stream)
                continue
            if pos.block_pos >= split.end:
                break
            records += 1
            yield pos, rec
    finally:
        stream.close()
        obs.count("load.records", records)
        obs.count("load.partitions")


def _strict_starts(path, splits, header: BamHeader, config: Config,
                   size: int, dev) -> dict:
    """``{split: Pos | None | _Raised}``: the warm ``.sbi`` plan's starts
    and, in strict mode, every other split resolved on ``dev`` here, in
    the calling process (tolerant mode resolves the rest in its
    partitions)."""
    from spark_bam_tpu_torch.load.boundary import resolve_split_start

    starts = dict(_consult_split_cache(path, splits, header, config, size,
                                       dev))
    policy = config.fault_policy
    if policy.tolerant:
        return starts
    for split in splits:
        if split in starts:
            continue
        try:
            # The reference resolves inside each partition, under this
            # span; here the calling process resolves, a span a split.
            with obs.span("load.partition", split=split.start):
                starts[split] = with_retries(
                    lambda: resolve_split_start(path, split, header, config,
                                                device=dev),
                    policy, "resolve_split_start")
        except Exception as e:
            starts[split] = _Raised(e)
    return starts


def _with_split_size(config: Config, split_size) -> Config:
    if split_size:
        return dataclasses.replace(config, split_size=parse_bytes(split_size))
    return config


def load_reads_and_positions(path, split_size=None, config: Config = Config(),
                             parallel: ParallelConfig = ParallelConfig(),
                             device=None) -> Dataset:
    """``(Pos, BamRecord)`` pairs of a BAM, one partition a file split of
    ``split_size`` (default the config's, else 32 MiB; reference
    CanLoadBam.scala:281-334). Strict split starts are resolved on
    ``device`` (CUDA unless named) before this returns."""
    dev = resolve_device(device)
    config = _with_split_size(config, split_size)
    size = config.split_size_or(Config.LOAD_SPLIT_SIZE_DEFAULT)
    policy = config.fault_policy
    header = with_retries(lambda: read_header(path), policy, "read_header")
    splits = with_retries(lambda: file_splits(path, size), policy,
                          "file_splits")
    starts = _strict_starts(path, splits, header, config, size, dev)
    return Dataset(
        splits,
        lambda split: _iter_split_records(path, split, header, config,
                                          starts.get(split, _UNRESOLVED)),
        parallel, policy=policy)


def _records_only(ds: Dataset) -> Dataset:
    compute = ds.compute
    return Dataset(ds.partitions, lambda p: (rec for _, rec in compute(p)),
                   ds.parallel, policy=ds.policy)


def load_bam(path, split_size=None, config: Config = Config(),
             parallel: ParallelConfig = ParallelConfig(),
             device=None) -> Dataset:
    """The records of a BAM, one partition a file split (reference
    CanLoadBam.scala:173-243)."""
    return _records_only(load_reads_and_positions(path, split_size, config,
                                                  parallel, device))


def load_fleet(paths, split_size=None, config: Config = Config(),
               parallel: ParallelConfig = ParallelConfig(),
               device=None) -> Dataset:
    """Many BAMs (local paths or URLs) as one dataset, one partition a
    file (reference ``load_fleet``, load/api.py:453-480): ``(path, Pos,
    BamRecord)`` triples, file after file. Every file's channels share the
    process-wide remote GET quota and the ``.sbi`` tier
    (``core/remote_plan.py``), so many objects cannot stampede a store,
    and each partition rides the executor's retries and quarantine.

    Under ``sequential`` or ``threads`` a partition reads its file's
    header and resolves its strict split starts on ``device`` from its
    own thread, inside the attempt (the flag kernels' ordered tile
    tickets make concurrent launches safe). Under ``processes`` nothing in
    a pooled child touches CUDA: every file's strict starts are resolved
    here, in the calling process, before any partition runs, as
    ``load_bam``'s are."""
    paths = [str(p) for p in paths]
    dev = resolve_device(device)
    inner = ParallelConfig("sequential")
    upfront = ({p: load_reads_and_positions(p, split_size, config, inner,
                                            dev)
                for p in paths} if parallel.mode == "processes" else None)

    def compute(path):
        ds = (upfront[path] if upfront is not None else
              load_reads_and_positions(path, split_size, config, inner, dev))
        for split in ds.partitions:
            for pos, rec in ds.compute(split):
                yield path, pos, rec

    obs.gauge("load.fleet_files").set(len(paths))
    return Dataset(paths, compute, parallel, policy=config.fault_policy)


def load_splits_and_reads(path, split_size=None, config: Config = Config(),
                          parallel: ParallelConfig = ParallelConfig(),
                          device=None) -> tuple[list[Split], Dataset]:
    """The resolved splits (each partition's first record start to the
    next one's, the last to ``Pos(file size, 0)``) and the records'
    dataset (reference CanLoadBam.scala:245-279)."""
    ds = load_reads_and_positions(path, split_size, config, parallel, device)
    starts = [item[0] for item in ds.first_per_partition()
              if item is not None]
    eof = Pos(path_size(path), 0)
    splits = [Split(start, starts[i + 1] if i + 1 < len(starts) else eof)
              for i, start in enumerate(starts)]
    return splits, _records_only(ds)


def load_reads(path, split_size=None, config: Config = Config(),
               parallel: ParallelConfig = ParallelConfig(),
               device=None, reference=None) -> Dataset:
    """The records of a ``.sam``, ``.bam`` or ``.cram``, by extension
    (reference CanLoadBam.scala:348-382, which hands CRAM to hadoop-bam;
    here it is built in). ``reference`` reaches the CRAM loader for a
    reference-based (``RR=true``) file; the other formats ignore it."""
    s = str(path)
    dev = resolve_device(device)
    if s.endswith(".sam"):
        return load_sam(path, split_size, config, parallel)
    if s.endswith(".bam"):
        return load_bam(path, split_size, config, parallel, dev)
    if s.endswith(".cram"):
        return load_cram(path, split_size, config, parallel,
                         reference=reference)
    raise ValueError(f"Can't tell format of path: {s}")


# ------------------------------------------------------------- SAM and CRAM
def _scan_sam_header(path) -> BamHeader:
    """The ``@SQ`` dictionary of a SAM file's text header, one pass over
    its leading ``@`` lines (shared by ``load_sam`` and the interval
    path)."""
    from spark_bam_tpu_torch.cram.reader import header_from_contigs

    entries = []
    with open(path, "rt") as f:
        for line in f:
            if not line.startswith("@"):
                break
            if line.startswith("@SQ"):
                fields = dict(kv.split(":", 1)
                              for kv in line.rstrip("\n").split("\t")[1:]
                              if ":" in kv)
                if "SN" in fields:
                    entries.append((fields["SN"], int(fields.get("LN", "0"))))
    return header_from_contigs(entries)


def load_sam(path, split_size=None, config: Config = Config(),
             parallel: ParallelConfig = ParallelConfig()) -> Dataset:
    """The records of a SAM text file, one partition a byte range of
    ``split_size`` (default the config's, else 32 MiB): a range owns the
    lines that start inside it, so each but the first skips its partial
    first line (reference load/api.py:524-556)."""
    from spark_bam_tpu_torch.bam.record import parse_sam_line

    size = _with_split_size(config, split_size).split_size_or(
        Config.LOAD_SPLIT_SIZE_DEFAULT)
    header = _scan_sam_header(path)
    by_name = {name: idx for idx, name in enumerate(header.contig_names)}
    file_size = os.path.getsize(path)
    ranges = [(s, min(s + size, file_size)) for s in range(0, file_size, size)]

    def compute(rng):
        start, end = rng
        with open(path, "rb") as f:
            f.seek(start)
            if start > 0:
                f.readline()  # the previous range owns this partial line
            while f.tell() < end:
                line = f.readline()
                if not line:
                    break
                text = line.decode("latin-1")
                if text.startswith("@"):
                    continue
                yield parse_sam_line(text, by_name)

    return Dataset(ranges, compute, parallel, policy=config.fault_policy)


def _load_sam_intervals(path, loci: "LociSet | str", split_size,
                        config: Config, parallel: ParallelConfig) -> Dataset:
    """A SAM file's records that overlap ``loci``: SAM text has no index,
    so the whole file is read and the overlap filter alone narrows it
    (reference load/api.py:948-978, CanLoadBam.scala:59-76)."""
    header = _scan_sam_header(path)
    if isinstance(loci, str):
        loci = LociSet.parse(loci, header)
    overlaps = _overlap_filter(loci, header)
    ds = load_sam(path, split_size, config, parallel)
    compute = ds.compute
    return Dataset(ds.partitions,
                   lambda p: (rec for rec in compute(p) if overlaps(rec)),
                   parallel, policy=ds.policy)


def _overlap_filter(loci: LociSet, header: BamHeader):
    names = header.contig_names

    def overlaps(rec) -> bool:
        # Unmapped reads (placed ones too) have no genomic region.
        if rec.ref_id < 0 or rec.is_unmapped:
            return False
        return loci.overlaps(names[rec.ref_id], rec.pos, rec.end_pos())

    return overlaps


def _resolve_reference(reference):
    """A FASTA path read into ``{name: bytes}`` once (not a partition);
    a mapping or None as given."""
    if isinstance(reference, (str, bytes)) or hasattr(reference,
                                                       "__fspath__"):
        from spark_bam_tpu_torch.cram.fasta import read_fasta

        return read_fasta(reference)
    return reference


def _group_by_size(infos, size: int) -> list[list]:
    """Container infos grouped greedily into partitions of at most
    ``size`` compressed bytes (a container larger alone), the container
    analog of ``pack_chunks``."""
    groups: list[list] = []
    cur: list = []
    cur_bytes = 0
    for info in infos:
        length = info.end - info.offset
        if cur and cur_bytes + length > size:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(info)
        cur_bytes += length
    if cur:
        groups.append(cur)
    return groups


def _contiguous_runs(group) -> list[tuple[int, int]]:
    """Container infos as ``(offset, end)`` runs, so a selection with
    gaps decodes none of the containers between its runs."""
    runs: list[list[int]] = []
    for info in group:
        if runs and runs[-1][1] == info.offset:
            runs[-1][1] = info.end
        else:
            runs.append([info.offset, info.end])
    return [(s, e) for s, e in runs]


def load_cram(path, split_size=None, config: Config = Config(),
              parallel: ParallelConfig = ParallelConfig(),
              reference=None) -> Dataset:
    """The records of a CRAM, one partition a run of whole containers of
    about ``split_size`` compressed bytes (reference load/api.py:559-584;
    hadoop-bam's ``CRAMInputFormat`` splits at containers too).
    ``reference`` (a FASTA path or ``{name: bytes}``) is needed only by a
    file written reference-based (``RR=true``)."""
    from spark_bam_tpu_torch.cram import CramReader

    reference = _resolve_reference(reference)
    size = _with_split_size(config, split_size).split_size_or(
        Config.LOAD_SPLIT_SIZE_DEFAULT)
    with CramReader(path) as r:
        infos = r.container_infos()

    def compute(group):
        with CramReader(path, reference=reference) as r:
            yield from r.records(group[0].offset, group[-1].offset + 1)

    return Dataset(_group_by_size(infos, size), compute, parallel,
                   policy=config.fault_policy)


def load_cram_intervals(path, loci: "LociSet | str", split_size=None,
                        config: Config = Config(),
                        parallel: ParallelConfig = ParallelConfig(),
                        reference=None) -> Dataset:
    """The records of a CRAM that overlap ``loci`` (reference
    load/api.py:616-680). With a ``PATH.crai`` only the containers whose
    index lines overlap are decoded, as the ``.bai`` narrows
    ``load_bam_intervals``; without one every container is, and the
    overlap filter alone narrows the records."""
    from spark_bam_tpu_torch.cram import CramReader
    from spark_bam_tpu_torch.cram.crai import read_crai

    reference = _resolve_reference(reference)
    with CramReader(path) as r:
        header = r.bam_header
        infos = r.container_infos()
    if isinstance(loci, str):
        loci = LociSet.parse(loci, header)
    name_to_idx = {name: idx for idx, name in enumerate(header.contig_names)}
    crai_path = str(path) + ".crai"
    selected = infos
    if path_exists(crai_path):
        # ref id -> 0-based intervals, a bare contig as its whole length.
        by_ref = {
            name_to_idx[contig]: ivs or [
                (0, int(header.contig_lengths[name_to_idx[contig]]))]
            for contig, ivs in loci.intervals.items()
            if contig in name_to_idx
        }
        wanted = set()
        for entry in read_crai(crai_path):
            ivs = by_ref.get(entry.ref_seq_id)
            if ivs and any(entry.overlaps(entry.ref_seq_id, s, e)
                           for s, e in ivs):
                wanted.add(entry.container_offset)
        selected = [info for info in infos if info.offset in wanted]
    size = _with_split_size(config, split_size).split_size_or(
        Config.LOAD_SPLIT_SIZE_DEFAULT)
    overlaps = _overlap_filter(loci, header)

    def compute(group):
        with CramReader(path, reference=reference) as r:
            for offset, end in _contiguous_runs(group):
                for rec in r.records(offset, end):
                    if overlaps(rec):
                        yield rec

    return Dataset(_group_by_size(selected, size), compute, parallel,
                   policy=config.fault_policy)


# ------------------------------------------------------------------ intervals
def interval_chunks(path, loci: LociSet, header: BamHeader,
                    config: Config = Config()) -> list[Chunk]:
    """The ``.bai`` chunks overlapping ``loci`` (reference
    getIntevalChunks, CanLoadBam.scala:387-421)."""
    bai = BaiIndex.read(str(path) + ".bai")
    name_to_idx = {name: idx for idx, name in enumerate(header.contig_names)}
    chunks: list[Chunk] = []
    for contig, ivs in loci.intervals.items():
        if contig not in name_to_idx:
            continue
        ref = name_to_idx[contig]
        if not ivs:
            ivs = [(0, int(header.contig_lengths[ref]))]
        for s, e in ivs:
            chunks.extend(bai.query(ref, s, e))
    chunks.sort(key=lambda c: (c.start, c.end))
    return merge_chunks(chunks)


def pack_chunks(chunks: list[Chunk], split_size: int, ratio: float
                ) -> list[list[Chunk]]:
    """Greedy size-capped grouping of chunks into partitions (the
    reference's cappedCostGroups, CanLoadBam.scala:85-99)."""
    groups: list[list[Chunk]] = []
    cur: list[Chunk] = []
    cur_cost = 0
    for c in chunks:
        cost = max(c.size(ratio), 1)
        if cur and cur_cost + cost > split_size:
            groups.append(cur)
            cur, cur_cost = [], 0
        cur.append(c)
        cur_cost += cost
    if cur:
        groups.append(cur)
    return groups


def load_bam_intervals(path, loci: "LociSet | str", split_size=None,
                       config: Config = Config(),
                       parallel: ParallelConfig = ParallelConfig()
                       ) -> Dataset:
    """The records of an indexed BAM that overlap ``loci`` (reference
    CanLoadBam.scala:59-138): the ``.bai`` chunks packed into partitions
    of about ``split_size``, each read from its chunks' starts on the
    host. A ``.sam`` path has no index: the whole file is read and the
    overlap filter narrows it."""
    if str(path).endswith(".sam"):
        return _load_sam_intervals(path, loci, split_size, config, parallel)
    header = with_retries(lambda: read_header(path), config.fault_policy,
                          "read_header")
    if isinstance(loci, str):
        loci = LociSet.parse(loci, header)
    config = _with_split_size(config, split_size)
    size = config.split_size_or(Config.LOAD_SPLIT_SIZE_DEFAULT)
    groups = pack_chunks(interval_chunks(path, loci, header, config), size,
                         config.estimated_compression_ratio)
    overlaps = _overlap_filter(loci, header)

    def compute(group):
        stream = SeekableRecordStream(
            SeekableUncompressedBytes(SeekableBlockStream(open_channel(path))),
            header)
        try:
            for chunk in group:
                stream.seek(chunk.start)
                for pos, rec in stream:
                    if (pos.block_pos, pos.offset) >= (chunk.end.block_pos,
                                                       chunk.end.offset):
                        break
                    if overlaps(rec):
                        yield rec
        finally:
            stream.close()

    return Dataset(groups, compute, parallel, policy=config.fault_policy)
