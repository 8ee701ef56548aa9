"""Command line: ``python -m spark_bam_tpu_torch COMMAND ... PATH``.

``count-reads [-n N] [--resident | --sharded]`` prints the reference CLI's
standalone count lines (``spark-bam read-count time: MS`` and ``Read count:
N`` per iteration) and, but for ``--sharded``, its ``funnel:`` line;
``--resident`` (or ``Config.resident_scan``) counts with one device
dispatch per resident chunk (``StreamChecker.count_reads_resident``),
``--sharded`` across the mesh (``parallel.stream_mesh.count_reads_sharded``).
``full-check [-l N] [--sharded]`` prints the reference's streaming
full-check report (``full-check --streaming``; with ``--sharded`` the
report reduced across the mesh, the same output): the critical and
two-check sections with ``block:offset`` positions, the total error counts
and the ``funnel:`` line. ``check-bam --sharded [--cache MODE]`` prints the
reference's sharded check-bam report against the ``.records`` sidecar,
its ``.sbi`` cache line included; the eager-against-seqdoop check-bam is
not ported.

``aggregate [-a SPEC] [-i LOCI] [--flags-required N] [--flags-forbidden N]
[-t TG]... [--format tsv|json] [--cache MODE] [-o OUT]`` prints the
reference's aggregate report: one ``metric<TAB>key<TAB>value`` line per
populated bucket (tsv), or the whole result as one JSON object, and a
timing line on stderr. A bad spec, loci or tag is a usage error before
any work.

Split planning: ``compute-splits [-s|-u] [-m SIZE] [--plan-hosts N
[--devices-per-host D]] [--cache MODE]`` prints spark-bam's splits (every
boundary resolved on the device, ``load/boundary.py``), hadoop-bam's
(``-u``) or, by default, their difference, as the reference prints them;
``index [-m SIZE] [--record-starts] [-o OUT]`` writes the ``.sbi``
split-index sidecar (blocks, the split plan and, with
``--record-starts``, every record start from the streaming check);
``index-blocks`` and ``index-records`` write the ``.blocks`` and
``.records`` sidecars. ``--cache`` (or ``SPARK_BAM_CACHE``) is ``off |
read | write | readwrite`` with an optional ``,strict``; sidecars go next
to the BAM or under ``SPARK_BAM_CACHE_DIR``.

``export [-i LOCI] [--format native|arrow|parquet] [--columns COLS]
[--columnar SPEC] [-m SIZE] -o OUT`` writes the BAM's records (those
overlapping ``LOCI``) as columnar record batches, projected to ``COLS``,
and prints the reference's summary line (``exported N rows in B batches
(SIZE, FORMAT) to OUT in S s [COLS]``). ``--columnar`` (or
``SPARK_BAM_COLUMNAR``) sets the row target and the native container's
codec; ``-m`` changes nothing, as the frames follow the row target. Bad
loci, columns or specs are usage errors before any work; Arrow and
Parquet need ``pyarrow``.

``rewrite IN OUT [-b PAYLOAD] [--level N] [-i] [--deflate SPEC]`` (alias
``htsjdk-rewrite``) writes every record of ``IN`` again into ``OUT``,
re-blocked at ``PAYLOAD`` uncompressed bytes a member, compressed by the
deflate spec's codec (host zlib at ``--level`` by default; ``mode=stored``
or ``mode=fixed`` members from the card's CRC-32 and fixed-Huffman
lanes), and with ``-i`` its ``.blocks``, ``.records`` and ``.sbi``
sidecars from the packing metadata; it prints the reference's ``Wrote N
reads to OUT`` lines. ``--deflate`` (or ``SPARK_BAM_DEFLATE``) is checked
before any work; its ``device=auto`` means the card here, as ``on`` does.

Every command runs on the CUDA device unless ``--device`` names another;
``--sharded`` meshes are every visible CUDA device, or ``--devices N``
entries of ``--device`` (``--device cpu --devices 4``: a 4-entry CPU mesh).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

from spark_bam_tpu_torch.bgzf.flat import metas_block_table, pos_of_flat_tables
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.check.flags import FLAG_NAMES, bit_counts
from spark_bam_tpu_torch.agg.plan import AggConfig
from spark_bam_tpu_torch.compress.config import DeflateConfig
from spark_bam_tpu_torch.core.config import Config, format_bytes, parse_bytes
from spark_bam_tpu_torch.core.stats import Stats, format_bytes_binary
from spark_bam_tpu_torch.load import api
from spark_bam_tpu_torch.load.hadoop import hadoop_bam_splits
from spark_bam_tpu_torch.load.intervals import BadLociError, LociSet
from spark_bam_tpu_torch.load.splits import (
    Split,
    diff_splits,
    file_splits,
    spark_bam_splits,
)
from spark_bam_tpu_torch.parallel.mesh import make_mesh
from spark_bam_tpu_torch.parallel.stream_mesh import (
    check_bam_sharded,
    count_reads_sharded,
    full_check_summary_sharded,
    host_shard_plan,
)
from spark_bam_tpu_torch.sbi.store import (
    CacheMode,
    CacheStore,
    cache_status_line,
    reset_cache_events,
)
from spark_bam_tpu_torch.tpu.stream_check import (
    StreamChecker,
    full_check_summary_streaming,
)


class UsageError(ValueError):
    """A flag or argument the command cannot serve: printed as one
    ``error: ...`` line with exit code 2."""


class Printer:
    """The reference CLI's output helpers: echo, indentation, and sampled
    lists that print ``{total} things:`` when everything fits the print
    limit, else the truncated header, the first ``limit`` items and a
    tab-ellipsis line."""

    def __init__(self, out=None, limit: int = 10):
        self.out = out or sys.stdout
        self.limit = limit
        self._indent = 0

    def echo(self, *lines: str) -> None:
        for line in lines:
            for part in str(line).split("\n"):
                self.out.write(("\t" * self._indent + part + "\n") if part
                               else "\n")

    @contextlib.contextmanager
    def indent(self):
        self._indent += 1
        try:
            yield
        finally:
            self._indent -= 1

    def print_limited(self, items: list, total: int | None = None,
                      header: str | None = None, truncated_header=None,
                      item_indent: int = 1) -> None:
        total = total if total is not None else len(items)
        if self.limit and total > self.limit:
            shown = items[: self.limit]
            if truncated_header:
                self.echo(truncated_header(len(shown)))
            for item in shown:
                self.echo("\t" * item_indent + str(item))
            self.echo("\t…")
        else:
            if header:
                self.echo(header)
            for item in items[:total]:
                self.echo("\t" * item_indent + str(item))


def funnel_status_line(config: Config, stats: dict | None = None,
                       full_masks: bool = False) -> str:
    """The ``funnel: …`` line: the configured mode, whether the two-stage
    prefilter ran on this path, and its measured reduction."""
    mode = config.funnel
    if not config.funnel_enabled(full_masks):
        why = "disabled" if mode == "off" else (
            "full per-position flag masks requested")
        return f"funnel: off ({mode}: {why})"
    if stats and stats.get("screened"):
        screened = int(stats["screened"])
        survivors = int(stats["survivors"])
        return (
            f"funnel: on ({mode}): {screened} positions -> {survivors} "
            f"survivors, {screened / max(survivors, 1):.1f}x reduction"
        )
    return f"funnel: on ({mode})"


def _sharded_mesh(device=None, devices: int | None = None):
    """The ``--sharded`` mesh: every visible CUDA device (the first
    ``devices`` of them), or ``devices`` entries of ``device``."""
    if device is None:
        mesh = make_mesh()
        return mesh if devices is None else make_mesh(mesh.devices[:devices])
    return make_mesh([device] * (devices or 1))


def _timed_counts(count_fn, iterations: int, out) -> int:
    count = 0
    for _ in range(max(iterations, 1)):
        t0 = time.perf_counter()
        count = count_fn()
        ms = int((time.perf_counter() - t0) * 1e3)
        out.write(f"spark-bam read-count time: {ms}\n")
        out.write(f"Read count: {count}\n\n")
    return count


def count_reads(path, iterations: int = 1, device=None, out=None,
                resident: bool = False, config: Config | None = None,
                sharded: bool = False, devices: int | None = None) -> int:
    out = sys.stdout if out is None else out
    config = Config() if config is None else config
    if sharded:
        if resident:
            raise UsageError("--resident and --sharded are mutually "
                             "exclusive")
        mesh = _sharded_mesh(device, devices)
        return _timed_counts(
            lambda: count_reads_sharded(path, config, mesh=mesh), iterations,
            out)
    checker = StreamChecker(path, config, device=device)
    count_fn = (checker.count_reads_resident
                if resident or config.resident_scan else checker.count_reads)
    count = _timed_counts(count_fn, iterations, out)
    out.write(funnel_status_line(config, checker.funnel_stats) + "\n\n")
    return count


def _counts_lines(counts: dict[str, int], hide_bit0: bool = False,
                  include_zeros: bool = False) -> list[str]:
    items = [
        (name, counts.get(name, 0))
        for name in FLAG_NAMES
        if (include_zeros or counts.get(name, 0))
        and not (hide_bit0 and name == "tooFewFixedBlockBytes")
    ]
    if not items:
        return []
    items.sort(key=lambda kv: -kv[1])
    name_w = max(len(n) for n, _ in items)
    count_w = max(len(str(c)) for _, c in items)
    return [f"{name:>{name_w}}:\t{str(count):>{count_w}}"
            for name, count in items]


def _mask_counts(masks: np.ndarray) -> dict[str, int]:
    return {name: c for name, c in zip(FLAG_NAMES, bit_counts(masks).tolist())
            if c}


def _render_report(p: Printer, crit_idx, crit_masks, two_idx, two_masks,
                   total_counts, fmt_pos) -> None:
    """The critical / two-check / total sections of the full-check report
    (reference FullCheck.scala); ``fmt_pos(flat)`` renders a position."""

    def limited(idx):
        return idx if not p.limit else idx[: p.limit]

    if len(crit_idx) == 0:
        p.echo("No positions where only one check failed")
    else:
        p.echo("Critical error counts (true negatives where only one check "
               "failed):")
        p.echo(*("\t" + ln for ln in _counts_lines(_mask_counts(crit_masks))))
        p.echo("")
        p.print_limited(
            [fmt_pos(int(i)) for i in limited(crit_idx)],
            total=len(crit_idx),
            header=f"{len(crit_idx)} critical positions:",
            truncated_header=lambda n: (
                f"{n} of {len(crit_idx)} critical positions:"),
        )

    p.echo("")

    if len(two_idx) == 0:
        p.echo("No positions where exactly two checks failed", "")
    else:
        p.print_limited(
            [fmt_pos(int(i)) for i in limited(two_idx)],
            total=len(two_idx),
            header=f"{len(two_idx)} positions where exactly two checks "
                   "failed:",
            truncated_header=lambda n: (
                f"{n} of {len(two_idx)} positions where exactly two checks "
                "failed:"),
        )
        p.echo("")
        # Masks by count, ties in order of first occurrence.
        masks, first, counts = np.unique(two_masks, return_index=True,
                                         return_counts=True)
        order = np.argsort(first, kind="stable")
        order = order[np.argsort(-counts[order], kind="stable")]
        top = [(int(masks[i]), int(counts[i])) for i in order]

        def combo_str(mask: int) -> str:
            return ",".join(n for i, n in enumerate(FLAG_NAMES)
                            if mask & (1 << i))

        if top[0][1] > 1:
            with p.indent():
                p.print_limited(
                    [f"{count}:\t{combo_str(mask)}" for mask, count in top],
                    header="Histogram:",
                    truncated_header=lambda n: "Histogram:",
                )
            p.echo("")
        with p.indent():
            p.echo("Per-flag totals:")
            p.echo(*("\t" + ln
                     for ln in _counts_lines(_mask_counts(two_masks))))
        p.echo("")

    p.echo("Total error counts:")
    p.echo(*(
        "\t" + ln
        for ln in _counts_lines(total_counts, hide_bit0=True,
                                include_zeros=True)
    ))
    p.echo("")


def full_check(path, print_limit: int = 10, device=None, out=None,
               sharded: bool = False, devices: int | None = None) -> dict:
    """The streaming full-check report of one BAM (reduced across the mesh
    with ``sharded``); returns its summary."""
    p = Printer(out=out, limit=print_limit)
    config = Config()
    metas = blocks_metadata(path)
    if sharded:
        s = full_check_summary_sharded(path, config,
                                       mesh=_sharded_mesh(device, devices),
                                       metas=metas)
    else:
        s = full_check_summary_streaming(path, config, device=device,
                                         metas=metas)
    block_starts, block_flat = metas_block_table(metas)

    def pos_str(i: int) -> str:
        b, o = pos_of_flat_tables(block_starts, block_flat, i)
        return f"{b}:{o}"

    _render_report(p, s["critical_positions"], s["critical_masks"],
                   s["two_check_positions"], s["two_check_masks"],
                   s["per_flag"], pos_str)
    p.echo(funnel_status_line(config, full_masks=True))
    return s


def check_bam(path, device=None, out=None, sharded: bool = False,
              devices: int | None = None, config: Config | None = None
              ) -> dict:
    """check-bam against the ``.records`` sidecar across the mesh; prints
    the reference's sharded report and returns its confusion stats."""
    if not sharded:
        raise UsageError(
            "check-bam compares the eager and seqdoop checkers without "
            "--sharded, which is not ported; run check-bam --sharded")
    p = Printer(out=out)
    config = Config() if config is None else config
    metas = blocks_metadata(path)
    mesh = _sharded_mesh(device, devices)
    stats = check_bam_sharded(path, config, mesh=mesh, metas=metas)
    # The data blocks' compressed bytes (the EOF sentinel excluded), as
    # the reference's report sums them.
    compressed = sum(m.compressed_size for m in metas)
    total = stats["positions"]
    p.echo(f"{total} uncompressed positions",
           f"{format_bytes_binary(compressed)} compressed",
           "Compression ratio: %.2f" % (total / compressed),
           f"{stats['true_positives'] + stats['false_negatives']} reads",
           f"checked across {stats['devices']} device(s)",
           cache_status_line(path, config),
           funnel_status_line(config))
    if not stats["false_positives"] and not stats["false_negatives"]:
        p.echo("All calls matched!")
    else:
        p.echo(f"{stats['false_positives']} false positives, "
               f"{stats['false_negatives']} false negatives")
    return stats


#: SAM flag bit → flagstat row label, in wire order (agg/plan.py).
_FLAG_LABELS = (
    "paired", "proper_pair", "unmapped", "mate_unmapped", "reverse",
    "mate_reverse", "read1", "read2", "secondary", "qc_fail", "dup",
    "supplementary",
)


def _coverage_spec(result: dict) -> str:
    for part in result["agg"].split(";"):
        if part.split(":", 1)[0] == "coverage":
            return part
    return "coverage"


def _tsv_lines(result: dict):
    """An ``aggregate`` result as tsv rows; only populated buckets print,
    so a whole-genome coverage vector stays readable."""
    contigs = result["contigs"]
    for name, vec in result["metrics"].items():
        if name == "count":
            for label, v in zip(("records", "mapped", "bases"), vec):
                yield f"count\t{label}\t{int(v)}"
        elif name == "flagstat":
            yield f"flagstat\ttotal\t{int(vec[0])}"
            for label, v in zip(_FLAG_LABELS, vec[1:]):
                yield f"flagstat\t{label}\t{int(v)}"
        elif name in ("mapq", "tlen"):
            top = len(vec) - 1
            for i, v in enumerate(vec):
                if v:
                    key = (f">{top - 1}" if name == "tlen" and i == top
                           else str(i))
                    yield f"{name}\t{key}\t{int(v)}"
        elif name == "coverage":
            nc = len(contigs) or 1
            bins = len(vec) // nc
            grid = vec.reshape(nc, bins)
            # The bucket width comes from the canonical spec the result
            # carries (agg/plan.py defaults when unstated).
            params = {}
            spec = _coverage_spec(result)
            if ":" in spec:
                for kv in spec.split(":", 1)[1].split(","):
                    key, _, value = kv.partition("=")
                    if value:
                        params[key] = int(value)
            width = params.get("bin", 1000)
            for (cname, clen), row in zip(contigs, grid):
                for k, v in enumerate(row):
                    if v:
                        lo = k * width
                        hi = (clen if k == bins - 1
                              else min((k + 1) * width, clen))
                        yield f"coverage\t{cname}:{lo}-{hi}\t{int(v)}"


def aggregate(path, agg: str | None = None, loci: str | None = None,
              flags_required: int = 0, flags_forbidden: int = 0,
              tags_required=(), fmt: str = "tsv", device=None, out=None,
              config: Config | None = None) -> dict:
    """The aggregate report of one BAM query; returns the result."""
    p = Printer(out=out)
    if loci:
        try:
            LociSet.parse(loci)
        except BadLociError as e:
            raise UsageError(str(e)) from e
    try:
        AggConfig.parse(agg or "")
        for t in tags_required:
            if len(t) != 2:
                raise ValueError(f"tag names are exactly two chars: {t!r}")
    except ValueError as e:
        raise UsageError(str(e)) from e
    t0 = time.monotonic()
    result = api.aggregate(path, agg=agg or "", loci=loci,
                           flags_required=flags_required,
                           flags_forbidden=flags_forbidden,
                           tags_required=tuple(tags_required),
                           config=Config() if config is None else config,
                           device=device)
    seconds = time.monotonic() - t0
    if fmt == "json":
        p.echo(json.dumps({
            "agg": result["agg"],
            "rows": result["rows"],
            "contigs": [[n, int(ln)] for n, ln in result["contigs"]],
            "metrics": {k: [int(x) for x in v]
                        for k, v in result["metrics"].items()},
        }, sort_keys=True))
    else:
        for line in _tsv_lines(result):
            p.echo(line)
    print(f"aggregated {result['rows']} rows [{result['agg']}] "
          f"in {seconds:.2f}s", file=sys.stderr)
    return result


def export(path, out_path: str, fmt: str = "native", loci: str | None = None,
           columns: str | None = None, device=None, out=None,
           config: Config | None = None) -> dict:
    """One export and its summary line (reference ``cli/export.py``);
    returns the summary."""
    from spark_bam_tpu_torch.columnar.config import ColumnarConfig
    from spark_bam_tpu_torch.columnar.schema import normalize_columns

    p = Printer(out=out)
    config = Config() if config is None else config
    try:
        if loci:
            LociSet.parse(loci)
        if columns:
            normalize_columns(columns)
        ColumnarConfig.parse(config.columnar)
    except ValueError as e:   # BadLociError is one
        raise UsageError(str(e)) from e
    summary = api.export(path, out_path, loci=loci or None, fmt=fmt,
                         columns=columns, config=config, device=device)
    cols = ",".join(summary["columns"])
    p.echo(
        f"exported {summary['rows']} rows in {summary['batches']} batches "
        f"({format_bytes(summary['bytes'])}, {summary['format']}) to "
        f"{summary['path']} in {summary['seconds']:.2f}s [{cols}]"
    )
    return summary


def rewrite(in_path, out_path, block_payload="65280", level: int = 6,
            index: bool = False, device=None, out=None,
            config: Config | None = None):
    """One rewrite (reference ``cli/rewrite.py::run``) and its lines;
    returns the ``RewriteResult``."""
    from spark_bam_tpu_torch.rewrite import rewrite_bam

    p = Printer(out=out)
    config = Config() if config is None else config
    try:
        payload = parse_bytes(block_payload)
        DeflateConfig.parse(config.deflate)
    except ValueError as e:
        raise UsageError(str(e)) from e
    res = rewrite_bam(in_path, out_path, block_payload=payload, level=level,
                      deflate=config.deflate, index=index, config=config,
                      device=device)
    p.echo(f"Wrote {res.count} reads to {out_path}")
    if index:
        p.echo(f"Indexed {res.n_blocks} blocks, {res.count} records")
        if "sbi" in res.sidecars:
            p.echo(f"Split index: {res.sidecars['sbi']}")
    return res


def _print_splits(p: Printer, splits: list[Split], ratio: float) -> None:
    stats = Stats([s.length(ratio) for s in splits])
    p.echo("Split-size distribution:", stats.show(), "")
    p.print_limited(
        [f"{s.start}-{s.end}" for s in splits],
        header=f"{len(splits)} splits:",
        truncated_header=lambda n: f"First {n} of {len(splits)} splits:",
    )
    p.echo("")


def print_host_plan(p: Printer, path, num_hosts: int, devices_per_host: int,
                    config: Config) -> None:
    """The ``num_hosts``-host sharded run's IO plan: each host's compressed
    byte range (halo overlap included) and owned uncompressed bytes."""
    plan = host_shard_plan(path, num_hosts, devices_per_host, config=config)
    p.echo(f"{num_hosts}-host plan ({devices_per_host} devices/host):")
    for row in plan:
        lo, hi = row["compressed_range"]
        g0, g1 = row["groups"]
        p.echo(
            f"\thost {row['host']}: bytes [{lo}, {hi}) "
            f"({format_bytes(hi - lo)} read, "
            f"{format_bytes(row['uncompressed'])} owned uncompressed, "
            f"rows {g0}-{g1})"
        )
    p.echo("")


def compute_splits(path, split_size: int, config: Config | None = None,
                   spark_bam: bool = False, hadoop_bam: bool = False,
                   device=None, out=None, print_limit: int = 10,
                   plan_hosts: int = 0, devices_per_host: int = 8) -> None:
    """spark-bam's splits (``spark_bam``), hadoop-bam's (``hadoop_bam``)
    or, by default, both and their difference, in the reference's report
    (reference ComputeSplits.scala:17-151)."""
    p = Printer(out=out, limit=print_limit)
    config = Config() if config is None else config
    ratio = config.estimated_compression_ratio

    def timed(fn):
        t0 = time.perf_counter()
        splits = fn()
        return int((time.perf_counter() - t0) * 1000), splits

    def spark():
        return timed(lambda: spark_bam_splits(path, split_size, config,
                                              device=device))

    def hadoop():
        return timed(lambda: hadoop_bam_splits(path, split_size,
                                               config=config))

    if hadoop_bam and not spark_bam:
        ms, splits = hadoop()
        p.echo(f"Get hadoop-bam splits: {ms}ms", "")
        _print_splits(p, splits, ratio)
    elif spark_bam and not hadoop_bam:
        ms, splits = spark()
        p.echo(f"Get spark-bam splits: {ms}ms",
               cache_status_line(path, config), "")
        _print_splits(p, splits, ratio)
    else:
        our_ms, ours = spark()
        p.echo(f"Get spark-bam splits: {our_ms}ms",
               cache_status_line(path, config))
        their_ms, theirs = hadoop()
        p.echo(f"Get hadoop-bam splits: {their_ms}ms", "")
        diffs = diff_splits(ours, theirs)
        if diffs:
            rows = [f"\t{s.start}-{s.end}" if side == "theirs"
                    else f"{s.start}-{s.end}" for side, s in diffs]
            totals = f"(totals: {len(ours)}, {len(theirs)})"
            p.print_limited(
                rows,
                header=f"{len(diffs)} splits differ {totals}:",
                truncated_header=lambda n: (
                    f"First {n} of {len(diffs)} splits that differ {totals}:"),
            )
            p.echo("")
        else:
            p.echo("All splits matched!", "")
            _print_splits(p, ours, ratio)
    if plan_hosts:
        print_host_plan(p, path, plan_hosts, devices_per_host, config)


def index(path, split_size: int, config: Config | None = None,
          out_path=None, record_starts: bool = False, device=None,
          out=None) -> str | None:
    """Write the ``.sbi`` sidecar of ``path``: its blocks, the split plan
    at ``split_size`` and, with ``record_starts``, every record start
    (from the streaming check, sorted), to ``out_path`` or the cache's
    place for it; prints the reference's ``Wrote ...`` line. Returns the
    sidecar path."""
    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.bgzf.flat import FlatView
    from spark_bam_tpu_torch.load.tpu_load import record_starts_streaming
    from spark_bam_tpu_torch.sbi.format import (
        PLAN_POS,
        SbiIndex,
        encode_sbi,
        fingerprint_of,
        record_starts_to_virtual,
    )
    from spark_bam_tpu_torch.sbi.plan import build_split_plan

    p = Printer(out=out)
    config = Config() if config is None else config
    header = read_header(path)
    blocks = list(blocks_metadata(path))
    entries = build_split_plan(path, file_splits(path, split_size), header,
                               config, device=device)
    sbi = SbiIndex(fingerprint_of(path, config), blocks=blocks,
                   split_plans={split_size: entries})
    n_starts = None
    if record_starts:
        # The cache is off for the inner check: this is the build.
        spans = list(record_starts_streaming(
            path, dataclasses.replace(config, cache=""), device=device))
        starts = (np.sort(np.concatenate(spans)) if spans
                  else np.empty(0, dtype=np.int64))
        bs, bf = metas_block_table(blocks)
        table = FlatView(np.empty(0, np.uint8), block_starts=bs,
                         block_flat=bf)
        sbi.record_starts = record_starts_to_virtual(table, starts)
        n_starts = len(starts)
    if out_path is not None:
        # An explicit destination: a plain atomic write, no store rules.
        dest = str(out_path)
        tmp = f"{dest}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(encode_sbi(sbi))
            os.replace(tmp, dest)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    else:
        dest = CacheStore.from_env().merge_and_store(path, config, sbi)
        if dest is None:
            p.echo(f"error: could not write a sidecar for {path}")
            return None
    resolved = sum(1 for e in entries if e.kind == PLAN_POS)
    parts = [
        f"{len(blocks)} blocks",
        f"split plan @{format_bytes(split_size)} "
        f"({len(entries)} boundaries, {resolved} resolved)",
    ]
    if n_starts is not None:
        parts.append(f"{n_starts} record starts")
    p.echo(f"Wrote {dest}: " + ", ".join(parts))
    return dest


def _add_knobs(p, split_help: str) -> None:
    p.add_argument("-m", "--max-split-size", default=None, help=split_help)
    p.add_argument("-z", "--bgzf-blocks-to-check", type=int, default=None)
    p.add_argument("--reads-to-check", type=int, default=None)
    p.add_argument("--max-read-size", type=int, default=None)


def _add_cache(p) -> None:
    p.add_argument(
        "--cache", default=None, metavar="MODE",
        help="split-index (.sbi) cache mode: off|read|write|readwrite, "
             "optional ',strict' suffix raises on stale sidecars "
             "(SPARK_BAM_CACHE works too)")


def _positive_int(s: str) -> int:
    v = int(s)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer: {s}")
    return v


def _config(args) -> Config:
    """``SPARK_BAM_CACHE``, ``SPARK_BAM_COLUMNAR`` and
    ``SPARK_BAM_DEFLATE``, then the command's flags: the split size, the
    checker knobs, ``--cache``, ``--columnar`` and ``--deflate`` (a bad
    size, cache or deflate spec is a usage error)."""
    kw = {}
    for knob in ("bgzf_blocks_to_check", "reads_to_check", "max_read_size",
                 "cache", "columnar", "deflate"):
        value = getattr(args, knob, None)
        if value is not None:
            kw[knob] = value
    try:
        split = getattr(args, "max_split_size", None)
        if split is not None:
            kw["split_size"] = parse_bytes(split)
        config = dataclasses.replace(Config.from_env(), **kw)
        CacheMode.parse(config.cache)
        DeflateConfig.parse(config.deflate)
    except ValueError as e:
        raise UsageError(str(e)) from e
    return config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spark_bam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cr = sub.add_parser("count-reads", help="count the records of a BAM")
    cr.add_argument("-n", "--num-iterations", type=int, default=1)
    cr.add_argument("--resident", action="store_true",
                    help="one device dispatch per resident chunk of windows")
    fc = sub.add_parser("full-check",
                        help="all 19 checks at every position of a BAM")
    fc.add_argument("-l", "--print-limit", type=int, default=10)
    cb = sub.add_parser("check-bam",
                        help="the checker against the .records sidecar")
    _add_cache(cb)
    for p in (cr, fc, cb):
        p.add_argument("--sharded", action="store_true",
                       help="across every device of the mesh")
        p.add_argument("--device", default=None,
                       help="torch device (default: the current CUDA device)")
        p.add_argument("--devices", type=int, default=None,
                       help="--sharded mesh entries: N copies of --device, "
                            "or the first N CUDA devices")
        p.add_argument("path")
    ag = sub.add_parser("aggregate",
                        help="aggregate statistics of a BAM query")
    ag.add_argument(
        "-a", "--agg", default=None, metavar="SPEC",
        help="';'-separated metric[:k=v,...] spec: count, flagstat, mapq, "
             "tlen[:max=N], coverage[:bin=N,bins=N,cap=N] (default: every "
             "metric at defaults)")
    ag.add_argument(
        "-i", "--intervals", default=None, metavar="LOCI",
        help="genomic loci to restrict to, e.g. 'chr1:5k-10k,chr2' "
             "(decimal k/m suffixes; whole contig when no range)")
    ag.add_argument("--flags-required", type=int, default=0,
                    help="only records with ALL these SAM flag bits")
    ag.add_argument("--flags-forbidden", type=int, default=0,
                    help="only records with NONE of these SAM flag bits")
    ag.add_argument(
        "-t", "--tag", action="append", default=None, metavar="TG",
        help="only records carrying this two-char tag (repeatable; all "
             "must be present)")
    ag.add_argument("--format", default="tsv", choices=("tsv", "json"),
                    help="report format (default tsv)")
    ag.add_argument("-o", "--out", default=None,
                    help="write the report here instead of stdout")
    ag.add_argument("-m", "--max-split-size", default=None,
                    help="split size of the record loaders; a BAM is "
                         "aggregated whole, so it changes nothing here")
    _add_cache(ag)
    cs = sub.add_parser("compute-splits",
                        help="spark-bam's and hadoop-bam's splits of a BAM")
    _add_knobs(cs, "split size (byte shorthand like 2MB ok; default 32MB)")
    cs.add_argument("-s", "--spark-bam", action="store_true")
    cs.add_argument("-u", "--upstream", action="store_true")
    cs.add_argument("-l", "--print-limit", type=int, default=10)
    cs.add_argument("-o", "--out", default=None,
                    help="write the report here instead of stdout")
    cs.add_argument(
        "--plan-hosts", type=_positive_int, default=0, metavar="N",
        help="also print the N-host sharded-run IO plan")
    cs.add_argument(
        "--devices-per-host", type=_positive_int, default=8, metavar="D",
        help="devices per host for --plan-hosts (default 8)")
    _add_cache(cs)
    ix = sub.add_parser("index", help="write the .sbi split-index sidecar")
    _add_knobs(ix, "split size to plan for (byte shorthand like 2MB ok; "
                   "default 32MB)")
    ix.add_argument("-o", "--out", default=None,
                    help="write the .sbi here instead of the cache's place")
    ix.add_argument(
        "--record-starts", action="store_true",
        help="also index every record-start virtual position (the "
             "streaming check over the file)")
    ib = sub.add_parser("index-blocks", help="write the .blocks sidecar")
    ir = sub.add_parser("index-records", help="write the .records sidecar")
    ir.add_argument("-t", "--throw-on-truncation", action="store_true")
    ex = sub.add_parser("export",
                        help="write a BAM's records as columnar batches")
    ex.add_argument("-m", "--max-split-size", default=None,
                    help="split size of the record loaders; the frames "
                         "follow the row target, so it changes nothing")
    ex.add_argument(
        "-i", "--intervals", default=None, metavar="LOCI",
        help="genomic loci to restrict to, e.g. 'chr1:5k-10k,chr2' "
             "(decimal k/m suffixes; whole contig when no range)")
    ex.add_argument(
        "--format", default="native", choices=("native", "arrow", "parquet"),
        help="output format (arrow/parquet need pyarrow; default native)")
    ex.add_argument(
        "--columns", default=None, metavar="COLS",
        help="comma-separated column projection (default: all columns)")
    ex.add_argument(
        "--columnar", default=None, metavar="SPEC",
        help="columnar knobs, e.g. 'rows=8192,codec=zlib,level=6,"
             "columns=flag+pos+name' (SPARK_BAM_COLUMNAR works too)")
    ex.add_argument("-o", "--out", dest="export_out", required=True,
                    help="output file path")
    rw = sub.add_parser(
        "rewrite", aliases=["htsjdk-rewrite"],
        help="write a BAM's records again: re-blocked, recompressed")
    _add_knobs(rw, "split size of the .sbi sidecar's plan (byte shorthand "
                   "like 2MB ok; default 32MB)")
    _add_cache(rw)
    rw.add_argument("-b", "--block-payload", default="65280",
                    help="uncompressed bytes a BGZF member (default 65280)")
    rw.add_argument("--level", type=int, default=6,
                    help="zlib level of the host codec (default 6)")
    rw.add_argument(
        "-i", "--index", action="store_true",
        help="also write the .blocks, .records and .sbi sidecars of the "
             "output, from the packing metadata (no re-read)")
    rw.add_argument(
        "--deflate", default=None, metavar="SPEC",
        help="write-path codec, e.g. 'mode=fixed,lanes=16,device=auto': "
             "stored or fixed-Huffman members from the card's lanes, host "
             "zlib when off (SPARK_BAM_DEFLATE works too)")
    rw.add_argument("in_path")
    rw.add_argument("out_path")
    for p in (ag, cs, ix, ex, rw):
        p.add_argument("--device", default=None,
                       help="torch device (default: the current CUDA device)")
    for p in (ib, ir):
        p.add_argument("-o", "--out", default=None)
    for p in (ag, cs, ix, ib, ir, ex):
        p.add_argument("path")
    args = ap.parse_args(argv)
    # The cache line describes this invocation only.
    reset_cache_events()
    try:
        return _run(args)
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _run(args) -> int:
    if args.cmd == "index-blocks":
        from spark_bam_tpu_torch.bgzf.index_blocks import index_blocks

        out_path, count = index_blocks(args.path, args.out)
        print(f"Wrote {count} blocks to {out_path}", file=sys.stderr)
        return 0
    if args.cmd == "index-records":
        from spark_bam_tpu_torch.bam.index_records import index_records

        out_path, count = index_records(args.path, args.out,
                                        strict=args.throw_on_truncation)
        print(f"Wrote {count} records to {out_path}", file=sys.stderr)
        return 0
    if args.cmd in ("count-reads", "full-check"):
        kw = dict(sharded=args.sharded, devices=args.devices)
        if args.cmd == "count-reads":
            count_reads(args.path, args.num_iterations, args.device,
                        resident=args.resident, **kw)
        else:
            full_check(args.path, args.print_limit, args.device, **kw)
        return 0
    config = _config(args)
    split = config.split_size_or(Config.LOAD_SPLIT_SIZE_DEFAULT)
    if args.cmd == "compute-splits":
        out = open(args.out, "w") if args.out else None
        try:
            compute_splits(args.path, split, config, args.spark_bam,
                           args.upstream, args.device, out, args.print_limit,
                           args.plan_hosts, args.devices_per_host)
        finally:
            if out is not None:
                out.close()
    elif args.cmd == "index":
        index(args.path, split, config, args.out, args.record_starts,
              args.device)
    elif args.cmd == "export":
        export(args.path, args.export_out, args.format, args.intervals,
               args.columns, args.device, config=config)
    elif args.cmd in ("rewrite", "htsjdk-rewrite"):
        rewrite(args.in_path, args.out_path, args.block_payload, args.level,
                args.index, args.device, config=config)
    elif args.cmd == "aggregate":
        out = open(args.out, "w") if args.out else None
        try:
            aggregate(args.path, args.agg, args.intervals,
                      args.flags_required, args.flags_forbidden,
                      tuple(args.tag or ()), args.format, args.device, out,
                      config)
        finally:
            if out is not None:
                out.close()
    else:
        check_bam(args.path, args.device, sharded=args.sharded,
                  devices=args.devices, config=config)
    return 0
