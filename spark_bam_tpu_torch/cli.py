"""Command line: ``python -m spark_bam_tpu_torch COMMAND ... PATH``. This
module parses and dispatches; the record path's commands and the checker
context live in ``cli_app.py``.

``count-reads [-n N] [-m SIZE]`` prints the reference's default output:
spark-bam's count (``load_bam(...).count()``, every strict split start
resolved on the device) against hadoop-bam's, with both times and ``Read
counts matched: N`` (or the mismatch line, or hadoop-bam's exception).
``--resident`` and ``--sharded`` print the reference CLI's standalone
count lines (``spark-bam read-count time: MS`` and ``Read count: N`` per
iteration) and, but for ``--sharded``, its ``funnel:`` line: ``--resident``
(or ``Config.resident_scan``) counts with one device dispatch per resident
chunk (``StreamChecker.count_reads_resident``), ``--sharded`` across the
mesh (``parallel.stream_mesh.count_reads_sharded``). On a ``.cram``
path it prints the standalone lines of ``load_reads(...).count()`` (no
hadoop-bam leg, as in the reference); ``--resident`` and ``--sharded``
are usage errors there. ``-F/--reference FASTA`` on ``count-reads``,
``aggregate`` and ``export`` decodes a CRAM written reference-based
(``RR=true``); ``aggregate`` and ``export`` also read ``.sam`` and
``.cram`` paths, on the host, as the reference does.
``full-check [-l N] [--sharded]`` prints the reference's streaming
full-check report (``full-check --streaming``; with ``--sharded`` the
report reduced across the mesh, the same output): the critical and
two-check sections with ``block:offset`` positions, the total error counts
and the ``funnel:`` line. ``check-bam [-s|-u] [-i RANGES]`` prints the
reference's check report: the eager checker (its verdict at every position
on the device) against the seqdoop checker, or ``-s`` / ``-u`` one of them
against the ``.records`` sidecar, over the blocks starting inside the
``-i`` byte ranges; ``check-bam --sharded [--cache MODE]`` prints the
reference's sharded report against the ``.records`` sidecar, its ``.sbi``
cache line included (``-u`` and ``-i`` are refused there, as the
reference refuses them). ``check-blocks [-s|-u] [-i RANGES]`` compares
the same checkers' first record start in every BGZF block;
``compare-splits [-m SIZE] BAMS-FILE`` spark-bam's and hadoop-bam's
splits of every BAM listed; ``time-load [-m SIZE]`` times each split's
first read through both loaders; ``index-bam [-o OUT]`` writes the
``.bai`` of a coordinate-sorted BAM.

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

``serve [--listen ADDR] [--serve SPEC] [--cache MODE] [--reads-to-check N]
[--funnel MODE] [--jobs SPEC] [--disk-chaos SPEC]`` runs the split service
(``serve/``) on ``unix:<path>`` or ``tcp:<host>:<port>`` (default
``tcp:127.0.0.1:8765``) until interrupted,
printing the reference's ``serving on ...`` line to stderr; ``--serve`` (or
``SPARK_BAM_SERVE``) sets its batching, admission and window knobs.

``fabric [--fabric SPEC] [--serve SPEC] [--jobs SPEC] [--disk-chaos SPEC]
[--listen ADDR] [--attach ADDR]...
[--worker-devices N] [--device DEV]`` launches ``workers`` serve worker
processes (``fabric/worker.py``; every visible CUDA device each, or
``--worker-devices`` entries of ``--device``), or attaches to running ones,
and fronts them with the fabric router (affinity, health probes, failover,
the latency autoscaler) on ``--listen``, printing the reference's
``fabric: routing on ...`` line to stderr; ``--fabric`` (or
``SPARK_BAM_FABRIC``) is exported to launched workers. SIGTERM drains it
and leaves a router ``drain`` flight dump under ``SPARK_BAM_FLIGHT_DIR``.

The durable job plane (``jobs/``): ``rewrite --durable [--checkpoint N]``
and ``export --durable [--checkpoint N]`` run through the journaled job
runners (checkpoints every N records, or N container frames, default from
``--jobs`` / ``SPARK_BAM_JOBS``): a re-run of the same command after a
crash resumes from the last durable checkpoint, and the artifact equals an
uninterrupted run's byte for byte; each prints the job's result as JSON.
``export --durable`` writes the native container of the whole file only.
``scrub [--source BAM] [--quarantine] [--stride N] [-o OUT] PATH...``
checks rewritten BAMs (with their sidecars) and native containers and
prints the reference's JSON report: exit 0 when clean, 3 on findings.
``--jobs SPEC`` (``dir=...,checkpoint=...,frames=...,mem=...,max=...``)
sets the job plane of ``rewrite``, ``export``, ``serve`` and ``fabric``
(``fabric`` exports it to the workers it launches, so they share the jobs
dir), and ``--disk-chaos SEED:SPEC`` installs the seeded disk-fault seam
at entry (``fabric`` exports it as ``SPARK_BAM_DISK_CHAOS``). A bad spec
is a usage error before any work.

Every path may be a URL: ``http(s)://``, ``gs://`` and ``s3://`` (and
schemes registered with ``core.channel.register_scheme``) read through the
remote data plane. ``--faults SPEC`` sets the partition executor's policy
(``retries=N``, ``mode=tolerant``, ...; with it ``export`` runs through
the executor), ``--chaos SEED:SPEC`` installs seeded read faults over
every channel and prints ``chaos(seed=N): injected ...`` at the end,
``--limits SPEC`` the decode limits (process-wide for the run),
``--remote SPEC`` the remote data plane (reset when the command ends) and
``-w`` the root log level WARN, on the commands where the reference's
parser takes them. ``fuzz-decode [--seed N] [--mutants M] [--formats
bam,bgzf,cram,sbi] [-o OUT]`` runs the decode fuzz
(``tools/fuzz_decode.py``), prints its JSON summary and exits 1 on a
violation.

Observability (``obs/``): ``--metrics-out PATH`` on every command (or
``SPARK_BAM_METRICS_OUT``) turns the metrics registry on for the run,
opens the root ``cli.<command>`` span and writes the JSONL trace there
when the command ends (a ``{pid}`` placeholder or a directory gives each
process a file of its own); ``--profile DIR`` (or ``SPARK_BAM_PROFILE``)
captures one inflate window under ``torch.profiler`` as a Chrome trace in
``DIR``. ``metrics-report TRACE...`` renders one trace in the reference's
stats format, or merges several processes' files by trace id into one
tree a request. ``serve`` and ``fabric`` take ``--slo SPEC`` (or
``SPARK_BAM_SLO``): objectives for the burn-rate engine, which turns the
registry on. ``top ADDRESS [--prometheus] [--watch [--interval S]]``
renders a worker's or a router's ``telemetry`` answer.

Every command runs on the CUDA device unless ``--device`` names another;
``--sharded`` meshes are every visible CUDA device, or ``--devices N``
entries of ``--device`` (``--device cpu --devices 4``: a 4-entry CPU mesh).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np

from spark_bam_tpu_torch import cli_app, obs
from spark_bam_tpu_torch.bgzf.flat import metas_block_table, pos_of_flat_tables
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.check.flags import FLAG_NAMES, bit_counts
from spark_bam_tpu_torch.agg.plan import AggConfig
from spark_bam_tpu_torch.compress.config import DeflateConfig
from spark_bam_tpu_torch.cli_app import Printer, UsageError, funnel_status_line
from spark_bam_tpu_torch.core.config import Config, format_bytes, parse_bytes
from spark_bam_tpu_torch.core import guard
from spark_bam_tpu_torch.core.faults import (
    FaultPolicy,
    install_chaos,
    install_disk_chaos,
    parse_disk_chaos,
    uninstall_chaos,
    uninstall_disk_chaos,
)
from spark_bam_tpu_torch.core.guard import DecodeLimits
from spark_bam_tpu_torch.core.remote_plan import RemoteConfig, set_remote_config
from spark_bam_tpu_torch.parallel.executor import reset_last_report
from spark_bam_tpu_torch.tools import fuzz_decode
from spark_bam_tpu_torch.core.stats import Stats
from spark_bam_tpu_torch.fabric.config import FabricConfig
from spark_bam_tpu_torch.jobs.manager import JobsConfig, job_id_of
from spark_bam_tpu_torch.obs.slo import SloConfig
from spark_bam_tpu_torch.serve.config import ServeConfig
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
from spark_bam_tpu_torch.tpu.inflate import PROFILE_ENV
from spark_bam_tpu_torch.tpu.stream_check import (
    StreamChecker,
    full_check_summary_streaming,
)


#: ``scrub``'s exit code when it found (and reported) integrity findings:
#: distinct from 2 (usage) and 1 (crash), as the reference's.
RC_FINDINGS = 3


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
                sharded: bool = False, devices: int | None = None,
                reference=None) -> int:
    out = sys.stdout if out is None else out
    config = Config() if config is None else config
    if str(path).endswith(".cram"):
        return _count_cram(path, iterations, device, out, resident, config,
                           sharded, reference)
    if not (sharded or resident or config.resident_scan):
        return cli_app.count_reads(
            path, Printer(out=out),
            config.split_size_or(Config.LOAD_SPLIT_SIZE_DEFAULT), config,
            iterations, device)
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


def _count_cram(path, iterations: int, device, out, resident: bool,
                config: Config, sharded: bool, reference) -> int:
    """``count-reads`` of a CRAM (reference count_reads.py:35-80): CRAM has
    no BGZF blocks to window, so only the record loader counts, with no
    hadoop-bam leg."""
    if resident and sharded:
        raise UsageError("--resident and --sharded are mutually exclusive")
    for flag, on in (("--resident", resident), ("--sharded", sharded)):
        if on:
            raise UsageError(
                f"{flag} supports BAM only: CRAM has no BGZF block "
                "structure to window (use the default count-reads path)")
    split = config.split_size_or(Config.LOAD_SPLIT_SIZE_DEFAULT)
    return _timed_counts(
        lambda: api.load_reads(path, split, config, device=device,
                               reference=reference).count(),
        iterations, out)


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
               sharded: bool = False, devices: int | None = None,
               config: Config | None = None) -> dict:
    """The streaming full-check report of one BAM (reduced across the mesh
    with ``sharded``); returns its summary."""
    p = Printer(out=out, limit=print_limit)
    config = Config() if config is None else config
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
              devices: int | None = None, config: Config | None = None,
              spark_bam: bool = False, hadoop_bam: bool = False,
              ranges=None, print_limit: int = 10) -> dict | None:
    """check-bam's report: by default the eager verdict (on ``device``)
    against seqdoop's or, with ``spark_bam`` / ``hadoop_bam``, one of them
    against the ``.records`` sidecar; with ``sharded`` the eager verdict
    against the sidecar across the mesh, whose confusion stats it
    returns."""
    config = Config() if config is None else config
    if not sharded:
        ctx = cli_app.CheckerContext(path, config,
                                     Printer(out=out, limit=print_limit),
                                     ranges=ranges, device=device)
        cli_app.check_bam(ctx, spark_bam, hadoop_bam)
        return None
    # --sharded is eager against the truth (-s composes); the seqdoop
    # oracle and byte ranges have no sharded path, as in the reference.
    if hadoop_bam:
        raise UsageError(
            "--sharded scores the eager checker against the .records "
            "truth; the seqdoop oracle (-u) has no sharded path")
    if ranges is not None:
        raise UsageError(
            "--sharded checks the whole file; -i/--intervals is not "
            "supported on the sharded path")
    p = Printer(out=out)
    metas = blocks_metadata(path)
    mesh = _sharded_mesh(device, devices)
    stats = check_bam_sharded(path, config, mesh=mesh, metas=metas)
    # The data blocks' compressed bytes (the EOF sentinel excluded), as
    # the reference's report sums them.
    compressed = sum(m.compressed_size for m in metas)
    cli_app.print_report_header(
        p, stats["positions"], compressed,
        stats["true_positives"] + stats["false_negatives"])
    p.echo(f"checked across {stats['devices']} device(s)",
           cache_status_line(path, config), funnel_status_line(config))
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
              config: Config | None = None, reference=None) -> dict:
    """The aggregate report of one BAM, CRAM or SAM query; returns the
    result."""
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
                           device=device, reference=reference)
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
           config: Config | None = None, reference=None) -> dict:
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
                         columns=columns, config=config, device=device,
                         reference=reference)
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


def durable_export(path, out_path: str, fmt: str = "native",
                   loci: str | None = None, columns: str | None = None,
                   checkpoint: int | None = None, device=None, out=None,
                   config: Config | None = None, reference=None) -> dict:
    """``export --durable``: the journaled export job (reference
    ``cli/main.py``), keyed by its spec under the jobs root; prints and
    returns the job's result. The job streams the whole file's native
    frames, so a format or loci that would change the frame list is
    refused."""
    from spark_bam_tpu_torch.columnar.config import ColumnarConfig
    from spark_bam_tpu_torch.columnar.schema import normalize_columns
    from spark_bam_tpu_torch.device import resolve_device
    from spark_bam_tpu_torch.jobs.runner import run_export_job

    p = Printer(out=out)
    config = Config() if config is None else config
    if fmt != "native":
        raise UsageError("--durable export supports --format native only")
    if loci or reference:
        raise UsageError("--durable export does not take -i/--reference")
    try:
        if columns:
            normalize_columns(columns)
        ColumnarConfig.parse(config.columnar)
    except ValueError as e:
        raise UsageError(str(e)) from e
    dev = resolve_device(device)   # raises without a card
    spec = {"op": "export", "path": path, "out": out_path,
            "columns": columns}
    spec = {k: v for k, v in spec.items() if v is not None}
    jcfg = config.jobs_config
    res = run_export_job(
        spec, os.path.join(jcfg.root(), job_id_of(spec)), config=config,
        checkpoint=checkpoint or jcfg.frames, device=dev,
    )
    p.echo(json.dumps(res, indent=2, sort_keys=True))
    return res


def durable_rewrite(in_path, out_path, block_payload="65280", level: int = 6,
                    index: bool = False, checkpoint: int | None = None,
                    device=None, out=None, config: Config | None = None
                    ) -> dict:
    """``rewrite --durable``: the journaled rewrite job (reference
    ``cli/main.py``), its codec from ``config.deflate``; a re-run of the
    same command resumes it. Prints and returns the job's result."""
    from spark_bam_tpu_torch.device import resolve_device
    from spark_bam_tpu_torch.jobs.runner import run_rewrite_job

    p = Printer(out=out)
    config = Config() if config is None else config
    try:
        payload = parse_bytes(block_payload)
        DeflateConfig.parse(config.deflate)
    except ValueError as e:
        raise UsageError(str(e)) from e
    dev = resolve_device(device)   # raises without a card
    spec = {"op": "rewrite", "path": in_path, "out": out_path,
            "block_payload": payload, "level": level,
            "index": True if index else None}
    spec = {k: v for k, v in spec.items() if v is not None}
    jcfg = config.jobs_config
    res = run_rewrite_job(
        spec, os.path.join(jcfg.root(), job_id_of(spec)), config=config,
        checkpoint=checkpoint or jcfg.checkpoint, device=dev,
    )
    p.echo(json.dumps(res, indent=2, sort_keys=True))
    return res


def scrub(paths, source: str | None = None, quarantine: bool = False,
          stride: int = 16, out=None) -> int:
    """The scrubber's JSON report (reference ``cli/scrub.py``); returns 0
    when every artifact is clean, else ``RC_FINDINGS``."""
    from spark_bam_tpu_torch.jobs.scrub import scrub_paths

    report = scrub_paths(paths, source=source, quarantine=quarantine,
                         stride=stride)
    Printer(out=out).echo(json.dumps(report.summary(), indent=2,
                                     sort_keys=True))
    return 0 if report.clean else RC_FINDINGS


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


def serve(listen: str, device=None, config: Config = Config()) -> None:
    """Run the split service on ``listen`` until interrupted, over
    ``device`` (default: every visible CUDA device, refusing without
    one)."""
    from spark_bam_tpu_torch.parallel.mesh import local_mesh
    from spark_bam_tpu_torch.serve import (
        ServeAddress,
        SplitService,
        serve_forever,
    )

    try:
        addr = ServeAddress(listen)
    except ValueError as e:
        raise UsageError(str(e)) from e
    service = SplitService(
        config, mesh=local_mesh(None if device is None else [device]))
    where = addr.path if addr.kind == "unix" else f"{addr.host}:{addr.port}"
    print(f"serving on {listen} ({where}; {service.mesh.n_local} devices) "
          "— Ctrl-C to stop", file=sys.stderr, flush=True)
    try:
        serve_forever(service, listen)
    except KeyboardInterrupt:
        pass
    finally:
        service.close()


def fabric(listen: str, attach, worker_devices: int, device=None,
           config: Config = Config()) -> None:
    """Launch (or attach to) the serve workers and route among them on
    ``listen`` until SIGTERM or Ctrl-C drains the router."""
    import signal

    import asyncio

    from spark_bam_tpu_torch.fabric import Router, WorkerPool
    from spark_bam_tpu_torch.obs import flight
    from spark_bam_tpu_torch.serve import ServeAddress, start_server

    try:
        ServeAddress(listen)
    except ValueError as e:
        raise UsageError(str(e)) from e
    fcfg = config.fabric_config
    # Launched workers inherit the fabric spec (a chaos run's seed lands in
    # their flight dumps too), the job plane's (workers that share its dir
    # resume each other's jobs), the disk-fault seam (every worker
    # installs the same seeded schedule) and the SLO objectives (every
    # worker runs the burn-rate engine).
    worker_env = None
    exported = {"SPARK_BAM_FABRIC": config.fabric,
                "SPARK_BAM_JOBS": config.jobs,
                "SPARK_BAM_DISK_CHAOS": config.disk_chaos,
                "SPARK_BAM_SLO": config.slo}
    exported = {k: v for k, v in exported.items() if v}
    if exported:
        worker_env = dict(os.environ, **exported)
    pool = WorkerPool(workers=fcfg.workers, devices=worker_devices,
                      device=device, serve=config.serve,
                      columnar=config.columnar, attach=attach,
                      env=worker_env)
    router = None

    def _drain():
        # Drain: stop routing new work; the workers get SIGTERM below and
        # finish their in-flight ticks unshed.
        flight.record("sigterm", signum=int(signal.SIGTERM), who="router")
        if router is not None:
            router.draining = True

    def _graceful(signum, frame):
        _drain()
        raise KeyboardInterrupt

    async def route():
        # On the loop, SIGTERM wakes the selector whichever thread the
        # signal reached, and stops the accept loop between callbacks.
        stopped = asyncio.Event()

        def on_sigterm():
            _drain()
            stopped.set()

        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM,
                                                      on_sigterm)
        server = await start_server(router, ServeAddress(listen))
        await stopped.wait()
        server.close()

    # Installed before the workers start: a SIGTERM while they come up
    # still terminates them below, and a supervisor that SIGTERMs on
    # seeing the announce gets a clean drain.
    signal.signal(signal.SIGTERM, _graceful)
    try:
        addresses = pool.start()
        router = Router(addresses, config=config)
        chaos_note = (f" [chaos {router.chaos.describe()}]"
                      if router.chaos is not None else "")
        print(f"fabric: routing on {listen} over {len(addresses)} workers "
              f"({'attached' if attach else 'launched'}: "
              f"{', '.join(addresses)}){chaos_note} — Ctrl-C to stop",
              file=sys.stderr, flush=True)
        asyncio.run(route())
    except KeyboardInterrupt:
        pass
    except BaseException as exc:
        # The router narrates its own crash before unwinding.
        flight.dump_auto("crash", who="router",
                         extra={"error": repr(exc),
                                "workers": pool.addresses})
        raise
    finally:
        pool.terminate()
        flight.dump_auto("drain", who="router", extra={
            "counters": dict(router.counters) if router else {},
            "moves": list(router.moves)[-32:] if router else []})


@contextlib.contextmanager
def metrics_session(command: str, metrics_out: str | None = None,
                    profile: str | None = None, slo: str | None = None):
    """One CLI run's observability (reference ``cli/main.py``):
    ``metrics_out`` (else ``SPARK_BAM_METRICS_OUT``) turns the registry
    on, the block runs inside the root ``cli.<command>`` span, and the
    trace is written after that span closes, then the registry shut down
    so in-process callers start the next run clean. An SLO spec turns the
    registry on without a trace to write (the engine reads its rings).
    ``profile`` (``--profile``) is set as ``SPARK_BAM_PROFILE`` for the
    run, so the inflate loops (and launched workers) capture one window.
    Yields the resolved trace path, or None."""
    metrics_out = metrics_out or os.environ.get("SPARK_BAM_METRICS_OUT")
    if metrics_out:
        obs.configure()
        metrics_out = obs.resolve_metrics_path(metrics_out)
    elif slo:
        obs.configure()
    if profile:
        os.environ[PROFILE_ENV] = profile
    root = obs.span(f"cli.{command}")
    root.__enter__()
    try:
        yield metrics_out
    finally:
        if profile:
            os.environ.pop(PROFILE_ENV, None)
        root.__exit__(None, None, None)
        if metrics_out:
            obs.export_jsonl(metrics_out)
            obs.shutdown()


def metrics_report(paths, p: Printer) -> None:
    """``metrics-report``: one trace file in the reference's stats format,
    or several processes' files merged by trace id."""
    from spark_bam_tpu_torch.obs.report import (
        render_merged_report,
        render_report,
    )

    paths = list(paths)
    p.echo(render_report(paths[0]) if len(paths) == 1
           else render_merged_report(paths))


def _add_metrics(p) -> None:
    p.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="turn observability on for this run and write the JSONL "
             "metrics trace here when it ends; a directory or a {pid} "
             "placeholder gives each process its own file "
             "(SPARK_BAM_METRICS_OUT works too; render with metrics-report)")
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="capture one inflate window under torch.profiler as a Chrome "
             "trace in DIR (SPARK_BAM_PROFILE works too; launched fabric "
             "workers inherit it)")


def _add_knobs(p, split_help: str) -> None:
    p.add_argument("-m", "--max-split-size", default=None, help=split_help)
    p.add_argument("-z", "--bgzf-blocks-to-check", type=int, default=None)
    p.add_argument("--reads-to-check", type=int, default=None)
    p.add_argument("--max-read-size", type=int, default=None)


def _add_reference(p) -> None:
    p.add_argument("-F", "--reference", default=None,
                   help="FASTA for reference-based (RR=true) CRAM decode")


def _add_inflate(p) -> None:
    p.add_argument(
        "--inflate", default=None, metavar="SPEC",
        help="read-path inflate knobs, e.g. 'tokenize=host' (bare "
             "'device'/'host' ok): where the DEFLATE entropy phase of the "
             "device inflate runs (SPARK_BAM_INFLATE works too)")


def _add_cache(p) -> None:
    p.add_argument(
        "--cache", default=None, metavar="MODE",
        help="split-index (.sbi) cache mode: off|read|write|readwrite, "
             "optional ',strict' suffix raises on stale sidecars "
             "(SPARK_BAM_CACHE works too)")


def _add_faults(p) -> None:
    p.add_argument(
        "--faults", default=None, metavar="SPEC",
        help="fault-tolerance policy of partition execution, e.g. "
             "'retries=3,backoff=0.05,deadline=60,hedge=2,mode=tolerant' "
             "(SPARK_BAM_FAULTS works too)")
    p.add_argument(
        "--chaos", default=None, metavar="SEED:SPEC",
        help="seeded fault injection on every opened channel, e.g. "
             "'7:io=0.1,latency=0.05x10,short=0.02,corrupt=1e-6': the same "
             "seed replays the same faults")


def _add_limits(p) -> None:
    p.add_argument(
        "--limits", default=None, metavar="SPEC",
        help="decode limits of untrusted input, e.g. 'record=32MB,refs=1000,"
             "cigar=65536,alloc=1GB' (SPARK_BAM_LIMITS works too)")


def _add_remote(p) -> None:
    p.add_argument(
        "--remote", default=None, metavar="SPEC",
        help="remote data plane, e.g. 'mode=plan,depth=8,gap=128KB,"
             "request=512KB,hedge=3,pool=64' (mode=legacy: cursor "
             "read-ahead; depth=0 adapts; SPARK_BAM_REMOTE works too)")


def _add_warn(p) -> None:
    p.add_argument("-w", "--warn", action="store_true",
                   help="root log level WARN")


def _positive_int(s: str) -> int:
    v = int(s)
    if v <= 0:
        raise argparse.ArgumentTypeError(f"must be a positive integer: {s}")
    return v


def _config(args) -> Config:
    """``SPARK_BAM_CACHE``, ``SPARK_BAM_COLUMNAR``, ``SPARK_BAM_DEFLATE``,
    ``SPARK_BAM_FAULTS``, ``SPARK_BAM_SERVE``, ``SPARK_BAM_FABRIC``,
    ``SPARK_BAM_JOBS``, ``SPARK_BAM_DISK_CHAOS``, ``SPARK_BAM_INFLATE``,
    ``SPARK_BAM_LIMITS``, ``SPARK_BAM_REMOTE`` and ``SPARK_BAM_SLO``, then
    the command's flags: the split size, the checker knobs, ``--cache``,
    ``--columnar``, ``--deflate``, ``--serve``, ``--funnel``,
    ``--fabric``, ``--jobs``, ``--disk-chaos``, ``--inflate``,
    ``--faults``, ``--limits``, ``--remote`` and ``--slo`` (a bad size or
    spec is a usage error)."""
    kw = {}
    for knob in ("bgzf_blocks_to_check", "reads_to_check", "max_read_size",
                 "cache", "columnar", "deflate", "serve", "funnel",
                 "fabric", "jobs", "disk_chaos", "inflate", "faults",
                 "limits", "remote", "slo"):
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
        ServeConfig.parse(config.serve)
        FabricConfig.parse(config.fabric)
        JobsConfig.parse(config.jobs)
        if config.disk_chaos:
            parse_disk_chaos(config.disk_chaos)
        FaultPolicy.parse(config.faults)
        DecodeLimits.parse(config.limits)
        RemoteConfig.parse(config.remote)
        SloConfig.parse(config.slo)
    except ValueError as e:
        raise UsageError(str(e)) from e
    return config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spark_bam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cr = sub.add_parser(
        "count-reads", help="count the records of a BAM: spark-bam's loader "
                            "against hadoop-bam's")
    cr.add_argument("-n", "--num-iterations", type=int, default=1)
    cr.add_argument("--resident", action="store_true",
                    help="one device dispatch per resident chunk of windows")
    _add_reference(cr)
    _add_knobs(cr, "split size of the record loaders (byte shorthand like "
                   "2MB ok; default 32MB)")
    fc = sub.add_parser("full-check",
                        help="all 19 checks at every position of a BAM")
    fc.add_argument("-l", "--print-limit", type=int, default=10)
    cb = sub.add_parser(
        "check-bam", help="the eager checker against seqdoop's, or either "
                          "against the .records sidecar")
    ck = sub.add_parser(
        "check-blocks", help="the checkers' first record start in every "
                             "BGZF block")
    for p in (cb, ck):
        _add_knobs(p, "split size (byte shorthand like 2MB ok)")
        p.add_argument("-s", "--spark-bam", action="store_true",
                       help="score the eager checker against the .records "
                            "index")
        p.add_argument("-u", "--upstream", action="store_true",
                       help="score the seqdoop checker against the "
                            ".records index")
        p.add_argument(
            "-i", "--intervals", default=None,
            help="comma-separated compressed byte-ranges (start-end|"
                 "start+len|point, byte shorthand ok); only blocks "
                 "starting inside are checked")
        p.add_argument("-l", "--print-limit", type=int, default=10)
        p.add_argument("-o", "--out", default=None,
                       help="write the report here instead of stdout")
        _add_cache(p)
    ck.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ck.add_argument("path")
    cp = sub.add_parser(
        "compare-splits", help="spark-bam's and hadoop-bam's splits of many "
                               "BAMs")
    tl = sub.add_parser(
        "time-load", help="each split's first read through spark-bam's and "
                          "hadoop-bam's loaders")
    for p in (cp, tl):
        _add_knobs(p, "split size (byte shorthand like 2MB ok; default "
                      "32MB)")
        p.add_argument("-l", "--print-limit", type=int, default=10)
        p.add_argument("-o", "--out", default=None,
                       help="write the report here instead of stdout")
        _add_cache(p)
        p.add_argument("--device", default=None,
                       help="torch device (default: the current CUDA "
                            "device)")
    cp.add_argument("bams", help="file holding one BAM path a line")
    tl.add_argument("path")
    ib_ = sub.add_parser("index-bam",
                         help="write the .bai of a coordinate-sorted BAM")
    ib_.add_argument("-o", "--out", default=None)
    ib_.add_argument("path")
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
                        help="aggregate statistics of a BAM, CRAM or SAM "
                             "query")
    _add_reference(ag)
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
    for p in (cr, fc, cb, ag, cs, ix):
        _add_inflate(p)
    ib = sub.add_parser("index-blocks", help="write the .blocks sidecar")
    ir = sub.add_parser("index-records", help="write the .records sidecar")
    ir.add_argument("-t", "--throw-on-truncation", action="store_true")
    ex = sub.add_parser("export",
                        help="write a BAM's, CRAM's or SAM's records as "
                             "columnar batches")
    _add_reference(ex)
    ex.add_argument("-m", "--max-split-size", default=None,
                    help="split size of the record loaders (default "
                         "32MB): each split's records follow the chain "
                         "from its first start")
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
    _add_inflate(ex)
    sc = sub.add_parser(
        "scrub", help="check rewritten and exported artifacts end to end")
    sc.add_argument(
        "--source", default=None, metavar="BAM",
        help="the BAM the artifacts were rewritten from: turns on record "
             "parity (every --stride'th record compared byte for byte)")
    sc.add_argument(
        "--quarantine", action="store_true",
        help="rename artifacts with findings to <path>.quarantined")
    sc.add_argument(
        "--stride", type=_positive_int, default=16, metavar="N",
        help="record-parity sampling stride (default 16; 1 = every record)")
    sc.add_argument("-o", "--out", default=None,
                    help="write the JSON report here instead of stdout")
    _add_warn(sc)
    sc.add_argument(
        "paths", nargs="+",
        help="artifacts to scrub (a BAM pulls in its .blocks, .records and "
             ".sbi sidecars; native containers stand alone)")
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
    sv = sub.add_parser(
        "serve", help="the split service: a daemon over the device mesh")
    _add_cache(sv)
    sv.add_argument(
        "--serve", default=None, metavar="SPEC",
        help="serving knobs, e.g. 'batch=16,tick=2,plan_queue=64,"
             "scan_queue=128,workers=2,window=1MB,halo=64KB,cache=256MB' "
             "(SPARK_BAM_SERVE works too)")
    sv.add_argument(
        "--listen", default="tcp:127.0.0.1:8765", metavar="ADDR",
        help="unix:<path> or tcp:<host>:<port> (default tcp:127.0.0.1:8765)")
    sv.add_argument("--reads-to-check", type=int, default=None)
    sv.add_argument("--funnel", default=None, choices=("on", "off", "auto"),
                    help="the two-stage candidate funnel of the count rows "
                         "(default auto: on)")
    fb = sub.add_parser(
        "fabric", help="route among serve workers: affinity, health, "
                       "failover, autoscaling")
    fb.add_argument(
        "--fabric", default=None, metavar="SPEC",
        help="fabric knobs, e.g. 'workers=3,slo=200,probe=500,spill=8,"
             "batch_ceil=32' (SPARK_BAM_FABRIC works too); resilience: "
             "budget/budget_rate, flap_k/flap_window/holddown, "
             "brownout[_frac], stream=1 for the resumable streaming relay; "
             "seeded chaos: 'chaos=SEED:drop=0.05+trunc=0.02+delay=0.1x20'")
    fb.add_argument(
        "--serve", default=None, metavar="SPEC",
        help="per-worker serving knobs, forwarded to every launched worker")
    fb.add_argument(
        "--listen", default="tcp:127.0.0.1:8765", metavar="ADDR",
        help="router address: unix:<path> or tcp:<host>:<port> (default "
             "tcp:127.0.0.1:8765)")
    fb.add_argument(
        "--attach", action="append", default=None, metavar="ADDR",
        help="attach to a running worker instead of launching (repeatable: "
             "one for every host's `multihost --serve` address)")
    fb.add_argument(
        "--worker-devices", type=int, default=0, metavar="N",
        help="mesh entries a LAUNCHED worker serves: N copies of --device, "
             "or the first N CUDA devices (0: every CUDA device, or one "
             "entry of --device)")
    _add_warn(fb)
    for p in (ag, cs, ix, ex, rw, sv):
        p.add_argument("--device", default=None,
                       help="torch device (default: the current CUDA device)")
    for p in (ex, rw):
        p.add_argument(
            "--durable", action="store_true",
            help="run through the journaled job runner: checkpoints to a "
                 "write-ahead log; a re-run after a crash resumes from the "
                 "last durable checkpoint and writes a byte-identical "
                 "artifact (SPARK_BAM_JOBS sets the job dir and cadence)")
        p.add_argument(
            "--checkpoint", type=_positive_int, default=None, metavar="N",
            help="with --durable: checkpoint cadence (records for rewrite, "
                 "frames for export; default from --jobs)")
    for p in (ex, rw, sv, fb):
        p.add_argument(
            "--jobs", default=None, metavar="SPEC",
            help="durable-job knobs, e.g. 'dir=/var/jobs,checkpoint=5000,"
                 "frames=8,mem=0.92,max=2' (SPARK_BAM_JOBS works too)")
        p.add_argument(
            "--disk-chaos", default=None, metavar="SEED:SPEC",
            help="seeded filesystem-fault injection on every guarded "
                 "write, e.g. '7:enospc=0.02+eio=0.01+short=0.01+torn=0.01+"
                 "rename=0.05'; fabric workers inherit it through "
                 "SPARK_BAM_DISK_CHAOS")
    fb.add_argument("--device", default=None,
                    help="torch device of the launched workers (default: "
                         "every visible CUDA device; cpu for the plain "
                         "versions)")
    for p in (ib, ir):
        p.add_argument("-o", "--out", default=None)
    for p in (ag, cs, ix, ib, ir, ex):
        p.add_argument("path")
    fz = sub.add_parser(
        "fuzz-decode", help="structure-aware mutation fuzzing of the BAM, "
                            "BGZF and .sbi decoders")
    fuzz_decode.add_arguments(fz)
    mr = sub.add_parser(
        "metrics-report", help="render --metrics-out JSONL traces; several "
                               "processes' files merge by trace id")
    mr.add_argument(
        "trace", nargs="+",
        help="JSONL trace(s) --metrics-out runs wrote; pass every "
             "per-process file of one fleet run to merge spans by trace id")
    tp = sub.add_parser(
        "top", help="a serve worker's or a fabric router's telemetry: "
                    "health, queues, p50/p99, host/h2d/dev split, SLO burn")
    tp.add_argument(
        "--prometheus", action="store_true",
        help="print the (fleet-merged) Prometheus exposition text instead "
             "of the human view")
    tp.add_argument(
        "--watch", action="store_true",
        help="live mode: clear and re-render every --interval seconds "
             "(Ctrl-C to stop)")
    tp.add_argument(
        "--interval", type=float, default=2.0, metavar="S",
        help="--watch refresh cadence in seconds (default 2)")
    tp.add_argument(
        "address", help="serve worker or fabric router address "
                        "(tcp:host:port or unix:path)")
    for p in (mr, tp):
        p.add_argument("-o", "--out", default=None,
                       help="write the output here instead of stdout")
    for p in (sv, fb):
        p.add_argument(
            "--slo", default=None, metavar="SPEC",
            help="SLO objectives and burn-rate alerting, e.g. "
                 "'serve.latency:p99<1500ms@5m;serve.errors:ratio<0.1%%@1h;"
                 "sample=0.1' (SPARK_BAM_SLO works too); fabric exports it "
                 "to the workers it launches")
    # Aliases share their parser: each parser once.
    for p in {id(p): p for p in sub.choices.values()}.values():
        _add_metrics(p)
    for p in (cr, fc, cb, ck, cp, tl, cs, ag, ex, sv):
        _add_faults(p)
        _add_limits(p)
        _add_remote(p)
    for p in (ix, fb):
        _add_faults(p)
    for p in (sc, fz):
        _add_limits(p)
    for p in (cr, fc, cb, ck, cp, tl, cs, ag, ex, ix, sv):
        _add_warn(p)
    args = ap.parse_args(argv)
    if getattr(args, "warn", False):
        logging.getLogger().setLevel(logging.WARNING)
    # The cache line describes this invocation only.
    reset_cache_events()
    reset_last_report()
    prev_limits = guard._active
    chaos_state = None
    try:
        try:
            if getattr(args, "faults", None):
                FaultPolicy.parse(args.faults)
            if getattr(args, "limits", None) is not None:
                # Process-wide, so every decoder this run reaches reads them.
                guard.set_limits(DecodeLimits.parse(args.limits))
            if getattr(args, "remote", None) is not None:
                set_remote_config(RemoteConfig.parse(args.remote))
            if getattr(args, "chaos", None):
                chaos_state = install_chaos(args.chaos)
        except ValueError as e:
            raise UsageError(str(e)) from e
        slo = getattr(args, "slo", None) or os.environ.get("SPARK_BAM_SLO")
        with metrics_session(args.cmd, args.metrics_out, args.profile, slo):
            rc = _run(args)
            if args.cmd == "export":
                cli_app.print_fault_summary(Printer())
            if chaos_state is not None:
                injected = ", ".join(f"{k}={v}" for k, v in
                                     chaos_state.injected.items() if v)
                Printer().echo(f"chaos(seed={chaos_state.seed}): injected "
                               f"{injected or 'nothing'}")
        return rc
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if getattr(args, "disk_chaos", None):
            uninstall_disk_chaos()
        if chaos_state is not None:
            uninstall_chaos()
        if getattr(args, "remote", None) is not None:
            # In-process callers start the next run clean.
            set_remote_config(None)
        guard.set_limits(prev_limits)


def _run(args) -> int:
    if args.cmd in ("metrics-report", "top"):
        out = open(args.out, "w") if args.out else None
        try:
            if args.cmd == "metrics-report":
                metrics_report(args.trace, Printer(out=out))
            else:
                from spark_bam_tpu_torch import cli_top

                cli_top.run(args.address, Printer(out=out),
                            prometheus=args.prometheus, watch=args.watch,
                            interval_s=args.interval)
        finally:
            if out is not None:
                out.close()
        return 0
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
        kw = dict(sharded=args.sharded, devices=args.devices,
                  config=_config(args))
        if args.cmd == "count-reads":
            count_reads(args.path, args.num_iterations, args.device,
                        resident=args.resident, reference=args.reference,
                        **kw)
        else:
            full_check(args.path, args.print_limit, args.device, **kw)
        return 0
    if args.cmd == "index-bam":
        cli_app.index_bam(args.path, args.out)
        return 0
    if args.cmd == "fuzz-decode":
        return fuzz_decode.run_from_args(args)
    if args.cmd == "scrub":
        out = open(args.out, "w") if args.out else None
        try:
            return scrub(args.paths, args.source, args.quarantine,
                         args.stride, out)
        finally:
            if out is not None:
                out.close()
    config = _config(args)
    if getattr(args, "disk_chaos", None):
        # In-process for rewrite, export and serve; fabric also exports it
        # to the workers it launches.
        install_disk_chaos(args.disk_chaos)
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
    elif args.cmd == "export" and args.durable:
        durable_export(args.path, args.export_out, args.format,
                       args.intervals, args.columns, args.checkpoint,
                       args.device, config=config, reference=args.reference)
    elif args.cmd == "export":
        export(args.path, args.export_out, args.format, args.intervals,
               args.columns, args.device, config=config,
               reference=args.reference)
    elif args.cmd in ("rewrite", "htsjdk-rewrite") and args.durable:
        durable_rewrite(args.in_path, args.out_path, args.block_payload,
                        args.level, args.index, args.checkpoint, args.device,
                        config=config)
    elif args.cmd in ("rewrite", "htsjdk-rewrite"):
        rewrite(args.in_path, args.out_path, args.block_payload, args.level,
                args.index, args.device, config=config)
    elif args.cmd == "serve":
        serve(args.listen, args.device, config)
    elif args.cmd == "fabric":
        fabric(args.listen, args.attach, args.worker_devices, args.device,
               config)
    elif args.cmd == "aggregate":
        out = open(args.out, "w") if args.out else None
        try:
            aggregate(args.path, args.agg, args.intervals,
                      args.flags_required, args.flags_forbidden,
                      tuple(args.tag or ()), args.format, args.device, out,
                      config, args.reference)
        finally:
            if out is not None:
                out.close()
    else:
        _run_check(args, config, split)
    return 0


def _run_check(args, config: Config, split: int) -> None:
    """check-bam, check-blocks, compare-splits and time-load, each
    writing its report to ``-o`` or stdout."""
    from spark_bam_tpu_torch.core.ranges import parse_ranges

    try:
        ranges = parse_ranges(getattr(args, "intervals", None))
    except ValueError as e:
        raise UsageError(str(e)) from e
    out = open(args.out, "w") if args.out else None
    try:
        p = Printer(out=out, limit=args.print_limit)
        if args.cmd == "check-bam":
            check_bam(args.path, args.device, out, sharded=args.sharded,
                      devices=args.devices, config=config,
                      spark_bam=args.spark_bam, hadoop_bam=args.upstream,
                      ranges=ranges, print_limit=args.print_limit)
        elif args.cmd == "compare-splits":
            cli_app.compare_splits(args.bams, p, split, config,
                                   device=args.device)
        else:
            ctx = cli_app.CheckerContext(args.path, config, p, ranges=ranges,
                                         device=args.device)
            if args.cmd == "check-blocks":
                cli_app.check_blocks(ctx, args.spark_bam, args.upstream)
            else:
                cli_app.time_load(ctx, split)
    finally:
        if out is not None:
            out.close()
