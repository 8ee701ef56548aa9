"""The record path's commands and the checker commands' shared context
(reference ``spark_bam_tpu/cli/app.py``, ``check_bam.py``,
``check_blocks.py``, ``compare_splits.py``, ``time_load.py``,
``count_reads.py`` and ``main.py``'s ``index-bam``); ``cli.py`` parses
the arguments and dispatches here. Each prints the reference CLI's
output line for line.

- ``CheckerContext``: one BAM's flat view, header and verdicts. The eager
  verdict at every position is ``TpuChecker.check_buffer`` on the
  context's device (the ``full_check_flags`` kernel on the card, exact by
  its host recheck of escaped lanes), never a host engine chosen by file
  size; the seqdoop verdict and the ``.records`` truth are host NumPy.
  ``-i`` byte ranges narrow the positions scored to the blocks starting
  inside them.
- ``count_reads``: ``load_bam(...).count()`` against hadoop-bam's count,
  with the times and the match line (``count-reads`` without
  ``--resident`` or ``--sharded``).
- ``check_bam``: eager against seqdoop, or ``-s`` eager / ``-u`` seqdoop
  against the ``.records`` truth; the confusion report, the annotated
  false positives, the ``.sbi`` cache line and the ``funnel:`` line (the
  reference's text: the full pass runs, no funnel).
- ``check_blocks``: the same checkers' first record start in every BGZF
  block.
- ``compare_splits``: spark-bam's splits (resolved on the device) against
  hadoop-bam's, one task per BAM on a thread pool.
- ``time_load``: each split's first read through both loaders.
- ``index_bam``: the ``.bai`` of a coordinate-sorted BAM.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass
from functools import cached_property

import numpy as np

from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bam.index_records import read_records_index
from spark_bam_tpu_torch.bam.record import BamRecord
from spark_bam_tpu_torch.bgzf.flat import FlatView, flatten_file
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.check.flags import Flags
from spark_bam_tpu_torch.check.seqdoop import seqdoop_check_flat
from spark_bam_tpu_torch.check.vectorized import check_flat
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.channel import path_size
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.core.stats import Stats, format_bytes_binary
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.parallel.executor import (
    ParallelConfig,
    last_report,
    map_partitions,
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
                       full_masks: bool = False, device: bool = True) -> str:
    """The ``funnel: …`` line: the configured mode, whether the two-stage
    prefilter ran on this path, and its measured reduction. ``device``
    False gives the reference's line of a path its host engine serves."""
    mode = config.funnel
    if not device or not config.funnel_enabled(full_masks):
        if mode == "off":
            why = "disabled"
        elif not device:
            why = "host engine, no device hot path"
        else:
            why = "full per-position flag masks requested"
        return f"funnel: off ({mode}: {why})"
    if stats and stats.get("screened"):
        screened = int(stats["screened"])
        survivors = int(stats["survivors"])
        return (
            f"funnel: on ({mode}): {screened} positions -> {survivors} "
            f"survivors, {screened / max(survivors, 1):.1f}x reduction"
        )
    return f"funnel: on ({mode})"


def print_report_header(p: Printer, total: int, compressed: int,
                        num_reads: int) -> None:
    """The check report's four header lines: positions, compressed size,
    ratio, reads."""
    p.echo(f"{total} uncompressed positions",
           f"{format_bytes_binary(compressed)} compressed",
           "Compression ratio: %.2f" % (total / compressed),
           f"{num_reads} reads")


def print_fault_summary(p: Printer) -> None:
    """The reference CLI's postscript: the last job's retries, hedges and
    quarantines, when it had any."""
    rep = last_report()
    if rep is not None and (rep.retries or rep.hedges or rep.quarantined
                            or rep.lost_records or rep.lost_blocks):
        p.echo(rep.summary())


def render_record(rec: BamRecord, names) -> str:
    """HTSJDK-style record rendering with the reference's location suffix
    (PosMetadata.scala:35-55)."""
    pair = ""
    if rec.flag & 0x1:
        pair = " 2/2" if rec.flag & 0x80 else " 1/2"
    kind = "unmapped" if rec.is_unmapped else "aligned"
    s = f"{rec.read_name}{pair} {rec.read_length}b {kind} read"
    if rec.is_unmapped and rec.pos >= 0 and 0 <= rec.ref_id < len(names):
        s += f" (placed at {names[rec.ref_id]}:{rec.pos + 1})"
    elif not rec.is_unmapped:
        s += f" @ {names[rec.ref_id]}:{rec.pos + 1}"
    return s


@dataclass
class PosAnnotation:
    pos: Pos
    delta: int | None
    record_str: str | None
    flags: Flags

    def __str__(self) -> str:
        rec = (f"{self.delta} before {self.record_str}"
               if self.record_str is not None else "no next record")
        return f"{self.pos}:\t{rec}. Failing checks: {self.flags}"


class CheckerContext:
    """One BAM's flat view, header and checker verdicts, built lazily;
    ``ranges`` (a ``RangeSet`` of compressed byte ranges) narrows the
    positions scored. ``device=None`` is the current CUDA device and
    raises without one."""

    def __init__(self, path, config: Config = Config(),
                 printer: Printer | None = None, ranges=None, device=None):
        self.path = str(path)
        self.config = config
        self.printer = printer or Printer()
        self.ranges = ranges
        self.device = resolve_device(device)

    @cached_property
    def header(self):
        return read_header(self.path)

    @cached_property
    def lengths(self) -> np.ndarray:
        return np.asarray(self.header.contig_lengths, dtype=np.int32)

    @cached_property
    def view(self) -> FlatView:
        return flatten_file(self.path)

    @cached_property
    def compressed_size(self) -> int:
        return path_size(self.path)

    @cached_property
    def selected_compressed_size(self) -> int:
        """The checked blocks' compressed bytes (``-i`` honoured, the EOF
        block excluded), as the reference's accumulator sums them."""
        return sum(m.compressed_size for m in blocks_metadata(self.path)
                   if self.ranges is None or m.start in self.ranges)

    @cached_property
    def position_mask(self) -> np.ndarray | None:
        """Flat positions whose block starts inside the byte ranges
        (reference Blocks.Args --intervals, Blocks.scala:33-41)."""
        if self.ranges is None:
            return None
        mask = np.zeros(self.view.size, dtype=bool)
        flats = self.view.block_flat
        for i, start in enumerate(self.view.block_starts):
            if int(start) in self.ranges:
                end = (self.view.size if i + 1 == len(flats)
                       else int(flats[i + 1]))
                mask[int(flats[i]): end] = True
        return mask

    @cached_property
    def eager_result(self):
        """The eager verdict, fail masks and chained reads at every
        position: ``TpuChecker.check_buffer`` (funnel off) on the
        context's device, or the host pass ``check_flat`` when
        ``Config.backend`` is numpy, python or native (the reference's
        ``_use_tpu_backend``; ``auto`` never picks the host by size)."""
        from spark_bam_tpu_torch.tpu.checker import TpuChecker

        if self.config.host_backend:
            return check_flat(self.view.data, self.lengths, at_eof=True,
                              reads_to_check=self.config.reads_to_check)
        want = min(self.config.window_size, max(self.view.size, 1))
        window = 1 << max(20, (want - 1).bit_length())
        checker = TpuChecker(self.lengths, window=window,
                             halo=min(self.config.halo_size, window // 4),
                             reads_to_check=self.config.reads_to_check,
                             device=self.device)
        return checker.check_buffer(self.view.data, at_eof=True)

    @cached_property
    def eager_verdict(self) -> np.ndarray:
        return self.eager_result.verdict

    @cached_property
    def seqdoop_verdict(self) -> np.ndarray:
        return seqdoop_check_flat(self.view, len(self.lengths))

    @cached_property
    def truth(self) -> np.ndarray:
        truth = np.zeros(self.view.size, dtype=bool)
        for pos in read_records_index(self.path + ".records"):
            truth[self.view.flat_of_pos(pos.block_pos, pos.offset)] = True
        return truth

    @cached_property
    def true_flat_eager(self) -> np.ndarray:
        return np.flatnonzero(self.eager_verdict)

    def annotate(self, flat_idx: int) -> PosAnnotation:
        """The next record and the failing checks of one position
        (reference PosMetadata.apply)."""
        pos = Pos(*self.view.pos_of_flat(flat_idx))
        res = self.eager_result
        flags = Flags.from_mask(int(res.fail_mask[flat_idx]),
                                int(res.reads_before[flat_idx]))
        true_flat = self.true_flat_eager
        j = int(np.searchsorted(true_flat, flat_idx))
        if (j < len(true_flat)
                and true_flat[j] - flat_idx < self.config.max_read_size):
            nxt = int(true_flat[j])
            rec, _ = BamRecord.decode(self.view.data, nxt)
            return PosAnnotation(pos, nxt - flat_idx,
                                 render_record(rec, self.header.contig_names),
                                 flags)
        return PosAnnotation(pos, None, None, flags)

    def print_header_and_confusion(self, expected: np.ndarray,
                                   actual: np.ndarray) -> None:
        """The check report (reference CheckerApp.scala:64-222)."""
        p = self.printer
        sel = self.position_mask
        if sel is not None:
            expected = expected & sel
            actual = actual & sel
            in_scope = int(sel.sum())
        else:
            in_scope = self.view.size
        tp = int((expected & actual).sum())
        fp_idx = np.flatnonzero(~expected & actual)
        fn_idx = np.flatnonzero(expected & ~actual)
        print_report_header(p, in_scope, self.selected_compressed_size,
                            tp + len(fn_idx))
        if not len(fp_idx) and not len(fn_idx):
            p.echo("All calls matched!")
            return
        p.echo(f"{len(fp_idx)} false positives, {len(fn_idx)} false "
               "negatives", "")
        if len(fp_idx):
            annotations = [self.annotate(int(i)) for i in fp_idx]
            hist: dict[str, int] = {}
            for a in annotations:
                hist[str(a.flags)] = hist.get(str(a.flags), 0) + 1
            p.print_limited(
                [f"{count}:\t{flags}" for flags, count in
                 sorted(hist.items(), key=lambda kv: -kv[1])],
                header="False-positive-site flags histogram:",
                truncated_header=lambda n: (
                    "False-positive-site flags histogram:"),
            )
            p.echo("")
            p.print_limited(
                [str(a) for a in annotations],
                header="False positives with succeeding read info:",
                truncated_header=lambda n: (
                    f"{n} of {len(fp_idx)} false positives with succeeding "
                    "read info::"),
            )
        if len(fn_idx):
            p.print_limited(
                [str(Pos(*self.view.pos_of_flat(int(i)))) for i in fn_idx],
                header=f"{len(fn_idx)} false negatives:",
                truncated_header=lambda n: (
                    f"{n} of {len(fn_idx)} false negatives:"),
            )

    def verdicts(self, spark_bam: bool, hadoop_bam: bool):
        """``(expected, actual)``: ``-s`` the truth against eager, ``-u``
        the truth against seqdoop, else eager against seqdoop."""
        if spark_bam and not hadoop_bam:
            return self.truth, self.eager_verdict
        if hadoop_bam and not spark_bam:
            return self.truth, self.seqdoop_verdict
        return self.eager_verdict, self.seqdoop_verdict


def _ms_since(t0: float) -> int:
    return int((time.perf_counter() - t0) * 1000)


def count_reads(path, p: Printer, split_size: int, config: Config,
                iterations: int = 1, device=None) -> int:
    """spark-bam's count (``load_bam``: split starts resolved on
    ``device``) against hadoop-bam's, ``iterations`` times (reference
    count_reads.py:84-114); returns spark-bam's count."""
    from spark_bam_tpu_torch.load.api import load_bam
    from spark_bam_tpu_torch.load.hadoop import hadoop_bam_count

    dev = resolve_device(device)

    def run_once():
        t0 = time.perf_counter()
        spark_count = load_bam(path, split_size, config, device=dev).count()
        spark_ms = _ms_since(t0)
        try:
            t0 = time.perf_counter()
            hadoop_count = hadoop_bam_count(path, split_size, config)
            return spark_ms, spark_count, _ms_since(t0), hadoop_count, None
        except Exception as e:
            return spark_ms, spark_count, None, None, e

    results = [run_once() for _ in range(max(iterations, 1))]
    for spark_ms, spark_count, hadoop_ms, hadoop_count, error in results:
        p.echo(f"spark-bam read-count time: {spark_ms}")
        if error is None:
            p.echo(f"hadoop-bam read-count time: {hadoop_ms}", "")
            if spark_count == hadoop_count:
                p.echo(f"Read counts matched: {spark_count}", "")
            else:
                p.echo(f"Read counts mismatched: {spark_count} via "
                       f"spark-bam, {hadoop_count} via hadoop-bam", "")
        else:
            p.echo("", f"spark-bam found {spark_count} reads, hadoop-bam "
                       "threw exception:",
                   f"{type(error).__module__}.{type(error).__name__}: "
                   f"{error}")
    print_fault_summary(p)
    return results[-1][1]


def check_bam(ctx: CheckerContext, spark_bam: bool = False,
              hadoop_bam: bool = False) -> None:
    """check-bam's default report (reference check_bam.py:41-48)."""
    from spark_bam_tpu_torch.sbi.store import cache_status_line

    ctx.print_header_and_confusion(*ctx.verdicts(spark_bam, hadoop_bam))
    ctx.printer.echo(cache_status_line(ctx.path, ctx.config))
    # The reference's line: its default check-bam runs no funnel.
    ctx.printer.echo(funnel_status_line(ctx.config, device=False))


def _next_read_start(view, verdict_flat, flat, max_read_size):
    j = int(np.searchsorted(verdict_flat, flat))
    if j < len(verdict_flat) and verdict_flat[j] - flat < max_read_size:
        return Pos(*view.pos_of_flat(int(verdict_flat[j])))
    return None


def check_blocks(ctx: CheckerContext, spark_bam: bool = False,
                 hadoop_bam: bool = False) -> None:
    """The checkers' first record start in every BGZF block, mismatches
    weighted by the previous block's compressed size (reference
    CheckBlocks.scala:25-201)."""
    p = ctx.printer
    v1, v2 = ctx.verdicts(spark_bam, hadoop_bam)
    flat1, flat2 = np.flatnonzero(v1), np.flatnonzero(v2)
    metas = [m for m in blocks_metadata(ctx.path)
             if ctx.ranges is None or m.start in ctx.ranges]
    total_compressed = ctx.compressed_size
    max_read_size = ctx.config.max_read_size
    mismatches = []   # (block start, previous compressed size, pos1, pos2)
    offsets_hist: dict[int | None, int] = {}
    prev = None
    for meta in metas:
        flat = ctx.view.flat_of_pos(meta.start, 0)
        pos1 = _next_read_start(ctx.view, flat1, flat, max_read_size)
        pos2 = _next_read_start(ctx.view, flat2, flat, max_read_size)
        offset = (pos1.offset if pos1 is not None
                  and pos1.block_pos == meta.start else None)
        offsets_hist[offset] = offsets_hist.get(offset, 0) + 1
        if pos1 != pos2:
            mismatches.append((meta.start,
                               prev.compressed_size if prev else 1,
                               pos1, pos2))
        prev = meta

    def print_offsets_info():
        keys = set(offsets_hist)
        n_empty = offsets_hist.get(None, 0)
        if keys == {None, 0}:
            p.echo("", f"{offsets_hist[0]} blocks start with a read,"
                       f" {n_empty} blocks didn't contain a read")
        elif keys == {0}:
            p.echo("", "All blocks start with reads")
        else:
            stats = Stats.from_hist(
                [(k, v) for k, v in offsets_hist.items() if k is not None],
                rounded=True)
            p.echo("", "Offsets of blocks' first reads "
                       f"({n_empty} blocks didn't contain a read start):",
                   stats.show())

    if not mismatches:
        p.echo(f"First read-position matched in {len(metas)} BGZF blocks "
               f"totaling {format_bytes_binary(total_compressed, True)} "
               "(compressed)")
        print_offsets_info()
        return
    bad_compressed = sum(m[1] for m in mismatches)
    p.echo(f"First read-position mismatched in {len(mismatches)} of "
           f"{len(metas)} BGZF blocks", "",
           f"{bad_compressed} of {total_compressed}"
           f" ({bad_compressed / total_compressed}) compressed positions"
           " would lead to bad splits")
    print_offsets_info()
    p.echo("")

    def show_pos(pos):
        return str(pos) if pos is not None else "-"

    p.print_limited(
        [f"{start} (prev block size: {prev_size}):\t{show_pos(p1)}\t"
         f"{show_pos(p2)}" for start, prev_size, p1, p2 in mismatches],
        header=f"{len(mismatches)} mismatched blocks:",
        truncated_header=lambda n: (
            f"{n} of {len(mismatches)} mismatched blocks:"),
    )


@dataclass
class PathResult:
    path: str
    our_ms: int
    their_ms: int
    num_ours: int
    num_theirs: int
    diffs: list  # [(side, Split)]


def _compare_path(path: str, split_size: int, config: Config,
                  device) -> PathResult:
    from spark_bam_tpu_torch.load.hadoop import hadoop_bam_splits
    from spark_bam_tpu_torch.load.splits import diff_splits, spark_bam_splits

    t0 = time.perf_counter()
    ours = spark_bam_splits(path, split_size, config, device=device)
    our_ms = _ms_since(t0)
    t0 = time.perf_counter()
    theirs = hadoop_bam_splits(path, split_size, config=config)
    their_ms = _ms_since(t0)
    return PathResult(path, our_ms, their_ms, len(ours), len(theirs),
                      diff_splits(ours, theirs))


def compare_splits(bams_path, p: Printer, split_size: int,
                   config: Config = Config(),
                   parallel: ParallelConfig = ParallelConfig(),
                   device=None) -> None:
    """spark-bam's splits against hadoop-bam's for every BAM listed in
    ``bams_path``, one task a BAM (reference
    CompareSplits.scala:15-166). The tasks run on a thread pool (or,
    with ``parallel`` ``processes``, in spawned processes)."""
    dev = resolve_device(device)
    with open(bams_path) as f:
        paths = [line.strip() for line in f if line.strip()]
    results = map_partitions(
        lambda path: _compare_path(path, split_size, config, dev), paths,
        parallel)
    total_ours = sum(r.num_ours for r in results)
    total_theirs = sum(r.num_theirs for r in results)
    bad = [r for r in results if r.diffs]

    def sides(r):
        n_ours = sum(1 for side, _ in r.diffs if side == "ours")
        return n_ours, len(r.diffs) - n_ours

    if bad:
        n_our_bad = sum(sides(r)[0] for r in bad)
        n_their_bad = sum(sides(r)[1] for r in bad)
        p.echo(f"{len(bad)} of {len(results)} BAMs' splits didn't match"
               f" (totals: {total_ours}, {total_theirs};"
               f" {n_our_bad}, {n_their_bad} unmatched)", "")
    else:
        p.echo(f"All {len(results)} BAMs' splits"
               f" (totals: {total_ours}, {total_theirs}) matched!", "")
    p.echo("Total split-computation time:")
    p.echo(f"\thadoop-bam:\t{sum(r.their_ms for r in results)}")
    p.echo(f"\tspark-bam:\t{sum(r.our_ms for r in results)}")
    p.echo("")
    ratios = [r.their_ms / r.our_ms if r.our_ms else float(r.their_ms)
              for r in results]
    if len(ratios) > 1:
        p.echo("Ratios:")
        p.echo(Stats(ratios).show(), "")
    else:
        p.echo("Ratio: %s" % round(ratios[0], 2), "")
    for r in bad:
        n_ours, n_theirs = sides(r)
        p.echo(f"\t{os.path.basename(r.path)}: {len(r.diffs)} splits differ"
               f" (totals: {r.num_ours}, {r.num_theirs};"
               f" mismatched: {n_ours}, {n_theirs}):")
        for side, s in r.diffs:
            indent = "\t\t\t" if side == "theirs" else "\t\t"
            p.echo(f"{indent}{s.start}-{s.end}")
        p.echo("")
    p.echo("")


def time_load(ctx: CheckerContext, split_size: int) -> None:
    """Each split's first read through spark-bam's splits (resolved on
    the context's device) and through hadoop-bam's (reference
    TimeLoad.scala)."""
    from spark_bam_tpu_torch.load.hadoop import (
        hadoop_bam_read_split,
        hadoop_bam_splits,
    )
    from spark_bam_tpu_torch.load.splits import spark_bam_splits

    p = ctx.printer
    t0 = time.perf_counter()
    our_splits = spark_bam_splits(ctx.path, split_size, ctx.config,
                                  device=ctx.device)
    our_first = []
    for split in our_splits:
        flat = ctx.view.flat_of_pos(split.start.block_pos, split.start.offset)
        rec, _ = BamRecord.decode(ctx.view.data, flat)
        our_first.append(rec.read_name)
    p.echo(f"spark-bam first-read collection time: {_ms_since(t0)}")
    try:
        t0 = time.perf_counter()
        their_first = []
        for split in hadoop_bam_splits(ctx.path, split_size,
                                       config=ctx.config):
            for _, rec in hadoop_bam_read_split(ctx.view, len(ctx.lengths),
                                                split):
                their_first.append(rec.read_name)
                break
        their_ms = _ms_since(t0)
    except Exception as e:
        p.echo("", f"spark-bam collected {len(our_first)} partitions' "
                   "first-reads",
               "hadoop-bam threw an exception:",
               f"{type(e).__module__}.{type(e).__name__}: {e}")
        return
    p.echo(f"hadoop-bam first-read collection time: {their_ms}", "")
    ours, theirs = set(our_first), set(their_first)
    if ours == theirs:
        p.echo(f"All {len(our_splits)} partition-start reads matched", "")
        return
    only_ours = sorted(ours - theirs)
    only_theirs = sorted(theirs - ours)
    p.echo(f"{len(only_ours)} spark-bam-only reads, {len(only_theirs)} "
           "hadoop-bam-only:")
    for name in only_ours:
        p.echo(f"\t{name}")
    p.echo("")
    for name in only_theirs:
        p.echo(f"\t\t{name}")
    p.echo("")


def index_bam(path, out_path=None) -> str:
    """Write the ``.bai`` of a coordinate-sorted BAM; prints the
    reference's ``Wrote ...`` line to stderr."""
    from spark_bam_tpu_torch.bam.bai import index_bam as write_bai

    out_path, idx = write_bai(path, out_path)
    n_chunks = sum(len(cs) for ref in idx.references
                   for cs in ref.bins.values())
    print(f"Wrote {out_path}: {len(idx.references)} references, "
          f"{n_chunks} chunks, {idx.n_no_coor} unplaced reads",
          file=sys.stderr)
    return out_path
