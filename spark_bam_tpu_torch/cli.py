"""Command line: ``python -m spark_bam_tpu_torch count-reads [-n N]
[--resident | --sharded] PATH``, ``python -m spark_bam_tpu_torch full-check
[-l N] [--sharded] PATH``, ``python -m spark_bam_tpu_torch check-bam
--sharded PATH`` and ``python -m spark_bam_tpu_torch aggregate PATH``.

``count-reads`` prints the reference CLI's standalone count lines
(``spark-bam read-count time: MS`` and ``Read count: N`` per iteration) and,
but for ``--sharded``, its ``funnel:`` line; ``--resident`` (or
``Config.resident_scan``) counts with one device dispatch per resident chunk
(``StreamChecker.count_reads_resident``), ``--sharded`` across the mesh
(``parallel.stream_mesh.count_reads_sharded``). ``full-check`` prints the
reference's streaming full-check report (``full-check --streaming``; with
``--sharded`` the report reduced across the mesh, the same output): the
critical and two-check sections with ``block:offset`` positions, the
total error counts and the ``funnel:`` line. ``check-bam --sharded``
prints the reference's sharded check-bam report against the ``.records``
sidecar (without the ``.sbi`` cache line: the port has no ``.sbi`` cache);
the eager-against-seqdoop check-bam is not ported. Every command runs on
the CUDA device unless ``--device`` names another; ``--sharded`` meshes
are every visible CUDA device, or ``--devices N`` entries of ``--device``
(``--device cpu --devices 4``: a 4-entry CPU mesh).

``aggregate [-a SPEC] [-i LOCI] [--flags-required N] [--flags-forbidden N]
[-t TG]... [--format tsv|json] [-o OUT] PATH`` prints the reference's
aggregate report: one ``metric<TAB>key<TAB>value`` line per populated
bucket (tsv), or the whole result as one JSON object, and a timing line on
stderr. A bad spec, loci or tag is a usage error before any work.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

from spark_bam_tpu_torch.bgzf.flat import metas_block_table, pos_of_flat_tables
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.check.flags import FLAG_NAMES, bit_counts
from spark_bam_tpu_torch.agg.plan import AggConfig
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.load import api
from spark_bam_tpu_torch.load.intervals import BadLociError, LociSet
from spark_bam_tpu_torch.parallel.mesh import make_mesh
from spark_bam_tpu_torch.parallel.stream_mesh import (
    check_bam_sharded,
    count_reads_sharded,
    full_check_summary_sharded,
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


def _format_bytes(n: int) -> str:
    """1024-based size with 3 significant figures and a K/M/G/T suffix
    ("583K", "25.6K"), as the reference report prints it."""
    for unit, shift in (("E", 60), ("P", 50), ("T", 40), ("G", 30),
                        ("M", 20), ("K", 10)):
        if n >= (1 << shift):
            v = n / (1 << shift)
            if v < 10:
                txt = f"{v:.2f}".rstrip("0").rstrip(".")
            elif v < 100:
                txt = f"{v:.1f}".rstrip("0").rstrip(".")
            else:
                txt = str(round(v))
            return f"{txt}{unit}"
    return str(n)


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
           f"{_format_bytes(compressed)} compressed",
           "Compression ratio: %.2f" % (total / compressed),
           f"{stats['true_positives'] + stats['false_negatives']} reads",
           f"checked across {stats['devices']} device(s)",
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
              tags_required=(), fmt: str = "tsv", device=None, out=None
              ) -> dict:
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
                           tags_required=tuple(tags_required), device=device)
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
    ag.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ag.add_argument("path")
    args = ap.parse_args(argv)
    if args.cmd == "aggregate":
        out = open(args.out, "w") if args.out else None
        try:
            aggregate(args.path, args.agg, args.intervals,
                      args.flags_required, args.flags_forbidden,
                      tuple(args.tag or ()), args.format, args.device, out)
        except UsageError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        finally:
            if out is not None:
                out.close()
        return 0
    kw = dict(sharded=args.sharded, devices=args.devices)
    try:
        if args.cmd == "count-reads":
            count_reads(args.path, args.num_iterations, args.device,
                        resident=args.resident, **kw)
        elif args.cmd == "full-check":
            full_check(args.path, args.print_limit, args.device, **kw)
        else:
            check_bam(args.path, args.device, **kw)
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0
