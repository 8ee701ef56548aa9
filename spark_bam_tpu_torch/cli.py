"""Command line: ``python -m spark_bam_tpu_torch count-reads [-n N] PATH``.

Prints the reference CLI's standalone count lines (``spark-bam read-count
time: MS`` and ``Read count: N`` per iteration) and its ``funnel:`` line.
Runs on the CUDA device unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import sys
import time

from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.tpu.stream_check import StreamChecker


def funnel_status_line(config: Config, stats: dict | None) -> str:
    mode = config.funnel
    if stats and stats.get("screened"):
        screened = int(stats["screened"])
        survivors = int(stats["survivors"])
        return (
            f"funnel: on ({mode}): {screened} positions -> {survivors} "
            f"survivors, {screened / max(survivors, 1):.1f}x reduction"
        )
    return f"funnel: on ({mode})"


def count_reads(path, iterations: int = 1, device=None, out=None) -> int:
    out = sys.stdout if out is None else out
    config = Config()
    checker = StreamChecker(path, config, device=device)
    count = 0
    for _ in range(max(iterations, 1)):
        t0 = time.perf_counter()
        count = checker.count_reads()
        ms = int((time.perf_counter() - t0) * 1e3)
        out.write(f"spark-bam read-count time: {ms}\n")
        out.write(f"Read count: {count}\n\n")
    out.write(funnel_status_line(config, checker.funnel_stats) + "\n\n")
    return count


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m spark_bam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cr = sub.add_parser("count-reads", help="count the records of a BAM")
    cr.add_argument("-n", "--num-iterations", type=int, default=1)
    cr.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    cr.add_argument("path")
    args = ap.parse_args(argv)
    count_reads(args.path, args.num_iterations, args.device)
    return 0
