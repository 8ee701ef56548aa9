"""Where the time of the sharded workloads goes on the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_sharded [--mib 256]

Writes a synthetic BAM (``--mib`` MiB uncompressed, seed 11) under the
package's ``_build/`` directory and runs on ``make_mesh()``:

1. ``full_check_summary_sharded`` at K = 2^17 sites a row, once to warm up,
   then timed: the wall; its host split (waiting for the next step's rows
   from the assembly thread, the step call, which queues every row's check
   and reduction and waits for the totals and site lists, and the rest:
   the host's site collection); the assembly thread's own time per row;
   and each row's card time in the check and in the reduction (CUDA
   events, ``timed_full_rows``). Then once under ``torch.profiler``:
   device busy share and launch calls per row.
2. ``count_reads_sharded`` against ``StreamChecker.count_reads`` (the
   fused count), in turns (sharded, fused, fused, sharded) after a warm-up
   of each, and the sharded count under ``torch.profiler``.

Prints the card's name and power limit and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import statistics
import time
from pathlib import Path

import torch

from spark_bam_tpu_torch import (
    Config,
    StreamChecker,
    count_reads_sharded,
    full_check_summary_sharded,
    make_mesh,
)
from spark_bam_tpu_torch.benchmarks.profile_count import _card, _profiled
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.parallel import mesh as pm
from spark_bam_tpu_torch.parallel import stream_mesh as sm

K_SITES = 1 << 17


@contextlib.contextmanager
def timed_full_rows():
    """While open, every row of the full step records CUDA events around
    its check and its reduction, and every step the fill of its site
    lists. Yields ``{"rows": [(start, after check, after reduction)],
    "most_sites": int}``; read the events after a synchronise."""
    out = {"rows": [], "most_sites": 0}
    marks = []
    real_row, real_check = pm._full_row, pm.check_window
    real_step = pm.FullStep.__call__

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def check(*a, **kw):
        res = real_check(*a, **kw)
        marks.append(event())
        return res

    def row(*a, **kw):
        e0 = event()
        res = real_row(*a, **kw)
        out["rows"].append((e0, marks.pop(), event()))
        return res

    def step(self, *a, **kw):
        res = real_step(self, *a, **kw)
        out["most_sites"] = max(out["most_sites"],
                                int((res[1] >= 0).sum(1).max()),
                                int((res[3] >= 0).sum(1).max()))
        return res

    pm._full_row, pm.check_window, pm.FullStep.__call__ = row, check, step
    try:
        yield out
    finally:
        pm._full_row, pm.check_window = real_row, real_check
        pm.FullStep.__call__ = real_step


def row_ms(rows) -> dict:
    """Medians and maxima of the check and reduction times of rows
    recorded by ``timed_full_rows``."""
    check = [a.elapsed_time(b) for a, b, _ in rows]
    red = [b.elapsed_time(c) for _, b, c in rows]
    return {"rows": len(rows),
            "check_ms_median": statistics.median(check),
            "check_ms_max": max(check),
            "reduce_ms_median": statistics.median(red),
            "reduce_ms_max": max(red)}


@contextlib.contextmanager
def host_split():
    """While open, times (host clock) the waits for assembled steps, the
    step calls of the full step, and the assembly thread's work."""
    t = {"wait_s": 0.0, "step_s": 0.0, "assemble_s": 0.0, "assembled": 0}
    real_batches = sm._ShardedStream.batches
    real_assemble = sm._ShardedStream._assemble
    real_step = pm.FullStep.__call__

    def batches(self, *a, **kw):
        gen = real_batches(self, *a, **kw)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    return
                t["wait_s"] += time.perf_counter() - t0
                yield item
        finally:
            gen.close()

    def assemble(self, *a, **kw):
        t0 = time.perf_counter()
        res = real_assemble(self, *a, **kw)
        t["assemble_s"] += time.perf_counter() - t0
        t["assembled"] += self.step_rows_local
        return res

    def step(self, *a, **kw):
        t0 = time.perf_counter()
        res = real_step(self, *a, **kw)
        t["step_s"] += time.perf_counter() - t0
        return res

    sm._ShardedStream.batches = batches
    sm._ShardedStream._assemble = assemble
    pm.FullStep.__call__ = step
    try:
        yield t
    finally:
        sm._ShardedStream.batches = real_batches
        sm._ShardedStream._assemble = real_assemble
        pm.FullStep.__call__ = real_step


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sharded needs a CUDA device")
    card = _card()
    print(card, flush=True)
    work = Path(__file__).resolve().parent.parent / "_build" / "profile_sh"
    work.mkdir(parents=True, exist_ok=True)
    try:
        bam = work / "profile.bam"
        manifest = synth_bam(bam, args.mib << 20, seed=11)
        mesh = make_mesh()

        def full():
            return full_check_summary_sharded(bam, Config(), mesh=mesh,
                                              k_positions=K_SITES)

        full()
        with host_split() as split, timed_full_rows() as rows:
            summary, wall = _wall(full)
        rows_n = len(rows["rows"])
        split["rest_s"] = wall - split["wait_s"] - split["step_s"]
        split["assemble_ms_per_row"] = (split["assemble_s"] * 1e3
                                        / max(split.pop("assembled"), 1))
        result = {"card": card, "mib": args.mib, "rows": rows_n,
                  "devices": summary["devices"], "full_check": {
                      "wall_s": wall, "host_split": split,
                      "row_card_ms": row_ms(rows["rows"]),
                      "most_sites": rows["most_sites"]}}
        prof = _profiled(full, rows_n)
        prof.pop("count")
        result["full_check"]["profiled"] = prof
        print(f"full-check sharded: {result['full_check']}", flush=True)

        checker = StreamChecker(bam, Config())
        sharded_first, first_s = _wall(
            lambda: count_reads_sharded(bam, Config(), mesh=mesh))
        fused_first, fused_first_s = _wall(checker.count_reads)
        walls = {"sharded": [], "fused": []}
        for name in ("sharded", "fused", "fused", "sharded"):
            fn = (checker.count_reads if name == "fused" else
                  lambda: count_reads_sharded(bam, Config(), mesh=mesh))
            got, s = _wall(fn)
            assert got == manifest["reads"], (name, got)
            walls[name].append(s)
        assert sharded_first == fused_first == manifest["reads"]
        prof = _profiled(lambda: count_reads_sharded(bam, Config(),
                                                     mesh=mesh), rows_n)
        prof.pop("count")
        result["count"] = {"sharded_first_s": first_s,
                           "fused_first_s": fused_first_s,
                           "turns_s": walls, "sharded_profiled": prof}
        print(f"count: {result['count']}", flush=True)
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
