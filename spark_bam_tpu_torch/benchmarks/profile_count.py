"""Where the time of one count-reads run goes on the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_count [--mib 256] [--resident]

Writes a synthetic BAM (``--mib`` MiB uncompressed) under the package's
``_build/`` directory, runs the fused count once to warm up (kernel build,
allocator), then again under ``torch.profiler`` and prints: the wall time,
the device-busy share (kernel time over wall), the host's kernel launches
(``cudaLaunchKernel`` calls and CPU time) and graph launches per window,
the top operators by device time and by host time, and the card's name and
power limit. Also times each stage of one window (staging, tokenize,
resolve, assembly, the prefilter with its survivor compaction, the bad-op
tables, the survivor table alone and with the walk and its count, the plain deep-flag stages, the lane
core against ``check_window`` and the full pass's compaction) with a
device synchronise around each (a second pass, after one that takes the
first calls' allocations), which serialises them but shows each one's
cost, and ``count_repeat``'s slope on that window (one
fused count captured in a CUDA graph, timed at two replay counts).

``--resident`` adds the resident count (``count_reads_resident``, one CUDA
graph replay per chunk) in the same call: a first count (graph captures
included) split on the host clock into host inflate (waiting for the
host-inflate windows), packing the pinned chunk, and the copies and replay
(host enqueue, and their device time by CUDA events); a second count on
the same checker, graphs reused, split the same way; and a third under
``torch.profiler``, read like the fused leg. Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from spark_bam_tpu_torch import Config, StreamChecker
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.tpu import checker as ck
from spark_bam_tpu_torch.tpu import kernels as K
from spark_bam_tpu_torch.tpu.inflate import stage_group_device
from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _timed(stages: dict, name: str, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
    return out


def stage_breakdown(bam: Path, checker: StreamChecker) -> dict:
    """Per-stage milliseconds of the main path's first window."""
    dev = checker.device
    st: dict = {}
    w, halo = checker.kernel_window, checker.halo
    lens = torch.from_numpy(pad_contig_lengths(checker.lengths)).to(dev)
    nc = len(checker.lengths)
    g = checker.pipeline.groups[0]
    with open_channel(bam) as ch:
        staged, clens, usizes, _crcs = _timed(
            st, "stage+h2d", lambda: stage_group_device(ch, g, dev))
    lit, dist, _, _ = _timed(st, "tokenize", lambda: K.tokenize(staged, clens))
    res, _ = _timed(st, "lz77_resolve",
                    lambda: K.lz77_resolve(lit, dist, out=lit))
    n = int(usizes.sum())
    exp = torch.zeros(staged.shape[0], dtype=torch.int32, device=dev)
    exp[: len(usizes)] = torch.from_numpy(usizes.astype(np.int32)).to(dev)
    carry = torch.zeros(halo, dtype=torch.uint8, device=dev)
    padded = _timed(st, "assemble", lambda: ck._assemble(
        res, exp, carry, 0, n, window=w, halo=halo))
    F, cand, n_set = _timed(st, "prefilter and compaction", lambda:
                            K.prefilter_check_flags(padded, lens, nc, n))
    tables = _timed(st, "bad_op_tables kernel",
                    lambda: K.bad_op_tables(padded, n))
    _timed(st, "survivor_table kernel", lambda: K.survivor_table(
        padded, lens, nc, n, F, cand, n_set, tables))
    _timed(st, "count_lanes kernels (survivor table, walk and count)",
           lambda: K.count_lanes(padded, lens, nc, n, False, F, cand, n_set,
                                 tables, 0, n - halo,
                                 checker.config.reads_to_check))
    # The plain versions' stages, as the count ran them before the kernels.
    plain = _timed(st, "funnel_tables (plain)",
                   lambda: K._funnel_tables(padded, n))
    _timed(st, "deep_flags (plain)", lambda: K._deep_flags_at(
        padded, lens, nc, n, plain, torch.where(cand >= 0, cand, 0)))
    _timed(st, "count_window (all of the check)", lambda: ck.count_window(
        padded, lens, nc, n, False, 0, n - halo, checker.config.reads_to_check))
    # What is left of the check in PyTorch, for the queue's order:
    # check_window's full-width scatter-back (its time less the lane
    # core's) and the full pass's survivor compaction.
    _timed(st, "_check_lanes (funnel)", lambda: ck._check_lanes(
        padded, lens, nc, n, False, checker.config.reads_to_check))
    _timed(st, "check_window (funnel)", lambda: ck.check_window(
        padded, lens, nc, n, False, checker.config.reads_to_check))
    full = K.full_check_flags(padded, lens, nc, n)
    survivor = (full == 0) & (torch.arange(w, device=dev) < n)
    _timed(st, "_compact_mask (full pass)", lambda: K._compact_mask(
        survivor, K.lane_capacity(w)))
    st["count_repeat"] = repeat_slope(padded, lens, nc, n, w,
                                      checker.config.reads_to_check)
    return st


def _events_ms(fn) -> float:
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def repeat_slope(padded, lens, nc: int, n: int, w: int,
                 reads_to_check: int, iters=(2, 10)) -> dict:
    """``count_repeat``'s two-point slope on one window: the device ms of
    one fused count without the host's launch cost (CUDA events around
    ``iters`` graph replays, the median of three calls each)."""
    run = ck.make_count_repeat(w, reads_to_check, True, padded.device)
    run(padded, lens, nc, n, False, 1)
    walls = {k: sorted(_events_ms(lambda k=k: run(padded, lens, nc, n, False,
                                                   k)) for _ in range(3))[1]
             for k in iters}
    slope = (walls[iters[1]] - walls[iters[0]]) / (iters[1] - iters[0])
    return {"wall_ms": {str(k): v for k, v in walls.items()},
            "slope_ms_per_window": slope}


def profiled(count_fn, windows: int, show: bool = True) -> dict:
    """One count under ``torch.profiler``: wall, device busy share, and the
    host's launch calls per window; prints the top operators with
    ``show``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        count = count_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(ka[0], "self_device_time_total")
            else "self_cuda_time_total")
    dev_us = sum(getattr(e, attr) for e in ka
                 if getattr(e, "device_type", None) == DeviceType.CUDA)
    if show:
        print(ka.table(sort_by=attr, row_limit=25))
        print(ka.table(sort_by="self_cpu_time_total", row_limit=15))
    host = {}
    for e in ka:
        if e.key in ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaLaunchKernelExC"):
            host[e.key] = {"calls_per_window": e.count / windows,
                           "cpu_ms_per_window":
                               e.cpu_time_total / 1e3 / windows}
    return {"count": count, "wall_s": wall,
            "device_busy_share": dev_us / 1e6 / wall,
            "device_ms": dev_us / 1e3,
            "ms_per_window": wall * 1e3 / windows, "host_calls": host}


def resident_split(checker: StreamChecker) -> dict:
    """One ``count_reads_resident`` on ``checker`` split on the host clock:
    waiting for host-inflate windows, packing rows into the pinned chunk, and
    the runner's calls (copies in, replay, clones out: host enqueue), the
    rest being the waits for each chunk's sums; plus the device time of the
    runner's calls (CUDA events around each)."""
    from spark_bam_tpu_torch.tpu import stream_check as scm

    ms = {"host inflate": 0.0, "packing": 0.0,
          "copies and replay (host enqueue)": 0.0}
    marks = []
    real_windows, real_pack = scm.halo_windows, scm._Staging.pack

    def windows(*a, **kw):
        it = real_windows(*a, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                ms["host inflate"] += (time.perf_counter() - t0) * 1e3
            yield item

    def pack(self, rows):
        t0 = time.perf_counter()
        real_pack(self, rows)
        ms["packing"] += (time.perf_counter() - t0) * 1e3

    if checker.scan_runner is None:
        checker.scan_runner = ck.make_count_scan(
            checker.kernel_window, checker.config.reads_to_check,
            checker.config.funnel_enabled(), checker.device)
    runner = checker.scan_runner
    before = runner.captures

    def call(*a):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        t0 = time.perf_counter()
        out = runner(*a)
        ms["copies and replay (host enqueue)"] += (
            time.perf_counter() - t0) * 1e3
        e1.record()
        marks.append((e0, e1))
        return out

    scm.halo_windows, scm._Staging.pack = windows, pack
    checker.scan_runner = call
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = checker.count_reads_resident()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        scm.halo_windows, scm._Staging.pack = real_windows, real_pack
        checker.scan_runner = runner
    ms["waiting for sums, other"] = wall - sum(ms.values())
    return {"count": count, "wall_ms": wall, "host_ms": ms,
            "host_share": {k: v / wall for k, v in ms.items()},
            "device_ms_copies_and_replays": sum(
                a.elapsed_time(b) for a, b in marks),
            "chunks": len(marks), "captures": runner.captures - before,
            "launches_per_replay": {
                f"{kp} rows": v
                for (kp, _), v in runner.launches_per_replay().items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--resident", action="store_true",
                    help="also profile count_reads_resident in this call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_count needs a CUDA device")
    card = _card()
    work = Path(__file__).resolve().parent.parent / "_build" / "profile"
    work.mkdir(parents=True, exist_ok=True)
    try:
        bam = work / "profile.bam"
        manifest = synth_bam(bam, args.mib << 20, seed=11)
        checker = StreamChecker(bam, Config())
        warm = checker.count_reads()
        assert warm == manifest["reads"], (warm, manifest["reads"])
        stage_breakdown(bam, checker)    # first calls: allocations
        stages = stage_breakdown(bam, checker)
        for k, v in stages.items():
            print(f"stage {k}: {v} ms" if isinstance(v, dict)
                  else f"stage {k}: {v:.3f} ms")
        checker = StreamChecker(bam, Config())
        windows = len(checker.pipeline.groups)
        fused = profiled(checker.count_reads, windows)
        assert fused["count"] == manifest["reads"]
        result = {"card": card, "mib": args.mib, "windows": windows,
                  "reads": fused["count"], "wall_s": fused["wall_s"],
                  "device_busy_share": fused["device_busy_share"],
                  "ms_per_window": fused["ms_per_window"],
                  "host_calls": fused["host_calls"], "stages_ms": stages}
        if args.resident:
            rc = StreamChecker(bam, Config(resident_scan=True))
            first = resident_split(rc)
            warm = resident_split(rc)
            prof = profiled(rc.count_reads_resident, windows)
            for leg in (first, warm, prof):
                assert leg["count"] == manifest["reads"], leg["count"]
            print(f"resident split, first count: {first}")
            print(f"resident split, graphs reused: {warm}")
            result["resident"] = {"first": first, "reused": warm,
                                  "profiled": prof}
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
