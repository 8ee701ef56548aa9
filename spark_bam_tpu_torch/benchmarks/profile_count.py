"""Where the time of one count-reads run goes on the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_count [--mib 256]

Writes a synthetic BAM (``--mib`` MiB uncompressed) under the package's
``_build/`` directory, runs the fused count once to warm up (kernel build,
allocator), then again under ``torch.profiler`` and prints: the wall time,
the device-busy share (kernel time over wall), the top operators by device
time and by host time, and the card's name and power limit. Also times each
stage of one window (staging, tokenize, resolve, assembly, the prefilter
with its survivor compaction, deep flags, walk) with a device synchronise
around each, which serialises them but shows each one's cost. Prints one
JSON line last.
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
        staged, clens, usizes = _timed(
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
    _, cand, _ = _timed(st, "prefilter and compaction", lambda:
                        K.prefilter_check_flags(padded, lens, nc, n))
    tables = _timed(st, "funnel_tables", lambda: ck._funnel_tables(padded, n))
    _timed(st, "deep_flags", lambda: ck._deep_flags_at(
        padded, lens, nc, n, tables, torch.where(cand >= 0, cand, 0)))
    _timed(st, "count_window (all of the check)", lambda: ck.count_window(
        padded, lens, nc, n, False, 0, n - halo, checker.config.reads_to_check))
    return st


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=256)
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
        stages = stage_breakdown(bam, checker)
        for k, v in stages.items():
            print(f"stage {k}: {v:.3f} ms")
        checker = StreamChecker(bam, Config())
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            count = checker.count_reads()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        assert count == manifest["reads"]
        ka = prof.key_averages()
        attr = ("self_device_time_total" if hasattr(ka[0], "self_device_time_total")
                else "self_cuda_time_total")
        dev_us = sum(getattr(e, attr) for e in ka
                     if getattr(e, "device_type", None) == DeviceType.CUDA)
        print(ka.table(sort_by=attr, row_limit=25))
        print(ka.table(sort_by="self_cpu_time_total", row_limit=15))
        windows = len(checker.pipeline.groups)
        print(json.dumps({
            "card": card, "mib": args.mib, "windows": windows,
            "reads": count, "wall_s": wall,
            "device_busy_share": dev_us / 1e6 / wall,
            "ms_per_window": wall * 1e3 / windows,
            "stages_ms": stages,
        }))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
