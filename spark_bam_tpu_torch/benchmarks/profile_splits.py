"""Where the time of split planning goes on the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_splits [--mib 1024]
        [--split 32MB] [--split 2MB]

Writes a synthetic BAM (``--mib`` MiB uncompressed, seed 7) under the
package's ``_build/`` directory and, for each ``--split`` size, resolves
every raw split boundary on the card (``sbi.plan.build_split_plan``, the
cache off) after one warm-up boundary:

- the wall and each boundary's ms (median, min, max);
- the host split summed over the boundaries: the block search
  (``find_block_start``), the run's host-zlib inflation (``_Run.grow``)
  and the device check (``_first_hit``: upload, ``check_window``, the
  first hit read back);
- ``check_window`` calls per boundary;
- one boundary under ``torch.profiler``: ``cudaLaunchKernel`` calls and
  the device's busy time.

Prints the card's name and power limit and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.benchmarks.profile_count import _card
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.core.config import Config, parse_bytes
from spark_bam_tpu_torch.load import boundary
from spark_bam_tpu_torch.load.splits import file_splits
from spark_bam_tpu_torch.sbi.plan import build_split_plan


class _Split:
    """``boundary``'s block search, run growth and device check timed on
    the host clock while entered (the card synchronized around each)."""

    def __init__(self):
        self.ms = {"find_block_start": 0.0, "grow": 0.0, "first_hit": 0.0}
        self.real = {}

    def _wrap(self, owner, name, key):
        real = getattr(owner, name)
        self.real[(owner, name)] = real

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            self.ms[key] += (time.perf_counter() - t0) * 1e3
            return out
        setattr(owner, name, run)

    def __enter__(self):
        self._wrap(boundary, "find_block_start", "find_block_start")
        self._wrap(boundary._Run, "grow", "grow")
        self._wrap(boundary, "_first_hit", "first_hit")
        return self

    def __exit__(self, *exc):
        for (owner, name), real in self.real.items():
            setattr(owner, name, real)


def profile_split(bam: Path, split_size: int, dev) -> dict:
    header = read_header(bam)
    splits = file_splits(bam, split_size)
    cfg = Config()
    boundary.resolve_split_start(bam, splits[1], header, cfg, device=dev)
    boundary.STATS.reset()
    with _Split() as sp:
        t0 = time.perf_counter()
        plan = build_split_plan(bam, splits, header, cfg, device=dev)
        wall = time.perf_counter() - t0
    st = boundary.STATS
    n = max(st.resolutions, 1)
    row = {
        "split_size": split_size,
        "boundaries": len(plan),
        "resolutions": st.resolutions,
        "wall_s": wall,
        "ms_median": statistics.median(st.ms),
        "ms_min": min(st.ms),
        "ms_max": max(st.ms),
        "host_split_ms_per_boundary": {k: v / n for k, v in sp.ms.items()},
        "check_windows_per_boundary": st.windows / n,
        "boundary_demotions": st.boundary_demotions,
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        boundary.resolve_split_start(bam, splits[1], header, cfg, device=dev)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t1) * 1e3
    ka = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(ka[0], "self_device_time_total")
            else "self_cuda_time_total")
    busy_us = sum(getattr(e, attr) for e in ka
                  if getattr(e, "device_type", None) == DeviceType.CUDA)
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    row["profiled_boundary"] = {"ms": one_ms, "cudaLaunchKernel": launches,
                                "device_busy_ms": busy_us / 1e3}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--split", action="append", default=None)
    args = ap.parse_args(argv)
    card = _card()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    work = Path(__file__).resolve().parent.parent / "_build" / "profile_splits"
    work.mkdir(parents=True, exist_ok=True)
    bam = work / "splits.bam"
    manifest = synth_bam(bam, args.mib << 20, seed=7)
    rows = []
    for spec in args.split or ["32MB", "2MB"]:
        row = profile_split(bam, parse_bytes(spec), dev)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card, "bam": manifest, "splits": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
