"""Where the time of one load (``stream_read_batches``) goes on the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_load [--mib 256]

Writes a synthetic BAM (``--mib`` MiB uncompressed) under the package's
``_build/`` directory and, after a warm-up load (kernel build, allocator,
pinned host buffers), prints:

- the walls of ``stream_read_batches`` and of ``count_reads`` over the same
  file, in turns;
- a host-clock split of one load: the window source (staging waits and
  the inflate launches), the check launches, ``_materialize`` (waiting for
  a window's check and its D2H copies), ``parse_window`` (starts up, the
  parse, columns down, the fix-up), and the rest (the NumPy work of
  ``_stream`` and ``read_batches`` over each window's verdicts);
- each window's ``parse_records`` time by CUDA events;
- one load under ``torch.profiler``: device-busy share, the top operators
  by device time and by host time;
- the host tag walk (``_tag_presence_mask``) per record, over the load
  edge corpus's batches (``benchmarks/load_cases.py``: two thirds of its
  reads carry NM or NM + MD), against ``parse_records`` per record;

with the card's name and power limit, and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

from spark_bam_tpu_torch import Config, StreamChecker, stream_read_batches
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.tpu import parser
from spark_bam_tpu_torch.tpu import stream_check as sc


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _load(bam: Path) -> int:
    rows = 0
    for _, batch in stream_read_batches(bam, Config()):
        rows += len(batch)
    torch.cuda.synchronize()
    return rows


def host_split(bam: Path) -> tuple[dict, float, list]:
    """One load with host-clock timers around its parts; returns the split
    (ms), the wall (s) and each window's parse_records ms (CUDA events)."""
    acc = {"source": 0.0, "check launches": 0.0, "materialize": 0.0,
           "parse_window": 0.0}
    parse_events = []
    saved = (StreamChecker._device_windows, StreamChecker._launcher,
             StreamChecker._materialize, sc.parse_window,
             parser.parse_records)

    def add(label, t0):
        acc[label] += (time.perf_counter() - t0) * 1e3

    def source(self):
        it = saved[0](self)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            add("source", t0)
            if item is None:
                return
            yield item

    def launcher(self, *a, **kw):
        launch = saved[1](self, *a, **kw)

        def timed(*la):
            t0 = time.perf_counter()
            out = launch(*la)
            add("check launches", t0)
            return out
        return timed

    def materialize(out):
        t0 = time.perf_counter()
        res = saved[2](out)
        add("materialize", t0)
        return res

    def parse_window(*a):
        t0 = time.perf_counter()
        batch = saved[3](*a)
        add("parse_window", t0)
        return batch

    def parse_records(padded, starts, *a, **kw):
        s = torch.cuda.current_stream(padded.device)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record(s)
        out = saved[4](padded, starts, *a, **kw)
        e1.record(s)
        parse_events.append((e0, e1))
        return out

    StreamChecker._device_windows = source
    StreamChecker._launcher = launcher
    StreamChecker._materialize = staticmethod(materialize)
    sc.parse_window = parse_window
    parser.parse_records = parse_records
    try:
        t0 = time.perf_counter()
        _load(bam)
        wall = time.perf_counter() - t0
    finally:
        StreamChecker._device_windows, StreamChecker._launcher = saved[:2]
        StreamChecker._materialize = staticmethod(saved[2])
        sc.parse_window, parser.parse_records = saved[3:]
    acc["rest (NumPy in _stream and read_batches)"] = (
        wall * 1e3 - sum(acc.values()))
    return acc, wall, [a.elapsed_time(b) for a, b in parse_events]


def tag_walk_us(work: Path) -> tuple[float, int]:
    """Host microseconds a record of ``_tag_presence_mask(..., ("NM",
    "MD"))`` over the edge corpus's batches, and the records walked."""
    from spark_bam_tpu_torch.benchmarks import load_cases
    from spark_bam_tpu_torch.load.tpu_load import _tag_presence_mask

    edges = work / "edges.bam"
    load_cases.write_bam(edges, seed=0)
    w, h = load_cases.GEOMETRY
    batches = [b for _, b in stream_read_batches(
        edges, Config(window_size=w, halo_size=h))]
    records = sum(len(b.columns["valid"]) for b in batches)
    t0 = time.perf_counter()
    for b in batches:
        _tag_presence_mask(b, ("NM", "MD"))
    return (time.perf_counter() - t0) * 1e6 / records, records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_load needs a CUDA device")
    card = _card()
    work = Path(__file__).resolve().parent.parent / "_build" / "profile_load"
    work.mkdir(parents=True, exist_ok=True)
    try:
        bam = work / "profile.bam"
        manifest = synth_bam(bam, args.mib << 20, seed=11)
        reads = manifest["reads"]
        assert _load(bam) == reads
        walls = {"load": [], "count": []}
        for _ in range(2):
            t0 = time.perf_counter()
            assert _load(bam) == reads
            walls["load"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            assert StreamChecker(bam, Config()).count_reads() == reads
            torch.cuda.synchronize()
            walls["count"].append(time.perf_counter() - t0)
        split, split_wall, parse_ms = host_split(bam)
        windows = len(parse_ms)
        print(f"{card}: {reads} reads, {windows} windows; walls in turns "
              f"load {walls['load']} s, count {walls['count']} s")
        for k, v in split.items():
            print(f"host split {k}: {v:.1f} ms ({v / windows:.2f} ms a "
                  f"window, {v / split_wall / 10:.1f} %)")
        print(f"parse_records per window (CUDA events): median "
              f"{statistics.median(parse_ms):.3f} ms, min {min(parse_ms):.3f}"
              f", max {max(parse_ms):.3f}")
        walk_us, walked = tag_walk_us(work)
        parse_ns = statistics.median(parse_ms) * 1e6 / (reads / windows)
        print(f"host tag walk: {walk_us:.2f} us a record over {walked} "
              f"records; parse_records {parse_ns:.1f} ns a record")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _load(bam)
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        attr = ("self_device_time_total"
                if hasattr(ka[0], "self_device_time_total")
                else "self_cuda_time_total")
        dev_us = sum(getattr(e, attr) for e in ka
                     if getattr(e, "device_type", None) == DeviceType.CUDA)
        print(ka.table(sort_by=attr, row_limit=20))
        print(ka.table(sort_by="self_cpu_time_total", row_limit=15))
        print(json.dumps({
            "card": card, "mib": args.mib, "windows": windows,
            "reads": reads, "load_walls_s": walls["load"],
            "count_walls_s": walls["count"],
            "load_reads_per_s": reads / min(walls["load"]),
            "host_split_ms": split, "host_split_wall_s": split_wall,
            "parse_ms_median": statistics.median(parse_ms),
            "parse_ns_per_record": parse_ns,
            "tag_walk_us_per_record": walk_us,
            "parse_ms": parse_ms, "profiled_wall_s": wall,
            "device_busy_share": dev_us / 1e6 / wall,
        }))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
