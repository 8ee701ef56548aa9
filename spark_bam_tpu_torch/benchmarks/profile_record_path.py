"""Where the time of the record path goes on the GPU host.

    python -m spark_bam_tpu_torch.benchmarks.profile_record_path
        [--mib 1024] [--split 32MB] [--parallel threads]

Writes a synthetic BAM (``--mib`` MiB uncompressed, seed 7) under the
package's ``_build/`` directory, then:

- ``load_bam(path, split).count()``: its wall and reads/s, split into the
  calling process's split resolution on the card (``load_reads_and_positions``
  returning: every strict split start resolved by ``resolve_split_start``)
  and the partitions' host work (``Dataset.count``: host zlib and the
  record decode, under ``--parallel``);
- the same count again with the partitions' host work split by the host
  clock, summed over the worker threads: block inflate and CRC
  (``bgzf.stream.read_block``), record decode (``BamRecord.decode``) and
  the rest of the stream (the wrappers' own cost included);
- the streaming count of the same file (``StreamChecker.count_reads``),
  the fused device path, beside it.

Prints the card's name and power limit and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path

import torch

from spark_bam_tpu_torch.bam import record as record_mod
from spark_bam_tpu_torch.benchmarks.profile_count import _card
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf import stream as stream_mod
from spark_bam_tpu_torch.core.config import Config, parse_bytes
from spark_bam_tpu_torch.kernels import build
from spark_bam_tpu_torch.load import api, boundary
from spark_bam_tpu_torch.parallel.executor import ParallelConfig
from spark_bam_tpu_torch.tpu import kernels as K
from spark_bam_tpu_torch.tpu.stream_check import StreamChecker


class _HostSplit:
    """Host-clock seconds in block reads and record decodes, summed over
    the threads that ran them, while entered."""

    def __init__(self):
        self.s = {"read_block": 0.0, "decode": 0.0}
        self.calls = {"read_block": 0, "decode": 0}
        self._lock = threading.Lock()

    def _timed(self, key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            dt = time.perf_counter() - t0
            with self._lock:
                self.s[key] += dt
                self.calls[key] += 1
            return out
        return run

    def __enter__(self):
        self._read_block = stream_mod.read_block
        self._decode = record_mod.BamRecord.decode
        stream_mod.read_block = self._timed("read_block", self._read_block)
        record_mod.BamRecord.decode = staticmethod(
            self._timed("decode", self._decode))
        return self

    def __exit__(self, *exc):
        stream_mod.read_block = self._read_block
        record_mod.BamRecord.decode = staticmethod(self._decode)


def profile_count(bam: Path, split_size: int, parallel: ParallelConfig,
                  dev, reads: int) -> dict:
    boundary.STATS.reset()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = api.load_reads_and_positions(bam, split_size, parallel=parallel,
                                      device=dev)
    torch.cuda.synchronize()
    resolve_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    t1 = time.perf_counter()
    n = ds.count()
    count_s = time.perf_counter() - t1
    if n != reads:
        raise RuntimeError(f"load_bam counted {n}, the generator wrote "
                           f"{reads}")
    wall = resolve_s + count_s
    row = {
        "split_size": split_size,
        "partitions": ds.num_partitions,
        "parallel": f"{parallel.mode}={parallel.num_workers}",
        "reads": n,
        "wall_s": wall,
        "reads_per_s": n / wall,
        "split_resolution_s": resolve_s,
        "split_resolution_share": resolve_s / wall,
        "partitions_s": count_s,
        "partitions_share": count_s / wall,
        "resolutions": boundary.STATS.resolutions,
        "check_window_calls": boundary.STATS.windows,
        "boundary_demotions": boundary.STATS.boundary_demotions,
        "boundary_ms": list(boundary.STATS.ms),
        "launches": launches,
    }
    ds = api.load_reads_and_positions(bam, split_size, parallel=parallel,
                                      device=dev)
    with _HostSplit() as hs:
        t2 = time.perf_counter()
        ds.count()
        split_wall = time.perf_counter() - t2
    row["host_split"] = {
        "wall_s": split_wall,
        "thread_s_read_block": hs.s["read_block"],
        "thread_s_decode": hs.s["decode"],
        "blocks": hs.calls["read_block"],
        "records": hs.calls["decode"],
        "us_per_record_decode": hs.s["decode"] / max(hs.calls["decode"], 1)
        * 1e6,
        "us_per_block_read": hs.s["read_block"]
        / max(hs.calls["read_block"], 1) * 1e6,
    }
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--split", default="32MB")
    ap.add_argument("--parallel", default="threads")
    args = ap.parse_args(argv)
    card = _card()
    print(card, flush=True)
    build.load()
    dev = torch.device("cuda", 0)
    work = (Path(__file__).resolve().parent.parent / "_build"
            / "profile_record_path")
    work.mkdir(parents=True, exist_ok=True)
    bam = work / "record_path.bam"
    manifest = synth_bam(bam, args.mib << 20, seed=7)
    row = profile_count(bam, parse_bytes(args.split),
                        ParallelConfig.parse(args.parallel), dev,
                        manifest["reads"])
    print(json.dumps(row), flush=True)
    checker = StreamChecker(bam, Config())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = checker.count_reads()
    torch.cuda.synchronize()
    row["streaming_count_s"] = time.perf_counter() - t0
    if streamed != manifest["reads"]:
        raise RuntimeError(f"streaming count {streamed}")
    row["streaming_over_record_path"] = row["streaming_count_s"] / row["wall_s"]
    print(json.dumps({"card": card, "bam": manifest, "record_path": row}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
