"""Walls and peak host memory of the host routes around the card: the
deferral resolver on long reads, the sharded escape patch and the host
inflate of the classic count loop.

    python -m spark_bam_tpu_torch.benchmarks.profile_host_routes \\
        [--roots DIR ...] [--mib 1024] [--device cuda|cpu] [--out FILE]

Writes its inputs under the package's ``_build/`` directory (a long-read
BAM of 8 MiB, seed 9, 32 reads of 60-110 kb; one of 2 MiB, 16 such reads;
a short-read BAM of ``--mib`` MiB, seed 7), then runs each leg in a fresh
child process for each checkout in ``--roots`` (a directory that holds a
``spark_bam_tpu_torch`` package; default: this one), in the order given,
so that two versions are compared in turns (parent, change, change,
parent):

- ``count``: ``StreamChecker.count_reads`` of the 8 MiB long-read BAM at
  a 256 KiB window and 64 KiB halo (chains outrun the halo, so the count
  re-runs through ``spans()``): the wall and the retry's wall, twice (the
  first warms the kernels up); then one ``spans()`` pass's wall and its
  emissions;
- ``sharded``: ``count_reads_sharded`` on one device at a 256 KiB window
  and 64 KiB halo over the 2 MiB long-read BAM, and at a 4 MiB window over
  the 8 MiB one: the wall, the time inside the escape patch
  (``_exact_row_true_positions``), the rows it patched, and the child's
  resident set before the count and its peak during it;
- ``inflate``: the classic loop's count (``Config(device_inflate=False)``)
  of the short-read BAM under a live metrics registry: each
  ``inflate.window`` span's ms, blocks, bytes and ``engine``;
- ``sharded_default`` (not run by default): the ``sharded`` leg at the
  default geometry (24 MiB window, 4 MiB halo) over a BAM of
  ``--ultra-mib`` MiB (seed 9, 32-read units of 300-600 kb, whose
  ten-record chains outrun the 4 MiB halo);
- ``short`` (not run by default): ``inflate_blocks`` on short runs of the
  short-read BAM (``SHORT_RUNS`` blocks, ``SHORT_REPS`` runs from spread
  offsets, eight threads, the page cache warm): the median ms a run, and,
  where the package has ``bgzf.flat.SLICE_BLOCKS``, the same for each
  value of ``--slice-blocks``.

Prints the card's name and power limit, one JSON line a child, and last
one JSON line of every result (also written to ``--out``). ``--device
cpu`` (a check of the script at a small ``--mib``) takes host-inflate
windows everywhere.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

LONG_GEO = (256 << 10, 64 << 10)
SHORT_RUNS = (1, 4, 16, 48, 64, 128, 256)
SHORT_REPS = 101


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _config(device: str):
    """The default ``Config``; on the CPU with host-inflate windows (the
    device inflate's plain tokenizer there is a Python decoder)."""
    from spark_bam_tpu_torch import Config

    return Config() if device != "cpu" else Config(device_inflate=False)


class _RssPeak:
    """This process's resident set (``/proc/self/statm``) sampled every
    5 ms on a thread while entered: ``start`` and ``peak`` in MiB (a spike
    shorter than a sample can be missed). ``ru_maxrss`` would also carry
    the spawning process's peak across ``exec``."""

    def __enter__(self):
        import threading

        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss() -> float:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**20

    def _run(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def leg_count(bam: str, device: str) -> dict:
    from spark_bam_tpu_torch import StreamChecker

    out: dict = {"runs": []}
    for _ in range(2):
        sc = StreamChecker(bam, _config(device), *LONG_GEO, device=device)
        retry = []
        via_spans = sc._count_via_spans

        def timed_retry():
            t0 = time.perf_counter()
            n = via_spans()
            retry.append(time.perf_counter() - t0)
            return n

        sc._count_via_spans = timed_retry
        _sync(device)
        t0 = time.perf_counter()
        n = sc.count_reads()
        _sync(device)
        out["runs"].append({"reads": n, "wall_s": time.perf_counter() - t0,
                            "retries": len(retry),
                            "retry_s": sum(retry)})
    sc = StreamChecker(bam, _config(device), *LONG_GEO, device=device)
    t0 = time.perf_counter()
    spans = list(sc.spans())
    out["spans_s"] = time.perf_counter() - t0
    out["spans_emissions"] = len(spans)
    return out


def leg_sharded(bam: str, device: str, window: int, halo: int) -> dict:
    from spark_bam_tpu_torch import count_reads_sharded, make_mesh
    from spark_bam_tpu_torch.parallel import stream_mesh as sm

    mesh = make_mesh(None if device == "cuda" else [device])
    patch = []
    real = sm._exact_row_true_positions

    def timed_patch(*a, **kw):
        t0 = time.perf_counter()
        res = real(*a, **kw)
        patch.append(time.perf_counter() - t0)
        return res

    sm._exact_row_true_positions = timed_patch
    stats: dict = {}
    _sync(device)
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        n = count_reads_sharded(bam, _config(device), mesh=mesh,
                                stats_out=stats,
                                window_uncompressed=window, halo=halo)
        _sync(device)
        wall = time.perf_counter() - t0
    return {"reads": n, "wall_s": wall,
            "patch_s": sum(patch), "patched_rows": len(patch),
            "patched_steps": stats.get("patched_steps"),
            "fallback": stats.get("fallback"),
            "rss_before_mib": rss.start, "peak_rss_mib": rss.peak}


def leg_inflate(bam: str, device: str) -> dict:
    from spark_bam_tpu_torch import Config, StreamChecker, obs

    sc = StreamChecker(bam, Config(device_inflate=False), device=device)
    reg = obs.configure()
    try:
        _sync(device)
        t0 = time.perf_counter()
        n = sc.count_reads()
        _sync(device)
        wall = time.perf_counter() - t0
        spans = [e for e in reg.events() if e["name"] == "inflate.window"]
    finally:
        obs.shutdown()
    ms = [e["ms"] for e in spans]
    nbytes = [e["attrs"]["bytes"] for e in spans]
    return {"reads": n, "wall_s": wall, "windows": len(spans),
            "engines": sorted({e["attrs"].get("engine") for e in spans}),
            "ms_median": statistics.median(ms), "ms_mean": statistics.mean(ms),
            "ms_per_32mib_median": statistics.median(
                m * (32 << 20) / max(b, 1) for m, b in zip(ms, nbytes)),
            "mb_per_s": sum(nbytes) / 1e6 / (sum(ms) / 1e3)}


def leg_short(bam: str, slice_blocks: list[int]) -> dict:
    from spark_bam_tpu_torch.bgzf import flat
    from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
    from spark_bam_tpu_torch.core.channel import open_channel

    metas = blocks_metadata(bam)
    sweep = slice_blocks if hasattr(flat, "SLICE_BLOCKS") else [None]
    out: dict = {}
    with open_channel(bam) as ch:
        flat.inflate_blocks(ch, metas[:SHORT_RUNS[-1]])   # builds, warms
        for sb in sweep:
            if sb is not None:
                flat.SLICE_BLOCKS = sb
            for n in SHORT_RUNS:
                ms = []
                for rep in range(SHORT_REPS):
                    lo = (rep * 7919) % (len(metas) - n)
                    t0 = time.perf_counter()
                    flat.inflate_blocks(ch, metas[lo: lo + n])
                    ms.append((time.perf_counter() - t0) * 1e3)
                out[f"{sb or 'parent'}:{n}"] = statistics.median(ms)
    return {"median_ms": out}


def _child(args) -> None:
    """One leg in this process, on the package under ``--root``."""
    sys.path[0] = os.path.abspath(args.root)
    if args.child == "count":
        res = leg_count(args.bam, args.device)
    elif args.child == "sharded":
        res = leg_sharded(args.bam, args.device, args.window or None,
                          args.halo or None)
    elif args.child == "short":
        res = leg_short(args.bam, args.slice_blocks)
    else:
        res = leg_inflate(args.bam, args.device)
    print(json.dumps(res), flush=True)


def _run_child(root: str, leg: str, bam: Path, device: str,
               extra=()) -> dict:
    root = os.path.abspath(root)
    cmd = [sys.executable, os.path.abspath(__file__), "--child", leg,
           "--root", root, "--bam", str(bam), "--device", device, *extra]
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=root)
    if proc.returncode != 0:
        raise RuntimeError(f"{leg} on {root} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=None)
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--legs", nargs="+",
                    default=["count", "sharded", "inflate"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None)
    ap.add_argument("--root", default=".")
    ap.add_argument("--bam", default=None)
    ap.add_argument("--ultra-mib", type=int, default=64)
    ap.add_argument("--slice-blocks", type=int, nargs="+",
                    default=[32, 8, 4, 2, 1])
    ap.add_argument("--window", type=int, default=LONG_GEO[0])
    ap.add_argument("--halo", type=int, default=LONG_GEO[1])
    args = ap.parse_args(argv)
    if args.child:
        _child(args)
        return 0

    from spark_bam_tpu_torch.benchmarks.synth import synth_bam

    here = Path(__file__).resolve().parents[2]
    roots = args.roots or [str(here)]
    if args.device == "cuda":
        from spark_bam_tpu_torch.benchmarks.profile_count import _card

        print(_card(), flush=True)
    work = here / "spark_bam_tpu_torch" / "_build" / "host_routes"
    work.mkdir(parents=True, exist_ok=True)
    long8, long2, short = (work / "long8.bam", work / "long2.bam",
                           work / f"short{args.mib}.bam")
    if not long8.exists():
        synth_bam(long8, 8 << 20, seed=9, unit_reads=32,
                  read_len=(60_000, 110_000))
    if not long2.exists():
        synth_bam(long2, 2 << 20, seed=9, unit_reads=8,
                  read_len=(60_000, 110_000))
    ultra = work / f"ultra{args.ultra_mib}.bam"
    if {"inflate", "short"} & set(args.legs) and not short.exists():
        synth_bam(short, args.mib << 20, seed=7)
    if "sharded_default" in args.legs and not ultra.exists():
        synth_bam(ultra, args.ultra_mib << 20, seed=9, unit_reads=32,
                  read_len=(300_000, 600_000))
    # Each root's first child builds its kernels and native libraries:
    # untimed.
    for root in dict.fromkeys(roots):
        _run_child(root, "count", long2, args.device)
    results = []
    for turn, root in enumerate(roots):
        for leg in args.legs:
            if leg == "sharded":
                runs = [(long2, LONG_GEO), (long8, (4 << 20, 64 << 10))]
            elif leg == "sharded_default":
                runs = [(ultra, (0, 0))]   # 0: the default geometry
            else:
                runs = [(long8 if leg == "count" else short, None)]
            for bam, geo in runs:
                extra = ([] if geo is None else
                         ["--window", str(geo[0]), "--halo", str(geo[1])])
                if leg == "short":
                    extra = ["--slice-blocks",
                             *map(str, args.slice_blocks)]
                child = "sharded" if leg == "sharded_default" else leg
                res = _run_child(root, child, bam, args.device, extra)
                res.update(turn=turn, root=root, leg=leg, bam=bam.name,
                           geo=geo)
                print(json.dumps(res), flush=True)
                results.append(res)
    line = json.dumps({"host_routes": results})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
