"""Where the time of the funnel's stage-1 kernels (``csrc/lanes.cu``:
``bad_op_tables`` and the walk, ``walk_lanes`` / ``count_lanes``) goes, on
the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_lanes \\
        [--against OTHER_lanes.cu ...]

Writes the synthetic BAM of ``chip_smoke.py`` (same generator and seed, so
its first window is the smoke's) under the package's ``_build/``,
inflates that window on the host into the funnel's (2^25 + PAD,) buffer
and runs stage 0 on it (the package's ``prefilter_check_flags``). Then:

- builds ``csrc/lanes.cu`` twice with nvcc: as it is, and with
  ``-DSBT_PROFILE``, which turns on the source's own ``clock64`` laps; the
  source names them in a ``// profile phases:`` line, the tables' per warp
  before the ``;``, the walk's per lane after it (each lane's row ends
  with the steps it took; a source with a survivor table puts survivor
  i's table laps in row i too). Builds each ``--against`` source (another
  ``lanes.cu``, for example a parent commit's, with ``flag_bits.cuh``
  beside it) as it is. A source that defines ``sbt_survivor_table`` walks
  in two launches (the table, then the walk; both in every time here), one
  without it in one (the earlier design: the deep mask where a chain
  lands);
- times every build in turns (``a b b a`` order, three times, CUDA-event
  medians of one call, host work included), then 20 calls in a row (``a b
  b a``; the host's work per call overlaps the card's), then 20 calls
  captured in one CUDA graph (``a b b a``, the device time a call: no host
  work at all): the tables, the walk in count mode (``count_lanes``,
  owned span [0, n - halo) as the count path gives a non-final window)
  and with per-lane outputs (``walk_lanes``), each build's output
  required to equal the plain
  versions' (``kernels._bad_op_tables``, ``_count_lanes``,
  ``_walk_lanes``) bit for bit; for a two-launch build also its survivor
  table alone in a graph;
- times ``count_window`` (one synchronised call, the median of five) and
  ``count_repeat``'s slope (``profile_count.repeat_slope``) with the
  package's kernels, and the host's time to enqueue one call of each of
  the package's stage-1 wrappers (200 calls, no synchronisation between
  them).

Prints the medians, each phase's cycles per table warp and per walk lane
(mean, max, share) with the steps a lane took, then the card's name,
power limit and top SM clock, and one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from spark_bam_tpu_torch import Config, StreamChecker
from spark_bam_tpu_torch.benchmarks import profile_resolve_flags as prf
from spark_bam_tpu_torch.benchmarks.lane_checks import graph_ms
from spark_bam_tpu_torch.benchmarks.profile_count import repeat_slope
from spark_bam_tpu_torch.benchmarks.profile_prefilter import _back_to_back_ms
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf.flat import inflate_blocks
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.kernels import build
from spark_bam_tpu_torch.tpu import checker as ck
from spark_bam_tpu_torch.tpu import kernels as K
from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths

_P, _I = ctypes.c_void_p, ctypes.c_int
#: Table warps and walk lanes whose laps a profiling build keeps (at
#: most; ``kProfWarps`` and ``kProfLanes`` in the source).
PROF_WARPS, PROF_LANES = 16384, 1 << 17
LANE_KEYS = ("res", "fail_mask", "reads_before", "reads_parsed", "exact")
_U = ctypes.c_uint
#: ``sbt_walk_lanes`` of the one-launch design: the deep mask on
#: the spot, a thread a list entry.
_ONE_LAUNCH_WALK = [_P, _I, _I, _P, _I, _I, _I, _P, _I, _P, _P, _P, _I, _P,
                    _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P,
                    _P, _U, _P, _P, _P]


class _Lanes:
    """One build of ``lanes.cu``, called as the package's wrappers call
    it, with its own ticket counter for the count."""

    def __init__(self, src: Path, so: Path, profile: bool = False):
        self.lib, _ = prf._compile(src, so, "sbt_bad_op_tables", profile)
        self.two = "sbt_survivor_table(" in src.read_text()
        names = (("sbt_survivor_table", "sbt_walk_lanes", "sbt_lanes_ctas")
                 if self.two else ())
        for name in names:
            fn = getattr(self.lib, name)
            fn.argtypes = build.SIGNATURES[name]
            fn.restype = _I
        if not self.two:
            self.lib.sbt_walk_lanes.argtypes = _ONE_LAUNCH_WALK
            self.lib.sbt_walk_lanes.restype = _I
        self.ctas = self.lib.sbt_lanes_ctas() if self.two else 0
        self.status = K.TileStatus(1)

    def _grid(self, cap: int) -> int:
        if self.two:
            return min(self.ctas, -(-cap // K.WALK_THREADS))
        return -(-cap // K.WALK_THREADS)

    def survivor(self, padded, lens, nc, n, F, cand, n_set, tables):
        """The survivor table alone (two-launch design)."""
        args, _, keep = K._walk_args(padded, lens, nc, n, False, F, cand,
                                     n_set, tables, True)
        table = torch.empty((cand.numel(), 4), dtype=torch.int32,
                            device=padded.device)
        self._call("sbt_survivor_table", *args, table.data_ptr(),
                   self._grid(cand.numel()))
        del keep
        return table

    def _args(self, padded, lens, nc, n, F, cand, n_set, tables):
        """The walk's leading arguments: with its survivor table's (the
        two-launch design), or the one-launch walk's."""
        t, _, keep = K._walk_args(padded, lens, nc, n, False, F, cand, n_set,
                                  tables, True)
        if not self.two:
            return (t[:6] + (n, None, 0, None) + t[8:15] + (10, 1)), keep
        table = torch.empty((cand.numel(), 4), dtype=torch.int32,
                            device=padded.device)
        return t + (0, None, table.data_ptr(), 10), (keep, table)

    def _call(self, fn: str, *args) -> None:
        err = getattr(self.lib, fn)(*args, prf._stream())
        if err:
            raise RuntimeError(f"{fn} failed: cudaError {err}")

    def tables(self, padded, n: int):
        total = padded.numel()
        nwords = -(-total // 32)
        nsuper = -(-nwords // 1024)
        words = torch.empty(nwords, dtype=torch.int32, device=padded.device)
        blocks = torch.empty((4, nsuper), dtype=torch.int32,
                             device=padded.device)
        self._call("sbt_bad_op_tables", padded.data_ptr(), total, n, None,
                   words.data_ptr(), nwords, blocks.data_ptr(), nsuper)
        return words, blocks

    def walk(self, padded, lens, nc, n, F, cand, n_set, tables):
        args, keep = self._args(padded, lens, nc, n, F, cand, n_set, tables)
        cap, dev = cand.numel(), padded.device
        out = {"res": torch.empty(cap, dtype=torch.int8, device=dev),
               "fail_mask": torch.empty(cap, dtype=torch.int32, device=dev),
               "reads_before": torch.empty(cap, dtype=torch.int32,
                                           device=dev),
               "reads_parsed": torch.empty(cap, dtype=torch.int32,
                                           device=dev),
               "exact": torch.empty(cap, dtype=torch.bool, device=dev)}
        self._call("sbt_walk_lanes", *args,
                   *(out[k].data_ptr() for k in LANE_KEYS),
                   0, None, 0, None, None, 0, None, None,
                   *((self._grid(cap),) if self.two else ()))
        del keep
        return out

    def count(self, padded, lens, nc, n, F, cand, n_set, tables, own: int):
        dev = padded.device
        grid = self._grid(cand.numel())
        partials = torch.empty(2 * grid, dtype=torch.int32, device=dev)
        out = torch.empty(3, dtype=torch.int64, device=dev)
        # The ticket counter first (a captured launch zeroes its own): the
        # two-launch walk may start before the table launch ends.
        records, base, _ = self.status.next(dev, prf._stream(), grid)
        args, keep = self._args(padded, lens, nc, n, F, cand, n_set, tables)
        self._call("sbt_walk_lanes", *args, None, None, None, None, None,
                   0, None, own, None, records.data_ptr(), base,
                   partials.data_ptr(), out.data_ptr(),
                   *((grid,) if self.two else ()))
        del keep
        return out


def _equal(name: str, got, want) -> None:
    pairs = (zip(got, want) if isinstance(got, tuple)
             else ((got[k], want[k]) for k in want) if isinstance(got, dict)
             else [(got, want)])
    for g, w in pairs:
        if not torch.equal(g, w):
            raise AssertionError(f"{name} differs from the plain version")


def _lane_split(rows: np.ndarray, phases: list[str], mhz: float) -> dict:
    """Per-lane cycles of each phase from (lanes, len(phases) + 1) laps,
    the last column the steps a lane took."""
    laps, steps = rows[:, :-1].astype(np.float64), rows[:, -1]
    tot = laps.sum(1)
    out = {"lanes": int(len(rows)), "cycles_mean": float(tot.mean()),
           "cycles_max": float(tot.max()), "us_mean": float(tot.mean() / mhz),
           "steps_mean": float(steps.mean()), "steps_max": int(steps.max()),
           "cycles_per_step": float(tot.sum() / max(int(steps.sum()), 1)),
           "phases": {}}
    for k, name in enumerate(phases):
        out["phases"][name] = {"cycles_mean": float(laps[:, k].mean()),
                               "cycles_max": float(laps[:, k].max()),
                               "share": float(laps[:, k].sum() / tot.sum())}
    print(f"  per lane ({out['lanes']}): {out['cycles_mean']:.0f} cycles "
          f"mean ({out['us_mean']:.2f} us at {mhz:.0f} MHz), max "
          f"{out['cycles_max']:.0f}; {out['steps_mean']:.2f} steps mean, "
          f"{out['cycles_per_step']:.0f} cycles a step")
    for name, v in out["phases"].items():
        print(f"    {name}: mean {v['cycles_mean']:.0f}, max "
              f"{v['cycles_max']:.0f}, {100 * v['share']:.1f} %")
    return out


def _warp_split(rows: np.ndarray, phases: list[str], mhz: float) -> dict:
    """Per-warp cycles of each phase from (warps, len(phases)) laps."""
    rows = rows.astype(np.float64)
    tot = rows.sum(1)
    out = {"warps": int(len(rows)), "cycles_mean": float(tot.mean()),
           "cycles_max": float(tot.max()), "us_mean": float(tot.mean() / mhz),
           "phases": {}}
    for k, name in enumerate(phases):
        out["phases"][name] = {"cycles_mean": float(rows[:, k].mean()),
                               "cycles_max": float(rows[:, k].max()),
                               "share": float(rows[:, k].sum() / tot.sum())}
    print(f"  per table warp ({out['warps']}): {out['cycles_mean']:.0f} "
          f"cycles mean ({out['us_mean']:.2f} us), max "
          f"{out['cycles_max']:.0f}")
    for name, v in out["phases"].items():
        print(f"    {name}: mean {v['cycles_mean']:.0f}, max "
              f"{v['cycles_max']:.0f}, {100 * v['share']:.1f} %")
    return out


def profile_lanes(srcs: list[Path], work: Path, padded, lens, nc: int,
                  n: int, halo: int, mhz: float) -> dict:
    w = padded.numel() - K.PAD
    own = n - halo
    F, cand, n_set = K.prefilter_check_flags(padded, lens, nc, n)
    live = min(int(n_set), cand.numel())
    print(f"stage 1 W={w} n={n} survivors {int(n_set)} (capacity "
          f"{cand.numel()}), owned span [0, {own})")
    src = build.CSRC / "lanes.cu"
    builds = {"lanes.cu": _Lanes(src, work / "lanes.so")}
    for i, other in enumerate(srcs):
        builds[str(other)] = _Lanes(other, work / f"lanes_{i}.so")
    want_t = K._bad_op_tables(padded, n)
    want_c = K._count_lanes(padded, lens, nc, n, False, F, cand, n_set,
                            want_t, 0, own)
    want_l = K._walk_lanes(padded, lens, nc, n, False, F, cand, n_set,
                           want_t)
    result: dict = {"survivors": int(n_set), "live_lanes": live,
                    "capacity": cand.numel(), "own": own}
    for what in ("tables", "count", "walk"):
        runs = {}
        for name, b in builds.items():
            tabs = b.tables(padded, n)
            if what == "tables":
                runs[name] = lambda b=b: b.tables(padded, n)
            elif what == "count":
                runs[name] = (lambda b=b, t=tabs: b.count(
                    padded, lens, nc, n, F, cand, n_set, t, own))
            else:
                runs[name] = (lambda b=b, t=tabs: b.walk(
                    padded, lens, nc, n, F, cand, n_set, t))
            got = runs[name]()
            _equal(f"{name} {what}", got, {"tables": want_t, "count": want_c,
                                           "walk": want_l}[what])
        print(f" {what}: one call, CUDA events, in turns")
        ms = prf._in_turns({k: (lambda f=f: (f(), 0)[1]) for k, f in
                            runs.items()})
        b2b = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            b2b[k].append(_back_to_back_ms(runs[k]))
        b2b = {k: statistics.median(v) for k, v in b2b.items()}
        for k, v in b2b.items():
            print(f"  {k}: {v:.4f} ms a call, 20 calls back to back")
        graph = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            graph[k].append(graph_ms(runs[k]))
        graph = {k: statistics.median(v) for k, v in graph.items()}
        for k, v in graph.items():
            print(f"  {k}: {v:.4f} ms a call, 20 calls in a CUDA graph")
        result[what] = {"ms": ms, "back_to_back_ms": b2b, "graph_ms": graph}
    main = builds["lanes.cu"]
    if main.two:
        tabs = main.tables(padded, n)
        table = main.survivor(padded, lens, nc, n, F, cand, n_set, tabs)
        _equal("the survivor table", table[:live], K._survivor_table(
            padded, lens, nc, n, F, cand, n_set, want_t)[:live])
        result["survivor_table_graph_ms"] = statistics.median(
            graph_ms(lambda: main.survivor(padded, lens, nc, n, F, cand,
                                           n_set, tabs)) for _ in range(3))
        print(f" the survivor table alone, 20 in a CUDA graph: "
              f"{result['survivor_table_graph_ms']:.4f} ms a call")

    prof = _Lanes(src, work / "lanes_prof.so", profile=True)
    groups = [[x.strip() for x in g.split(",")]
              for g in ", ".join(prf._names(src, "phases")).split(";")]
    tab_cols, walk_cols = len(groups[0]), len(groups[1]) + 1
    tabs = prof.tables(padded, n)
    _equal("the profiling build's tables", tabs, want_t)
    tab = np.zeros((PROF_WARPS, tab_cols), dtype=np.int64)
    walk = np.zeros((PROF_LANES, walk_cols), dtype=np.int64)
    prof.lib.sbt_lanes_profile.argtypes = [_P, _I, _P, _I]
    if prof.lib.sbt_lanes_profile(tab.ctypes.data, PROF_WARPS,
                                  walk.ctypes.data, PROF_LANES):
        raise RuntimeError("reading the table marks failed")
    print(" profiling build, tables")
    result["tables"]["split"] = _warp_split(tab[tab.sum(1) > 0], groups[0],
                                            mhz)
    got = prof.count(padded, lens, nc, n, F, cand, n_set, tabs, own)
    _equal("the profiling build's count", got, want_c)
    if prof.lib.sbt_lanes_profile(tab.ctypes.data, PROF_WARPS,
                                  walk.ctypes.data, PROF_LANES):
        raise RuntimeError("reading the walk marks failed")
    print(" profiling build, walk (count mode)")
    result["count"]["split"] = _lane_split(walk[: min(live, PROF_LANES)],
                                           groups[1], mhz)

    # The package's kernels on the count path: count_window's stage time
    # and count_repeat's slope.
    def count_window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.count_window(padded, lens, nc, n, False, 0, own)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    count_window()
    result["count_window_ms"] = statistics.median(
        count_window() for _ in range(5))
    wrappers = {
        "bad_op_tables": lambda: K.bad_op_tables(padded, n),
        "survivor_table": lambda: K.survivor_table(padded, lens, nc, n, F,
                                                   cand, n_set, want_t),
        "count_lanes": lambda: K.count_lanes(padded, lens, nc, n, False, F,
                                             cand, n_set, want_t, 0, own),
        "walk_lanes": lambda: K.walk_lanes(padded, lens, nc, n, False, F,
                                           cand, n_set, want_t)}
    result["host_enqueue_ms"] = {}
    for k, f in wrappers.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            f()
        result["host_enqueue_ms"][k] = (time.perf_counter() - t0) * 5
        torch.cuda.synchronize()
    print(f" host time to enqueue a call (200 calls): "
          f"{result['host_enqueue_ms']}")
    result["count_repeat"] = repeat_slope(padded, lens, nc, n, w, 10)
    print(f" count_window (one synchronised call, median of 5): "
          f"{result['count_window_ms']:.3f} ms; count_repeat slope "
          f"{result['count_repeat']['slope_ms_per_window']:.4f} ms a window")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[], type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_lanes needs a CUDA device")
    card = prf._smi("name,power.limit")
    mhz = float(prf._smi("clocks.max.sm").split()[0])
    work = build.BUILD_DIR / "profile_lanes"
    work.mkdir(parents=True, exist_ok=True)
    try:
        bam = work / "smoke.bam"
        synth_bam(bam, prf.SYNTH_BYTES, seed=7)
        dev = torch.device("cuda", 0)
        checker = StreamChecker(bam, Config())
        with open_channel(bam) as ch:
            flat0 = inflate_blocks(ch, checker.pipeline.groups[0]).data
        w = checker.kernel_window
        padded = torch.zeros(w + K.PAD, dtype=torch.uint8, device=dev)
        padded[: len(flat0)] = torch.from_numpy(flat0).to(dev)
        lens = torch.from_numpy(pad_contig_lengths(checker.lengths)).to(dev)
        result = {"card": card, "sm_mhz_max": mhz}
        result["lanes"] = profile_lanes(
            args.against, work, padded, lens, len(checker.lengths),
            len(flat0), checker.halo, mhz)
        print(card)
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
