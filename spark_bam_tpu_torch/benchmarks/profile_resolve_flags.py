"""Where the time of ``lz77_resolve`` and ``full_check_flags`` goes, on
the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_resolve_flags \\
        [--against OTHER_lz77.cu ...] [--against OTHER_full_flags.cu ...]

Writes a synthetic BAM (the generator and seed of ``chip_smoke.py``, so its
first window is the smoke's) under the package's ``_build/``, stages that
window's raw-DEFLATE rows on the card and tokenizes them (512 token rows of
65,536), and inflates the same window on the host into the full pass's
(2^25 + PAD,) buffer. Then, for each of the two kernels:

- builds ``csrc/lz77.cu`` / ``csrc/full_flags.cu`` twice with nvcc: as it
  is, and with ``-DSBT_PROFILE``, which turns on the source's own
  ``clock64`` marks per CTA (and, for the full pass, CUDA events around
  each of its launches). The source names its phases in a
  ``// profile phases:`` line and its launches in ``// profile launches:``;
- builds each ``--against`` source (a file defining the same C entry
  point, for example a parent commit's; a ``#include`` resolves beside it
  first) as it is;
- times the kernel and every ``--against`` source in turns (``a b b a``
  order, three times, CUDA-event medians) and requires identical outputs.

Prints, for ``lz77_resolve``: the medians, the rounds per row as a
histogram (kernel and plain version) and each row's cycles split into the
source's phases; for ``full_check_flags``: the medians, each launch's time
from the profiling build's events, and each tile's cycles split into the
phases. Then the card's name, power limit and top SM clock, and one JSON
line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from spark_bam_tpu_torch import Config, StreamChecker
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf.flat import inflate_blocks
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.kernels import build
from spark_bam_tpu_torch.tpu import kernels as K
from spark_bam_tpu_torch.tpu.inflate import stage_group_device
from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths

#: Enough synthetic BAM for one full 32 MiB window.
SYNTH_BYTES = 96 << 20
#: CTAs whose marks a profiling build keeps (``g_*_marks`` in the sources).
MAX_CTAS = 8192
_P, _I = ctypes.c_void_p, ctypes.c_int
_U = ctypes.c_uint
#: Entry points whose argument list changed between designs, by arity:
#: ``sbt_full_flags`` with three launches (a chunk table as scratch) or one
#: (tile status records, ticket base and epoch), first with ``n`` by value
#: only (12 arguments); ``sbt_prefilter`` with the flags only, or with the
#: survivor compaction and ``n`` by value only (16). Others take
#: ``build.SIGNATURES``.
_ARGTYPES = {("sbt_full_flags", 10): [_P, _I, _I, _P, _I, _I, _I, _P, _P, _P],
             ("sbt_full_flags", 12): [_P, _I, _I, _P, _I, _I, _I, _P, _U, _U,
                                      _P, _P],
             ("sbt_prefilter", 8): [_P, _I, _P, _I, _I, _I, _P, _P],
             ("sbt_prefilter", 16): [_P, _I, _P, _I, _I, _I, _P, _U, _U, _P,
                                     _P, _P, _I, _P, _I, _P]}


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _names(src: Path, what: str) -> list[str]:
    m = re.search(rf"^// profile {what}: (.+)$", src.read_text(), re.M)
    return [x.strip() for x in m.group(1).split(",")] if m else []


def _arity(src: Path, entry: str) -> int:
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src.read_text())
    if not m:
        raise RuntimeError(f"{src} defines no {entry}")
    return m.group(1).count(",") + 1


def _compile(src: Path, out: Path, entry: str, profile: bool = False):
    cmd = [build._nvcc(), *build.ARCH, *build.FLAGS, "-I", str(build.CSRC),
           *(["-DSBT_PROFILE"] if profile else []), "-shared", str(src),
           "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, entry)
    arity = _arity(src, entry)
    fn.argtypes = _ARGTYPES.get((entry, arity), build.SIGNATURES[entry])
    fn.restype = _I
    return lib, arity


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _timed(fn) -> float:
    a, z = _events()
    a.record()
    err = fn()
    z.record()
    z.synchronize()
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return a.elapsed_time(z)


def _in_turns(runs: dict) -> dict:
    """``a b b a`` three times over the callables in ``runs``: medians."""
    names = list(runs)
    times = {n: [] for n in names}
    for _ in range(3):
        for n in names + names[::-1]:
            times[n].append(_timed(runs[n]))
    for n in names:
        print(f"  {n}: median {statistics.median(times[n]):.4f} ms over "
              f"{len(times[n])} {sorted(round(t, 4) for t in times[n])}")
    return {n: statistics.median(t) for n, t in times.items()}


def _split(marks: np.ndarray, phases: list[str], mhz: float) -> dict:
    """Per-CTA phase cycles from (CTAs, len(phases) + 1) clock64 marks."""
    marks = marks[(marks > 0).all(1)]
    d = np.diff(marks, axis=1).astype(np.float64)
    tot = d.sum(1)
    out = {"ctas": int(len(marks)), "cycles_mean": float(tot.mean()),
           "cycles_max": float(tot.max()),
           "us_mean": float(tot.mean() / mhz), "phases": {}}
    for k, name in enumerate(phases):
        out["phases"][name] = {
            "cycles_mean": float(d[:, k].mean()),
            "cycles_max": float(d[:, k].max()),
            "share": float(d[:, k].sum() / tot.sum()),
        }
    print(f"  per CTA ({out['ctas']}): {out['cycles_mean']:.0f} cycles mean "
          f"({out['us_mean']:.2f} us at {mhz:.0f} MHz), max "
          f"{out['cycles_max']:.0f}")
    for name, v in out["phases"].items():
        print(f"    {name}: mean {v['cycles_mean']:.0f}, max "
              f"{v['cycles_max']:.0f}, {100 * v['share']:.1f} %")
    return out


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def profile_lz77(srcs: list[Path], work: Path, lit, dist, mhz: float):
    print("lz77_resolve", tuple(lit.shape))
    b = lit.shape[0]
    src = build.CSRC / "lz77.cu"
    libs = {"lz77.cu": _compile(src, work / "lz77.so", "sbt_lz77_resolve")}
    for i, other in enumerate(srcs):
        libs[str(other)] = _compile(other, work / f"lz77_{i}.so",
                                    "sbt_lz77_resolve")
    prof, _ = _compile(src, work / "lz77_prof.so", "sbt_lz77_resolve", True)
    outs = {n: torch.empty_like(lit) for n in libs}
    rounds = {n: torch.zeros(1, dtype=torch.int32, device=lit.device)
              for n in libs}

    def run(lib, n_out, n_rounds):
        return lambda: lib.sbt_lz77_resolve(
            lit.data_ptr(), dist.data_ptr(), b, n_out.data_ptr(),
            n_rounds.data_ptr(), _stream())

    ms = _in_turns({n: run(lib, outs[n], rounds[n])
                    for n, (lib, _) in libs.items()})
    p_out, p_rounds = torch.empty_like(lit), torch.zeros_like(rounds["lz77.cu"])
    _timed(run(prof, p_out, p_rounds))
    want, want_rounds = K._resolve_body(lit, dist)
    for n in libs:
        if not torch.equal(outs[n], want):
            raise AssertionError(f"{n} differs from the plain version")
    if not torch.equal(p_out, want):
        raise AssertionError("the profiling build differs")

    phases = _names(src, "phases")
    marks = np.zeros((MAX_CTAS // 2, len(phases) + 1), dtype=np.int64)
    row_rounds = np.zeros(MAX_CTAS // 2, dtype=np.int32)
    prof.sbt_lz77_profile.argtypes = [_P, _P, _I]
    if prof.sbt_lz77_profile(marks.ctypes.data, row_rounds.ctypes.data, b):
        raise RuntimeError("reading the lz77 marks failed")
    split = _split(marks[:b], phases, mhz)
    plain_rows = [int(K._resolve_body(lit[r:r + 1], dist[r:r + 1])[1])
                  for r in range(b)]
    hist = dict(sorted(Counter(row_rounds[:b].tolist()).items()))
    plain_hist = dict(sorted(Counter(plain_rows).items()))
    print(f"  rounds per row, kernel {hist}; plain {plain_hist}; batch: "
          f"kernel {int(rounds['lz77.cu'])}, plain {int(want_rounds)}")
    if any(k > p for k, p in zip(row_rounds[:b], plain_rows)):
        raise AssertionError("a row took more rounds than the plain version")
    return {"ms": ms, "rounds_kernel": int(rounds["lz77.cu"]),
            "rounds_plain": int(want_rounds),
            "rounds_hist_kernel": {str(k): v for k, v in hist.items()},
            "rounds_hist_plain": {str(k): v for k, v in plain_hist.items()},
            "split": split}


class _FlagsCall:
    """One build of ``sbt_full_flags``, called with its own scratch: the
    three-launch design's chunk table (10 arguments) or the one-launch
    design's tile status records (12 arguments; 13 where ``n`` may also
    come from device memory, passed here by value)."""

    def __init__(self, lib, arity: int):
        self.lib, self.arity = lib, arity
        self.status = K.TileStatus() if arity >= 12 else None

    def __call__(self, padded, lens, nc: int, n: int, out):
        total, w = padded.numel(), padded.numel() - K.PAD
        dev = padded.device
        if self.arity == 10:
            chunks = -(-total // 1024)
            scratch = torch.empty((2 * chunks + 1, 4), dtype=torch.int32,
                                  device=dev)
            extra = (scratch.data_ptr(),)
        else:
            scratch, base, epoch = self.status.next(
                dev, _stream(), -(-total // K.FULL_FLAGS_TILE))
            extra = (scratch.data_ptr(), base, epoch)
        n_args = (n, None) if self.arity == 13 else (n,)
        return self.lib.sbt_full_flags(
            padded.data_ptr(), total, w, lens.data_ptr(), lens.numel(), nc,
            *n_args, *extra, out.data_ptr(), _stream())


def profile_full_flags(srcs: list[Path], work: Path, padded, lens, nc: int,
                       n: int, mhz: float):
    w = padded.numel() - K.PAD
    print(f"full_check_flags W={w} n={n}")
    src = build.CSRC / "full_flags.cu"
    calls = {"full_flags.cu": _FlagsCall(*_compile(
        src, work / "ff.so", "sbt_full_flags"))}
    for i, other in enumerate(srcs):
        calls[str(other)] = _FlagsCall(*_compile(
            other, work / f"ff_{i}.so", "sbt_full_flags"))
    prof_lib, arity = _compile(src, work / "ff_prof.so", "sbt_full_flags",
                               True)
    prof = _FlagsCall(prof_lib, arity)
    outs = {name: torch.empty(w, dtype=torch.int32, device=padded.device)
            for name in calls}
    ms = _in_turns({name: (lambda c=c, o=outs[name]: c(padded, lens, nc, n,
                                                         o))
                    for name, c in calls.items()})
    want = K._compute_flags(padded, lens, nc, n)
    for name in calls:
        if not torch.equal(outs[name], want):
            raise AssertionError(f"{name} differs from the plain version")

    launches = _names(src, "launches")
    phases = _names(src, "phases")
    launch_ms = np.zeros(len(launches), dtype=np.float32)
    marks = np.zeros((MAX_CTAS, len(phases) + 1), dtype=np.int64)
    prof_lib.sbt_full_flags_profile.argtypes = [_P, _P, _I]
    per_launch = {k: [] for k in launches}
    splits = []
    p_out = torch.empty(w, dtype=torch.int32, device=padded.device)
    for _ in range(5):
        marks[:] = 0
        _timed(lambda: prof(padded, lens, nc, n, p_out))
        if prof_lib.sbt_full_flags_profile(launch_ms.ctypes.data,
                                           marks.ctypes.data, MAX_CTAS):
            raise RuntimeError("reading the full-flags profile failed")
        for k, name in enumerate(launches):
            per_launch[name].append(float(launch_ms[k]))
        splits.append(marks.copy())
    if not torch.equal(p_out, want):
        raise AssertionError("the profiling build differs")
    launch_med = {k: statistics.median(v) for k, v in per_launch.items()}
    print(f"  launches of the profiling build (event medians, ms): "
          f"{launch_med}")
    occupancy = calls["full_flags.cu"].lib.sbt_full_flags_occupancy()
    print(f"  CTAs an SM holds: {occupancy}")
    split = _split(splits[-1], phases, mhz)
    return {"ms": ms, "launch_ms": launch_med, "ctas_per_sm": occupancy,
            "split": split}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[], type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_resolve_flags needs a CUDA device")
    card = _smi("name,power.limit")
    mhz = float(_smi("clocks.max.sm").split()[0])
    lz_srcs = [p for p in args.against
               if "sbt_lz77_resolve(" in p.read_text()]
    ff_srcs = [p for p in args.against if "sbt_full_flags(" in p.read_text()]
    work = build.BUILD_DIR / "profile_resolve_flags"
    work.mkdir(parents=True, exist_ok=True)
    try:
        bam = work / "smoke.bam"
        synth_bam(bam, SYNTH_BYTES, seed=7)
        dev = torch.device("cuda", 0)
        checker = StreamChecker(bam, Config())
        group0 = checker.pipeline.groups[0]
        with open_channel(bam) as ch:
            staged, clens, _ = stage_group_device(ch, group0, dev)
            flat0 = inflate_blocks(ch, group0).data
        lit, dist, _, _ = K.tokenize(staged, clens)
        result = {"card": card, "sm_mhz_max": mhz,
                  "rows": int((clens > 0).sum())}
        result["lz77_resolve"] = profile_lz77(lz_srcs, work, lit, dist, mhz)

        w = checker.kernel_window
        padded = torch.zeros(w + K.PAD, dtype=torch.uint8, device=dev)
        padded[: len(flat0)] = torch.from_numpy(flat0).to(dev)
        lens = torch.from_numpy(pad_contig_lengths(checker.lengths)).to(dev)
        result["full_check_flags"] = profile_full_flags(
            ff_srcs, work, padded, lens, len(checker.lengths), len(flat0),
            mhz)
        print(card)
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
