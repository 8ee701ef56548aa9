"""Where the time of ``prefilter_check_flags`` and of the survivor
compaction goes, on the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_prefilter \\
        [--against OTHER_prefilter.cu ...]

Writes the synthetic BAM of ``chip_smoke.py`` (same generator and seed, so
its first window is the smoke's) under the package's ``_build/``, and
inflates that window on the host into the funnel's (2^25 + PAD,) buffer.
Then:

- builds ``csrc/prefilter.cu`` twice with nvcc: as it is, and with
  ``-DSBT_PROFILE``, which turns on the source's own ``clock64`` marks per
  CTA and CUDA events around its launch; the source names its phases in a
  ``// profile phases:`` line. Builds each ``--against`` source (a file
  defining ``sbt_prefilter``, for example a parent commit's) as it is. A
  source whose ``sbt_prefilter`` takes 8 arguments computes the flags
  only; one that takes 16 also compacts the survivors (``cand``,
  ``n_set``), and its timed call includes the ``-1`` fill of ``cand``
  and the allocation of its bitmap scratch;
- times every build in turns (``a b b a`` order, three times, CUDA-event
  medians of one call, host work included), then 20 calls in a row (``a
  b b a``; the host's work per call overlaps the card's), and requires
  the flags, and where a build gives them ``cand`` and ``n_set``, to
  equal the plain versions';
- times the plain compaction the check ran before the fused kernel (the
  survivor mask and ``checker._compact_mask``) and ``torch.nonzero(F ==
  0)``, the library call that computes the same positions (it syncs the
  host; the port never calls it), each with CUDA events, and the peak
  device memory of the compaction.

Prints the medians, the launch time of the profiling build, the cycles of
each CTA (or of each tile's steps) split into the phases, for the fused
kernel its flags loop's SASS instructions an offset (``cuobjdump``) and
the share of the SMs' issue slots the flags phase uses, then the card's
name, power limit and top SM clock, and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from spark_bam_tpu_torch import Config, StreamChecker
from spark_bam_tpu_torch.benchmarks import profile_resolve_flags as prf
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf.flat import inflate_blocks
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.kernels import build
from spark_bam_tpu_torch.tpu import checker as ck
from spark_bam_tpu_torch.tpu import kernels as K
from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths


class _PrefilterCall:
    """One build of ``sbt_prefilter``: flags only (8 arguments) or flags
    and the ordered survivor compaction (16 arguments, with its own tile
    status records, bitmap scratch and a persistent grid; 17 where ``n``
    may also come from device memory, passed here by value)."""

    def __init__(self, lib, arity: int):
        self.lib, self.arity = lib, arity
        self.status = K.TileStatus(4) if arity >= 16 else None
        if arity >= 16:
            lib.sbt_prefilter_ctas.argtypes = []
            self.ctas = lib.sbt_prefilter_ctas()

    def __call__(self, padded, lens, nc: int, n: int, out, cand, n_set):
        w = padded.numel() - K.PAD
        if self.arity == 8:
            return self.lib.sbt_prefilter(
                padded.data_ptr(), w, lens.data_ptr(), lens.numel(), nc, n,
                out.data_ptr(), prf._stream())
        tiles = -(-w // K.PREFILTER_TILE)
        grid = min(tiles, self.ctas)
        records, base, epoch = self.status.next(padded.device,
                                                prf._stream(), tiles + grid)
        bitmaps = torch.empty(tiles * K.PREFILTER_TILE // 32,
                              dtype=torch.int32, device=padded.device)
        cand.fill_(-1)
        n_args = (n,) if self.arity == 16 else (n, None)
        return self.lib.sbt_prefilter(
            padded.data_ptr(), w, lens.data_ptr(), lens.numel(), nc, *n_args,
            records.data_ptr(), base, epoch, out.data_ptr(),
            bitmaps.data_ptr(), cand.data_ptr(), cand.numel(),
            n_set.data_ptr(), grid, prf._stream())


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                        r"([^;]*);")


def loop_sass(sass: str, kernel: str = "prefilter_kernel",
              store: str = "STG.E.128") -> tuple[int, int] | None:
    """``(instructions, 16-byte stores)`` of the innermost loop of
    ``kernel`` in ``cuobjdump -sass`` text whose body holds ``store``
    instructions: the flags loop, whose store writes 4 offsets' flags.
    None when the dump has no such kernel or loop."""
    blocks = sass.split("Function : ")
    body = next((b for b in blocks[1:] if kernel in b.split("\n", 1)[0]),
                None)
    if body is None:
        return None
    ins = [(int(m.group(1), 16), m.group(3), m.group(4))
           for m in _SASS_LINE.finditer(body)]
    best = None
    for addr, op, rest in ins:
        target = re.match(r"\s*(0x[0-9a-f]+)", rest)
        if not op.startswith("BRA") or not target:
            continue
        lo = int(target.group(1), 16)
        if lo >= addr:
            continue
        span = [o for a, o, _ in ins if lo <= a <= addr]
        stores = sum(o == store for o in span)
        if stores and (best is None or len(span) < best[0]):
            best = (len(span), stores)
    return best


def _sass_per_offset(so: Path) -> float | None:
    """SASS instructions an offset in the built kernel's flags loop, from
    ``cuobjdump -sass`` (None where the toolkit lacks it)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True).stdout
    loop = loop_sass(out)
    return None if loop is None else loop[0] / (4 * loop[1])


def _back_to_back_ms(fn, reps: int = 20) -> float:
    """CUDA-event time of ``reps`` calls of ``fn`` in a row, over
    ``reps``: the host enqueues ahead of the card, so its own time per call
    stays out of the figure (unlike one call between two events)."""
    fn()
    torch.cuda.synchronize()
    a, z = prf._events()
    a.record()
    for _ in range(reps):
        fn()
    z.record()
    z.synchronize()
    return a.elapsed_time(z) / reps


def _event_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after one."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, z = prf._events()
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def time_compaction(F, n: int, capacity: int) -> dict:
    """Card time of the plain compaction (the survivor mask, then
    ``_compact_mask``; and ``_compact_mask`` alone), its peak memory, and
    of ``torch.nonzero(F == 0)``."""
    w = F.numel()
    idx = torch.arange(w, device=F.device)
    survivor = (F == 0) & (idx < n)

    def mask_and_compact():
        return ck._compact_mask((F == 0) & (idx < n), capacity)

    out = {
        "mask_and_compact_mask_ms": _event_ms(mask_and_compact),
        "compact_mask_ms": _event_ms(
            lambda: ck._compact_mask(survivor, capacity)),
        "nonzero_ms": _event_ms(lambda: torch.nonzero(F == 0)),
    }
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ck._compact_mask(survivor, capacity)
    torch.cuda.synchronize()
    out["compact_mask_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                      - before)
    for k, v in out.items():
        print(f"  {k}: {v}")
    return out


def profile_prefilter(srcs: list[Path], work: Path, padded, lens, nc: int,
                      n: int, mhz: float) -> dict:
    w = padded.numel() - K.PAD
    cap = K.lane_capacity(w)
    print(f"prefilter_check_flags W={w} n={n} capacity={cap}")
    src = build.CSRC / "prefilter.cu"
    calls = {"prefilter.cu": _PrefilterCall(*prf._compile(
        src, work / "pf.so", "sbt_prefilter"))}
    for i, other in enumerate(srcs):
        calls[str(other)] = _PrefilterCall(*prf._compile(
            other, work / f"pf_{i}.so", "sbt_prefilter"))
    prof_lib, arity = prf._compile(src, work / "pf_prof.so", "sbt_prefilter",
                                   True)
    prof = _PrefilterCall(prof_lib, arity)
    dev = padded.device

    def outputs():
        return (torch.empty(w, dtype=torch.int32, device=dev),
                torch.empty(cap, dtype=torch.int32, device=dev),
                torch.empty(1, dtype=torch.int32, device=dev))

    outs = {name: outputs() for name in calls}
    runs = {name: (lambda c=c, o=outs[name]: c(padded, lens, nc, n, *o))
            for name, c in calls.items()}
    ms = prf._in_turns(runs)
    names = list(runs)
    b2b = {name: [] for name in names}
    for name in names + names[::-1]:
        b2b[name].append(_back_to_back_ms(runs[name]))
    b2b = {name: statistics.median(v) for name, v in b2b.items()}
    for name, v in b2b.items():
        print(f"  {name}: {v:.4f} ms a call, 20 calls back to back")
    want_f = K._prefilter_flags(padded, lens, nc, n)
    survivor = (want_f == 0) & (torch.arange(w, device=dev) < n)
    want_cand, want_n = ck._compact_mask(survivor, cap)

    def check(name, c, o):
        if not torch.equal(o[0], want_f):
            raise AssertionError(f"{name}: flags differ from the plain "
                                 "version")
        if c.arity == 16 and not (
                torch.equal(o[1].long(), want_cand)
                and int(o[2][0]) == int(want_n)):
            raise AssertionError(f"{name}: cand or n_set differ from the "
                                 "plain compaction")

    for name, c in calls.items():
        check(name, c, outs[name])

    # Phase groups split by ';' (one mark more than phases each), in one
    # row of marks per CTA or tile.
    groups = [[x.strip() for x in g.split(",")]
              for g in ", ".join(prf._names(src, "phases")).split(";")]
    marks = np.zeros((prf.MAX_CTAS, sum(len(g) + 1 for g in groups)),
                     dtype=np.int64)
    launch_ms = np.zeros(1, dtype=np.float32)
    prof_lib.sbt_prefilter_profile.argtypes = [prf._P, prf._P, prf._I]
    per_launch, p_out = [], outputs()
    for _ in range(5):
        marks[:] = 0
        prf._timed(lambda: prof(padded, lens, nc, n, *p_out))
        if prof_lib.sbt_prefilter_profile(launch_ms.ctypes.data,
                                          marks.ctypes.data, prf.MAX_CTAS):
            raise RuntimeError("reading the prefilter profile failed")
        per_launch.append(float(launch_ms[0]))
    check("the profiling build", prof, p_out)
    print(f"  launch of the profiling build (event median, ms): "
          f"{statistics.median(per_launch):.4f}")
    split, col = {}, 0
    for g in groups:
        split[", ".join(g)] = prf._split(marks[:, col: col + len(g) + 1], g,
                                         mhz)
        col += len(g) + 1
    survivors = int(want_n)
    print(f"  survivors {survivors} of {w} offsets "
          f"({100 * survivors / w:.2f} %)")
    # The flags loop against the SM's issue rate (4 warp-instructions a
    # cycle): CTAs an SM x offsets a tile / the flags phase's cycles.
    issue = {}
    per_offset = _sass_per_offset(work / "pf.so")
    if per_offset is not None and calls["prefilter.cu"].arity == 16:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ctas_per_sm = calls["prefilter.cu"].ctas / sms
        flags = split[", ".join(groups[0])]["phases"]
        rate = ctas_per_sm * K.PREFILTER_TILE / flags["flags"]["cycles_mean"]
        issue = {"sass_per_offset": per_offset, "ctas_per_sm": ctas_per_sm,
                 "offsets_per_cycle_per_sm": rate,
                 "issue_share": rate * per_offset / 128}
        print(f"  flags loop: {per_offset:.2f} SASS instructions an offset, "
              f"{ctas_per_sm:g} CTAs an SM, {rate:.3f} offsets a cycle an "
              f"SM: {100 * issue['issue_share']:.1f} % of issue")
    return {"ms": ms, "back_to_back_ms": b2b,
            "profile_launch_ms": statistics.median(per_launch),
            "survivors": survivors, "capacity": cap, "split": split,
            "flags_loop": issue,
            "compaction": time_compaction(want_f, n, cap)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[], type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_prefilter needs a CUDA device")
    card = prf._smi("name,power.limit")
    mhz = float(prf._smi("clocks.max.sm").split()[0])
    work = build.BUILD_DIR / "profile_prefilter"
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
        result["prefilter"] = profile_prefilter(
            args.against, work, padded, lens, len(checker.lengths),
            len(flat0), mhz)
        print(card)
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
