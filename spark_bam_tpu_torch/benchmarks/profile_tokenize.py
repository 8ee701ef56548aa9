"""Where the tokenize kernel's time goes, row by row, on the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_tokenize \\
        [--against OTHER_tokenize.cu ...]

Writes a synthetic BAM (the generator and seed of ``chip_smoke.py``, so its
first window is the smoke's) under the package's ``_build/``, stages that
window's raw-DEFLATE rows on the card, and builds two copies of
``csrc/tokenize.cu`` with nvcc: the kernel as it is, and one with
``clock64`` reads at the row's start and end and around each dynamic
block's table build (the copy fails to build, and says so, when the
kernel's text no longer has the points it patches). Each ``--against``
source (for example a parent commit's ``tokenize.cu`` with the same C
entry point) is built as it is and timed in turns with the kernel:
``a b b a`` order, CUDA-event medians. All outputs must be identical.

Prints, per real row of the instrumented run: SM cycles, table-build
cycles, literals and match runs (from the token planes), and a least-
squares split of the non-table cycles into cycles per literal and per
match run; then the card's name, power limit and top SM clock. One JSON
line last.

``host_device_split`` (in the JSON line under ``split``, and called by
``chip_smoke.py``'s host tokenizer phase) sets the two routes of the
entropy phase side by side on the same window, as the reference's
``bench.py`` does per group: the host tokenizer's tokenize + pack into a
pinned slot (``inflate tokenize=host``; with every thread and with one),
the packed copy's bytes and CUDA-event time, and ``lz77_resolve`` on the
packed planes; against the raw payload copy's bytes and time (pageable,
as ``stage_group_device`` copies) and the ``tokenize`` kernel's time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from spark_bam_tpu_torch import Config, StreamChecker
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.kernels import build
from spark_bam_tpu_torch.tpu.inflate import stage_group_device
from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE

#: Enough synthetic BAM for one full 32 MiB window.
SYNTH_BYTES = 96 << 20
#: Text of csrc/tokenize.cu → its clock64-instrumented replacement.
_PATCHES = (
    ("namespace {\n",
     "namespace {\n__device__ long long g_row_cycles[2 * 4096];\n"),
    ("  __shared__ Shared s;\n",
     "  __shared__ Shared s;\n"
     "  const long long t_start_ = clock64();\n  long long t_tab_ = 0;\n"),
    ("        ok = dynamic_tables(s, br, lane) &&\n",
     "        const long long t0_ = clock64();\n"
     "        const bool tab_ok_ = dynamic_tables(s, br, lane);\n"
     "        t_tab_ += clock64() - t0_;\n"
     "        ok = tab_ok_ &&\n"),
    ("  if (lane == 0) {\n    out_lens[r] = o;",
     "  if (lane == 0 && r < 4096) {\n"
     "    g_row_cycles[2 * r] = clock64() - t_start_;\n"
     "    g_row_cycles[2 * r + 1] = t_tab_;\n  }\n"
     "  if (lane == 0) {\n    out_lens[r] = o;"),
)
_READ_CYCLES = ('\nextern "C" int sbt_row_cycles(long long* h, int n) {\n'
                '  return (int)cudaMemcpyFromSymbol(h, g_row_cycles, n * 8);\n'
                '}\n')


def symbol_counts(dist: np.ndarray, out_lens: np.ndarray):
    """Per token row: ``(literals, match runs)``. A run is a maximal stretch
    of equal non-zero distances; adjacent matches with equal distances
    merge into one, so runs undercount matches."""
    d = dist.astype(np.int32)
    in_row = np.arange(d.shape[1])[None, :] < out_lens[:, None]
    lits = ((d == 0) & in_row).sum(1)
    starts = np.concatenate(
        [np.ones((len(d), 1), bool), d[:, 1:] != d[:, :-1]], 1)
    return lits, ((d != 0) & starts).sum(1)


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _compile(src: Path, out: Path) -> ctypes.CDLL:
    cmd = [build._nvcc(), *build.ARCH, *build.FLAGS, "-shared", str(src),
           "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.sbt_tokenize.argtypes = build.SIGNATURES["sbt_tokenize"]
    lib.sbt_tokenize.restype = ctypes.c_int
    return lib


def _instrumented(text: str) -> str:
    for old, new in _PATCHES:
        if old not in text:
            raise RuntimeError(f"csrc/tokenize.cu has no {old!r}: update "
                               "profile_tokenize's patches")
        text = text.replace(old, new, 1)
    return text + _READ_CYCLES


def _run(lib, staged, clens):
    b, c_pad = staged.shape
    dev = staged.device
    lit = torch.zeros((b, STRIDE), dtype=torch.uint8, device=dev)
    dist = torch.zeros((b, STRIDE), dtype=torch.int16, device=dev)
    olens = torch.zeros(b, dtype=torch.int32, device=dev)
    ok = torch.zeros(b, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    err = lib.sbt_tokenize(staged.data_ptr(), clens.data_ptr(), b, c_pad,
                           lit.data_ptr(), dist.data_ptr(), olens.data_ptr(),
                           ok.data_ptr(), stream)
    z.record()
    z.synchronize()
    if err:
        raise RuntimeError(f"sbt_tokenize launch failed: cudaError {err}")
    return a.elapsed_time(z), (lit, dist, olens, ok)


def _events_ms(fn, reps: int = 5) -> float:
    """CUDA-event median of ``fn`` on the current stream."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def host_device_split(ch, group, dev: torch.device, reps: int = 3,
                      threads: int = 8) -> dict:
    """The host and the device entropy phase of one window group (see the
    module docstring): host wall ms (``time.perf_counter``, medians of
    ``reps``), copy and kernel ms by CUDA events. Holds the host planes
    equal to the ``tokenize`` kernel's first; raises when they differ."""
    import time

    from spark_bam_tpu_torch.bgzf.flat import stage_run_payloads
    from spark_bam_tpu_torch.tpu import kernels as K
    from spark_bam_tpu_torch.tpu.inflate import (
        PackedStaging,
        _resolve_packed,
        _unpack_tokens,
        tokenize_group,
    )

    staging = PackedStaging(dev, 2)
    host_ms, groups = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        groups.append(tokenize_group(ch, group, staging, threads))
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if len(groups) > 1:    # keep one slot's group for the copies
            staging.release(groups.pop(0).slot)
    g = groups[0]
    t0 = time.perf_counter()
    tokenize_group(ch, group, None, 1)
    one_ms = (time.perf_counter() - t0) * 1e3
    host = torch.from_numpy(g.packed)
    packed_dev = torch.empty(host.numel(), dtype=torch.uint8, device=dev)
    packed_h2d_ms = _events_ms(
        lambda: packed_dev.copy_(host, non_blocking=True))
    staged, clens = stage_run_payloads(ch, group)
    staged_t, clens_t = torch.from_numpy(staged), torch.from_numpy(clens)
    raw_h2d_ms = _events_ms(lambda: (staged_t.to(dev), clens_t.to(dev)))
    staged_d, clens_d = staged_t.to(dev), clens_t.to(dev)
    lit, dist, olens, ok = K.tokenize(staged_d, clens_d)
    h_lit, h_dist = _unpack_tokens(packed_dev)
    b = g.b
    if not (torch.equal(lit, h_lit)
            and torch.equal(dist.view(torch.int16), h_dist.view(torch.int16))
            and bool(ok[:b].all())
            and np.array_equal(olens[:b].cpu().numpy(), g.out_lens)):
        raise AssertionError("host planes differ from the tokenize kernel's")
    tok_ms = _events_ms(lambda: K.tokenize(staged_d, clens_d))
    lz_ms = _events_ms(lambda: _resolve_packed(packed_dev.clone()))
    clone_ms = _events_ms(lambda: packed_dev.clone())
    staging.release(g.slot)
    return {
        "blocks": b, "rows": int(staged.shape[0]),
        "uncompressed_bytes": int(g.out_lens.sum()),
        "host_tokenize_pack_ms": statistics.median(host_ms),
        "host_tokenize_pack_ms_runs": host_ms,
        "host_tokenize_pack_ms_1_thread": one_ms, "threads": threads,
        "packed_h2d_bytes": int(host.numel()),
        "packed_h2d_ms": packed_h2d_ms,
        "lz77_on_packed_ms": max(lz_ms - clone_ms, 0.0),
        "raw_h2d_bytes": int(staged.nbytes + clens.nbytes),
        "raw_h2d_ms": raw_h2d_ms,
        "tokenize_kernel_ms": tok_ms,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", action="append", default=[], type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tokenize needs a CUDA device")
    card = _smi("name,power.limit")
    sm_mhz = float(_smi("clocks.max.sm").split()[0])
    work = build.BUILD_DIR / "profile_tokenize"
    work.mkdir(parents=True, exist_ok=True)
    try:
        src = (build.CSRC / "tokenize.cu").read_text()
        (work / "tokenize_cycles.cu").write_text(_instrumented(src))
        libs = {"tokenize.cu": _compile(build.CSRC / "tokenize.cu",
                                        work / "tokenize.so")}
        for i, other in enumerate(args.against):
            libs[str(other)] = _compile(other, work / f"against{i}.so")
        cycles_lib = _compile(work / "tokenize_cycles.cu", work / "cyc.so")
        cycles_lib.sbt_row_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]

        bam = work / "smoke.bam"
        synth_bam(bam, SYNTH_BYTES, seed=7)
        dev = torch.device("cuda", 0)
        checker = StreamChecker(bam, Config())
        with open_channel(bam) as ch:
            staged, clens, _ = stage_group_device(
                ch, checker.pipeline.groups[0], dev)
        names = list(libs)
        times = {n: [] for n in names}
        outs = {}
        for _ in range(3):
            for n in names + names[::-1]:
                t, outs[n] = _run(libs[n], staged, clens)
                times[n].append(t)
        _, planes = _run(cycles_lib, staged, clens)
        for n in names:
            if not all(torch.equal(x, y) for x, y in zip(outs[n], planes)):
                raise AssertionError(f"{n} and the instrumented kernel differ")

        b = staged.shape[0]
        h = np.zeros(2 * b, dtype=np.int64)
        if cycles_lib.sbt_row_cycles(h.ctypes.data, 2 * b):
            raise RuntimeError("reading the row cycles failed")
        real = clens.cpu().numpy() > 0
        row_cycles, tab_cycles = h.reshape(b, 2)[real].T
        lits, runs = symbol_counts(planes[1].cpu().numpy()[real],
                                   planes[2].cpu().numpy()[real])
        split = np.linalg.lstsq(np.stack([lits, runs], 1).astype(float),
                                (row_cycles - tab_cycles).astype(float),
                                rcond=None)[0]
        ms = {n: statistics.median(t) for n, t in times.items()}
        for n in names:
            print(f"{n}: median {ms[n]:.3f} ms over {len(times[n])} "
                  f"launches {sorted(round(t, 3) for t in times[n])}")
        result = {
            "card": card, "sm_mhz_max": sm_mhz, "rows": int(real.sum()),
            "ms": ms,
            "row_cycles_mean": float(row_cycles.mean()),
            "row_cycles_max": int(row_cycles.max()),
            "table_cycles_mean": float(tab_cycles.mean()),
            "table_share": float(tab_cycles.sum() / row_cycles.sum()),
            "literals_mean": float(lits.mean()),
            "match_runs_mean": float(runs.mean()),
            "cycles_per_literal": float(split[0]),
            "cycles_per_match_run": float(split[1]),
            "cycles_per_symbol_mean": float(
                ((row_cycles - tab_cycles) / (lits + runs)).mean()),
        }
        with open_channel(bam) as ch:
            result["split"] = host_device_split(
                ch, checker.pipeline.groups[0], dev)
        print(f"host vs device entropy phase: {result['split']}")
        print(card)
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
