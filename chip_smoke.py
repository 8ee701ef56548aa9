#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_bam_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

1. Prints the card's name and power limit, then builds the CUDA kernels
   from ``spark_bam_tpu_torch/csrc`` with nvcc for sm_90a.
2. Writes a synthetic BAM (≥ 1 GiB uncompressed, short reads on GRCh38
   chr1/chr2, exact read count) and holds each kernel against its plain
   PyTorch version, bit for bit, at the shapes of the main path's first
   window: ``tokenize`` on the window's staged payload rows (with its
   symbols per row and cycles per symbol), on the shared DEFLATE edge set
   (``benchmarks/deflate_cases.py``) with 1,000 seeded mutants, and on
   seeded byte-mutants of 16 window rows; ``lz77_resolve`` on the
   resulting token planes (plus a distance-1 RLE row, the 16-round worst
   case),
   ``prefilter_check_flags`` on the inflated 32 MiB window (plus a window
   of seeded random bytes) and ``full_check_flags`` on that window at two
   valid lengths, on random bytes, on constant 0x88 bytes (every int a
   valid cigar op) and on a long-read window. Kernel times are CUDA-event
   medians.
3. count-reads: counts the BAM through ``StreamChecker.count_reads`` at the
   default geometry (24 MiB window, 4 MiB halo, 32 MiB kernel window) on
   the fused device path, then through the classic host-zlib loop, and
   checks both counts against the generator's.
4. full-check: ``full_check_summary_streaming`` over the same BAM at the
   default geometry, its windows inflated on the card (``tokenize``,
   ``lz77_resolve``) and fully flagged there (``full_check_flags``), then
   one pass over ``StreamChecker.full_spans``: its spans must tile the file
   and its zero masks past the header must number the generator's reads.
   A small BAM of two windows is summarised on the card, on the card from
   host-zlib windows (``device_inflate=False``) and with ``device="cpu"``
   (the plain versions): equal summaries.
5. Long reads (60-110 kb) at a 256 KiB window and 64 KiB halo, which the
   chains outrun: both count loops must still be exact (through the escape
   retry), ``full_spans`` must defer, and the card's summary must equal
   the CPU's.

Launch counters are set to 0 just before each main path (3, 4) and read
just after. Prints one JSON line per kernel set (``{"kernels": [...]}``)
and, last, the device line ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without CUDA, or without the package beside
it, it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak memory rate
#: The kernels of the count-reads path and of the full-check path.
COUNT_KERNELS = ("tokenize", "lz77_resolve", "prefilter_check_flags")
FULL_CHECK_KERNELS = ("tokenize", "lz77_resolve", "full_check_flags")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median kernel time of ``fn`` over ``reps`` runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def require(ok, what) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def _as_long(t):
    if t.dtype == torch.uint16:  # few ops exist for uint16: go via int16
        return t.view(torch.int16).long() & 0xFFFF
    return t.long()


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over integer tensor pairs (0 = identical)."""
    err = 0
    for got, want in pairs:
        g, w = (_as_long(t.cpu().reshape(-1)) for t in (got, want))
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g - w).abs().max()))
    return err


def tile_full_spans(checker):
    """One pass over ``checker.full_spans()``: ``(positions tiled by the
    window spans, zero masks at or past the header, deferred
    re-emissions)``. Window spans must be contiguous from 0; a deferred
    position holds mask 0 in its covering span and comes back once, in a
    span behind the frontier."""
    he = checker.header_end_abs
    frontier = zeros = deferred = 0
    for base, fm, _rb in checker.full_spans():
        lo = max(he - base, 0)
        if base < frontier:
            deferred += 1
            zeros += int((fm[lo:] == 0).sum()) - len(fm[lo:])
            continue
        require(base == frontier, f"span at {base}, frontier {frontier}")
        zeros += int((fm[lo:] == 0).sum())
        frontier = base + len(fm)
    # Each re-emitted position also counted once as a zero in its covering
    # span; the subtraction above took that back.
    return frontier, zeros, deferred


def summaries_equal(a: dict, b: dict) -> bool:
    """Two full-check summaries, site arrays compared exactly."""
    if a.keys() != b.keys():
        return False
    for k in a:
        if hasattr(a[k], "shape"):
            if not (a[k].shape == b[k].shape and (a[k] == b[k]).all()):
                return False
        elif a[k] != b[k]:
            return False
    return True


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import spark_bam_tpu_torch as port

    if Path(port.__file__).resolve().parent != ROOT / "spark_bam_tpu_torch":
        raise RuntimeError(f"imported {port.__file__}, not this checkout's")
    import numpy as np

    from spark_bam_tpu_torch.benchmarks import deflate_cases
    from spark_bam_tpu_torch.benchmarks.profile_tokenize import symbol_counts
    from spark_bam_tpu_torch.benchmarks.synth import synth_bam
    from spark_bam_tpu_torch.bgzf.flat import inflate_blocks
    from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
    from spark_bam_tpu_torch.core.channel import open_channel
    from spark_bam_tpu_torch.device import sync
    from spark_bam_tpu_torch.kernels import build
    from spark_bam_tpu_torch.tpu import kernels as K
    from spark_bam_tpu_torch.tpu.inflate import stage_group_device
    from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths
    from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE, tokenize_plain

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    build.load()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    dev = torch.device("cuda", 0)
    work = ROOT / "spark_bam_tpu_torch" / "_build" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    try:
        bam = work / "smoke.bam"
        t0 = time.perf_counter()
        manifest = synth_bam(bam, 1 << 30, seed=7)
        log(f"synthetic BAM: {manifest} ({time.perf_counter() - t0:.1f} s)")

        checker = port.StreamChecker(bam, port.Config())
        w, halo = checker.kernel_window, checker.halo
        require((w, halo) == (32 << 20, 4 << 20), (w, halo))
        lens_dev = torch.from_numpy(pad_contig_lengths(checker.lengths)).to(dev)
        nc = len(checker.lengths)
        group0 = checker.pipeline.groups[0]
        rows = []

        # ---- tokenize: the first window's staged rows ---------------------
        with open_channel(bam) as ch:
            staged, clens, usizes = stage_group_device(ch, group0, dev)
            flat0 = inflate_blocks(ch, group0).data
        k_tok = K.tokenize(staged, clens)
        sync(dev)
        t0 = time.perf_counter()
        p_tok = tokenize_plain(staged.cpu(), clens.cpu())
        tok_plain_ms = (time.perf_counter() - t0) * 1e3
        tok_err = max_abs_err(zip(k_tok, p_tok))
        require(tok_err == 0, f"tokenize differs from plain: {tok_err}")
        real = clens.cpu().numpy() > 0
        require(bool(p_tok[3].numpy()[real].all()), "real rows must decode")
        require(np.array_equal(p_tok[2].numpy()[real], usizes), "ISIZE")
        tok_ms = cuda_ms(lambda: K.tokenize(staged, clens), reps=5)
        b_pad, c_pad = staged.shape
        tok_bytes = (int(clens.sum()) + 4 * b_pad
                     + 3 * b_pad * STRIDE + 5 * b_pad)
        log(f"tokenize: {b_pad}x{c_pad} rows, bit-identical; kernel "
            f"{tok_ms:.3f} ms, plain (CPU Python) {tok_plain_ms:.0f} ms")

        # Symbols per row, estimated from the plain planes (literals plus
        # match runs), and the kernel's cycles per symbol of the longest
        # row at the card's top SM clock.
        lits, runs = symbol_counts(p_tok[1].view(torch.int16).numpy()[real],
                                   p_tok[2].numpy()[real])
        syms = lits + runs
        sm_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        ).stdout.split()[0])
        cycles = tok_ms * 1e-3 * sm_mhz * 1e6 / int(syms.max())
        log(f"tokenize symbols per row ({len(syms)} rows): literals mean "
            f"{lits.mean():.0f} max {lits.max()}, match runs mean "
            f"{runs.mean():.0f} max {runs.max()}, symbols max {syms.max()}; "
            f"{cycles:.0f} cycles per symbol at {sm_mhz:.0f} MHz")

        # Error paths: the shared DEFLATE edge set and 1,000 seeded mutants
        # of it, at a row width that puts rows at every alignment; then 16
        # real rows and 32 seeded byte-mutants of them.
        cases = deflate_cases.edge_cases()
        cases.update(deflate_cases.mutants(cases, 1000, seed=7))
        estaged, eclens, enames = deflate_cases.stage(cases, 16387)
        estaged_d = torch.from_numpy(estaged).to(dev)
        eclens_d = torch.from_numpy(eclens).to(dev)
        k_edge = K.tokenize(estaged_d, eclens_d)
        sync(dev)
        p_edge = tokenize_plain(torch.from_numpy(estaged),
                                torch.from_numpy(eclens))
        edge_err = max_abs_err(zip(k_edge, p_edge))
        require(edge_err == 0, f"tokenize differs on the edge set: {edge_err}")
        for i, name in enumerate(enames):
            if name in deflate_cases.EXPECT_REJECT:
                require(not bool(p_edge[3][i]), f"{name} must be rejected")
            elif not name.startswith("mutant_"):
                require(bool(p_edge[3][i]), f"{name} must decode")
        log(f"tokenize edge set: {len(enames) - 1000} streams and 1000 "
            f"mutants, {int((~p_edge[3]).sum())} rejected, bit-identical")
        del k_edge, p_edge, estaged_d

        rng = np.random.default_rng(7)
        sample = staged[:16].cpu().numpy()
        sample_clens = clens[:16].cpu().numpy()
        muts = []
        for i in range(32):
            row = sample[i % 16].copy()
            hits = rng.integers(0, sample_clens[i % 16], size=1 + i % 4)
            row[hits] ^= rng.integers(1, 256, size=len(hits)).astype(np.uint8)
            muts.append(row)
        mut_clens = np.tile(sample_clens, 3)
        mstaged = np.concatenate([sample, np.stack(muts)])
        mstaged_d = torch.from_numpy(mstaged).to(dev)
        mclens_d = torch.from_numpy(mut_clens.astype(np.int32)).to(dev)
        k_mut = K.tokenize(mstaged_d, mclens_d)
        p_mut = tokenize_plain(mstaged_d.cpu(), mclens_d.cpu())
        mut_err = max_abs_err(zip(k_mut, p_mut))
        n_rej = int((~p_mut[3]).sum())
        require(mut_err == 0, f"tokenize differs on mutants: {mut_err}")
        log(f"tokenize window mutants: 48 rows, {n_rej} rejected, "
            f"bit-identical")
        rows.append(dict(
            name="tokenize", route="cuda",
            source="spark_bam_tpu_torch/csrc/tokenize.cu",
            replaces="spark_bam_tpu/tpu/pallas_kernels.py:299",
            parity="bit-identical",
            max_abs_err=max(tok_err, edge_err, mut_err),
            ms=tok_ms,
            plain_ms=tok_plain_ms, bound_ms=tok_bytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None,
        ))

        # ---- lz77_resolve: those token planes + a distance-1 RLE row ------
        lit, dist = k_tok[0], k_tok[1]
        k_res, k_rounds = K.lz77_resolve(lit, dist)
        p_res, p_rounds = K._resolve_body(lit, dist)
        res_err = max_abs_err([(k_res, p_res)])
        require(res_err == 0, f"lz77_resolve differs from plain: {res_err}")
        require(int(k_rounds) <= int(p_rounds) <= 16, (k_rounds, p_rounds))
        got = k_res.cpu().numpy()
        start = 0
        for r, n in enumerate(usizes):
            require(np.array_equal(got[r, :n], flat0[start: start + n]),
                    f"resolved row {r} differs from host zlib")
            start += n
        rle_dist = torch.ones((1, STRIDE), dtype=torch.int16, device=dev)
        rle_dist[0, 0] = 0
        rle_dist = rle_dist.view(torch.uint16)
        rle_lit = torch.zeros((1, STRIDE), dtype=torch.uint8, device=dev)
        rle_lit[0, 0] = 0x41
        k_rle, k_rle_r = K.lz77_resolve(rle_lit, rle_dist)
        p_rle, p_rle_r = K._resolve_body(rle_lit, rle_dist)
        rle_err = max_abs_err([(k_rle, p_rle)])
        require(rle_err == 0 and bool((k_rle == 0x41).all()),
                "RLE row must resolve to its one literal")
        require(int(k_rle_r) <= int(p_rle_r) == 16, (k_rle_r, p_rle_r))
        res_ms = cuda_ms(lambda: K.lz77_resolve(lit, dist))
        res_plain_ms = cuda_ms(lambda: K._resolve_body(lit, dist), reps=3)
        res_bytes = 4 * lit.numel() + 4
        log(f"lz77_resolve: {tuple(lit.shape)}, bit-identical, rounds kernel "
            f"{int(k_rounds)} plain {int(p_rounds)}; RLE row kernel "
            f"{int(k_rle_r)} plain {int(p_rle_r)} rounds; "
            f"kernel {res_ms:.3f} ms, plain {res_plain_ms:.3f} ms")
        rows.append(dict(
            name="lz77_resolve", route="cuda",
            source="spark_bam_tpu_torch/csrc/lz77.cu",
            replaces="spark_bam_tpu/tpu/pallas_kernels.py:250",
            parity="bit-identical", max_abs_err=max(res_err, rle_err),
            ms=res_ms,
            plain_ms=res_plain_ms, bound_ms=res_bytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None,
        ))

        # ---- prefilter_check_flags: the 32 MiB window + random bytes ------
        n0 = len(flat0)
        padded = torch.zeros(w + K.PAD, dtype=torch.uint8, device=dev)
        padded[:n0] = torch.from_numpy(flat0).to(dev)
        soup = torch.from_numpy(
            rng.integers(0, 256, size=w + K.PAD, dtype=np.uint8)).to(dev)
        pre_err = 0
        for buf, n in ((padded, n0), (soup, w)):
            got = K.prefilter_check_flags(buf, lens_dev, nc, n)
            want = K._prefilter_flags(buf, lens_dev, nc, n)
            pre_err = max(pre_err, max_abs_err([(got, want)]))
        require(pre_err == 0, f"prefilter differs from plain: {pre_err}")
        pre_ms = cuda_ms(
            lambda: K.prefilter_check_flags(padded, lens_dev, nc, n0), reps=20)
        pre_plain_ms = cuda_ms(
            lambda: K._prefilter_flags(padded, lens_dev, nc, n0), reps=5)
        pre_bytes = (w + 35) + 4 * lens_dev.numel() + 4 * w
        log(f"prefilter_check_flags: W={w}, bit-identical on the window and "
            f"on random bytes; kernel {pre_ms:.3f} ms, plain "
            f"{pre_plain_ms:.3f} ms")
        rows.append(dict(
            name="prefilter_check_flags", route="cuda",
            source="spark_bam_tpu_torch/csrc/prefilter.cu",
            replaces="spark_bam_tpu/tpu/pallas_kernels.py:436",
            parity="bit-identical", max_abs_err=pre_err, ms=pre_ms,
            plain_ms=pre_plain_ms,
            bound_ms=pre_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None,
        ))
        # ---- full_check_flags: the window at two lengths, random bytes,
        # constant 0x88 (n_cigar 34,952 of valid ops at every offset), and
        # a window of long reads ------------------------------------------
        long_bam = work / "long.bam"
        long_manifest = synth_bam(long_bam, 8 << 20, seed=9, unit_reads=32,
                                  read_len=(60_000, 110_000))
        log(f"long-read BAM: {long_manifest}")
        with open_channel(long_bam) as ch:
            long_flat = inflate_blocks(ch, blocks_metadata(long_bam)).data
        long_n = min(len(long_flat), w)
        long_pad = torch.zeros(w + K.PAD, dtype=torch.uint8, device=dev)
        long_pad[:long_n] = torch.from_numpy(long_flat[:long_n]).to(dev)
        const88 = torch.full((w + K.PAD,), 0x88, dtype=torch.uint8, device=dev)
        full_err = 0
        for label, buf, n in (("window", padded, n0),
                              ("window, n - 12345", padded, n0 - 12345),
                              ("random bytes", soup, w),
                              ("constant 0x88", const88, w),
                              ("long reads", long_pad, long_n)):
            got = K.full_check_flags(buf, lens_dev, nc, n)
            want = K._compute_flags(buf, lens_dev, nc, n)
            err = max_abs_err([(got, want)])
            full_err = max(full_err, err)
            case_ms = cuda_ms(
                lambda: K.full_check_flags(buf, lens_dev, nc, n), reps=20)
            log(f"full_check_flags [{label}]: W={w}, n={n}, max_abs_err "
                f"{err}, kernel {case_ms:.3f} ms")
        require(full_err == 0, f"full_check_flags differs from plain: "
                               f"{full_err}")
        full_ms = cuda_ms(
            lambda: K.full_check_flags(padded, lens_dev, nc, n0), reps=20)
        full_plain_ms = cuda_ms(
            lambda: K._compute_flags(padded, lens_dev, nc, n0), reps=3)
        full_bytes = (w + K.PAD) + 4 * lens_dev.numel() + 4 * w
        log(f"full_check_flags: bit-identical on all five; kernel "
            f"{full_ms:.3f} ms, plain {full_plain_ms:.3f} ms")
        rows.append(dict(
            name="full_check_flags", route="cuda",
            source="spark_bam_tpu_torch/csrc/full_flags.cu",
            replaces="spark_bam_tpu/tpu/pallas_kernels.py:470",
            parity="bit-identical", max_abs_err=full_err, ms=full_ms,
            plain_ms=full_plain_ms,
            bound_ms=full_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None,
        ))
        del padded, soup, const88, long_pad, k_tok, p_tok, k_res, p_res
        del lit, dist, staged
        torch.cuda.empty_cache()

        # ---- end to end: count-reads, fused device path, then classic -----
        checker = port.StreamChecker(bam, port.Config())
        K.reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        fused = checker.count_reads()
        sync(dev)
        fused_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        classic_checker = port.StreamChecker(
            bam, port.Config(fused_count=False))
        t0 = time.perf_counter()
        classic = classic_checker.count_reads()
        sync(dev)
        classic_s = time.perf_counter() - t0
        want = manifest["reads"]
        require(fused == want, f"fused count {fused} != generator's {want}")
        require(classic == want, f"classic count {classic} != {want}")
        require(checker.tokenize_demotions == 0, "tokenizer demoted")
        require(all(launches[k] > 0 for k in COUNT_KERNELS), launches)
        gb = manifest["uncompressed_bytes"] / 1e9
        for name, s in (("fused device", fused_s), ("classic host-zlib",
                                                    classic_s)):
            log(f"count-reads {name}: {want} reads in {s:.3f} s = "
                f"{want / s:.0f} reads/s, {gb / s:.3f} GB/s inflated "
                f"({card})")
        log(f"funnel: {checker.funnel_stats}; launches {launches}")

        # ---- end to end: full-check, then one pass over its spans --------
        K.reset_launch_counts()
        sync(dev)
        t0 = time.perf_counter()
        summary = port.full_check_summary_streaming(bam, port.Config())
        sync(dev)
        fc_s = time.perf_counter() - t0
        fc_launches = dict(K.LAUNCHES)
        require(all(fc_launches[k] > 0 for k in FULL_CHECK_KERNELS),
                fc_launches)
        launches["full_check_flags"] = fc_launches["full_check_flags"]
        total = summary["positions"]
        windows = len(checker.pipeline.groups)
        log(f"full-check: {total} positions, {windows} windows in "
            f"{fc_s:.3f} s = {total / fc_s:.0f} positions/s, "
            f"{want / fc_s:.0f} reads/s; {summary['considered']} considered, "
            f"{len(summary['critical_positions'])} critical, "
            f"{len(summary['two_check_positions'])} two-check; launches "
            f"{fc_launches} ({card})")
        sc = port.StreamChecker(bam, port.Config())
        t0 = time.perf_counter()
        tiled, zeros, deferred = tile_full_spans(sc)
        spans_s = time.perf_counter() - t0
        require(tiled == sc.total == total, (tiled, sc.total, total))
        require(sc.tokenize_demotions == 0, "full_spans demoted a window")
        require(zeros == want, f"{zeros} zero masks past the header, "
                               f"{want} reads")
        log(f"full_spans: tiles {tiled} positions, {deferred} deferred "
            f"re-emissions, {zeros} zero masks past the header = reads; "
            f"the pass alone (no summary) {spans_s:.3f} s")

        small = work / "small.bam"
        small_manifest = synth_bam(small, 40 << 20, seed=8)
        t0 = time.perf_counter()
        on_card = port.full_check_summary_streaming(small, port.Config())
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host_zlib = port.full_check_summary_streaming(
            small, port.Config(device_inflate=False))
        host_zlib_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = port.full_check_summary_streaming(small, port.Config(),
                                                   device="cpu")
        cpu_s = time.perf_counter() - t0
        small_windows = len(port.StreamChecker(
            small, port.Config(), device="cpu").pipeline.groups)
        require(small_windows >= 2, small_windows)
        require(summaries_equal(on_card, on_cpu), "card and CPU summaries "
                                                  "differ")
        require(summaries_equal(on_card, host_zlib),
                "device-inflated and host-zlib summaries differ")
        log(f"full-check card vs CPU: {small_manifest['uncompressed_bytes']} "
            f"bytes, {small_windows} windows, equal summaries; card "
            f"{card_s:.3f} s, card from host-zlib windows {host_zlib_s:.3f} "
            f"s, CPU (plain versions) {cpu_s:.3f} s")

        # ---- long reads: chains outrun a 64 KiB halo ---------------------
        geo = (256 << 10, 64 << 10)
        long_reads = long_manifest["reads"]
        for fused in (True, False):
            lc = port.StreamChecker(long_bam, port.Config(fused_count=fused),
                                    *geo)
            retries = []
            via_spans = lc._count_via_spans
            lc._count_via_spans = lambda: retries.append(1) or via_spans()
            got = lc.count_reads()
            require(got == long_reads, f"long-read count {got} != "
                                       f"{long_reads} (fused={fused})")
            require(retries == [1], f"expected one escape retry, got "
                                    f"{len(retries)}")
        lc = port.StreamChecker(long_bam, port.Config(), *geo)
        tiled, zeros, deferred = tile_full_spans(lc)
        require(tiled == lc.total, (tiled, lc.total))
        require(deferred > 0, "long reads must defer")
        require(zeros == long_reads, (zeros, long_reads))
        long_card = port.full_check_summary_streaming(long_bam, port.Config(),
                                                      *geo)
        long_cpu = port.full_check_summary_streaming(
            long_bam, port.Config(), *geo, device="cpu")
        require(summaries_equal(long_card, long_cpu),
                "long-read card and CPU summaries differ")
        log(f"long reads: {long_reads} reads counted exactly on both loops "
            f"through the escape retry; full_spans {deferred} deferred "
            f"re-emissions; card summary equals CPU")

        for row in rows:
            row["launches"] = launches[row["name"]]
        print(json.dumps({"kernels": rows}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
