#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spark_bam_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

1. Prints the card's name and power limit, then builds the CUDA kernels
   from ``spark_bam_tpu_torch/csrc`` with nvcc for sm_90a.
2. Writes a synthetic BAM (≥ 1 GiB uncompressed, short reads on GRCh38
   chr1/chr2, exact read count) and holds each kernel against its plain
   PyTorch version, bit for bit, at the shapes of the main path's first
   window: ``tokenize`` on the window's staged payload rows (plus seeded
   byte-mutants of 16 of them), ``lz77_resolve`` on the resulting token
   planes (plus a distance-1 RLE row, the 16-round worst case) and
   ``prefilter_check_flags`` on the inflated 32 MiB window (plus a window
   of seeded random bytes). Kernel times are CUDA-event medians.
3. Counts the BAM through ``StreamChecker.count_reads`` at the default
   geometry (24 MiB window, 4 MiB halo, 32 MiB kernel window) on the fused
   device path, with the launch counters reset just before and read just
   after, then through the classic host-zlib loop, and checks both counts
   against the generator's.

Prints one JSON line per kernel set (``{"kernels": [...]}``) and, last, the
device line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without CUDA, or without the package beside it, it exits non-zero
before printing a result.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import spark_bam_tpu_torch as port

    if Path(port.__file__).resolve().parent != ROOT / "spark_bam_tpu_torch":
        raise RuntimeError(f"imported {port.__file__}, not this checkout's")
    import numpy as np

    from spark_bam_tpu_torch.benchmarks.synth import synth_bam
    from spark_bam_tpu_torch.bgzf.flat import inflate_blocks
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

        # Error paths: 16 real rows and 32 seeded byte-mutants of them.
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
        log(f"tokenize mutants: 48 rows, {n_rej} rejected, bit-identical")
        rows.append(dict(
            name="tokenize", route="cuda",
            source="spark_bam_tpu_torch/csrc/tokenize.cu",
            replaces="spark_bam_tpu/tpu/pallas_kernels.py:299",
            parity="bit-identical", max_abs_err=max(tok_err, mut_err),
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
        del padded, soup, k_tok, p_tok, k_res, p_res, lit, dist, staged
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
        require(all(v > 0 for v in launches.values()), launches)
        gb = manifest["uncompressed_bytes"] / 1e9
        for name, s in (("fused device", fused_s), ("classic host-zlib",
                                                    classic_s)):
            log(f"count-reads {name}: {want} reads in {s:.3f} s = "
                f"{want / s:.0f} reads/s, {gb / s:.3f} GB/s inflated "
                f"({card})")
        log(f"funnel: {checker.funnel_stats}; launches {launches}")
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
