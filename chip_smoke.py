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
   case, and the shared token-row edge set of
   ``benchmarks/resolve_flag_cases.py``), with the rounds each row took,
   ``prefilter_check_flags`` (flags, survivor list and count in one
   launch) on the inflated 32 MiB window at its length and at one short of
   a tile edge, on seeded random bytes, on a window whose survivors
   overflow the capacity and on the shared prefilter edge set
   (``benchmarks/prefilter_cases.py``) at W = 2^25, each case twice back
   to back on one stream and once on a second stream, then
   ``benchmarks/profile_prefilter.py``'s phase split and the plain
   compaction's and ``torch.nonzero``'s card times; and
   ``full_check_flags`` on that window at two valid lengths, on random
   bytes, on constant 0x88 bytes (every int a valid cigar op), on a
   long-read window and on the shared flag-window edge set at W = 2^25.
   Kernel times are CUDA-event medians. Then
   ``benchmarks/profile_resolve_flags.py`` on the same window: the
   clock64 phase split of LZ77 and the full pass and the rounds
   histogram.
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
6. The resident count: ``StreamChecker.count_reads_resident`` over the
   1 GiB BAM at the default geometry (host-zlib windows packed four to a
   resident chunk, each chunk one CUDA graph replay of its window bodies):
   the generator's count, its wall beside the fused and classic counts,
   the graphs captured, replays and launches a replay runs, then again
   on the same checker (graphs reused); the long reads exact through the
   escape retry; the small BAM counted equally on the card and the CPU.
   Both flag kernels were also captured in a graph at W = 2^25 in step 2
   and replayed over four windows of different bytes and lengths, on one
   stream and on a second, bit-identical to their plain versions on every
   replay (``benchmarks/replay_cases.py``).
7. The load path: ``stream_read_batches`` over the 1 GiB BAM at the
   default geometry (each window's records parsed on the device window
   the check holds; rows = the generator's reads, no spills, no
   demotions; reads/s and the per-window ``parse_records`` time, CUDA
   events), then with a loci and flag filter (the mask equals a NumPy
   filter over the unfiltered columns); the load edge corpus
   (``benchmarks/load_cases.py``) on the card, on the CPU and with the
   funnel off (``full_check_flags``), equal batches under every filter,
   tags included; the long reads' exact spills; ``load_reads_columnar``
   and ``record_starts`` on the small BAM, card against CPU.
8. The sharded workloads (``parallel/``) on ``make_mesh()``, every card:
   ``count_reads_sharded`` over the 1 GiB BAM (the generator's count, no
   escape, no demotion, no fallback; wall beside the fused count; steps,
   rows, launches a step, graph replays), then again with its graphs
   reused; ``full_check_summary_sharded`` at K = 2^17 sites a row (equal
   to phase 4's streaming summary, no fallback; wall beside phase 4's; the
   most sites of any row; the full step's check and reduction per row,
   CUDA events); ``check_bam_sharded`` against a ``.records`` sidecar from
   the port's ``index_records`` (every read a true positive, no false
   call); the small BAM at the default K (the site lists overflow: the
   fallback must give the streaming summary), and on a two-entry mesh of
   one card equal to a one-entry mesh; long reads exact through patched
   steps, full-check equal to the CPU's; two processes of
   ``parallel/multihost.py`` joined by gloo on the one card (and by NCCL,
   one card each, where there are two cards) counting the small BAM.

9. The aggregate (``load.api.aggregate``, default spec
   ``count;flagstat;mapq;tlen;coverage``) over the 1 GiB BAM: the whole-file
   check (``full_check_flags`` windows), the record parse and the
   reduction on the card; ``count`` and ``flagstat`` totals = the
   generator's reads, every vector = the port's int64 oracle
   (``agg.host.host_aggregate``) over the parsed columns; the wall and its
   host split, the ``full_check_flags`` launches, the reduction's card time
   and PyTorch launches per 65,536-record window, peak host RSS and peak
   device memory. Then with a loci and flag filter (= the oracle over
   NumPy-masked columns); the mesh's agg step on every card and on a
   two-entry mesh of one card (= one device); card = CPU on the small BAM,
   the load edge corpus under tag filters and an unmapped BAM with no
   reference sequences (``benchmarks/agg_cases.py``; empty coverage).

10. Split planning with the ``.sbi`` cache (``split_phase``, under a
   temporary ``SPARK_BAM_CACHE_DIR``): ``index -m 32MB --record-starts``
   on the 1 GiB BAM, cold (the wall split into block scan, boundary
   resolutions on the card with each one's ms, and the streaming starts;
   launches, peak host RSS and device memory; the sidecar's starts = the
   generator's manifest, every resolved plan start a manifest start, the
   first the header's end); ``compute-splits -s -m 32MB`` cold with the
   cache off, then warm with ``--cache read`` (equal splits, zero launches,
   zero resolutions); the aggregate warm from the sidecar (= phase 9's
   result, zero launches; its wall beside phase 9's); on the small BAM,
   ``compute-splits`` in the default mode card = CPU, the plan card = CPU
   with a sentinel-only last split (``PLAN_NONE``) and a touched sidecar
   invalidated and recomputed. The time per boundary at the reference's
   2 MiB splits: ``benchmarks/profile_splits.py``.

11. The columnar export (``export_phase``): ``export`` of the 1 GiB BAM
   (native container, codec none, all columns, 8,192 rows a frame):
   4,784,128 rows in 584 frames, read back by the port's
   ``NativeReader``: its fixed columns = the load's (phase 7) in file
   order, ``pos`` = the generator's, the variable-length columns of the
   first and last 8,192 rows and every 997th = the row-by-row
   ``_var_piece``; the wall split into stream (check and parse), render,
   dictionary pass, encode and write, reads/s, bytes, peak host RSS and
   launches (``full_check_flags`` 0), timed by
   ``benchmarks/profile_export.py::timed_export`` (which also times a
   projected export alone: ``python3 -m
   spark_bam_tpu_torch.benchmarks.profile_export --columns
   flag,pos,name,cigar --columnar codec=zlib``). Then card bytes = CPU
   bytes on the small BAM and a 2 MiB long-read BAM (rows in file order)
   for codecs none, zlib and deflate, unfiltered and with a loci and flag
   filter.

12. The write path (``write_phase``): ``crc32_lanes`` and
   ``deflate_fixed_lanes`` (``csrc/deflate.cu``) against their plain
   versions on the card, bit for bit (the whole packed plane, total_bits,
   CRC), and against zlib's CRC-32 and ``fixed_pack``, at B = 1, 16 and
   128 over ``benchmarks/write_cases.py`` (lengths 0 to STRIDE, an
   overflowing lane), and their CUDA-event times on the writer's own
   payloads at lanes 16 and 128; ``BgzfWriter`` over the 1 GiB BAM's
   uncompressed stream under mode=fixed and mode=stored at lanes 16 and
   128 and under mode=off (host zlib), timed by
   ``benchmarks/profile_write.py::timed_write`` (staging, H2D, kernel,
   wait, D2H, assembly, write), every member inflated back by host zlib
   against its payload and its row, every 64th equal to the host
   function's; ``rewrite -i --deflate mode=fixed`` through ``cli.py`` on
   the small BAM and a 256 MiB one, equal byte for byte (BAM, ``.blocks``,
   ``.records``) to ``device=off``, the output counted to the manifest's
   reads and its warm ``compute-splits`` resolving nothing;
   ``encode_zlib_stream`` on the card over 64 MiB with one incompressible
   window (= ``zlib_stream``, one re-pack), and the small BAM's export
   with ``codec=deflate`` under ``SPARK_BAM_DEFLATE=mode=fixed`` =
   ``device=off``.

Launch counters are set to 0 just before each main path (3, 4, 6, 7, 8,
9, 10, 11, 12) and read just after; a graph replay counts the launches captured in it. Prints one JSON line per kernel set (``{"kernels": [...]}``)
and, last, the device line ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without CUDA, or without the package beside
it, it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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
    if t.dtype == torch.uint32:
        return t.view(torch.int32).long() & 0xFFFFFFFF
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


def batches_equal(got, want, label) -> None:
    """Two ``(abs_base, ReadBatch)`` sequences, column for column."""
    require([b for b, _ in got] == [b for b, _ in want], f"{label}: bases")
    for (base, g), (_, w) in zip(got, want):
        require(list(g.columns) == list(w.columns), f"{label}: columns")
        require((g.starts == w.starts).all() and len(g.starts) == len(w.starts)
                and (g.buf == w.buf).all(), f"{label}: starts/buf at {base}")
        for k in w.columns:
            require(g.columns[k].dtype == w.columns[k].dtype
                    and (g.columns[k] == w.columns[k]).all(),
                    f"{label}: column {k} at {base}")


def numpy_filter(cols, intervals, required: int, forbidden: int):
    """The interval/flag filter in plain NumPy (int64, no wrap: the
    synthetic reads' ends stay far inside int32)."""
    pos = cols["pos"].astype(np.int64)
    end = pos + np.maximum(cols["ref_span"].astype(np.int64), 1)
    ref, flag = cols["ref_id"], cols["flag"]
    hit = np.zeros(len(pos), dtype=bool)
    for r, lo, hi in intervals:
        hit |= (ref == r) & (pos < hi) & (lo < end)
    ok = ((flag & required) == required) & ((flag & forbidden) == 0)
    return ((flag & 4) == 0) & (ref >= 0) & hit & ok


def resident_phase(port, bam, manifest, long_bam, long_manifest, small,
                   small_manifest, card, fused_s, classic_s) -> dict:
    """Phase 6, the resident count; returns its kernel launch counts on
    the 1 GiB count."""
    from spark_bam_tpu_torch.tpu import kernels as K

    want = manifest["reads"]
    checker = port.StreamChecker(bam, port.Config(resident_scan=True))
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = checker.count_reads_resident()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    funnel = dict(checker.funnel_stats)
    runner = checker.scan_runner
    require(got == want, f"resident count {got} != generator's {want}")
    require(launches["prefilter_check_flags"] > 0, launches)
    require(isinstance(runner, port.CountScanGraphs), type(runner))
    windows = len(checker.pipeline.groups)
    rows = checker.resident_chunk_rows()
    chunks = runner.replays
    require(chunks == -(-windows // rows) and chunks < windows,
            f"{chunks} replays for {windows} windows at {rows} a chunk")
    captures = runner.captures
    per_replay = {f"{kp} rows": v for (kp, _), v in
                  runner.launches_per_replay().items()}
    t0 = time.perf_counter()
    again = checker.count_reads_resident()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    require(again == want and runner.captures == captures,
            "the second resident count must reuse the graphs")
    gb = manifest["uncompressed_bytes"] / 1e9
    for name, s in (("resident (captures included)", first_s),
                    ("resident (graphs reused)", warm_s),
                    ("fused device", fused_s), ("classic host-zlib", classic_s)):
        log(f"count-reads {name}: {want} reads in {s:.3f} s = "
            f"{want / s:.0f} reads/s, {gb / s:.3f} GB/s inflated ({card})")
    log(f"resident: {windows} windows, {rows} rows a chunk, {chunks} graph "
        f"replays a count, {captures} graphs captured ({per_replay} launched "
        f"a replay); launches {launches}; funnel {funnel}")

    geo = (256 << 10, 64 << 10)
    lc = port.StreamChecker(long_bam, port.Config(), *geo)
    retries = []
    via_spans = lc._count_via_spans
    lc._count_via_spans = lambda: retries.append(1) or via_spans()
    got = lc.count_reads_resident(chunk_windows=4)
    require(got == long_manifest["reads"] and retries == [1],
            f"long-read resident count {got}, {len(retries)} escape retries")
    t0 = time.perf_counter()
    on_card = port.StreamChecker(small, port.Config()).count_reads_resident()
    on_cpu = port.StreamChecker(small, port.Config(),
                                device="cpu").count_reads_resident()
    require(on_card == on_cpu == small_manifest["reads"],
            f"small BAM resident count card {on_card}, CPU {on_cpu}")
    log(f"resident long reads: {got} reads exact through one escape retry; "
        f"small BAM: card = CPU = {on_cpu}; {time.perf_counter() - t0:.1f} s")
    del checker, runner, lc
    torch.cuda.empty_cache()
    return launches


def load_phase(port, bam, manifest, long_bam, long_manifest, small, work,
               card) -> dict:
    """Phase 7, the load path; returns its kernel launch counts on the
    1 GiB load and on the edge corpus's funnel-off load, and the 1 GiB
    load's fixed columns in file order (phase 11's reference)."""
    import weakref

    from spark_bam_tpu_torch.benchmarks import load_cases
    from spark_bam_tpu_torch.benchmarks.synth import record_positions
    from spark_bam_tpu_torch.load import tpu_load
    from spark_bam_tpu_torch.tpu import kernels as K
    from spark_bam_tpu_torch.tpu import parser, stream_check

    dev = torch.device("cuda", 0)
    checked, timed, host_parses, made = [], [], [], []
    real_check = stream_check.check_window
    real_parse = parser.parse_records
    real_flat = stream_check.parse_flat_records
    real_checker = tpu_load.StreamChecker

    def spy_check(padded, *a, **kw):
        checked.append(weakref.ref(padded))
        return real_check(padded, *a, **kw)

    def timed_parse(padded, starts, *a, **kw):
        s = torch.cuda.current_stream(padded.device)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record(s)
        out = real_parse(padded, starts, *a, **kw)
        t1.record(s)
        resident = any(r() is padded for r in checked)
        timed.append((t0, t1, starts.numel(), padded.numel(), resident))
        return out

    def spy_flat(buf, starts, *a, **kw):
        host_parses.append(len(buf))
        return real_flat(buf, starts, *a, **kw)

    class Recording(real_checker):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    stream_check.check_window = spy_check
    parser.parse_records = timed_parse
    stream_check.parse_flat_records = spy_flat
    tpu_load.StreamChecker = Recording
    try:
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = spills = batches = 0
        fixed = ("flag", "ref_id", "pos", "mapq", "next_ref_id", "next_pos",
                 "tlen")
        parts: dict = {c: [] for c in fixed}
        for base, batch in port.stream_read_batches(bam, port.Config()):
            batches += 1
            rows += len(batch)
            spills += len(batch) if base == -1 else 0
            for c in fixed:
                parts[c].append(batch[c])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_launches = dict(K.LAUNCHES)
        checker = made[-1]
        w = checker.kernel_window
        require(all(load_launches[k] > 0 for k in COUNT_KERNELS),
                f"load path launches {load_launches}")
        require(rows == manifest["reads"], f"load rows {rows} != "
                                           f"{manifest['reads']}")
        require(spills == 0 and not host_parses, f"{spills} spills")
        require(checker.tokenize_demotions == 0, "load demoted a window")
        require(len(timed) == batches, (len(timed), batches))
        require(all(t[4] and t[3] == w + K.PAD for t in timed),
                "a window parse ran on another tensor than the checked one")
        parse_ms = [a.elapsed_time(b) for a, b, *_ in timed]
        per_row = [ms / n for (ms, (_, _, n, _, _)) in zip(parse_ms, timed)]
        log(f"load: stream_read_batches {rows} reads in {batches} windows, "
            f"{load_s:.3f} s = {rows / load_s:.0f} reads/s "
            f"({manifest['uncompressed_bytes'] / 1e9 / load_s:.3f} GB/s); "
            f"parse_records per window (CUDA events) median "
            f"{statistics.median(parse_ms):.3f} ms, max {max(parse_ms):.3f} "
            f"ms ({statistics.median(per_row) * 1e6:.1f} ns a record), "
            f"every window parsed on its checked device tensor, 0 spills, "
            f"0 host parses; launches {load_launches} ({card})")

        # Filtered: a loci + flag filter, held against NumPy on the CPU.
        loci = "chr1:100000-900000,chr2:500000-1500000"
        header = checker.header
        ivs = tpu_load._interval_table(header, loci)
        kept = 0
        t0 = time.perf_counter()
        for base, batch in port.stream_read_batches(
                bam, port.Config(), loci=loci, flags_forbidden=0x10):
            want = numpy_filter(batch.columns, ivs, 0, 0x10)
            require((batch.columns["valid"] == want).all(),
                    f"filtered mask differs at {base}")
            kept += int(want.sum())
        filt_s = time.perf_counter() - t0
        require(0 < kept < rows, kept)
        log(f"load filtered ({loci}, forbid 0x10): {kept} of {rows} reads "
            f"kept, masks equal to NumPy on the CPU; {filt_s:.3f} s")
    finally:
        stream_check.check_window = real_check
        parser.parse_records = real_parse
        stream_check.parse_flat_records = real_flat
        tpu_load.StreamChecker = real_checker

    # The edge corpus: card, CPU and funnel off, under every filter.
    edges = work / "edges.bam"
    em = load_cases.write_bam(edges, seed=0)
    w0, h0 = load_cases.GEOMETRY
    cfg = port.Config(window_size=w0, halo_size=h0)
    off = port.Config(window_size=w0, halo_size=h0, funnel="off")
    off_launches: dict = {}
    t0 = time.perf_counter()
    for loci in (None,) + load_cases.LOCI:
        for fr, ff in ((0, 0),) + load_cases.FLAG_FILTERS:
            kw = dict(loci=loci, flags_required=fr, flags_forbidden=ff)
            on_card = list(port.stream_read_batches(edges, cfg, **kw))
            on_cpu = list(port.stream_read_batches(edges, cfg, device="cpu",
                                                   **kw))
            label = f"edges {loci} {fr:#x}/{ff:#x}"
            batches_equal(on_card, on_cpu, label)
            if loci is None and not fr and not ff:
                before = dict(K.LAUNCHES)
                funnel_off = list(port.stream_read_batches(edges, off))
                off_launches = {k: v - before[k]
                                for k, v in K.LAUNCHES.items()}
                batches_equal(funnel_off, on_card, label + " funnel off")
                spilled = sum(len(b) for base, b in on_card if base == -1)
                found = sum(len(b) for _, b in on_card)
                require(spilled >= load_cases.LONG_READS, spilled)
                require(found == em["records"] - len(em["refused"]),
                        (found, em["records"]))
            for tags in load_cases.TAG_FILTERS:
                for (_, a), (_, b) in zip(on_card, on_cpu):
                    require((tpu_load._tag_presence_mask(a, tags)
                             == tpu_load._tag_presence_mask(b, tags)).all(),
                            f"{label} tags {tags}")
    require(off_launches["full_check_flags"] > 0
            and not off_launches["prefilter_check_flags"],
            f"funnel off must run the full pass alone: {off_launches}")
    log(f"load edge corpus: {em['records']} records "
        f"({em['uncompressed_bytes']} bytes), card = CPU under "
        f"{len(load_cases.LOCI) + 1} loci x {len(load_cases.FLAG_FILTERS) + 1}"
        f" flag filters x {len(load_cases.TAG_FILTERS)} tag sets, funnel off "
        f"(launches {off_launches}) = funnel on; "
        f"{time.perf_counter() - t0:.1f} s")

    # Long reads: exact spills at 256 KiB / 64 KiB.
    lcfg = port.Config(window_size=256 << 10, halo_size=64 << 10)
    got = list(port.stream_read_batches(long_bam, lcfg))
    spilled = sum(len(b) for base, b in got if base == -1)
    pos = sorted(np.concatenate([b["pos"] for _, b in got]).tolist())
    require(spilled > 0, "long reads must spill")
    require(pos == sorted(record_positions(long_manifest)),
            "long-read positions differ from the generator's")
    log(f"load long reads: {len(pos)} reads, {spilled} decoded exactly from "
        f"the stream, positions = the generator's")

    # Whole file: record_starts and load_reads_columnar, card against CPU.
    t0 = time.perf_counter()
    rs_card = port.record_starts(small)
    rs_cpu = port.record_starts(small, device="cpu")
    require((rs_card.starts == rs_cpu.starts).all()
            and len(rs_card.starts) == len(rs_cpu.starts), "record_starts")
    for kw in ({}, {"loci": "chr1:0-1000000", "flags_forbidden": 0x400}):
        a = port.load_reads_columnar(small, **kw)
        b = port.load_reads_columnar(small, device="cpu", **kw)
        batches_equal([(0, a)], [(0, b)], f"load_reads_columnar {kw}")
    log(f"load whole file: record_starts ({len(rs_card.starts)} starts) and "
        f"load_reads_columnar equal on card and CPU; "
        f"{time.perf_counter() - t0:.1f} s")
    load_cols = {c: np.concatenate(v) for c, v in parts.items()}
    return load_launches, off_launches, load_cols


def _two_process_count(bam, work, backend: str) -> list[dict]:
    """Two processes of the multi-process worker counting ``bam`` in
    several all-reduced steps, joined through a file rendezvous; returns
    their JSON lines."""
    init = work / f"rendezvous-{backend}"
    argv = [sys.executable, "-m", "spark_bam_tpu_torch.parallel.multihost",
            "--init-file", str(init), "--num-processes", "2", "--backend",
            backend, "--bam", str(bam), "--chunk-bytes", str(32 << 20)]
    procs = [subprocess.Popen([*argv, "--process-id", str(pid)], cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        require(p.returncode == 0, f"{backend} worker failed:\n{out[-3000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def sharded_phase(port, bam, manifest, summary, fc_s, fused_s, small,
                  small_manifest, small_summary, work, card) -> dict:
    """Phase 8, the sharded workloads; returns the kernel launch counts of
    the sharded count, full-check and check-bam on the 1 GiB BAM."""
    from spark_bam_tpu_torch.bam.index_records import index_records
    from spark_bam_tpu_torch.benchmarks.profile_sharded import (
        row_ms,
        timed_full_rows,
    )
    from spark_bam_tpu_torch.benchmarks.synth import synth_bam
    from spark_bam_tpu_torch.parallel import mesh as pm
    from spark_bam_tpu_torch.tpu import kernels as K

    want = manifest["reads"]
    cards = torch.cuda.device_count()
    mesh = port.make_mesh()
    require(mesh.n_local == cards, (mesh, cards))
    launches = {}

    # ---- count ---------------------------------------------------------
    walls = []
    for run in range(2):
        stats = {}
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = port.count_reads_sharded(bam, port.Config(), mesh=mesh,
                                       stats_out=stats)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            launches["sharded_count"] = dict(K.LAUNCHES)
        require(got == want, f"sharded count {got} != generator's {want}")
        require(stats["escapes"] == 0 and stats["tokenize_demotions"] == 0
                and stats["fallback"] is False, stats)
    cl = launches["sharded_count"]
    require(all(cl[k] > 0 for k in COUNT_KERNELS)
            and cl["full_check_flags"] == 0, cl)
    runners = list(pm.mesh_steps(mesh).count_step(10, True).runners.values())
    replays = sum(r.replays for r in runners)
    per_replay = [r.launches_per_replay() for r in runners]
    gb = manifest["uncompressed_bytes"] / 1e9
    log(f"sharded count on {cards} card(s): {want} reads, {stats['steps']} "
        f"steps of {stats['rows']} rows; {walls[0]:.3f} s with its graph "
        f"captures, {walls[1]:.3f} s reused ({want / walls[1]:.0f} reads/s, "
        f"{gb / walls[1]:.3f} GB/s), fused count {fused_s:.3f} s ({card}); "
        f"launches {cl}, {sum(cl.values()) / stats['steps']:.1f} a step; "
        f"{replays} graph replays over both counts, launches a replay "
        f"{per_replay}")

    # ---- full-check: the report reduced on the card, row by row ---------
    k = 1 << 17
    stats = {}
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = port.full_check_summary_sharded(bam, port.Config(), mesh=mesh,
                                              k_positions=k, stats_out=stats)
    torch.cuda.synchronize()
    fcs_s = time.perf_counter() - t0
    launches["sharded_full_check"] = fl = dict(K.LAUNCHES)
    require(all(fl[x] > 0 for x in FULL_CHECK_KERNELS)
            and fl["prefilter_check_flags"] == 0, fl)
    require(stats["fallback"] is False and stats["defers"] == 0
            and stats["tokenize_demotions"] == 0, stats)
    require(sharded.pop("devices") == cards, "devices")
    require(summaries_equal(sharded, summary),
            "sharded full-check differs from the streaming summary")
    # Again, with CUDA events around each row's check and reduction and the
    # site lists' fill read from each step's host copy.
    with timed_full_rows() as timed:
        t0 = time.perf_counter()
        again = port.full_check_summary_sharded(bam, port.Config(),
                                                mesh=mesh, k_positions=k)
        torch.cuda.synchronize()
        timed_s = time.perf_counter() - t0
    again.pop("devices")
    require(summaries_equal(again, summary), "second sharded full-check")
    per_row = row_ms(timed["rows"])
    two = len(summary["two_check_positions"])
    total = summary["positions"]
    log(f"sharded full-check on {cards} card(s), K = {k}: {total} "
        f"positions in {fcs_s:.3f} s ({total / fcs_s:.0f} positions/s; "
        f"timed again {timed_s:.3f} s) against the streaming summary's "
        f"{fc_s:.3f} s, equal summaries, no fallback ({card}); "
        f"most sites of a row {timed['most_sites']} ({two} two-check sites "
        f"in all); per row (CUDA events) {per_row}; launches {fl}")

    # ---- check-bam against the port's .records sidecar -------------------
    t0 = time.perf_counter()
    _, n_records = index_records(bam)
    index_s = time.perf_counter() - t0
    require(n_records == want, (n_records, want))
    stats = {}
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb = port.check_bam_sharded(bam, port.Config(), mesh=mesh,
                                stats_out=stats)
    torch.cuda.synchronize()
    cb_s = time.perf_counter() - t0
    launches["check_bam"] = bl = dict(K.LAUNCHES)
    require(cb["true_positives"] == want and cb["false_positives"] == 0
            and cb["false_negatives"] == 0 and cb["devices"] == cards, cb)
    require(stats["fallback"] is False and stats["patched_steps"] == 0
            and stats["tokenize_demotions"] == 0, stats)
    require(all(bl[x] > 0 for x in COUNT_KERNELS), bl)
    log(f"sharded check-bam: {cb} in {cb_s:.3f} s (.records of {n_records} "
        f"records written in {index_s:.3f} s); launches {bl}")

    # ---- the small BAM: the default K overflows; one card as two shards --
    t0 = time.perf_counter()
    stats = {}
    sd = port.full_check_summary_sharded(small, port.Config(), mesh=mesh,
                                         stats_out=stats)
    require(stats["fallback"] is True and sd.pop("devices") == 1, stats)
    require(summaries_equal(sd, small_summary),
            "small BAM fallback differs from the streaming summary")
    index_records(small)
    dev = torch.device("cuda", 0)
    results = []
    for m in (port.make_mesh([dev]), port.make_mesh([dev, dev])):
        full = port.full_check_summary_sharded(small, port.Config(), mesh=m,
                                               k_positions=k)
        require(full.pop("devices") == m.n_local, "devices")
        cbm = port.check_bam_sharded(small, port.Config(), mesh=m)
        require(cbm.pop("devices") == m.n_local, "devices")
        results.append((port.count_reads_sharded(small, port.Config(),
                                                 mesh=m), cbm, full))
    (c1, b1, f1), (c2, b2, f2) = results
    require(c1 == c2 == small_manifest["reads"] and b1 == b2
            and b1["true_positives"] == c1, (c1, c2, b1, b2))
    require(summaries_equal(f1, f2) and summaries_equal(f1, small_summary),
            "two shards of one card differ from one")
    log(f"small BAM: default K = 4096 overflows, the fallback equals the "
        f"streaming summary; [cuda:0, cuda:0] = [cuda:0] for count "
        f"({c1}), check-bam and full-check (K = {k}); "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- long reads: escaped steps patched exactly on the host -----------
    t0 = time.perf_counter()
    lb = work / "long_sharded.bam"
    lm = synth_bam(lb, 2 << 20, seed=9, unit_reads=8,
                   read_len=(60_000, 110_000))
    index_records(lb)
    geo = dict(window_uncompressed=256 << 10, halo=64 << 10)
    cs, bs, fs = {}, {}, {}
    got = port.count_reads_sharded(lb, port.Config(), mesh=mesh,
                                   stats_out=cs, **geo)
    require(got == lm["reads"] and cs["patched_steps"] > 0
            and not cs["fallback"], (got, cs))
    lcb = port.check_bam_sharded(lb, port.Config(), mesh=mesh, stats_out=bs,
                                 **geo)
    require(lcb["true_positives"] == lm["reads"]
            and lcb["false_positives"] == lcb["false_negatives"] == 0
            and bs["patched_steps"] > 0 and not bs["fallback"], (lcb, bs))
    lfull = port.full_check_summary_sharded(lb, port.Config(), mesh=mesh,
                                            stats_out=fs, **geo)
    require(fs["patched_steps"] > 0 and not fs["fallback"], fs)
    lfull.pop("devices")
    lcpu = port.full_check_summary_streaming(
        lb, port.Config(device_inflate=False), device="cpu", **geo)
    require(summaries_equal(lfull, lcpu), "long-read sharded full-check "
                                          "differs from the CPU's")
    log(f"sharded long reads: {got} reads counted and checked exactly "
        f"through {cs['patched_steps']} patched step(s) ({cs['escapes']} "
        f"escapes); full-check equal to the CPU's; "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- two processes ----------------------------------------------------
    t0 = time.perf_counter()
    backends = ["gloo"] + (["nccl"] if cards >= 2 else [])
    for backend in backends:
        outs = _two_process_count(small, work, backend)
        for pid, o in enumerate(outs):
            require(o["process_id"] == pid and o["processes"] == 2
                    and o["backend"] == backend
                    and o["count"] == small_manifest["reads"]
                    and o["chunks"] >= 2 and not o["fallback"]
                    and o["tokenize_demotions"] == 0, o)
        log(f"two processes ({backend}): each counted {outs[0]['count']} in "
            f"{outs[0]['chunks']} all-reduced steps over {outs[0]['rows']} "
            f"rows")
    if cards < 2:
        log("NCCL not run: this machine has one card (two ranks cannot "
            "share one card under NCCL)")
    log(f"two-process runs: {time.perf_counter() - t0:.1f} s")
    return launches


class _RssPeak:
    """Peak resident set size of this process while it is entered, sampled
    from /proc every 10 ms on a thread."""

    def __enter__(self):
        import threading

        self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def _agg_equal(got: dict, want: dict, label: str) -> None:
    require(list(got) == list(want), f"{label}: metrics {list(got)}")
    for k in want:
        require(got[k].dtype == np.int64 and np.array_equal(got[k], want[k]),
                f"{label}: {k} differs")


def agg_phase(port, bam, manifest, small, work, card) -> tuple[dict, dict]:
    """Phase 9, the aggregate; returns its kernel launch counts on the
    1 GiB aggregate and that aggregate's result, wall, host split and peak
    host RSS (phase 10's reference)."""
    from torch.autograd import DeviceType

    from spark_bam_tpu_torch.agg import AggConfig, host_aggregate
    from spark_bam_tpu_torch.agg import kernels as AK
    from spark_bam_tpu_torch.benchmarks import agg_cases, load_cases
    from spark_bam_tpu_torch.load import api, tpu_load
    from spark_bam_tpu_torch.parallel.mesh import mesh_steps
    from spark_bam_tpu_torch.tpu import kernels as K

    want = manifest["reads"]
    dev = torch.device("cuda", 0)
    plan = AggConfig.parse("")
    split: dict = {}
    seen: dict = {}
    names = ("read_header", "flatten_file", "record_starts",
             "parse_flat_records", "_apply_filter", "aggregate_planes")
    real = {n: getattr(api, n) for n in names}

    def timed(name):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            split[name] = split.get(name, 0.0) + time.perf_counter() - t0
            seen[name] = out
            return out
        return run

    for n in names:
        setattr(api, n, timed(n))
    try:
        gc.collect()
        torch.zeros(1, device=dev)   # the allocator's stats exist from here
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            res = port.aggregate(bam)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        peak_dev = torch.cuda.max_memory_allocated(dev)
        host_split = dict(split)
        batch = seen["parse_flat_records"]
        cols = {k: batch.columns[k] for k in AK.PLANES}
        header = seen["read_header"]
        del batch, seen["parse_flat_records"], seen["flatten_file"]
        seen["record_starts"] = None

        # Filtered: a loci and flag filter on the same file.
        loci = "chr1:100000-900000,chr2:500000-1500000"
        split.clear()
        t0 = time.perf_counter()
        filt = port.aggregate(bam, loci=loci, flags_forbidden=0x10)
        filt_s = time.perf_counter() - t0
        filt_split = dict(split)
        seen.clear()
    finally:
        for n in names:
            setattr(api, n, real[n])
    nc = len(header.contig_lengths)
    require(launches["full_check_flags"] > 0, launches)
    count, flagstat = res["metrics"]["count"], res["metrics"]["flagstat"]
    require(res["rows"] == want and count[0] == want and flagstat[0] == want,
            f"aggregate rows {res['rows']}, count {count[0]}, flagstat "
            f"{flagstat[0]}; the generator's {want}")
    require(res["agg"] == plan.canonical() and len(res["contigs"]) == nc,
            res["agg"])
    t0 = time.perf_counter()
    oracle = host_aggregate(cols, plan, nc)
    oracle_s = time.perf_counter() - t0
    _agg_equal(res["metrics"], oracle, "1 GiB aggregate")
    chunks = -(-want // AK.DEFAULT_CHUNK)
    log(f"aggregate 1 GiB ({plan.canonical()}): {want} reads in "
        f"{wall:.3f} s = {want / wall:.0f} reads/s; host split (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in host_split.items())
        + f"; {chunks} reduction windows of {AK.DEFAULT_CHUNK}; "
        f"full_check_flags launches {launches['full_check_flags']} "
        f"(all {launches}); peak host RSS {rss.peak / 2**30:.2f} GiB "
        f"(sampled), peak device memory {peak_dev / 2**30:.2f} GiB; every "
        f"vector = host_aggregate ({oracle_s:.1f} s) ({card})")

    # The reduction per window: CUDA events and PyTorch launches.
    step = AK.update_fn(plan, nc)
    planes = {k: torch.from_numpy(v).to(dev) for k, v in
              AK._pad_planes(cols, 0, AK.DEFAULT_CHUNK, 1).items()}
    state = AK._state_on(plan, nc, dev)
    step_ms = cuda_ms(lambda: step(state, planes), reps=20)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        step(state, planes)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    host_launches = sum(e.count for e in ka
                        if e.key.startswith("cudaLaunchKernel"))
    dev_kernels = sum(e.count for e in ka
                      if getattr(e, "device_type", None) == DeviceType.CUDA)
    in_bytes = sum(v.numel() * v.element_size() for v in planes.values())
    out_bytes = 4 * plan.total_length(nc)
    log(f"aggregate reduction per window of {AK.DEFAULT_CHUNK} records "
        f"(default spec, nc {nc}): {step_ms:.3f} ms (CUDA-event median of "
        f"20); {host_launches} cudaLaunchKernel calls, {dev_kernels} device "
        f"kernels (torch.profiler); bound {in_bytes + out_bytes} bytes = "
        f"{(in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3:.5f} ms ({card})")
    del planes, state

    # The filtered pass against the oracle over the masked columns.
    ivs = tpu_load._interval_table(header, loci)
    masked = dict(cols, valid=cols["valid"]
                  & numpy_filter(cols, ivs, 0, 0x10))
    kept = int(masked["valid"].sum())
    require(0 < kept < want and filt["rows"] == kept, (kept, filt["rows"]))
    _agg_equal(filt["metrics"], host_aggregate(masked, plan, nc),
               "1 GiB aggregate, filtered")
    log(f"aggregate filtered ({loci}, forbid 0x10): {kept} rows in "
        f"{filt_s:.3f} s (" + ", ".join(f"{k} {v:.3f}"
                                        for k, v in filt_split.items())
        + "); every vector = host_aggregate over NumPy-masked columns")

    # The mesh's agg step: every card, and two entries of one card.
    t0 = time.perf_counter()
    one = AK.aggregate_planes(cols, plan, nc, device=dev)
    one_s = time.perf_counter() - t0
    _agg_equal(one, res["metrics"], "aggregate_planes")
    for label, mesh in (("every card", port.make_mesh()),
                        ("two entries of one card",
                         port.make_mesh([dev, dev]))):
        t0 = time.perf_counter()
        got = AK.aggregate_planes(cols, plan, nc, steps=mesh_steps(mesh))
        _agg_equal(got, one, f"agg step on {label}")
        log(f"aggregate agg step on {label} ({mesh.n_local} entries): "
            f"equal to one device; {time.perf_counter() - t0:.3f} s against "
            f"{one_s:.3f} s")
    del cols, masked

    # Card against CPU: the small BAM, the edge corpus under tag filters,
    # and an unmapped BAM with no reference sequences (nc 0).
    t0 = time.perf_counter()
    a = port.aggregate(small)
    b = port.aggregate(small, device="cpu")
    _agg_equal(a["metrics"], b["metrics"], "small BAM")
    require(a["rows"] == b["rows"] > 0, (a["rows"], b["rows"]))
    edges = work / "agg_edges.bam"
    load_cases.write_bam(edges, seed=0)
    w0, h0 = load_cases.GEOMETRY
    cfg = port.Config(window_size=w0, halo_size=h0)
    filters = [dict(tags_required=t) for t in load_cases.TAG_FILTERS]
    filters += [dict(loci=load_cases.LOCI[0], flags_forbidden=0x4,
                     tags_required=("NM",)), {}]
    for kw in filters:
        a = port.aggregate(edges, config=cfg, **kw)
        b = port.aggregate(edges, config=cfg, device="cpu", **kw)
        _agg_equal(a["metrics"], b["metrics"], f"edge corpus {kw}")
        require(a["rows"] == b["rows"], kw)
    unmapped = work / "unmapped.bam"
    n_un = agg_cases.write_unmapped_bam(unmapped, 2000)
    a = port.aggregate(unmapped)
    b = port.aggregate(unmapped, device="cpu")
    _agg_equal(a["metrics"], b["metrics"], "unmapped BAM")
    m = a["metrics"]
    require(a["contigs"] == [] and m["coverage"].shape == (0,)
            and m["count"][:2].tolist() == [n_un, 0]
            and m["flagstat"][3] == n_un, (a["rows"], m["count"]))
    log(f"aggregate card = CPU: the small BAM, the edge corpus under "
        f"{len(filters)} filters ({len(load_cases.TAG_FILTERS)} tag sets), "
        f"an unmapped BAM of {n_un} reads with nc 0 (empty coverage); "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, {"result": res, "wall": wall, "split": host_split,
                      "rss": rss.peak}


class _Spied:
    """Module functions timed (host clock, the card synchronized on both
    sides) while entered: ``split[name]`` sums each one's seconds; a
    generator's items are drawn inside its timing."""

    def __init__(self, split: dict, *targets):
        self.split = split
        self.targets = targets   # (module, name) pairs
        self.real = {}

    def __enter__(self):
        for mod, name in self.targets:
            real = getattr(mod, name)
            self.real[(mod, name)] = real

            def run(*a, _real=real, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*a, **kw)
                if _name == "record_starts_streaming":
                    out = list(out)
                torch.cuda.synchronize()
                self.split[_name] = (self.split.get(_name, 0.0)
                                     + time.perf_counter() - t0)
                return out
            setattr(mod, name, run)
        return self

    def __exit__(self, *exc):
        for (mod, name), real in self.real.items():
            setattr(mod, name, real)


def _report_lines(out) -> list[str]:
    """A compute-splits report without its timing lines."""
    return [ln for ln in out.getvalue().split("\n")
            if not ln.startswith("Get ")]


def split_phase(port, bam, manifest, small, work, card, agg_ref) -> dict:
    """Phase 10, split planning with the ``.sbi`` cache (under a temporary
    ``SPARK_BAM_CACHE_DIR``); returns the kernel launches of its three
    1 GiB paths: the cold ``index --record-starts``, the cold
    ``compute-splits -s`` and the warm aggregate."""
    import io

    from spark_bam_tpu_torch import cli
    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.benchmarks.split_cases import sentinel_split_size
    from spark_bam_tpu_torch.benchmarks.synth import record_flat_starts
    from spark_bam_tpu_torch.bgzf.flat import FlatView, metas_block_table
    from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
    from spark_bam_tpu_torch.load import api, boundary, tpu_load
    from spark_bam_tpu_torch.load.splits import file_splits
    from spark_bam_tpu_torch.sbi import plan as sbi_plan
    from spark_bam_tpu_torch.sbi.format import (
        PLAN_NONE,
        PLAN_POS,
        decode_sbi,
        record_starts_to_flat,
    )
    from spark_bam_tpu_torch.sbi.store import CacheStore, reset_cache_events
    from spark_bam_tpu_torch.tpu import kernels as K

    dev = torch.device("cuda", 0)
    split = port.Config.LOAD_SPLIT_SIZE_DEFAULT
    os.environ["SPARK_BAM_CACHE_DIR"] = str(work / "sbi_cache")
    paths = {}
    try:
        # ---- 1. index -m 32MB --record-starts, cold ----------------------
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launch_counts()
        boundary.STATS.reset()
        split_s: dict = {}
        out = io.StringIO()
        with _Spied(split_s, (cli, "blocks_metadata"),
                    (sbi_plan, "build_split_plan"),
                    (tpu_load, "record_starts_streaming")), \
                _RssPeak() as rss:
            t0 = time.perf_counter()
            dest = cli.index(bam, split, port.Config(), record_starts=True,
                             out=out)
            torch.cuda.synchronize()
            index_s = time.perf_counter() - t0
        paths["index_cold"] = dict(K.LAUNCHES)
        peak_dev = torch.cuda.max_memory_allocated(dev)
        res_ms = list(boundary.STATS.ms)
        st = boundary.STATS
        require(dest == CacheStore.from_env().sidecar_path(bam), dest)
        require(all(paths["index_cold"][k] > 0 for k in COUNT_KERNELS),
                paths["index_cold"])
        require(st.boundary_demotions == 0, st)
        sbi = decode_sbi(open(dest, "rb").read())
        bs, bf = metas_block_table(blocks_metadata(bam))
        table = FlatView(np.empty(0, np.uint8), block_starts=bs,
                         block_flat=bf)
        truth = record_flat_starts(manifest)
        require(np.array_equal(record_starts_to_flat(table,
                                                     sbi.record_starts),
                               truth), "sidecar starts != the manifest's")
        entries = sbi.split_plans[split]
        header = read_header(bam)
        require(entries[0].kind == PLAN_POS and entries[0].pos ==
                header.end_pos, entries[0])
        resolved = [table.flat_of_pos(*e.pos) for e in entries
                    if e.kind == PLAN_POS]
        require(len(resolved) >= len(entries) - 1 and
                np.isin(resolved, truth).all(), "a plan start is no record")
        log(f"index -m 32MB --record-starts, 1 GiB, cold: {index_s:.3f} s = "
            + ", ".join(f"{k} {v:.3f}" for k, v in split_s.items())
            + f" s; {st.resolutions} boundary resolutions, {st.windows} "
            f"check_window calls, {st.boundary_demotions} demotions, ms "
            f"each "
            f"{[round(x, 2) for x in res_ms]} (median "
            f"{statistics.median(res_ms):.2f}); launches "
            f"{paths['index_cold']}; peak host RSS {rss.peak / 2**30:.2f} "
            f"GiB, peak device memory {peak_dev / 2**30:.2f} GiB; sidecar "
            f"{os.path.getsize(dest)} bytes, {len(sbi.record_starts)} starts "
            f"= the manifest's, {len(entries)} plan entries ({card})")
        log("  " + out.getvalue().strip())

        # ---- 2. compute-splits -s -m 32MB, cold (cache off), then warm ---
        reports = []
        for label, cfg in (("cold", port.Config()),
                           ("warm", port.Config(cache="read"))):
            reset_cache_events()
            K.reset_launch_counts()
            boundary.STATS.reset()
            out = io.StringIO()
            t0 = time.perf_counter()
            cli.compute_splits(bam, split, cfg, spark_bam=True, out=out)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            paths[f"compute_splits_{label}"] = dict(K.LAUNCHES)
            reports.append(_report_lines(out))
            log(f"compute-splits -s -m 32MB, 1 GiB, {label}: {wall:.3f} s, "
                f"{boundary.STATS.resolutions} boundary resolutions, "
                f"launches {dict(K.LAUNCHES)}; {reports[-1][0]}")
        warm = paths.pop("compute_splits_warm")
        require(not any(warm.values()) and boundary.STATS.resolutions == 0,
                f"warm compute-splits launched {warm}")
        require(reports[1][0] == "cache: hit (fingerprint ok)", reports[1])
        require(reports[0][1:] == reports[1][1:], "cold and warm splits "
                                                  "differ")

        # ---- 3. the aggregate, warm from step 1 -------------------------
        split_a: dict = {}
        gc.collect()
        K.reset_launch_counts()
        with _Spied(split_a, *((api, n) for n in (
                "flatten_file", "record_starts", "parse_flat_records",
                "aggregate_planes"))), _RssPeak() as rss:
            t0 = time.perf_counter()
            res = port.aggregate(bam, config=port.Config(cache="readwrite"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        paths["aggregate_warm"] = dict(K.LAUNCHES)
        require(not any(paths["aggregate_warm"].values()),
                f"warm aggregate launched {paths['aggregate_warm']}")
        ref = agg_ref["result"]
        require(res["rows"] == ref["rows"] and res["agg"] == ref["agg"],
                (res["rows"], ref["rows"]))
        _agg_equal(res["metrics"], ref["metrics"], "warm aggregate")
        log(f"aggregate 1 GiB warm (.sbi record starts): {wall:.3f} s = "
            + ", ".join(f"{k} {v:.3f}" for k, v in split_a.items())
            + f"; peak host RSS {rss.peak / 2**30:.2f} GiB; phase 9 cold "
            f"{agg_ref['wall']:.3f} s = "
            + ", ".join(f"{k} {v:.3f}" for k, v in agg_ref["split"].items())
            + f", peak host RSS {agg_ref['rss'] / 2**30:.2f} GiB; equal "
            f"vectors, zero launches ({card})")
        del res

        # ---- 4. the small BAM: card against CPU --------------------------
        t0 = time.perf_counter()
        size = 4 << 20
        sentinel = sentinel_split_size(small)
        got = {}
        for d in (None, "cpu"):
            out = io.StringIO()
            cli.compute_splits(small, size, port.Config(), device=d, out=out)
            got[d] = _report_lines(out)
        require(got[None] == got["cpu"], "compute-splits: card and CPU "
                                         "differ")
        header = read_header(small)
        splits = file_splits(small, sentinel)
        plan = sbi_plan.build_split_plan(small, splits, header,
                                         port.Config())
        require(plan == sbi_plan.build_split_plan(
            small, splits, header, port.Config(), device="cpu"), plan)
        require(plan[-1].kind == PLAN_NONE and plan[-1].file_start ==
                sentinel, plan[-1])
        cli.index(small, size, port.Config(), out=io.StringIO())
        st_ = os.stat(small)
        os.utime(small, ns=(st_.st_atime_ns, st_.st_mtime_ns + 10**9))
        reset_cache_events()
        out = io.StringIO()
        cli.compute_splits(small, size, port.Config(cache="readwrite"),
                           spark_bam=True, out=out)
        stale = _report_lines(out)
        cold = io.StringIO()
        cli.compute_splits(small, size, port.Config(), spark_bam=True,
                           device="cpu", out=cold)
        require(stale[0].startswith("cache: invalidated (stale sidecar: "
                                    "file mtime changed); written ("),
                stale[0])
        require(stale[1:] == _report_lines(cold)[1:], "stale recompute")
        log(f"small BAM (seed 8): compute-splits card = CPU at -m {size}; "
            f"the plan card = CPU with a sentinel-only last split (-m "
            f"{sentinel}: {plan[-1]}); a touched sidecar invalidated and "
            f"recomputed "
            f"({stale[0]}); {time.perf_counter() - t0:.1f} s")
    finally:
        os.environ.pop("SPARK_BAM_CACHE_DIR", None)
    return paths


def export_phase(port, bam, manifest, load_cols, small, small_manifest,
                 work, card) -> dict:
    """Phase 11, the columnar export; returns its kernel launch counts on
    the 1 GiB export."""
    import dataclasses

    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.benchmarks.synth import (
        record_flat_starts,
        record_positions,
        synth_bam,
    )
    from spark_bam_tpu_torch.benchmarks.profile_export import timed_export
    from spark_bam_tpu_torch.columnar import export as cex
    from spark_bam_tpu_torch.columnar import from_parser
    from spark_bam_tpu_torch.columnar.config import ColumnarConfig
    from spark_bam_tpu_torch.columnar.native import NativeReader
    from spark_bam_tpu_torch.columnar.schema import FIXED_COLUMNS, VAR_COLUMNS
    from spark_bam_tpu_torch.load import tpu_load
    from spark_bam_tpu_torch.load.tpu_load import stream_ordered_batches
    from spark_bam_tpu_torch.tpu import kernels as K

    out_dir = work / "export"
    out_dir.mkdir(exist_ok=True)
    reads = manifest["reads"]
    flat_starts = record_flat_starts(manifest)
    samples: dict = {}   # file-order row → its var pieces by _var_piece

    def sample(item):
        """Locate a piece's rows in the generator's file order and render
        the sampled ones row by row."""
        abs_starts, batch, _floor = item
        rows = np.flatnonzero(batch.columns["valid"])
        at = np.searchsorted(flat_starts, abs_starts[rows])
        require(np.array_equal(flat_starts[np.minimum(
            at, len(flat_starts) - 1)], abs_starts[rows]),
            "an exported row is not a record start")
        pick = np.flatnonzero((at < 8192) | (at >= reads - 8192)
                              | (at % 997 == 0))
        for k in pick:
            samples[int(at[k])] = tuple(
                from_parser._var_piece(c, batch, int(rows[k]))
                for c in VAR_COLUMNS)

    out = out_dir / "smoke.sbcr"
    K.reset_launch_counts()
    torch.cuda.synchronize()
    with _RssPeak() as rss:
        summary, split = timed_export(bam, out, on_piece=sample)
    launches = dict(K.LAUNCHES)
    wall = split["wall"]
    require(summary["rows"] == reads, f"export rows {summary['rows']}")
    require(summary["batches"] == -(-reads // 8192),
            f"export batches {summary['batches']}")
    require(all(launches[k] > 0 for k in COUNT_KERNELS)
            and launches["full_check_flags"] == 0,
            f"export launches {launches}")
    size = out.stat().st_size
    require(summary["bytes"] == size, (summary["bytes"], size))
    want_samples = len(samples)
    require(want_samples > 2 * 8192, want_samples)

    # Read it back: fixed columns = the load's in file order, pos = the
    # generator's, the sampled var rows = _var_piece's.
    t0 = time.perf_counter()
    got_cols: dict = {c: [] for c in FIXED_COLUMNS}
    row0 = checked = 0
    for b in NativeReader(str(out)).iter_batches():
        for c in FIXED_COLUMNS:
            got_cols[c].append(b.columns[c])
        for i in range(b.num_rows):
            piece = samples.get(row0 + i)
            if piece is not None:
                for c, want in zip(VAR_COLUMNS, piece):
                    require(b.columns[c].value(i) == want,
                            f"row {row0 + i} column {c} differs")
                checked += 1
        row0 += b.num_rows
    require(checked == want_samples and row0 == reads, (checked, row0))
    for c in FIXED_COLUMNS:
        require(np.array_equal(np.concatenate(got_cols[c]), load_cols[c]),
                f"exported {c} differs from the load's")
    require(np.array_equal(np.concatenate(got_cols["pos"]),
                           np.asarray(record_positions(manifest))),
            "exported pos differs from the generator's, in file order")
    del got_cols
    read_s = time.perf_counter() - t0
    log(f"export 1 GiB (native, codec none, all columns): {reads} rows in "
        f"{summary['batches']} batches, {size} bytes, {wall:.3f} s = "
        f"{reads / wall:.0f} reads/s; split: stream (check and parse) "
        f"{split['stream']:.3f} s, render {split['render']:.3f} s, "
        f"dictionary pass {split['dictionary']:.3f} s, encode "
        f"{split['encode']:.3f} s, write {split['write']:.3f} s, order and "
        f"rebatch {split['order_and_rest']:.3f} s (the smoke's row "
        f"sampling, {split['hook']:.3f} s, taken out); peak host RSS "
        f"{rss.peak / 2**30:.2f} GiB; launches {launches} ({card})")
    log(f"export read back: fixed columns = the load's in file order, pos = "
        f"the generator's, {checked} sampled rows' var columns = _var_piece "
        f"(first and last 8,192, every 997th); {read_s:.1f} s")

    for f in out_dir.iterdir():
        f.unlink()

    # Card = CPU on the small BAM and the long reads, every codec, with
    # and without a filter. The CPU side streams each BAM once (host zlib
    # windows, the plain check and parse), filters copies of its pieces on
    # the CPU as stream_ordered_batches does, and encodes each codec.
    def filtered(pieces, header, q):
        out = []
        for abs_starts, batch, floor in pieces:
            cols = dict(batch.columns, valid=batch.columns["valid"].copy())
            copy = dataclasses.replace(batch, columns=cols)
            tpu_load._apply_filter(copy, header, q["loci"], 0,
                                   q["flags_forbidden"], device="cpu")
            out.append((abs_starts, copy, floor))
        return out

    t0 = time.perf_counter()
    # The CPU tests' long-read BAM: 16 reads of 60-110 kb, most of which
    # spill at this geometry (the 8 MiB one's CPU check takes minutes).
    long_bam = work / "long_export.bam"
    long_manifest = synth_bam(long_bam, 2 << 20, seed=9, unit_reads=8,
                              read_len=(60_000, 110_000))
    long_cfg = port.Config(window_size=256 << 10, halo_size=64 << 10)
    query = {"loci": "chr1:1000-2000000,chr2:0-300", "flags_forbidden": 0x10}
    compared = 0
    for label, path, cfg, m in (("small", small, port.Config(),
                                 small_manifest),
                                ("long reads", long_bam, long_cfg,
                                 long_manifest)):
        header = read_header(path)
        contigs = list(zip(header.contig_names,
                           (int(x) for x in header.contig_lengths)))
        unfiltered = list(stream_ordered_batches(
            path, dataclasses.replace(cfg, device_inflate=False),
            device="cpu"))
        for q in ({}, query):
            cpu_pieces = (filtered(unfiltered, header, q) if q
                          else unfiltered)
            for codec in ("none", "zlib", "deflate"):
                spec = f"codec={codec}"
                card_out, cpu_out = out_dir / "card.sbcr", out_dir / "cpu.sbcr"
                got = port.export(path, card_out,
                                  config=dataclasses.replace(cfg,
                                                             columnar=spec),
                                  **q)
                cex.export_dataset(iter(cpu_pieces), cpu_out,
                                   ccfg=ColumnarConfig.parse(spec),
                                   contigs=contigs)
                blob = card_out.read_bytes()
                require(blob == cpu_out.read_bytes(),
                        f"{label} {q} {codec}: card bytes differ from CPU's")
                if not q:
                    require(got["rows"] == m["reads"], (label, got["rows"]))
                    pos = np.concatenate([b.columns["pos"] for b in
                                          NativeReader(blob).iter_batches()])
                    require(np.array_equal(pos,
                                           np.asarray(record_positions(m))),
                            f"{label}: rows not in file order")
                else:
                    require(0 < got["rows"] < m["reads"], (label, got))
                compared += 1
            del cpu_pieces
        del unfiltered
    for f in out_dir.iterdir():
        f.unlink()
    log(f"export card = CPU: small BAM and long reads (256 KiB / 64 KiB, "
        f"rows in file order), codecs none, zlib and deflate, unfiltered "
        f"and {query}: {compared} files equal byte for byte; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def _check_members(blob, blocks, stream, host_member, every: int = 64) -> int:
    """Every member of a writer's output against the stream it packed:
    host zlib inflates it back to its payload (gzip mode checks the CRC
    and ISIZE fields), its ``Metadata`` row matches the bytes written
    (BSIZE, ISIZE, contiguous from 0, the EOF block after the last), and
    every ``every``-th member equals ``host_member(payload)``; returns the
    members held against the host function."""
    import zlib

    from spark_bam_tpu_torch.bam.writer import BGZF_EOF

    mv, src = memoryview(blob), memoryview(stream)
    at = flat = held = 0
    for i, m in enumerate(blocks):
        require(m.start == at, f"member {i} at {m.start}, expected {at}")
        mem = mv[m.start: m.start + m.compressed_size]
        require(mem[16] | mem[17] << 8 == m.compressed_size - 1
                and int.from_bytes(mem[-4:], "little") == m.uncompressed_size,
                f"member {i}: BSIZE/ISIZE differ from its row")
        d = zlib.decompressobj(31)
        payload = src[flat: flat + m.uncompressed_size]
        require(d.decompress(mem) == payload and d.eof
                and not d.unused_data, f"member {i} does not inflate back")
        if i % every == 0:
            require(mem == host_member(bytes(payload)),
                    f"member {i} differs from the host function's")
            held += 1
        at += m.compressed_size
        flat += m.uncompressed_size
    require(flat == len(src), f"members hold {flat} of {len(src)} bytes")
    require(mv[at:] == BGZF_EOF, "no EOF block after the last member")
    return held


def write_phase(port, bam, manifest, small, small_manifest, work,
                card) -> tuple[list, dict]:
    """Phase 12, the write path; returns the kernel rows of
    ``crc32_lanes`` and ``deflate_fixed_lanes`` and the launch counts of
    every kernel on each of its paths."""
    import io
    import zlib

    from spark_bam_tpu_torch import cli
    from spark_bam_tpu_torch.benchmarks.profile_write import (
        graph_ms,
        timed_write,
    )
    from spark_bam_tpu_torch.benchmarks.synth import synth_bam
    from spark_bam_tpu_torch.benchmarks.write_cases import lane_batch
    from spark_bam_tpu_torch.bgzf.flat import inflate_blocks
    from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
    from spark_bam_tpu_torch.compress import codec
    from spark_bam_tpu_torch.compress import kernels as CK
    from spark_bam_tpu_torch.compress.huffman import (
        MAX_STORED_PAYLOAD,
        fixed_member,
        fixed_pack,
        stored_member,
        zlib_member,
        zlib_stream,
    )
    from spark_bam_tpu_torch.core.channel import open_channel
    from spark_bam_tpu_torch.device import sync
    from spark_bam_tpu_torch.load import api, boundary
    from spark_bam_tpu_torch.sbi.store import reset_cache_events
    from spark_bam_tpu_torch.tpu import kernels as K

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    saved_env = {k: os.environ.pop(k, None) for k in (
        "SPARK_BAM_DEFLATE", "SPARK_BAM_CACHE", "SPARK_BAM_CACHE_DIR")}
    paths: dict = {}
    out_dir = work / "write"
    out_dir.mkdir(exist_ok=True)
    try:
        # ---- (a) both kernels against their plain versions, bit for bit --
        t0 = time.perf_counter()
        errs = {"crc32_lanes": 0, "deflate_fixed_lanes": 0}
        case_log = []
        for b in (1, 16, 128):
            payloads = lane_batch(b, seed=b)
            data, lengths, _ = CK.pack_lanes(payloads, pin=True)
            data, lengths = data.to(dev), lengths.to(dev)
            crc = CK.crc32_lanes(data, lengths)
            packed, bits, crc2 = CK.deflate_fixed_lanes(data, lengths)
            want = CK.deflate_fixed_lanes_plain(data, lengths)
            errs["crc32_lanes"] = max(errs["crc32_lanes"],
                                      max_abs_err([(crc, want[2])]))
            errs["deflate_fixed_lanes"] = max(
                errs["deflate_fixed_lanes"],
                max_abs_err(zip((packed, bits, crc2), want)))
            require(not any(errs.values()), f"write lanes differ at B={b}: "
                                            f"{errs}")
            crc_h = crc.cpu().numpy()
            require([int(c) for c in crc_h]
                    == [zlib.crc32(p) & 0xFFFFFFFF for p in payloads],
                    f"CRC differs from zlib's at B={b}")
            if b <= 16:
                host = packed.cpu().numpy()
                for i, p in enumerate(payloads):
                    fp, tb = fixed_pack(p)
                    n = min(len(fp), CK.OUT_BYTES)
                    require(int(bits[i]) == tb
                            and host[i, :n].tobytes() == fp[:n]
                            and not host[i, n:].any(),
                            f"lane {i} of B={b} differs from fixed_pack")
            over = int((bits > CK.OUT_BYTES * 8).sum())
            case_log.append(f"B={b} ({over} overflowing, "
                            f"{int((lengths == 0).sum())} empty)")
        log(f"write lanes: crc32_lanes and deflate_fixed_lanes = their plain "
            f"versions (packed plane, total_bits, CRC) and zlib / fixed_pack "
            f"at {', '.join(case_log)}; {time.perf_counter() - t0:.1f} s")

        # ---- the 1 GiB BAM's uncompressed stream ------------------------
        t0 = time.perf_counter()
        with open_channel(bam) as ch:
            stream = inflate_blocks(ch, blocks_metadata(bam)).data
        log(f"uncompressed stream: {len(stream)} bytes "
            f"({time.perf_counter() - t0:.1f} s)")

        # Kernel times at the writer's shapes: its first 16 and 128 payloads.
        timing = {}
        for b in (16, 128):
            payloads = [stream[i * 65280: (i + 1) * 65280].tobytes()
                        for i in range(b)]
            data, lengths, _ = CK.pack_lanes(payloads, pin=True)
            data, lengths = data.to(dev), lengths.to(dev)
            n_in = int(lengths.sum()) + 4 * b
            calls = {"crc32_lanes": lambda: CK.crc32_lanes(data, lengths),
                     "deflate_fixed_lanes":
                         lambda: CK.deflate_fixed_lanes(data, lengths)}
            timing[b] = {
                "crc_bytes": n_in + 4 * b,
                "fixed_bytes": n_in + b * CK.OUT_BYTES + 8 * b,
                **{k: graph_ms(fn) for k, fn in calls.items()},
                **{"call_" + k: cuda_ms(fn, reps=50)
                   for k, fn in calls.items()},
            }
            if b == 16:
                sync(dev)
                t1 = time.perf_counter()
                CK.crc32_lanes_plain(data, lengths)
                sync(dev)
                crc_plain_ms = (time.perf_counter() - t1) * 1e3
                t1 = time.perf_counter()
                CK.deflate_fixed_lanes_plain(data, lengths)
                sync(dev)
                fixed_plain_ms = (time.perf_counter() - t1) * 1e3
            log(f"write lanes at lanes={b} (the writer's payloads), device "
                f"time a launch (20 in a CUDA graph): crc32_lanes "
                f"{timing[b]['crc32_lanes']:.4f} ms, deflate_fixed_lanes "
                f"{timing[b]['deflate_fixed_lanes']:.4f} ms; one call between "
                f"events (host launch included, median of 50): "
                f"{timing[b]['call_crc32_lanes']:.4f} / "
                f"{timing[b]['call_deflate_fixed_lanes']:.4f} ms ({card})")
        log(f"plain versions on the card at lanes=16: crc32_lanes_plain "
            f"{crc_plain_ms:.1f} ms, deflate_fixed_lanes_plain "
            f"{fixed_plain_ms:.1f} ms")

        # ---- (b) BgzfWriter over the stream, each codec -----------------
        host_of = {"fixed": fixed_member, "stored": stored_member,
                   "off": lambda p: zlib_member(p, 6)}
        for spec in ("mode=fixed", "mode=fixed,lanes=128", "mode=stored",
                     "mode=stored,lanes=128", "mode=off"):
            out = out_dir / "w.bgzf"
            # Host zlib takes ~70 s a GiB: its yardstick runs on the first
            # 256 MiB (the whole GiB: benchmarks/profile_write.py).
            src = stream[: 256 << 20] if spec == "mode=off" else stream
            K.reset_launch_counts()
            r = timed_write(src, spec, out)
            name = "writer_" + spec.replace("mode=", "").replace(",lanes=",
                                                                  "_")
            paths[name] = dict(K.LAUNCHES)
            mode = spec.split(",")[0][5:]
            if mode != "off":
                kernel = ("crc32_lanes" if mode == "stored"
                          else "deflate_fixed_lanes")
                require(paths[name][kernel] == r["dispatches"] > 0,
                        (name, paths[name], r["dispatches"]))
            t1 = time.perf_counter()
            held = _check_members(out.read_bytes(), r["blocks"], src,
                                  host_of[mode])
            check_s = time.perf_counter() - t1
            out.unlink()
            log(f"writer {spec}: {r['members']} members, {r['bytes_in']} -> "
                f"{r['bytes_out']} bytes in {r['wall_s']:.3f} s = "
                f"{r['gb_per_s']:.3f} GB/s of input; split "
                f"{json.dumps(r['split_s'])}; dispatches {r['dispatches']}, "
                f"launches {r['launches']} "
                f"({r['launches_per_dispatch']} a dispatch); picks "
                f"{r['picks']}; every member inflates back with its row, "
                f"{held} equal the host function's ({check_s:.1f} s; {card})")

        # ---- (c) rewrite --deflate mode=fixed -i through cli.py ---------
        big = work / "rewrite_src.bam"
        big_manifest = synth_bam(big, 256 << 20, seed=13)
        for label, src, m in (("small", small, small_manifest),
                              ("256mib", big, big_manifest)):
            outs = {}
            for spec in ("mode=fixed", "mode=fixed,device=off"):
                out = out_dir / f"{label}_{len(outs)}.bam"
                K.reset_launch_counts()
                reset_cache_events()
                buf = io.StringIO()
                t1 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["rewrite", "-i", "--deflate", spec,
                                   str(src), str(out)])
                wall = time.perf_counter() - t1
                require(rc == 0, f"rewrite {label} {spec}: rc {rc}")
                require(buf.getvalue().startswith(
                    f"Wrote {m['reads']} reads to "), buf.getvalue())
                if spec == "mode=fixed":
                    paths[f"rewrite_{label}"] = dict(K.LAUNCHES)
                    require(K.LAUNCHES["deflate_fixed_lanes"] > 0,
                            K.LAUNCHES)
                outs[spec] = (out, wall)
            (a, a_s), (b_, b_s) = outs.values()
            for ext in ("", ".blocks", ".records"):
                require(Path(str(a) + ext).read_bytes()
                        == Path(str(b_) + ext).read_bytes(),
                        f"rewrite {label}{ext}: card differs from device=off")
            K.reset_launch_counts()
            got = port.StreamChecker(a, port.Config()).count_reads()
            paths[f"count_rewritten_{label}"] = dict(K.LAUNCHES)
            require(got == m["reads"], f"rewritten {label}: {got} reads, "
                                       f"manifest {m['reads']}")
            boundary.STATS.reset()
            reset_cache_events()
            K.reset_launch_counts()
            rep = io.StringIO()
            with contextlib.redirect_stdout(rep):
                require(cli.main(["compute-splits", "-s", "--cache", "read",
                                  str(a)]) == 0, "warm compute-splits")
            require("cache: hit (fingerprint ok)" in rep.getvalue()
                    and boundary.STATS.resolutions == 0
                    and not any(K.LAUNCHES.values()),
                    f"warm compute-splits of the rewritten {label}: "
                    f"{boundary.STATS.resolutions} resolutions, "
                    f"{K.LAUNCHES}")
            log(f"rewrite -i --deflate mode=fixed {label} "
                f"({m['uncompressed_bytes']} bytes, {m['reads']} reads): card "
                f"{a_s:.3f} s, device=off {b_s:.3f} s; BAM, .blocks and "
                f".records equal byte for byte; count-reads of the output = "
                f"the manifest's; warm compute-splits 0 resolutions, 0 "
                f"launches; launches {paths[f'rewrite_{label}']} ({card})")
            for ext in ("", ".blocks", ".records", ".sbi"):
                for p in (a, b_):
                    Path(str(p) + ext).unlink(missing_ok=True)
        big.unlink()
        big.with_suffix(".manifest.json").unlink(missing_ok=True)

        # ---- (d) encode_zlib_stream, and the export's deflate codec ----
        rng = np.random.default_rng(12)
        raw = bytearray(rng.integers(32, 127, 64 << 20,
                                     dtype=np.uint8).tobytes())
        w = MAX_STORED_PAYLOAD
        raw[10 * w: 11 * w] = rng.integers(0, 256, w, dtype=np.uint8).tobytes()
        raw = bytes(raw)
        before = dict(codec.ZLIB_STREAM_COUNTS)
        K.reset_launch_counts()
        t1 = time.perf_counter()
        got = codec.encode_zlib_stream(raw, "mode=fixed,device=on")
        dev_s = time.perf_counter() - t1
        paths["encode_zlib_stream"] = dict(K.LAUNCHES)
        t1 = time.perf_counter()
        want = zlib_stream(raw)
        host_s = time.perf_counter() - t1
        repacks = codec.ZLIB_STREAM_COUNTS["repacks"] - before["repacks"]
        require(got == want, "encode_zlib_stream differs from zlib_stream")
        require(repacks == 1, f"{repacks} re-packs, expected 1")
        log(f"encode_zlib_stream mode=fixed,device=on over {len(raw)} bytes "
            f"(one incompressible window): = zlib_stream's "
            f"{len(want)} bytes; {repacks} window re-packed on the host; "
            f"card {dev_s:.3f} s, host {host_s:.3f} s; launches "
            f"{paths['encode_zlib_stream']['deflate_fixed_lanes']}")
        del raw, got, want
        blobs = {}
        for spec in ("mode=fixed", "mode=fixed,device=off"):
            os.environ["SPARK_BAM_DEFLATE"] = spec
            before = dict(codec.ZLIB_STREAM_COUNTS)
            K.reset_launch_counts()
            out = out_dir / "small.sbcr"
            api.export(small, out, config=port.Config(
                columnar="codec=deflate"))
            if spec == "mode=fixed":
                paths["export_deflate_small"] = dict(K.LAUNCHES)
                require(K.LAUNCHES["deflate_fixed_lanes"] > 0, K.LAUNCHES)
                windows = (codec.ZLIB_STREAM_COUNTS["windows"]
                           - before["windows"])
                repacked = (codec.ZLIB_STREAM_COUNTS["repacks"]
                            - before["repacks"])
            blobs[spec] = out.read_bytes()
            out.unlink()
        require(blobs["mode=fixed"] == blobs["mode=fixed,device=off"],
                "export codec=deflate: card differs from device=off")
        log(f"export codec=deflate of the small BAM under SPARK_BAM_DEFLATE="
            f"mode=fixed = device=off byte for byte ({len(blobs['mode=fixed'])}"
            f" bytes; {windows} windows on the card, {repacked} re-packed)")
    finally:
        os.environ.pop("SPARK_BAM_DEFLATE", None)
        for k, v in saved_env.items():
            if v is not None:
                os.environ[k] = v
        shutil.rmtree(out_dir, ignore_errors=True)

    main_paths = [p for p in paths if not p.startswith("count_")]
    rows = []
    for name, line, bytes_key in (("crc32_lanes", 100, "crc_bytes"),
                                  ("deflate_fixed_lanes", 107, "fixed_bytes")):
        rows.append(dict(
            name=name, route="cuda", source="spark_bam_tpu_torch/csrc/deflate.cu",
            replaces=f"spark_bam_tpu/compress/kernels.py:{line}",
            parity="bit-identical", max_abs_err=errs[name],
            ms=timing[16][name], ms_lanes_128=timing[128][name],
            call_ms=timing[16]["call_" + name],
            call_ms_lanes_128=timing[128]["call_" + name],
            plain_ms=crc_plain_ms if name == "crc32_lanes" else fixed_plain_ms,
            bound_ms=timing[16][bytes_key] / HBM_BYTES_PER_S * 1e3,
            bound_ms_lanes_128=timing[128][bytes_key] / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None,
            launches=sum(paths[p][name] for p in main_paths),
        ))
    log(f"phase 12 (write path): {time.perf_counter() - t_phase:.1f} s")
    return rows, paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import spark_bam_tpu_torch as port

    if Path(port.__file__).resolve().parent != ROOT / "spark_bam_tpu_torch":
        raise RuntimeError(f"imported {port.__file__}, not this checkout's")

    from spark_bam_tpu_torch.benchmarks import deflate_cases, prefilter_cases
    from spark_bam_tpu_torch.benchmarks import profile_prefilter as pfp
    from spark_bam_tpu_torch.benchmarks import profile_resolve_flags as prf
    from spark_bam_tpu_torch.benchmarks import replay_cases, resolve_flag_cases
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
        edge_rows = resolve_flag_cases.token_rows(7)
        names = list(edge_rows)
        e_lit, e_dist = (torch.from_numpy(a).to(dev) for a in
                         resolve_flag_cases.stack_rows(edge_rows))
        k_edge, k_edge_r = K.lz77_resolve(e_lit, e_dist)
        p_edge, p_edge_r = K._resolve_body(e_lit, e_dist)
        res_edge_err = max_abs_err([(k_edge, p_edge)])
        donor = e_lit.clone()
        K.lz77_resolve(donor, e_dist, out=donor)
        res_edge_err = max(res_edge_err, max_abs_err([(donor, p_edge)]))
        require(res_edge_err == 0, f"lz77_resolve differs on the edge set: "
                                   f"{res_edge_err}")
        require(int(k_edge_r) <= int(p_edge_r) <= 16, (k_edge_r, p_edge_r))
        edge_rounds = []
        for r, name in enumerate(names):
            _, kr = K.lz77_resolve(e_lit[r:r + 1], e_dist[r:r + 1])
            _, pr = K._resolve_body(e_lit[r:r + 1], e_dist[r:r + 1])
            require(int(kr) <= int(pr), (name, int(kr), int(pr)))
            edge_rounds.append(f"{name} {int(kr)}/{int(pr)}")
        log(f"lz77_resolve edge set: {len(names)} rows, bit-identical out of "
            f"place and in place; rounds kernel/plain: "
            f"{', '.join(edge_rounds)}")
        del e_lit, e_dist, k_edge, p_edge, donor
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
            parity="bit-identical",
            max_abs_err=max(res_err, rle_err, res_edge_err),
            ms=res_ms,
            plain_ms=res_plain_ms, bound_ms=res_bytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None,
        ))

        # ---- prefilter_check_flags (fused flags and compaction): the
        # 32 MiB window at two lengths, random bytes, the overflowing soup
        # and the shared edge set at W = 2^25; each twice back to back on
        # one stream and once on a second stream -------------------------
        n0 = len(flat0)
        padded = torch.zeros(w + K.PAD, dtype=torch.uint8, device=dev)
        padded[:n0] = torch.from_numpy(flat0).to(dev)
        soup = torch.from_numpy(
            rng.integers(0, 256, size=w + K.PAD, dtype=np.uint8)).to(dev)
        n_odd = (n0 // prefilter_cases.TILE) * prefilter_cases.TILE - 3
        pre_cases = {"window": (padded, n0, lens_dev, nc),
                     f"window, n = {n_odd}": (padded, n_odd, lens_dev, nc),
                     "random bytes": (soup, w, lens_dev, nc)}
        edge = prefilter_cases.prefilter_windows(w, seed=7)
        edge["overflow_soup"] = prefilter_cases.overflow_soup(w)
        side = torch.cuda.Stream(dev)
        pre_err = 0
        pre_log = []
        for label in [*pre_cases, *edge]:
            if label in pre_cases:
                buf, n, lt, c = pre_cases[label]
            else:
                b_np, n, l_np, c = edge.pop(label)
                buf, lt = (torch.from_numpy(a).to(dev) for a in (b_np, l_np))
            cap = K.lane_capacity(buf.numel() - K.PAD)
            want = K._prefilter_compact(buf, lt, c, n, cap)
            runs = [K.prefilter_check_flags(buf, lt, c, n) for _ in range(2)]
            sync(dev)
            with torch.cuda.stream(side):
                runs.append(K.prefilter_check_flags(buf, lt, c, n))
            side.synchronize()
            err = max(max_abs_err(zip(got, want)) for got in runs)
            pre_err = max(pre_err, err)
            pre_log.append(f"{label} {int(want[2])}")
            require(err == 0, f"prefilter differs from plain on {label}")
        require(pre_err == 0, f"prefilter differs from plain: {pre_err}")
        pre_ms = cuda_ms(
            lambda: K.prefilter_check_flags(padded, lens_dev, nc, n0), reps=20)
        pre_plain_ms = cuda_ms(lambda: K._prefilter_compact(
            padded, lens_dev, nc, n0, K.lane_capacity(w)), reps=5)
        cap = K.lane_capacity(w)
        pre_bytes = ((w + 35) + 4 * lens_dev.numel() + 4 * w + 4 * cap + 4)
        log(f"prefilter_check_flags: W={w}, capacity {cap}; F, cand and "
            f"n_set bit-identical, each case twice on one stream and once "
            f"on a second; survivors: {', '.join(pre_log)}; kernel "
            f"{pre_ms:.3f} ms, plain {pre_plain_ms:.3f} ms")
        prof_dir = work / "profile"
        prof_dir.mkdir(exist_ok=True)
        pre_prof = pfp.profile_prefilter([], prof_dir, padded, lens_dev, nc,
                                         n0, sm_mhz)
        rows.append(dict(
            name="prefilter_check_flags", route="cuda",
            source="spark_bam_tpu_torch/csrc/prefilter.cu",
            replaces="spark_bam_tpu/tpu/pallas_kernels.py:436",
            parity="bit-identical", max_abs_err=pre_err, ms=pre_ms,
            plain_ms=pre_plain_ms,
            bound_ms=pre_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=pre_prof["compaction"]["nonzero_ms"],
        ))
        del edge
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
        edge_windows = resolve_flag_cases.flag_windows(w, seed=7)
        for label, (buf_np, n) in edge_windows.items():
            buf = torch.from_numpy(buf_np).to(dev)
            err = 0
            for _ in range(2):   # twice: the status records are reused
                got = K.full_check_flags(buf, lens_dev, nc, n)
                want = K._compute_flags(buf, lens_dev, nc, n)
                err = max(err, max_abs_err([(got, want)]))
            full_err = max(full_err, err)
            log(f"full_check_flags edge [{label}]: W={buf.numel() - K.PAD}, "
                f"n={n}, max_abs_err {err}")
        del buf, edge_windows
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
        # Both flag kernels captured in a CUDA graph once and replayed over
        # four windows of different bytes and lengths, on this stream and
        # on a second one, with eager launches between the replays.
        replay_windows = [(padded, n0), (soup, w), (long_pad, long_n),
                          (padded, n_odd)]
        replay_log = []
        for label, stream in (("current", None), ("second", side)):
            rep = replay_cases.replay_flag_kernels(replay_windows, lens_dev,
                                                   nc, stream)
            for name, r in rep.items():
                require(r["replays"] >= 3 and r["max_abs_err"] == 0
                        and r["eager_err"] == 0,
                        f"{name} replayed on the {label} stream: {r}")
                replay_log.append(f"{name} {r['replays']} replays on the "
                                  f"{label} stream")
        log(f"graph replays at W={w}: {', '.join(replay_log)}; every replay "
            f"and every eager launch between them bit-identical to plain")
        # The profile script's split of both kernels on this window, and the
        # rounds each of its rows took (kernel and plain version).
        prf.profile_lz77([], prof_dir, lit, dist, sm_mhz)
        prf.profile_full_flags([], prof_dir, padded, lens_dev, nc, n0, sm_mhz)
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
        count_launches = dict(launches)
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

        resident_launches = resident_phase(
            port, bam, manifest, long_bam, long_manifest, small,
            small_manifest, card, fused_s, classic_s)

        load_launches, off_launches, load_cols = load_phase(
            port, bam, manifest, long_bam, long_manifest, small, work, card)

        sharded_launches = sharded_phase(
            port, bam, manifest, summary, fc_s, fused_s, small,
            small_manifest, on_card, work, card)

        agg_launches, agg_ref = agg_phase(port, bam, manifest, small, work,
                                          card)

        split_launches = split_phase(port, bam, manifest, small, work, card,
                                     agg_ref)
        del agg_ref

        export_launches = export_phase(
            port, bam, manifest, load_cols, small, small_manifest, work,
            card)
        del load_cols

        write_rows, write_launches = write_phase(
            port, bam, manifest, small, small_manifest, work, card)

        for row in rows:
            row["launches"] = launches[row["name"]]
            row["launches_by_path"] = {
                "count_reads": count_launches[row["name"]],
                "full_check": fc_launches[row["name"]],
                "resident": resident_launches[row["name"]],
                "load": load_launches[row["name"]],
                "load_funnel_off_edge_corpus": off_launches[row["name"]],
                **{path: n[row["name"]]
                   for path, n in sharded_launches.items()},
                "aggregate": agg_launches[row["name"]],
                **{path: n[row["name"]]
                   for path, n in split_launches.items()},
                "export": export_launches[row["name"]],
                **{path: n[row["name"]]
                   for path, n in write_launches.items()},
            }
        for row in write_rows:
            row["launches_by_path"] = {path: n[row["name"]]
                                       for path, n in write_launches.items()}
        print(json.dumps({"kernels": rows + write_rows}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
