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
   on host-zlib windows (the plain flag pass): equal summaries.
5. Long reads (60-110 kb) at a 256 KiB window and 64 KiB halo, which the
   chains outrun: both count loops must still be exact (through the escape
   retry), ``full_spans`` must defer, and the card's summary must equal
   the CPU's on a 2 MiB BAM of 16 such reads.
6. The resident count: ``StreamChecker.count_reads_resident`` over the
   1 GiB BAM at the default geometry (host-zlib windows packed four to a
   resident chunk, each chunk one CUDA graph replay of its window bodies):
   the generator's count, its wall beside the fused and classic counts,
   the graphs captured, replays and launches a replay runs, then again
   on the same checker (graphs reused); the long reads exact through the
   escape retry; a 4 MiB BAM of the small BAM's seed counted equally on
   the card and the CPU.
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
   funnel off (``full_check_flags``), equal batches, and equal under
   every filter applied to them on the card and on the CPU, tags
   included; the long reads' exact spills; ``load_reads_columnar``
   and ``record_starts`` on the small BAM, card against CPU (the CPU's
   columns parsed and filtered over its one whole-file check).
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
   NumPy-masked columns, reusing the first run's record starts); the
   mesh's agg step on every card and on a
   two-entry mesh of one card (= one device); card = CPU on the small BAM
   (the CPU's parse and reduction over phase 7's CPU record starts),
   the load edge corpus under tag filters and an unmapped BAM with no
   reference sequences (``benchmarks/agg_cases.py``; empty coverage).

10. Split planning with the ``.sbi`` cache (``split_phase``, under a
   temporary ``SPARK_BAM_CACHE_DIR``): ``index -m 32MB --record-starts``
   on the 1 GiB BAM, cold (the wall split into block scan, boundary
   resolutions on the card with each one's ms, and the streaming starts;
   launches, peak host RSS and device memory; the sidecar's starts = the
   generator's manifest, every resolved plan start a manifest start, the
   first the header's end); ``index -m 8MB`` (the plan alone, merged into
   that sidecar for phase 13); ``compute-splits -s -m 32MB`` cold with the
   cache off, then warm with ``--cache read`` (equal splits, zero launches,
   zero resolutions); the aggregate warm from the sidecar (= phase 9's
   result, zero launches; its wall beside phase 9's); on the small BAM,
   ``compute-splits -s`` card = CPU, the plan card = CPU
   with a sentinel-only last split (``PLAN_NONE``) and a touched sidecar
   invalidated and recomputed (= a cold run on the card). The time per boundary at the reference's
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
   filter (the small BAM: none and deflate unfiltered, zlib filtered).

12. The write path (``write_phase``): ``crc32_lanes`` and
   ``deflate_fixed_lanes`` (``csrc/deflate.cu``) against their plain
   versions on the card, bit for bit (the whole packed plane, total_bits,
   CRC), and against zlib's CRC-32 and ``fixed_pack``, at B = 1, 16 and
   128 over ``benchmarks/write_cases.py`` (lengths 0 to STRIDE, an
   overflowing lane), and their CUDA-event times on the writer's own
   payloads at lanes 16 and 128; ``BgzfWriter`` over the 1 GiB BAM's
   uncompressed stream's first 256 MiB under mode=fixed and mode=stored at
   lanes 16 and 128 and under mode=off
   (host zlib, on its first 64 MiB), timed by
   ``benchmarks/profile_write.py::timed_write`` (staging, H2D, kernel,
   wait, D2H, assembly, write), every member inflated back by host zlib
   against its payload and its row, every 64th equal to the host
   function's; ``rewrite -i --deflate mode=fixed`` through ``cli.py`` on
   the small BAM (equal byte for byte, BAM, ``.blocks`` and ``.records``,
   to ``device=off``) and a 128 MiB one (phase 15's oracle), each output
   counted to the manifest's reads and its warm ``compute-splits``
   resolving nothing;
   ``encode_zlib_stream`` on the card over 64 MiB with one incompressible
   window (= ``zlib_stream``, one re-pack), and the small BAM's export
   with ``codec=deflate`` under ``SPARK_BAM_DEFLATE=mode=fixed`` =
   ``device=off``.

13. The serve daemon (``serve_phase``): ``SplitService`` behind a
   ``ServerThread`` on a unix socket, queried by ``ServeClient``s in
   threads. Service A (``window=24MB,halo=4MB,batch=4,tick=2,workers=4,
   cache=2GB``, the ``.sbi`` cache of phase 10) on the 1 GiB BAM: a
   whole-file ``count`` (= the manifest's, no escape; its wall, ticks,
   device ms a tick by CUDA events, and one row's launches by
   torch.profiler), 16 ``count``s over compressed ranges from 4 clients
   (summing to it), ``plan`` at 32 MiB and 8 MiB warm (= phase 10's plans,
   zero split resolutions), ``record_starts`` warm and ``aggregate`` (=
   phase 9's vectors). Service B (the reference defaults) on the 40 MiB,
   long-read and unmapped BAMs: 8 clients' mixed counts (each = the
   generator's; ticks of more than one row; latency p50 and p99), ``fleet``,
   the long reads' escape to the exact count, ``batch`` over sockets and
   shm = ``export``'s file byte for byte (unfiltered, loci and flags, an
   empty flag filter), ``aggregate`` = ``aggregate``, ``Overloaded`` at
   ``scan_queue=1``, a ``deadline_ms`` shed, ``drain``; its count (of the
   last third), plan, batch and aggregate responses = the same service's
   on a CPU mesh. A count with ``--funnel off`` runs its rows through
   ``full_check_flags``.

14. The serve fabric (``fabric_phase``): (a) ``python -m
   spark_bam_tpu_torch fabric --fabric workers=2,probe=500,stream=1 --serve
   <service A's spec>`` on a unix socket, its two worker processes on the
   card (the ``.sbi`` cache of phase 10): the 1 GiB ``count`` = the
   manifest's, its repeat on the same worker (``stats``), the warm ``plan``
   at 32 MiB = phase 10's with zero split resolutions, a streamed ``batch``
   of the 40 MiB BAM over sockets and over the shm descriptor relay =
   ``export``'s file, then SIGTERM: exit 0, drained. (b) A ``Router`` over
   an in-process worker (its launches counted) and one ``WorkerPool``
   worker on the card: a ``batch`` in flight on the pool worker survives
   its SIGKILL byte-identically (a failover), the worker respawns on its
   port and is reinstated; 8 clients x 3 counts of the 40 MiB BAM through
   the router and directly to the worker (latency p50/p99, the router's
   added latency, counts a second). (c) A seeded chaos run
   (``drop``, ``dup``, ``delay``, ``trunc`` at the links, ``shm_crc`` on the
   in-process worker's ring) over that fleet: every count = the
   generator's, every streamed batch = ``export``'s, none lost, the retry
   budget's spend within its bound.

15. The durable job plane (``jobs_phase``), its oracles phase 11's
   container and phase 12's rewrites (no clean job of its own): (a)
   ``python -m spark_bam_tpu_torch export --durable --jobs
   dir=...,frames=1`` of the 40 MiB BAM in a subprocess, stopped and
   SIGKILLed once its journal holds two checkpoints, then the same command
   in-process through ``cli.main``: it resumes, and its ``.sbcr`` = phase
   11's card export of that BAM byte for byte (its wall beside phase 11's, the journal's appends,
   checkpointed bytes a second, redone bytes). (b) Two ``WorkerPool``
   workers on the card sharing a jobs dir (``SPARK_BAM_JOBS``) behind an
   in-process ``Router``: ``submit job=transcode deflate=mode=fixed`` of
   the 40 MiB BAM, its owner stopped and SIGKILLed after its first
   checkpoint, the watchdog's rescue on the survivor (``job_rescues`` 1,
   the time from the kill to done): the BAM, ``.blocks`` and ``.records``
   = phase 12's ``rewrite -i`` byte for byte, redone bytes ≤ two
   segments, a warm ``compute-splits`` resolving nothing, ``scrub
   --source`` clean (its rate). (c) An in-process worker (service A's
   spec): an export job of the 40 MiB BAM = ``export``'s file, with the
   peak device memory while it ran; a ``mode=fixed`` rewrite job of the
   128 MiB BAM paused by a seeded ENOSPC mid-run (the alert in the flight
   record), resubmitted without chaos: = phase 12's output.

16. The host DEFLATE tokenizer (``host_tokenize_phase``, ``inflate
   tokenize=host``): (a) ``native/tokenize.cpp`` built by g++ (its build
   seconds); (b) on the first window's rows the host planes, ``out_lens``
   and verdicts = the ``tokenize`` kernel's, and on 48 rows (32 seeded
   byte-mutants) the same refusals and first refused index; host tokenize
   + pack ms on every thread and on one beside the kernel's ms, the packed
   (pinned) and raw (pageable) copies' bytes and ms, ``lz77_resolve`` on
   the packed planes (``benchmarks/profile_tokenize.py::
   host_device_split``); (c) ``count_reads`` of the 1 GiB BAM under
   ``tokenize=host`` = the generator's, no demotion, no ``tokenize``
   launch, one ``lz77_resolve`` a window, its wall beside phase 3's; (d)
   the 40 MiB BAM: ``inflate_file_device`` (both routes) = ``flatten_file``,
   the full-check summary = phase 4's card and CPU summaries, the load's
   batches and the sharded count = the device route's; (e) the export of
   a refused record mid-file (``load_cases.write_refused_mid_bam``): 601
   rows in the writer's order, card = CPU byte for byte.

17. The record path and the reference's check commands
   (``record_phase``), on the 40 MiB BAM at 2 MiB splits: ``count-reads``
   (``load_bam``, every strict split start resolved on the card by
   ``prefilter_check_flags`` windows, against hadoop-bam's count: ``Read
   counts matched``; its wall split into the split resolution and the
   host record decode); ``load_splits_and_reads`` card = CPU;
   ``check-bam`` default and ``-s`` against the ``.records`` sidecar, the
   eager verdict from ``full_check_flags`` windows (its time beside the
   seqdoop verdict's on the host) = phase 7's CPU plain run's starts and a
   CPU plain check of the first MiB at every exact position;
   ``check-blocks``; ``time-load`` and ``compare-splits`` on a 4 MiB BAM
   of the same seed (with the refused record's BAM); ``index-bam`` of a
   sorted BAM and ``load_bam_intervals`` = a brute-force overlap; and
   ``count-reads`` of the refused record's BAM: 601. Every card launch of
   the two flag kernels there is held against its plain version on the
   same inputs.

Launch counters are set to 0 just before each main path (3, 4, 6, 7, 8,
9, 10, 11, 12, 13, 14, 15, 16, 17) and read just after; a graph replay counts the launches captured in it. Prints one JSON line per kernel set (``{"kernels": [...]}``)
and, last, the device line ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without CUDA, or without the package beside
it, it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import gc
import io
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
#: The kernels that phase 14's fabric paths launch.
FABRIC_KERNELS = ("prefilter_check_flags", "full_check_flags")
#: Beside those kernels' rows: which of phase 14's launches the counters see.
FABRIC_NOTE = ("fabric paths count the in-process worker's launches; the "
               "fabric command's and the pool's worker processes launch in "
               "their own processes, which these counters do not see")
FULL_CHECK_KERNELS = ("tokenize", "lz77_resolve", "full_check_flags")
#: Beside every kernel's row: which of phase 15's launches the counters see.
JOBS_NOTE = ("jobs paths count this process's jobs: the resumed durable "
             "export, the in-process worker's export job and its paused "
             "then resumed rewrite; the rescued transcode runs in worker "
             "processes the counters do not see")


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
    from spark_bam_tpu_torch.benchmarks.synth import synth_bam
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
    # Card = CPU on a 4 MiB BAM of the small BAM's seed (its 40 MiB CPU
    # count was a depth cut, PERF.md §4).
    mid = Path(small).with_name("resident_mid.bam")
    mid_manifest = synth_bam(mid, 4 << 20, seed=8)
    on_card = port.StreamChecker(mid, port.Config()).count_reads_resident()
    on_cpu = port.StreamChecker(mid, port.Config(),
                                device="cpu").count_reads_resident()
    require(on_card == on_cpu == mid_manifest["reads"],
            f"4 MiB BAM resident count card {on_card}, CPU {on_cpu}")
    mid.unlink()
    log(f"resident long reads: {got} reads exact through one escape retry; "
        f"4 MiB BAM: card = CPU = {on_cpu}; {time.perf_counter() - t0:.1f} s")
    del checker, runner, lc
    torch.cuda.empty_cache()
    return launches


def load_phase(port, bam, manifest, long_bam, long_manifest, small, work,
               card) -> dict:
    """Phase 7, the load path; returns its kernel launch counts on the
    1 GiB load and on the edge corpus's funnel-off load, and the 1 GiB
    load's fixed columns in file order (phase 11's reference)."""
    import weakref

    from spark_bam_tpu_torch.bam.header import read_header
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

    # The edge corpus: card, CPU and funnel off, then every filter on the
    # card and on the CPU over those batches (``_apply_filter``, the
    # filter ``stream_read_batches`` runs on each window's batch; one
    # stream a side instead of one a filter is a depth cut, PERF.md §4).
    edges = work / "edges.bam"
    em = load_cases.write_bam(edges, seed=0)
    w0, h0 = load_cases.GEOMETRY
    cfg = port.Config(window_size=w0, halo_size=h0)
    off = port.Config(window_size=w0, halo_size=h0, funnel="off")
    t0 = time.perf_counter()
    all_card = list(port.stream_read_batches(edges, cfg))
    all_cpu = list(port.stream_read_batches(edges, cfg, device="cpu"))
    batches_equal(all_card, all_cpu, "edges unfiltered")
    before = dict(K.LAUNCHES)
    funnel_off = list(port.stream_read_batches(edges, off))
    off_launches = {k: v - before[k] for k, v in K.LAUNCHES.items()}
    batches_equal(funnel_off, all_card, "edges funnel off")
    spilled = sum(len(b) for base, b in all_card if base == -1)
    found = sum(len(b) for _, b in all_card)
    require(spilled >= load_cases.LONG_READS, spilled)
    require(found == em["records"] - len(em["refused"]),
            (found, em["records"]))
    edge_header = read_header(edges)

    def filtered(batches, dev_, loci, fr, ff):
        out = []
        for base, b in batches:
            b = parser.ReadBatch(dict(b.columns), b.starts, b.buf)
            out.append((base, tpu_load._apply_filter(
                b, edge_header, loci, fr, ff, device=dev_)))
        return out

    for loci in (None,) + load_cases.LOCI:
        for fr, ff in ((0, 0),) + load_cases.FLAG_FILTERS:
            on_card = filtered(all_card, dev, loci, fr, ff)
            on_cpu = filtered(all_cpu, "cpu", loci, fr, ff)
            label = f"edges {loci} {fr:#x}/{ff:#x}"
            batches_equal(on_card, on_cpu, label)
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
    # The CPU side checks the whole file once: its columns are the plain
    # parse and filters over those starts, as load_reads_columnar's (the
    # two other CPU whole-file checks were a depth cut, PERF.md §4).
    from spark_bam_tpu_torch.load.tpu_load import _apply_filter
    from spark_bam_tpu_torch.tpu.parser import parse_flat_records

    t0 = time.perf_counter()
    rs_card = port.record_starts(small)
    rs_cpu = port.record_starts(small, device="cpu")
    require((rs_card.starts == rs_cpu.starts).all()
            and len(rs_card.starts) == len(rs_cpu.starts), "record_starts")
    cpu_cols = parse_flat_records(rs_cpu.view.data, rs_cpu.starts,
                                  device="cpu")
    for kw in ({}, {"loci": "chr1:0-1000000", "flags_forbidden": 0x400}):
        a = port.load_reads_columnar(small, **kw)
        b = cpu_cols if not kw else _apply_filter(
            cpu_cols, rs_cpu.header, kw["loci"], 0, kw["flags_forbidden"],
            device="cpu")
        batches_equal([(0, a)], [(0, b)], f"load_reads_columnar {kw}")
    log(f"load whole file: record_starts ({len(rs_card.starts)} starts) and "
        f"load_reads_columnar equal on card and CPU (the CPU's columns from "
        f"its one whole-file check); {time.perf_counter() - t0:.1f} s")
    load_cols = {c: np.concatenate(v) for c, v in parts.items()}
    return load_launches, off_launches, load_cols, rs_cpu.starts


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


def agg_phase(port, bam, manifest, small, work, card,
              small_starts) -> tuple[dict, dict]:
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
        first_starts, seen["record_starts"] = seen["record_starts"], None

        # Filtered: a loci and flag filter on the same file. Its parse,
        # filters and reduction run again; the whole-file check does not
        # (it reuses the starts above: a depth cut, PERF.md §4).
        loci = "chr1:100000-900000,chr2:500000-1500000"
        split.clear()
        real_starts = real["record_starts"]
        real["record_starts"] = lambda *a, **kw: first_starts
        try:
            t0 = time.perf_counter()
            filt = port.aggregate(bam, loci=loci, flags_forbidden=0x10)
            filt_s = time.perf_counter() - t0
        finally:
            real["record_starts"] = real_starts
        del first_starts
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
        + "; record_starts reused from the unfiltered run); every vector = "
        "host_aggregate over NumPy-masked columns")

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
    # and an unmapped BAM with no reference sequences (nc 0). The small
    # BAM's CPU side parses and reduces over phase 7's CPU record starts
    # (its own whole-file CPU check was a depth cut, PERF.md §4; phase 7
    # holds those starts = the card's).
    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.bgzf.flat import flatten_file
    from spark_bam_tpu_torch.tpu.parser import parse_flat_records

    t0 = time.perf_counter()
    a = port.aggregate(small)
    cpu_batch = parse_flat_records(flatten_file(small).data, small_starts,
                                   device="cpu")
    b_metrics = AK.aggregate_planes(
        cpu_batch.columns, AggConfig.parse(""),
        len(read_header(small).contig_lengths), device="cpu")
    _agg_equal(a["metrics"], b_metrics, "small BAM")
    require(a["rows"] == int(cpu_batch.columns["valid"].sum()) > 0,
            a["rows"])
    del cpu_batch
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
    ``SPARK_BAM_CACHE_DIR``); returns the kernel launches of its four
    1 GiB paths: the cold ``index --record-starts``, the cold ``index -m
    8MB``, the cold ``compute-splits -s`` and the warm aggregate."""
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

        # ---- 1b. index -m 8MB (the plan alone), merged into the sidecar:
        # phase 13 serves both plans warm from it (8 MiB, not the
        # reference's 2 MiB check-path split: 81 boundaries, not 324, keep
        # the smoke inside its limit; profile_splits.py times 2 MiB) -----
        K.reset_launch_counts()
        boundary.STATS.reset()
        out = io.StringIO()
        t0 = time.perf_counter()
        cli.index(bam, 8 << 20, port.Config(), out=out)
        torch.cuda.synchronize()
        index2_s = time.perf_counter() - t0
        paths["index_8mb_cold"] = dict(K.LAUNCHES)
        sbi2 = decode_sbi(open(dest, "rb").read())
        entries2 = sbi2.split_plans[8 << 20]
        require(split in sbi2.split_plans and np.array_equal(
            sbi2.record_starts, sbi.record_starts), "merge lost a section")
        resolved2 = [table.flat_of_pos(*e.pos) for e in entries2
                     if e.kind == PLAN_POS]
        require(len(resolved2) >= len(entries2) - 1 and
                np.isin(resolved2, truth).all(), "an 8 MiB plan start is no "
                                                 "record")
        log(f"index -m 8MB, 1 GiB, cold: {index2_s:.3f} s, "
            f"{boundary.STATS.resolutions} boundary resolutions (median "
            f"{statistics.median(boundary.STATS.ms):.2f} ms); launches "
            f"{paths['index_8mb_cold']}; every resolved start a manifest "
            f"start ({card})")
        del sbi2, entries2, resolved2

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
        # spark-bam's splits (-s): the hadoop-bam leg is host code, the
        # same on either device (its two runs here were a depth cut,
        # PERF.md §4; phase 17 runs it).
        for d in (None, "cpu"):
            out = io.StringIO()
            cli.compute_splits(small, size, port.Config(), spark_bam=True,
                               device=d, out=out)
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
        # The stale recompute against a cold run without the cache, on the
        # card (the CPU's cold run was a depth cut, PERF.md §4: the card =
        # CPU line above holds the card's splits).
        cold = io.StringIO()
        cli.compute_splits(small, size, port.Config(), spark_bam=True,
                           out=cold)
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
                 work, card, keep: dict) -> dict:
    """Phase 11, the columnar export; returns its kernel launch counts on
    the 1 GiB export, and leaves the small BAM's default container and its
    wall in ``keep`` (phase 15's oracle)."""
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
            # The small BAM takes each codec once (all three under both
            # queries was a depth cut, PERF.md §4); the long reads all.
            codecs = (("none", "zlib", "deflate") if label != "small" else
                      ("zlib",) if q else ("none", "deflate"))
            for codec in codecs:
                spec = f"codec={codec}"
                card_out, cpu_out = out_dir / "card.sbcr", out_dir / "cpu.sbcr"
                t1 = time.perf_counter()
                got = port.export(path, card_out,
                                  config=dataclasses.replace(cfg,
                                                             columnar=spec),
                                  **q)
                if label == "small" and not q and codec == "none":
                    # Phase 15 (a)'s oracle: the default container.
                    keep["export_small_wall"] = time.perf_counter() - t1
                    keep["export_small_sbcr"] = work / "keep" / "small.sbcr"
                    shutil.copyfile(card_out, keep["export_small_sbcr"])
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
                card, keep: dict) -> tuple[list, dict]:
    """Phase 12, the write path; returns the kernel rows of
    ``crc32_lanes`` and ``deflate_fixed_lanes`` and the launch counts of
    every kernel on each of its paths. Leaves in ``keep`` (phase 15's
    oracles) the card's ``rewrite -i`` outputs of the small and 128 MiB
    BAMs with their sidecars, and the 128 MiB source."""
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
            # 64 MiB (the whole GiB: benchmarks/profile_write.py); the
            # card's writers on the first 256 MiB (depth cuts, PERF.md §4).
            src = stream[: 64 << 20] if spec == "mode=off" else stream[
                : 256 << 20]
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
        big_manifest = synth_bam(big, 128 << 20, seed=13)
        # The 128 MiB BAM is rewritten on the card only: phase 15's paused
        # and resumed job must equal it (its device=off leg was a depth
        # cut, PERF.md §4); the small BAM holds card = device=off.
        for label, src, m in (("small", small, small_manifest),
                              ("128mib", big, big_manifest)):
            outs = {}
            specs = (("mode=fixed", "mode=fixed,device=off")
                     if label == "small" else ("mode=fixed",))
            for spec in specs:
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
            (a, a_s), *off = outs.values()
            b_, b_s = off[0] if off else (None, None)
            for ext in ("", ".blocks", ".records") if off else ():
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
            keep[f"rewrite_{label}"] = a.rename(work / "keep" / a.name)
            for ext in (".blocks", ".records"):
                Path(str(a) + ext).rename(str(keep[f"rewrite_{label}"]) + ext)
            vs_off = (f"device=off {b_s:.3f} s; BAM, .blocks and .records "
                      f"equal byte for byte" if off else "no device=off leg")
            log(f"rewrite -i --deflate mode=fixed {label} "
                f"({m['uncompressed_bytes']} bytes, {m['reads']} reads): card "
                f"{a_s:.3f} s, {vs_off}; count-reads of the output = "
                f"the manifest's; warm compute-splits 0 resolutions, 0 "
                f"launches; launches {paths[f'rewrite_{label}']} ({card})")
            for ext in ("", ".blocks", ".records", ".sbi"):
                for p in (a, b_) if off else (a,):
                    Path(str(p) + ext).unlink(missing_ok=True)
        keep["rewrite_src"] = big.rename(work / "keep" / big.name)
        keep["rewrite_src_manifest"] = big_manifest
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


def _served(resp: dict) -> bytes:
    """A response as the wire encodes it, without its id, transport and
    timing fields, with its frames appended."""
    from spark_bam_tpu_torch.serve import encode

    frames = b"".join(bytes(f) for f in resp.get("_binary") or ())
    keep = {k: v for k, v in resp.items()
            if k not in ("id", "_binary", "_transport", "devices",
                         "latency_p50_ms", "latency_p99_ms")}
    return encode(keep) + frames


def _range_truth(path, starts: np.ndarray, header_end: int, lo_c: int,
                 hi_c: int) -> int:
    """Records whose flat start lies in the blocks whose compressed starts
    fall in [lo_c, hi_c): the generator's count for a serve range."""
    from spark_bam_tpu_torch.bgzf.flat import metas_block_table
    from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata

    bs, bf = metas_block_table(blocks_metadata(path))
    end = np.iinfo(np.int64).max   # past any flat offset
    i, j = np.searchsorted(bs, [lo_c, hi_c], side="left")
    lo = max(header_end, int(bf[i]) if i < len(bf) else end)
    hi = int(bf[j]) if j < len(bf) else end
    return int(np.count_nonzero((starts >= lo) & (starts < max(lo, hi))))


def _row_cost(svc, path: str) -> tuple[int, int, float]:
    """One row of a service's serve step (the file's first window) on the
    main thread: ``cudaLaunchKernel`` calls and device kernels
    (torch.profiler) and its card time (CUDA events)."""
    from torch.autograd import DeviceType

    dev = svc.device
    fs = svc.file_state(path)
    step = svc.steps.serve_step(reads_to_check=10, funnel=True)
    n = min(svc.serve_cfg.window, fs.flat.size)
    row = torch.zeros((1, svc.batcher.width), dtype=torch.uint8, device=dev)
    row[0, :n] = torch.from_numpy(fs.flat.data[:n]).to(dev)
    cols = ([n], [n == fs.flat.size], [fs.header_end],
            [n - svc.serve_cfg.halo], fs.lengths[None, :], [fs.nc])

    def one_row():
        return step([row], *cols)

    one_row()
    row_ms = cuda_ms(one_row, reps=5)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        one_row()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    host_launches = sum(e.count for e in ka
                        if e.key.startswith("cudaLaunchKernel"))
    dev_kernels = sum(e.count for e in ka
                      if getattr(e, "device_type", None) == DeviceType.CUDA)
    return host_launches, dev_kernels, row_ms


def serve_phase(port, bam, manifest, small, small_manifest, long_bam,
                long_manifest, work, card, agg_ref) -> dict:
    """Phase 13, the serve daemon on the card; returns the kernel launches
    of its three paths: service A on the 1 GiB BAM, service B on the small
    BAMs, and a count with the funnel off."""
    from concurrent.futures import ThreadPoolExecutor

    from spark_bam_tpu_torch import obs
    from spark_bam_tpu_torch.agg.plan import AggConfig, encode_result
    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.benchmarks import agg_cases
    from spark_bam_tpu_torch.benchmarks.synth import record_flat_starts
    from spark_bam_tpu_torch.parallel.mesh import local_mesh
    from spark_bam_tpu_torch.sbi.format import PLAN_NONE, PLAN_POS, decode_sbi
    from spark_bam_tpu_torch.sbi.store import CacheStore
    from spark_bam_tpu_torch.serve import (
        ServeClient,
        ServeClientError,
        ServerThread,
        SplitService,
    )
    from spark_bam_tpu_torch.tpu import kernels as K

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    paths: dict = {}
    want = manifest["reads"]
    os.environ["SPARK_BAM_CACHE_DIR"] = str(work / "sbi_cache")
    reg = obs.configure()
    try:
        # ---- service A: the 1 GiB BAM, warm from phase 10's sidecar -----
        sidecar = decode_sbi(open(CacheStore.from_env().sidecar_path(bam),
                                  "rb").read())
        plans = {size: sidecar.split_plans[size]
                 for size in (32 << 20, 8 << 20)}
        spec_a = "window=24MB,halo=4MB,batch=4,tick=2,workers=4,cache=2GB"
        svc = SplitService(port.Config(serve=spec_a, cache="readwrite"))
        require(svc.mesh.devices[0] == dev, svc.mesh)
        tick_ms: list = []
        real_step = svc.batcher._step

        def timed_step(*a):
            stream = torch.cuda.current_stream(dev)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record(stream)
            out = real_step(*a)
            e.record(stream)
            e.synchronize()
            tick_ms.append(s.elapsed_time(e))
            return out

        svc.batcher._step = timed_step
        try:
            # Relative: a socket path holds at most 107 bytes.
            sock_a = os.path.relpath(work / "serve_a.sock")
            with ServerThread(svc, f"unix:{sock_a}") as srv, \
                    ServeClient(srv.address) as c:
                K.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                first = c.request("count", path=str(bam))
                cold_s = time.perf_counter() - t0
                n_ticks = sum(svc.batcher.batch_sizes.values())
                rows_a = sum(k * v for k, v in svc.batcher.batch_sizes.items())
                ticks_first = list(tick_ms)
                t0 = time.perf_counter()
                again = c.request("count", path=str(bam))
                warm_s = time.perf_counter() - t0
                require(first["count"] == want and first["escaped"] == 0
                        and not first["exact_fallback"], first)
                require(_served(again) == _served(first), again)
                size = os.path.getsize(bam)
                edges = [size * k // 16 for k in range(17)]

                def ranged(k):
                    with ServeClient(srv.address) as ck:
                        return ck.request("count", path=str(bam),
                                          start=edges[k], end=edges[k + 1])

                t0 = time.perf_counter()
                with ThreadPoolExecutor(4) as ex:
                    parts = list(ex.map(ranged, range(16)))
                ranges_s = time.perf_counter() - t0
                require(sum(p["count"] for p in parts) == want
                        and not any(p["escaped"] for p in parts),
                        [p["count"] for p in parts])
                res0 = reg.counter("load.split_resolutions").value
                plan_s = {}
                for split_size, entries in plans.items():
                    t0 = time.perf_counter()
                    resp = c.request("plan", path=str(bam),
                                     split_size=split_size)
                    plan_s[split_size] = time.perf_counter() - t0
                    got = [(s["start"], s["pos"]) for s in resp["splits"]]
                    exp = [(e.file_start,
                            [e.pos.block_pos, e.pos.offset]
                            if e.kind == PLAN_POS else None)
                           for e in entries]
                    require(all(e.kind in (PLAN_POS, PLAN_NONE)
                                for e in entries), "unresolved plan entry")
                    require(got == exp, f"plan at {split_size} != phase 10's")
                stats = c.request("stats")
                require(stats["split_resolutions"] == res0 == 0,
                        f"warm plans resolved {stats['split_resolutions']}")
                t0 = time.perf_counter()
                rs = c.request("record_starts", path=str(bam), limit=3)
                rs_s = time.perf_counter() - t0
                hdr = read_header(bam)
                require(rs["count"] == want and rs["vpos"][0] ==
                        hdr.end_pos.to_htsjdk(), rs)
                t0 = time.perf_counter()
                agg = c.request("aggregate", path=str(bam))
                agg_s = time.perf_counter() - t0
                ref = agg_ref["result"]
                meta, payload = encode_result(
                    AggConfig.parse(""), len(ref["contigs"]), ref["contigs"],
                    ref["metrics"])
                require(agg["rows"] == want and agg["result"] == meta
                        and b"".join(agg["_binary"]) == payload,
                        "aggregate over serve != phase 9's vectors")
                stats = c.request("stats")
            paths["serve_a"] = dict(K.LAUNCHES)
            require(paths["serve_a"]["prefilter_check_flags"] >= rows_a
                    and paths["serve_a"]["full_check_flags"] == 0,
                    paths["serve_a"])
            host_launches, dev_kernels, row_ms = _row_cost(svc, str(bam))
        finally:
            svc.close()
        hist = {h["name"]: h for h in reg.snapshot()["hists"]}
        host_tick = hist["serve.tick.ms"]["values"][:n_ticks]
        log(f"serve A ({spec_a}, the 1 GiB BAM, warm .sbi): whole-file count "
            f"{first['count']} in {cold_s:.3f} s with the first touch "
            f"(flatten), {warm_s:.3f} s warm = {want / warm_s:.0f} reads/s; "
            f"{n_ticks} ticks of {rows_a} rows (batch sizes "
            f"{stats['batch_sizes']}); device ms a tick (CUDA events) median "
            f"{statistics.median(ticks_first):.2f} max "
            f"{max(ticks_first):.2f}; host ms a tick (upload included) median "
            f"{statistics.median(host_tick):.2f}; one row: {host_launches} "
            f"cudaLaunchKernel calls, {dev_kernels} device kernels, "
            f"{row_ms:.2f} ms (CUDA events); 16 range counts by 4 clients "
            f"sum to the manifest's in {ranges_s:.3f} s; plans warm at 32 MiB "
            f"({len(plans[32 << 20])} splits, {plan_s[32 << 20]:.3f} s) and "
            f"8 MiB ({len(plans[8 << 20])}, {plan_s[8 << 20]:.3f} s) = phase "
            f"10's with {stats['split_resolutions']} split resolutions; "
            f"record_starts {rs['count']} warm in {rs_s:.3f} s; aggregate = "
            f"phase 9's vectors in {agg_s:.3f} s; count rows_per_s "
            f"{stats['ops']['count']['rows_per_s']}; launches "
            f"{paths['serve_a']} ({card})")

        # ---- service B: the reference defaults, the small BAMs -----------
        unmapped = work / "serve_unmapped.bam"
        n_unmapped = agg_cases.write_unmapped_bam(unmapped, 2000)
        files = {"small": str(small), "long": str(long_bam),
                 "unmapped": str(unmapped)}
        exports = {}
        loci = "chr2:1-800000"
        for label, kw in (("all", {}),
                          (f"{loci}, forbid 0x10",
                           {"loci": loci, "flags_forbidden": 0x10}),
                          ("require 0x1", {"flags_required": 0x1})):
            out = work / f"serve_export_{len(exports)}.sbcr"
            summary = port.export(small, out, **kw)
            serve_kw = dict(kw)
            if "loci" in serve_kw:
                serve_kw["intervals"] = serve_kw.pop("loci")
            exports[label] = (serve_kw, out.read_bytes(), summary["rows"])
            out.unlink()
        require(0 < exports[f"{loci}, forbid 0x10"][2] <
                small_manifest["reads"] == exports["all"][2]
                and exports["require 0x1"][2] == 0,
                {k: v[2] for k, v in exports.items()})
        one_shot = port.aggregate(small)
        truth = record_flat_starts(small_manifest)
        header_end = read_header(small).uncompressed_size
        small_size = os.path.getsize(small)
        svc_b = SplitService(port.Config())
        svc_cpu = SplitService(port.Config(), mesh=local_mesh(["cpu"]))
        sock_b = os.path.relpath(work / "serve_b.sock")
        try:
            K.reset_launch_counts()
            with ServerThread(svc_b, f"unix:{sock_b}") as srv:

                def client(i):
                    rng = np.random.default_rng(100 + i)
                    lat, bad = [], []
                    with ServeClient(srv.address) as ci:
                        for j in range(3):
                            if j == 0:
                                lo, hi = 0, small_size
                                req = {}
                            else:
                                lo = int(rng.integers(0, small_size))
                                hi = lo + small_size // 8
                                req = {"start": lo, "end": hi}
                            t0 = time.perf_counter()
                            r = ci.request("count", path=files["small"], **req)
                            lat.append((time.perf_counter() - t0) * 1e3)
                            exp = _range_truth(small, truth, header_end, lo, hi)
                            if r["count"] != exp:
                                bad.append((lo, hi, r["count"], exp))
                    return lat, bad

                t0 = time.perf_counter()
                with ThreadPoolExecutor(8) as ex:
                    res = list(ex.map(client, range(8)))
                clients_s = time.perf_counter() - t0
                lat = sorted(x for r in res for x in r[0])
                require(not any(r[1] for r in res), [r[1] for r in res])
                sizes = svc_b.batcher.batch_sizes
                require(any(k > 1 for k in sizes), f"no coalesced tick: {sizes}")
                with ServeClient(srv.address) as c:
                    fleet = c.request("fleet", paths=list(files.values()))
                    require(fleet["paths"] == {
                        files["small"]: small_manifest["reads"],
                        files["long"]: long_manifest["reads"],
                        files["unmapped"]: n_unmapped}, fleet)
                    lr = c.request("count", path=files["long"])
                    require(lr["exact_fallback"] is True and lr["escaped"] > 0
                            and lr["count"] == long_manifest["reads"], lr)
                    batch_log = []
                    for transport in ("socket", "auto"):
                        with ServeClient(srv.address,
                                         transport=transport) as ct:
                            for label, (kw, blob, _) in exports.items():
                                t0 = time.perf_counter()
                                r = ct.request("batch", path=files["small"],
                                               **kw)
                                s = time.perf_counter() - t0
                                require(b"".join(bytes(f) for f in
                                                 r["_binary"]) == blob,
                                        f"batch [{label}] over {ct.transport}"
                                        " != export")
                                batch_log.append(
                                    f"{label} over {ct.transport} {s:.3f} s")
                        require(ct.transport == ("socket" if transport ==
                                                 "socket" else "shm"),
                                ct.transport)
                    ag = c.request("aggregate", path=files["small"])
                    meta, payload = encode_result(
                        AggConfig.parse(""), len(one_shot["contigs"]),
                        one_shot["contigs"], one_shot["metrics"])
                    require(ag["result"] == meta and
                            b"".join(ag["_binary"]) == payload,
                            "serve aggregate != aggregate")
                    # Overloaded at scan_queue=1, a deadline shed, drain.
                    c.request("tune", scan_queue=1)
                    svc_b.batcher.pause()
                    held = svc_b.submit({"op": "count", "path": files["small"]})
                    time.sleep(0.1)
                    with ServeClient(srv.address, policy=None) as cf:
                        try:
                            cf.request("count", path=files["small"])
                            require(False, "no Overloaded at scan_queue=1")
                        except ServeClientError as e:
                            require(e.error == "Overloaded", e.resp)
                    svc_b.batcher.resume()
                    require(held.result(timeout=300)["count"] ==
                            small_manifest["reads"], "held count")
                    c.request("tune", scan_queue=64)
                    svc_b.batcher.pause()
                    shed = svc_b.submit({"op": "count", "path": files["small"],
                                         "deadline_ms": 30})
                    time.sleep(0.3)
                    svc_b.batcher.resume()
                    require(shed.result(timeout=300)["error"] ==
                            "DeadlineExceeded", "deadline shed")
                    stats_b = c.request("stats")
                    paths["serve_b"] = dict(K.LAUNCHES)
                    row_b = _row_cost(svc_b, files["small"])
                    # Card = CPU on the 40 MiB BAM (the count over its
                    # last third: the whole file's and two thirds' CPU
                    # counts were a depth cut, PERF.md §4; the clients
                    # above hold the whole-file count to the generator's).
                    t0 = time.perf_counter()
                    for req in ({"op": "count", "path": files["small"],
                                 "start": 2 * small_size // 3},
                                {"op": "plan", "path": files["small"],
                                 "split_size": 4 << 20},
                                {"op": "batch", "path": files["small"],
                                 "columns": ["flag", "pos", "name", "cigar"],
                                 "intervals": "chr1:1-50000000"},
                                {"op": "aggregate", "path": files["small"],
                                 "flags_forbidden": 0x10}):
                        got = _served(c.request(**req))
                        exp = _served(svc_cpu.submit(dict(req)).result(
                            timeout=600))
                        require(got == exp, f"card != CPU on {req}")
                    cpu_s = time.perf_counter() - t0
                    c.request("drain")
                    try:
                        c.request("count", path=files["small"])
                        require(False, "a draining service took work")
                    except ServeClientError as e:
                        require(e.error == "Draining", e.resp)
        finally:
            svc_b.close()
            svc_cpu.close()
        require(paths["serve_b"]["prefilter_check_flags"] > 0
                and paths["serve_b"]["full_check_flags"] > 0, paths["serve_b"])
        p50, p99 = _pct(lat, 0.5), _pct(lat, 0.99)
        log(f"serve B (defaults, 40 MiB + long-read + unmapped BAMs): 8 "
            f"clients x 3 counts in {clients_s:.3f} s, latency p50 "
            f"{p50:.1f} ms p99 {p99:.1f} ms (client clock), each = the "
            f"generator's; one 1 MiB row {row_b[0]} cudaLaunchKernel "
            f"calls, {row_b[1]} device kernels, {row_b[2]:.2f} ms (CUDA "
            f"events); batch sizes {stats_b['batch_sizes']}; count "
            f"rows_per_s {stats_b['ops']['count']['rows_per_s']}; fleet "
            f"{fleet['total']}; long reads escaped {lr['escaped']} -> exact "
            f"{lr['count']}; batch = export byte for byte: "
            + ", ".join(batch_log)
            + f"; aggregate = aggregate; Overloaded at scan_queue=1, a "
            f"deadline shed, drain; card = CPU on count, plan, batch and "
            f"aggregate ({cpu_s:.1f} s with the CPU service); launches "
            f"{paths['serve_b']} ({card})")

        # ---- the funnel off: count rows through the full flag kernel ----
        svc_c = SplitService(port.Config(funnel="off"))
        try:
            K.reset_launch_counts()
            r = svc_c.submit({"op": "count", "path": files["small"]}).result(
                timeout=600)
            paths["serve_funnel_off"] = dict(K.LAUNCHES)
        finally:
            svc_c.close()
        require(r["count"] == small_manifest["reads"], r)
        require(paths["serve_funnel_off"]["full_check_flags"] > 0
                and paths["serve_funnel_off"]["prefilter_check_flags"] == 0,
                paths["serve_funnel_off"])
        log(f"serve --funnel off: count {r['count']} through "
            f"full_check_flags ({paths['serve_funnel_off']})")
    finally:
        obs.shutdown()
        os.environ.pop("SPARK_BAM_CACHE_DIR", None)
    log(f"phase 13 (serve): {time.perf_counter() - t_phase:.1f} s")
    return paths


def _wait_for(pred, timeout_s: float, what: str) -> float:
    """Poll ``pred`` until it holds; the seconds it took, or a failure."""
    t0 = time.perf_counter()
    while not pred():
        require(time.perf_counter() - t0 < timeout_s, f"timed out: {what}")
        time.sleep(0.01)
    return time.perf_counter() - t0


def _pct(samples: list, q: float) -> float:
    s = sorted(samples)
    return s[min(len(s) - 1, round(q * (len(s) - 1)))]


def fabric_phase(port, bam, manifest, small, small_manifest, work,
                 card) -> dict:
    """Phase 14, the serve fabric on the card; returns the kernel launches
    of the two in-process paths (the failover and latency run, and the
    chaos run)."""
    import signal
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from spark_bam_tpu_torch.core.faults import _roll
    from spark_bam_tpu_torch.fabric import (
        FabricChaos,
        Router,
        WorkerPool,
        parse_fabric_chaos,
        rendezvous_weight,
    )
    from spark_bam_tpu_torch.fabric.chaos import _KINDS
    from spark_bam_tpu_torch.fabric.worker import PipeReader
    from spark_bam_tpu_torch.sbi.format import PLAN_POS, decode_sbi
    from spark_bam_tpu_torch.sbi.store import CacheStore
    from spark_bam_tpu_torch.serve import (
        ServeClient,
        ServeClientError,
        ServerThread,
        SplitService,
    )
    from spark_bam_tpu_torch.tpu import kernels as K

    t_phase = time.perf_counter()
    paths: dict = {}
    want, small_want = manifest["reads"], small_manifest["reads"]
    spec_a = "window=24MB,halo=4MB,batch=4,tick=2,workers=4,cache=2GB"
    out = work / "fabric_export.sbcr"
    port.export(small, out)
    export_bytes = out.read_bytes()
    out.unlink()
    cache_dir = work / "sbi_cache"
    sidecar = decode_sbi(open(CacheStore.from_env(
        {"SPARK_BAM_CACHE_DIR": str(cache_dir)}).sidecar_path(bam),
        "rb").read())
    plan32 = [(e.file_start, [e.pos.block_pos, e.pos.offset]
               if e.kind == PLAN_POS else None)
              for e in sidecar.split_plans[32 << 20]]

    # ---- (a) the fabric command, as users run it -----------------------
    sock = os.path.relpath(work / "fabric.sock")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               SPARK_BAM_CACHE_DIR=str(cache_dir),
               SPARK_BAM_CACHE="readwrite")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_bam_tpu_torch", "fabric",
         "--fabric", "workers=2,probe=500,stream=1", "--serve", spec_a,
         "--listen", f"unix:{sock}"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    err = PipeReader(proc.stderr)
    try:
        require(err.wait(lambda x: "routing on" in x, time.monotonic() + 300)
                is not None and proc.poll() is None,
                "".join(err.lines)[-4000:])
        _wait_for(lambda: os.path.exists(sock), 30, "the router's socket")
        up_s = time.perf_counter() - t0
        with ServeClient(f"unix:{sock}") as c:
            t0 = time.perf_counter()
            first = c.request("count", path=str(bam))
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = c.request("count", path=str(bam))
            again_s = time.perf_counter() - t0
            require(first["count"] == again["count"] == want
                    and first["escaped"] == 0, (first, again))
            stats = c.request("stats")
            served = {w: v["stats"]["ops"].get("count", {}).get("requests", 0)
                      for w, v in stats["workers"].items()}
            require(sorted(served.values()) == [0, 2],
                    f"the repeat left its worker: {served}")
            t0 = time.perf_counter()
            plan = c.request("plan", path=str(bam), split_size=32 << 20)
            plan_s = time.perf_counter() - t0
            got = [(s["start"], s["pos"]) for s in plan["splits"]]
            require(got == plan32, "the fabric's plan at 32 MiB != phase 10's")
            stats = c.request("stats")
            res = [v["stats"]["split_resolutions"]
                   for v in stats["workers"].values()]
            require(res == [0, 0], f"the warm plan resolved {res}")
            batch_s = {}
            for transport in ("socket", "auto"):
                with ServeClient(f"unix:{sock}", transport=transport) as cb:
                    t0 = time.perf_counter()
                    r = cb.request("batch", path=str(small))
                    batch_s[cb.transport] = time.perf_counter() - t0
                    require(b"".join(bytes(f) for f in r["_binary"]) ==
                            export_bytes, f"streamed batch over "
                            f"{cb.transport} != export")
            stats = c.request("stats")
            require(stats["counters"].get("streamed") == 2, stats["counters"])
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        down_s = time.perf_counter() - t0
        require(rc == 0, f"fabric exited {rc}: {''.join(err.lines)[-4000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    log(f"fabric command (2 workers on the card, {spec_a}): routing "
        f"{up_s:.3f} s after launch (both workers announced); the 1 GiB "
        f"count {first['count']} = the manifest's in {first_s:.3f} s with "
        f"the first touch, {again_s:.3f} s again on the same worker "
        f"({served}); plan at 32 MiB = phase 10's ({len(got)} splits) in "
        f"{plan_s:.3f} s, split resolutions {res}; streamed batch of the 40 "
        f"MiB BAM = export's file over socket {batch_s['socket']:.3f} s, "
        f"shm (descriptor relay) {batch_s['shm']:.3f} s; SIGTERM: exit 0 "
        f"drained in {down_s:.3f} s ({card})")

    # ---- (b) a Router over an in-process worker and a pool worker ------
    svc = SplitService(port.Config(serve=spec_a))
    srv = ServerThread(svc, "tcp:127.0.0.1:0").start()
    pool = WorkerPool(workers=1, serve=spec_a,
                      env=dict(os.environ, PYTHONPATH=str(ROOT)))
    rsrv = router = rsrv_c = None
    try:
        t0 = time.perf_counter()
        pool_addr = pool.start(timeout_s=300)[0]
        spawn_s = time.perf_counter() - t0
        in_addr = "tcp:%s:%d" % srv.address
        # The in-process worker wins the small BAM; the pool worker wins an
        # alias of it, so the killed batch starts on the pool worker.
        in_wid = max(("w0", "w1"),
                     key=lambda w: rendezvous_weight(w, str(small)))
        pool_wid = "w1" if in_wid == "w0" else "w0"
        addrs = [in_addr, pool_addr] if in_wid == "w0" \
            else [pool_addr, in_addr]
        alias = next(work / f"fabric_alias_{k}.bam" for k in range(64)
                     if max(("w0", "w1"), key=lambda w: rendezvous_weight(
                         w, str(work / f"fabric_alias_{k}.bam"))) == pool_wid)
        os.symlink(small, alias)
        router = Router(addrs, config=port.Config(
            fabric="probe=200,probe_timeout=2000,eject=100,eject_max=400,"
                   "holddown=400,autoscale=600000,budget=64,budget_rate=1"))
        sock_b = os.path.relpath(work / "fabric_b.sock")
        rsrv = ServerThread(router, f"unix:{sock_b}").start()
        pool_link = router.links[int(pool_wid[1])]
        def batch_alias():
            with ServeClient(rsrv.address) as cb:
                return cb.request("batch", path=str(alias))

        K.reset_launch_counts()
        with ThreadPoolExecutor(1) as ex, ServeClient(rsrv.address) as c:
            c.request("ping")
            fut = ex.submit(batch_alias)
            _wait_for(lambda: pool_link.inflight > 0, 60,
                      "the batch in flight on the pool worker")
            pool.wedge(0)              # it cannot finish now...
            t_kill = time.perf_counter()
            pool.kill(0, hard=True)    # ...and dies mid-batch
            r = fut.result(timeout=300)
            failover_s = time.perf_counter() - t_kill
            require(b"".join(bytes(f) for f in r["_binary"]) == export_bytes,
                    "batch across the SIGKILL != export")
            require(router.counters.get("failovers", 0) >= 1,
                    router.counters)
            t0 = time.perf_counter()
            require(pool.respawn(0, timeout_s=300) == pool_addr, "respawn")
            respawn_s = time.perf_counter() - t0
            reinstate_s = _wait_for(lambda: pool_link.healthy, 60,
                                    "the respawned worker's reinstatement")

        def counts(address):
            def client(i):
                lat = []
                with ServeClient(address) as ci:
                    for _ in range(3):
                        t = time.perf_counter()
                        n = ci.request("count", path=str(small))["count"]
                        lat.append((time.perf_counter() - t) * 1e3)
                        require(n == small_want, (n, small_want))
                return lat
            t = time.perf_counter()
            with ThreadPoolExecutor(8) as ex:
                lat = [x for r in ex.map(client, range(8)) for x in r]
            return lat, time.perf_counter() - t

        def hop(address):
            # Sequential empty-range counts: a request with no rows, so
            # its time is the transport and the handler alone.
            lat = []
            with ServeClient(address) as ci:
                for _ in range(30):
                    t = time.perf_counter()
                    ci.request("count", path=str(small), start=0, end=0)
                    lat.append((time.perf_counter() - t) * 1e3)
            return statistics.median(lat)

        with ServeClient(rsrv.address) as c:       # the small BAM's first
            c.request("count", path=str(small))    # touch on its worker
        before = dict(router.counters)
        turns = {"router": ([], [], []), "direct": ([], [], [])}
        for via in ("direct", "router", "router", "direct"):
            lat, wall = counts(rsrv.address if via == "router" else in_addr)
            turns[via][0].extend(lat)
            turns[via][1].append(wall)
            turns[via][2].append(hop(rsrv.address if via == "router"
                                     else in_addr))
        moved = {k: v - before.get(k, 0) for k, v in router.counters.items()
                 if v != before.get(k, 0)}
        lat_r, lat_d = turns["router"][0], turns["direct"][0]
        wall_r, wall_d = (statistics.mean(turns[v][1])
                          for v in ("router", "direct"))
        hop_r, hop_d = (statistics.median(turns[v][2])
                        for v in ("router", "direct"))
        paths["fabric_inprocess"] = dict(K.LAUNCHES)
        require(paths["fabric_inprocess"]["prefilter_check_flags"] > 0
                and paths["fabric_inprocess"]["full_check_flags"] > 0,
                paths["fabric_inprocess"])
        log(f"fabric in-process (a Router over the in-process worker and "
            f"one pool worker, {spec_a}): pool worker spawn to announce "
            f"{spawn_s:.3f} s (torch import, CUDA init, library load); "
            f"SIGKILL mid-batch: frames = export's, failovers "
            f"{router.counters['failovers']}, the batch answered "
            f"{failover_s:.3f} s after the kill; respawn on its port "
            f"{respawn_s:.3f} s, reinstated {reinstate_s:.3f} s later; 8 "
            f"clients x 3 counts of the 40 MiB BAM in turns (direct, "
            f"router, router, direct): through the router {wall_r:.3f} s "
            f"a turn = {24 / wall_r:.1f} counts/s, latency p50 "
            f"{_pct(lat_r, 0.5):.1f} ms p99 {_pct(lat_r, 0.99):.1f} ms; "
            f"direct to the worker {wall_d:.3f} s = {24 / wall_d:.1f} "
            f"counts/s, p50 {_pct(lat_d, 0.5):.1f} ms p99 "
            f"{_pct(lat_d, 0.99):.1f} ms; the 3 slowest through "
            f"{[round(x, 1) for x in sorted(lat_r)[-3:]]} ms, direct "
            f"{[round(x, 1) for x in sorted(lat_d)[-3:]]} ms; the router's "
            f"counters over the turns {moved}; an empty-range count alone "
            f"(median of 30, each turn) {hop_r:.3f} ms through the router, "
            f"{hop_d:.3f} ms direct: the hop adds {hop_r - hop_d:.3f} ms; "
            f"in-process launches {paths['fabric_inprocess']} ({card})")

        # ---- (c) a seeded chaos run over the same fleet ------------------
        # The first seed whose schedule cuts a stream and corrupts a
        # descriptor early, and drops none of the first three sends.
        seed = next(k for k in range(1, 10_000)
                    if any(_roll(k, _KINDS["shm_crc"], i, 0.02)
                           for i in range(1, 24))
                    and any(_roll(k, _KINDS["trunc"], i, 0.02)
                            for i in range(1, 48))
                    and not any(_roll(k, _KINDS["drop"], i, 0.05)
                                for i in range(3)))
        chaos = (f"{seed}:drop=0.05+dup=0.05+delay=0.1x20+trunc=0.02+"
                 "shm_crc=0.02")
        svc.shm_chaos = FabricChaos(*parse_fabric_chaos(chaos))
        fab_c = ("probe=500,probe_timeout=2000,eject=50,eject_max=200,"
                 "holddown=200,autoscale=600000,stream=1,budget=64,"
                 f"budget_rate=1,chaos={chaos}")
        router_c = Router(addrs, config=port.Config(fabric=fab_c))
        sock_c = os.path.relpath(work / "fabric_c.sock")
        rsrv_c = ServerThread(router_c, f"unix:{sock_c}").start()
        K.reset_launch_counts()
        tally = {"sent": 0, "retries": 0, "no_healthy": 0, "lost": 0,
                 "wrong": 0}
        tally_lock = threading.Lock()

        def note(key, n=1):
            with tally_lock:
                tally[key] += n

        def ask(ci, op, check):
            # A typed WorkerLost (both links down at once, or the budget
            # spent) is the client's to retry; a request is lost when its
            # 20 sends all fail, wrong when its answer differs. The
            # retries, and of them the router's "no healthy workers"
            # answers, say how often the fleet refused work.
            for _ in range(20):
                note("sent")
                try:
                    r = ci.request(op, path=str(small))
                except ServeClientError as e:
                    require(e.error == "WorkerLost", e.resp)
                    note("retries")
                    note("no_healthy", int("no healthy workers"
                                           in e.resp.get("message", "")))
                    time.sleep(0.05)
                    continue
                note("wrong", int(not check(r)))
                return
            note("lost")

        def chaos_client(i):
            with ServeClient(rsrv_c.address) as ci:
                if i < 2:
                    for _ in range(2):
                        ask(ci, "batch", lambda r: b"".join(
                            bytes(f) for f in r["_binary"]) == export_bytes)
                for _ in range(4):
                    ask(ci, "count", lambda r: r["count"] == small_want)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            list(ex.map(chaos_client, range(8)))
        chaos_s = time.perf_counter() - t0
        paths["fabric_chaos"] = dict(K.LAUNCHES)
        fcfg = router_c.fcfg
        spent = router_c.counters.get("budget_spent", 0)
        require(tally["lost"] == 0 and tally["wrong"] == 0, tally)
        require(spent <= fcfg.budget + fcfg.budget_rate * tally["sent"],
                (spent, tally))
        require(paths["fabric_chaos"]["prefilter_check_flags"] > 0,
                paths["fabric_chaos"])
        log(f"fabric chaos ({chaos}, stream=1): 36 requests (32 counts, 4 "
            f"streamed batches over shm) in {chaos_s:.3f} s, every count = "
            f"the generator's, every batch = export's, lost 0 (after "
            f"client retries), wrong 0; client retries of a typed "
            f"WorkerLost {tally['retries']}, of them the router's 'no "
            f"healthy workers' {tally['no_healthy']}; "
            f"injected {dict((k, v) for k, v in router_c.chaos.injected.items() if v)}"
            f" at the links, shm_crc {svc.shm_chaos.injected['shm_crc']} on "
            f"the in-process worker's ring; router counters "
            f"{dict(sorted(router_c.counters.items()))}; budget spent "
            f"{spent} of {fcfg.budget} + {fcfg.budget_rate} x "
            f"{tally['sent']} admitted; launches {paths['fabric_chaos']} "
            f"({card})")
    finally:
        for s in (rsrv_c, rsrv):
            if s is not None:
                s.stop()
        pool.terminate()
        srv.stop()
        svc.close()
    log(f"phase 14 (fabric): {time.perf_counter() - t_phase:.1f} s")
    return paths


def _journal_tags(path) -> list:
    """The tags of a journal's durable prefix ([] before it exists)."""
    from spark_bam_tpu_torch.jobs.journal import read_journal

    try:
        return [r["t"] for r in read_journal(path)]
    except OSError:
        return []


def _same_file(a, b) -> bool:
    import filecmp

    return filecmp.cmp(str(a), str(b), shallow=False)


def _first_fault_seed(kind: int, rate: float, lo: int, hi: int) -> int:
    """The first disk-chaos seed whose first fault of ``kind`` at ``rate``
    lands on an operation in [lo, hi)."""
    from spark_bam_tpu_torch.core.faults import _roll

    for seed in range(1, 1 << 20):
        first = next((i for i in range(hi) if _roll(seed, kind, i, rate)),
                     None)
        if first is not None and first >= lo:
            return seed
    raise AssertionError("no seed")


def jobs_phase(port, bam, manifest, small, small_manifest, work, card,
               keep: dict) -> dict:
    """Phase 15, the durable job plane on the card; returns the kernel
    launches of its in-process paths. Its oracles are phase 11's small-BAM
    container and phase 12's rewrites (``keep``): it runs no clean job of
    its own."""
    import io
    import signal

    from spark_bam_tpu_torch import cli
    from spark_bam_tpu_torch.core import faults
    from spark_bam_tpu_torch.fabric import Router, WorkerPool, rendezvous_weight
    from spark_bam_tpu_torch.fabric.worker import PipeReader
    from spark_bam_tpu_torch.jobs.journal import read_journal
    from spark_bam_tpu_torch.jobs.manager import job_id_of
    from spark_bam_tpu_torch.load import boundary
    from spark_bam_tpu_torch.obs import flight
    from spark_bam_tpu_torch.sbi.store import reset_cache_events
    from spark_bam_tpu_torch.serve import (
        ServeClient,
        ServeClientError,
        ServerThread,
        SplitService,
    )
    from spark_bam_tpu_torch.tpu import kernels as K

    t_phase = time.perf_counter()
    paths: dict = {}
    saved_env = {k: os.environ.pop(k, None) for k in (
        "SPARK_BAM_DEFLATE", "SPARK_BAM_CACHE", "SPARK_BAM_CACHE_DIR",
        "SPARK_BAM_JOBS", "SPARK_BAM_DISK_CHAOS", "SPARK_BAM_COLUMNAR")}
    jobs_root = work / "jobs"
    out_dir = work / "jobs_out"
    out_dir.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    try:
        # ---- (a) export --durable as users run it: killed, then resumed -
        # On the 40 MiB BAM, a checkpoint a frame (the 1 GiB BAM's, eight
        # frames a checkpoint, was a depth cut: PERF.md §4).
        out = out_dir / "durable.sbcr"
        argv = ["export", "--durable", "--jobs",
                f"dir={jobs_root / 'export'},frames=1", "-o", str(out),
                str(small)]
        jid = job_id_of({"op": "export", "path": str(small),
                         "out": str(out)})
        journal = jobs_root / "export" / jid / "journal.sbj"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_bam_tpu_torch", *argv], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        err = PipeReader(proc.stderr)
        try:
            _wait_for(lambda: (_journal_tags(journal).count("ckpt") >= 2
                               or proc.poll() is not None), 300,
                      "two checkpoints of the durable export")
            require(proc.poll() is None
                    and "done" not in _journal_tags(journal),
                    "the durable export ended before its kill: "
                    + "".join(err.lines)[-3000:])
            proc.send_signal(signal.SIGSTOP)
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        killed_s = time.perf_counter() - t0
        require(proc.returncode == -signal.SIGKILL, proc.returncode)
        require(not out.exists(), "an artifact before the job's done")
        banked = [r for r in read_journal(journal) if r["t"] == "ckpt"]
        K.reset_launch_counts()
        torch.cuda.synchronize()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        resume_s = time.perf_counter() - t0
        paths["jobs_durable_export"] = dict(K.LAUNCHES)
        require(rc == 0, f"export --durable resumed: rc {rc}")
        res = json.loads(buf.getvalue())
        reads = small_manifest["reads"]
        require(res["resumed"] and res["rows"] == reads
                and res["batches"] == -(-reads // 8192), res)
        require(_same_file(out, keep["export_small_sbcr"]),
                "the resumed durable export != phase 11's small.sbcr")
        require(all(paths["jobs_durable_export"][k] > 0
                    for k in COUNT_KERNELS)
                and paths["jobs_durable_export"]["full_check_flags"] == 0,
                paths["jobs_durable_export"])
        recs = read_journal(journal)
        fresh = [r for r in recs if r["t"] == "ckpt"][len(banked):]
        ck_bytes = sum(r["seg_bytes"] for r in fresh)
        log(f"jobs (a) export --durable of the 40 MiB BAM (frames=1): "
            f"SIGKILLed {killed_s:.3f} s after launch with "
            f"{len(banked)} checkpoints ({banked[-1]['frames']} frames, "
            f"{banked[-1]['offset']} bytes) durable; the same command "
            f"in-process resumed and finished in {resume_s:.3f} s (phase "
            f"11's plain export {keep['export_small_wall']:.3f} s): .sbcr = "
            f"phase 11's byte for byte ({out.stat().st_size} bytes, {res['rows']} "
            f"rows, {res['batches']} frames); redone bytes "
            f"{res['redone_bytes']}; journal appends {len(recs)} "
            f"({res['checkpoints']} checkpoints), this run's checkpoints "
            f"{len(fresh)} = {ck_bytes} bytes, {ck_bytes / resume_s / 1e6:.1f}"
            f" MB/s of checkpointed segments; launches "
            f"{paths['jobs_durable_export']} ({card})")
        out.unlink()

        # ---- (b) the fabric's rescue of a transcode on the card ---------
        shared = jobs_root / "shared"
        tr_out = out_dir / "transcoded.bam"
        req = {"job": "transcode", "path": str(small), "out": str(tr_out),
               "block_payload": 65280, "level": 6, "deflate": "mode=fixed"}
        jid = job_id_of({"op": "transcode", **{k: v for k, v in req.items()
                                              if k != "job"}})
        tjournal = shared / jid / "journal.sbj"
        pool = WorkerPool(workers=2, env=dict(
            env, SPARK_BAM_JOBS=f"dir={shared},checkpoint=20000,mem=1.0"))
        rsrv = None
        try:
            t0 = time.perf_counter()
            addrs = pool.start(timeout_s=300)
            spawn_s = time.perf_counter() - t0
            router = Router(addrs, config=port.Config(
                fabric="probe=100,autoscale=600000"))
            rsrv = ServerThread(router, "tcp:127.0.0.1:0").start()
            owner = max(range(2), key=lambda i: rendezvous_weight(
                f"w{i}", str(small)))
            with ServeClient(rsrv.address) as c:
                t_sub = time.perf_counter()
                require(c.request("submit", **req)["job_id"] == jid, jid)
                _wait_for(lambda: bool({"ckpt", "done"}
                                       & set(_journal_tags(tjournal))),
                          300, "the transcode's first checkpoint")
                require("done" not in _journal_tags(tjournal),
                        "the transcode finished before its owner's kill")
                kill_after_s = time.perf_counter() - t_sub
                pool.wedge(owner)
                t_kill = time.perf_counter()
                pool.kill(owner, hard=True)
                while True:
                    require(time.perf_counter() - t_kill < 300,
                            "the rescued transcode did not finish")
                    try:
                        st = c.request("job_status", job_id=jid)
                    except (ServeClientError, ConnectionError, OSError):
                        time.sleep(0.05)     # the owner is gone: rescue due
                        continue
                    if st["state"] == "done":
                        break
                    require(st["state"] == "running", st)
                    time.sleep(0.05)
                rescue_s = time.perf_counter() - t_kill
            rescues = router.counters.get("job_rescues", 0)
        finally:
            if rsrv is not None:
                rsrv.stop()
            pool.terminate()
        require(rescues == 1, router.counters)
        tres = st["result"]
        seg = [r["seg_bytes"] for r in read_journal(tjournal)
               if r["t"] == "ckpt"]
        require(tres["resumed"] and tres["redone_bytes"] <= 2 * max(seg),
                (tres, max(seg)))
        for ext in ("", ".blocks", ".records"):
            require(_same_file(str(tr_out) + ext,
                               str(keep["rewrite_small"]) + ext),
                    f"the rescued transcode{ext} != phase 12's small_0.bam"
                    f"{ext}")
        boundary.STATS.reset()
        reset_cache_events()
        K.reset_launch_counts()
        rep = io.StringIO()
        with contextlib.redirect_stdout(rep):
            require(cli.main(["compute-splits", "-s", "--cache", "read",
                              str(tr_out)]) == 0, "warm compute-splits")
        require("cache: hit (fingerprint ok)" in rep.getvalue()
                and boundary.STATS.resolutions == 0
                and not any(K.LAUNCHES.values()),
                f"warm compute-splits of the transcode: "
                f"{boundary.STATS.resolutions} resolutions, {K.LAUNCHES}")
        rep = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(rep):
            rc = cli.main(["scrub", "--source", str(small), str(tr_out)])
        scrub_s = time.perf_counter() - t0
        report = json.loads(rep.getvalue())
        require(rc == 0 and report["clean"]
                and report["records_checked"] == small_manifest["reads"]
                and report["artifacts"] == 4, report)
        size = tr_out.stat().st_size
        log(f"jobs (b) fabric rescue: two pool workers on the card (spawn "
            f"to announce {spawn_s:.3f} s) share a jobs dir; submit "
            f"transcode deflate=mode=fixed of the 40 MiB BAM; its owner "
            f"w{owner} stopped and SIGKILLed {kill_after_s:.3f} s after the "
            f"submit (first checkpoint durable); the watchdog re-homed it "
            f"(job_rescues {rescues}) and it was done {rescue_s:.3f} s after "
            f"the SIGKILL; BAM, .blocks and .records = phase 12's small_0 "
            f"byte for byte; redone bytes {tres['redone_bytes']} (largest "
            f"segment {max(seg)}); warm compute-splits 0 resolutions, 0 "
            f"launches; scrub --source clean: {report['records_checked']} "
            f"records, {size} bytes in {scrub_s:.3f} s = "
            f"{report['records_checked'] / scrub_s:.0f} records/s, "
            f"{size / scrub_s / 1e6:.1f} MB/s ({card})")
        for ext in ("", ".blocks", ".records", ".sbi"):
            Path(str(tr_out) + ext).unlink(missing_ok=True)

        # ---- (c) a worker's export job; a rewrite paused by ENOSPC -------
        spec_a = "window=24MB,halo=4MB,batch=4,tick=2,workers=4,cache=2GB"
        svc = SplitService(port.Config(
            serve=spec_a,
            jobs=f"dir={jobs_root / 'inproc'},checkpoint=20000,mem=1.0"))

        def job(req, timeout=600):
            st = svc.submit(dict(req, op="submit")).result(timeout=timeout)
            t = time.perf_counter()
            while st["state"] == "running":
                require(time.perf_counter() - t < timeout, st)
                time.sleep(0.02)
                st = svc.submit({"op": "job_status", "job_id": st["job_id"]}
                                ).result(timeout=timeout)
            return st

        try:
            plain = out_dir / "plain.sbcr"
            port.export(small, plain)
            ex_out = out_dir / "worker_export.sbcr"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            st = job({"job": "export", "path": str(small),
                      "out": str(ex_out)})
            ex_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            paths["jobs_worker_export"] = dict(K.LAUNCHES)
            require(st["state"] == "done"
                    and st["result"]["rows"] == small_manifest["reads"], st)
            require(_same_file(ex_out, plain),
                    "the worker's export job != export's file")
            log(f"jobs (c) export job of the 40 MiB BAM in an in-process "
                f"worker ({spec_a}): done "
                f"in {ex_s:.3f} s, = export's file; device memory "
                f"{before / 2**20:.1f} MiB before it, peak "
                f"{peak / 2**20:.1f} MiB while it ran; launches "
                f"{paths['jobs_worker_export']} ({card})")
            for p_ in (plain, ex_out):
                p_.unlink()

            src = keep["rewrite_src"]
            m = keep["rewrite_src_manifest"]
            rw_out = out_dir / "paused.bam"
            rreq = {"job": "rewrite", "path": str(src), "out": str(rw_out),
                    "deflate": "mode=fixed"}
            # One write a member and a journal append a checkpoint: the
            # first injected ENOSPC lands between a fifth and a third of
            # them.
            n_writes = (-(-m["uncompressed_bytes"] // 65280)
                        + m["reads"] // 20000 + 2)
            rate = 3.0 / n_writes
            seed = _first_fault_seed(faults._K_ENOSPC, rate, n_writes // 5,
                                     n_writes // 3)
            flight.recorder().clear()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with faults.disk_chaos(f"{seed}:enospc={rate}"):
                st = job(rreq)
            pause_s = time.perf_counter() - t0
            rjid = st["job_id"]
            require(st["state"] == "paused" and "ENOSPC" in st["error"], st)
            rck = [r for r in read_journal(jobs_root / "inproc" / rjid /
                                           "journal.sbj") if r["t"] == "ckpt"]
            require(rck, "the paused rewrite banked no checkpoint")
            alerts = [e for e in flight.recorder().events()
                      if e["e"] == "slo_alert" and e.get("job_id") == rjid]
            require(len(alerts) == 1 and alerts[0]["objective"]
                    == "jobs.paused", alerts)
            t0 = time.perf_counter()
            st = job(rreq)
            resume_rw_s = time.perf_counter() - t0
            paths["jobs_pause_resume_rewrite"] = dict(K.LAUNCHES)
            require(st["state"] == "done" and st["result"]["resumed"]
                    and st["result"]["count"] == m["reads"], st)
            require(paths["jobs_pause_resume_rewrite"]["deflate_fixed_lanes"]
                    > 0, paths["jobs_pause_resume_rewrite"])
            require(_same_file(rw_out, keep["rewrite_128mib"]),
                    "the paused-then-resumed rewrite != phase 12's 128mib_0")
            stats = svc.submit({"op": "stats"}).result(timeout=60)
            require(stats["jobs"].get(rjid) == "done", stats["jobs"])
            log(f"jobs (c) rewrite job of the 128 MiB BAM under "
                f"mode=fixed and disk chaos {seed}:enospc={rate:.6f}: paused "
                f"after {len(rck)} checkpoints ({rck[-1]['records']} records)"
                f" in {pause_s:.3f} s, the alert in the flight record; "
                f"resubmitted without chaos, done in {resume_rw_s:.3f} s, "
                f"= phase 12's 128mib_0.bam byte for byte; redone bytes "
                f"{st['result']['redone_bytes']}; launches "
                f"{paths['jobs_pause_resume_rewrite']} ({card})")
            rw_out.unlink()
        finally:
            svc.close()
    finally:
        for k, v in saved_env.items():
            if v is not None:
                os.environ[k] = v
        shutil.rmtree(jobs_root, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"phase 15 (jobs): {time.perf_counter() - t_phase:.1f} s")
    return paths


def host_tokenize_phase(port, bam, manifest, small, small_manifest,
                        summary_card, summary_cpu, work, card,
                        fused_s) -> tuple[dict, dict]:
    """Phase 16: ``inflate tokenize=host``, the host DEFLATE tokenizer
    (``native/tokenize.cpp``) feeding the card's ``lz77_resolve``. Returns
    the launches of each path, counted from zero around it, and the first
    window's host/device split."""
    import dataclasses

    from spark_bam_tpu_torch.benchmarks import load_cases
    from spark_bam_tpu_torch.benchmarks.profile_tokenize import (
        host_device_split,
    )
    from spark_bam_tpu_torch.bgzf.flat import flatten_file, stage_run_payloads
    from spark_bam_tpu_torch.columnar.native import NativeReader
    from spark_bam_tpu_torch.core.channel import open_channel
    from spark_bam_tpu_torch.device import sync
    from spark_bam_tpu_torch.native import build as nbuild
    from spark_bam_tpu_torch.tpu import kernels as K
    from spark_bam_tpu_torch.tpu.inflate import inflate_file_device
    from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE

    dev = torch.device("cuda", 0)
    host = "tokenize=host"
    t_phase = time.perf_counter()
    out: dict = {}

    # (a) The tokenizer's library, built by g++ from the checkout's source.
    lib_path = nbuild.library_path()
    prebuilt = lib_path.exists()
    t0 = time.perf_counter()
    nbuild.load()
    log(f"host tokenizer: {lib_path.name} "
        + (f"already built ({time.perf_counter() - t0:.3f} s to load)"
           if prebuilt else f"built by g++ in {nbuild.build_seconds:.3f} s"))
    cpu_model = "unknown"
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        cpu_model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), cpu_model)
    log(f"host CPU: {cpu_model}, {os.cpu_count()} cores visible")

    # (b) The first window's rows: host planes = the tokenize kernel's (in
    # host_device_split), then the verdicts and refused index on the
    # window's first 16 rows and 32 seeded byte-mutants of them.
    checker = port.StreamChecker(bam, port.Config(inflate=host))
    group0 = checker.pipeline.groups[0]
    with open_channel(bam) as ch:
        split = host_device_split(ch, group0, dev)
        staged, clens = stage_run_payloads(ch, group0)
    rng = np.random.default_rng(16)
    rows_b, rows_c = [], []
    for i in range(48):
        row = staged[i % 16].copy()
        if i >= 16:
            hits = rng.integers(0, clens[i % 16], size=1 + i % 4)
            row[hits] ^= rng.integers(1, 256, size=len(hits)).astype(np.uint8)
        rows_b.append(row)
        rows_c.append(int(clens[i % 16]))
    m_staged = torch.from_numpy(np.stack(rows_b)).to(dev)
    m_clens = torch.tensor(rows_c, dtype=torch.int32, device=dev)
    k_lit, k_dist, k_lens, k_ok = K.tokenize(m_staged, m_clens)
    k_ok = k_ok.cpu().numpy()
    comp = np.stack(rows_b).reshape(-1)
    offs = np.arange(48, dtype=np.int64) * staged.shape[1]
    lens = np.array(rows_c, dtype=np.int64)
    h_lit = np.zeros((48, STRIDE), np.uint8)
    h_dist = np.zeros((48, STRIDE), np.uint16)
    h_lens = np.zeros(48, np.int64)
    verdicts = []
    for i in range(48):
        verdicts.append(nbuild.tokenize_deflate(
            comp, offs[i:i + 1], lens[i:i + 1], h_lit[i:i + 1],
            h_dist[i:i + 1], h_lens[i:i + 1]) == 0)
    verdicts = np.array(verdicts)
    require(np.array_equal(verdicts, k_ok), "host and kernel verdicts differ")
    acc = np.flatnonzero(verdicts)
    kl, kd = k_lit.cpu().numpy(), _as_long(k_dist).cpu().numpy()
    require(np.array_equal(h_lit[acc], kl[acc])
            and np.array_equal(h_dist[acc].astype(np.int64), kd[acc])
            and np.array_equal(h_lens[acc], k_lens.cpu().numpy()[acc]),
            "host planes differ from the kernel's on accepted mutants")
    first_bad = nbuild.tokenize_deflate(
        comp, offs, lens, np.zeros((48, STRIDE), np.uint8),
        np.zeros((48, STRIDE), np.uint16), np.zeros(48, np.int64))
    want_bad = int(np.flatnonzero(~k_ok)[0]) + 1 if (~k_ok).any() else 0
    require(first_bad == want_bad, (first_bad, want_bad))
    per_32mib = (32 << 20) / max(split["uncompressed_bytes"], 1)
    log(f"host tokenizer vs the tokenize kernel, first window "
        f"({split['blocks']} blocks, {split['uncompressed_bytes']} bytes): "
        f"planes and out_lens bit-identical; 48 rows (32 mutants): "
        f"{int((~k_ok).sum())} refused by both, first refused index "
        f"{first_bad} = the kernel's; host tokenize + pack "
        f"{split['host_tokenize_pack_ms']:.1f} ms on {split['threads']} "
        f"threads ({split['host_tokenize_pack_ms'] * per_32mib:.1f} ms per "
        f"32 MiB), {split['host_tokenize_pack_ms_1_thread']:.1f} ms on one "
        f"(threads overlap: "
        f"{split['host_tokenize_pack_ms_1_thread'] / split['host_tokenize_pack_ms']:.2f}x)"
        f"; tokenize kernel {split['tokenize_kernel_ms']:.3f} ms; packed "
        f"H2D {split['packed_h2d_bytes']} bytes {split['packed_h2d_ms']:.3f} "
        f"ms (pinned), raw H2D {split['raw_h2d_bytes']} bytes "
        f"{split['raw_h2d_ms']:.3f} ms (pageable); lz77_resolve on the "
        f"packed planes {split['lz77_on_packed_ms']:.3f} ms")
    del m_staged, k_lit, k_dist

    # (c) count-reads of the 1 GiB BAM, fused, under tokenize=host.
    K.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    got = checker.count_reads()
    sync(dev)
    host_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    windows = len(checker.pipeline.groups)
    require(got == manifest["reads"], (got, manifest["reads"]))
    require(checker.tokenize_demotions == 0, "the host route demoted")
    require(launches["tokenize"] == 0, launches)
    require(launches["lz77_resolve"] == windows, launches)
    require(launches["prefilter_check_flags"] >= windows, launches)
    log(f"count-reads tokenize=host: {got} reads (= the generator's, 0 "
        f"demotions) in {host_s:.3f} s = {got / host_s:.0f} reads/s, beside "
        f"{fused_s:.3f} s on the device tokenizer (phase 3); {windows} "
        f"windows, launches {launches} = "
        f"{sum(launches.values()) / windows:.2f} kernel launches a window "
        f"({card})")
    out["count_reads_host_tokenize"] = launches

    # (d) The 40 MiB BAM under tokenize=host on the card, against the
    # device route on the card and the CPU's results.
    K.reset_launch_counts()
    t0 = time.perf_counter()
    flat = flatten_file(small)
    for spec in (host, ""):
        view = inflate_file_device(small, spec)
        require(np.array_equal(view.data, flat.data)
                and np.array_equal(view.block_flat, flat.block_flat),
                f"inflate_file_device [{spec or 'device'}] != flatten_file")
    del view, flat
    s_host = port.full_check_summary_streaming(small,
                                               port.Config(inflate=host))
    require(summaries_equal(s_host, summary_card)
            and summaries_equal(s_host, summary_cpu),
            "tokenize=host full-check summary differs")

    def load_rows(cfg):
        rows = []
        for base, batch in port.stream_read_batches(small, cfg):
            v = batch.columns["valid"]
            rows.append((base, batch.starts[v],
                         {k: c[v] for k, c in batch.columns.items()}))
        return rows

    lh, ld = load_rows(port.Config(inflate=host)), load_rows(port.Config())
    require(len(lh) == len(ld) and all(
        a[0] == b[0] and np.array_equal(a[1], b[1])
        and all(np.array_equal(a[2][k], b[2][k]) for k in a[2])
        for a, b in zip(lh, ld)), "tokenize=host load batches differ")
    n_rows = sum(len(r[1]) for r in lh)
    require(n_rows == small_manifest["reads"], (n_rows, small_manifest))
    del lh, ld
    mesh = port.make_mesh()
    stats: dict = {}
    sh = port.count_reads_sharded(small, port.Config(inflate=host),
                                  mesh=mesh, stats_out=stats)
    sd = port.count_reads_sharded(small, port.Config(), mesh=mesh)
    require(sh == sd == small_manifest["reads"], (sh, sd))
    require(stats["tokenize_demotions"] == 0, stats)
    sync(dev)
    small_launches = dict(K.LAUNCHES)
    log(f"40 MiB BAM tokenize=host on the card: inflate_file_device = the "
        f"device route's = flatten_file; full-check summary = the device "
        f"route's (phase 4) = the CPU's; load batches = the device route's "
        f"({n_rows} rows = the generator's); sharded count {sh} = the "
        f"device route's; launches {small_launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    out["small_host_tokenize"] = small_launches

    # (e) The export of a refused record mid-file: the record path's 601
    # rows, in the writer's order, card = CPU byte for byte.
    K.reset_launch_counts()
    rm = work / "refused_mid.bam"
    rm_manifest = load_cases.write_refused_mid_bam(rm)
    for geo in ({}, dict(zip(("window_size", "halo_size"),
                             load_cases.GEOMETRY))):
        cfg = port.Config(**geo)
        card_out, cpu_out = work / "rm_card.sbcr", work / "rm_cpu.sbcr"
        res = port.export(rm, card_out, config=cfg)
        port.export(rm, cpu_out, config=dataclasses.replace(cfg),
                    device="cpu")
        blob = card_out.read_bytes()
        names = []
        for b in NativeReader(blob).iter_batches():
            names += [b.columns["name"].value(i).decode()
                      for i in range(b.num_rows)]
        require(res["rows"] == rm_manifest["records"] == 601, res)
        require(names == rm_manifest["names"], "exported names differ")
        require(blob == cpu_out.read_bytes(), "refused-mid export card != CPU")
    sync(dev)
    out["export_refused_mid"] = dict(K.LAUNCHES)
    log(f"export past a refused record mid-file: 601 rows in the writer's "
        f"order at both geometries, card = CPU byte for byte; phase 16 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out, split


def _held_kernels(checker_mod, K):
    """Spies on the check's two flag-kernel wrappers: each launch goes on
    as it was, a card call's inputs are kept, and ``held()`` later runs
    each kept call's plain version on the same inputs and returns the largest
    difference (the plain versions count no launch)."""
    kept = {"prefilter_check_flags": [], "full_check_flags": []}
    real = {name: getattr(checker_mod, name) for name in kept}

    def spy(name):
        def call(padded, lengths, num_contigs, n):
            out = real[name](padded, lengths, num_contigs, n)
            if padded.is_cuda:
                n_in = n.clone() if isinstance(n, torch.Tensor) else n
                kept[name].append((padded.clone(), lengths.clone(),
                                   num_contigs, n_in, out))
            return out
        return call

    def held() -> dict:
        errs = {}
        for name, calls in kept.items():
            err = 0
            for padded, lengths, nc, n, out in calls:
                if name == "prefilter_check_flags":
                    want = K._prefilter_compact(
                        padded, lengths, nc, n,
                        K.lane_capacity(padded.numel() - K.PAD))
                    err = max(err, max_abs_err(zip(out, want)))
                else:
                    want = K._compute_flags(padded, lengths, nc, n)
                    err = max(err, max_abs_err([(out, want)]))
            errs[name] = (len(calls), err)
            calls.clear()
        return errs

    for name in kept:
        setattr(checker_mod, name, spy(name))
    return held, lambda: [setattr(checker_mod, n, f) for n, f in real.items()]


def record_phase(port, small, small_manifest, small_starts, work,
                 card) -> tuple[dict, dict]:
    """Phase 17, the record path and the reference's check commands on
    the card: ``count-reads`` (``load_bam`` with its strict split starts
    resolved on the card against hadoop-bam's count), ``load_splits_and_
    reads`` card = CPU, ``check-bam`` (default and ``-s``) with the eager
    verdict from ``full_check_flags``, ``check-blocks``, ``time-load``,
    ``compare-splits``, ``index-bam`` with ``load_bam_intervals``, and the
    refused record's 601. Every launch of the two flag kernels on these
    paths is held against its plain version on the same inputs. Returns
    the launches of each path, counted from zero around it, and the
    largest kernel-against-plain difference of each kernel."""
    import re

    from spark_bam_tpu_torch import cli, cli_app
    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.bam.index_records import index_records
    from spark_bam_tpu_torch.bam.record import BamRecord
    from spark_bam_tpu_torch.bam.writer import write_bam_result
    from spark_bam_tpu_torch.benchmarks import load_cases
    from spark_bam_tpu_torch.benchmarks.synth import synth_bam
    from spark_bam_tpu_torch.device import sync
    from spark_bam_tpu_torch.load import api, boundary
    from spark_bam_tpu_torch.load.intervals import LociSet
    from spark_bam_tpu_torch.tpu import checker as checker_mod
    from spark_bam_tpu_torch.tpu import kernels as K

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    out: dict = {}
    errs: dict = {}
    held, restore = _held_kernels(checker_mod, K)
    reads = small_manifest["reads"]

    def run_cli(*argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            require(cli.main(list(argv)) == 0, argv)
        return buf.getvalue()

    def note(path: str) -> None:
        sync(dev)
        out[path] = dict(K.LAUNCHES)
        for name, (calls, err) in held().items():
            n_prev, e_prev = errs.get(name, (0, 0))
            errs[name] = (n_prev + calls, max(e_prev, err))
            require(err == 0, f"{name} differs from plain on {path}: {err}")
        K.reset_launch_counts()

    try:
        # (a) count-reads at 2 MiB splits: load_bam (every strict split
        # start resolved on the card before the partitions) against hadoop-bam.
        resolving = []
        real_starts = api._strict_starts

        def timed_starts(*a, **kw):
            t0 = time.perf_counter()
            got = real_starts(*a, **kw)
            resolving.append(time.perf_counter() - t0)
            return got

        api._strict_starts = timed_starts
        boundary.STATS.reset()
        K.reset_launch_counts()
        try:
            text = run_cli("count-reads", "-m", "2MB", str(small))
        finally:
            api._strict_starts = real_starts
        note("record_count_reads")
        spark_ms = int(re.search(r"spark-bam read-count time: (\d+)",
                                 text).group(1))
        hadoop_ms = int(re.search(r"hadoop-bam read-count time: (\d+)",
                                  text).group(1))
        require(f"Read counts matched: {reads}" in text.splitlines(), text)
        require(out["record_count_reads"]["prefilter_check_flags"] > 0,
                out["record_count_reads"])
        resolve_s = resolving[0]
        decode_s = spark_ms / 1e3 - resolve_s
        log(f"count-reads -m 2MB, 40 MiB BAM: Read counts matched: {reads}; "
            f"spark-bam (load_bam) {spark_ms} ms = {reads / spark_ms * 1e3:.0f}"
            f" reads/s: split resolution on the card {resolve_s:.3f} s "
            f"({resolve_s / (spark_ms / 1e3):.1%}; "
            f"{boundary.STATS.resolutions} boundaries, "
            f"{boundary.STATS.windows} check_window calls, "
            f"{boundary.STATS.boundary_demotions} demotions, ms each "
            f"{[round(x, 2) for x in boundary.STATS.ms]}), record decode "
            f"and executor {decode_s:.3f} s ({reads / decode_s:.0f} records/s, "
            f"{decode_s / reads * 1e6:.1f} us a record); hadoop-bam "
            f"{hadoop_ms} ms; launches {out['record_count_reads']} ({card})")

        # (b) load_splits_and_reads: the card's splits = the CPU's.
        t0 = time.perf_counter()
        splits, _ = api.load_splits_and_reads(small, "2MB", device=dev)
        card_s = time.perf_counter() - t0
        note("record_load_splits")
        t0 = time.perf_counter()
        cpu_splits, _ = api.load_splits_and_reads(small, "2MB", device="cpu")
        cpu_s = time.perf_counter() - t0
        require(splits == cpu_splits and len(splits) > 1, "splits differ")
        require(out["record_load_splits"]["prefilter_check_flags"] > 0,
                out["record_load_splits"])
        log(f"load_splits_and_reads -m 2MB: {len(splits)} splits, card = CPU "
            f"(card {card_s:.3f} s, CPU plain {cpu_s:.3f} s); launches "
            f"{out['record_load_splits']}")

        # (c) check-bam, default and -s: the eager verdict at every position
        # from full_check_flags windows on the card.
        if not Path(f"{small}.records").exists():
            index_records(small)
        report = io.StringIO()
        ctx = cli_app.CheckerContext(small, port.Config(),
                                     cli_app.Printer(out=report), device=dev)
        ctx.view
        sync(dev)
        t0 = time.perf_counter()
        eager = ctx.eager_result
        sync(dev)
        eager_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ctx.seqdoop_verdict
        seqdoop_s = time.perf_counter() - t0
        note("record_check_bam")
        cli_app.check_bam(ctx)
        cli_app.check_bam(ctx, spark_bam=True)
        lines = report.getvalue().splitlines()
        require(lines.count(f"{reads} reads") == 2, lines[:12])
        require("All calls matched!" in lines[lines.index(
            f"{reads} reads", 4):], "eager against the .records truth")
        require(out["record_check_bam"]["full_check_flags"] > 0,
                out["record_check_bam"])
        # The CPU plain run's verdict: phase 7's whole-file check on the
        # CPU (its record starts), and a plain check of the first MiB.
        header_end = read_header(small).uncompressed_size
        starts = np.flatnonzero(eager.verdict)
        require(np.array_equal(starts[starts >= header_end], small_starts),
                "eager verdict differs from the CPU plain run's")
        head = 1 << 20
        from spark_bam_tpu_torch.tpu.checker import TpuChecker

        plain = TpuChecker(ctx.lengths, window=head, halo=head // 4,
                           device="cpu").check_buffer(ctx.view.data[:head],
                                                      at_eof=False)
        exact = plain.exact & ~plain.escaped
        for k in ("verdict", "fail_mask", "reads_before"):
            require(np.array_equal(getattr(plain, k)[exact],
                                   getattr(eager, k)[:head][exact]), k)
        log(f"check-bam, 40 MiB BAM ({ctx.view.size} positions): eager "
            f"verdict on the card {eager_s:.3f} s (full_check_flags "
            f"{out['record_check_bam']['full_check_flags']} launches, its "
            f"host recheck included) against the seqdoop verdict on the host "
            f"{seqdoop_s:.3f} s; = the CPU plain run's starts (phase 7) and "
            f"its first MiB at every exact position; default report "
            f"{lines[4:6]}; -s: all calls matched ({card})")

        # (d) check-blocks on the same context.
        blocks_out = io.StringIO()
        ctx.printer = cli_app.Printer(out=blocks_out)
        t0 = time.perf_counter()
        cli_app.check_blocks(ctx)
        blocks_s = time.perf_counter() - t0
        require("BGZF blocks" in blocks_out.getvalue(), blocks_out.getvalue())
        log(f"check-blocks {blocks_s:.3f} s: "
            f"{blocks_out.getvalue().splitlines()[0]}")
        del ctx, eager

        # (e) time-load and (f) compare-splits (with the refused record's
        # BAM) on a 4 MiB BAM of the same seed at 512 KiB splits: each
        # hadoop-bam leg runs the seqdoop guesser over its whole file (the
        # 40 MiB BAM's was a depth cut, PERF.md §4).
        mid = work / "mid17.bam"
        synth_bam(mid, 4 << 20, seed=8)
        text = run_cli("time-load", "-m", "512KB", str(mid))
        note("record_time_load")
        require("threw" not in text and "partition-start reads matched"
                in text, text)
        require(out["record_time_load"]["prefilter_check_flags"] > 0,
                out["record_time_load"])
        log(f"time-load -m 512KB, 4 MiB BAM: "
            f"{' / '.join(ln for ln in text.splitlines() if ln)}; launches "
            f"{out['record_time_load']}")
        rm = work / "refused_mid17.bam"
        load_cases.write_refused_mid_bam(rm)
        listing = work / "bams17.txt"
        listing.write_text(f"{mid}\n{rm}\n")
        text = run_cli("compare-splits", "-m", "512KB", str(listing))
        note("record_compare_splits")
        require("2 BAMs' splits" in text.splitlines()[0], text)
        require(out["record_compare_splits"]["prefilter_check_flags"] > 0,
                out["record_compare_splits"])
        log(f"compare-splits -m 512KB over the 4 MiB and the refused "
            f"record's BAMs: {text.splitlines()[0]}; launches "
            f"{out['record_compare_splits']}")

        # (g) index-bam of a coordinate-sorted BAM, then load_bam_intervals
        # against a brute-force overlap of the records written.
        sorted_bam = work / "sorted17.bam"
        hdr = read_header(small)
        names = list(hdr.contig_names)
        records = []
        for i in range(60_000):
            ref = 0 if i < 40_000 else 1
            pos = 10_000 + 97 * (i if ref == 0 else i - 40_000)
            n = 60 + i % 91
            flag = 4 if i % 1000 == 7 else 0
            records.append(BamRecord(ref, pos, 60, 0, flag, -1, -1, 0,
                                     f"s{i}", [] if flag else [(n, 0)],
                                     "A" * n, bytes([30]) * n))
        records += [BamRecord(-1, -1, 0, 0, 4, -1, -1, 0, f"u{i}", [], "C",
                              b"\x1e") for i in range(50)]
        write_bam_result(sorted_bam, hdr, records)
        t0 = time.perf_counter()
        err_buf = io.StringIO()
        with contextlib.redirect_stderr(err_buf):
            require(cli.main(["index-bam", str(sorted_bam)]) == 0, "index-bam")
        index_s = time.perf_counter() - t0
        counts = []
        for spec in ("chr1:100k-300k", "chr2", "chr1:1m-1m,chr2:5k-20k"):
            loci = LociSet.parse(spec, hdr)
            got = [r.read_name for r in api.load_bam_intervals(
                sorted_bam, spec, "256KB").collect()]
            want = [r.read_name for r in records if r.ref_id >= 0
                    and not r.is_unmapped
                    and loci.overlaps(names[r.ref_id], r.pos, r.end_pos())]
            require(got == want, f"load_bam_intervals {spec}")
            counts.append(len(got))
        log(f"index-bam of a sorted BAM of {len(records)} records in "
            f"{index_s:.3f} s ({err_buf.getvalue().strip()}); "
            f"load_bam_intervals = the brute-force overlap: {counts} records")

        # (h) count-reads of the refused record's BAM: 601.
        text = run_cli("count-reads", str(rm))
        require("Read counts matched: 601" in text.splitlines(), text)
        text = run_cli("count-reads", "-m", "16KB", str(rm))
        require("Read counts matched: 601" in text.splitlines(), text)
        note("record_count_reads_refused")
        require(out["record_count_reads_refused"]["prefilter_check_flags"] > 0,
                out["record_count_reads_refused"])
        log(f"count-reads of the refused record's BAM: Read counts matched: "
            f"601 at 32 MiB and 16 KiB splits; launches "
            f"{out['record_count_reads_refused']}")
    finally:
        restore()
    log(f"phase 17 kernels held against plain on the record path "
        f"(calls, max_abs_err): {errs}; phase 17 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out, errs


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
    phase_walls: list = []
    phase_t = [time.perf_counter()]

    def phase_done(label: str) -> None:
        """Log the wall of the phase that just ended (from the last mark)."""
        now = time.perf_counter()
        phase_walls.append((label, now - phase_t[0]))
        log(f"phase {label}: {now - phase_t[0]:.1f} s")
        phase_t[0] = now

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

        phase_done("2 (synthetic BAM, kernels)")
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

        phase_done("3 (count-reads)")
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
        # The CPU leg inflates with host zlib: the device inflate's plain
        # versions ran on the first window above (a depth cut: PERF.md §4).
        on_cpu = port.full_check_summary_streaming(
            small, port.Config(device_inflate=False), device="cpu")
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
            f"s, CPU (plain versions on host-zlib windows) {cpu_s:.3f} s")

        phase_done("4 (full-check)")
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
        # Card = CPU on 16 of those reads (2 MiB; the 8 MiB BAM's CPU
        # summary was a depth cut, PERF.md §4).
        long2 = work / "long2.bam"
        synth_bam(long2, 2 << 20, seed=9, unit_reads=8,
                  read_len=(60_000, 110_000))
        long_card = port.full_check_summary_streaming(long2, port.Config(),
                                                      *geo)
        long_cpu = port.full_check_summary_streaming(
            long2, port.Config(), *geo, device="cpu")
        require(summaries_equal(long_card, long_cpu),
                "long-read card and CPU summaries differ")
        long2.unlink()
        log(f"long reads: {long_reads} reads counted exactly on both loops "
            f"through the escape retry; full_spans {deferred} deferred "
            f"re-emissions; card summary equals CPU on a 2 MiB BAM of 16 "
            f"of them")

        phase_done("5 (long reads)")
        resident_launches = resident_phase(
            port, bam, manifest, long_bam, long_manifest, small,
            small_manifest, card, fused_s, classic_s)

        phase_done("6 (resident)")
        load_launches, off_launches, load_cols, small_starts = load_phase(
            port, bam, manifest, long_bam, long_manifest, small, work, card)

        phase_done("7 (load)")
        sharded_launches = sharded_phase(
            port, bam, manifest, summary, fc_s, fused_s, small,
            small_manifest, on_card, work, card)

        phase_done("8 (sharded)")
        agg_launches, agg_ref = agg_phase(port, bam, manifest, small, work,
                                          card, small_starts)

        phase_done("9 (aggregate)")
        split_launches = split_phase(port, bam, manifest, small, work, card,
                                     agg_ref)

        phase_done("10 (splits)")
        keep: dict = {}
        (work / "keep").mkdir(exist_ok=True)
        export_launches = export_phase(
            port, bam, manifest, load_cols, small, small_manifest, work,
            card, keep)
        del load_cols

        phase_done("11 (export)")
        write_rows, write_launches = write_phase(
            port, bam, manifest, small, small_manifest, work, card, keep)

        phase_done("12 (write)")
        serve_launches = serve_phase(
            port, bam, manifest, small, small_manifest, long_bam,
            long_manifest, work, card, agg_ref)
        del agg_ref

        phase_done("13 (serve)")
        fabric_launches = fabric_phase(port, bam, manifest, small,
                                       small_manifest, work, card)

        phase_done("14 (fabric)")
        jobs_launches = jobs_phase(port, bam, manifest, small,
                                   small_manifest, work, card, keep)
        shutil.rmtree(work / "keep", ignore_errors=True)

        phase_done("15 (jobs)")
        host_launches, host_split = host_tokenize_phase(
            port, bam, manifest, small, small_manifest, on_card, on_cpu,
            work, card, fused_s)

        phase_done("16 (host tokenizer)")
        record_launches, record_errs = record_phase(
            port, small, small_manifest, small_starts, work, card)

        phase_done("17 (record path)")
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
                **{path: n[row["name"]]
                   for path, n in serve_launches.items()},
                **{path: n[row["name"]]
                   for path, n in fabric_launches.items()},
                **{path: n[row["name"]]
                   for path, n in jobs_launches.items()},
                **{path: n[row["name"]]
                   for path, n in host_launches.items()},
                **{path: n[row["name"]]
                   for path, n in record_launches.items()},
            }
            if row["name"] in record_errs:
                calls, err = record_errs[row["name"]]
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["record_path_calls_held"] = calls
            if row["name"] == "tokenize":
                # The host engine of the same entropy phase (phase 16).
                row["host_engine"] = host_split
            if row["name"] in FABRIC_KERNELS:
                row["launches_note"] = FABRIC_NOTE + " " + JOBS_NOTE
            else:
                row["launches_note"] = JOBS_NOTE
        for row in write_rows:
            row["launches_by_path"] = {
                path: n[row["name"]]
                for path, n in (*write_launches.items(),
                                *serve_launches.items(),
                                *fabric_launches.items(),
                                *jobs_launches.items(),
                                *host_launches.items(),
                                *record_launches.items())}
            row["launches_note"] = JOBS_NOTE
        log("phase walls (s): " + ", ".join(
            f"{label} {wall:.1f}" for label, wall in phase_walls))
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
