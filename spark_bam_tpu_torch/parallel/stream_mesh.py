"""Mesh-sharded streaming workloads: one BAM across every device, and
across processes (reference ``spark_bam_tpu/parallel/stream_mesh.py``).

Row discipline (any row computable from ``(path, metas)`` alone, no
sequential carry, which is what lets processes split the file):

- ``window_plan`` groups consecutive BGZF blocks into ≈window-sized
  uncompressed runs; row *g* OWNS group *g*'s uncompressed span, and the
  owned spans tile ``[0, total)`` exactly;
- each row's buffer extends past its owned span with following blocks
  until ≥ ``halo`` lookahead bytes are present (re-inflated overlap,
  traded for seam independence);
- a chain that outruns even the halo *escapes*: the step that holds it
  keeps its totals out of the result, and its rows are re-derived exactly
  on the host over a geometrically grown buffer (verdicts by the native
  tri-state walk, ``PATCH_CHUNK_POSITIONS`` candidates at a time; flags by
  ``check/vectorized.check_flat``); an input dirty nearly everywhere, or a
  buffer that outgrows the adversarial cap, re-runs through
  ``StreamChecker``'s deferral-exact path on one device.

Each row is inflated on its device (``stage_group_device`` →
``inflate_window_raw``: the ``tokenize`` and ``lz77_resolve`` kernels and
the assembly; under ``Config.inflate`` ``tokenize=host``,
``tokenize_group`` → ``inflate_window_tokens``: the host tokenizer's
packed planes, ``lz77_resolve`` and the assembly) straight into the
step's row tensor there; with ``device_inflate=False`` rows come from
the host inflate through pinned memory. A device tokenizer verdict of
False, or a row the host tokenizer refuses, re-inflates that row on the
host and is counted in ``tokenize_demotions``; any other failure raises (the
reference re-inflates after any device error). Steps are
double-buffered: a worker thread assembles step i + 1 into the other of
two row buffers per device, on its own CUDA stream, after the step that
last read that buffer (an event), while step i runs.

Workloads:

- ``count_reads_sharded``: the count step (``prefilter_check_flags``
  under the funnel);
- ``check_bam_sharded``: verdicts against the ``.records`` truth at every
  uncompressed position, the confusion matrix reduced per step;
- ``full_check_summary_sharded``: the full-check report reduced on the
  devices row by row (``full_check_flags``), only per-step totals and
  (rows, K) site lists coming back;
- ``host_shard_plan``: which bytes each process of a run will read.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Callable

import numpy as np
import torch

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bam.index_records import read_records_table
from spark_bam_tpu_torch.bgzf.block import MAX_BLOCK_SIZE
from spark_bam_tpu_torch.bgzf.flat import inflate_blocks, metas_block_table
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.check.flags import (
    BIT,
    FLAG_NAMES,
    bit_counts,
    considered_mask,
    num_failing_fields,
)
from spark_bam_tpu_torch.check.vectorized import check_flat
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.native import build as native
from spark_bam_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_steps
from spark_bam_tpu_torch.tpu.checker import (
    PAD,
    inflate_window_raw,
    inflate_window_tokens,
)
from spark_bam_tpu_torch.tpu.inflate import (
    TokenizeError,
    open_planned,
    stage_group_device,
    tokenize_group,
    window_plan,
)
from spark_bam_tpu_torch.tpu.stream_check import (
    StreamChecker,
    _next_pow2,
    full_check_summary_streaming,
    pad_contig_lengths,
)

#: Candidate positions a row's verdict patch checks at a time (its
#: per-position state is 9 bytes each).
PATCH_CHUNK_POSITIONS = 1 << 20


def _plan_rows(metas: list, fresh: int, n_global: int, num_processes: int):
    """The row-planning arithmetic shared by the sharded engine and
    ``host_shard_plan`` (a plan matches what the engine reads by
    construction): block groups, each group's first block index and
    uncompressed size / flat start, and the per-process row count (global
    rows padded to a multiple of the device count, so every process runs
    the same number of steps and enters every all-reduce)."""
    groups = window_plan(metas, fresh)
    sizes = np.array(
        [sum(m.uncompressed_size for m in g) for g in groups], dtype=np.int64
    )
    flat_starts = np.zeros(len(groups), dtype=np.int64)
    first_block = np.zeros(len(groups), dtype=np.int64)
    if len(groups):
        np.cumsum(sizes[:-1], out=flat_starts[1:])
        np.cumsum([len(g) for g in groups[:-1]], out=first_block[1:])
    n_rows = -(-max(len(groups), 1) // n_global) * n_global
    per_proc = n_rows // num_processes
    return groups, sizes, flat_starts, first_block, per_proc


def _halo_block_range(metas: list, groups: list, first_block, g0: int,
                      g1: int, halo: int) -> tuple[int, int]:
    """Block index range [b0, b1) covering groups [g0, g1) plus trailing
    blocks until ≥ ``halo`` lookahead bytes: a row's extension and a plan's
    per-host read range."""
    b0 = int(first_block[g0])
    b1 = b0 + sum(len(groups[g]) for g in range(g0, g1))
    extra = 0
    while b1 < len(metas) and extra < halo:
        extra += metas[b1].uncompressed_size
        b1 += 1
    return b0, b1


def _step_rows(kernel_window: int, n_local: int, chunk_bytes: int) -> int:
    """Rows a process assembles per step: a multiple of its device count
    within the ``chunk_bytes`` budget of rows at stride W + PAD."""
    return n_local * max(
        1, chunk_bytes // ((kernel_window + PAD) * max(n_local, 1)))


class _Slot:
    """One step's row tensors on every device: (k/n, W + PAD) u8 rows and,
    with truth, (k/n, W) bool truth rows; ``free`` holds, per device, the
    event after the step that last read them."""

    def __init__(self, mesh: Mesh, rows: int, kw: int, with_truth: bool):
        self.windows = [torch.zeros((rows, kw + PAD), dtype=torch.uint8,
                                    device=d) for d in mesh.devices]
        self.truth = ([torch.zeros((rows, kw), dtype=torch.bool, device=d)
                       for d in mesh.devices] if with_truth else None)
        self.free = [None] * mesh.n_local
        self.ready = [None] * mesh.n_local


class _StepArgs:
    """One assembled step: per-device row shards and the host columns."""

    def __init__(self, slot: _Slot, ns, eofs, los, owns):
        self.windows = slot.windows
        self.truth = slot.truth
        self.ns, self.at_eofs, self.los, self.owns = ns, eofs, los, owns


class _ShardedStream:
    """Shared plumbing: plan the block groups, assemble this process's row
    slice into mesh-wide steps (double-buffered), and hold the contig
    table. ``num_processes``/``process_id`` default to the mesh's; given,
    they plan the slice of a process of that layout (the mesh then spans
    the whole layout, as a JAX mesh does)."""

    def __init__(
        self,
        path,
        config: Config,
        mesh: Mesh | None,
        window_uncompressed: int | None,
        halo: int | None,
        metas: list | None,
        with_truth: bool = False,
        num_processes: int | None = None,
        process_id: int | None = None,
        chunk_bytes: int = 192 << 20,
    ):
        self.path = path
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_global = self.mesh.n_global
        self.num_processes = (self.mesh.num_processes if num_processes is None
                              else num_processes)
        self.process_id = (self.mesh.process_id if process_id is None
                           else process_id)

        header = read_header(path)
        self.num_contigs = len(header.contig_lengths)
        self.lengths = pad_contig_lengths(header.contig_lengths)
        self.lengths_t = torch.from_numpy(self.lengths)
        self.header_end = header.uncompressed_size

        self.fresh = window_uncompressed or config.window_size
        halo = config.halo_size if halo is None else halo
        self.halo = min(halo, self.fresh // 2)
        self.metas = list(blocks_metadata(path)) if metas is None else metas
        (
            self.groups, self.sizes, self.flat_starts, self.first_block,
            self.per_proc,
        ) = _plan_rows(self.metas, self.fresh, self.n_global,
                       self.num_processes)
        self.total = int(self.sizes.sum())
        # Row buffer bound: owned span (≤ fresh, or one oversized block) +
        # halo + ≤ one block of halo-extension overshoot.
        row_bound = (max(self.fresh, MAX_BLOCK_SIZE) + self.halo
                     + MAX_BLOCK_SIZE)
        self.kernel_window = _next_pow2(
            min(row_bound, max(self.total, 1 << 16)))
        self.device_inflate = config.device_inflate is not False
        self.host_tokenize = (
            config.inflate_config.resolve_tokenize() == "host")
        self.n_local = self.n_global // self.num_processes
        self.step_rows_local = _step_rows(self.kernel_window, self.n_local,
                                          chunk_bytes)
        if self.per_proc:
            self.step_rows_local = min(self.step_rows_local, self.per_proc)
        self.with_truth = with_truth
        self.tokenize_demotions = 0

    # ------------------------------------------------------------- assembly
    def _row_range(self, g: int) -> tuple[list, int, bool, int]:
        """Global row ``g``'s blocks, their bytes, whether they reach EOF,
        and its owned length."""
        b0, b1 = _halo_block_range(self.metas, self.groups, self.first_block,
                                   g, g + 1, self.halo)
        run = self.metas[b0:b1]
        n = sum(m.uncompressed_size for m in run)
        at_eof = b1 == len(self.metas)
        own = (n if at_eof and g == len(self.groups) - 1
               else int(self.sizes[g]))
        return run, n, at_eof, own

    def _host_row(self, ch, run, out_row) -> None:
        """Inflate a row on the host into ``out_row`` through pinned
        memory (zeros past its bytes)."""
        data = torch.from_numpy(inflate_blocks(ch, run, threads=8).data)
        if out_row.is_cuda:
            data = data.pin_memory()
        out_row[: data.numel()].copy_(data, non_blocking=True)
        out_row[data.numel():].zero_()

    def _device_row(self, ch, run, n: int, out_row):
        """Inflate a row on its device into ``out_row``; returns the device
        tokenizer's () verdict, or None under ``tokenize=host``, where a
        row the host tokenizer refuses goes to the host inflate (counted)."""
        dev = out_row.device
        carry = torch.zeros(1, dtype=torch.uint8, device=dev)
        if self.host_tokenize:
            try:
                group = tokenize_group(ch, run)
            except TokenizeError:
                self.tokenize_demotions += 1
                self._host_row(ch, run, out_row)
                return None
            padded, _ = inflate_window_tokens(
                group.to_device(dev),
                torch.from_numpy(group.out_lens).to(dev), carry, 0, n,
                window=self.kernel_window, halo=1)
            out_row.copy_(padded)
            return None
        staged, clens, usizes, _ = stage_group_device(ch, run, dev)
        exp = np.zeros(staged.shape[0], dtype=np.int32)
        exp[: len(usizes)] = usizes
        padded, _, tok_ok = inflate_window_raw(
            staged, clens, torch.from_numpy(exp).to(dev), carry, 0, n,
            window=self.kernel_window, halo=1)
        out_row.copy_(padded)
        return tok_ok

    def _assemble(self, ch, c0: int, header_clamp: bool, slot: _Slot,
                  truth_flats, streams):
        """One step's rows into ``slot`` (padding rows are all zero and own
        nothing) and its host columns."""
        k = self.step_rows_local
        ns = np.zeros(k, dtype=np.int64)
        eofs = np.zeros(k, dtype=bool)
        los = np.zeros(k, dtype=np.int64)
        owns = np.zeros(k, dtype=np.int64)
        he = self.header_end if header_clamp else 0
        per = k // self.mesh.n_local
        for d, dev in enumerate(self.mesh.devices):
            stream = streams[d]
            if stream is not None:
                if slot.free[d] is not None:
                    stream.wait_event(slot.free[d])
                ctx = torch.cuda.stream(stream)
            else:
                ctx = nullcontext()
            with ctx:
                rows, oks = slot.windows[d], []
                for r in range(per):
                    j = d * per + r
                    g = self.process_id * self.per_proc + c0 + j
                    if c0 + j >= self.per_proc or g >= len(self.groups):
                        rows[r].zero_()
                        if slot.truth is not None:
                            slot.truth[d][r].zero_()
                        continue
                    run, n, at_eof, own = self._row_range(g)
                    base = int(self.flat_starts[g])
                    if self.device_inflate:
                        ok = self._device_row(ch, run, n, rows[r])
                        if ok is not None:
                            oks.append((r, run, ok))
                    else:
                        self._host_row(ch, run, rows[r])
                    ns[j], eofs[j], owns[j] = n, at_eof, own
                    los[j] = min(max(he - base, 0), own)
                    if slot.truth is not None:
                        tr = slot.truth[d][r]
                        tr.zero_()
                        i0, i1 = np.searchsorted(truth_flats, (base, base + n))
                        tr[torch.from_numpy(truth_flats[i0:i1] - base).to(
                            dev)] = True
                if oks:
                    # One read-back of the tokenizer verdicts per device.
                    verdicts = torch.stack([ok for _, _, ok in oks]).cpu()
                    for (r, run, _), good in zip(oks, verdicts.tolist()):
                        if not good:
                            self.tokenize_demotions += 1
                            self._host_row(ch, run, rows[r])
                if stream is not None:
                    slot.ready[d] = torch.cuda.Event()
                    slot.ready[d].record(stream)
        return _StepArgs(slot, ns, eofs, los, owns)

    def batches(self, header_clamp: bool, truth_flats=None):
        """Yield ``(args, positions_done, c0)`` per step (``c0`` = the
        step's first process-local row: row ``j`` of the step is global
        group ``process_id * per_proc + c0 + j``), assembling the next
        step on a worker thread while the caller's step runs: from the
        second step on, since the first may capture CUDA graphs."""
        if not self.per_proc:
            return
        per = self.step_rows_local // self.mesh.n_local
        kw = self.kernel_window
        slots = [_Slot(self.mesh, per, kw, self.with_truth) for _ in range(2)]
        streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                   for d in self.mesh.devices]
        steps = list(range(0, self.per_proc, self.step_rows_local))
        with open_planned(self.path, self.metas) as ch, \
                ThreadPoolExecutor(1) as pool:
            def submit(i):
                return pool.submit(self._assemble, ch, steps[i], header_clamp,
                                   slots[i % 2], truth_flats, streams)

            pending = submit(0)
            try:
                for i, c0 in enumerate(steps):
                    args = pending.result()
                    slot = slots[i % 2]
                    for d, dev in enumerate(self.mesh.devices):
                        if slot.ready[d] is not None:
                            torch.cuda.current_stream(dev).wait_event(
                                slot.ready[d])
                    # No assembly runs beside the first step, which may
                    # capture CUDA graphs (the count step's runners).
                    if 0 < i < len(steps) - 1:
                        pending = submit(i + 1)
                    # Highest global row completed this step (process-major
                    # row order: the last process owns the final groups).
                    g_hi = min(
                        (self.num_processes - 1) * self.per_proc
                        + c0 + self.step_rows_local,
                        len(self.groups),
                    ) - 1
                    done = int(self.flat_starts[g_hi] + self.sizes[g_hi])
                    yield args, done, c0
                    # The caller has queued the step that reads this slot.
                    for d, dev in enumerate(self.mesh.devices):
                        if dev.type == "cuda":
                            slot.free[d] = torch.cuda.Event()
                            slot.free[d].record(
                                torch.cuda.current_stream(dev))
                    if i == 0 and len(steps) > 1:
                        pending = submit(1)
            finally:
                pending.cancel()
                pool.shutdown(wait=True)


def _mostly_dirty(dirty: list, steps: int) -> bool:
    """The escape-everywhere guard: stop burning device work when the input
    is dirty nearly everywhere (undersized halo): all dirty at 4 steps, or
    ≥ 90 % dirty once 8 have run (a lone clean step must not disable the
    guard). Every process decides alike: it reads all-reduced totals."""
    return (steps >= 4 and len(dirty) == steps) or (
        steps >= 8 and len(dirty) * 10 >= steps * 9
    )


class _RowGrowth:
    """The grown-buffer protocol of the exact row patches: global row
    ``g``'s block range extended with halo lookahead, re-inflated at
    geometrically doubled spans until the resolver is satisfied, with one
    adversarial-growth cap at ``(reads_to_check + 2) × max_read_size`` of
    lookahead."""

    def __init__(self, st: _ShardedStream, g: int):
        self.st = st
        self.lo_abs = int(st.flat_starts[g])
        self.hi_abs = self.lo_abs + int(st.sizes[g])
        self.b0 = int(st.first_block[g])
        b_end = (int(st.first_block[g + 1]) if g + 1 < len(st.groups)
                 else len(st.metas))
        self.nblocks = len(st.metas)
        self.cap_bytes = (st.config.reads_to_check + 2) \
            * st.config.max_read_size
        self.b1 = min(b_end + max(1, st.halo // MAX_BLOCK_SIZE + 1),
                      self.nblocks)

    def view(self, ch):
        return inflate_blocks(ch, self.st.metas[self.b0: self.b1], threads=8)

    @property
    def at_eof(self) -> bool:
        return self.b1 == self.nblocks

    def grow(self, view_size: int) -> bool:
        """Double the block span; False once lookahead exceeds the cap."""
        if view_size - (self.hi_abs - self.lo_abs) > self.cap_bytes:
            return False
        self.b1 = min(self.b0 + 2 * (self.b1 - self.b0), self.nblocks)
        return True


def _exact_row_true_positions(st: _ShardedStream, g: int, lo_clamp: int,
                              ch):
    """Exact absolute record starts inside global row ``g``'s owned span
    from ``lo_clamp`` on: the native tri-state walk over a geometrically
    grown buffer, re-checking after each growth only the candidates still
    uncertain. The escape-localized patch: a dirty row re-derives from
    ``(path, metas)`` alone. ``ch`` is an open channel on ``st.path`` (one
    serves every row a caller patches). None past the growth cap (callers
    take the whole-file path)."""
    rg = _RowGrowth(st, g)
    lo_eval = max(rg.lo_abs, lo_clamp)
    if lo_eval >= rg.hi_abs:
        return np.empty(0, dtype=np.int64)
    lens = st.lengths[: st.num_contigs]
    # Candidates walk the owned span in chunks, so per-position state
    # (int64 candidate + u8 verdict, 9 bytes) stays one chunk's; ``rg`` and
    # its view persist across chunks, so growth won by an early chunk
    # serves the rest of the row.
    obs.count("mesh.patch_rows")
    view = rg.view(ch)
    hits: list[np.ndarray] = []
    for c_lo in range(lo_eval, rg.hi_abs, PATCH_CHUNK_POSITIONS):
        c_hi = min(c_lo + PATCH_CHUNK_POSITIONS, rg.hi_abs)
        cand_abs = np.arange(c_lo, c_hi, dtype=np.int64)
        res = np.full(len(cand_abs), 2, dtype=np.uint8)
        obs.count("mesh.patch_chunks")
        obs.observe("mesh.patch_chunk_positions", len(cand_abs))
        while True:
            unc = np.flatnonzero(res == 2)
            res[unc] = native.eager_check_window_native(
                view.data, cand_abs[unc] - rg.lo_abs, lens,
                reads_to_check=st.config.reads_to_check, exact_eof=rg.at_eof)
            if rg.at_eof or not (res == 2).any():
                hits.append(cand_abs[res == 1])
                break
            if not rg.grow(view.size):
                return None
            view = rg.view(ch)
    return np.concatenate(hits) if hits else np.empty(0, dtype=np.int64)


def _exact_row_flags(st: _ShardedStream, g: int, ch):
    """Exact ``(fail_mask, reads_before)`` over global row ``g``'s owned
    span: the full flag pass of ``check_flat`` (the tri-state walk gives
    verdicts only) over a buffer grown until every owned lane is exact and
    unescaped (or EOF); None past the cap."""
    rg = _RowGrowth(st, g)
    span = rg.hi_abs - rg.lo_abs
    if span <= 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    lens = st.lengths[: st.num_contigs]
    while True:
        view = rg.view(ch)
        res = check_flat(view.data, lens, at_eof=rg.at_eof,
                         reads_to_check=st.config.reads_to_check)
        need = (res.escaped | ~res.exact)[:span]
        if rg.at_eof or not need.any():
            return (np.asarray(res.fail_mask[:span], dtype=np.int32),
                    np.asarray(res.reads_before[:span], dtype=np.int32))
        if not rg.grow(view.size):
            return None


def _step_global_rows(st: _ShardedStream, c0: int) -> list[int]:
    """Global groups a step at local row ``c0`` covered across ALL
    processes (fill rows excluded): the rows a dirty-step patch recomputes
    so that every process lands the same result."""
    rows = []
    for p in range(st.num_processes):
        for j in range(c0, min(c0 + st.step_rows_local, st.per_proc)):
            g = p * st.per_proc + j
            if g < len(st.groups):
                rows.append(g)
    return rows


def _coords(mesh: Mesh | None, num_processes, process_id) -> Mesh:
    """The mesh of an entry point (default: every CUDA device), whose
    process coordinates the caller's, when given, must match."""
    mesh = mesh if mesh is not None else make_mesh()
    for name, got, want in (("num_processes", num_processes,
                             mesh.num_processes),
                            ("process_id", process_id, mesh.process_id)):
        if got is not None and got != want:
            raise ValueError(f"{name}={got}, but the mesh's is {want}")
    return mesh


def count_reads_sharded(
    path,
    config: Config = Config(),
    mesh: Mesh | None = None,
    window_uncompressed: int | None = None,
    halo: int | None = None,
    metas: list | None = None,
    progress: Callable[[int, int, int], None] | None = None,
    stats_out: dict | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    chunk_bytes: int = 192 << 20,
) -> int:
    """Record count of ``path`` across ``mesh`` (default: every CUDA
    device; under ``torch.distributed`` the mesh spans the processes, each
    assembles its own rows, and every process gets the reduced count).
    ``progress(steps_done, positions_done, total_positions)`` fires after
    each step. ``stats_out`` receives ``steps``, ``escapes``, ``fallback``,
    ``patched_steps``, ``rows`` and ``tokenize_demotions``: escaped steps
    re-derive exactly on the host (``patched_steps``); ``fallback`` is
    True when the whole-file exact path ran instead."""
    mesh = _coords(mesh, num_processes, process_id)
    st = _ShardedStream(path, config, mesh, window_uncompressed, halo, metas,
                        chunk_bytes=chunk_bytes)
    step = mesh_steps(st.mesh).count_step(config.reads_to_check,
                                          config.funnel_enabled())
    count = escapes = steps = 0
    dirty: list[int] = []   # local row offsets (c0) of escaped steps
    whole_file = False
    batches = st.batches(header_clamp=True)
    try:
        for a, done, c0 in batches:
            with obs.span("mesh.step", workload="count", c0=c0):
                totals = step(a.windows, a.ns, a.at_eofs, a.los, a.owns,
                              st.lengths_t, st.num_contigs)
                esc = int(totals[1])
            steps += 1
            obs.count("mesh.steps")
            if esc:
                obs.count("mesh.dirty_steps")
                obs.count("mesh.escapes", esc)
                # The dirty step's totals are untrusted (an escaped chain's
                # verdict can be wrong either way); every other step stands.
                escapes += esc
                dirty.append(c0)
            else:
                count += int(totals[0])
            if progress is not None:
                progress(steps, done, st.total)
            if _mostly_dirty(dirty, steps):
                whole_file = True
                break
    finally:
        batches.close()

    patched = None
    if dirty and not whole_file:
        patched = 0
        rows = {g for c0 in dirty for g in _step_global_rows(st, c0)}
        with open_channel(path) as ch:
            for g in rows:
                pos = _exact_row_true_positions(st, g, st.header_end, ch)
                if pos is None:
                    patched = None   # adversarial lookahead growth
                    break
                patched += len(pos)

    if stats_out is not None:
        stats_out.update(
            steps=steps, escapes=escapes,
            fallback=bool(escapes) and patched is None,
            patched_steps=0 if patched is None else len(dirty),
            rows=len(st.groups), tokenize_demotions=st.tokenize_demotions,
        )
    if escapes and patched is None:
        # Whole-file exact path on one device (every process computes the
        # same count), reusing this pass's block scan.
        return StreamChecker(
            path, config, window_uncompressed=st.fresh, halo=st.halo,
            device=st.mesh.devices[0], metas=st.metas,
        ).count_reads()
    return count + (patched or 0)


def full_check_summary_sharded(
    path,
    config: Config = Config(),
    mesh: Mesh | None = None,
    window_uncompressed: int | None = None,
    halo: int | None = None,
    metas: list | None = None,
    progress: Callable[[int, int, int], None] | None = None,
    k_positions: int = 4096,
    stats_out: dict | None = None,
    chunk_bytes: int = 192 << 20,
) -> dict:
    """The full-check report across the mesh, reduced on the devices row by
    row: per-flag totals, the considered count, and the critical and
    two-check sites with their masks; the return shape of
    ``full_check_summary_streaming`` plus ``devices``.

    A step with deferred lanes (escaped or edge-inexact masks) keeps its
    results out and its rows re-derive exactly on the host. The
    single-device streaming summary (on the mesh's first device) is the
    fallback for nearly-all-dirty inputs, adversarial growth, and rows
    with more than ``k_positions`` sites of a kind; ``devices`` is 1 then
    and ``stats_out["fallback"]`` True. One process only."""
    mesh = mesh if mesh is not None else make_mesh()
    if mesh.num_processes > 1:
        raise NotImplementedError(
            "full_check_summary_sharded is single-process only (the site "
            "lists of every process's rows would need an all-gather of "
            "variable-length lists); run it on one process")
    st = _ShardedStream(path, config, mesh, window_uncompressed, halo, metas,
                        chunk_bytes=chunk_bytes)
    step = mesh_steps(st.mesh).full_step(config.reads_to_check, k_positions)
    n_flags = len(FLAG_NAMES)
    agg = np.zeros(5 + n_flags, dtype=np.int64)
    crit_pos: list[np.ndarray] = []
    crit_mask: list[np.ndarray] = []
    two_pos: list[np.ndarray] = []
    two_mask: list[np.ndarray] = []
    fallback = False
    defers = 0
    dirty: list[int] = []
    steps = 0
    batches = st.batches(header_clamp=False)
    try:
        for a, done, c0 in batches:
            with obs.span("mesh.step", workload="full_check", c0=c0):
                totals, ci, cm, ti, tm = step(
                    a.windows, a.ns, a.at_eofs, a.los, a.owns, st.lengths_t,
                    st.num_contigs)
                deferred = int(totals[4])
            steps += 1
            obs.count("mesh.steps")
            if deferred:
                obs.count("mesh.dirty_steps")
                # Deferred lanes: this step's masks are not exact.
                defers += int(totals[4])
                dirty.append(c0)
                if _mostly_dirty(dirty, steps):
                    fallback = True
                    break
                if progress is not None:
                    progress(steps, done, st.total)
                continue
            agg += totals
            for j in range(ci.shape[0]):
                g = c0 + j
                if g >= len(st.groups):
                    continue   # padding row: no sites by construction
                base = int(st.flat_starts[g])
                for idx, masks, acc_p, acc_m in (
                    (ci[j], cm[j], crit_pos, crit_mask),
                    (ti[j], tm[j], two_pos, two_mask),
                ):
                    sel = idx >= 0
                    if sel.any():
                        acc_p.append(base + idx[sel].astype(np.int64))
                        acc_m.append(masks[sel].astype(np.int32))
            if progress is not None:
                progress(steps, done, st.total)
    finally:
        batches.close()

    if dirty and not fallback:
        bit0 = int(BIT["tooFewFixedBlockBytes"])
        rows = {g for c0 in dirty for g in _step_global_rows(st, c0)}
        with open_channel(path) as ch:
            for g in sorted(rows):
                out = _exact_row_flags(st, g, ch)
                if out is None:
                    fallback = True   # adversarial lookahead growth
                    break
                fm, rb = out
                base = int(st.flat_starts[g])
                agg[0] += int((fm == 0).sum())
                agg[1] += int(((fm == bit0) & (rb == 0)).sum())
                considered = considered_mask(fm, rb)
                agg[5:] += bit_counts(fm[considered])
                nf = num_failing_fields(fm, rb)
                ones = np.flatnonzero(considered & (nf == 1))
                twos = np.flatnonzero(considered & (nf == 2))
                agg[2] += len(ones)
                agg[3] += len(twos)
                if len(ones):
                    crit_pos.append(base + ones)
                    crit_mask.append(fm[ones].astype(np.int32))
                if len(twos):
                    two_pos.append(base + twos)
                    two_mask.append(fm[twos].astype(np.int32))

    n_crit = sum(map(len, crit_pos))
    n_two = sum(map(len, two_pos))
    if not fallback and (n_crit != int(agg[2]) or n_two != int(agg[3])):
        fallback = True   # a row overflowed its site list
    if stats_out is not None:
        stats_out.update(
            steps=steps, fallback=fallback, defers=defers,
            patched_steps=0 if fallback else len(dirty),
            tokenize_demotions=st.tokenize_demotions,
        )
    if fallback:
        out = full_check_summary_streaming(
            path, config, window_uncompressed=st.fresh, halo=st.halo,
            device=st.mesh.devices[0], metas=st.metas,
        )
        out["devices"] = 1
        return out

    def cat(parts, dtype):
        return np.concatenate(parts) if parts else np.empty(0, dtype=dtype)

    cp, cm_ = cat(crit_pos, np.int64), cat(crit_mask, np.int32)
    tp_, tm_ = cat(two_pos, np.int64), cat(two_mask, np.int32)
    if dirty:
        # Patched rows appended their sites after the clean steps': restore
        # ascending file order.
        o = np.argsort(cp, kind="stable")
        cp, cm_ = cp[o], cm_[o]
        o = np.argsort(tp_, kind="stable")
        tp_, tm_ = tp_[o], tm_[o]
    return {
        "per_flag": {name: int(agg[5 + i])
                     for i, name in enumerate(FLAG_NAMES)},
        # Passes and bare at-EOF markers are the only owned positions not
        # considered: the total is derived, no position-scale counter.
        "considered": st.total - int(agg[0]) - int(agg[1]),
        "critical_positions": cp,
        "critical_masks": cm_,
        "two_check_positions": tp_,
        "two_check_masks": tm_,
        "positions": st.total,
        "devices": st.n_global,
    }


def host_shard_plan(
    path,
    num_hosts: int,
    devices_per_host: int,
    config: Config = Config(),
    window_uncompressed: int | None = None,
    halo: int | None = None,
    metas: list | None = None,
) -> list[dict]:
    """Each host's IO footprint in a ``num_hosts × devices_per_host``
    sharded run, before any device comes up: ``host``, ``groups`` (owned
    group range, end-exclusive), ``compressed_range`` (the file bytes it
    reads, its trailing halo overlap included) and ``uncompressed`` (owned
    flat bytes). Owned ranges partition the file; the engine's own row
    arithmetic makes the plan exact."""
    fresh = window_uncompressed or config.window_size
    h = config.halo_size if halo is None else halo
    h = min(h, fresh // 2)
    metas = list(blocks_metadata(path)) if metas is None else metas
    groups, sizes, _flat_starts, first_block, per_proc = _plan_rows(
        metas, fresh, num_hosts * devices_per_host, num_hosts)
    plan = []
    for p in range(num_hosts):
        g0 = min(p * per_proc, len(groups))
        g1 = min((p + 1) * per_proc, len(groups))
        if g0 == g1:
            plan.append({"host": p, "groups": (g0, g0),
                         "compressed_range": (0, 0), "uncompressed": 0})
            continue
        b0, b1 = _halo_block_range(metas, groups, first_block, g0, g1, h)
        lo = metas[b0].start
        hi = metas[b1 - 1].start + metas[b1 - 1].compressed_size
        plan.append({
            "host": p,
            "groups": (g0, g1),
            "compressed_range": (int(lo), int(hi)),
            "uncompressed": int(sizes[g0:g1].sum()),
        })
    return plan


def _truth_flats(path, records_path, metas) -> np.ndarray:
    """The ``.records`` ground truth as sorted absolute flat offsets."""
    records_path = (str(path) + ".records" if records_path is None
                    else records_path)
    blocks, offs = read_records_table(records_path)
    metas = list(blocks_metadata(path)) if metas is None else metas
    block_starts, block_flat = metas_block_table(metas)
    idx = np.searchsorted(block_starts, blocks)
    if len(idx) and (idx.max() >= len(block_starts)
                     or not np.array_equal(block_starts[idx], blocks)):
        raise ValueError(f"{records_path}: block positions not in {path}'s "
                         "block table (stale sidecar?)")
    return np.sort(block_flat[idx] + offs)


def check_bam_sharded(
    path,
    config: Config = Config(),
    mesh: Mesh | None = None,
    records_path=None,
    window_uncompressed: int | None = None,
    halo: int | None = None,
    metas: list | None = None,
    progress: Callable[[int, int, int], None] | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    stats_out: dict | None = None,
    chunk_bytes: int = 192 << 20,
) -> dict:
    """check-bam across the mesh: the checker's verdict against the
    ``.records`` truth at every uncompressed position (header bytes
    included), the confusion matrix reduced per step. Returns
    ``{"true_positives", "false_positives", "false_negatives",
    "true_negatives", "positions", "devices"}``; escaped steps re-derive
    exactly on the host, and the whole-file exact path on one device
    (``devices`` 1) takes nearly-all-dirty inputs. ``stats_out`` receives
    ``steps``, ``fallback``, ``patched_steps`` and
    ``tokenize_demotions``."""
    mesh = _coords(mesh, num_processes, process_id)
    st = _ShardedStream(path, config, mesh, window_uncompressed, halo, metas,
                        with_truth=True, chunk_bytes=chunk_bytes)
    truth_flats = _truth_flats(path, records_path, st.metas)
    step = mesh_steps(st.mesh).confusion_step(config.reads_to_check,
                                              config.funnel_enabled())
    # [tp, fp, fn, escapes]: record-scale counters; positions and true
    # negatives follow from the owned spans, which tile [0, total).
    agg = np.zeros(4, dtype=np.int64)
    steps = 0
    dirty: list[int] = []
    whole_file = False
    batches = st.batches(header_clamp=False, truth_flats=truth_flats)
    try:
        for a, done, c0 in batches:
            with obs.span("mesh.step", workload="check_bam", c0=c0):
                totals = step(a.windows, a.ns, a.at_eofs, a.truth, a.los,
                              a.owns, st.lengths_t, st.num_contigs)
                escaped = int(totals[3])
            steps += 1
            obs.count("mesh.steps")
            if escaped:
                obs.count("mesh.dirty_steps")
                dirty.append(c0)
            else:
                agg += totals
            if progress is not None:
                progress(steps, done, st.total)
            if _mostly_dirty(dirty, steps):
                whole_file = True
                break
    finally:
        batches.close()

    if dirty and not whole_file:
        rows = {g for c0 in dirty for g in _step_global_rows(st, c0)}
        with open_channel(path) as ch:
            for g in rows:
                pos = _exact_row_true_positions(st, g, 0, ch)
                if pos is None:
                    whole_file = True   # adversarial lookahead growth
                    break
                lo = int(st.flat_starts[g])
                hi = lo + int(st.sizes[g])
                i0, i1 = np.searchsorted(truth_flats, (lo, hi))
                t = truth_flats[i0:i1]
                tp_g = int(np.isin(pos, t).sum())
                agg[0] += tp_g
                agg[1] += len(pos) - tp_g
                agg[2] += len(t) - tp_g
    if stats_out is not None:
        stats_out.update(
            steps=steps, fallback=whole_file,
            patched_steps=0 if whole_file else len(dirty),
            tokenize_demotions=st.tokenize_demotions,
        )
    if whole_file:
        stats = _check_bam_exact(path, config, st, truth_flats)
        stats["devices"] = 1   # the exact fallback runs on one device
        return stats
    tp, fp, fn = int(agg[0]), int(agg[1]), int(agg[2])
    return {
        "true_positives": tp,
        "false_positives": fp,
        "false_negatives": fn,
        "true_negatives": st.total - tp - fp - fn,
        "positions": st.total,
        "devices": st.n_global,
    }


def _check_bam_exact(path, config, st: _ShardedStream, truth_flats) -> dict:
    """The whole-file fallback: predicted starts from the deferral-exact
    single-device spans, confusion by set arithmetic."""
    checker = StreamChecker(path, config, window_uncompressed=st.fresh,
                            halo=st.halo, device=st.mesh.devices[0],
                            metas=st.metas)
    parts = [base + np.flatnonzero(v) for base, v in checker.spans()]
    pred = (np.sort(np.concatenate(parts)) if parts
            else np.empty(0, dtype=np.int64))
    tp = int(np.isin(pred, truth_flats).sum())
    fp = len(pred) - tp
    fn = len(truth_flats) - tp
    return {
        "true_positives": tp,
        "false_positives": fp,
        "false_negatives": fn,
        "true_negatives": st.total - tp - fp - fn,
        "positions": st.total,
    }
