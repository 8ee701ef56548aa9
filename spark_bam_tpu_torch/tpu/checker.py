"""Record-boundary checker over one window (reference ``spark_bam_tpu/tpu/
checker.py``), in two forms that give the same verdicts:

- the funnel (``funnel=True``, the count path): stage 0 screens every
  offset with the fixed-block prefilter and compacts the survivors into a
  fixed-capacity lane buffer in the same launch (the CUDA kernel
  ``prefilter_check_flags``); they get their full 19-bit mask from
  word-level hierarchical tables and walk ``reads_to_check`` chained
  records;
- the full pass (``funnel=False``, full-check's per-position masks): the
  CUDA kernel ``full_check_flags`` gives all 19 bits at every offset, its
  survivors compact in PyTorch (``_compact_mask``) into the same lanes and
  walk with plain lookups into it.

``TpuChecker`` windows a flat buffer through ``check_window`` (full pass)
and re-checks escaped lanes on the host, the reference's ``Checker``
plug-in face. ``count_scan`` counts the windows of a resident chunk
(reference ``checker.count_scan``); on a CUDA device ``make_count_scan``
gives ``CountScanGraphs``, which runs a chunk as one CUDA graph replay.
``count_window_raw`` and ``count_window_tokens`` fuse a window's device
inflate with its count: from raw payloads through the ``tokenize`` kernel,
or from the host tokenizer's packed planes.

Scalars the reference traces (``n``, ``at_eof``, ``lo``, ``own``,
``carry_len``, ``num_contigs``) are plain Python values here: the host knows
them when it queues a window. ``n``, ``at_eof``, ``lo`` and ``own`` may also
be 0-d tensors on the window's device (``n`` int32), with the same results:
a CUDA graph needs them so, since a Python value is frozen into the graph
at capture. Everything else is tensor code on the
window's device. PyTorch has no popcount and thin uint32 support, so packed
words live in int64 with a SWAR popcount, and the reference's JVM int32 wrap
is applied explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spark_bam_tpu_torch.check.flags import BIT, DEFINITIVE_MASK, ESCAPE_MASK
from spark_bam_tpu_torch.check.vectorized import check_flat
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.tpu import kernels
from spark_bam_tpu_torch.tpu.kernels import (
    PAD,
    _compact_mask,
    _fixed_bits,
    _misc_at,
    _pack_bits,
    _popcount32,
    _prefilter_flags,
    _take,
    _wrap32,
    full_check_flags,
    lane_capacity,
    lz77_resolve,
    prefilter_check_flags,
    tokenize,
)
from spark_bam_tpu_torch.tpu.inflate import _resolve_packed
from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE

__all__ = [
    "PAD", "CountScanGraphs", "TpuChecker", "WindowResult",
    "_prefilter_flags", "check_window", "count_scan", "count_window",
    "count_window_raw", "inflate_window_raw", "make_count_scan", "next_carry",
]

def _funnel_tables(p, n):
    """Word-level prefix tables for the deep checks: packed indicator words
    plus exclusive per-word popcount prefixes (allowed read-name bytes; bad
    cigar-op bytes per stride-4 class)."""
    allowed = (p >= 0x21) & (p <= 0x7E) & (p != 0x40)
    nwords = _pack_bits(allowed)
    nwpc = _popcount32(nwords)
    nwpre = torch.cumsum(nwpc, 0) - nwpc
    j = torch.arange(p.numel(), device=p.device)
    bad_op = ((p & 0xF) > 8) & (j + 4 <= n)
    cwords = _pack_bits(bad_op)
    # One 1-D scan per class: a scan down dim 0 of a (words, 4) tensor runs
    # PyTorch's outer-dim scan kernel, which took 238.6 ms per 32 MiB window
    # on an H100 80GB HBM3 at 700 W (benchmarks/profile_count.py).
    pcs = [_popcount32(cwords & (0x11111111 << c)) for c in range(4)]
    cwpre4 = torch.stack([torch.cumsum(pc, 0) - pc for pc in pcs], dim=1)
    return nwords, nwpre, cwords, cwpre4.reshape(-1)


def _allowed_before(nwords, nwpre, q):
    """Allowed read-name bytes at positions < q."""
    wi = q >> 5
    part = _popcount32(_take(nwords, wi) & ((1 << (q & 31)) - 1))
    return _take(nwpre, wi) + part


def _badops_before(cwords, cwpre4, q, c):
    """Bad cigar-op bytes j < q with j ≡ c (mod 4)."""
    wi = q >> 5
    part = _popcount32(
        _take(cwords, wi) & (0x11111111 << c) & ((1 << (q & 31)) - 1)
    )
    return _take(cwpre4, wi * 4 + c) + part


def _deep_flags_at(p, lengths, num_contigs: int, n, tables, pos):
    """The full 19-bit mask at positions (K,), field for field the reference
    full pass (same overwrite, same quirks)."""
    nwords, nwpre, cwords, cwpre4 = tables
    total = p.numel()
    pc = pos.clamp(0, total - 36)
    slab = _take(p, pc[:, None] + torch.arange(36, device=p.device)[None, :])
    slab = slab.long()

    def u32at(off):
        return (slab[:, off] | (slab[:, off + 1] << 8)
                | (slab[:, off + 2] << 16) | (slab[:, off + 3] << 24))

    remaining = _wrap32(u32at(0))
    ref_idx = _wrap32(u32at(4))
    ref_pos = _wrap32(u32at(8))
    name_len = slab[:, 12]
    fnc = u32at(16)
    n_cigar = fnc & 0xFFFF
    mapped = ((fnc >> 18) & 1) == 0
    seq_len = _wrap32(u32at(20))
    next_ref_idx = _wrap32(u32at(24))
    next_ref_pos = _wrap32(u32at(28))

    f = _fixed_bits(remaining, ref_idx, ref_pos, name_len, n_cigar, seq_len,
                    next_ref_idx, next_ref_pos, lengths, num_contigs)

    name_start = pos + 36
    name_end = name_start + name_len
    has_name = name_len >= 2
    name_eof = has_name & (name_end > n)
    f |= name_eof.long() * BIT["tooFewBytesForReadName"]
    name_in = has_name & ~name_eof
    last_idx = name_end - 1
    non_null = name_in & (_take(p, last_idx) != 0)
    f |= non_null.long() * BIT["nonNullTerminatedReadName"]
    good = (_allowed_before(nwords, nwpre, last_idx.clamp(0, total - 1))
            - _allowed_before(nwords, nwpre, name_start.clamp(0, total - 1)))
    bad_chars = name_in & ~non_null & (good != name_len - 1)
    f |= bad_chars.long() * BIT["nonASCIIReadName"]

    cig_start = name_start + torch.where(name_in, name_len, 0)
    cig_end = cig_start + 4 * n_cigar
    cig_considered = ~name_eof
    ccls = cig_start & 3
    bad_count = (
        _badops_before(cwords, cwpre4, cig_end.clamp(0, total - 1), ccls)
        - _badops_before(cwords, cwpre4, cig_start.clamp(0, total - 1), ccls)
    )
    has_bad = cig_considered & (bad_count != 0)
    f |= has_bad.long() * BIT["invalidCigarOp"]
    cig_eof = cig_considered & ~has_bad & (cig_end > n)
    f |= cig_eof.long() * BIT["tooFewBytesForCigarOps"]
    empty_ok = cig_considered & ~has_bad & ~cig_eof & mapped
    empty_seq = empty_ok & (seq_len == 0)
    empty_cig = empty_ok & (n_cigar == 0)
    # Swapped on purpose: reference quirk (EmptyMapped binds its fields in
    # the other order).
    f |= empty_seq.long() * BIT["emptyMappedCigar"]
    f |= empty_cig.long() * BIT["emptyMappedSeq"]
    f = torch.where(pos > n - 36, BIT["tooFewFixedBlockBytes"], f)
    return f.int()


def _check_lanes(padded, lengths, num_contigs: int, n, at_eof,
                 reads_to_check: int = 10, funnel: bool = True) -> dict:
    """Flag pass (prefilter, or the full pass with ``funnel=False``) +
    survivor compaction + chain walk, without scattering the lanes back to
    full width (the shared core of ``check_window`` and ``count_window``)."""
    dev = padded.device
    w = padded.numel() - PAD
    if isinstance(at_eof, torch.Tensor):
        ae = at_eof if at_eof.dtype == torch.bool else at_eof != 0
    else:
        ae = torch.tensor(bool(at_eof), device=dev)
    capacity = lane_capacity(w)
    if funnel:
        F, cand, n_survivors = prefilter_check_flags(padded, lengths,
                                                     num_contigs, n)
        n_survivors = n_survivors.long()
    else:
        F = full_check_flags(padded, lengths, num_contigs, n)
    in_range = torch.arange(w, device=dev) < n
    definitive0 = F & DEFINITIVE_MASK
    boundary0 = F & ESCAPE_MASK
    survivor = (F == 0) & in_range
    # Rejected positions resolve straight from F. Under the funnel F is the
    # prefilter mask: every prefilter bit is definitive except the
    # tooFewFixedBlockBytes overwrite, where it equals the full mask.
    fail0 = (F != 0) & ((definitive0 != 0) | (ae & (boundary0 != 0)))
    esc0 = (F != 0) & ~ae & (definitive0 == 0) & (boundary0 != 0)
    inexact0 = (F != 0) & ~ae & (definitive0 != 0) & (boundary0 != 0)
    res0 = torch.where(esc0, 2, torch.where(fail0, -1, 0)).to(torch.int8)
    fail_mask0 = torch.where(fail0, F, 0)

    if not funnel:
        cand, n_survivors = _compact_mask(survivor, capacity)
    overflow = n_survivors > capacity
    live = cand >= 0
    if funnel:
        # Stage 1: the full mask at the survivors, looked up by position in
        # the walk; a walked position the prefilter rejects resolves from
        # its prefilter bits alone.
        tables = _funnel_tables(padded, n)
        F_cand = _deep_flags_at(padded, lengths, num_contigs, n, tables,
                                torch.where(live, cand, 0))
        F_cand = torch.where(live, F_cand, 0)
        F_deep = torch.zeros(w + 1, dtype=torch.int32, device=dev)
        F_deep[torch.where(live, cand, w)] = F_cand
        F_deep = F_deep[:w]

        def flags_lookup(pi):
            pre = F[pi]
            return torch.where(pre == 0, F_deep[pi], pre)
    else:
        def flags_lookup(pi):
            return F[pi]

    logical = torch.where(live, cand, 0)
    physical = logical
    l_overflowed = torch.zeros(capacity, dtype=torch.bool, device=dev)
    res = torch.where(live, 0, -1).to(torch.int8)
    fail_mask = torch.zeros(capacity, dtype=torch.int32, device=dev)
    reads_before = torch.zeros(capacity, dtype=torch.int32, device=dev)
    reads_parsed = torch.zeros(capacity, dtype=torch.int32, device=dev)
    exact = torch.ones(capacity, dtype=torch.bool, device=dev)
    bound = n + 64

    for step in range(reads_to_check):
        run = res == 0
        # EOF at a record edge (zero bytes left): eager/Checker.scala:36-39.
        at_end = run & (physical >= n)
        edge = (physical == logical) & ~l_overflowed & (step > 0)
        maybe_edge = l_overflowed & (step > 0)   # comparison untrustworthy
        eof_ok = at_end & edge & ae
        eof_bad = at_end & ~edge & ~maybe_edge & ae
        eof_esc = at_end & (~ae | maybe_edge)
        res = torch.where(eof_ok, 1, res).to(torch.int8)
        reads_parsed = torch.where(eof_ok, step, reads_parsed)
        res = torch.where(eof_bad, -1, res).to(torch.int8)
        fail_mask = torch.where(eof_bad, BIT["tooFewFixedBlockBytes"],
                                fail_mask)
        reads_before = torch.where(eof_bad, step, reads_before)
        res = torch.where(eof_esc, 2, res).to(torch.int8)
        run = res == 0

        pi = physical.clamp(0, w - 1)
        f = torch.where(run, flags_lookup(pi), 0)
        definitive = f & DEFINITIVE_MASK
        boundary = f & ESCAPE_MASK
        fail = run & ((definitive != 0) | (ae & (boundary != 0)))
        esc = run & ~ae & (definitive == 0) & (boundary != 0)
        inexact = run & ~ae & (definitive != 0) & (boundary != 0)
        res = torch.where(fail, -1, res).to(torch.int8)
        fail_mask = torch.where(fail, f, fail_mask)
        reads_before = torch.where(fail, step, reads_before)
        res = torch.where(esc, 2, res).to(torch.int8)
        exact = exact & ~inexact
        run = res == 0

        ok = run & (f == 0)
        rem, b_end = _misc_at(padded, n, pi)
        # Out-of-range logical cursors collapse to sentinels (±(n+64)) that
        # keep every later comparison; a lane whose cursor would need to
        # re-enter range is flagged via l_overflowed.
        rem_c = rem.clamp(-bound, bound)
        next_logical = logical + 4 + rem_c
        clamped = next_logical.clamp(-bound, bound)
        overflow_now = (rem > bound) | (rem < -bound) | (next_logical != clamped)
        next_physical = torch.maximum(b_end, clamped).clamp(max=n)
        logical = torch.where(ok, clamped, logical)
        physical = torch.where(ok, next_physical, physical)
        l_overflowed = l_overflowed | (ok & overflow_now)

    full_chain = live & (res == 0)
    res = torch.where(full_chain, 1, res).to(torch.int8)
    reads_parsed = torch.where(full_chain, reads_to_check, reads_parsed)
    return {
        "survivor": survivor, "res0": res0, "fail_mask0": fail_mask0,
        "inexact0": inexact0, "cand": cand, "live": live, "res": res,
        "fail_mask": fail_mask, "reads_before": reads_before,
        "reads_parsed": reads_parsed, "exact": exact,
        "overflow": overflow, "n_survivors": n_survivors,
    }


def check_window(padded, lengths, num_contigs: int, n, at_eof,
                 reads_to_check: int = 10, funnel: bool = True) -> dict:
    """Verdicts for every offset of a (W + PAD,) u8 window (zeros past
    ``n``): (W,) ``verdict``, ``fail_mask``, ``reads_parsed``,
    ``reads_before``, ``exact``, ``escaped`` and the () ``survivors`` count
    (of stage 0 under the funnel, of the full pass without it). A
    survivor-capacity overflow escapes the whole window.

    The two forms give the same verdicts. Under the funnel, ``fail_mask``
    at a prefilter-rejected position holds only the prefilter bits, and
    ``exact`` may be True where the full pass reports a definitively
    failing lane inexact; the full pass (``funnel=False``) gives every
    position its whole mask."""
    w = padded.numel() - PAD
    L = _check_lanes(padded, lengths, num_contigs, n, at_eof, reads_to_check,
                     funnel)
    live, survivor = L["live"], L["survivor"]
    tgt = torch.where(live, L["cand"], w)

    def scatter(vals, fill, dtype):
        full = torch.full((w + 1,), fill, dtype=dtype, device=padded.device)
        full[tgt] = vals.to(dtype)
        return full[:w]

    res_full = torch.where(
        survivor, scatter(torch.where(live, L["res"], 0), 0, torch.int8),
        L["res0"])
    fm_full = torch.where(survivor, scatter(L["fail_mask"], 0, torch.int32),
                          L["fail_mask0"])
    rb_full = torch.where(survivor, scatter(L["reads_before"], 0, torch.int32),
                          0)
    rp_full = torch.where(survivor, scatter(L["reads_parsed"], 0, torch.int32),
                          0)
    ex_full = torch.where(survivor, scatter(L["exact"], True, torch.bool),
                          ~L["inexact0"])
    overflow = L["overflow"]
    res_full = torch.where(overflow, 2, res_full)
    escaped = res_full == 2
    return {
        "verdict": res_full == 1,
        "fail_mask": torch.where(overflow, 0, fm_full).int(),
        "reads_parsed": rp_full.int(),
        "reads_before": rb_full.int(),
        "exact": ex_full & ~escaped & ~overflow,
        "escaped": escaped,
        "survivors": L["n_survivors"],
    }


def count_window(padded, lengths, num_contigs: int, n, at_eof, lo, own,
                 reads_to_check: int = 10, funnel: bool = True) -> dict:
    """``check_window`` reduced over the owned span [lo, own) without the
    full-width scatters: () ``count`` of record starts, ``esc_count`` of
    escaped owned positions (all of them on a capacity overflow), and
    ``survivors``."""
    L = _check_lanes(padded, lengths, num_contigs, n, at_eof, reads_to_check,
                     funnel)
    w = padded.numel() - PAD
    i = torch.arange(w, device=padded.device)
    m = (i >= lo) & (i < own)
    own_lane = L["live"] & (L["cand"] >= lo) & (L["cand"] < own)
    count = (own_lane & (L["res"] == 1)).sum()
    esc = (m & (L["res0"] == 2)).sum() + (own_lane & (L["res"] == 2)).sum()
    overflow = L["overflow"]
    return {
        "count": torch.where(overflow, 0, count),
        "esc_count": torch.where(overflow, m.sum(), esc),
        "survivors": L["n_survivors"],
    }


def _host_ints(x) -> np.ndarray:
    """A (K,) row scalar column (array, list or tensor) as host int64."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def count_scan(chunk, lengths, num_contigs: int, starts, ns, at_eofs, los,
               owns, *, window: int, reads_to_check: int = 10,
               funnel: bool = False) -> dict:
    """``count_window`` over the K windows packed in one resident chunk
    (reference ``checker.count_scan``), one after another on the chunk's
    device. Window k is ``chunk[starts[k] : starts[k] + window + PAD]``
    (zeros past its ``ns[k]`` valid bytes) with ``at_eofs[k]`` and the
    owned span ``[los[k], owns[k])``; the row scalars are host arrays or
    tensors. A row with ``own == lo`` contributes nothing, which is how
    callers pad K to a bucket. Returns the () int32 ``count``,
    ``esc_count`` and ``survivors`` summed over the rows (a chunk holds
    fewer than 2^31 positions).

    The plain version of ``CountScanGraphs``, which ``make_count_scan``
    returns for a CUDA device."""
    stride = window + PAD
    starts, ns, aes, los, owns = (_host_ints(c) for c in
                                  (starts, ns, at_eofs, los, owns))
    total = torch.zeros(3, dtype=torch.int64, device=chunk.device)
    for s, n, ae, lo, own in zip(starts, ns, aes, los, owns):
        if s < 0 or s + stride > chunk.numel():
            raise ValueError(f"row at {s} runs past the {chunk.numel()}-byte "
                             f"chunk (rows are {stride} bytes)")
        r = count_window(chunk[s: s + stride], lengths, num_contigs, int(n),
                         bool(ae), int(lo), int(own), reads_to_check, funnel)
        total += torch.stack([r["count"].long(), r["esc_count"].long(),
                              r["survivors"].long()])
    total = total.int()
    return {"count": total[0], "esc_count": total[1], "survivors": total[2]}


class CountScanGraphs:
    """``count_scan`` on a CUDA device as one CUDA graph replay per chunk.

    The runner owns a static chunk buffer of Kp rows at stride
    ``window + PAD`` (16-byte aligned, since PAD is), a static (4, Kp)
    int32 table of the rows' ``n``, ``at_eof``, ``lo`` and ``own``, a
    static contig table, and one ``torch.cuda.CUDAGraph`` per
    power-of-two row count Kp (the reference's recompile bound) and
    contig count: each captures Kp ``count_window`` bodies in sequence
    over the static rows, with the row scalars as 0-d views of the table.
    Before its first capture the runner runs one body eagerly on a side
    stream, so the kernels are built and loaded and their launch set-up
    is done outside any capture.

    A call copies the chunk's rows and scalars in on the current stream
    (pinned host tensors let the copies overlap the previous replay),
    gives the rows from K to Kp ``n = lo = own = 0`` (they count
    nothing), replays the bucket's graph and returns clones of its three
    sums, which the next replay would overwrite. Inside the graph the flag
    kernels read ``n`` from the table and start from tile records zeroed
    by a captured memset (``kernels.TileStatus``); every replay adds the
    graph's captured launches to ``kernels.LAUNCHES``. A failed capture
    or replay raises: nothing falls back to the eager loop."""

    def __init__(self, window: int, reads_to_check: int = 10,
                 funnel: bool = False, device=None):
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CountScanGraphs runs on a CUDA device, not "
                             f"{self.device}; count_scan is the plain loop")
        self.window = window
        self.stride = window + PAD
        self.reads_to_check = reads_to_check
        self.funnel = funnel
        self.rows = 0
        self.chunk = self.table = self.lengths = None
        #: (Kp, num_contigs) → (graph, static (3,) int32 sums, launches of
        #: each kernel that one replay runs).
        self.graphs: dict = {}
        self.captures = 0
        self.replays = 0
        self._warm = False

    def _buffers(self, kp: int, cmax: int) -> None:
        """Static buffers for ``kp`` rows and a ``cmax`` contig table; a
        buffer that grows drops the graphs that read the old one."""
        dev = self.device
        if kp > self.rows:
            self.graphs.clear()
            self.chunk = torch.zeros(kp * self.stride, dtype=torch.uint8,
                                     device=dev)
            self.table = torch.zeros((4, kp), dtype=torch.int32, device=dev)
            self.rows = kp
        if self.lengths is None or self.lengths.numel() != cmax:
            self.graphs.clear()
            self.lengths = torch.zeros(cmax, dtype=torch.int32, device=dev)

    def _body(self, kp: int, num_contigs: int) -> torch.Tensor:
        """Kp window bodies over the static rows: the (3,) int32 sums."""
        total = None
        for j in range(kp):
            row = self.chunk[j * self.stride: (j + 1) * self.stride]
            n, ae, lo, own = self.table[:, j]
            r = count_window(row, self.lengths, num_contigs, n, ae, lo, own,
                             self.reads_to_check, self.funnel)
            v = torch.stack([r["count"].long(), r["esc_count"].long(),
                             r["survivors"].long()])
            total = v if total is None else total + v
        return total.int()

    def _graph(self, kp: int, num_contigs: int):
        key = (kp, num_contigs)
        if key in self.graphs:
            return self.graphs[key]
        dev = self.device
        current = torch.cuda.current_stream(dev)
        if not self._warm:
            side = torch.cuda.Stream(dev)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self._body(1, num_contigs)
            current.wait_stream(side)
            self._warm = True
        before = dict(kernels.CAPTURED)
        graph = torch.cuda.CUDAGraph()
        # A capture stream on this runner's device: the default one is made
        # once per process, on whichever device was current then.
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev),
                              capture_error_mode="thread_local"):
            sums = self._body(kp, num_contigs)
        launches = {k: kernels.CAPTURED[k] - before[k] for k in before
                    if kernels.CAPTURED[k] != before[k]}
        self.graphs[key] = (graph, sums, launches)
        self.captures += 1
        return self.graphs[key]

    def launches_per_replay(self) -> dict:
        """Kernel launches one replay runs, per captured (Kp, num_contigs)."""
        return {key: dict(g[2]) for key, g in self.graphs.items()}

    def __call__(self, chunk, lengths, num_contigs: int, starts, ns, at_eofs,
                 los, owns) -> dict:
        k = len(ns)
        if k == 0:
            raise ValueError("a chunk holds at least one row")
        kp = 1 << (k - 1).bit_length()
        if not np.array_equal(_host_ints(starts),
                              np.arange(k, dtype=np.int64) * self.stride):
            raise ValueError(f"rows must lie at stride window + PAD = "
                             f"{self.stride}")
        nbytes = k * self.stride
        if chunk.dim() != 1 or chunk.dtype != torch.uint8 \
                or chunk.numel() < nbytes:
            raise ValueError(f"chunk must be a 1-D uint8 tensor of at least "
                             f"{nbytes} bytes")
        self._buffers(kp, lengths.numel())
        self.chunk[:nbytes].copy_(chunk[:nbytes], non_blocking=True)
        self.lengths.copy_(lengths, non_blocking=True)
        for i, col in enumerate((ns, at_eofs, los, owns)):
            self.table[i, :k].copy_(torch.as_tensor(col), non_blocking=True)
        if kp > k:
            self.table[:, k:kp].zero_()
        graph, sums, launches = self._graph(kp, int(num_contigs))
        graph.replay()
        self.replays += 1
        with kernels._COUNT_LOCK:
            for name, c in launches.items():
                kernels.LAUNCHES[name] += c
        out = sums.clone()
        return {"count": out[0], "esc_count": out[1], "survivors": out[2]}


def make_count_scan(window: int, reads_to_check: int = 10,
                    funnel: bool = False, device=None):
    """The resident-chunk counter for a fixed ``window`` (reference
    ``checker.make_count_scan``), called as ``(chunk, lengths,
    num_contigs, starts, ns, at_eofs, los, owns)``: ``count_scan`` on the
    CPU, a ``CountScanGraphs`` runner on a CUDA device (``device=None`` is
    the current CUDA device and raises without one)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return CountScanGraphs(window, reads_to_check, funnel, dev)

    def run(chunk, lengths, num_contigs, starts, ns, at_eofs, los, owns):
        return count_scan(chunk, lengths, num_contigs, starts, ns, at_eofs,
                          los, owns, window=window,
                          reads_to_check=reads_to_check, funnel=funnel)

    return run


def _assemble(resolved, out_lens, carry, carry_len: int, n: int, *,
              window: int, halo: int) -> torch.Tensor:
    """The logical (window + PAD,) u8 window from the halo carry and the
    resolved block rows: byte ``i`` is ``carry[i]`` or byte ``i - carry_len``
    of the concatenated rows, located by a search over the cumulative
    ``out_lens`` (zero-length rows take no range); zeros from ``n`` on."""
    dev = resolved.device
    b = resolved.shape[0]
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum(out_lens.long(), 0)])
    i = torch.arange(window, device=dev)
    j = i - carry_len
    blk = (torch.searchsorted(cum, j, right=True) - 1).clamp(0, b - 1)
    off = (j - cum[blk]).clamp(0, STRIDE - 1)
    from_blocks = resolved.reshape(-1)[blk * STRIDE + off]
    carry_v = carry[i.clamp(0, halo - 1)]
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    val = torch.where(i < carry_len, carry_v,
                      torch.where(i < n, from_blocks, zero))
    return torch.cat([val, torch.zeros(PAD, dtype=torch.uint8, device=dev)])


def next_carry(padded, own: int, halo: int) -> torch.Tensor:
    """The next window's halo carry: ``padded[own : own + halo]``, zero-filled
    to ``halo`` bytes."""
    carry = padded[own: own + halo]
    short = halo - carry.numel()
    if short:
        carry = torch.cat([carry, torch.zeros(short, dtype=torch.uint8,
                                              device=padded.device)])
    return carry.clone()


def inflate_window_raw(staged, clens, exp_lens, carry, carry_len: int, n: int,
                       *, window: int, halo: int):
    """The device inflate of one window: tokenize the staged raw-DEFLATE
    rows, resolve LZ77 in place over the literal plane, and assemble the
    (window + PAD,) window behind the halo carry (``_assemble``). Returns
    ``(padded, rounds, tok_ok)``; ``tok_ok`` is True iff every real row
    (``clens > 0``) decoded cleanly to exactly its footer ISIZE. The
    assembly uses the footer lengths, so a lying row cannot shift its
    neighbours' bytes; callers discard the window when tok_ok is False."""
    lit, dist, olens, ok = tokenize(staged, clens)
    pad = clens == 0
    tok_ok = ((ok | pad) & ((olens == exp_lens) | pad)).all()
    resolved, rounds = lz77_resolve(lit, dist, out=lit)
    padded = _assemble(resolved, exp_lens, carry, carry_len, n,
                       window=window, halo=halo)
    return padded, rounds, tok_ok


def count_window_raw(staged, clens, exp_lens, carry, lengths,
                     num_contigs: int, carry_len: int, n: int, at_eof: bool,
                     lo: int, own: int, *, window: int, halo: int,
                     reads_to_check: int = 10, funnel: bool = True) -> dict:
    """The device-resident count of one window: ``inflate_window_raw``, then
    ``count_window`` over the owned span and the next ``carry``; adds
    ``rounds`` and ``tok_ok``. Callers discard the window's counts when
    tok_ok is False."""
    padded, rounds, tok_ok = inflate_window_raw(
        staged, clens, exp_lens, carry, carry_len, n, window=window,
        halo=halo)
    r = count_window(padded, lengths, num_contigs, n, at_eof, lo, own,
                     reads_to_check, funnel)
    return {**r, "carry": next_carry(padded, own, halo), "rounds": rounds,
            "tok_ok": tok_ok}


def inflate_window_tokens(packed, out_lens, carry, carry_len: int, n: int,
                          *, window: int, halo: int):
    """The device half of the ``tokenize=host`` route for one window: the
    packed token planes (``inflate.pack_tokens``' layout, on the device)
    unpacked as views, LZ77 resolved in place over the lit plane, and the
    (window + PAD,) window assembled behind the halo carry from the rows'
    ``out_lens`` (``_assemble``). Returns ``(padded, rounds)``."""
    resolved, rounds = _resolve_packed(packed)
    padded = _assemble(resolved, out_lens, carry, carry_len, n,
                       window=window, halo=halo)
    return padded, rounds


def count_window_tokens(packed, out_lens, carry, lengths, num_contigs: int,
                        carry_len: int, n: int, at_eof: bool, lo: int,
                        own: int, *, window: int, halo: int,
                        reads_to_check: int = 10, funnel: bool = True
                        ) -> dict:
    """The device-resident count of one window from host-tokenized packed
    planes (reference ``checker.count_window_tokens`` with
    ``_count_from_planes``): ``inflate_window_tokens``, then
    ``count_window`` over the owned span ``[lo, own)`` and the next
    ``carry``. Returns ``count``, ``esc_count``, ``survivors``, ``carry``
    and ``rounds``. The host already checked every row's size against its
    footer, so there is no verdict to return."""
    padded, rounds = inflate_window_tokens(packed, out_lens, carry,
                                           carry_len, n, window=window,
                                           halo=halo)
    r = count_window(padded, lengths, num_contigs, n, at_eof, lo, own,
                     reads_to_check, funnel)
    return {**r, "carry": next_carry(padded, own, halo), "rounds": rounds}


@dataclass
class WindowResult:
    verdict: np.ndarray
    fail_mask: np.ndarray
    reads_parsed: np.ndarray
    reads_before: np.ndarray
    exact: np.ndarray
    escaped: np.ndarray


class TpuChecker:
    """The reference's ``Checker`` plug-in face: windows a flat buffer
    through ``check_window`` (full pass) on the device, and re-checks
    escaped or inexact lanes with the host engine, so results are exact.
    ``device=None`` runs on the current CUDA device and raises without
    one."""

    def __init__(
        self,
        contig_lengths: np.ndarray,
        window: int = 16 << 20,
        halo: int = 4 << 20,
        reads_to_check: int = 10,
        cmax: int = 1024,
        device=None,
    ):
        self.device = resolve_device(device)
        self.window = window
        self.halo = halo
        self.reads_to_check = reads_to_check
        self.num_contigs = len(contig_lengths)
        self.lengths = np.zeros(max(cmax, len(contig_lengths)), dtype=np.int32)
        self.lengths[: len(contig_lengths)] = contig_lengths

    def check_buffer(self, buf: np.ndarray, at_eof: bool = True) -> WindowResult:
        """Check every position of ``buf``; exact everywhere except possibly
        within the final chain reach when ``at_eof=False`` (those escape)."""
        n_total = len(buf)
        out = {
            k: np.empty(n_total, dtype=d)
            for k, d in [
                ("verdict", bool), ("fail_mask", np.int32),
                ("reads_parsed", np.int32), ("reads_before", np.int32),
                ("exact", bool), ("escaped", bool),
            ]
        }
        w = self.window
        step = max(w - self.halo, 1)
        lens = torch.from_numpy(self.lengths).to(self.device)
        s = 0
        while True:
            e = min(s + w, n_total)
            chunk_eof = at_eof and e == n_total
            padded = torch.zeros(w + PAD, dtype=torch.uint8, device=self.device)
            padded[: e - s] = torch.from_numpy(np.ascontiguousarray(buf[s:e]))
            res = check_window(padded, lens, self.num_contigs, e - s,
                               chunk_eof, self.reads_to_check, funnel=False)
            # Own [s, s + step): the halo tail belongs to the next window,
            # except in the last one, which owns through the end.
            own_end = e if e == n_total else min(s + step, n_total)
            for k in out:
                out[k][s:own_end] = res[k][: own_end - s].cpu().numpy()
            if e == n_total:
                break
            s += step
        result = WindowResult(**out)
        self._host_recheck(buf, result, at_eof)
        return result

    def _host_recheck(self, buf, result: WindowResult, at_eof: bool):
        """Resolve escaped and inexact lanes with the host engine over the
        suffix that can influence them (halo-outrunning chains, cursor
        overflows)."""
        bad = result.escaped | ~result.exact
        if at_eof:
            idxs = np.flatnonzero(bad)
        else:
            # In windowed mode the tail's escapes are legitimate output.
            idxs = np.flatnonzero(bad[: max(len(buf) - self.halo, 0)])
        if len(idxs) == 0:
            return
        base = int(idxs.min())
        res = check_flat(
            buf[base:], self.lengths[: self.num_contigs],
            candidates=(idxs - base).astype(np.int64),
            at_eof=at_eof, reads_to_check=self.reads_to_check,
        )
        result.verdict[idxs] = res.verdict
        result.fail_mask[idxs] = res.fail_mask
        result.reads_parsed[idxs] = res.reads_parsed
        result.reads_before[idxs] = res.reads_before
        result.exact[idxs] = res.exact | res.verdict | (res.fail_mask != 0)
        result.escaped[idxs] = res.escaped
