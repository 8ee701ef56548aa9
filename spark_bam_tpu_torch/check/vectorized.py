"""The host record-boundary engine (reference ``spark_bam_tpu/check/
vectorized.py``): a flag pass at every offset of a flat buffer, then a
lock-step NumPy chain walk over candidates.

The streaming checker's deferral path resolves escaped and inexact lanes
with it, on the host, whatever the device: it is the reference's own exact
path for chains that outrun a window, not a stand-in for a kernel.

1. **Flag pass** (``compute_flags``): the 19-bit mask ``F[i]`` of the
   would-be record at every offset ``i``, from the full pass's plain
   version (``tpu/kernels.py::_compute_flags``) run on the CPU. ``F[i] ==
   0`` iff the record at ``i`` passes every check.
2. **Chain walk** (``chain_verdicts``): ``reads_to_check`` lock-step rounds
   follow each candidate's next-record pointers with a logical and a
   physical cursor. With ``at_eof=False``, a candidate whose resolution
   needs bytes past the buffer is *escaped* rather than guessed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spark_bam_tpu_torch.check.flags import BIT, DEFINITIVE_MASK, ESCAPE_MASK
from spark_bam_tpu_torch.tpu.kernels import PAD, _compute_flags, _misc_at


@dataclass
class RecordMasks:
    """Per-position single-record results over a flat buffer."""

    F: np.ndarray          # int32 flag mask per position; 0 = record valid
    remaining: np.ndarray  # int64 length prefix at each position (int32 value)
    body_end: np.ndarray   # int64 position after the fixed, name and cigar reads
    n: int                 # buffer size (number of candidate positions)


def compute_flags(buf: np.ndarray, contig_lengths: np.ndarray) -> RecordMasks:
    """Flag pass: all 19 checks at every offset of ``buf``, by the plain
    full pass ``kernels._compute_flags`` on a CPU tensor (the buffer padded
    by ``PAD`` zeros), with ``remaining``/``body_end`` from ``_misc_at``."""
    n = int(buf.shape[0])
    p = torch.zeros(n + PAD, dtype=torch.uint8)
    p[:n] = torch.from_numpy(np.ascontiguousarray(buf, dtype=np.uint8))
    lengths = torch.zeros(max(len(contig_lengths), 1), dtype=torch.int32)
    lengths[: len(contig_lengths)] = torch.from_numpy(
        np.asarray(contig_lengths, dtype=np.int32))
    F = _compute_flags(p, lengths, len(contig_lengths), n)
    remaining, body_end = _misc_at(p, n, torch.arange(n))
    return RecordMasks(F=F.numpy(), remaining=remaining.numpy(),
                       body_end=body_end.numpy(), n=n)


@dataclass
class ChainResult:
    verdict: np.ndarray        # bool: a record boundary
    reads_parsed: np.ndarray   # int32: chained successes of true verdicts
    fail_mask: np.ndarray      # int32: flags of the first failing record
    reads_before: np.ndarray   # int32: successes before the failing record
    exact: np.ndarray          # bool: the resolution never touched buffer-end bits
    escaped: np.ndarray        # bool: unresolved (windowed mode only)


def chain_verdicts(
    masks: RecordMasks,
    candidates: np.ndarray,
    at_eof: bool = True,
    reads_to_check: int = 10,
) -> ChainResult:
    """Chain walk: resolve each candidate by following next-record
    pointers."""
    n = masks.n
    F, remaining, body_end = masks.F, masks.remaining, masks.body_end

    logical = candidates.astype(np.int64)
    physical = candidates.astype(np.int64)
    m = logical.shape[0]
    res = np.zeros(m, dtype=np.int8)  # 0 running, 1 true, -1 false, 2 escaped
    fail_mask = np.zeros(m, dtype=np.int32)
    reads_before = np.zeros(m, dtype=np.int32)
    reads_parsed = np.zeros(m, dtype=np.int32)
    exact = np.ones(m, dtype=bool)

    for step in range(reads_to_check):
        run = res == 0
        if not run.any():
            break
        at_end = physical >= n
        if at_eof:
            # Zero bytes exactly at the expected record edge after at least
            # one success is a valid EOF (eager/Checker.scala:36-39).
            eof_ok = run & at_end & (physical == logical) & (step > 0)
            res[eof_ok] = 1
            reads_parsed[eof_ok] = step
            eof_bad = run & at_end & ~eof_ok
            res[eof_bad] = -1
            fail_mask[eof_bad] = BIT["tooFewFixedBlockBytes"]
            reads_before[eof_bad] = step
        else:
            res[run & at_end] = 2
        run = res == 0

        f = F[np.clip(physical, 0, n - 1)]
        f = np.where(run, f, 0)
        definitive = f & DEFINITIVE_MASK
        boundary = f & ESCAPE_MASK

        fail = run & (definitive != 0)
        if at_eof:
            fail |= run & (boundary != 0)
        else:
            esc = run & (definitive == 0) & (boundary != 0)
            res[esc] = 2
            # A definitive failure whose flags also touch the buffer end is
            # a certain false verdict with possibly incomplete flags.
            exact &= ~(run & (definitive != 0) & (boundary != 0))
        res[fail] = -1
        fail_mask[fail] = f[fail]
        reads_before[fail] = step
        run = res == 0

        ok = run & (f == 0)
        pi = np.clip(physical, 0, n - 1)
        next_logical = logical + 4 + remaining[pi].astype(np.int64)
        next_physical = np.maximum(body_end[pi], next_logical)
        if at_eof:
            next_physical = np.minimum(next_physical, n)
        else:
            esc = ok & (next_physical > n)
            res[esc] = 2
            ok &= res == 0
        logical = np.where(ok, next_logical, logical)
        physical = np.where(ok, next_physical, physical)

    full_chain = res == 0
    res[full_chain] = 1
    reads_parsed[full_chain] = reads_to_check
    escaped = res == 2
    exact &= ~escaped
    return ChainResult(
        verdict=res == 1,
        reads_parsed=reads_parsed,
        fail_mask=fail_mask,
        reads_before=reads_before,
        exact=exact,
        escaped=escaped,
    )


def check_flat(
    buf: np.ndarray,
    contig_lengths: np.ndarray,
    candidates: np.ndarray | None = None,
    at_eof: bool = True,
    reads_to_check: int = 10,
) -> ChainResult:
    """Flag pass and chain walk over one flat buffer, at ``candidates`` or
    at every position. In the all-position form, positions whose own record
    fails (``F != 0``) resolve from the flag pass alone and only the
    survivors walk."""
    masks = compute_flags(np.asarray(buf, dtype=np.uint8), contig_lengths)
    if candidates is not None:
        return chain_verdicts(masks, candidates, at_eof=at_eof,
                              reads_to_check=reads_to_check)
    n = masks.n
    F = masks.F
    nonzero = F != 0
    if at_eof:
        fail0 = nonzero
        esc0 = np.zeros(n, dtype=bool)
        inexact0 = esc0
    else:
        definitive = F & DEFINITIVE_MASK
        boundary = F & ESCAPE_MASK
        fail0 = nonzero & (definitive != 0)
        esc0 = nonzero & (definitive == 0) & (boundary != 0)
        inexact0 = fail0 & (boundary != 0)
    verdict = np.zeros(n, dtype=bool)
    fail_mask = np.where(fail0, F, 0).astype(np.int32)
    reads_parsed = np.zeros(n, dtype=np.int32)
    reads_before = np.zeros(n, dtype=np.int32)
    escaped = esc0.copy()
    exact = ~(inexact0 | esc0)
    surv = np.flatnonzero(~nonzero).astype(np.int64)
    if len(surv):
        cr = chain_verdicts(masks, surv, at_eof=at_eof,
                            reads_to_check=reads_to_check)
        verdict[surv] = cr.verdict
        fail_mask[surv] = cr.fail_mask
        reads_parsed[surv] = cr.reads_parsed
        reads_before[surv] = cr.reads_before
        exact[surv] = cr.exact
        escaped[surv] = cr.escaped
    return ChainResult(verdict, reads_parsed, fail_mask, reads_before, exact,
                       escaped)
