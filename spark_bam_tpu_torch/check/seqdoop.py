"""``seqdoop`` checker: behavioral emulation of hadoop-bam's BAMSplitGuesser
(reference ``spark_bam_tpu/check/seqdoop.py``), host NumPy.

The reference wraps the actual upstream library to measure its accuracy
in-harness (seqdoop/.../seqdoop/Checker.scala:22-108 + the truncated stream
reproducing its fixed read window :119-164). We implement the *behavior* from
the reference's documented comparison (docs/motivation.md checks table and
:123-140) and pin it with the fixture goldens:

- anchor record: reference/mate idx bounds and negative-position checks, name
  NUL-termination, length-consistency — but NOT locus-too-large, NOT
  name-emptiness/charset, NOT cigar-op validity, NOT empty-mapped checks
- succeeding records: structural decode validity *including* cigar ops,
  chained until ``blocks_needed`` distinct BGZF block positions are visited
- the window is capped at ``max_bytes_read`` *compressed* bytes past the
  candidate's block; hitting the cap mid-decode "passes" if any record
  decoded (the upstream EOF/decodedAny quirk, motivation.md:123-140)

``SeqdoopChecker.next_read_start`` from a block past the file's last data
block (the EOF sentinel) returns None, where the reference's raises
``KeyError`` (its flat view has no entry for the empty block).
"""

from __future__ import annotations

import numpy as np

from spark_bam_tpu_torch.bgzf.flat import FlatView, flatten_file
from spark_bam_tpu_torch.core.pos import Pos

MAX_BYTES_READ = 3 * 0xFFFF * 2  # upstream BAMSplitGuesser.MAX_BYTES_READ
BLOCKS_NEEDED = 3                # upstream BLOCKS_NEEDED_FOR_GUESS


def _fields(buf: np.ndarray):
    n = len(buf)
    p = np.zeros(n + 40, dtype=np.uint8)
    p[:n] = buf
    u = (
        p[:-3].astype(np.uint32)
        | (p[1:-2].astype(np.uint32) << 8)
        | (p[2:-1].astype(np.uint32) << 16)
        | (p[3:].astype(np.uint32) << 24)
    )
    i32 = u.view(np.int32)
    return p, u, i32


def seqdoop_masks(
    buf: np.ndarray, num_contigs: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(anchor_ok, succ_ok, next_offset) per position.

    ``anchor_ok``: hadoop-bam's checkRecordStart checks.
    ``succ_ok``:   decode-time validity of a succeeding record (adds cigar-op
                   validity; keeps idx/neg-pos checks; still no locus bound).
    """
    n = len(buf)
    p, u, i32 = _fields(buf)
    remaining = i32[0:n]
    ref_idx = i32[4: n + 4]
    ref_pos = i32[8: n + 8]
    name_len = p[12: n + 12].astype(np.int32)
    fnc = u[16: n + 16]
    n_cigar = (fnc & 0xFFFF).astype(np.int32)
    seq_len = i32[20: n + 20]
    next_ref_idx = i32[24: n + 24]
    next_ref_pos = i32[28: n + 28]

    idx = np.arange(n, dtype=np.int64)
    fits = idx + 36 <= n

    ref_ok = (
        (ref_idx >= -1) & (ref_idx < num_contigs) & (ref_pos >= -1)
        & (next_ref_idx >= -1) & (next_ref_idx < num_contigs) & (next_ref_pos >= -1)
    )

    # Length-consistency, JVM int32 wrap + truncating division.
    with np.errstate(over="ignore"):
        t = (seq_len + np.int32(1)).astype(np.int32)
        half = t // 2 + ((t < 0) & (t % 2 != 0))
        rhs = (
            np.int32(32) + name_len + np.int32(4) * n_cigar
            + half.astype(np.int32) + seq_len
        ).astype(np.int32)
    size_ok = remaining >= rhs

    name_end = idx + 36 + name_len
    name_ok = (
        (name_len >= 1)
        & (name_end <= n)
        & (p[np.clip(name_end - 1, 0, n + 39)] == 0)
    )

    anchor_ok = fits & ref_ok & size_ok & name_ok

    # Cigar-op validity via stride-4 suffix sums (as in check/vectorized.py).
    pad = 4 * 65535 + 300 + 4
    bad_op = np.zeros(n + pad, dtype=np.int32)
    readable = max(n - 3, 0)
    bad_op[:readable] = (p[:readable] & 0xF) > 8
    B = np.zeros(n + pad, dtype=np.int32)
    for r in range(4):
        B[r::4] = bad_op[r::4][::-1].cumsum()[::-1]
    cig_start = np.where(name_len >= 1, name_end, idx + 36)
    cig_end = cig_start + 4 * n_cigar.astype(np.int64)
    bad_count = B[np.clip(cig_start, 0, n + pad - 1)] - B[np.clip(cig_end, 0, n + pad - 1)]
    cigar_ok = (bad_count == 0) & (cig_end <= n)

    succ_ok = fits & ref_ok & size_ok & name_ok & cigar_ok

    next_offset = idx + 4 + remaining.astype(np.int64)
    return anchor_ok, succ_ok, next_offset


def seqdoop_check_flat(
    view: FlatView,
    num_contigs: int,
    candidates: np.ndarray | None = None,
    max_bytes_read: int = MAX_BYTES_READ,
    blocks_needed: int = BLOCKS_NEEDED,
    max_steps: int = 50_000,
) -> np.ndarray:
    """Seqdoop verdict for every position (or given candidates) of a view."""
    buf = view.data
    n = view.size
    anchor_ok, succ_ok, nxt = seqdoop_masks(buf, num_contigs)

    # Block bookkeeping: block index of each flat position and the flat cap
    # implied by the compressed read window of each candidate's block.
    block_flat = view.block_flat
    block_starts = view.block_starts
    n_blocks = len(block_starts)

    verdict = np.zeros(n, dtype=bool)
    cand = candidates if candidates is not None else np.flatnonzero(anchor_ok)
    cand = cand[anchor_ok[cand]]
    if len(cand) == 0:
        return verdict

    blk_of = np.searchsorted(block_flat, cand, side="right") - 1
    limit_comp = block_starts[blk_of] + max_bytes_read
    # First block NOT fully within the compressed window:
    comp_ends = block_starts + _compressed_sizes(view, n)
    cut_block = np.searchsorted(comp_ends, limit_comp, side="right")
    flat_limit = np.where(
        cut_block >= n_blocks, n, block_flat[np.clip(cut_block, 0, n_blocks - 1)]
    )

    m = len(cand)
    # The succeeding-records scan decodes from the anchor itself
    # (motivation.md:127-131): the anchor is record #0 (cigar NOT checked),
    # every later record is cigar-checked.
    pos = cand.astype(np.int64)
    cap = np.minimum(flat_limit, n)
    last_blk = np.full(m, -1, dtype=np.int64)
    visited = np.zeros(m, dtype=np.int32)
    decoded_any = np.zeros(m, dtype=bool)
    res = np.zeros(m, dtype=np.int8)     # 0 running, 1 pass, -1 fail

    for _ in range(max_steps):
        run = res == 0
        if not run.any():
            break

        pi = np.clip(pos, 0, n - 1)

        # Header or body crossing the (256 KB-window or file) end ⇒ EOF,
        # "valid iff anything was decoded" (the upstream decodedAny quirk).
        over = run & ((pos + 36 > cap) | (nxt[pi] > cap))
        res[over & decoded_any] = 1
        res[over & ~decoded_any] = -1
        run &= res == 0

        # Record decoded: body fit inside the window, so the field checks run
        # (including the codec-relative cigar scan — note its cigar offset
        # differs from eager's when l_read_name ∈ {0,1}, which is exactly why
        # the known FP anchors pass here while eager flags invalidCigarOp).
        bad = run & ~succ_ok[pi]
        res[bad] = -1
        run &= res == 0
        decoded_any = decoded_any | run

        # Count distinct BGZF blocks visited; enough ⇒ pass.
        b = np.searchsorted(block_flat, pi, side="right") - 1
        newblk = run & (b != last_blk)
        visited[newblk] += 1
        last_blk = np.where(run, b, last_blk)
        done = run & (visited >= blocks_needed)
        res[done] = 1
        run &= res == 0

        pos = np.where(run, nxt[pi], pos)

    verdict[cand[res == 1]] = True
    return verdict


def _compressed_sizes(view: FlatView, n: int) -> np.ndarray:
    """Per-block compressed sizes from consecutive starts (the final block's
    true size isn't derivable from the view; approximate with its flat span,
    which errs small and only affects the cap by <64 KiB at EOF)."""
    starts = view.block_starts
    if len(starts) == 1:
        return np.array([n - view.block_flat[0]], dtype=np.int64)
    diffs = np.diff(starts)
    last = max(int(diffs[-1]), 1)
    return np.append(diffs, last)


class SeqdoopChecker:
    """Sequential plugin face over the vectorized seqdoop engine."""

    def __init__(self, view: FlatView, num_contigs: int):
        self.view = view
        self.num_contigs = num_contigs
        self._verdict: np.ndarray | None = None

    @staticmethod
    def open(path) -> "SeqdoopChecker":
        from spark_bam_tpu_torch.bam.header import read_header

        return SeqdoopChecker(flatten_file(path),
                              len(read_header(path).contig_lengths))

    @property
    def verdict(self) -> np.ndarray:
        if self._verdict is None:
            self._verdict = seqdoop_check_flat(self.view, self.num_contigs)
        return self._verdict

    def next_read_start(self, start: Pos, max_read_size: int = 10_000_000) -> Pos | None:
        starts = self.view.block_starts
        if len(starts) == 0 or start.block_pos > starts[-1]:
            return None   # the EOF sentinel: no record follows
        flat = self.view.flat_of_pos(start.block_pos, start.offset)
        true_flat = np.flatnonzero(self.verdict)
        j = int(np.searchsorted(true_flat, flat))
        if j < len(true_flat) and true_flat[j] - flat < max_read_size:
            return Pos(*self.view.pos_of_flat(int(true_flat[j])))
        return None

