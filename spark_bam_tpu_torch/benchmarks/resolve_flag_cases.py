"""Edge cases for ``lz77_resolve`` and ``full_check_flags``.

One set, shared by the CPU tests (the plain versions against the JAX
package), the card tests and ``chip_smoke.py`` (the CUDA kernels against
the plain versions), like ``deflate_cases.py`` for the tokenizer.

- ``token_rows(seed)``: named (STRIDE,) u8 literal / u16 distance rows,
  every ``dist[i] <= i``: all literals, a padding row, the distance-1 run
  (16 doubling rounds), chains of the maximal distance, a sparse chain and
  a lone straggler among converged positions, DEFLATE-like runs whose
  parents cross the half-row boundary, and 60 %-match random rows.
- ``flag_windows(w)``: named ``(padded (w' + PAD,) u8, n)`` windows for
  the full pass at a window of ``w`` bytes (a multiple of ``TILE``, at
  least 4 tiles): a single bad cigar op at a tile's end, at the end of a
  predecessor's lookahead and just past it, and in the last tile; no bad
  op at all; a bad op far ahead of every offset; at a window of at least
  2 tiles + ``CIGAR_REACH``, a record with the longest cigar there is
  whose last op, 17 tiles ahead, is bad (or whose next one is); ``n`` at
  each residue mod 4 on both sides of a tile boundary; ``n < 36``; a
  ``w'`` that is not a multiple of the tile. ``TILE`` and ``LOOK`` are the CUDA kernel's
  tile and lookahead; the plain versions do not depend on them.

    rows = token_rows(0)
    lit, dist = stack_rows(rows)
    for name, (padded, n) in flag_windows(1 << 18).items(): ...
"""

from __future__ import annotations

import numpy as np

#: Token row width (``tokenize_device.STRIDE``).
STRIDE = 65536
#: The full pass's padding past W (``kernels.PAD``).
PAD = 257 * 1024
#: ``kTile`` and ``kLook`` of ``csrc/full_flags.cu``.
TILE = 16384
LOOK = 512
#: Byte with a valid cigar op nibble (8) whose fixed block reads name_len
#: 136 and n_cigar 34,952: every offset's cigar spans 139,808 bytes.
SEA = 0x88
#: Byte with a bad cigar op nibble (9).
BAD = 0x89
#: The farthest a cigar reaches past its offset: fixed block, a 255-byte
#: name, 65,535 ops.
CIGAR_REACH = 36 + 255 + 4 * 65535


def _runs(rng, lo: int, hi: int, lit_share: float, cross: bool):
    """Distances of DEFLATE-like runs over [lo, hi): literals and matches
    of 3..258 bytes at distances 1..32,768. With ``cross``, matches in the
    second half reach back into the first."""
    d = np.zeros(STRIDE, dtype=np.int64)
    i = lo
    while i < hi:
        if rng.random() < lit_share or i < 3:
            i += int(rng.integers(1, 8))
            continue
        length = int(rng.integers(3, 259))
        far = min(i, 32768)
        if cross and i >= STRIDE // 2 and i - STRIDE // 2 + 1 <= far:
            dist = int(rng.integers(i - STRIDE // 2 + 1, far + 1))
        else:
            dist = int(rng.integers(1, far + 1))
        end = min(i + length, hi)
        d[i:end] = dist
        i = end
    return d


def token_rows(seed: int = 0) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    i = np.arange(STRIDE)
    rows: dict[str, np.ndarray] = {}
    rows["literals"] = np.zeros(STRIDE, dtype=np.int64)
    rows["padding"] = None                            # lit 0, dist 0
    rle = np.ones(STRIDE, dtype=np.int64)
    rle[0] = 0
    rows["rle_distance_1"] = rle                      # 16 doubling rounds
    rows["max_distance"] = np.where(i >= 32768, 32768, 0)
    # Hops of 32,768 back then 1: every position past 32,768 points into
    # a distance-1 run of the first half.
    d = np.where(i >= 32768, 32768, 0)
    d[1:32768] = 1
    rows["max_distance_into_run"] = d
    # One chain of 4,096 hops at stride 16 among literals: two active bits
    # a bitmap word, 12 rounds.
    d = np.zeros(STRIDE, dtype=np.int64)
    d[16::16] = 16
    rows["sparse_chain"] = d
    # Everything points straight at a literal (of [0, 256) or of
    # [32768, 33024)) except a chain of 17 at the end.
    d = np.where(i >= 32768, i - 32768 - i % 256, i - i % 256)
    d[-17:] = 1
    rows["lone_straggler"] = d
    rows["runs"] = _runs(rng, 0, STRIDE, 0.4, cross=False)
    rows["runs_cross_half"] = _runs(rng, 0, STRIDE, 0.2, cross=True)
    rows["runs_short_row"] = _runs(rng, 0, 40_000, 0.3, cross=True)
    for r in range(3):
        take = rng.random(STRIDE) < 0.6
        d = (rng.random(STRIDE) * np.minimum(i, 32768)).astype(np.int64)
        rows[f"random_60pct_{r}"] = np.where(take & (d > 0), d, 0)
    out = {}
    for name, d in rows.items():
        if d is None:
            out[name] = (np.zeros(STRIDE, np.uint8), np.zeros(STRIDE, np.uint16))
            continue
        lit = rng.integers(0, 256, STRIDE, dtype=np.uint8)
        assert (d <= i).all() and (d <= 32768).all(), name
        out[name] = (lit, d.astype(np.uint16))
    return out


def stack_rows(rows: dict[str, tuple[np.ndarray, np.ndarray]],
               names=None) -> tuple[np.ndarray, np.ndarray]:
    """(B, STRIDE) literal and distance planes of ``names`` (default all)."""
    names = list(rows) if names is None else names
    return (np.stack([rows[k][0] for k in names]),
            np.stack([rows[k][1] for k in names]))


def _sea(w: int, bad_at=()) -> np.ndarray:
    p = np.full(w + PAD, SEA, dtype=np.uint8)
    for j in bad_at:
        p[j] = BAD
    return p


def flag_windows(w: int, seed: int = 0) -> dict[str, tuple[np.ndarray, int]]:
    if w % TILE or w < 4 * TILE:
        raise ValueError(f"w must be a multiple of {TILE}, at least 4 tiles")
    rng = np.random.default_rng(seed)
    mid = (w // 2 // TILE) * TILE                     # a tile's first byte
    out: dict[str, tuple[np.ndarray, int]] = {}
    out["bad_at_tile_end"] = (_sea(w, [mid - 1]), w)
    out["bad_at_lookahead_end"] = (_sea(w, [mid + LOOK - 1]), w)
    out["bad_past_lookahead"] = (_sea(w, [mid + LOOK]), w)
    out["bad_in_last_tile"] = (_sea(w, [w - 4]), w)   # the last one counted
    out["bad_past_n"] = (_sea(w, [w - 3]), w)         # j + 4 > n: not bad
    out["no_bad_op"] = (_sea(w), w)
    nibbles = rng.integers(0, 256, w + PAD, dtype=np.uint8)
    nibbles = (nibbles & 0xF0) | (nibbles & 0x0F) % 9
    out["random_valid_nibbles"] = (nibbles, w)
    out["bad_far_ahead"] = (_sea(w, [min(1 << 20, w - 4)]), w)
    soup = rng.integers(0, 256, w + PAD, dtype=np.uint8)
    edge = w - TILE
    for k in range(-4, 4):
        out[f"n_at_tile{'+' if k >= 0 else '-'}{abs(k)}"] = (soup, edge + k)
    out["n_35"] = (soup, 35)
    out["n_1"] = (soup, 1)
    if w >= 2 * TILE + CIGAR_REACH:
        # The last offset of tile 0 holds the longest record header a
        # cigar can have; its last op lies 17 tiles ahead. One bad op
        # there, or just past the cigar.
        i0 = TILE - 1
        last_op = i0 + CIGAR_REACH - 4
        for name, bad in (("cigar_reach_last_op", last_op),
                          ("cigar_reach_past_end", last_op + 4)):
            p = _sea(w, [bad])
            p[i0 + 12] = 255                      # name_len
            p[i0 + 16: i0 + 18] = 0xFF            # n_cigar 65,535
            out[name] = (p, w)
    ragged = w - 3 * TILE // 2 - 12
    out["w_not_a_tile_multiple"] = (soup[: ragged + PAD].copy(), ragged - 7)
    out["w_not_a_tile_multiple_sea"] = (
        _sea(ragged, [ragged - TILE + LOOK]), ragged)
    return out
