"""Edge cases for the fused stage-0 pass, ``prefilter_check_flags``: the
flag bits at every offset and the survivors compacted behind them.

One set, shared by the CPU tests (the plain version against the JAX
package's prefilter and compaction), the card tests and ``chip_smoke.py``
(the CUDA kernel against the plain version), like ``resolve_flag_cases.py``
for the full pass.

``prefilter_windows(w)`` gives named ``(padded (w' + PAD,) u8, n, lengths
(CMAX,) i32, num_contigs)`` cases at a window of ``w`` bytes (a multiple of
``TILE``, at least 4 tiles; ``w' = w`` unless the name says otherwise);
each case's survivor capacity is ``lane_capacity(w')``:

- a survivor at ``n - 36``, and a record at ``n - 35`` that cannot survive;
- survivors only in the first tile, only in the last tile, and at offsets
  whose 36-byte block crosses into the next tile;
- ``w'`` not a whole number of tiles (a multiple of 4, and not), ``n < 36``;
- exactly 0, ``capacity``, ``capacity + 1`` and ``2 * capacity``
  survivors (``survivor_run``);
- ``ref_idx`` and ``next_ref_idx`` at -2, -1, 0, ``num_contigs - 1``,
  ``num_contigs``, ``CMAX - 1`` and 2^31 - 1 against positions at -2, -1,
  0 and the contig length and one past it;
- implied record sizes that wrap in int32, ``seq_len`` from -1 to -4 (the
  division truncating toward zero) at the size threshold and one below,
  ``name_len`` 0, 1 and 2;
- seeded random bytes, alone and with valid records sprinkled in.

``TILE`` is the CUDA kernel's tile; the plain versions do not depend on
it. ``survivor_run(buf, start, k)`` writes ``k`` survivors at ``start +
12j`` (with ``RUN_CONTIGS`` contigs), for windows of any survivor count;
``overflow_soup(w)`` is the checker tests' window whose survivors exceed
the capacity (1/12 of its offsets, under a table that accepts any index
and position: the JAX Pallas prefilter loops over that many contigs, so
it is for the card, not for the CPU tests).

    for name, (padded, n, lengths, nc) in prefilter_windows(1 << 17).items():
        ...
"""

from __future__ import annotations

import struct

import numpy as np

#: The funnel's padding past W (``kernels.PAD``).
PAD = 257 * 1024
#: ``kTile`` of ``csrc/prefilter.cu``.
TILE = 16384
#: The contig table width of the main path (``pad_contig_lengths``).
CMAX = 1024
#: A table of three contigs, zero-padded.
NUM_CONTIGS = 3
LENGTHS = np.zeros(CMAX, dtype=np.int32)
LENGTHS[:NUM_CONTIGS] = (1000, 2000, 3000)
#: 12 bytes that, repeated, pass the prefilter at every twelfth offset
#: under ``LENGTHS`` with ``RUN_CONTIGS`` contigs: remaining 258 (also
#: next_ref_idx; its low byte is name_len 2), every other field 0. Every
#: other offset reads name_len 0 or 1.
RUN_UNIT = struct.pack("<iii", 258, 0, 0)
RUN_CONTIGS = 259


def lane_capacity(w: int) -> int:
    """The check's survivor capacity (``kernels.lane_capacity``)."""
    return max(w // 32, 4096)


def header(remaining=1000, ref_idx=0, ref_pos=100, name_len=2, n_cigar=0,
           flag=0, seq_len=0, next_ref_idx=-1, next_ref_pos=-1) -> bytes:
    """A record's 36-byte fixed block; the defaults pass the prefilter
    under ``LENGTHS``, and on a zero background no offset near it does."""
    return struct.pack("<iiiBBHHHiiii", remaining, ref_idx, ref_pos,
                       name_len, 0, 0, n_cigar, flag, seq_len, next_ref_idx,
                       next_ref_pos, 0)


def implied(name_len: int, n_cigar: int, seq_len: int) -> int:
    """The implied record size as the reference computes it (int32 wrap,
    division truncating toward zero)."""
    def wrap(x):
        return (x + (1 << 31)) % (1 << 32) - (1 << 31)

    t = wrap(seq_len + 1)
    half = abs(t) // 2 * (1 if t >= 0 else -1)
    return wrap(32 + name_len + 4 * n_cigar + half + seq_len)


def _zeros(w: int) -> np.ndarray:
    return np.zeros(w + PAD, dtype=np.uint8)


def _put(buf: np.ndarray, at: int, block: bytes) -> None:
    buf[at: at + len(block)] = np.frombuffer(block, dtype=np.uint8)


def _headers_every(buf: np.ndarray, lo: int, hi: int, step: int = 64,
                   block: bytes | None = None) -> None:
    block = header() if block is None else block
    for at in range(lo, hi - 35, step):
        _put(buf, at, block)


def survivor_run(buf: np.ndarray, start: int, k: int) -> None:
    """``k`` survivors (with ``RUN_CONTIGS`` contigs) at ``start + 12j``,
    j < k: ``k + 1`` copies of ``RUN_UNIT`` (the last one gives the k-th
    its name byte)."""
    if k:
        _put(buf, start, RUN_UNIT * (k + 1))


def _field_headers(buf: np.ndarray, blocks: list[bytes], lo: int = 4096):
    for j, block in enumerate(blocks):
        _put(buf, lo + 64 * j, block)


def prefilter_windows(w: int, seed: int = 0):
    if w % TILE or w < 4 * TILE:
        raise ValueError(f"w must be a multiple of {TILE}, at least 4 tiles")
    rng = np.random.default_rng(seed)
    out = {}
    table = (LENGTHS, NUM_CONTIGS)

    n = w - 1000
    buf = _zeros(w)
    _put(buf, n - 36, header())
    _put(buf, n - 200, header())
    out["survivor_at_n_minus_36"] = (buf, n, *table)
    buf = _zeros(w)
    _put(buf, n - 35, header())
    out["none_at_n_minus_35"] = (buf, n, *table)

    buf = _zeros(w)
    _headers_every(buf, 0, TILE)
    out["first_tile_only"] = (buf, w, *table)
    buf = _zeros(w)
    _headers_every(buf, w - TILE, w)
    out["last_tile_only"] = (buf, w, *table)
    buf = _zeros(w)
    for t in range(1, w // TILE):
        _put(buf, t * TILE - (35, 20, 4, 1)[t % 4], header())
    out["tail_crosses_tile"] = (buf, w, *table)

    for name, ragged in (("w_not_a_tile_multiple", w - 3 * TILE // 2 - 12),
                         ("w_not_a_multiple_of_4", w - 3 * TILE // 2 - 13)):
        buf = _zeros(ragged)
        _headers_every(buf, ragged - 3 * TILE // 2, ragged, step=52)
        _put(buf, ragged - 36, header())
        out[name] = (buf, ragged, *table)
    out["w_not_a_multiple_of_4_n_short"] = (buf, ragged - 5, *table)

    buf = _zeros(w)
    survivor_run(buf, 0, w // 12 - 8)
    out["n_35"] = (buf, 35, LENGTHS, RUN_CONTIGS)
    out["n_0"] = (buf, 0, LENGTHS, RUN_CONTIGS)

    cap = lane_capacity(w)
    for name, k in (("count_0", 0), ("count_capacity", cap),
                    ("count_capacity_plus_1", cap + 1),
                    ("count_2x_capacity", 2 * cap)):
        buf = _zeros(w)
        survivor_run(buf, 3 * TILE // 2 - 8 if k <= cap else 100, k)
        out[name] = (buf, w, LENGTHS, RUN_CONTIGS)

    lens = LENGTHS[0]
    idxs = (-2, -1, 0, NUM_CONTIGS - 1, NUM_CONTIGS, CMAX - 1, 0x7FFFFFFF)
    poss = (-2, -1, 0, int(lens), int(lens) + 1)
    blocks = [header(ref_idx=i, ref_pos=p, next_ref_idx=j, next_ref_pos=p)
              for i in idxs for j in idxs for p in poss]
    buf = _zeros(w)
    _field_headers(buf, blocks)
    out["ref_idx_edges"] = (buf, w, *table)

    blocks = []
    for seq_len in (0x7FFFFFFF, 0x7FFFFFFE, 0x7FFFFFF0, -(1 << 31),
                    -(1 << 31) + 1, 1 << 30):
        for name_len in (2, 255):
            for n_cigar in (0, 1, 0xFFFF):
                rhs = implied(name_len, n_cigar, seq_len)
                for remaining in (rhs - 1, rhs, 1000, -1):
                    remaining = max(min(remaining, 0x7FFFFFFF), -(1 << 31))
                    blocks.append(header(remaining=remaining,
                                         name_len=name_len, n_cigar=n_cigar,
                                         seq_len=seq_len))
    buf = _zeros(w)
    _field_headers(buf, blocks)
    out["implied_size_wrap"] = (buf, w, *table)

    blocks = []
    for seq_len in (-1, -2, -3, -4, 0, 1):
        for name_len in (0, 1, 2, 3):
            for n_cigar in (0, 7):
                rhs = implied(name_len, n_cigar, seq_len)
                blocks += [header(remaining=r, name_len=name_len,
                                  n_cigar=n_cigar, seq_len=seq_len)
                           for r in (rhs - 1, rhs)]
    buf = _zeros(w)
    _field_headers(buf, blocks)
    out["seq_len_negative_name_len"] = (buf, w, *table)

    soup = rng.integers(0, 256, w + PAD, dtype=np.uint8)
    out["random_bytes"] = (soup, w, *table)
    mixed = soup.copy()
    for at in rng.choice(w - 36, size=w // 256, replace=False):
        _put(mixed, int(at), header(ref_pos=int(rng.integers(-1, 1001))))
    out["random_with_records"] = (mixed, w - 17, *table)
    return out


def overflow_soup(w: int):
    """``(padded, n, lengths, num_contigs)``: a 36-byte pattern that passes
    at three of every 36 offsets under a table that accepts any index and
    position, so 1/12 of the window survives, more than the capacity."""
    rec = bytearray(36)
    rec[0:4] = struct.pack("<i", 0x02000000)    # remaining
    rec[12:16] = bytes([2, 2, 2, 2])            # name_len, mapq, bin
    rec[20:24] = struct.pack("<i", 0x00C00000)  # seq_len
    buf = _zeros(w)
    buf[:w] = np.frombuffer(bytes(rec) * -(-w // 36), dtype=np.uint8)[:w]
    return (buf, w, np.full(CMAX, 0x7FFFFFFF, dtype=np.int32), 0x7FFFFFFF)
