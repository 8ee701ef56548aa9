"""Edge cases for the funnel's stage 1 (``bad_op_tables``, ``walk_lanes``,
``count_lanes``): windows whose survivors walk chains that reach the
deep checks, the cursor sentinels and the bad-op tables' corners.

One set, shared by the CPU tests (the plain lane core against the JAX
package's ``_check_lanes``), the card tests and ``chip_smoke.py`` (the
kernels against their plain versions), beside ``prefilter_cases.py``,
whose windows they also run.

``lane_windows(w, seed)`` gives named ``(padded (w + PAD,) u8, n, lengths
(CMAX,) i32, num_contigs)`` cases at a window of ``w`` bytes (a multiple
of 4,096):

- ``int32_wrap``: records that pass every check with ``seq_len`` 2^31 - 1
  (``seq_len + 1`` wraps, the implied size wraps) and ``remaining`` at
  2^31 - 1, at the implied size, and near -2^31 (``seq_len`` chosen so
  the implied size wraps below it), some reached as the second record of
  a chain, each followed by a valid record so the walk goes on past the
  sentinels; and a chain of valid records that ends at ``n``;
- ``cigar_spans``: chains of records with up to 65,535 cigar ops (the
  implied size equal to ``remaining``, so each chain steps record to
  record), bad op codes planted at the first and last op, at ops whose
  byte lies at and beside 1,024- and 32,768-byte boundaries, and bad
  nibbles at every other byte of every op (other stride-4 classes, which
  must not count), names with a bad byte, a '@', no terminator and a
  name cut by ``n``;
- ``chains``: valid records chained end to end through the window's
  first 2 MiB at most, with a few breaks (a bad name, an empty mapped
  sequence, a chain running into ``n``), so walks reach
  ``reads_to_check`` and the EOF edge;
- ``overflow_chain``: more survivors than the capacity, and the first
  lane's chain into records past it whose names fail (they walk as mask
  0, as in the reference).

``cigar_spans`` and ``chains`` cut their last record with ``n``.

``table_windows(w, seed)`` gives the cases of the stage-1 kernels' survivor
table and rank search (for the card and for the CPU checks of the plain
table; ``tail_super_block`` holds more valid bytes than ``w``, so it is
not one for the JAX package, whose extended window clamps elsewhere):

- ``dense_run``: two records whose step crosses a run of consecutive
  offsets that all survive (every byte 0x60 under a table that accepts
  any index and position; their names end without a NUL, so their lanes
  stop at once), about a third and an eighth of the capacity long, then a
  chain of valid records: a lane from the record before each run reaches
  the chain by its successor rank, a farther search than any real window
  asks for, and a lane from the record before that one (a negative
  ``seq_len`` leaves its logical cursor 13 bytes behind the physical one)
  lands inside the run and searches the list itself;
- ``tail_super_block``: ``n`` the whole padded window, random bytes over
  the last, partial 32 KiB super-block (bad ops in its words and
  summaries), and a chain of records from 200 bytes before ``w`` whose
  cursors pass ``w`` (positions past ``w - 1`` read at ``w - 1``).
"""

from __future__ import annotations

import struct

import numpy as np

from spark_bam_tpu_torch.benchmarks.prefilter_cases import (
    CMAX,
    LENGTHS,
    NUM_CONTIGS,
    PAD,
    RUN_CONTIGS,
    lane_capacity,
    survivor_run,
)

#: The flag word's unmapped bit: skips the empty-mapped checks.
UNMAPPED = 4


def _wrap(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def implied(name_len: int, n_cigar: int, seq_len: int) -> int:
    """The implied record size (int32 wrap, truncating division)."""
    t = _wrap(seq_len + 1)
    half = abs(t) // 2 * (1 if t >= 0 else -1)
    return _wrap(32 + name_len + 4 * n_cigar + half + seq_len)


def record(name: bytes = b"r1\0", n_cigar: int = 0, seq_len: int = 0,
           flag: int = UNMAPPED, remaining: int | None = None,
           cigar: bytes | None = None, ref_idx: int = -1,
           ref_pos: int = -1) -> bytes:
    """A record's fixed block, name and cigar (no sequence: with
    ``seq_len`` 0 the implied size is the block's end, so the next record
    follows the cigar). ``remaining`` defaults to the implied size."""
    if remaining is None:
        remaining = implied(len(name), n_cigar, seq_len)
    head = struct.pack("<iiiBBHHHiiii", remaining, ref_idx, ref_pos,
                       len(name) & 0xFF, 0, 0, n_cigar, flag, seq_len, -1,
                       -1, 0)
    if cigar is None:
        cigar = struct.pack("<I", 0x10) * n_cigar
    return head + name + cigar


def _zeros(w: int) -> np.ndarray:
    return np.zeros(w + PAD, dtype=np.uint8)


def _put(buf: np.ndarray, at: int, data: bytes) -> int:
    buf[at: at + len(data)] = np.frombuffer(data, dtype=np.uint8)
    return at + len(data)


def _table():
    return LENGTHS, NUM_CONTIGS


def int32_wrap(w: int):
    buf = _zeros(w)
    big = 0x7FFFFFFF
    # seq_len 1,431,655,765: the implied size wraps to -2^31 + 35 + name.
    s_neg = 1431655765
    cases = [
        record(seq_len=big, remaining=big),
        record(seq_len=big),
        record(seq_len=big, remaining=implied(3, 0, big) + 1),
        record(seq_len=s_neg, remaining=-(1 << 31) + 100),
        record(seq_len=s_neg),
        record(seq_len=-(1 << 31), remaining=big),
        record(seq_len=big, remaining=big, n_cigar=3),
    ]
    at = 256
    for rec in cases:
        # Alone, then as the second record of a chain, each followed by
        # a valid record (the walk's next position after a clamp).
        at = _put(buf, at, rec)
        at = _put(buf, at, record()) + 200
        at = _put(buf, at, record())
        at = _put(buf, at, rec)
        at = _put(buf, at, record()) + 200
    # A chain of valid records that ends at n: full chains, and walks that
    # meet the EOF edge.
    for _ in range(30):
        at = _put(buf, at, record())
    return buf, at, *_table()


def _cigar_record(n_ops: int, bad_ops=(), cls_noise: bool = True,
                  name: bytes = b"ok\0") -> bytes:
    ops = np.zeros((n_ops, 4), dtype=np.uint8)
    ops[:, 0] = 0x10                      # op 0 (M), length 1
    if cls_noise:
        ops[:, 1:] = 0x09                 # bad nibbles at other classes
    for j in bad_ops:
        ops[j, 0] = 0x19                  # op code 9: bad
    return record(name=name, n_cigar=n_ops, cigar=ops.tobytes())


def cigar_spans(w: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    buf = _zeros(w)
    top = min(65535, w // 20)            # the longest cigar that fits
    specs = [(top, ()), (top, (0,)), (top, (top - 1,)), (min(8000, top), ()),
             (300, (299,)), (1, ()), (1, (0,)), (0, ())]
    # Bad ops whose byte lands at and beside 1 KiB and 32 KiB boundaries.
    for edge in (1024, 32768):
        for delta in (-4, 0, 4):
            specs.append((top, ("edge", edge, delta)))
    for _ in range(6):
        n_ops = int(rng.integers(1, top + 1))
        specs.append((n_ops, (int(rng.integers(0, n_ops)),)))
    at = 100
    for n_ops, bad in specs:
        start = at + 36 + 3
        if start + 4 * n_ops > w - 4096:
            continue
        if bad and bad[0] == "edge":
            _, edge, delta = bad
            target = (start // edge + 1) * edge + delta
            target += (start - target) % 4          # the op's own byte
            bad = ((target - start) // 4,) if start <= target \
                < start + 4 * n_ops else ()
        at = _put(buf, at, _cigar_record(n_ops, bad))
    # Names: a bad byte, a '@', no terminator, the longest; then a record
    # whose name runs past n.
    for name in (b"a\x01b\0", b"a@b\0", b"abc", b"x" * 254 + b"\0"):
        at = _put(buf, at, record(name=name))
        at = _put(buf, at, record())
    _put(buf, at, record(name=b"y" * 40 + b"\0"))
    return buf, min(at + 36 + 10, w), *_table()


def chains(w: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    buf = _zeros(w)
    at = 7
    end = min(w - 4096, 1 << 21)     # 2 MiB of chains at most
    while at < end:
        kind = int(rng.integers(0, 20))
        name = bytes(rng.integers(0x41, 0x5B, int(rng.integers(1, 30)))
                     .astype(np.uint8)) + b"\0"
        if kind == 0:
            name = name[:-2] + b"\x7f\0"                   # not allowed
        rec = record(name=name, n_cigar=int(rng.integers(0, 8)),
                     flag=0 if kind == 1 else UNMAPPED)    # empty mapped
        at = _put(buf, at, rec)
        if kind == 2:
            at += int(rng.integers(1, 64))                 # a break
    return buf, at - 20, *_table()


def overflow_chain(w: int):
    """More survivors than the capacity, and a chain from the first lane
    into records past the capacity whose names fail the deep checks: the
    reference walks them as mask 0 (no deep mask was scattered there), so
    that lane parses them."""
    buf = _zeros(w)
    cap = lane_capacity(w)
    far = 128 + 12 * (cap + 120)
    _put(buf, 64, record(remaining=far - 64 - 4))
    survivor_run(buf, 128, cap + 100)
    at = far
    while at < far + 4000:
        at = _put(buf, at, record(name=b"a\x01b\0"))
    return buf, w, LENGTHS, RUN_CONTIGS


#: A table that accepts any contig index and position (``overflow_soup``'s).
ANY_LENGTHS = np.full(CMAX, 0x7FFFFFFF, dtype=np.int32)
ANY_CONTIGS = 0x7FFFFFFF


def dense_run(w: int):
    buf = _zeros(w)
    cap = lane_capacity(w)
    at = 64
    for run in (cap // 3, cap // 8):
        # A (its step falls 13 bytes short of B's end: logical behind
        # physical), B (remaining across the run), the run, then a chain.
        at = _put(buf, at, record(seq_len=-9))
        b = at
        at = _put(buf, at, record(remaining=run + 39))
        nat = b + 4 + run + 39
        buf[at: nat] = 0x60
        at = nat
        for _ in range(12):
            at = _put(buf, at, record())
        at += 100
    return buf, min(at + 64, w), ANY_LENGTHS, ANY_CONTIGS


def tail_super_block(w: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    buf = _zeros(w)
    total = len(buf)
    tail = total - (total % 32768 or 32768) - 8192
    buf[tail:] = rng.integers(0, 256, total - tail, dtype=np.uint8)
    at = w - 200
    while at < w + 400:
        at = _put(buf, at, record())
    return buf, total, *_table()


def table_windows(w: int, seed: int = 0):
    if w % 4096:
        raise ValueError("w must be a multiple of 4096")
    return {"dense_run": dense_run(w),
            "tail_super_block": tail_super_block(w, seed)}


def lane_windows(w: int, seed: int = 0):
    if w % 4096:
        raise ValueError("w must be a multiple of 4096")
    return {"int32_wrap": int32_wrap(w), "cigar_spans": cigar_spans(w, seed),
            "chains": chains(w, seed), "overflow_chain": overflow_chain(w)}


__all__ = ["CMAX", "implied", "lane_windows", "record",
           "table_windows"]
