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


def lane_windows(w: int, seed: int = 0):
    if w % 4096:
        raise ValueError("w must be a multiple of 4096")
    return {"int32_wrap": int32_wrap(w), "cigar_spans": cigar_spans(w, seed),
            "chains": chains(w, seed), "overflow_chain": overflow_chain(w)}


__all__ = ["CMAX", "implied", "lane_windows", "record"]
