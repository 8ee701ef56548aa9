"""The port's hand-written CUDA kernels, their wrappers, and the plain
PyTorch versions of the same functions.

Each wrapper takes its plain version only for tensors that lie on the CPU.
For CUDA tensors it launches its kernel (``csrc/*.cu``, built by
``kernels/build.py``) on the current stream or raises; nothing falls back.
``LAUNCHES`` counts kernel launches per wrapper, and only those. A launch
captured into a CUDA graph runs only when the graph is replayed: it is
counted in ``CAPTURED`` instead, and the graph's owner adds its captured
launches to ``LAUNCHES`` at every replay (``checker.CountScanGraphs``).

The two flag kernels take the valid byte count ``n`` by value from a
Python int, or read it from device memory when it is a 0-d int32 tensor
on the window's device, so that a captured launch reads each replay's
value. Their tile status records are kept per stream between eager
launches (``TileStatus``); a captured launch gets records of its own,
zeroed by a captured memset just before it.

| wrapper                 | CUDA source           | replaces (spark_bam_tpu/tpu/pallas_kernels.py) |
| ----------------------- | --------------------- | ---------------------------------------------- |
| ``prefilter_check_flags`` | ``csrc/prefilter.cu`` | ``prefilter_check_flags`` (``:436``), and the compaction ``tpu/checker.py::_compact_mask`` (``:414``) |
| ``full_check_flags``    | ``csrc/full_flags.cu`` | ``full_check_flags`` (``:470``)               |
| ``lz77_resolve``        | ``csrc/lz77.cu``      | ``lz77_resolve_pallas`` (``:250``)             |
| ``tokenize``            | ``csrc/tokenize.cu``  | ``tokenize_pallas`` (``:299``)                 |

The funnel's stage 1, jnp and ``lax.scan`` code in the reference, has two
kernels of its own (``csrc/lanes.cu``; reference ``tpu/checker.py``):

| wrapper                 | replaces (spark_bam_tpu/tpu/checker.py) |
| ----------------------- | --------------------------------------- |
| ``bad_op_tables``       | ``_funnel_tables`` (``:281``), ``_badops_before`` (``:312``) |
| ``survivor_table``      | ``_deep_flags_at`` (``:322``) and ``_misc_at`` (``:184``) at the survivors |
| ``walk_lanes``, ``count_lanes`` | the walk of ``_check_lanes`` (``:538-623``), the funnel's ``count_window`` (``:741-760``); each launches ``survivor_table`` first |

What bounds each on the H100 and how its design answers is noted at the
top of its source. The tokenizer's plain version is the Python decoder in
``tpu/tokenize_device.py`` (a bit-serial decoder has no tensor form).
"""

from __future__ import annotations

import threading

import torch

from spark_bam_tpu_torch.check.flags import BIT, DEFINITIVE_MASK, ESCAPE_MASK
from spark_bam_tpu_torch.kernels.build import load
from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE, tokenize_plain

# Padding beyond any index a flag pass can touch (36 fixed + 255 name +
# 4*65535 cigar + slack), as in the reference checker: 257*1024 = 263168.
PAD = 257 * 1024
#: Bytes per tile of the full pass (``kTile`` in ``csrc/full_flags.cu``).
FULL_FLAGS_TILE = 16384
#: int32 per tile status record of the full pass (``kRecord`` there).
_RECORD = 16
#: Offsets per tile of the prefilter (``kTile`` in ``csrc/prefilter.cu``).
PREFILTER_TILE = 16384
#: int32 per tile status record of the prefilter (``kRecord`` there).
_PREFILTER_RECORD = 4
#: Status words hold the epoch in 32 bits.
_EPOCHS = 1 << 32
#: log2(64 Ki): pointer doubling collapses any chain inside a token row.
DOUBLING_ROUNDS = (STRIDE - 1).bit_length()

#: Threads a CTA of the survivor table and the lane walk (``kThreads`` in
#: ``csrc/lanes.cu``).
WALK_THREADS = 256
#: Bitmap words a bad-op summary word covers (``kSuperWords`` there).
_SUPER_WORDS = 1024
#: A survivor-table entry's successor when the walk must search itself
#: (``kNoSucc`` there).
NO_SUCC = -(1 << 31)

LAUNCHES = {"prefilter_check_flags": 0, "full_check_flags": 0,
            "lz77_resolve": 0, "tokenize": 0,
            "bad_op_tables": 0, "survivor_table": 0, "walk_lanes": 0,
            # the write path's lanes (compress/kernels.py)
            "crc32_lanes": 0, "deflate_fixed_lanes": 0}
#: Launches recorded into CUDA graphs being captured (none of them ran).
CAPTURED = dict.fromkeys(LAUNCHES, 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value a JVM int would hold (two's-complement wrap)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _u32_fields(p: torch.Tensor, w: int):
    """Little-endian u32 (as int64) at byte offsets [0, w + 32) of ``p``."""
    q = p[: w + 35].long()
    return q[:-3] | (q[1:-2] << 8) | (q[2:-1] << 16) | (q[3:] << 24)


def _ref_pos_bits(idx, pos, c, len_at, b_neg_idx, b_large_idx, b_neg_pos,
                  b_large_pos):
    neg_idx = idx < -1
    large_idx = ~neg_idx & (idx >= c)
    neg_pos = pos < -1
    large_pos = ~neg_idx & ~large_idx & ~neg_pos & (idx >= 0) & (pos > len_at)
    return (
        neg_idx.long() * b_neg_idx | large_idx.long() * b_large_idx
        | neg_pos.long() * b_neg_pos | large_pos.long() * b_large_pos
    )


def _fixed_bits(remaining, ref_idx, ref_pos, name_len, n_cigar, seq_len,
                next_ref_idx, next_ref_pos, lengths, num_contigs: int):
    """The flag bits that the fixed 36-byte block alone decides (contig
    bounds of both positions, the implied record size, the name length),
    as int64, without the ``tooFewFixedBlockBytes`` overwrite."""
    cmax = lengths.numel()
    lens = lengths.long()
    f = _ref_pos_bits(
        ref_idx, ref_pos, num_contigs, lens[ref_idx.clamp(0, cmax - 1)],
        BIT["negativeReadIdx"], BIT["tooLargeReadIdx"],
        BIT["negativeReadPos"], BIT["tooLargeReadPos"],
    ) | _ref_pos_bits(
        next_ref_idx, next_ref_pos, num_contigs,
        lens[next_ref_idx.clamp(0, cmax - 1)],
        BIT["negativeNextReadIdx"], BIT["tooLargeNextReadIdx"],
        BIT["negativeNextReadPos"], BIT["tooLargeNextReadPos"],
    )
    half = torch.div(_wrap32(seq_len + 1), 2, rounding_mode="trunc")
    rhs = _wrap32(32 + name_len + 4 * n_cigar + half + seq_len)
    f |= (remaining < rhs).long() * BIT["tooFewRemainingBytesImplied"]
    f |= (name_len == 0).long() * BIT["noReadName"]
    f |= (name_len == 1).long() * BIT["emptyReadName"]
    return f


def _window_fields(p, w: int) -> dict:
    """The fixed-block fields of the record at every offset [0, w) of the
    padded window ``p``, as int64 (JVM int32 values where the reference
    reads an int)."""
    u = _u32_fields(p, w)
    i32 = _wrap32(u)
    return {
        "remaining": i32[0:w], "ref_idx": i32[4: w + 4],
        "ref_pos": i32[8: w + 8], "name_len": p[12: w + 12].long(),
        "fnc": u[16: w + 16], "seq_len": i32[20: w + 20],
        "next_ref_idx": i32[24: w + 24], "next_ref_pos": i32[28: w + 28],
    }


def _window_fixed_bits(fx: dict, lengths, num_contigs: int):
    return _fixed_bits(
        fx["remaining"], fx["ref_idx"], fx["ref_pos"], fx["name_len"],
        fx["fnc"] & 0xFFFF, fx["seq_len"], fx["next_ref_idx"],
        fx["next_ref_pos"], lengths, num_contigs,
    )


def lane_capacity(w: int) -> int:
    """The check's survivor lanes for a window of ``w`` offsets."""
    return max(w // 32, 4096)


def _prefilter_flags(p, lengths, num_contigs: int, n) -> torch.Tensor:
    """Plain version of the stage-0 funnel pass: the fixed-block subset of
    the 19 bits at every offset of the (W + PAD,) window ``p``, including
    the ``tooFewFixedBlockBytes`` overwrite. Returns (W,) int32."""
    w = p.numel() - PAD
    f = _window_fixed_bits(_window_fields(p, w), lengths, num_contigs)
    few_fixed = torch.arange(w, device=p.device) > n - 36
    return torch.where(few_fixed, BIT["tooFewFixedBlockBytes"], f).int()


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(t, idx, mode="clip")``."""
    return t[idx.clamp(0, t.numel() - 1)]


_M32 = 0xFFFFFFFF


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a uint32 value (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a bool vector into uint32 words held in int64 (lane = bit
    index), zero-padding the tail to a word boundary."""
    length = bits.numel()
    full = -(-length // 32) * 32
    if full != length:
        bits = torch.cat([bits, bits.new_zeros(full - length)])
    lanes = torch.arange(32, device=bits.device)
    return (bits.view(-1, 32).long() << lanes).sum(1)


def _compact_mask(mask: torch.Tensor, capacity: int):
    """Set positions of ``mask`` compacted into a (capacity,) index buffer
    (-1 past the population), via packed words, a word-level popcount prefix,
    a binary search for the word holding the k-th set bit and masked
    popcounts for its lane. Returns ``(cand, n_set)``."""
    words = _pack_bits(mask)
    wpc = _popcount32(words)
    wcnt = torch.cumsum(wpc, 0)
    n_set = wcnt[-1]
    k = torch.arange(capacity, device=mask.device)
    wi = torch.searchsorted(wcnt, k + 1, right=False)
    excl = _take(wcnt - wpc, wi)
    r = k + 1 - excl                              # rank inside the word: 1..32
    word = _take(words, wi)
    lanes = torch.arange(32, device=mask.device)
    incl = (2 << lanes) - 1                       # inclusive lane masks
    pcnt = _popcount32(word[:, None] & incl[None, :])
    hit = (pcnt == r[:, None]) & (((word[:, None] >> lanes[None, :]) & 1) == 1)
    lane = hit.int().argmax(dim=1)                # first hit
    cand = torch.where(k < n_set, wi * 32 + lane, -1)
    return cand, n_set


def _prefilter_compact(p, lengths, num_contigs: int, n, capacity: int):
    """Plain version of the fused stage-0 pass: ``_prefilter_flags``, then
    the survivors (``F == 0`` at offsets below ``n``) compacted by
    ``_compact_mask``. Returns ``(F (W,) i32, cand (capacity,) i32,
    n_set () i32)``: the first ``capacity`` survivors in increasing order
    then -1, and the exact survivor count (which may exceed the
    capacity)."""
    F = _prefilter_flags(p, lengths, num_contigs, n)
    survivor = (F == 0) & (torch.arange(F.numel(), device=p.device) < n)
    cand, n_set = _compact_mask(survivor, capacity)
    return F, cand.int(), n_set.int()


def _misc_at(p, n, pos):
    """``remaining`` and ``body_end`` of the record at each position (K,)
    (pre-clipped to [0, w)) of the padded window ``p`` holding ``n`` valid
    bytes: what a chain walk needs to step."""
    def byte(off):
        return _take(p, pos + off).long()

    remaining = _wrap32(byte(0) | (byte(1) << 8) | (byte(2) << 16)
                        | (byte(3) << 24))
    name_len = byte(12)
    n_cigar = byte(16) | (byte(17) << 8)
    has_name = name_len >= 2
    name_eof = has_name & (pos + 36 + name_len > n)
    name_in = has_name & ~name_eof
    cig_start = pos + 36 + torch.where(name_in, name_len, 0)
    few_fixed = pos > n - 36
    body_end = torch.where(
        few_fixed, pos + 36,
        cig_start + torch.where(~name_eof, 4 * n_cigar, 0),
    )
    return remaining, body_end


def _bad_op_bits(p, n) -> torch.Tensor:
    """Bad cigar-op bytes of the padded window ``p``: low nibble > 8, the
    op's 4-byte int inside the ``n`` valid bytes."""
    j = torch.arange(p.numel(), device=p.device)
    return ((p & 0xF) > 8) & (j + 4 <= n)


def _bad_op_tables(p, n):
    """Plain version of ``bad_op_tables``: ``(words, blocks)``, int32 holding
    uint32 bits. Bit k of ``words[i]`` is a bad op at byte 32 i + k (the
    reference's ``cwords``); bit b of ``blocks[c, s]`` says a bad op of
    stride-4 class c lies in the 1,024 bytes from 1,024 (32 s + b)."""
    words = _pack_bits(_bad_op_bits(p, n))
    nsuper = -(-words.numel() // _SUPER_WORDS)
    full = torch.zeros(nsuper * _SUPER_WORDS, dtype=torch.int64,
                       device=p.device)
    full[: words.numel()] = words
    per_block = full.view(-1, 32)
    cls = torch.stack([((per_block & (0x11111111 << c)) != 0).any(1)
                       for c in range(4)])
    blocks = _pack_bits(cls.reshape(-1)).view(4, nsuper)
    return _wrap32(words).int(), _wrap32(blocks).int()


def _funnel_tables(p, n, cwords=None):
    """Word-level prefix tables for the deep checks: packed indicator words
    plus exclusive per-word popcount prefixes (allowed read-name bytes; bad
    cigar-op bytes per stride-4 class). ``cwords`` (``bad_op_tables``'
    words, int32) saves packing the bad ops again."""
    allowed = (p >= 0x21) & (p <= 0x7E) & (p != 0x40)
    nwords = _pack_bits(allowed)
    nwpc = _popcount32(nwords)
    nwpre = torch.cumsum(nwpc, 0) - nwpc
    if cwords is None:
        cwords = _pack_bits(_bad_op_bits(p, n))
    else:
        cwords = cwords.long() & _M32
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


def _as_bool(at_eof, dev) -> torch.Tensor:
    if isinstance(at_eof, torch.Tensor):
        return at_eof if at_eof.dtype == torch.bool else at_eof != 0
    return torch.tensor(bool(at_eof), device=dev)


def _chain_walk(padded, n, at_eof, live, start, reads_to_check: int, at,
                moved=None) -> dict:
    """The chain walk of the lanes ``live`` from the positions ``start``,
    line for line the reference's ``_check_lanes`` step: ``at(pi)`` gives
    each lane's flag word, ``remaining`` and body end at the clipped
    positions ``pi``; ``moved(ok, pi, rem, b_end, nxt)``, where given,
    hears each step's cursor move (``ok`` the lanes that step, ``nxt``
    their next physical cursor). Returns the five per-lane outputs."""
    dev = padded.device
    w = padded.numel() - PAD
    capacity = live.numel()
    ae = _as_bool(at_eof, dev)
    logical = start
    physical = logical
    l_overflowed = torch.zeros(capacity, dtype=torch.bool, device=dev)
    res = torch.where(live, 0, -1).to(torch.int8)
    fail_mask = torch.zeros(capacity, dtype=torch.int32, device=dev)
    reads_before = torch.zeros(capacity, dtype=torch.int32, device=dev)
    reads_parsed = torch.zeros(capacity, dtype=torch.int32, device=dev)
    exact = torch.ones(capacity, dtype=torch.bool, device=dev)

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
        flags, rem, b_end = at(pi)
        f = torch.where(run, flags, 0)
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
        # Out-of-range logical cursors collapse to sentinels (±(n+64)) that
        # keep every later comparison; a lane whose cursor would need to
        # re-enter range is flagged via l_overflowed.
        next_logical, next_physical, overflow_now = _step(logical, rem,
                                                           b_end, n)
        if moved is not None:
            moved(ok, pi, rem, b_end, next_physical)
        logical = torch.where(ok, next_logical, logical)
        physical = torch.where(ok, next_physical, physical)
        l_overflowed = l_overflowed | (ok & overflow_now)

    full_chain = live & (res == 0)
    res = torch.where(full_chain, 1, res).to(torch.int8)
    reads_parsed = torch.where(full_chain, reads_to_check, reads_parsed)
    return {"res": res, "fail_mask": fail_mask.int(),
            "reads_before": reads_before.int(),
            "reads_parsed": reads_parsed.int(), "exact": exact}


def _step(logical, rem, b_end, n):
    """One step of the walk's cursors from a record with ``rem`` and
    ``b_end`` (int64): ``(logical, physical, overflow)``, the logical
    cursor clamped to the sentinels ±(n + 64)."""
    bound = n + 64
    next_logical = logical + 4 + rem.clamp(-bound, bound)
    clamped = next_logical.clamp(-bound, bound)
    overflow = (rem > bound) | (rem < -bound) | (next_logical != clamped)
    return clamped, torch.maximum(b_end, clamped).clamp(max=n), overflow


def _walk_lanes(padded, lengths, num_contigs: int, n, at_eof, F, cand,
                n_set, tables, reads_to_check: int = 10,
                funnel: bool = True) -> dict:
    """Plain version of ``walk_lanes``: the chain walk of each survivor
    lane, line for line the reference's ``_check_lanes`` step. Under the
    funnel a walked position that the prefilter passes takes the deep mask
    of its lane from a full-width scatter (0 past the capacity); the full
    pass's flags are looked up as they are. ``tables`` is
    ``bad_op_tables``' output (under the funnel; else unused)."""
    dev = padded.device
    w = padded.numel() - PAD
    live = cand >= 0
    if funnel:
        ft = _funnel_tables(padded, n, cwords=tables[0])
        F_cand = _deep_flags_at(padded, lengths, num_contigs, n, ft,
                                torch.where(live, cand, 0))
        F_cand = torch.where(live, F_cand, 0)
        F_deep = torch.zeros(w + 1, dtype=torch.int32, device=dev)
        F_deep[torch.where(live, cand, w).long()] = F_cand
        F_deep = F_deep[:w]

        def flags_lookup(pi):
            pre = F[pi]
            return torch.where(pre == 0, F_deep[pi], pre)
    else:
        def flags_lookup(pi):
            return F[pi]

    def at(pi):
        return (flags_lookup(pi), *_misc_at(padded, n, pi))

    return _chain_walk(padded, n, at_eof, live,
                       torch.where(live, cand, 0).long(), reads_to_check, at)


def _list_keys(cand, n_set):
    """The survivor list's first min(n_set, capacity) entries, the rest
    above any position: a sorted key for the lower-bound searches."""
    k = torch.arange(cand.numel(), device=cand.device)
    return torch.where(k < n_set, cand.long(), _M32)


def _survivor_table(padded, lengths, num_contigs: int, n, F, cand, n_set,
                    tables, funnel: bool = True) -> torch.Tensor:
    """Plain version of ``survivor_table``: (capacity, 4) int32 entries
    ``(mask, remaining, body_end, successor)`` of the first min(n_set,
    capacity) survivors of ``cand`` (zeros past them). ``mask`` is the
    flag word the walk reads there: ``F``, or under the funnel where ``F``
    is 0 the deep mask (``_deep_flags_at``). Where it is 0: the record's
    ``remaining`` and body end (``_misc_at``), and the list rank of the
    position its step lands on from a logical cursor at the record (where
    that position is in the list; else ``~`` its lower bound), or
    ``NO_SUCC`` where that position is at or past ``n`` or past ``w - 1``;
    where the mask is not 0 the rest is ``(0, 0, NO_SUCC)``."""
    w = padded.numel() - PAD
    cap = cand.numel()
    keys = _list_keys(cand, n_set)
    live = keys < _M32
    q = cand.long().clamp(0, w - 1)
    mask = F[q].long()
    if funnel:
        ft = _funnel_tables(padded, n, cwords=tables[0])
        deep = _deep_flags_at(padded, lengths, num_contigs, n, ft, q).long()
        mask = torch.where(mask == 0, deep, mask)
    rem, b_end = _misc_at(padded, n, q)
    _, nat, _ = _step(q, rem, b_end, n)
    lb = torch.searchsorted(keys, nat)
    hit = keys[lb.clamp(max=cap - 1)] == nat
    succ = torch.where(hit, lb, ~lb)
    walks = mask == 0
    succ = torch.where(walks & (nat < n) & (nat <= w - 1), succ, NO_SUCC)
    entry = torch.stack([mask, torch.where(walks, rem, 0),
                         torch.where(walks, b_end, 0), succ], 1)
    return torch.where(live[:, None], entry, 0).int()


def _walk_from_table(padded, n, at_eof, F, cand, n_set, table,
                     reads_to_check: int = 10) -> dict:
    """The walk of ``csrc/lanes.cu`` over ``survivor_table``'s entries, in
    PyTorch: each lane's cursors as in ``_walk_lanes``, the mask and step
    of a position in the list from its entry (its rank from the previous
    entry's successor where the step landed where that entry says, else
    by a lower-bound search), of a position not in it from ``F`` and the
    record there. Gives ``_walk_lanes``' five per-lane outputs (it is the
    kernel's design, held against the reference in the CPU tests)."""
    w = padded.numel() - PAD
    cap = cand.numel()
    keys = _list_keys(cand, n_set)
    live = keys < _M32
    tab = table.long()
    # Each lane's list rank at or after its position, and whether the
    # position is the entry there.
    lb = torch.arange(cap, device=padded.device)
    have = live

    def at(pi):
        e = tab[lb.clamp(max=cap - 1)]
        spot_rem, spot_end = _misc_at(padded, n, pi)
        return (torch.where(have, e[:, 0], F[pi].long()),
                torch.where(have, e[:, 1], spot_rem),
                torch.where(have, e[:, 2], spot_end))

    def moved(ok, pi, rem, b_end, nxt):
        nonlocal lb, have
        succ = tab[lb.clamp(max=cap - 1), 3]
        _, nat, _ = _step(pi, rem, b_end, n)
        by_succ = have & (succ != NO_SUCC) & (nxt == nat)
        npi = nxt.clamp(0, w - 1)
        found = torch.searchsorted(keys, npi)
        at_found = keys[found.clamp(max=cap - 1)] == npi
        move = ok & (nxt < n)
        lb = torch.where(move, torch.where(
            by_succ, torch.where(succ >= 0, succ, ~succ), found), lb)
        have = torch.where(move, torch.where(by_succ, succ >= 0, at_found),
                           have)

    return _chain_walk(padded, n, at_eof, live,
                       torch.where(live, cand, 0).long(), reads_to_check, at,
                       moved)


def _stage0_escapes(F, at_eof) -> torch.Tensor:
    """Offsets whose stage-0 flags resolve them as escapes (``res0 == 2``)."""
    ae = _as_bool(at_eof, F.device)
    return ((F != 0) & ~ae & ((F & DEFINITIVE_MASK) == 0)
            & ((F & ESCAPE_MASK) != 0))


def _count_lanes(padded, lengths, num_contigs: int, n, at_eof, F, cand,
                 n_set, tables, lo, own, reads_to_check: int = 10,
                 funnel: bool = True) -> torch.Tensor:
    """Plain version of ``count_lanes``: ``_walk_lanes`` reduced over the
    owned span [lo, own) (the reference's funnel ``count_window``), as a
    (3,) int64 ``(count, esc_count, survivors)``; on a capacity overflow
    ``(0, owned offsets, survivors)``."""
    L = _walk_lanes(padded, lengths, num_contigs, n, at_eof, F, cand, n_set,
                    tables, reads_to_check, funnel)
    w = padded.numel() - PAD
    i = torch.arange(w, device=padded.device)
    m = (i >= lo) & (i < own)
    own_lane = (cand >= 0) & (cand >= lo) & (cand < own)
    count = (own_lane & (L["res"] == 1)).sum()
    esc = ((m & _stage0_escapes(F, at_eof)).sum()
           + (own_lane & (L["res"] == 2)).sum())
    overflow = n_set > cand.numel()
    return torch.stack([torch.where(overflow, 0, count),
                        torch.where(overflow, m.sum(), esc),
                        torch.as_tensor(n_set, device=padded.device).long()])


def _compute_flags(p, lengths, num_contigs: int, n) -> torch.Tensor:
    """Plain version of the full pass: all 19 flag bits at every offset of
    the (W + PAD,) window ``p`` (zeros past ``n``), line for line the
    reference's ``checker._compute_flags``: read-name validity from a
    cumulative allowed-byte count, cigar-op validity from stride-4 suffix
    sums of bad-op indicators. Returns (W,) int32."""
    total = p.numel()
    w = total - PAD
    fx = _window_fields(p, w)
    name_len, fnc, seq_len = fx["name_len"], fx["fnc"], fx["seq_len"]
    n_cigar = fnc & 0xFFFF
    mapped = ((fnc >> 18) & 1) == 0
    f = _window_fixed_bits(fx, lengths, num_contigs)

    idx = torch.arange(w, device=p.device)
    name_start = idx + 36
    name_end = name_start + name_len
    has_name = name_len >= 2
    name_eof = has_name & (name_end > n)
    f |= name_eof.long() * BIT["tooFewBytesForReadName"]
    name_in = has_name & ~name_eof
    last_idx = name_end - 1
    non_null = name_in & (_take(p, last_idx) != 0)
    f |= non_null.long() * BIT["nonNullTerminatedReadName"]
    allowed = (p >= 0x21) & (p <= 0x7E) & (p != 0x40)
    acc = torch.cat([torch.zeros(1, dtype=torch.int64, device=p.device),
                     torch.cumsum(allowed, 0)])
    good = _take(acc, last_idx) - _take(acc, name_start)
    bad_chars = name_in & ~non_null & (good != name_len - 1)
    f |= bad_chars.long() * BIT["nonASCIIReadName"]

    # Stride-4 suffix sums, one 1-D scan per class (a scan down dim 0 of a
    # (N/4, 4) view runs PyTorch's slow outer-dim scan kernel on the card).
    bad_op = _bad_op_bits(p, n)
    B = torch.empty(total, dtype=torch.int64, device=p.device)
    for c in range(4):
        B[c::4] = bad_op[c::4].flip(0).cumsum(0).flip(0)
    cig_start = name_start + torch.where(name_in, name_len, 0)
    cig_end = cig_start + 4 * n_cigar
    cig_considered = ~name_eof
    has_bad = cig_considered & ((_take(B, cig_start) - _take(B, cig_end)) > 0)
    f |= has_bad.long() * BIT["invalidCigarOp"]
    cig_eof = cig_considered & ~has_bad & (cig_end > n)
    f |= cig_eof.long() * BIT["tooFewBytesForCigarOps"]
    empty_ok = cig_considered & ~has_bad & ~cig_eof & mapped
    # Swapped on purpose: reference quirk (EmptyMapped binds its fields in
    # the other order).
    f |= (empty_ok & (seq_len == 0)).long() * BIT["emptyMappedCigar"]
    f |= (empty_ok & (n_cigar == 0)).long() * BIT["emptyMappedSeq"]
    return torch.where(idx > n - 36, BIT["tooFewFixedBlockBytes"], f).int()


def _resolve_body(lit: torch.Tensor, dist: torch.Tensor):
    """Plain version of the LZ77 resolve: synchronous pointer doubling with
    early exit. ``lit``/``dist`` are (B, STRIDE) u8/u16 token rows with
    ``dist[i] <= i``. Returns ``(resolved (B, STRIDE) u8, rounds () i32)``;
    ``rounds`` counts doubling rounds including the one that found the
    fixed point (at most 16)."""
    d = dist.view(torch.int16).long() & 0xFFFF
    p = torch.arange(lit.shape[1], device=lit.device)[None, :] - d
    rounds = 0
    while rounds < DOUBLING_ROUNDS:
        nxt = torch.gather(p, 1, p)
        rounds += 1
        done = torch.equal(nxt, p)
        p = nxt
        if done:
            break
    return torch.gather(lit, 1, p), torch.tensor(rounds, dtype=torch.int32)


class TileStatus:
    """A kernel's tile status records (``record`` int32 each), kept per
    CUDA stream between launches: a ticket counter, then one record per
    tile. Zeroed once; each launch on a stream gets the next epoch and the
    ticket base where the previous launch's tickets ended (launches on one
    stream run one after another), so the kernel never needs the records
    cleared. Each kernel that keeps records has its own instance.

    A launch captured into a CUDA graph cannot take tickets and epochs from
    the host: every replay would reuse the captured base and epoch while
    the ticket counters and the records moved on. It gets records of its
    own instead, zeroed by a memset captured just before it, with ticket
    base 0 and epoch 1, so each replay starts from clean records.

    Launches on one stream must run in the order their tickets were
    taken: a caller holds ``ordered`` from ``next`` through its launch, so
    two host threads enqueueing on one stream cannot swap them."""

    def __init__(self, record: int = _RECORD):
        self._record = record
        self._lock = threading.Lock()
        self.ordered = threading.Lock()
        self._streams: dict = {}   # (device, stream) → [records, base, epoch]

    def next(self, device: torch.device, stream: int, tiles: int):
        """``(records, ticket_base, epoch)`` for a launch of ``tiles``
        tiles on ``stream`` (PyTorch's current stream of ``device``)."""
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return (torch.zeros(self._record * (1 + tiles), dtype=torch.int32,
                                device=device), 0, 1)
        key = (device.index, stream)
        with self._lock:
            st = self._streams.get(key)
            size = self._record * (1 + tiles)
            if st is None or st[0].numel() < size or st[2] + 1 >= _EPOCHS:
                st = [torch.zeros(size, dtype=torch.int32, device=device),
                      0, 0]
                self._streams[key] = st
            records, base, epoch = st
            st[1] = (base + tiles) & 0xFFFFFFFF
            st[2] = epoch + 1
            return records, base, epoch + 1

    def drop(self, device: torch.device, stream: int) -> None:
        """Forget a stream's records (after a launch that did not run)."""
        with self._lock:
            self._streams.pop((device.index, stream), None)


_TILE_STATUS = TileStatus()
_PREFILTER_STATUS = TileStatus(_PREFILTER_RECORD)
#: The lane walk's count mode: a ticket counter per stream (one ticket a
#: CTA; the last CTA sums the others' partial counts).
_WALK_STATUS = TileStatus(1)


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(
            f"{name}: expected a {ndim}-D {dtype} tensor, got {t.dim()}-D "
            f"{t.dtype}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: Guards the counters: host threads of one process launch concurrently.
_COUNT_LOCK = threading.Lock()


def _launch(name, fn, *args, device: torch.device) -> None:
    """Call the C entry point ``fn`` on ``device``'s current stream and
    count its launch under ``name`` (a tuple: one under each name, for an
    entry point that launches several kernels)."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    counts = CAPTURED if torch.cuda.is_current_stream_capturing() else LAUNCHES
    with _COUNT_LOCK:
        for k in (name,) if isinstance(name, str) else name:
            counts[k] += 1


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _n_arg(n, dev: torch.device, size: int):
    """The valid byte count for a flag kernel: ``(n, None)`` by value for
    an int, checked to lie in ``[0, size]`` (the padded window) before any
    launch, ``(0, pointer)`` for a 0-d int32 tensor on ``dev``."""
    if not isinstance(n, torch.Tensor):
        if not 0 <= int(n) <= size:
            raise ValueError(f"n = {int(n)} lies outside the {size}-byte "
                             "padded window")
        return int(n), None
    if n.dim() != 0 or n.dtype != torch.int32 or n.device != dev:
        raise TypeError(f"n: expected an int or a 0-d int32 tensor on {dev}, "
                        f"got a {n.dim()}-D {n.dtype} tensor on {n.device}")
    return 0, n.data_ptr()


def _int_arg(x, name: str, dev: torch.device):
    """A scalar for the lane kernels: ``(x, None)`` by value for a Python
    int or bool (inside int32), ``(0, pointer, tensor)`` for a 0-d tensor
    on ``dev`` (an int32 one as it is, another dtype converted on the
    stream). The tensor is returned to keep it alive until the launch."""
    if not isinstance(x, torch.Tensor):
        v = int(x)
        if not -(1 << 31) <= v < 1 << 31:
            raise ValueError(f"{name} = {v} does not fit an int32")
        return v, None, None
    if x.dim() != 0 or x.device != dev:
        raise TypeError(f"{name}: expected an int or a 0-d tensor on {dev}, "
                        f"got a {x.dim()}-D tensor on {x.device}")
    if x.dtype != torch.int32:
        x = x.to(torch.int32)
    return 0, x.data_ptr(), x


_CTAS: dict = {}


def _prefilter_ctas(dev: torch.device) -> int:
    """One wave of the prefilter's persistent CTAs on ``dev``."""
    if dev.index not in _CTAS:
        lib = load()
        with torch.cuda.device(dev):
            ctas = int(lib.sbt_prefilter_ctas())
        if ctas <= 0:
            raise RuntimeError("sbt_prefilter_ctas found no room for a CTA")
        _CTAS[dev.index] = ctas
    return _CTAS[dev.index]


def prefilter_check_flags(padded: torch.Tensor, lengths: torch.Tensor,
                          num_contigs: int, n):
    """Stage-0 funnel bits at every offset of a (W + PAD,) u8 window and
    its survivors, compacted into ``lane_capacity(W)`` lanes; ``lengths``
    is the padded (Cmax,) i32 contig table and ``n`` the valid byte count
    (an int, or a 0-d int32 tensor on the window's device).
    Returns ``(F (W,) i32, cand (capacity,) i32, n_set () i32)``, as
    ``_prefilter_compact``.

    Replaces ``pallas_kernels.py::prefilter_check_flags`` and the check's
    ``_compact_mask`` behind it, in one launch. Bound by issue slots (~69
    instructions an offset; its bytes, one in and four out an offset,
    would take 0.051 ms at W = 2^25): one wave of persistent CTAs takes
    16 KiB tiles by ticket, stages each in shared memory by one bulk async
    copy, 4 offsets a thread from nine shared words with one 16-byte
    store, and packs the survivors by warp ballot into a bitmap (2 KiB a
    tile of scratch) with its count; then, by a second ticket in tile
    order, ranks each tile's survivors by a block scan and a decoupled
    look-back over epoch-tagged tile records (kept per stream,
    ``TileStatus``) and writes them in increasing order. ``padded`` must
    start on a 16-byte boundary."""
    w = padded.numel() - PAD
    capacity = lane_capacity(w)
    if not _on_cuda(padded):
        return _prefilter_compact(padded, lengths, num_contigs, n, capacity)
    dev = padded.device
    _check(padded, "padded", torch.uint8, 1, dev)
    _check(lengths, "lengths", torch.int32, 1, dev)
    if w <= 0 or lengths.numel() == 0 or num_contigs < 0:
        raise ValueError("padded must exceed PAD bytes; lengths non-empty; "
                         "num_contigs not negative")
    if padded.numel() >= 1 << 31:
        raise ValueError("the window must hold fewer than 2^31 bytes")
    if padded.data_ptr() % 16:
        raise ValueError("padded must start on a 16-byte boundary")
    n_val, n_ptr = _n_arg(n, dev, padded.numel())
    tiles = -(-w // PREFILTER_TILE)
    grid = min(tiles, _prefilter_ctas(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(w, dtype=torch.int32, device=dev)
    bitmaps = torch.empty(tiles * PREFILTER_TILE // 32, dtype=torch.int32,
                          device=dev)
    cand = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    n_set = torch.empty((), dtype=torch.int32, device=dev)
    with _PREFILTER_STATUS.ordered:
        # In each of its two phases each CTA takes one ticket past the
        # last tile.
        records, base, epoch = _PREFILTER_STATUS.next(dev, stream,
                                                      tiles + grid)
        try:
            _launch("prefilter_check_flags", "sbt_prefilter",
                    padded.data_ptr(), w, lengths.data_ptr(), lengths.numel(),
                    int(num_contigs), n_val, n_ptr, records.data_ptr(), base,
                    epoch, out.data_ptr(), bitmaps.data_ptr(),
                    cand.data_ptr(), capacity, n_set.data_ptr(), grid,
                    device=dev)
        except RuntimeError:
            _PREFILTER_STATUS.drop(dev, stream)
            raise
    return out, cand, n_set


def full_check_flags(padded: torch.Tensor, lengths: torch.Tensor,
                     num_contigs: int, n) -> torch.Tensor:
    """All 19 flag bits at every offset of a (W + PAD,) u8 window (zeros
    past ``n``, an int or a 0-d int32 tensor on the window's device);
    ``lengths`` is the padded (Cmax,) i32 contig table.
    Returns (W,) i32.

    Replaces ``pallas_kernels.py::full_check_flags``. Bound by bytes (one
    in, four out per offset); one launch over 16 KiB tiles held in shared
    memory with 512 bytes of lookahead, the first bad cigar op past each
    tile's region from the status records of the 17 tiles after it (kept
    per stream, ``TileStatus``), 4 offsets a thread. No offset loops over
    its cigar or its name. ``padded`` must start on a 16-byte boundary."""
    if not _on_cuda(padded):
        return _compute_flags(padded, lengths, num_contigs, n)
    dev = padded.device
    _check(padded, "padded", torch.uint8, 1, dev)
    _check(lengths, "lengths", torch.int32, 1, dev)
    w = padded.numel() - PAD
    if w <= 0 or w % 4 or lengths.numel() == 0 or num_contigs < 0:
        raise ValueError("padded must be PAD plus a positive multiple of 4 "
                         "bytes; lengths non-empty; num_contigs not "
                         "negative")
    if padded.numel() >= 1 << 31:
        raise ValueError("the window must hold fewer than 2^31 bytes")
    if padded.data_ptr() % 16:
        raise ValueError("padded must start on a 16-byte boundary")
    n_val, n_ptr = _n_arg(n, dev, padded.numel())
    tiles = -(-padded.numel() // FULL_FLAGS_TILE)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(w, dtype=torch.int32, device=dev)
    with _TILE_STATUS.ordered:
        records, base, epoch = _TILE_STATUS.next(dev, stream, tiles)
        try:
            _launch("full_check_flags", "sbt_full_flags", padded.data_ptr(),
                    padded.numel(), w, lengths.data_ptr(), lengths.numel(),
                    int(num_contigs), n_val, n_ptr, records.data_ptr(), base,
                    epoch, out.data_ptr(), device=dev)
        except RuntimeError:
            _TILE_STATUS.drop(dev, stream)
            raise
    return out


def lz77_resolve(lit: torch.Tensor, dist: torch.Tensor,
                 out: torch.Tensor | None = None):
    """Resolve (B, STRIDE) u8/u16 token rows to bytes. Returns
    ``(resolved (B, STRIDE) u8, rounds () i32)``. ``out`` may be ``lit``
    itself (the kernel resolves in place safely).

    Replaces ``pallas_kernels.py::lz77_resolve_pallas``. Bound by bytes
    (~4 per output byte); one CTA per row holds the row (bulk async
    copies) with uint16 parents in shared memory and jumps it in chunks of
    4,096 positions in increasing order, so the pointer jumping never
    touches device memory. Its ``rounds`` (the most any chunk took) may
    be fewer than the plain version's. The three tensors must start on
    16-byte boundaries (fresh tensors do)."""
    if not _on_cuda(lit):
        res, rounds = _resolve_body(lit, dist)
        if out is not None:
            out.copy_(res)
            res = out
        return res, rounds
    dev = lit.device
    _check(lit, "lit", torch.uint8, 2, dev)
    _check(dist, "dist", torch.uint16, 2, dev)
    if lit.shape[1] != STRIDE or dist.shape != lit.shape:
        raise ValueError(f"token rows must be (B, {STRIDE}), got "
                         f"{tuple(lit.shape)} / {tuple(dist.shape)}")
    if out is None:
        out = torch.empty_like(lit)
    _check(out, "out", torch.uint8, 2, dev)
    if out.shape != lit.shape:
        raise ValueError("out must have lit's shape")
    if any(t.data_ptr() % 16 for t in (lit, dist, out)):
        raise ValueError("lit, dist and out must start on 16-byte boundaries")
    rounds = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch("lz77_resolve", "sbt_lz77_resolve", lit.data_ptr(),
            dist.data_ptr(), lit.shape[0], out.data_ptr(), rounds.data_ptr(),
            device=dev)
    return out, rounds[0]


def tokenize(staged: torch.Tensor, clens: torch.Tensor):
    """Entropy-decode (B, C_pad) u8 raw-DEFLATE rows (``clens`` (B,) i32,
    C_pad ≥ clen + 8) into ``(lit (B, S) u8, dist (B, S) u16, out_lens (B,)
    i32, ok (B,) bool)``; see ``tpu/tokenize_device.py`` for the contract.

    Replaces ``pallas_kernels.py::tokenize_pallas``. Bound by the latency
    of the serial symbol chain of the longest row, not bytes. A warp per
    row (one CTA each) walks the bits in lockstep through two-level decode
    tables in shared memory (12-bit litlen root whose entries give two
    literals where both codes fit, 8-bit distance root, subtables for
    longer codes); its lanes split the table builds, match fills and
    stored copies. ~130 cycles per symbol on the H100 (PERF.md). The
    planes are zero-filled here; the kernel writes only the non-zero
    bytes. ``staged`` must start on a 16-byte boundary."""
    if not _on_cuda(staged):
        return tokenize_plain(staged, clens)
    dev = staged.device
    _check(staged, "staged", torch.uint8, 2, dev)
    _check(clens, "clens", torch.int32, 1, dev)
    b, c_pad = staged.shape
    if clens.numel() != b or c_pad < 16:
        raise ValueError("clens must have one entry per staged row; "
                         "C_pad must be at least 16")
    if staged.data_ptr() % 16:
        raise ValueError("staged must start on a 16-byte boundary")
    lit = torch.zeros((b, STRIDE), dtype=torch.uint8, device=dev)
    dist = torch.zeros((b, STRIDE), dtype=torch.int16, device=dev).view(
        torch.uint16)
    out_lens = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    _launch("tokenize", "sbt_tokenize", staged.data_ptr(), clens.data_ptr(),
            b, c_pad, lit.data_ptr(), dist.data_ptr(), out_lens.data_ptr(),
            ok.data_ptr(), device=dev)
    return lit, dist, out_lens, ok


def bad_op_tables(padded: torch.Tensor, n):
    """The bad cigar-op tables of a (W + PAD,) u8 window holding ``n``
    valid bytes (an int, or a 0-d int32 tensor on the window's device):
    ``(words (ceil((W + PAD) / 32),) i32, blocks (4, ceil((W + PAD) /
    32768)) i32)``, as ``_bad_op_tables``. ``walk_lanes`` answers "a bad op
    of class c in [a, b)" from them in a bounded number of reads.

    Replaces the reference's ``_funnel_tables`` (its ``cwords`` are
    ``words``, bit for bit) with ``_badops_before``. Bound by bytes (W +
    PAD in, an eighth of that out): a warp packs 32 KiB, 32 bits a lane a
    step, and ballots one class summary word for it; no CTA depends on
    another. ``padded`` must start on a 16-byte boundary."""
    if not _on_cuda(padded):
        return _bad_op_tables(padded, n)
    dev = padded.device
    _check(padded, "padded", torch.uint8, 1, dev)
    total = padded.numel()
    if total <= PAD or total >= 1 << 31:
        raise ValueError("padded must hold more than PAD and fewer than "
                         "2^31 bytes")
    if padded.data_ptr() % 16:
        raise ValueError("padded must start on a 16-byte boundary")
    n_val, n_ptr = _n_arg(n, dev, total)
    nwords = -(-total // 32)
    nsuper = -(-nwords // _SUPER_WORDS)
    words = torch.empty(nwords, dtype=torch.int32, device=dev)
    blocks = torch.empty((4, nsuper), dtype=torch.int32, device=dev)
    _launch("bad_op_tables", "sbt_bad_op_tables", padded.data_ptr(), total,
            n_val, n_ptr, words.data_ptr(), nwords, blocks.data_ptr(),
            nsuper, device=dev)
    return words, blocks


_LANE_CTAS: dict = {}


def _lane_grid(dev: torch.device, capacity: int) -> int:
    """CTAs of the survivor table and the walk: one wave on ``dev``
    (``sbt_lanes_ctas``), fewer for a short list. Both loop over the
    survivors present, read from device memory, so the grid depends on
    the capacity alone and a captured launch stays right for any
    ``n_set``."""
    if dev.index not in _LANE_CTAS:
        lib = load()
        with torch.cuda.device(dev):
            ctas = int(lib.sbt_lanes_ctas())
        if ctas <= 0:
            raise RuntimeError("sbt_lanes_ctas found no room for a CTA")
        _LANE_CTAS[dev.index] = ctas
    return min(_LANE_CTAS[dev.index], -(-capacity // WALK_THREADS))


def _walk_args(padded, lengths, num_contigs, n, at_eof, F, cand, n_set,
               tables, funnel):
    """Checks shared by ``survivor_table``, ``walk_lanes`` and
    ``count_lanes``: the survivor table's leading arguments (up to
    ``funnel``; the walk's too), ``at_eof``'s two, and the tensors they
    point to."""
    dev = padded.device
    _check(padded, "padded", torch.uint8, 1, dev)
    _check(lengths, "lengths", torch.int32, 1, dev)
    total = padded.numel()
    w = total - PAD
    _check(F, "F", torch.int32, 1, dev)
    _check(cand, "cand", torch.int32, 1, dev)
    if w <= 0 or total >= 1 << 31 or F.numel() != w:
        raise ValueError("padded must hold PAD plus W > 0 bytes, fewer than "
                         "2^31, and F one flag word an offset")
    if cand.numel() == 0 or lengths.numel() == 0 or num_contigs < 0:
        raise ValueError("cand and lengths non-empty; num_contigs not "
                         "negative")
    if padded.data_ptr() % 16:
        raise ValueError("padded must start on a 16-byte boundary")
    if not isinstance(n_set, torch.Tensor) or n_set.dim() != 0 \
            or n_set.device != dev:
        raise TypeError("n_set must be a 0-d tensor on the window's device")
    if n_set.dtype != torch.int32:
        n_set = n_set.to(torch.int32)
    n_val, n_ptr = _n_arg(n, dev, total)
    ae_val, ae_ptr, ae_t = _int_arg(at_eof, "at_eof", dev)
    if funnel:
        words, blocks = tables
        _check(words, "words", torch.int32, 1, dev)
        _check(blocks, "blocks", torch.int32, 2, dev)
        nsuper = blocks.shape[1]
        if words.numel() != -(-total // 32) or blocks.shape[0] != 4 \
                or nsuper != -(-words.numel() // _SUPER_WORDS):
            raise ValueError("tables must be bad_op_tables' of this window")
        w_ptr, b_ptr = words.data_ptr(), blocks.data_ptr()
    else:
        w_ptr = b_ptr = None
        nsuper = 0
    args = (padded.data_ptr(), total, w, lengths.data_ptr(), lengths.numel(),
            int(num_contigs), n_val, n_ptr, F.data_ptr(), cand.data_ptr(),
            cand.numel(), n_set.data_ptr(), w_ptr, b_ptr, nsuper,
            int(bool(funnel)))
    return args, (ae_val, ae_ptr), (n_set, ae_t)


def survivor_table(padded: torch.Tensor, lengths: torch.Tensor,
                   num_contigs: int, n, F: torch.Tensor, cand: torch.Tensor,
                   n_set, tables, funnel: bool = True) -> torch.Tensor:
    """The (capacity, 4) int32 entries ``(mask, remaining, body_end,
    successor)`` of the first min(n_set, capacity) survivors of ``cand``
    (the compacted survivor list of a (W + PAD,) u8 window, in increasing
    order; ``F`` its stage-0 flags, ``tables`` ``bad_op_tables``' under
    ``funnel``), as ``_survivor_table``; the rows past them are left
    unwritten on a card (zeros on the CPU). ``walk_lanes`` and
    ``count_lanes`` launch it first, in the same call.

    Replaces the reference's ``_deep_flags_at`` and ``_misc_at`` at the
    survivors. A thread a survivor, over the ``n_set`` present (read from
    device memory): the deep mask (names by 16-byte loads and SIMD byte
    compares, cigars from the bad-op tables), the record's step and the
    list rank where it lands, each once, so that the walk's lanes read
    16 bytes where they land instead of computing it again
    (``csrc/lanes.cu``)."""
    if not _on_cuda(padded):
        return _survivor_table(padded, lengths, num_contigs, n, F, cand,
                               n_set, tables, funnel)
    dev = padded.device
    args, _, keep = _walk_args(padded, lengths, num_contigs, n, 0, F, cand,
                               n_set, tables, funnel)
    table = torch.empty((cand.numel(), 4), dtype=torch.int32, device=dev)
    _launch("survivor_table", "sbt_survivor_table", *args, table.data_ptr(),
            _lane_grid(dev, cand.numel()), device=dev)
    del keep
    return table


#: The launches of one ``sbt_walk_lanes`` call: the table, then the walk.
_WALK_LAUNCHES = ("survivor_table", "walk_lanes")


def walk_lanes(padded: torch.Tensor, lengths: torch.Tensor, num_contigs: int,
               n, at_eof, F: torch.Tensor, cand: torch.Tensor, n_set,
               tables, reads_to_check: int = 10, funnel: bool = True) -> dict:
    """The chain walk of every survivor lane of a (W + PAD,) u8 window:
    ``F`` (W,) i32 the stage-0 flags (the prefilter's under ``funnel``,
    else the full pass's), ``cand`` (capacity,) i32 the compacted survivors
    (-1 past them), ``n_set`` the () i32 survivor count, ``tables``
    ``bad_op_tables``' (unused without the funnel); ``n`` and ``at_eof``
    ints or 0-d tensors on the window's device. Returns (capacity,)
    ``res`` i8, ``fail_mask``, ``reads_before``, ``reads_parsed`` i32 and
    ``exact`` bool, as ``_walk_lanes``.

    Replaces the walk of the reference's ``_check_lanes``. One call, two
    launches: ``survivor_table`` (each survivor's mask and step, once),
    then a thread a lane over the survivors present that reads the table
    where its chain lands (a survivor past the capacity walks as mask 0,
    as in the reference's scatter; ``csrc/lanes.cu``)."""
    if not _on_cuda(padded):
        return _walk_lanes(padded, lengths, num_contigs, n, at_eof, F, cand,
                           n_set, tables, reads_to_check, funnel)
    if reads_to_check < 0:
        raise ValueError("reads_to_check must not be negative")
    dev = padded.device
    args, ae, keep = _walk_args(padded, lengths, num_contigs, n, at_eof, F,
                                cand, n_set, tables, funnel)
    cap = cand.numel()
    table = torch.empty((cap, 4), dtype=torch.int32, device=dev)
    out = {"res": torch.empty(cap, dtype=torch.int8, device=dev),
           "fail_mask": torch.empty(cap, dtype=torch.int32, device=dev),
           "reads_before": torch.empty(cap, dtype=torch.int32, device=dev),
           "reads_parsed": torch.empty(cap, dtype=torch.int32, device=dev),
           "exact": torch.empty(cap, dtype=torch.bool, device=dev)}
    _launch(_WALK_LAUNCHES, "sbt_walk_lanes", *args, *ae, table.data_ptr(),
            int(reads_to_check),
            *(out[k].data_ptr() for k in ("res", "fail_mask", "reads_before",
                                          "reads_parsed", "exact")),
            0, None, 0, None, None, 0, None, None, _lane_grid(dev, cap),
            device=dev)
    del keep
    return out


def count_lanes(padded: torch.Tensor, lengths: torch.Tensor, num_contigs: int,
                n, at_eof, F: torch.Tensor, cand: torch.Tensor, n_set, tables,
                lo, own, reads_to_check: int = 10,
                funnel: bool = True) -> torch.Tensor:
    """``walk_lanes`` reduced over the owned span [lo, own): the (3,)
    int64 ``(count, esc_count, survivors)`` of ``_count_lanes`` (``lo``
    and ``own`` ints or 0-d tensors on the window's device). After the
    survivor table, one launch writes no per-lane output: each CTA counts
    its owned lanes that pass or escape, or a grid-stride share of the
    owned offsets that stage 0 resolves as escapes (16-byte loads of
    ``F``), and the last CTA to take a ticket (kept per stream,
    ``TileStatus``; a captured launch gets its own counter, zeroed before
    the table's launch) sums the CTAs' partial counts."""
    if not _on_cuda(padded):
        return _count_lanes(padded, lengths, num_contigs, n, at_eof, F, cand,
                            n_set, tables, lo, own, reads_to_check, funnel)
    if reads_to_check < 0:
        raise ValueError("reads_to_check must not be negative")
    dev = padded.device
    args, ae, keep = _walk_args(padded, lengths, num_contigs, n, at_eof, F,
                                cand, n_set, tables, funnel)
    lo_val, lo_ptr, lo_t = _int_arg(lo, "lo", dev)
    own_val, own_ptr, own_t = _int_arg(own, "own", dev)
    cap = cand.numel()
    grid = _lane_grid(dev, cap)
    table = torch.empty((cap, 4), dtype=torch.int32, device=dev)
    partials = torch.empty(2 * grid, dtype=torch.int32, device=dev)
    out = torch.empty(3, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _WALK_STATUS.ordered:
        records, base, _epoch = _WALK_STATUS.next(dev, stream, grid)
        try:
            _launch(_WALK_LAUNCHES, "sbt_walk_lanes", *args, *ae,
                    table.data_ptr(), int(reads_to_check),
                    None, None, None, None, None, lo_val, lo_ptr, own_val,
                    own_ptr, records.data_ptr(), base, partials.data_ptr(),
                    out.data_ptr(), grid, device=dev)
        except RuntimeError:
            _WALK_STATUS.drop(dev, stream)
            raise
    del keep, lo_t, own_t
    return out
