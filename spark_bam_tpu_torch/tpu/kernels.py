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

What bounds each on the H100 and how its design answers is noted at the
top of its source. The tokenizer's plain version is the Python decoder in
``tpu/tokenize_device.py`` (a bit-serial decoder has no tensor form).
"""

from __future__ import annotations

import threading

import torch

from spark_bam_tpu_torch.check.flags import BIT
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

LAUNCHES = {"prefilter_check_flags": 0, "full_check_flags": 0,
            "lz77_resolve": 0, "tokenize": 0,
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
    j = torch.arange(total, device=p.device)
    bad_op = ((p & 0xF) > 8) & (j + 4 <= n)
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


def _launch(name: str, fn, *args, device: torch.device) -> None:
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
    counts = CAPTURED if torch.cuda.is_current_stream_capturing() else LAUNCHES
    with _COUNT_LOCK:
        counts[name] += 1


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
