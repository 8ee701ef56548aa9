"""Batched BAM record parsing on the device (reference ``spark_bam_tpu/
tpu/parser.py``).

Given a flat uncompressed buffer and the record starts the checker found,
every fixed field of every record comes out of one gather pass as a
column, and the interval/flag filter runs where the columns are. The
streaming load parses each window on the device tensor the check already
holds (``parse_window``); ``parse_flat_records`` is the host entry that
pads and uploads a host buffer (spills, the whole-file load).

Reference spans (for interval overlap) come from a bounded scan of
``CIGAR_SCAN_CAP`` cigar ops; rows with more ops are flagged and finished
on the host, exactly. Every column is int32 as the reference's are: field
words are composed in int64 and wrapped to int32 (two's complement), and
the span sums wrap as an int32 sum does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from spark_bam_tpu_torch.bam.record import reference_span
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.tpu.kernels import _take, _wrap32

CIGAR_SCAN_CAP = 64  # ops scanned on the device; beyond ⇒ host fix-up

# Cigar ops that consume reference bases: M, D, N, =, X.
_REF_CONSUMING = (1 << 0) | (1 << 2) | (1 << 3) | (1 << 7) | (1 << 8)

#: Column order of a parse: sorted by name, as the reference's jitted
#: dict comes back.
COLUMNS = ("bin", "block_size", "flag", "l_read_name", "l_seq", "mapq",
           "n_cigar", "name_offset", "next_pos", "next_ref_id", "pos",
           "ref_id", "ref_span", "span_exact", "tlen", "valid")
_BOOL_COLUMNS = ("valid", "span_exact")


#: Records parsed per gather pass (bounds the (rows, 4 × cap) gathers).
PARSE_CHUNK = 1 << 17


def _words(p: torch.Tensor, at: torch.Tensor, k: int) -> torch.Tensor:
    """(M, k) little-endian int32 words at byte offsets ``at[:, None] +
    4j``: one gather of 4k bytes a row, each byte's index clamped to ``p``
    as ``jnp.take(..., mode="clip")`` clamps, viewed as int32 (the two's
    complement of each u32)."""
    idx = at[:, None] + torch.arange(4 * k, device=p.device)
    return _take(p, idx).view(torch.int32)


def _parse_chunk(padded, starts, cigar_cap: int) -> dict:
    valid = starts >= 0
    s = starts.long().clamp(min=0)
    (block_size, ref_id, pos, lnm, fnc, l_seq, next_ref_id, next_pos,
     tlen) = _words(padded, s, 9).unbind(1)
    l_read_name = lnm & 0xFF
    n_cigar = fnc & 0xFFFF

    # Bounded cigar scan: ref span = Σ len over ref-consuming ops, an int32
    # sum (it wraps past 2^31 as the reference's does).
    ops = _words(padded, s + 36 + l_read_name, cigar_cap)
    consumes = ((_REF_CONSUMING >> (ops & 0xF)) & 1) == 1
    ks = torch.arange(cigar_cap, device=padded.device)
    in_range = ks[None, :] < n_cigar[:, None]
    length = (ops >> 4) & 0x0FFFFFFF
    span = _wrap32(torch.where(consumes & in_range, length, 0)
                   .sum(1, dtype=torch.int64)).int()
    return {
        "bin": (lnm >> 16) & 0xFFFF, "block_size": block_size,
        "flag": (fnc >> 16) & 0xFFFF, "l_read_name": l_read_name,
        "l_seq": l_seq, "mapq": (lnm >> 8) & 0xFF, "n_cigar": n_cigar,
        "name_offset": (s + 36).int(), "next_pos": next_pos,
        "next_ref_id": next_ref_id, "pos": pos, "ref_id": ref_id,
        "ref_span": span, "span_exact": n_cigar <= cigar_cap, "tlen": tlen,
        "valid": valid,
    }


def parse_records(padded: torch.Tensor, starts: torch.Tensor,
                  cigar_cap: int = CIGAR_SCAN_CAP) -> dict:
    """Columnar fixed-field extraction for M records.

    ``padded`` is a (N + pad,) u8 tensor (zeros past the data), ``starts``
    (M,) int32 record offsets (padding: -1) on the same device. Returns a
    dict of (M,) tensors in ``COLUMNS`` order: int32 fields, ``valid``
    masking real rows and ``span_exact`` marking rows whose reference span
    the scan resolved. Each ``PARSE_CHUNK`` rows take two gathers: the 36
    fixed bytes and ``4 * cigar_cap`` cigar bytes."""
    parts = [_parse_chunk(padded, starts[i: i + PARSE_CHUNK], cigar_cap)
             for i in range(0, max(starts.numel(), 1), PARSE_CHUNK)]
    if len(parts) == 1:
        return {k: parts[0][k] for k in COLUMNS}
    return {k: torch.cat([c[k] for c in parts]) for k in COLUMNS}


def interval_flag_filter(cols: dict, intervals: torch.Tensor,
                         flags_required: int, flags_forbidden: int
                         ) -> torch.Tensor:
    """Record filter: genomic interval overlap and SAM flag masks over
    (M,) column tensors, ``intervals`` (R, 3) int32 rows of (ref_id, start,
    end). Unmapped reads never overlap an interval (reference
    loadBamIntervals region semantics, CanLoadBam.scala:109-133)."""
    pos = cols["pos"].long()
    end = _wrap32(pos + cols["ref_span"].long().clamp(min=1))
    ref = cols["ref_id"].long()
    flag = cols["flag"].long()
    mapped = (flag & 4) == 0
    ivs = intervals.long()
    overlap = (
        (ref[:, None] == ivs[None, :, 0])
        & (pos[:, None] < ivs[None, :, 2])
        & (ivs[None, :, 1] < end[:, None])
    ).any(dim=1)
    fr = int(np.int32(flags_required))
    ff = int(np.int32(flags_forbidden))
    flag_ok = ((flag & fr) == fr) & ((flag & ff) == 0)
    return cols["valid"] & mapped & (ref >= 0) & overlap & flag_ok


_SEQ_CODES = "=ACMGRSVTWYHKDBN"


@dataclass
class ReadBatch:
    """Columnar batch of parsed records (host NumPy arrays).

    Fixed fields live in ``columns``; variable-length payloads (name, seq,
    qual) materialize lazily from the flat buffer on demand.
    """

    columns: dict[str, np.ndarray]
    starts: np.ndarray
    buf: np.ndarray | None = None

    def __len__(self) -> int:
        return int(self.columns["valid"].sum())

    def __getitem__(self, key: str) -> np.ndarray:
        return self.columns[key][self.columns["valid"]]

    # ---- lazy variable-length payloads (row index is pre-filter) ----
    def name(self, i: int) -> str:
        off = int(self.columns["name_offset"][i])
        ln = int(self.columns["l_read_name"][i])
        return bytes(self.buf[off: off + ln - 1]).decode("latin-1")

    def seq(self, i: int) -> str:
        off = (
            int(self.columns["name_offset"][i])
            + int(self.columns["l_read_name"][i])
            + 4 * int(self.columns["n_cigar"][i])
        )
        n = int(self.columns["l_seq"][i])
        packed = self.buf[off: off + (n + 1) // 2]
        return "".join(
            _SEQ_CODES[(packed[k >> 1] >> (4 if k % 2 == 0 else 0)) & 0xF]
            for k in range(n)
        )

    def qual(self, i: int) -> bytes:
        n = int(self.columns["l_seq"][i])
        off = (
            int(self.columns["name_offset"][i])
            + int(self.columns["l_read_name"][i])
            + 4 * int(self.columns["n_cigar"][i])
            + (n + 1) // 2
        )
        return bytes(self.buf[off: off + n])


def _next_pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


_SIDE_STREAMS: dict = {}
_SIDE_LOCK = threading.Lock()


def _columns_to_host(cols: dict) -> dict[str, np.ndarray]:
    """Device columns as host arrays: one (16, M) int32 stack, copied back
    through pinned memory on CUDA; ``valid``/``span_exact`` as bool."""
    stack = torch.stack([cols[k].int() for k in COLUMNS])
    if stack.is_cuda:
        host = torch.empty(stack.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(stack, non_blocking=True)
        torch.cuda.current_stream(stack.device).synchronize()
    else:
        host = stack
    arr = host.numpy()
    return {k: arr[i].astype(bool) if k in _BOOL_COLUMNS else arr[i]
            for i, k in enumerate(COLUMNS)}


def parse_window(padded: torch.Tensor, buf: np.ndarray,
                 starts: np.ndarray) -> ReadBatch:
    """Parse the records at ``starts`` (host offsets into ``buf``) on the
    device tensor ``padded`` that holds ``buf``'s bytes, zeros after them;
    only the starts go up and only the columns come back. On CUDA it runs
    on a side stream, so it overlaps the window already queued behind this
    one; the caller has waited for ``padded``'s bytes. Rows whose cigar
    outruns the scan get their span on the host, from ``buf``."""
    dev = padded.device
    if padded.is_cuda:
        with _SIDE_LOCK:
            side = _SIDE_STREAMS.get(dev)
            if side is None:
                side = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            cols = parse_records(
                padded, torch.from_numpy(starts.astype(np.int32)).to(dev))
            host = _columns_to_host(cols)
    else:
        host = _columns_to_host(parse_records(
            padded, torch.from_numpy(starts.astype(np.int32))))
    inexact = np.flatnonzero(host["valid"] & ~host["span_exact"])
    for i in inexact:
        host["ref_span"][i] = reference_span(buf, int(starts[i]))
    host["span_exact"][inexact] = True
    return ReadBatch(host, starts, buf=np.asarray(buf))


def parse_flat_records(buf: np.ndarray, starts: np.ndarray,
                       pad: int = 300_000, device=None) -> ReadBatch:
    """Host entry: pad the buffer to ``pow2(len) + pad`` zeros, upload it,
    parse on the device and fix up rows whose cigar exceeded the scan."""
    dev = resolve_device(device)
    padded = np.zeros(_next_pow2(len(buf)) + pad, dtype=np.uint8)
    padded[: len(buf)] = buf
    return parse_window(torch.from_numpy(padded).to(dev), buf, starts)
