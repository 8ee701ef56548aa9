"""ReadBatch → RecordBatch: schema batches from the device parse
(reference ``spark_bam_tpu/columnar/from_parser.py``).

The parse (``tpu/parser.py``) holds every fixed field as an int32 plane
and the flat buffer the variable-length payloads live in. The
renderings here match ``BamRecord.decode`` byte for byte: the name
without its NUL, the cigar string (``*`` without ops), the sequence's
letters, and the raw ``qual`` and ``tags`` bytes (``tags``: everything
from after ``qual`` through ``start + 4 + block_size``, parsed or not).

``render_columns`` renders every row of a batch at once: per column the
rows' byte ranges (Python slice semantics, so a range past the buffer
clips as the reference's slice does), an exclusive cumsum for the
offsets, then one gather for the values. ``_var_piece`` renders one row
in Python, as the reference does; it is the plain version the tests hold
the vectorized one against, and nothing on the export path calls it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from spark_bam_tpu_torch.columnar.schema import (
    FIXED_COLUMNS,
    RecordBatch,
    VarColumn,
    normalize_columns,
    slice_batch,
)

CIGAR_OPS = "MIDNSHP=X"
SEQ_CODES = "=ACMGRSVTWYHKDBN"

_SEQ_LUT = np.frombuffer(SEQ_CODES.encode("ascii"), dtype=np.uint8)
#: Packed sequence byte → its two letters (high nibble first), as the
#: uint16 whose little-endian bytes they are.
_SEQ_PAIRS = np.ascontiguousarray(np.stack(
    [_SEQ_LUT[np.arange(256) >> 4], _SEQ_LUT[np.arange(256) & 0xF]],
    axis=1)).view("<u2").ravel()
_OP_LUT = np.frombuffer(CIGAR_OPS.encode("ascii"), dtype=np.uint8)
#: Decimal digits a cigar length (< 2^28) can take.
_MAX_DIGITS = 9
_POW10 = 10 ** np.arange(_MAX_DIGITS + 1, dtype=np.int64)


def _var_piece(name: str, batch, i: int) -> bytes:
    """One row's rendering of a variable-length column, straight from the
    flat buffer (the plain version of :func:`render_columns`)."""
    cols = batch.columns
    buf = batch.buf
    start = int(batch.starts[i])
    name_off = int(cols["name_offset"][i])
    l_name = int(cols["l_read_name"][i])
    n_cigar = int(cols["n_cigar"][i])
    l_seq = int(cols["l_seq"][i])
    cig_off = name_off + l_name
    seq_off = cig_off + 4 * n_cigar
    qual_off = seq_off + (l_seq + 1) // 2
    if name == "name":
        return bytes(buf[name_off: name_off + l_name - 1])
    if name == "cigar":
        if n_cigar == 0:
            return b"*"
        ops = np.frombuffer(
            bytes(buf[cig_off: cig_off + 4 * n_cigar]), dtype="<u4"
        )
        return "".join(
            f"{int(v) >> 4}{CIGAR_OPS[int(v) & 0xF]}" for v in ops
        ).encode("latin-1")
    if name == "seq":
        if l_seq == 0:
            return b""
        packed = np.frombuffer(
            bytes(buf[seq_off: seq_off + (l_seq + 1) // 2]), dtype=np.uint8
        )
        nibbles = np.empty(2 * len(packed), dtype=np.uint8)
        nibbles[0::2] = packed >> 4
        nibbles[1::2] = packed & 0xF
        return _SEQ_LUT[nibbles[:l_seq]].tobytes()
    if name == "qual":
        return bytes(buf[qual_off: qual_off + l_seq])
    end = start + 4 + int(cols["block_size"][i])
    return bytes(buf[qual_off + l_seq: end])


def _slice_bounds(lo: np.ndarray, hi: np.ndarray, n: int):
    """``buf[lo:hi]``'s start and length for each row, as Python resolves
    a step-1 slice of an ``n``-byte buffer."""
    lo = np.where(lo < 0, lo + n, lo).clip(0, n)
    hi = np.where(hi < 0, hi + n, hi).clip(0, n)
    return lo, np.maximum(hi - lo, 0)


def _offsets(lens: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=out[1:])
    return out


def _gather(buf: np.ndarray, lo: np.ndarray, lens: np.ndarray) -> VarColumn:
    """The rows' byte ranges ``buf[lo : lo + lens]``, concatenated: one
    index per byte (int32 where the buffer allows), one ``take``."""
    offsets = _offsets(lens)
    total = int(offsets[-1])
    it = np.int32 if max(len(buf), total) < 1 << 31 else np.int64
    idx = np.arange(total, dtype=it)
    idx += np.repeat((lo - offsets[:-1]).astype(it), lens)
    return VarColumn(offsets, buf.take(idx))


def _render_seq(buf: np.ndarray, seq_off, l_seq) -> VarColumn:
    """Each packed byte becomes its two letters; a row of odd ``l_seq``
    drops its last (padding) letter."""
    lo, plen = _slice_bounds(seq_off, seq_off + (l_seq + 1) // 2, len(buf))
    letters = _SEQ_PAIRS[_gather(buf, lo, plen).values].view(np.uint8)
    n = np.minimum(l_seq, 2 * plen).clip(0)
    drop = 2 * plen - n          # 0, or 1 past an odd length
    if drop.any():
        keep = np.ones(len(letters), dtype=bool)
        keep[_offsets(2 * plen)[1:][drop > 0] - 1] = False
        letters = letters[keep]
    return VarColumn(_offsets(n), letters)


def _render_cigar(buf: np.ndarray, cig_off, n_cigar) -> VarColumn:
    """``{len}{op}`` per cigar word, ``*`` for a row without ops. Each
    op's digits are counted, then digits and letters are written into a
    (ops, 10) grid and read out in order."""
    lo, nbytes = _slice_bounds(cig_off, cig_off + 4 * n_cigar, len(buf))
    if (nbytes % 4).any():
        raise ValueError("buffer size must be a multiple of element size")
    nops = nbytes // 4
    star = n_cigar == 0
    pieces = np.where(star, 1, nops)          # pieces a row renders
    row = np.repeat(np.arange(len(pieces)), pieces)
    j = np.arange(len(row), dtype=np.int64) - np.repeat(
        _offsets(pieces)[:-1], pieces)
    at = lo[row] + 4 * j
    is_star = star[row]
    at = np.where(is_star, 0, at)
    word = (buf[at].astype(np.int64) | (buf[at + 1].astype(np.int64) << 8)
            | (buf[at + 2].astype(np.int64) << 16)
            | (buf[at + 3].astype(np.int64) << 24)) if len(at) else (
        np.zeros(0, dtype=np.int64))
    length = word >> 4
    op = word & 0xF
    if (op[~is_star] >= len(CIGAR_OPS)).any():
        raise IndexError("string index out of range")
    digits = 1 + (length[:, None] >= _POW10[None, 1:_MAX_DIGITS + 1]).sum(1)
    width = np.where(is_star, 1, digits + 1)
    k = np.arange(_MAX_DIGITS + 1)[None, :]
    exp = (digits[:, None] - 1 - k).clip(0)
    grid = (48 + (length[:, None] // _POW10[exp]) % 10).astype(np.uint8)
    grid[k == digits[:, None]] = 0      # filled below
    letters = _OP_LUT[np.where(is_star, 0, op).clip(0, len(CIGAR_OPS) - 1)]
    grid[np.arange(len(grid)), digits.clip(max=_MAX_DIGITS)] = letters
    grid[is_star, 0] = ord("*")
    values = grid[k < width[:, None]]
    row_len = np.bincount(row, weights=width, minlength=len(pieces))
    return VarColumn(_offsets(row_len.astype(np.int64)), values)


def render_columns(batch, rows: np.ndarray, columns) -> dict:
    """Schema columns of the ReadBatch ``batch``'s rows ``rows`` (row
    indices, in order): fixed columns as int32 arrays, variable-length
    ones as :class:`VarColumn`s, every row of a column at once."""
    cols = batch.columns
    rows = np.asarray(rows, dtype=np.int64)
    out: "dict[str, np.ndarray | VarColumn]" = {}
    buf = batch.buf
    n = 0 if buf is None else len(buf)

    def field(k):
        return np.asarray(cols[k])[rows].astype(np.int64)

    if any(c not in FIXED_COLUMNS for c in columns):
        name_off, l_name = field("name_offset"), field("l_read_name")
        n_cigar, l_seq = field("n_cigar"), field("l_seq")
        cig_off = name_off + l_name
        seq_off = cig_off + 4 * n_cigar
        qual_off = seq_off + (l_seq + 1) // 2
    for name in columns:
        if name in FIXED_COLUMNS:
            out[name] = np.ascontiguousarray(
                np.asarray(cols[name])[rows], dtype=np.int32)
        elif name == "name":
            out[name] = _gather(buf, *_slice_bounds(
                name_off, name_off + l_name - 1, n))
        elif name == "cigar":
            out[name] = _render_cigar(buf, cig_off, n_cigar)
        elif name == "seq":
            out[name] = _render_seq(buf, seq_off, l_seq)
        elif name == "qual":
            out[name] = _gather(buf, *_slice_bounds(
                qual_off, qual_off + l_seq, n))
        else:
            end = np.asarray(batch.starts)[rows].astype(np.int64) + 4 + field(
                "block_size")
            out[name] = _gather(buf, *_slice_bounds(qual_off + l_seq, end, n))
    return out


def read_batch_to_record_batches(
    batch, batch_rows: int, columns=None
) -> Iterator[RecordBatch]:
    """Schema batches of ``batch``'s valid rows, ``batch_rows`` per frame
    (the last partial), in row order."""
    rows = np.flatnonzero(np.asarray(batch.columns["valid"]))
    full = RecordBatch(
        render_columns(batch, rows, normalize_columns(columns)), len(rows))
    batch_rows = max(int(batch_rows), 1)
    for lo in range(0, full.num_rows, batch_rows):
        yield slice_batch(full, lo, min(lo + batch_rows, full.num_rows))
