"""The native columnar container (reference ``spark_bam_tpu/columnar/
native.py``), byte for byte. Layout:

    magic   4s   b"SBCR"
    version u16  (1)
    flags   u16  (0, reserved)
    frame*  — each frame is
        tag         u8    (1 schema, 2 batch, 3 end; others skipped)
        payload_len u64
        payload     bytes
        crc32       u32   over tag+payload_len+payload

The schema frame's payload is deterministic JSON (sorted keys, no
whitespace) of ``schema_version``, ``columns``, ``codec``, ``level`` and
``contigs``. A batch frame holds ``rows u32, ncols u16``, then per column
(schema order) a kind byte (0 fixed, 1 var, 2 dictionary) and its
buffers; each buffer is ``raw_len u64, enc_len u64, bytes``, stored raw
when ``enc_len == raw_len`` and zlib otherwise. Kind 2 (``name`` and
``cigar`` only, where it is strictly smaller than kind 1) holds int32
per-row codes and the dictionary's offsets and values, in
first-occurrence order. The end frame carries ``total_rows u64,
n_batches u32``.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Iterator

import numpy as np

from spark_bam_tpu_torch.columnar.schema import (
    COLUMNS,
    SCHEMA_VERSION,
    RecordBatch,
    VarColumn,
    take_rows,
)

MAGIC = b"SBCR"
VERSION = 1

TAG_SCHEMA = 1
TAG_BATCH = 2
TAG_END = 3

_HEAD = struct.Struct("<4sHH")
_FRAME = struct.Struct("<BQ")
_CRC = struct.Struct("<I")
_BUF = struct.Struct("<QQ")
_BATCH = struct.Struct("<IH")
_END = struct.Struct("<QI")


class ColumnarFormatError(ValueError):
    """Structurally invalid container (bad magic, CRC, framing or
    lengths). A ``ValueError``, as the reference's is through its
    malformed-input taxonomy."""


def container_meta(columns, codec: str = "none", level: int = 6,
                   contigs=None) -> dict:
    """The schema-frame payload: a fixed key set, canonical column order,
    nothing that depends on the run."""
    return {
        "schema_version": SCHEMA_VERSION,
        "columns": list(columns),
        "codec": codec,
        "level": int(level),
        "contigs": [[str(n), int(l)] for n, l in (contigs or [])],
    }


def _frame(tag: int, payload: bytes) -> bytes:
    head = _FRAME.pack(tag, len(payload))
    return head + payload + _CRC.pack(zlib.crc32(head + payload) & 0xFFFFFFFF)


def _encode_buffer(raw: bytes, codec: str, level: int) -> bytes:
    """One buffer, compressed only where that makes it smaller."""
    if codec == "zlib":
        enc = zlib.compress(raw, level)
        if len(enc) < len(raw):
            return _BUF.pack(len(raw), len(enc)) + enc
    elif codec == "deflate" and raw:
        from spark_bam_tpu_torch.compress.codec import encode_zlib_stream

        enc = encode_zlib_stream(raw)
        if len(enc) < len(raw):
            return _BUF.pack(len(raw), len(enc)) + enc
    return _BUF.pack(len(raw), len(raw)) + raw


def container_head(meta: dict) -> bytes:
    """Magic, version and the schema frame: the first bytes of every
    container."""
    payload = json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()
    return _HEAD.pack(MAGIC, VERSION, 0) + _frame(TAG_SCHEMA, payload)


#: Var columns worth a dictionary pass: read names repeat their prefix
#: and cigars collapse to a few shapes; seq and qual are near-unique.
_DICT_COLUMNS = frozenset({"name", "cigar"})


def _var_parts(col: VarColumn, codec: str, level: int) -> "list[bytes]":
    return [
        b"\x01",
        _encode_buffer(
            np.ascontiguousarray(col.offsets, dtype=np.int64).tobytes(),
            codec, level,
        ),
        _encode_buffer(
            np.ascontiguousarray(col.values, dtype=np.uint8).tobytes(),
            codec, level,
        ),
    ]


def dictionary(col: VarColumn) -> "tuple[np.ndarray, list[bytes]]":
    """Per-row int32 codes into the column's distinct values, numbered in
    first-occurrence order, and those values."""
    offsets = np.ascontiguousarray(col.offsets, dtype=np.int64).tolist()
    raw = np.ascontiguousarray(col.values, dtype=np.uint8).tobytes()
    codes = np.empty(len(offsets) - 1, dtype=np.int32)
    index: "dict[bytes, int]" = {}
    entries: "list[bytes]" = []
    for i in range(len(offsets) - 1):
        s = raw[offsets[i]: offsets[i + 1]]
        code = index.get(s)
        if code is None:
            code = index[s] = len(entries)
            entries.append(s)
        codes[i] = code
    return codes, entries


def _dict_parts(col: VarColumn, codec: str, level: int) -> "list[bytes]":
    """Kind 2: the codes, then the dictionary's offsets and values."""
    codes, entries = dictionary(col)
    d_off = np.zeros(len(entries) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in entries], out=d_off[1:])
    return [
        b"\x02",
        _encode_buffer(codes.tobytes(), codec, level),
        _encode_buffer(d_off.tobytes(), codec, level),
        _encode_buffer(b"".join(entries), codec, level),
    ]


def batch_frame(batch: RecordBatch, meta: dict) -> bytes:
    codec, level = meta["codec"], meta["level"]
    parts = [_BATCH.pack(batch.num_rows, len(meta["columns"]))]
    for name in meta["columns"]:
        col = batch.columns[name]
        if isinstance(col, VarColumn):
            var = _var_parts(col, codec, level)
            if name in _DICT_COLUMNS:
                # Keep only when smaller: the dictionary pays off only
                # where the column repeats.
                dct = _dict_parts(col, codec, level)
                if sum(map(len, dct)) < sum(map(len, var)):
                    var = dct
            parts.extend(var)
        else:
            parts.append(b"\x00")
            parts.append(_encode_buffer(
                np.ascontiguousarray(col, dtype=np.int32).tobytes(),
                codec, level,
            ))
    return _frame(TAG_BATCH, b"".join(parts))


def end_frame(total_rows: int, n_batches: int) -> bytes:
    return _frame(TAG_END, _END.pack(total_rows, n_batches))


# ------------------------------------------------------------------- reading
def _take(buf: memoryview, p: int, n: int, what: str) -> "tuple[memoryview, int]":
    if p + n > len(buf):
        raise ColumnarFormatError(
            f"truncated container: {what} needs {n} bytes at {p}, "
            f"have {len(buf) - p}"
        )
    return buf[p: p + n], p + n


def _decode_buffer(payload: memoryview, p: int) -> "tuple[bytes, int]":
    head, p = _take(payload, p, _BUF.size, "buffer header")
    raw_len, enc_len = _BUF.unpack(head)
    data, p = _take(payload, p, enc_len, "buffer body")
    if enc_len == raw_len:
        return bytes(data), p
    raw = zlib.decompress(bytes(data))
    if len(raw) != raw_len:
        raise ColumnarFormatError(
            f"buffer inflated to {len(raw)} bytes, header declared {raw_len}"
        )
    return raw, p


def _decode_batch(payload: memoryview, columns) -> RecordBatch:
    head, p = _take(payload, 0, _BATCH.size, "batch header")
    rows, ncols = _BATCH.unpack(head)
    if ncols != len(columns):
        raise ColumnarFormatError(
            f"batch has {ncols} columns, schema declares {len(columns)}"
        )
    cols: "dict[str, np.ndarray | VarColumn]" = {}
    for name in columns:
        kind, p = _take(payload, p, 1, "column kind")
        if kind[0] == 0:
            raw, p = _decode_buffer(payload, p)
            arr = np.frombuffer(raw, dtype=np.int32)
            if len(arr) != rows:
                raise ColumnarFormatError(
                    f"column {name!r}: {len(arr)} values for {rows} rows"
                )
            cols[name] = arr
        elif kind[0] == 1:
            raw_off, p = _decode_buffer(payload, p)
            raw_val, p = _decode_buffer(payload, p)
            offsets = np.frombuffer(raw_off, dtype=np.int64)
            values = np.frombuffer(raw_val, dtype=np.uint8)
            if len(offsets) != rows + 1:
                raise ColumnarFormatError(
                    f"column {name!r}: {len(offsets)} offsets for {rows} rows"
                )
            if rows and (int(offsets[-1]) != len(values) or int(offsets[0]) != 0
                         or (np.diff(offsets) < 0).any()):
                raise ColumnarFormatError(
                    f"column {name!r}: offsets inconsistent with "
                    f"{len(values)} value bytes"
                )
            cols[name] = VarColumn(offsets, values)
        elif kind[0] == 2:
            raw_codes, p = _decode_buffer(payload, p)
            raw_off, p = _decode_buffer(payload, p)
            raw_val, p = _decode_buffer(payload, p)
            codes = np.frombuffer(raw_codes, dtype=np.int32)
            d_off = np.frombuffer(raw_off, dtype=np.int64)
            d_val = np.frombuffer(raw_val, dtype=np.uint8)
            if len(codes) != rows:
                raise ColumnarFormatError(
                    f"column {name!r}: {len(codes)} codes for {rows} rows"
                )
            ndict = len(d_off) - 1
            if ndict < 0 or (len(d_off) and (
                    int(d_off[0]) != 0
                    or (ndict and int(d_off[-1]) != len(d_val))
                    or (np.diff(d_off) < 0).any())):
                raise ColumnarFormatError(
                    f"column {name!r}: dictionary offsets inconsistent "
                    f"with {len(d_val)} value bytes"
                )
            if rows and (ndict == 0 or codes.min() < 0
                         or codes.max() >= ndict):
                raise ColumnarFormatError(
                    f"column {name!r}: code out of range for "
                    f"{ndict}-entry dictionary"
                )
            # The full VarColumn: consumers never see the encoding.
            entries = RecordBatch({name: VarColumn(d_off, d_val)}, ndict)
            cols[name] = take_rows(entries, codes).columns[name]
        else:
            raise ColumnarFormatError(
                f"column {name!r}: unknown kind byte {kind[0]}"
            )
    return RecordBatch(cols, rows)


class NativeReader:
    """Validating reader over a container's bytes or file path.

    ``meta`` is decoded at open; batches stream from :meth:`iter_batches`.
    Unknown frame tags are skipped (their CRC still checked)."""

    def __init__(self, src):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self._data = memoryview(src)
        else:
            with open(src, "rb") as f:
                self._data = memoryview(f.read())
        head, p = _take(self._data, 0, _HEAD.size, "container header")
        magic, version, _flags = _HEAD.unpack(head)
        if magic != MAGIC:
            raise ColumnarFormatError(
                f"bad magic {bytes(magic)!r}: not a columnar container"
            )
        if version != VERSION:
            raise ColumnarFormatError(f"unsupported container version {version}")
        tag, payload, p = self._frame_at(p)
        if tag != TAG_SCHEMA:
            raise ColumnarFormatError(
                f"first frame has tag {tag}, expected schema ({TAG_SCHEMA})"
            )
        try:
            self.meta = json.loads(bytes(payload))
        except Exception as exc:
            raise ColumnarFormatError(f"schema frame is not JSON: {exc}") from exc
        if self.meta.get("schema_version") != SCHEMA_VERSION:
            raise ColumnarFormatError(
                f"unsupported schema_version {self.meta.get('schema_version')}"
            )
        cols = self.meta.get("columns")
        if (not isinstance(cols, list) or not cols
                or any(c not in COLUMNS for c in cols)):
            raise ColumnarFormatError(f"schema declares bad columns: {cols!r}")
        self.columns = tuple(cols)
        self._body_at = p

    def _frame_at(self, p: int) -> "tuple[int, memoryview, int]":
        head, q = _take(self._data, p, _FRAME.size, "frame header")
        tag, length = _FRAME.unpack(head)
        payload, q = _take(self._data, q, length, f"frame tag={tag} payload")
        crc_raw, q = _take(self._data, q, _CRC.size, "frame crc")
        want = zlib.crc32(self._data[p: p + _FRAME.size + length]) & 0xFFFFFFFF
        if _CRC.unpack(crc_raw)[0] != want:
            raise ColumnarFormatError(f"frame tag={tag} at {p}: CRC mismatch")
        return tag, payload, q

    def iter_batches(self) -> Iterator[RecordBatch]:
        p = self._body_at
        total = 0
        n_batches = 0
        saw_end = False
        while p < len(self._data):
            tag, payload, p = self._frame_at(p)
            if tag == TAG_BATCH:
                if saw_end:
                    raise ColumnarFormatError("batch frame after end frame")
                batch = _decode_batch(payload, self.columns)
                total += batch.num_rows
                n_batches += 1
                yield batch
            elif tag == TAG_END:
                if len(payload) != _END.size:
                    raise ColumnarFormatError("end frame has wrong size")
                want_rows, want_batches = _END.unpack(bytes(payload))
                if want_rows != total or want_batches != n_batches:
                    raise ColumnarFormatError(
                        f"end frame declares {want_rows} rows / "
                        f"{want_batches} batches, read {total} / {n_batches}"
                    )
                saw_end = True
            # Unknown tags: CRC checked by _frame_at, content skipped.
        if not saw_end:
            raise ColumnarFormatError("container has no end frame (truncated?)")


def read_container(src) -> "tuple[dict, list[RecordBatch]]":
    """(meta, every batch) of a container's path or bytes."""
    reader = NativeReader(src)
    return reader.meta, list(reader.iter_batches())
