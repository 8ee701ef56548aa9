"""Versioned binary ``.sbi`` split-index format (reference
``spark_bam_tpu/sbi/format.py``), byte for byte: a sidecar either package
writes decodes in the other.

Layout (little-endian throughout)::

    magic   4s   b"SBTI"
    version u16  FORMAT_VERSION
    flags   u16  reserved (0)
    -- fingerprint -------------------------------------------------
    size          u64  compressed byte size of the BAM
    mtime_ns      u64  local-file mtime (0 for URLs — size+CRC carry it)
    header_crc    u32  CRC32 of the BAM's first min(64 KiB, size) bytes
    config_digest u32  CRC32 of the checker knobs that shape the index
    -- sections ----------------------------------------------------
    n_sections u32, then per section: tag u32, payload_len u64, payload
        tag 1 BLOCKS:        n u64, then n × (start u64, comp u32, uncomp u32)
        tag 2 SPLIT_PLANS:   n_plans u32, per plan: split_size u64,
                             n_entries u64, entries × (file_start u64,
                             kind u8, vpos u64)
        tag 3 RECORD_STARTS: n u64, then n × u64 HTSJDK virtual positions
    -- trailer -----------------------------------------------------
    crc32 u32 over every preceding byte

Any structural problem — bad magic, unknown version, truncated payload,
trailer-CRC mismatch — raises ``SbiFormatError``; the store treats that
as cache corruption (invalidate and recompute), never as data.

Plan-entry ``kind``: 0 = the boundary owns no record start (clean:
no blocks, or EOF); 1 = resolved to ``vpos``; 2 = unresolved (the
boundary scan exhausted ``max_read_size`` at build time — consumers
re-resolve live so the cached plan can never swallow that error).

The fingerprint binds the sidecar to (file bytes, checker config): the
checker-knob digest covers every knob that changes split positions, so
an index built under different knobs reads as stale, not as truth.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from spark_bam_tpu_torch.bgzf.block import Metadata
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.pos import Pos

MAGIC = b"SBTI"
FORMAT_VERSION = 1
#: Bumped whenever checker *semantics* change in a way that moves record
#: boundaries; part of the config digest so old indexes age out safely.
CHECKER_SEMANTICS_VERSION = 1

#: Bytes of file head covered by the fingerprint CRC — spans the BAM
#: header's BGZF blocks for any realistic contig dictionary.
HEADER_CRC_SPAN = 64 << 10

SECTION_BLOCKS = 1
SECTION_SPLIT_PLANS = 2
SECTION_RECORD_STARTS = 3

PLAN_NONE = 0        # boundary owns no record start
PLAN_POS = 1         # resolved virtual position
PLAN_UNRESOLVED = 2  # scan budget exhausted at build time; re-resolve live


class SbiFormatError(ValueError):
    """The sidecar's bytes are not a well-formed ``.sbi`` index; the store
    treats it as cache corruption."""


def is_url(path) -> bool:
    return "://" in os.fspath(path)


def _local_only(path) -> None:
    if is_url(path):
        raise NotImplementedError(
            f"{path}: a remote BAM's .sbi cache needs the remote byte "
            "channel, which this port does not have yet; pass a local file")


def config_digest(config) -> int:
    """CRC32 over the checker knobs that determine split/record positions."""
    spec = (
        f"v{CHECKER_SEMANTICS_VERSION};"
        f"z={config.bgzf_blocks_to_check};"
        f"r={config.reads_to_check};"
        f"m={config.max_read_size}"
    )
    return zlib.crc32(spec.encode()) & 0xFFFFFFFF


@dataclass(frozen=True)
class Fingerprint:
    size: int
    mtime_ns: int
    header_crc: int
    config_digest: int

    def mismatch(self, other: "Fingerprint") -> str | None:
        """First differing field as a human reason, or None when equal."""
        for name, label in (
            ("size", "file size changed"),
            ("mtime_ns", "file mtime changed"),
            ("header_crc", "file head bytes changed"),
            ("config_digest", "checker config changed"),
        ):
            if getattr(self, name) != getattr(other, name):
                return label
        return None


def fingerprint_of(bam_path, config) -> Fingerprint:
    """The current fingerprint of the local file ``bam_path`` under
    ``config``."""
    path = os.fspath(bam_path)
    _local_only(path)
    mtime_ns = os.stat(path).st_mtime_ns
    with open_channel(path) as ch:
        size = ch.size
        head = bytes(ch.read_at(0, min(HEADER_CRC_SPAN, size)))
    return Fingerprint(
        size, mtime_ns, zlib.crc32(head) & 0xFFFFFFFF, config_digest(config)
    )


@dataclass(frozen=True)
class PlanEntry:
    """One raw split boundary's resolution (pre-dedup: consecutive
    boundaries may resolve to the same position; consumers dedupe)."""

    file_start: int
    kind: int           # PLAN_NONE | PLAN_POS | PLAN_UNRESOLVED
    pos: Pos | None     # set iff kind == PLAN_POS


@dataclass
class SbiIndex:
    """In-memory form of one ``.sbi`` sidecar."""

    fingerprint: Fingerprint
    blocks: list[Metadata] | None = None
    #: split_size → raw per-boundary entries for that split size
    split_plans: dict[int, list[PlanEntry]] = field(default_factory=dict)
    #: HTSJDK-packed virtual positions of every record start (sorted)
    record_starts: np.ndarray | None = None

    def merge_from(self, other: "SbiIndex") -> None:
        """Adopt sections present in ``other`` and absent here (the
        read-modify-write half of write-through: a load that only computed
        a split plan must not drop a previously indexed record-start
        section, and vice versa)."""
        if self.blocks is None:
            self.blocks = other.blocks
        for size, plan in other.split_plans.items():
            self.split_plans.setdefault(size, plan)
        if self.record_starts is None:
            self.record_starts = other.record_starts


# ----------------------------------------------------------------- encode

def _encode_blocks(blocks: list[Metadata]) -> bytes:
    out = [struct.pack("<Q", len(blocks))]
    out.extend(
        struct.pack("<QII", m.start, m.compressed_size, m.uncompressed_size)
        for m in blocks
    )
    return b"".join(out)


def _encode_split_plans(plans: dict[int, list[PlanEntry]]) -> bytes:
    out = [struct.pack("<I", len(plans))]
    for split_size in sorted(plans):
        entries = plans[split_size]
        out.append(struct.pack("<QQ", split_size, len(entries)))
        for e in entries:
            vpos = e.pos.to_htsjdk() if e.kind == PLAN_POS else 0
            out.append(struct.pack("<QBQ", e.file_start, e.kind, vpos))
    return b"".join(out)


def _encode_record_starts(starts: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(starts, dtype=np.uint64)
    return struct.pack("<Q", len(arr)) + arr.tobytes()


def encode_sbi(index: SbiIndex) -> bytes:
    fp = index.fingerprint
    head = MAGIC + struct.pack(
        "<HHQQII", FORMAT_VERSION, 0, fp.size, fp.mtime_ns, fp.header_crc,
        fp.config_digest,
    )
    sections: list[tuple[int, bytes]] = []
    if index.blocks is not None:
        sections.append((SECTION_BLOCKS, _encode_blocks(index.blocks)))
    if index.split_plans:
        sections.append(
            (SECTION_SPLIT_PLANS, _encode_split_plans(index.split_plans))
        )
    if index.record_starts is not None:
        sections.append(
            (SECTION_RECORD_STARTS, _encode_record_starts(index.record_starts))
        )
    body = [head, struct.pack("<I", len(sections))]
    for tag, payload in sections:
        body.append(struct.pack("<IQ", tag, len(payload)))
        body.append(payload)
    blob = b"".join(body)
    return blob + struct.pack("<I", zlib.crc32(blob) & 0xFFFFFFFF)


# ----------------------------------------------------------------- decode

class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise SbiFormatError(
                f"truncated .sbi: wanted {n} bytes at {self.off}, "
                f"have {len(self.data) - self.off}"
            )
        out = self.data[self.off: self.off + n]
        self.off += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def count(self, n: int, what: str, item_size: int) -> int:
        """Validate an element count against the bytes actually present
        before it sizes a loop (a corrupt count must fail in O(1), not
        after ``n`` iterations)."""
        if n * item_size > len(self.data) - self.off:
            raise SbiFormatError(
                f"corrupt .sbi: {what} count {n} needs {n * item_size} "
                f"bytes at {self.off}, have {len(self.data) - self.off}"
            )
        return n


def _decode_blocks(r: _Reader) -> list[Metadata]:
    (n,) = r.unpack("<Q")
    r.count(n, "blocks", 16)
    return [Metadata(*r.unpack("<QII")) for _ in range(n)]


def _decode_split_plans(r: _Reader) -> dict[int, list[PlanEntry]]:
    (n_plans,) = r.unpack("<I")
    r.count(n_plans, "split plans", 16)
    plans: dict[int, list[PlanEntry]] = {}
    for _ in range(n_plans):
        split_size, n_entries = r.unpack("<QQ")
        r.count(n_entries, "plan entries", 17)
        entries = []
        for _ in range(n_entries):
            file_start, kind, vpos = r.unpack("<QBQ")
            if kind not in (PLAN_NONE, PLAN_POS, PLAN_UNRESOLVED):
                raise SbiFormatError(f"bad plan-entry kind {kind}")
            entries.append(
                PlanEntry(
                    file_start, kind,
                    Pos.from_htsjdk(vpos) if kind == PLAN_POS else None,
                )
            )
        plans[int(split_size)] = entries
    return plans


def _decode_record_starts(r: _Reader) -> np.ndarray:
    (n,) = r.unpack("<Q")
    raw = r.take(8 * r.count(n, "record starts", 8))
    return np.frombuffer(raw, dtype=np.uint64).copy()


def decode_sbi(data: bytes) -> SbiIndex:
    if len(data) < len(MAGIC) + 2 + 2 + 24 + 4 + 4:
        raise SbiFormatError(f"short .sbi: {len(data)} bytes")
    (trailer,) = struct.unpack("<I", data[-4:])
    if zlib.crc32(data[:-4]) & 0xFFFFFFFF != trailer:
        raise SbiFormatError("trailer CRC32 mismatch (corrupt sidecar)")
    r = _Reader(data[:-4])
    if r.take(4) != MAGIC:
        raise SbiFormatError("bad magic")
    version, _flags = r.unpack("<HH")
    if version != FORMAT_VERSION:
        raise SbiFormatError(f"unsupported .sbi version {version}")
    size, mtime_ns, header_crc, digest = r.unpack("<QQII")
    index = SbiIndex(Fingerprint(size, mtime_ns, header_crc, digest))
    (n_sections,) = r.unpack("<I")
    for _ in range(n_sections):
        tag, payload_len = r.unpack("<IQ")
        payload = _Reader(r.take(payload_len))
        if tag == SECTION_BLOCKS:
            index.blocks = _decode_blocks(payload)
        elif tag == SECTION_SPLIT_PLANS:
            index.split_plans = _decode_split_plans(payload)
        elif tag == SECTION_RECORD_STARTS:
            index.record_starts = _decode_record_starts(payload)
        # Unknown tags are skipped: newer writers stay readable.
    return index


# --------------------------------------------------- virtual ↔ flat offsets

def record_starts_to_virtual(view, flat_starts: np.ndarray) -> np.ndarray:
    """Flat record-start offsets → sorted HTSJDK virtual positions."""
    blocks, offs = view.pos_of_flat_many(np.asarray(flat_starts, dtype=np.int64))
    return (
        (blocks.astype(np.uint64) << np.uint64(16)) | offs.astype(np.uint64)
    )


def record_starts_to_flat(view, virtual: np.ndarray) -> np.ndarray:
    """HTSJDK virtual positions → flat offsets in ``view``. Raises
    ``SbiFormatError`` when a position names a block the file doesn't
    have (the fingerprint should make this impossible; defense anyway)."""
    v = np.asarray(virtual, dtype=np.uint64)
    blocks = (v >> np.uint64(16)).astype(np.int64)
    offs = (v & np.uint64(0xFFFF)).astype(np.int64)
    idx = np.searchsorted(view.block_starts, blocks)
    if len(v) and (
        idx.max(initial=0) >= len(view.block_starts)
        or not np.array_equal(view.block_starts[idx], blocks)
    ):
        raise SbiFormatError("record-start block not present in file")
    return view.block_flat[idx] + offs
