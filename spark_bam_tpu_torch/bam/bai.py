"""The ``.bai`` BAM index (reference ``spark_bam_tpu/bam/bai.py``;
Index.scala:11-93, METADATA_BIN_ID :92, and the chunk query of
CanLoadBam.scala:387-421): read and write the binning and linear index,
build one from a coordinate-sorted BAM in one record pass (``build_bai``,
``index_bam``: the samtools-index role, byte-equal to the reference's),
and answer which virtual-position chunks can hold alignments overlapping
``[start, end)`` of a contig (``BaiIndex.query``), the
``load_bam_intervals`` plan.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

from spark_bam_tpu_torch.core.guard import StructurallyInvalid, TruncatedInput
from spark_bam_tpu_torch.core.pos import Pos

METADATA_BIN_ID = 37450  # magic bin holding per-reference metadata pseudo-chunks
LINEAR_INDEX_SHIFT = 14  # 16 KiB linear-index windows


def _bai_count(n: int, what: str, data: bytes, off: int, item_size: int,
               path) -> int:
    """Validate an index count before it sizes a loop or an allocation: a
    corrupt ``n_intv`` used to size a multi-GB ``struct.unpack_from``."""
    if n < 0:
        raise StructurallyInvalid(
            f".bai {what} is negative: {n}", path=str(path), pos=off
        )
    if off + n * item_size > len(data):
        raise TruncatedInput(
            f".bai {what} {n} needs {n * item_size} bytes, "
            f"have {len(data) - off}", path=str(path), pos=off,
        )
    return n


@dataclass(frozen=True)
class Chunk:
    start: Pos
    end: Pos

    def size(self, estimated_compression_ratio: float = 3.0) -> int:
        """Approximate compressed size (used for bin-packing into partitions)."""
        return self.end.distance(self.start, estimated_compression_ratio)


@dataclass
class Reference:
    bins: dict[int, list[Chunk]]
    linear_index: list[int]  # virtual offsets, one per 16 KiB window
    metadata_chunks: list[Chunk]


@dataclass
class BaiIndex:
    references: list[Reference]
    n_no_coor: int | None

    @staticmethod
    def read(path) -> "BaiIndex":
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            raise StructurallyInvalid(
                f"Not a BAI index: bad magic {data[:4]!r}", path=str(path)
            )
        try:
            return BaiIndex._parse(data, path)
        except struct.error as e:
            raise TruncatedInput(f"truncated .bai: {e}", path=str(path)) from e

    @staticmethod
    def _parse(data: bytes, path) -> "BaiIndex":
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        # 8 = the per-reference minimum (n_bin i32 + n_intv i32).
        _bai_count(n_ref, "n_ref", data, off, 8, path)
        refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            _bai_count(n_bin, "n_bin", data, off, 8, path)
            bins: dict[int, list[Chunk]] = {}
            meta: list[Chunk] = []
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                _bai_count(n_chunk, "n_chunk", data, off, 16, path)
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append(Chunk(Pos.from_htsjdk(beg), Pos.from_htsjdk(end)))
                if bin_id == METADATA_BIN_ID:
                    meta = chunks
                else:
                    bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            _bai_count(n_intv, "n_intv", data, off, 8, path)
            linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            refs.append(Reference(bins, linear, meta))
        n_no_coor = None
        if off + 8 <= len(data):
            (n_no_coor,) = struct.unpack_from("<Q", data, off)
        return BaiIndex(refs, n_no_coor)

    # ------------------------------------------------------------------ queries
    def chunk_starts(self) -> list[Pos]:
        return sorted(
            {c.start for ref in self.references for cs in ref.bins.values() for c in cs}
        )

    def all_addresses(self) -> list[Pos]:
        out = set()
        for ref in self.references:
            for chunks in ref.bins.values():
                for c in chunks:
                    out.add(c.start)
                    out.add(c.end)
        return sorted(out)

    def query(self, ref_idx: int, start: int, end: int) -> list[Chunk]:
        """Chunks possibly containing alignments overlapping [start, end)."""
        if ref_idx >= len(self.references):
            return []
        ref = self.references[ref_idx]
        min_offset = Pos(0, 0)
        win = start >> LINEAR_INDEX_SHIFT
        if ref.linear_index and win < len(ref.linear_index):
            min_offset = Pos.from_htsjdk(ref.linear_index[win])
        chunks = [
            c
            for bin_id in reg2bins(start, end)
            for c in ref.bins.get(bin_id, ())
            if (c.end.block_pos, c.end.offset) > (min_offset.block_pos, min_offset.offset)
        ]
        return merge_chunks(sorted(chunks, key=lambda c: (c.start, c.end)))


    # ------------------------------------------------------------------ write
    def write(self, out_path) -> str:
        """Serialize in the standard BAI layout (readable by this module's
        reader and by htsjdk and samtools). Write, then rename: a crash
        leaves no truncated index."""
        parts = [b"BAI\x01", struct.pack("<i", len(self.references))]
        for ref in self.references:
            n_bin = len(ref.bins) + (1 if ref.metadata_chunks else 0)
            parts.append(struct.pack("<i", n_bin))
            for bin_id in sorted(ref.bins):
                chunks = ref.bins[bin_id]
                parts.append(struct.pack("<Ii", bin_id, len(chunks)))
                for c in chunks:
                    parts.append(
                        struct.pack("<QQ", c.start.to_htsjdk(), c.end.to_htsjdk())
                    )
            if ref.metadata_chunks:
                parts.append(
                    struct.pack("<Ii", METADATA_BIN_ID, len(ref.metadata_chunks))
                )
                for c in ref.metadata_chunks:
                    parts.append(
                        struct.pack("<QQ", c.start.to_htsjdk(), c.end.to_htsjdk())
                    )
            parts.append(struct.pack("<i", len(ref.linear_index)))
            parts.append(struct.pack(f"<{len(ref.linear_index)}Q", *ref.linear_index))
        if self.n_no_coor is not None:
            parts.append(struct.pack("<Q", self.n_no_coor))
        tmp_path = f"{out_path}.tmp{os.getpid()}"
        try:
            with open(tmp_path, "wb") as f:
                f.write(b"".join(parts))
            os.replace(tmp_path, out_path)
        finally:
            if os.path.exists(tmp_path):  # failure path only
                os.unlink(tmp_path)
        return str(out_path)


def build_bai(bam_path) -> BaiIndex:
    """Build the BAI binning + linear index for a coordinate-sorted BAM,
    the samtools-index role. One sequential pass: each record contributes its virtual-position span
    ``[start, next record's start)`` to its ``reg2bin`` bin and its minimum
    start offset to every 16 KiB linear window it overlaps. Placed-unmapped
    reads index at ``[pos, pos+1)``; unplaced reads count into
    ``n_no_coor``. Per-reference metadata pseudo-bins (37450) carry the
    begin/end offsets and mapped/unmapped counts, as samtools writes them.
    """
    from spark_bam_tpu_torch.bam.iterators import RecordStream
    from spark_bam_tpu_torch.core.channel import open_channel, path_size

    ch = open_channel(bam_path)
    stream = RecordStream.open(ch)
    header = stream.header
    n_ref = len(header.contig_names)
    eof_pos = Pos(path_size(bam_path), 0)
    after_pos = None  # virtual offset just past the most recent record

    bins: list[dict[int, list[Chunk]]] = [{} for _ in range(n_ref)]
    linear: list[dict[int, int]] = [{} for _ in range(n_ref)]
    span: list[list] = [[None, None, 0, 0] for _ in range(n_ref)]  # beg,end,mapped,unmapped
    n_no_coor = 0

    def add(ref_id: int, beg: int, end_coord: int, vstart: Pos, vend: Pos):
        b = reg2bin(beg, end_coord)
        chunks = bins[ref_id].setdefault(b, [])
        if chunks and (
            (vstart.block_pos, vstart.offset)
            <= (chunks[-1].end.block_pos, chunks[-1].end.offset)
            or vstart.block_pos == chunks[-1].end.block_pos
        ):
            # Adjacent/same-block chunks coalesce (samtools/htsjdk do too).
            if (vend.block_pos, vend.offset) > (
                chunks[-1].end.block_pos, chunks[-1].end.offset
            ):
                chunks[-1] = Chunk(chunks[-1].start, vend)
        else:
            chunks.append(Chunk(vstart, vend))
        vs = vstart.to_htsjdk()
        lin = linear[ref_id]
        for w in range(beg >> LINEAR_INDEX_SHIFT,
                       max(beg, end_coord - 1) >> LINEAR_INDEX_SHIFT):
            lin[w] = min(lin.get(w, vs), vs)
        w = max(beg, end_coord - 1) >> LINEAR_INDEX_SHIFT
        lin[w] = min(lin.get(w, vs), vs)
        sp = span[ref_id]
        sp[0] = vstart if sp[0] is None else sp[0]
        sp[1] = vend

    try:
        prev = None
        prev_key = None
        for pos, rec in stream:
            after_pos = _tell_after(stream)
            if rec.ref_id >= 0 and rec.pos >= 0:
                key = (rec.ref_id, rec.pos)
                if prev_key is not None and key < prev_key:
                    # An index built from unsorted input would silently
                    # drop records at query time (the linear-index pruning
                    # assumes coordinate order) — refuse, like samtools.
                    raise ValueError(
                        f"{bam_path}: not coordinate-sorted at {pos} "
                        f"(ref {rec.ref_id} pos {rec.pos} after "
                        f"ref {prev_key[0]} pos {prev_key[1]})"
                    )
                prev_key = key
            if prev is not None:
                _index_one(prev[1], prev[0], pos, add, span)
            prev = (pos, rec)
            if rec.ref_id < 0 or rec.pos < 0:
                n_no_coor += 1
        if prev is not None:
            # The final record's chunk ends at the virtual offset just past
            # it (what samtools writes), not at the physical file size —
            # Pos(file_size, 0) would drag the BGZF EOF sentinel into the
            # last chunk and byte-differ from samtools output.
            _index_one(
                prev[1], prev[0],
                eof_pos if after_pos is None else after_pos, add, span,
            )
    finally:
        ch.close()

    refs = []
    for r in range(n_ref):
        lin = linear[r]
        n_win = (max(lin) + 1) if lin else 0
        # Gap windows carry the previous window's value (samtools layout);
        # leading gaps are 0 (= unconstrained for query pruning).
        arr = []
        last = 0
        for w in range(n_win):
            last = lin.get(w, last)
            arr.append(last)
        meta = []
        beg_v, end_v, n_mapped, n_unmapped = span[r]
        if beg_v is not None:
            meta = [
                Chunk(beg_v, end_v),
                Chunk(Pos.from_htsjdk(n_mapped), Pos.from_htsjdk(n_unmapped)),
            ]
        refs.append(Reference(bins[r], arr, meta))
    return BaiIndex(refs, n_no_coor)


def _tell_after(stream) -> Pos | None:
    """The stream cursor as samtools' ``bgzf_tell`` reports it: when the
    record just read exhausted its block, the next block's start with
    offset 0 (for the last record, the EOF block's offset: the exclusive
    bound samtools writes). It never moves the cursor."""
    return stream.u.tell_after()


def _index_one(rec, vstart: Pos, vend: Pos, add, span) -> None:
    if rec.ref_id < 0 or rec.pos < 0:
        return
    if rec.is_unmapped:
        add(rec.ref_id, rec.pos, rec.pos + 1, vstart, vend)
        span[rec.ref_id][3] += 1
    else:
        add(rec.ref_id, rec.pos, rec.end_pos(), vstart, vend)
        span[rec.ref_id][2] += 1


def index_bam(bam_path, out_path=None) -> tuple[str, "BaiIndex"]:
    """Build and write ``bam_path``'s ``.bai``; returns (path, index)."""
    out_path = str(out_path) if out_path is not None else str(bam_path) + ".bai"
    index = build_bai(bam_path)
    index.write(out_path)
    return out_path, index


def reg2bins(beg: int, end: int) -> list[int]:
    """All bin ids overlapping [beg, end) in the UCSC binning scheme."""
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (for the BAM writer)."""
    end -= 1
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


def merge_chunks(chunks: list[Chunk]) -> list[Chunk]:
    """Coalesce adjacent/overlapping chunks (matches HTSJDK's optimization)."""
    out: list[Chunk] = []
    for c in chunks:
        if out and (c.start.block_pos, c.start.offset) <= (
            out[-1].end.block_pos,
            out[-1].end.offset,
        ):
            if (c.end.block_pos, c.end.offset) > (out[-1].end.block_pos, out[-1].end.offset):
                out[-1] = Chunk(out[-1].start, c.end)
        else:
            out.append(c)
    return out
