"""CRAM 3.0 writer: lower ``BamRecord``s into containers.

Reference-less encoding (the htslib ``no_ref`` convention, legal per spec
with preservation ``RR=false``): M/=/X cigar runs become explicit-bases
``b`` features, so readers reconstruct sequence + cigar with no FASTA in
hand. One slice per container; every data series goes to its own external
block (ITF8 ints / raw bytes / length-prefixed arrays), with the core
bit-stream left empty. Mates are always written detached (MF/NS/NP/TS
explicit), read names preserved.

Purpose-built for round-tripping the record model and for generating CRAM
inputs; the reader handles the wider spec surface. Its bytes and its
``.crai`` equal the reference writer's (``spark_bam_tpu/cram/writer.py``)
for the same records.
"""

from __future__ import annotations

from collections import defaultdict

from spark_bam_tpu_torch.bam.record import BamRecord
from spark_bam_tpu_torch.cram import codecs
from spark_bam_tpu_torch.cram.bam_bridge import features_from_record, split_tags
from spark_bam_tpu_torch.cram.container import (
    COMPRESSION_HEADER,
    CORE,
    EXTERNAL,
    GZIP,
    MAPPED_SLICE,
    RANS4x8,
    RAW,
    Block,
    ContainerHeader,
    eof_container,
    file_definition,
    sam_header_container,
)
from spark_bam_tpu_torch.cram.nums import itf8
from spark_bam_tpu_torch.cram.structure import CompressionHeader, SliceHeader

# Stable external-block content ids, one per data series.
SERIES_IDS = {
    "BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6, "RN": 7, "MF": 8,
    "NS": 9, "NP": 10, "TS": 11, "NF": 12, "TL": 13, "FN": 14, "FC": 15,
    "FP": 16, "DL": 17, "BB": 18, "QQ": 19, "BS": 20, "IN": 21, "RS": 22,
    "PD": 23, "HC": 24, "SC": 25, "MQ": 26, "BA": 27, "QS": 28,
}

_METHODS = {"gzip": GZIP, "rans": RANS4x8, "raw": RAW}

# CF (CRAM record flag) bits.
CF_QS_PRESERVED = 1
CF_DETACHED = 2
CF_NO_SEQ = 8

_READ_CONSUMING = {0, 1, 4, 7, 8}  # M, I, S, =, X


def synthesize_sam_text(contigs) -> str:
    """A minimal SAM header text for ``contigs``, ``(name, length)`` pairs
    in index order."""
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for name, length in contigs:
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    return "\n".join(lines) + "\n"


class _PendingContainer:
    def __init__(self):
        self.streams: dict[str, bytearray] = defaultdict(bytearray)
        self.tag_streams: dict[int, bytearray] = defaultdict(bytearray)
        self.td_lines: list[tuple] = []
        self.td_index: dict[tuple, int] = {}
        self.n_records = 0
        self.bases = 0
        # ref id → [min 0-based start, max 0-based end) over mapped records;
        # -1 present iff the slice holds unmapped reads. Feeds the .crai.
        self.ref_spans: dict[int, list[int]] = {}

    def put_int(self, series: str, v: int) -> None:
        self.streams[series] += itf8(v)

    def put_byte(self, series: str, v: int) -> None:
        self.streams[series].append(v)

    def put_bytes(self, series: str, v: bytes) -> None:
        self.streams[series] += v

    def put_array(self, series: str, v: bytes) -> None:
        self.streams[series] += itf8(len(v)) + v

    def add(self, rec: BamRecord) -> None:
        flag = rec.flag
        seq = rec.seq
        rl = len(seq)
        cf = CF_QS_PRESERVED | CF_DETACHED
        if rl == 0:
            cf |= CF_NO_SEQ
            if not rec.is_unmapped:
                # Sequence '*' with a real cigar: read length comes from the
                # cigar; bases are written as N placeholders and discarded
                # again on decode (CF_NO_SEQ).
                rl = sum(ln for ln, op in rec.cigar if op in _READ_CONSUMING)
                seq = "N" * rl
        if rec.is_unmapped or rec.ref_id < 0:
            self.ref_spans.setdefault(-1, [0, 0])
        else:
            span = self.ref_spans.setdefault(rec.ref_id, [rec.pos, rec.end_pos()])
            span[0] = min(span[0], rec.pos)
            span[1] = max(span[1], rec.end_pos())
        self.put_int("BF", flag)
        self.put_int("CF", cf)
        self.put_int("RI", rec.ref_id)
        self.put_int("RL", rl)
        self.put_int("AP", rec.pos + 1)
        self.put_int("RG", -1)
        self.put_bytes("RN", rec.read_name.encode("latin-1") + b"\x00")
        mf = (1 if flag & 0x20 else 0) | (2 if flag & 0x8 else 0)
        self.put_int("MF", mf)
        self.put_int("NS", rec.next_ref_id)
        self.put_int("NP", rec.next_pos + 1)
        self.put_int("TS", rec.tlen)

        entries = split_tags(rec.tags)
        line = tuple((tag, typ) for tag, typ, _ in entries)
        tl = self.td_index.setdefault(line, len(self.td_lines))
        if tl == len(self.td_lines):
            self.td_lines.append(line)
        self.put_int("TL", tl)
        for tag, typ, value in entries:
            key = (tag[0] << 16) | (tag[1] << 8) | typ
            self.tag_streams[key] += itf8(len(value)) + value

        qual = rec.qual if len(rec.qual) == rl else b"\xff" * rl
        if not rec.is_unmapped:
            feats = features_from_record(rec.cigar, seq)
            self.put_int("FN", len(feats))
            prev = 0
            for code, fpos, payload in feats:
                self.put_byte("FC", code)
                self.put_int("FP", fpos - prev)
                prev = fpos
                if code == ord("b"):
                    self.put_array("BB", payload)
                elif code == ord("I"):
                    self.put_array("IN", payload)
                elif code == ord("S"):
                    self.put_array("SC", payload)
                elif code == ord("D"):
                    self.put_int("DL", payload)
                elif code == ord("N"):
                    self.put_int("RS", payload)
                elif code == ord("H"):
                    self.put_int("HC", payload)
                elif code == ord("P"):
                    self.put_int("PD", payload)
            self.put_int("MQ", rec.mapq)
            self.put_bytes("QS", qual)
        else:
            if not (cf & CF_NO_SEQ):
                self.put_bytes("BA", seq.encode("latin-1"))
                self.put_bytes("QS", qual)
        self.n_records += 1
        self.bases += rl

    # ------------------------------------------------------------ assembly
    def compression_header(self) -> CompressionHeader:
        enc = {}
        for series, cid in SERIES_IDS.items():
            if series == "RN":
                enc[series] = codecs.byte_array_stop(0, cid)
            elif series in ("BB", "QQ", "IN", "SC"):
                enc[series] = codecs.byte_array_len(
                    codecs.external(cid), codecs.external(cid)
                )
            else:
                enc[series] = codecs.external(cid)
        tag_enc = {
            key: codecs.byte_array_len(codecs.external(key), codecs.external(key))
            for key in self.tag_streams
        }
        td = [
            [(tag, typ) for tag, typ in line] for line in (self.td_lines or [()])
        ]
        return CompressionHeader(
            read_names_included=True,
            ap_delta=False,
            reference_required=False,
            tag_dict=td,
            data_series=enc,
            tags=tag_enc,
        )

    def serialize(
        self, record_counter: int, method: int
    ) -> tuple[bytes, int, int]:
        """Returns (container bytes, slice offset, slice size) — the offsets
        feed the .crai index entries."""
        ch_block = Block(
            COMPRESSION_HEADER, 0, self.compression_header().serialize()
        ).serialize(GZIP if method != RAW else RAW)

        ext_blocks = []
        for series, cid in SERIES_IDS.items():
            data = bytes(self.streams[series])
            if data:
                ext_blocks.append(Block(EXTERNAL, cid, data).serialize(method))
        for key, data in sorted(self.tag_streams.items()):
            ext_blocks.append(Block(EXTERNAL, key, bytes(data)).serialize(method))
        core_block = Block(CORE, 0, b"").serialize(RAW)

        content_ids = [SERIES_IDS[s] for s in SERIES_IDS if self.streams[s]]
        content_ids += sorted(self.tag_streams)
        slice_hdr = SliceHeader(
            ref_seq_id=-2,  # multiref: RI decoded per record
            start=0,
            span=0,
            n_records=self.n_records,
            record_counter=record_counter,
            n_blocks=1 + len(ext_blocks),
            content_ids=content_ids,
        )
        slice_hdr_block = Block(
            MAPPED_SLICE, 0, slice_hdr.serialize()
        ).serialize(RAW)

        blocks = (
            ch_block + slice_hdr_block + core_block + b"".join(ext_blocks)
        )
        header = ContainerHeader(
            length=len(blocks),
            ref_seq_id=-2,
            start=0,
            span=0,
            n_records=self.n_records,
            record_counter=record_counter,
            bases=self.bases,
            n_blocks=3 + len(ext_blocks),
            landmarks=[len(ch_block)],
        )
        slice_offset = len(ch_block)
        slice_size = len(blocks) - slice_offset
        return header.serialize() + blocks, slice_offset, slice_size


class CramWriter:
    """Writes ``BamRecord``s as a reference-less CRAM at ``path``:
    ``records_per_container`` records a container, external blocks
    compressed by ``method`` (``gzip``, ``rans`` or ``raw``), and a
    ``.crai`` beside it when ``index``. ``contigs`` are ``(name, length)``
    pairs in index order; ``sam_text``, when given, is the header written
    instead of one made from them."""

    def __init__(
        self,
        path,
        contigs,
        sam_text: str = "",
        records_per_container: int = 4096,
        method: str = "gzip",
        index: bool = True,
    ):
        self.path = path
        self.f = open(path, "wb")
        self.method = _METHODS[method]
        self.records_per_container = records_per_container
        self.index = index
        self.crai_entries: list = []
        self.counter = 0
        self.pending = _PendingContainer()
        text = sam_text or synthesize_sam_text(contigs)
        self.f.write(file_definition())
        self.f.write(sam_header_container(text))

    def write(self, rec: BamRecord) -> None:
        self.pending.add(rec)
        if self.pending.n_records >= self.records_per_container:
            self._flush()

    def write_all(self, records) -> None:
        for rec in records:
            self.write(rec)

    def _flush(self) -> None:
        if self.pending.n_records:
            from spark_bam_tpu_torch.cram.crai import CraiEntry

            start_counter = self.counter
            self.counter += self.pending.n_records
            container_offset = self.f.tell()
            data, slice_offset, slice_size = self.pending.serialize(
                start_counter, self.method
            )
            self.f.write(data)
            for ref in sorted(self.pending.ref_spans):
                lo, hi = self.pending.ref_spans[ref]
                self.crai_entries.append(
                    CraiEntry(
                        ref,
                        lo + 1 if ref >= 0 else 0,
                        hi - lo if ref >= 0 else 0,
                        container_offset,
                        slice_offset,
                        slice_size,
                    )
                )
            self.pending = _PendingContainer()

    def close(self) -> None:
        self._flush()
        self.f.write(eof_container())
        self.f.close()
        if self.index:
            from spark_bam_tpu_torch.cram.crai import write_crai

            write_crai(str(self.path) + ".crai", self.crai_entries)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
