"""CRAM 3.0 reader: containers → slices → ``BamRecord``s.

Handles the spec surface real writers use: single-ref / multiref /
unmapped slices, AP-delta coordinates, detached and downstream-mate
records, reference-less (``RR=false``) and reference-based feature decode
(pass ``reference=`` a FASTA path or ``{name: bytes}``), per-series codecs
from the compression header (EXTERNAL / HUFFMAN / BETA / GAMMA /
BYTE_ARRAY_*), and block compression raw/gzip/bzip2/lzma/rANS.

Container headers are self-delimiting, so ``container_infos`` doubles as
the split planner for ``load_cram``, the CRAM analog of the BGZF
``.blocks`` table. The reader is the reference's (``spark_bam_tpu/cram/
reader.py``) over the port's own header and record types; it decodes on
the host, as the reference does.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass

import numpy as np

from spark_bam_tpu_torch.bam.header import BamHeader
from spark_bam_tpu_torch.bam.record import BamRecord
from spark_bam_tpu_torch.cram.bam_bridge import join_tags, reg2bin, subst_tables
from spark_bam_tpu_torch.cram.codecs import BitReader, Decoders
from spark_bam_tpu_torch.cram.container import (
    COMPRESSION_HEADER,
    CORE,
    EXTERNAL,
    FILE_HEADER,
    MAPPED_SLICE,
    Block,
    ContainerHeader,
    parse_file_definition,
)
from spark_bam_tpu_torch.cram.nums import Cursor
from spark_bam_tpu_torch.cram.structure import CompressionHeader, SliceHeader
from spark_bam_tpu_torch.cram.writer import CF_DETACHED, CF_NO_SEQ, CF_QS_PRESERVED
from spark_bam_tpu_torch.core.guard import (
    MalformedInputError,
    StructurallyInvalid,
    check_count,
    current_limits,
)
from spark_bam_tpu_torch.core.pos import Pos

CF_MATE_DOWNSTREAM = 4

_M, _I, _D, _N, _S, _H, _P = 0, 1, 2, 3, 4, 5, 6


def header_from_contigs(contigs, text: str = "") -> BamHeader:
    """A ``BamHeader`` of ``(name, length)`` pairs in index order, for a
    CRAM or SAM file: no BGZF offsets (``uncompressed_size`` 0,
    ``end_pos`` ``Pos(0, 0)``), lengths as int64."""
    names = tuple(name for name, _ in contigs)
    lengths = np.array([length for _, length in contigs], dtype=np.int64)
    return BamHeader(names, lengths, 0, Pos(0, 0), text)


def contigs_from_sam_text(text: str) -> BamHeader:
    """The ``@SQ`` dictionary of a SAM header text (``SN`` names, ``LN``
    lengths, 0 where absent) as a ``BamHeader`` holding ``text``."""
    entries = []
    for line in text.splitlines():
        if line.startswith("@SQ"):
            fields = dict(
                kv.split(":", 1) for kv in line.split("\t")[1:] if ":" in kv
            )
            if "SN" in fields:
                entries.append((fields["SN"], int(fields.get("LN", 0))))
    return header_from_contigs(entries, text)


@dataclass
class ContainerInfo:
    offset: int          # file offset of the container header
    end: int             # file offset one past the last block byte
    n_records: int
    record_counter: int


def load_cram_header(path) -> BamHeader:
    with CramReader(path) as r:
        return r.bam_header


class CramReader:
    def __init__(self, path, reference=None):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
            buf: bytes | mmap.mmap = self._mm
        except ValueError:  # empty file
            self._mm = None
            buf = b""
        self.buf = buf
        parse_file_definition(bytes(buf[:6]))
        cur = Cursor(buf, 26)
        header = ContainerHeader.parse(cur)
        blocks_start = cur.pos
        block = Block.parse(cur)
        if block.content_type != FILE_HEADER:
            raise StructurallyInvalid(
                "first CRAM container does not hold the SAM header",
                path=path,
            )
        text_cur = Cursor(block.data)
        text_len = text_cur.i32()
        self.sam_text = text_cur.read(text_len).decode("latin-1")
        self.header = contigs_from_sam_text(self.sam_text)
        self.first_data_offset = blocks_start + header.length
        if isinstance(reference, (str, bytes)) or hasattr(reference, "__fspath__"):
            from spark_bam_tpu_torch.cram.fasta import read_fasta

            reference = read_fasta(reference)
        self.reference = reference

    @property
    def bam_header(self) -> BamHeader:
        return self.header

    # ------------------------------------------------------------- layout
    def container_infos(self) -> list[ContainerInfo]:
        """Header-only walk of the data containers (the split table)."""
        infos = []
        cur = Cursor(self.buf, self.first_data_offset)
        while cur.remaining() > 0:
            offset = cur.pos
            header = ContainerHeader.parse(cur)
            if header.is_eof:
                break
            end = cur.pos + header.length
            infos.append(
                ContainerInfo(offset, end, header.n_records, header.record_counter)
            )
            cur.pos = end
        return infos

    # ------------------------------------------------------------- decode
    def records(self, offset: int | None = None, end: int | None = None):
        """Iterate records of containers whose header starts in
        [offset, end) — defaults to the whole file."""
        cur = Cursor(self.buf, self.first_data_offset if offset is None else offset)
        while cur.remaining() > 0 and (end is None or cur.pos < end):
            container_start = cur.pos
            header = ContainerHeader.parse(cur)
            if header.is_eof:
                break
            region_end = cur.pos + header.length
            # Decode boundary: whatever a corrupt container throws deep in
            # the codec machinery (bad tag keys, inconsistent series
            # lengths, malformed UTF/latin frames) surfaces as one typed
            # error carrying the container offset.
            try:
                out = list(self._decode_container(cur, header, region_end))
            except MalformedInputError:
                raise
            except (
                ValueError,
                KeyError,
                IndexError,
                NotImplementedError,
                OverflowError,
                UnicodeDecodeError,
                struct.error,
            ) as e:
                raise StructurallyInvalid(
                    f"CRAM container decode failed: {e!r}",
                    path=self.path,
                    pos=container_start,
                ) from e
            yield from out
            cur.pos = region_end

    def __iter__(self):
        return self.records()

    def _decode_container(self, cur: Cursor, header: ContainerHeader, region_end: int):
        first = Block.parse(cur)
        if first.content_type != COMPRESSION_HEADER:
            raise StructurallyInvalid(
                "container does not start with a compression header"
            )
        ch = CompressionHeader.parse(first.data)
        counter = header.record_counter
        while cur.pos < region_end:
            sh_block = Block.parse(cur)
            if sh_block.content_type != MAPPED_SLICE:
                raise StructurallyInvalid(
                    f"expected slice header block, got type {sh_block.content_type}"
                )
            sh = SliceHeader.parse(sh_block.data)
            # A slice cannot hold more records than its container declares;
            # the slice count sizes per-record work below, so fence it here.
            check_count(sh.n_records, "CRAM slice records", header.n_records)
            blocks = [Block.parse(cur) for _ in range(sh.n_blocks)]
            yield from self._decode_slice(ch, sh, blocks, counter)
            counter += sh.n_records

    def _decode_slice(
        self, ch: CompressionHeader, sh: SliceHeader, blocks: list[Block], counter: int
    ):
        core = next((b for b in blocks if b.content_type == CORE), None)
        ext = {
            b.content_id: Cursor(b.data)
            for b in blocks
            if b.content_type == EXTERNAL
        }
        embedded_ref = None
        ref_origin = 0  # 0-based reference position of ref byte 0
        if sh.embedded_ref_id >= 0 and sh.embedded_ref_id in ext:
            # The embedded block holds only the slice's span: its first
            # byte is the base at the slice's 1-based alignment start.
            embedded_ref = ext[sh.embedded_ref_id].buf
            ref_origin = max(sh.start - 1, 0)
        dec = Decoders(BitReader(core.data if core else b""), ext)
        ds = ch.data_series

        def int_r(key: str, default: int | None = None):
            if key in ds:
                return dec.int_reader(ds[key])
            if default is None:
                def missing():
                    raise ValueError(f"data series {key} not encoded")
                return missing
            return lambda: default

        def byte_r(key: str):
            if key in ds:
                return dec.byte_reader(ds[key])
            def missing():
                raise ValueError(f"data series {key} not encoded")
            return missing

        def array_r(key: str):
            if key in ds:
                return dec.array_reader(ds[key])
            return lambda: b""

        def bulk_r(key: str):
            if key in ds:
                return dec.bulk_reader(ds[key])
            return lambda n: b"\xff" * n

        r_bf, r_cf = int_r("BF"), int_r("CF")
        r_ri = int_r("RI", -1)
        r_rl, r_ap = int_r("RL"), int_r("AP")
        r_rg = int_r("RG", -1)
        r_rn = array_r("RN")
        r_mf, r_ns = int_r("MF", 0), int_r("NS", -1)
        r_np, r_ts = int_r("NP", 0), int_r("TS", 0)
        r_nf = int_r("NF", 0)
        r_tl = int_r("TL", 0)
        r_fn, r_fp = int_r("FN", 0), int_r("FP", 0)
        r_fc = byte_r("FC")
        r_dl, r_rs = int_r("DL", 0), int_r("RS", 0)
        r_hc, r_pd = int_r("HC", 0), int_r("PD", 0)
        r_mq = int_r("MQ", 0)
        r_bb, r_in, r_sc, r_qq = (
            array_r("BB"), array_r("IN"), array_r("SC"), array_r("QQ"),
        )
        r_bs = byte_r("BS") if "BS" in ds else lambda: 0
        r_ba_bulk, r_qs_bulk = bulk_r("BA"), bulk_r("QS")
        r_ba = byte_r("BA") if "BA" in ds else lambda: ord("N")
        r_qs = byte_r("QS") if "QS" in ds else lambda: 0xFF
        tag_readers = {key: dec.array_reader(enc) for key, enc in ch.tags.items()}
        sub = subst_tables(ch.subst_matrix)

        out: list[BamRecord] = []
        links: list[int | None] = []
        last_ap = sh.start
        max_seq = current_limits().max_seq_len
        for i in range(sh.n_records):
            bf = r_bf()
            cf = r_cf()
            ri = r_ri() if sh.ref_seq_id == -2 else sh.ref_seq_id
            # RL sizes the seq/qual buffers and bulk reads below.
            rl = check_count(r_rl(), "CRAM read length", max_seq)
            if ch.ap_delta:
                last_ap += r_ap()
                ap = last_ap
            else:
                ap = r_ap()
            r_rg()
            name = ""
            if ch.read_names_included:
                name = r_rn().decode("latin-1")
            nf = None
            mate_ref, mate_pos, ts = -1, -1, 0
            if cf & CF_DETACHED:
                mf = r_mf()
                if not ch.read_names_included:
                    name = r_rn().decode("latin-1")
                mate_ref = r_ns()
                mate_pos = r_np() - 1
                ts = r_ts()
                if mf & 1:
                    bf |= 0x20
                if mf & 2:
                    bf |= 0x8
            elif cf & CF_MATE_DOWNSTREAM:
                nf = r_nf()
            if not name:
                name = f"q{counter + i}"
            tl = r_tl()
            line = ch.tag_dict[tl] if tl < len(ch.tag_dict) else []
            entries = []
            for tag, typ in line:
                key = (tag[0] << 16) | (tag[1] << 8) | typ
                entries.append((tag, typ, tag_readers[key]()))
            tags = join_tags(entries)

            pos = ap - 1
            if not (bf & 4):
                rec = self._decode_mapped(
                    bf, cf, ri, rl, pos, sub, embedded_ref, ref_origin,
                    ch.reference_required,
                    r_fn, r_fc, r_fp, r_bb, r_in, r_sc, r_qq, r_bs,
                    r_dl, r_rs, r_hc, r_pd, r_mq, r_ba, r_qs, r_qs_bulk,
                )
            else:
                if cf & CF_NO_SEQ:
                    seq, qual = "", b""
                else:
                    seq = r_ba_bulk(rl).decode("latin-1")
                    qual = r_qs_bulk(rl) if cf & CF_QS_PRESERVED else b"\xff" * rl
                # MQ is a mapped-only data series in CRAM: an unmapped
                # read's nonzero MAPQ is not representable and decodes as
                # 0 (htsjdk behaves identically).
                rec = BamRecord(
                    ri, pos, 0, reg2bin(pos, pos + 1) if pos >= 0 else 0,
                    bf, -1, -1, 0, "", [], seq, qual, b"",
                )
            if cf & CF_NO_SEQ:
                rec.seq, rec.qual = "", b""
            rec.read_name = name
            rec.tags = tags
            if cf & CF_DETACHED:
                rec.next_ref_id, rec.next_pos, rec.tlen = mate_ref, mate_pos, ts
            out.append(rec)
            links.append(nf)

        self._resolve_mates(out, links, ch.read_names_included)
        return out

    def _decode_mapped(
        self, bf, cf, ri, rl, pos, sub, embedded_ref, ref_origin,
        reference_required,
        r_fn, r_fc, r_fp, r_bb, r_in, r_sc, r_qq, r_bs,
        r_dl, r_rs, r_hc, r_pd, r_mq, r_ba, r_qs, r_qs_bulk,
    ) -> BamRecord:
        ref_seq = embedded_ref
        if ref_seq is None:
            ref_origin = 0
            if self.reference is not None and ri >= 0:
                ref_seq = self.reference.get(self.header.contig_names[ri])

        fn = r_fn()
        feats = []
        fpos = 0
        for _ in range(fn):
            fc = r_fc()
            fpos += r_fp()
            c = chr(fc)
            if c == "b":
                payload = r_bb()
            elif c == "B":
                payload = (r_ba(), r_qs())
            elif c == "X":
                payload = r_bs()
            elif c == "I":
                payload = r_in()
            elif c == "i":
                payload = bytes([r_ba()])
            elif c == "S":
                payload = r_sc()
            elif c == "q":
                payload = r_qq()
            elif c == "Q":
                payload = r_qs()
            elif c == "D":
                payload = r_dl()
            elif c == "N":
                payload = r_rs()
            elif c == "H":
                payload = r_hc()
            elif c == "P":
                payload = r_pd()
            else:
                raise ValueError(f"unknown feature code {c!r}")
            feats.append((c, fpos, payload))
        mq = r_mq()
        qual = bytearray(
            r_qs_bulk(rl) if cf & CF_QS_PRESERVED else b"\xff" * rl
        )

        seq = bytearray(rl)
        cigar: list[tuple[int, int]] = []
        read_cur = 1   # 1-based read cursor
        ref_off = 0    # reference bases consumed

        def ref_base(k: int) -> int:
            if ref_seq is None:
                if reference_required:
                    raise ValueError(
                        "this CRAM was written reference-based (RR=true): "
                        "pass reference= (FASTA path or {name: bytes}) to "
                        "CramReader/load_cram to decode sequences"
                    )
                return ord("N")  # RR=false: bases are genuinely unknown
            idx = pos + k - ref_origin
            if 0 <= idx < len(ref_seq):
                return ref_seq[idx] & ~0x20  # uppercase
            return ord("N")

        def emit(op: int, length: int) -> None:
            if length <= 0:
                return
            if cigar and cigar[-1][1] == op:
                cigar[-1] = (cigar[-1][0] + length, op)
            else:
                cigar.append((length, op))

        def match_gap(length: int) -> None:
            nonlocal read_cur, ref_off
            for k in range(length):
                seq[read_cur - 1 + k] = ref_base(ref_off + k)
            emit(_M, length)
            read_cur += length
            ref_off += length

        for c, fpos, payload in feats:
            if fpos > read_cur and c not in ("Q", "q"):
                match_gap(fpos - read_cur)
            if c == "b":
                n = len(payload)
                seq[read_cur - 1: read_cur - 1 + n] = payload
                emit(_M, n)
                read_cur += n
                ref_off += n
            elif c == "B":
                base, q = payload
                seq[read_cur - 1] = base
                qual[read_cur - 1] = q
                emit(_M, 1)
                read_cur += 1
                ref_off += 1
            elif c == "X":
                rb = chr(ref_base(ref_off))
                alt = sub.get(rb.upper(), sub["N"])[payload & 0x3]
                seq[read_cur - 1] = ord(alt)
                emit(_M, 1)
                read_cur += 1
                ref_off += 1
            elif c in ("I", "i"):
                n = len(payload)
                seq[read_cur - 1: read_cur - 1 + n] = payload
                emit(_I, n)
                read_cur += n
            elif c == "S":
                n = len(payload)
                seq[read_cur - 1: read_cur - 1 + n] = payload
                emit(_S, n)
                read_cur += n
            elif c == "D":
                emit(_D, payload)
                ref_off += payload
            elif c == "N":
                emit(_N, payload)
                ref_off += payload
            elif c == "H":
                emit(_H, payload)
            elif c == "P":
                emit(_P, payload)
            elif c == "Q":
                qual[fpos - 1] = payload
            elif c == "q":
                qual[fpos - 1: fpos - 1 + len(payload)] = payload
        if read_cur <= rl:
            match_gap(rl - read_cur + 1)

        span = sum(n for n, op in cigar if op in (_M, _D, _N))
        end = pos + (span if span else 1)
        return BamRecord(
            ri, pos, mq, reg2bin(pos, end) if pos >= 0 else 0, bf,
            -1, -1, 0, "", cigar, seq.decode("latin-1"), bytes(qual), b"",
        )

    @staticmethod
    def _resolve_mates(
        out: list[BamRecord],
        links: list[int | None],
        names_included: bool,
    ) -> None:
        for i, nf in enumerate(links):
            if nf is None:
                continue
            j = i + nf + 1
            if j >= len(out):
                continue
            a, b = out[i], out[j]
            if not names_included:
                # Synthesized QNAMEs: NF-linked mates are one template and
                # must share one name (htsjdk generates one name per pair).
                b.read_name = a.read_name
            a.next_ref_id, a.next_pos = b.ref_id, b.pos
            b.next_ref_id, b.next_pos = a.ref_id, a.pos
            if b.flag & 0x10:
                a.flag |= 0x20
            if b.flag & 0x4:
                a.flag |= 0x8
            if a.flag & 0x10:
                b.flag |= 0x20
            if a.flag & 0x4:
                b.flag |= 0x8
            if a.ref_id == b.ref_id and a.ref_id >= 0:
                left = min(a.pos, b.pos)
                right = max(a.end_pos(), b.end_pos())
                span = right - left
                a.tlen = span if a.pos <= b.pos else -span
                b.tlen = -a.tlen

    # ------------------------------------------------------------ plumbing
    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
