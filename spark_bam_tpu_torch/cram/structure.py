"""CRAM logical structures: compression header and slice header.

The compression header (one per data container) declares how every data
series and tag is encoded; the slice header binds a run of records to the
blocks holding their series streams.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from spark_bam_tpu_torch.core.guard import StructurallyInvalid, check_count
from spark_bam_tpu_torch.cram.codecs import Encoding
from spark_bam_tpu_torch.cram.nums import Cursor, itf8, ltf8

# Data series and their value kinds (CRAM 3.0 §8.4). ``int`` series decode
# ITF8 under EXTERNAL; ``byte`` series decode raw bytes; ``array`` series
# use BYTE_ARRAY_* encodings.
INT_SERIES = (
    "BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS", "NF",
    "TL", "FN", "FP", "DL", "RS", "PD", "HC", "MQ",
)
BYTE_SERIES = ("BA", "QS", "FC", "BS")
ARRAY_SERIES = ("RN", "BB", "QQ", "IN", "SC")

DEFAULT_SUBST_MATRIX = bytes([0x1B] * 5)  # codes 0..3 in base order, per ref base


@dataclass
class CompressionHeader:
    read_names_included: bool = True
    ap_delta: bool = False
    reference_required: bool = True
    subst_matrix: bytes = DEFAULT_SUBST_MATRIX
    tag_dict: list[list[tuple[bytes, int]]] = field(default_factory=lambda: [[]])
    data_series: dict[str, Encoding] = field(default_factory=dict)
    tags: dict[int, Encoding] = field(default_factory=dict)

    # ------------------------------------------------------------ serialize
    def serialize(self) -> bytes:
        pres = bytearray()
        entries = [
            (b"RN", bytes([self.read_names_included])),
            (b"AP", bytes([self.ap_delta])),
            (b"RR", bytes([self.reference_required])),
            (b"SM", self.subst_matrix),
            (b"TD", self._td_blob()),
        ]
        pres += itf8(len(entries))
        for key, val in entries:
            pres += key + val
        out = itf8(len(pres)) + bytes(pres)

        ds = bytearray()
        ds += itf8(len(self.data_series))
        for key, enc in self.data_series.items():
            ds += key.encode("latin-1") + enc.serialize()
        out += itf8(len(ds)) + bytes(ds)

        tg = bytearray()
        tg += itf8(len(self.tags))
        for key, enc in self.tags.items():
            tg += itf8(key) + enc.serialize()
        out += itf8(len(tg)) + bytes(tg)
        return bytes(out)

    def _td_blob(self) -> bytes:
        blob = bytearray()
        for line in self.tag_dict:
            for tag, typ in line:
                blob += tag + bytes([typ])
            blob.append(0)
        return itf8(len(blob)) + bytes(blob)

    # ---------------------------------------------------------------- parse
    @staticmethod
    def parse(data: bytes) -> "CompressionHeader":
        cur = Cursor(data)
        h = CompressionHeader()
        cur.itf8()  # preservation map byte size
        # Every count below fences a loop over parsed entries; each entry
        # is ≥ 3 bytes (2-byte key + ≥ 1 value byte), so a count beyond the
        # remaining bytes is provably corrupt before the loop runs.
        n_pres = check_count(
            cur.itf8(), "CRAM preservation-map entries", cur.remaining()
        )
        for _ in range(n_pres):
            key = cur.read(2)
            if key == b"RN":
                h.read_names_included = bool(cur.u8())
            elif key == b"AP":
                h.ap_delta = bool(cur.u8())
            elif key == b"RR":
                h.reference_required = bool(cur.u8())
            elif key == b"SM":
                h.subst_matrix = cur.read(5)
            elif key == b"TD":
                blob = cur.read(cur.itf8())
                h.tag_dict = []
                line: list[tuple[bytes, int]] = []
                i = 0
                while i < len(blob):
                    if blob[i] == 0:
                        h.tag_dict.append(line)
                        line = []
                        i += 1
                    else:
                        if i + 3 > len(blob):
                            raise StructurallyInvalid(
                                f"CRAM TD dictionary cut mid-entry at "
                                f"byte {i} of {len(blob)}"
                            )
                        line.append((bytes(blob[i: i + 2]), blob[i + 2]))
                        i += 3
                if not h.tag_dict:
                    h.tag_dict = [[]]
            else:
                raise StructurallyInvalid(
                    f"unknown preservation key {key!r}", pos=cur.pos
                )
        cur.itf8()  # data-series map byte size
        n_series = check_count(
            cur.itf8(), "CRAM data-series entries", cur.remaining()
        )
        for _ in range(n_series):
            key = cur.read(2).decode("latin-1")
            h.data_series[key] = Encoding.parse(cur)
        cur.itf8()  # tag map byte size
        n_tags = check_count(
            cur.itf8(), "CRAM tag-map entries", cur.remaining()
        )
        for _ in range(n_tags):
            key = cur.itf8()
            h.tags[key] = Encoding.parse(cur)
        return h


@dataclass
class SliceHeader:
    ref_seq_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_blocks: int
    content_ids: list[int]
    embedded_ref_id: int = -1
    ref_md5: bytes = bytes(16)
    tags: bytes = b""

    def serialize(self) -> bytes:
        return (
            itf8(self.ref_seq_id)
            + itf8(self.start)
            + itf8(self.span)
            + itf8(self.n_records)
            + ltf8(self.record_counter)
            + itf8(self.n_blocks)
            + itf8(len(self.content_ids))
            + b"".join(itf8(c) for c in self.content_ids)
            + itf8(self.embedded_ref_id)
            + self.ref_md5
            + self.tags
        )

    @staticmethod
    def parse(data: bytes) -> "SliceHeader":
        cur = Cursor(data)
        ref_seq_id = cur.itf8()
        start = cur.itf8()
        span = cur.itf8()
        n_records = cur.itf8()
        record_counter = cur.ltf8()
        n_blocks = cur.itf8()
        n_ids = check_count(
            cur.itf8(), "CRAM slice content ids", cur.remaining()
        )
        content_ids = [cur.itf8() for _ in range(n_ids)]
        embedded_ref_id = cur.itf8()
        ref_md5 = cur.read(16)
        tags = bytes(cur.buf[cur.pos:])
        return SliceHeader(
            ref_seq_id, start, span, n_records, record_counter,
            n_blocks, content_ids, embedded_ref_id, ref_md5, tags,
        )
