"""End-to-end integrity scrubber of rewritten and exported artifacts
(reference ``spark_bam_tpu/jobs/scrub.py``).

It checks what the job plane writes, and anything shaped like it: BAM
outputs member by member (the BGZF header, the raw DEFLATE round trip,
each member's CRC32 and ISIZE, the EOF sentinel), the ``.blocks``,
``.records`` and ``.sbi`` sidecars against the BAM they describe, and
native columnar containers through the validating reader (frame CRCs,
schema, the end frame's counts). With a ``source`` BAM it also runs
record parity: source and output decoded in lock step, the encoded bytes
compared on a stride and the totals always.

Damaged artifacts can be quarantined (renamed ``<path>.quarantined``) so
no warm load trusts them again. Every artifact gets a verdict in a
:class:`ScrubReport`, whose ``job_report()`` is the executor's ledger
shape (``parallel/executor.py``). The findings' texts are the
reference's, so both packages' ``summary()`` agree on the same files.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.bam.writer import BGZF_EOF
from spark_bam_tpu_torch.bgzf.block import Metadata
from spark_bam_tpu_torch.parallel.executor import JobReport, PartitionReport

_MEMBER_MAGIC = b"\x1f\x8b\x08\x04"


@dataclass
class Finding:
    path: str
    kind: str     # bam | blocks | records | sbi | native | parity | io
    error: str

    def as_dict(self) -> dict:
        return {"path": self.path, "kind": self.kind, "error": self.error}


@dataclass
class ScrubReport:
    artifacts: "list[str]" = field(default_factory=list)
    findings: "list[Finding]" = field(default_factory=list)
    quarantined: "list[str]" = field(default_factory=list)
    records_checked: int = 0
    records_compared: int = 0

    @property
    def clean(self) -> bool:
        return not self.findings

    def job_report(self) -> JobReport:
        """The scrub as an executor ledger: one partition an artifact,
        quarantined where findings landed."""
        bad = {f.path for f in self.findings}
        parts = []
        for i, path in enumerate(self.artifacts):
            errors = "; ".join(
                f.error for f in self.findings if f.path == path
            )
            parts.append(PartitionReport(
                index=i,
                status="quarantined" if path in bad else "ok",
                error=errors or None,
            ))
        return JobReport(partitions=parts)

    def summary(self) -> dict:
        return {
            "artifacts": len(self.artifacts),
            "findings": [f.as_dict() for f in self.findings],
            "quarantined": list(self.quarantined),
            "records_checked": self.records_checked,
            "records_compared": self.records_compared,
            "clean": self.clean,
        }


def scan_bgzf_members(data: bytes, path: str
                      ) -> "tuple[list[Metadata], list[Finding]]":
    """Structural walk of a BGZF byte string: every member's header, BSIZE
    subfield, raw DEFLATE payload, CRC32 and ISIZE, and the 28-byte EOF
    sentinel at the end. Returns the member table (for the sidecar checks)
    and the findings."""
    members: "list[Metadata]" = []
    findings: "list[Finding]" = []

    def bad(msg: str) -> "tuple[list[Metadata], list[Finding]]":
        findings.append(Finding(path, "bam", msg))
        return members, findings

    p = 0
    n = len(data)
    while p < n:
        if n - p < 18:
            return bad(f"trailing {n - p} bytes at {p}: no room for a member")
        if data[p: p + 4] != _MEMBER_MAGIC:
            return bad(f"bad BGZF member magic at offset {p}")
        xlen = struct.unpack_from("<H", data, p + 10)[0]
        extra = data[p + 12: p + 12 + xlen]
        if len(extra) != xlen:
            return bad(f"member at {p}: extra field truncated")
        bsize = None
        q = 0
        while q + 4 <= len(extra):
            si1, si2, slen = extra[q], extra[q + 1], struct.unpack_from(
                "<H", extra, q + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", extra, q + 4)[0]
            q += 4 + slen
        if bsize is None:
            return bad(f"member at {p}: no BC (BSIZE) subfield")
        size = bsize + 1
        if p + size > n:
            return bad(
                f"member at {p}: declares {size} bytes, file has {n - p}"
            )
        payload = data[p + 12 + xlen: p + size - 8]
        crc, isize = struct.unpack_from("<II", data, p + size - 8)
        try:
            inflated = zlib.decompress(bytes(payload), -15)
        except zlib.error as exc:
            return bad(f"member at {p}: deflate payload corrupt ({exc})")
        if len(inflated) != isize:
            return bad(
                f"member at {p}: ISIZE {isize} != inflated {len(inflated)}"
            )
        if (zlib.crc32(inflated) & 0xFFFFFFFF) != crc:
            return bad(f"member at {p}: payload CRC32 mismatch")
        members.append(Metadata(p, size, isize))
        p += size
    if not data.endswith(BGZF_EOF):
        findings.append(Finding(path, "bam", "missing BGZF EOF sentinel"))
    elif members and members[-1].uncompressed_size == 0:
        members.pop()  # the sentinel is not a data member
    return members, findings


def _scrub_blocks_sidecar(path: str, members: "list[Metadata]"
                          ) -> "list[Finding]":
    from spark_bam_tpu_torch.bgzf.index_blocks import read_blocks_index

    try:
        rows = read_blocks_index(path)
    except (OSError, ValueError) as exc:
        return [Finding(path, "blocks", f"unreadable: {exc}")]
    if rows != members:
        n = min(len(rows), len(members))
        at = next(
            (i for i in range(n) if rows[i] != members[i]), n
        )
        return [Finding(
            path, "blocks",
            f"{len(rows)} rows vs {len(members)} members on disk; "
            f"first divergence at row {at}",
        )]
    return []


def _scrub_records_sidecar(path: str, members: "list[Metadata]"
                           ) -> "list[Finding]":
    from spark_bam_tpu_torch.bam.index_records import read_records_index

    try:
        rows = read_records_index(path)
    except (OSError, ValueError) as exc:
        return [Finding(path, "records", f"unreadable: {exc}")]
    usize = {m.start: m.uncompressed_size for m in members}
    for i, pos in enumerate(rows):
        if pos.block_pos not in usize:
            return [Finding(
                path, "records",
                f"row {i}: {pos} does not start on a member boundary",
            )]
        if not (0 <= pos.offset < max(usize[pos.block_pos], 1)):
            return [Finding(
                path, "records",
                f"row {i}: {pos} offset outside its member's "
                f"{usize[pos.block_pos]} uncompressed bytes",
            )]
    return []


def _scrub_sbi(path: str, members: "list[Metadata]") -> "list[Finding]":
    from spark_bam_tpu_torch.sbi.format import SbiFormatError, decode_sbi

    try:
        with open(path, "rb") as f:
            index = decode_sbi(f.read())
    except (OSError, SbiFormatError, ValueError) as exc:
        return [Finding(path, "sbi", f"undecodable: {exc}")]
    if members and list(index.blocks) != members:
        return [Finding(
            path, "sbi",
            f"{len(index.blocks)} indexed blocks disagree with "
            f"{len(members)} members on disk",
        )]
    return []


def _scrub_native(path: str) -> "tuple[int, list[Finding]]":
    from spark_bam_tpu_torch.columnar.native import (
        ColumnarFormatError,
        NativeReader,
    )

    try:
        reader = NativeReader(path)
        rows = sum(b.num_rows for b in reader.iter_batches())
    except (OSError, ColumnarFormatError, ValueError) as exc:
        return 0, [Finding(path, "native", f"container invalid: {exc}")]
    return rows, []


def _record_parity(out_path: str, source: str, stride: int
                   ) -> "tuple[int, int, list[Finding]]":
    """Source and output decoded in lock step: every ``stride``-th
    record's encoded bytes must match, and so must the totals. Returns
    (records checked, records byte-compared, findings)."""
    from spark_bam_tpu_torch.bam.iterators import RecordStream
    from spark_bam_tpu_torch.core.channel import open_channel
    from spark_bam_tpu_torch.core.guard import MalformedInputError

    checked = compared = 0
    try:
        with open_channel(source) as sch, open_channel(out_path) as och:
            src = iter(RecordStream.open(sch))
            out = iter(RecordStream.open(och))
            i = 0
            while True:
                a = next(src, None)
                b = next(out, None)
                if a is None and b is None:
                    break
                if a is None or b is None:
                    return checked, compared, [Finding(
                        out_path, "parity",
                        f"record count diverges at index {i} "
                        f"(source {'ended' if a is None else 'continues'})",
                    )]
                checked += 1
                if i % max(stride, 1) == 0:
                    compared += 1
                    if a[1].encode() != b[1].encode():
                        return checked, compared, [Finding(
                            out_path, "parity",
                            f"record {i} bytes differ from source",
                        )]
                i += 1
    except (OSError, MalformedInputError, ValueError, EOFError) as exc:
        return checked, compared, [Finding(
            out_path, "parity", f"parity scan failed: {exc}"
        )]
    return checked, compared, []


def _sniff(path: str) -> str:
    """An artifact's kind by extension, else by its magic bytes."""
    from spark_bam_tpu_torch.columnar.native import MAGIC as SBCR_MAGIC

    lower = path.lower()
    for ext in ("blocks", "records", "sbi"):
        if lower.endswith("." + ext):
            return ext
    try:
        with open(path, "rb") as f:
            head = f.read(4)
    except OSError:
        return "io"
    if head[:2] == b"\x1f\x8b":
        return "bam"
    if head == SBCR_MAGIC:
        return "native"
    return "bam" if lower.endswith(".bam") else "native"


def scrub_paths(
    paths,
    source: "str | None" = None,
    quarantine: bool = False,
    stride: int = 16,
) -> ScrubReport:
    """Scrub each artifact of ``paths``. A ``.bam`` pulls in its existing
    sidecars; ``source`` turns on record parity against the input the
    artifact was made from."""
    report = ScrubReport()
    todo: "list[str]" = []
    for p in (str(p) for p in paths):
        todo.append(p)
        if p.lower().endswith(".bam"):
            for ext in (".blocks", ".records", ".sbi"):
                if os.path.exists(p + ext) and p + ext not in todo:
                    todo.append(p + ext)
    members_of: "dict[str, list[Metadata]]" = {}
    with obs.span("jobs.scrub", artifacts=len(todo)):
        # BAMs first: the sidecar checks need their member tables.
        for path in sorted(todo, key=lambda p: _sniff(p) != "bam"):
            kind = _sniff(path)
            report.artifacts.append(path)
            obs.count("scrub.artifacts")
            findings: "list[Finding]" = []
            if kind == "io":
                findings = [Finding(path, "io", "unreadable artifact")]
            elif kind == "bam":
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError as exc:
                    findings = [Finding(path, "io", str(exc))]
                else:
                    members, findings = scan_bgzf_members(data, path)
                    members_of[path] = members
                    if not findings and source:
                        checked, compared, parity = _record_parity(
                            path, source, stride
                        )
                        report.records_checked += checked
                        report.records_compared += compared
                        findings.extend(parity)
            elif kind == "native":
                rows, findings = _scrub_native(path)
                report.records_checked += rows
            else:
                base = path[: path.rfind(".")]
                members = members_of.get(base, [])
                if kind == "blocks":
                    findings = _scrub_blocks_sidecar(path, members)
                elif kind == "records":
                    findings = _scrub_records_sidecar(path, members)
                else:
                    findings = _scrub_sbi(path, members)
            report.findings.extend(findings)
            if findings:
                obs.count("scrub.findings", len(findings))
                if quarantine:
                    try:
                        os.replace(path, path + ".quarantined")
                        report.quarantined.append(path + ".quarantined")
                        obs.count("scrub.quarantined")
                    except OSError:
                        pass
    obs.count("scrub.records_checked", report.records_checked)
    return report
