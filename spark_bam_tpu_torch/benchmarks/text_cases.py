"""SAM and CRAM copies of a BAM, for the tests and ``chip_smoke.py``.

The records are decoded from the BAM by the port's record stream and
written again by the port's own writers, so neither JAX nor the JAX
package is needed: ``write_sam`` renders each record with ``to_sam``
under the BAM's header text, and ``write_cram`` encodes them with the
reference-less ``CramWriter`` (and its ``.crai`` beside it).

The CRAM writer is reference-less (``RR=false``): a record's ``=`` and
``X`` cigar runs come back as ``M``, and SAM carries no ``bin`` (it
parses as 0). The BAMs these helpers are given use ``M`` runs only, so
their CRAM copies decode to equal records.
"""

from __future__ import annotations

from spark_bam_tpu_torch.bam.header import BamHeader
from spark_bam_tpu_torch.bam.iterators import RecordStream
from spark_bam_tpu_torch.core.channel import open_channel


def bam_records(path) -> tuple[BamHeader, list]:
    """The header and every record of the BAM at ``path``."""
    stream = RecordStream.open(open_channel(path))
    try:
        return stream.header, [rec for _, rec in stream]
    finally:
        stream.close()


def contig_pairs(header: BamHeader) -> list[tuple[str, int]]:
    return [(str(n), int(ln)) for n, ln in
            zip(header.contig_names, header.contig_lengths)]


def write_sam(header: BamHeader, records, path) -> int:
    """The records as a SAM file under the header's text; returns their
    count."""
    n = 0
    with open(path, "w", encoding="latin-1") as f:
        f.write(header.text)
        if header.text and not header.text.endswith("\n"):
            f.write("\n")
        for rec in records:
            f.write(rec.to_sam(header.contig_names) + "\n")
            n += 1
    return n


def write_cram(header: BamHeader, records, path, method: str = "gzip",
               records_per_container: int = 4096, index: bool = True
               ) -> int:
    """The records as a reference-less CRAM (``method`` gzip, rans or raw)
    under the header's text, with its ``.crai`` when ``index``; returns
    their count."""
    from spark_bam_tpu_torch.cram import CramWriter

    n = 0
    with CramWriter(path, contig_pairs(header), header.text,
                    records_per_container=records_per_container,
                    method=method, index=index) as w:
        for rec in records:
            w.write(rec)
            n += 1
    return n


def write_cram_from_bam(bam_path, cram_path, method: str = "gzip",
                        records_per_container: int = 4096) -> dict:
    """``write_cram`` of a BAM's records, timed: ``{"records",
    "decode_s", "write_s"}`` (the BAM's decode and the CRAM's write).
    ``python -m spark_bam_tpu_torch.benchmarks.text_cases BAM CRAM
    [METHOD]`` prints the same as one JSON line."""
    import time

    t0 = time.perf_counter()
    header, records = bam_records(bam_path)
    t1 = time.perf_counter()
    n = write_cram(header, records, cram_path, method, records_per_container)
    return {"records": n, "decode_s": t1 - t0,
            "write_s": time.perf_counter() - t1}


if __name__ == "__main__":
    import json
    import sys

    print(json.dumps(write_cram_from_bam(*sys.argv[1:4])), flush=True)
