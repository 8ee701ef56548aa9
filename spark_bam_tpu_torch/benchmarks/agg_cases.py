"""Inputs for the aggregate: seeded record planes with their edge rows, the
two inputs where the JAX package's device reduction leaves the wire
contract, a tagged BAM and an unmapped BAM with no reference sequences.

One set, shared by the CPU tests (the port against the JAX package), the
card tests and ``chip_smoke.py`` (the card against ``device="cpu"`` and
the int64 oracle). It needs neither JAX nor the JAX package: the BAMs are
encoded by ``load_cases.encode_record`` and compressed by ``synth.py``.

- ``random_planes(seed, m, nc)``: ``m`` seeded rows of every plane the
  reduction reads, then the edge rows: ``mapq`` outside 0-255, ``ref_span``
  0 and negative, ``pos`` -1 on a mapped flag, ``ref_id`` -1, ``nc`` and
  past it, spans over more buckets than any ``cap``, reads past the last
  bucket (its collapse), a read ending just short of 2^31, ``tlen``
  ±(2^31 - 1), and an invalid row.
- ``REFERENCE_FAULTS``: name → ``(spec, nc, planes)``. ``tlen_min_int``:
  eight valid rows, one with ``tlen`` -2^31 (the JAX device path's
  ``|tlen|`` stays negative in int32 and its scatter drops the row).
  ``coverage_near_2_31``: a read at ``pos`` 2^31 - 10 with ``ref_span`` 100
  and one at ``pos`` 500 (the JAX device path's ``pos + span`` wraps in
  int32 and the first read's bases vanish).
- ``write_tagged_bam(path)``: 240 records on the contigs of
  ``TAGGED_CONTIGS``, 200 mapped over two contigs then 40 unmapped, NM on
  every 3rd, RG on every 5th and a B array BC on every 7th, seeded
  ``mapq`` and ``tlen``: the shape of the JAX package's own aggregate test
  BAM.
- ``write_unmapped_bam(path, n)``: ``n`` unmapped reads and a header with
  no reference sequences (``nc`` = 0: the coverage vector is empty).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from spark_bam_tpu_torch.benchmarks.load_cases import encode_record, tag
from spark_bam_tpu_torch.benchmarks.synth import (
    BGZF_EOF,
    compress_block,
    compress_blocks,
    encode_header,
)

PLANES = ("valid", "flag", "mapq", "tlen", "l_seq", "pos", "ref_span",
          "ref_id")
TAGGED_CONTIGS = (("chr1", 10_000_000), ("chr2", 5_000_000))
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _edge_rows(nc: int) -> list[dict]:
    """Edge rows (all valid but the last); fields left out are 0."""
    mapped = dict(valid=True, flag=0, mapq=30, l_seq=100, ref_id=0)
    return [
        dict(mapped, mapq=-3), dict(mapped, mapq=300),
        dict(mapped, pos=500, ref_span=0), dict(mapped, pos=500,
                                                ref_span=-7),
        dict(mapped, pos=-1, ref_span=50),
        dict(mapped, ref_id=-1, pos=100, ref_span=50),
        dict(mapped, ref_id=nc, pos=100, ref_span=50),
        dict(mapped, ref_id=nc + 5, pos=100, ref_span=50),
        dict(mapped, pos=123, ref_span=50_000),         # > cap buckets
        dict(mapped, pos=3_999_999, ref_span=2_000_000),  # last buckets
        dict(mapped, pos=900_000_000, ref_span=10),     # past the last
        # Ends 50 short of 2^31, and keeps one bucket's sum below 2^31.
        dict(mapped, ref_id=max(nc - 1, 0), pos=(1 << 30) - 100,
             ref_span=(1 << 30) + 50),
        dict(mapped, flag=4, pos=100, ref_span=50),     # unmapped bit
        dict(mapped, tlen=_I32_MAX), dict(mapped, tlen=-_I32_MAX),
        dict(mapped, tlen=2001), dict(mapped, tlen=-2002),
        dict(mapped, flag=0xFFFF, l_seq=-5),
        dict(valid=False, flag=3, mapq=7, tlen=9, l_seq=11, pos=13,
             ref_span=15, ref_id=0),
    ]


def random_planes(seed: int, m: int, nc: int) -> dict:
    """``m`` seeded rows (then the edge rows) of the planes the reduction
    reads: int32 planes and a bool ``valid``."""
    rng = np.random.default_rng(seed)
    cols = {
        "valid": rng.random(m) < 0.85,
        "flag": rng.integers(0, 1 << 12, m),
        "mapq": rng.integers(0, 256, m),
        "tlen": rng.integers(-3000, 3000, m),
        "l_seq": rng.integers(0, 400, m),
        "pos": rng.integers(-1, 700_000, m),
        "ref_span": rng.integers(-3, 4000, m),
        "ref_id": rng.integers(-1, max(nc, 1) + 1, m),
    }
    extra = _edge_rows(nc)
    for k in PLANES:
        cols[k] = np.concatenate([cols[k], [r.get(k, 0) for r in extra]])
    return {k: np.asarray(v, dtype=bool if k == "valid" else np.int32)
            for k, v in cols.items()}


def _rows(**cols) -> dict:
    n = len(cols["pos"])
    out = {"valid": np.ones(n, dtype=bool)}
    for k in PLANES[1:]:
        out[k] = np.asarray(cols.get(k, [0] * n), dtype=np.int64).astype(
            np.int32)
    return out


REFERENCE_FAULTS = {
    "tlen_min_int": ("tlen", 1, _rows(
        pos=[0] * 8,
        tlen=[0, 5, -5, 2000, 2001, -3000, _I32_MIN, 17])),
    "coverage_near_2_31": ("coverage", 1, _rows(
        pos=[_I32_MAX - 9, 500], ref_span=[100, 100])),
}


def _write(path, header: bytes, records: list[bytes],
           block: int = 5000) -> None:
    stream = b"".join(records)
    blob = compress_blocks(header) + b"".join(
        compress_block(stream[i: i + block])
        for i in range(0, len(stream), block)) + BGZF_EOF
    Path(path).write_bytes(blob)


def write_tagged_bam(path, seed: int = 3) -> int:
    """The tagged BAM; returns its record count."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(240):
        n = int(rng.integers(20, 150))
        mapped = i < 200
        tags = b""
        if i % 3 == 0:
            tags += tag("NM", "i", struct.pack("<i",
                                               int(rng.integers(0, 5))))
        if i % 5 == 0:
            tags += tag("RG", "Z", b"grp1\x00")
        if i % 7 == 0:
            tags += tag("BC", "B", b"I" + struct.pack("<iIII", 3, 1, 2, 3))
        recs.append(encode_record(
            ref_id=(i // 100) if mapped else -1,
            pos=5 + 13 * (i % 100) if mapped else -1,
            mapq=int(rng.integers(0, 61)) if mapped else 0, bin_=0,
            flag=(16 if i % 2 else 0) if mapped else 4,
            tlen=int(rng.integers(-900, 900)), name=b"r%d" % i,
            cigar=((n, 0),) if mapped else (), seq_len=n, rng=rng,
            tags=tags))
    _write(path, encode_header(TAGGED_CONTIGS), recs)
    return len(recs)


def write_unmapped_bam(path, n: int = 500, seed: int = 5) -> int:
    """Unmapped reads under a header with no reference sequences; returns
    the record count."""
    rng = np.random.default_rng(seed)
    recs = [encode_record(
        ref_id=-1, pos=-1, flag=4 | int(rng.choice([0, 1, 0x41, 0x81])),
        mapq=0, bin_=4680, tlen=int(rng.integers(-50, 50)),
        name=b"u%d" % i, cigar=(), seq_len=int(rng.integers(30, 200)),
        rng=rng, tags=tag("NM", "i", struct.pack("<i", 0)) if i % 4 else b"")
        for i in range(n)]
    _write(path, encode_header(()), recs)
    return len(recs)
