"""Edge cases for the load path: the record parse, the interval, flag and
tag filters, and the streaming batches with their exact spills.

One set, shared by the CPU tests (the port against the JAX package), the
card tests and ``chip_smoke.py`` (the card against ``device="cpu"``). It
encodes its own records and compresses them with ``synth.py``'s block
compressor, so it needs neither JAX nor the JAX package.

``edge_records(seed)`` gives named record bytes (4-byte length prefix
included), one record per case:

- unmapped records with a position (``ref_id`` 0, ``pos`` 1,500) and
  without one (``ref_id`` -1, ``pos`` -1, no cigar, no sequence);
- one record for each SAM flag bit (``1 << b``, b = 0..15) and one with
  all sixteen set;
- cigars of 0 (unmapped), 1, 64, 65, 66 and 300 ops, mixing every op
  code; 64 ops, 63 of them of 2^28 - 1 reference bases, whose span
  overflows int32 (the device scan wraps it); the spans of more than 64
  ops are finished on the host;
- tags of every value type (``A c C s S i I f Z H`` and ``B`` arrays of
  each element type, including an empty one), and malformed tag regions,
  each between well-formed tags: an unterminated ``Z``, a ``B`` count past
  the region, a ``B`` of unknown element type, an unknown type byte, a
  truncated ``i`` payload, a region ending in two stray bytes;
- ``l_read_name`` 1 (an empty name, which the checker refuses:
  ``emptyReadName``);
- ``mapq`` 255, ``bin`` 0xFFFF, negative ``tlen``, mate fields set;
- positions at the interval edges of ``LOCI``: a record starting at an
  interval's end, one ending at its start, one ending one past it, and
  one spanning an empty range.

``write_bam(path, seed)`` writes them into one BAM on ``CONTIGS``, between
seeded filler reads, and returns its manifest. The file is cut for the
``GEOMETRY`` window and halo (64 KiB, 16 KiB): a record ends exactly at
the first window's end; a run of ``LONG_READS`` reads of ~30 KB outruns
the halo (their starts spill and decode exactly); the last record ends at
the end of the file. The refused record goes first, so no other record's
chain runs through it.

``write_refused_mid_bam(path)`` writes seeded reads with the refused
empty-name record in the middle of the file, where the chains of the
records before it run through it: the checker refuses those starts, the
record path (and so the export) reads them.

``write_seqdoop_trap_bam(path)`` writes seeded reads and one carrier
record whose trailing ``B`` tag holds a whole fake record, a BGZF block
starting exactly at the fake: hadoop-bam's guesser (seqdoop) takes the
fake for a record start (it does not check the name's alphabet), the
checker refuses it (an ``@`` in the name). With the fake's mate fields
set on an unpaired read, hadoop-bam's reader throws ``BamFormatError``
there; without them it reads one record too many.

``LOCI``, ``FLAG_FILTERS`` and ``TAG_FILTERS`` are the filters the tests
and the smoke apply to it: loci with a whole contig, an empty range, a
contig absent from the header and an interval whose end is a record's
start; required and forbidden flags; tags present, absent, and after a
malformed entry.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from spark_bam_tpu_torch.benchmarks.synth import (
    BGZF_EOF,
    compress_block,
    compress_blocks,
    reg2bin,
)

CONTIGS = (("chr1", 1_000_000), ("chr2", 500_000), ("chrM", 16_569))
GEOMETRY = (64 << 10, 16 << 10)
#: Uncompressed bytes per record block; the first window (header block +
#: 7 record blocks) ends exactly at record-stream offset 7 × BLOCK.
BLOCK = 8192
LONG_READS = 6

LOCI = (
    "chr1:1000-2000",
    "chr1:5000-5000",
    "chrM",
    "chrZ:1-100,chr2:100k-200k",
    "chr1:0-1m,chr2,chrM:0-10",
)
FLAG_FILTERS = ((0, 0x4), (0x1, 0), (0x40, 0x400), (0, 0x900))
TAG_FILTERS = (("NM",), ("MD",), ("NM", "MD"), ("XZ",), ("XB",), ("XT",),
               ("ZZ",))

_BASES = np.array([1, 2, 4, 8], dtype=np.uint8)


def tag(name: str, typ: str, payload: bytes) -> bytes:
    return name.encode() + typ.encode() + payload


def encode_record(*, ref_id: int = 0, pos: int = 100, name: bytes = b"r",
                  flag: int = 0, mapq: int = 30, bin_: int | None = None,
                  cigar=((10, 0),), seq_len: int | None = None,
                  rng: np.random.Generator | None = None, tags: bytes = b"",
                  next_ref_id: int = -1, next_pos: int = -1,
                  tlen: int = 0, l_read_name: int | None = None) -> bytes:
    """One BAM record, length prefix included. ``cigar`` holds ``(length,
    op)`` pairs; the sequence defaults to the cigar's query length."""
    if seq_len is None:
        seq_len = sum(n for n, op in cigar if op in (0, 1, 4, 7, 8))
    rng = rng or np.random.default_rng(0)
    codes = rng.choice(_BASES, seq_len)
    if seq_len % 2:
        codes = np.append(codes, np.uint8(0))
    packed = (codes[0::2] << 4) | codes[1::2]
    quals = rng.integers(2, 41, seq_len, dtype=np.uint8)
    name_z = name + b"\x00"
    if bin_ is None:
        bin_ = reg2bin(max(pos, 0), max(pos, 0) + 1)
    body = struct.pack(
        "<iiBBHHHiiii", ref_id, pos,
        len(name_z) if l_read_name is None else l_read_name, mapq, bin_,
        len(cigar), flag, seq_len, next_ref_id, next_pos, tlen,
    ) + name_z + b"".join(struct.pack("<I", (n << 4) | op) for n, op in cigar)
    body += packed.tobytes() + quals.tobytes() + tags
    return struct.pack("<i", len(body)) + body


def tag_regions() -> dict[str, bytes]:
    """Named tag regions: every value type, and malformed entries between
    well-formed ``NM``/``MD`` tags."""
    nm = tag("NM", "i", struct.pack("<i", 3))
    md = tag("MD", "Z", b"10A5\x00")
    every = b"".join([
        tag("XA", "A", b"Q"), tag("Xc", "c", struct.pack("<b", -5)),
        tag("XC", "C", b"\xfe"), tag("Xs", "s", struct.pack("<h", -300)),
        tag("XS", "S", struct.pack("<H", 60000)),
        tag("Xi", "i", struct.pack("<i", -70000)),
        tag("XI", "I", struct.pack("<I", 4_000_000_000)),
        tag("Xf", "f", struct.pack("<f", 1.5)), tag("XZ", "Z", b"text\x00"),
        tag("XH", "H", b"1AE3\x00"),
        *(tag("XB", "B", t.encode() + struct.pack("<i", 3) + b"\x01" * (3 * k))
          for t, k in (("c", 1), ("C", 1), ("s", 2), ("S", 2), ("i", 4),
                       ("I", 4), ("f", 4))),
        tag("Xb", "B", b"i" + struct.pack("<i", 0)),
    ])
    return {
        "tags_none": b"",
        "tags_nm": nm,
        "tags_nm_md": nm + md,
        "tags_every_type": nm + every + md,
        "tags_unterminated_z": nm + tag("XZ", "Z", b"no terminator"),
        "tags_bad_b_count": nm + tag("XB", "B", b"i" + struct.pack(
            "<I", 0x7FFFFFF0)) + md,
        "tags_unknown_b_type": nm + tag("XB", "B", b"q" + struct.pack(
            "<i", 2) + b"\x00" * 8) + md,
        "tags_unknown_type": nm + tag("XU", "Q", b"\x00" * 4) + md,
        "tags_truncated_i": md + tag("XT", "i", b"\x01\x02"),
        "tags_stray_bytes": nm + md + b"XY",
    }


def edge_records(seed: int = 0) -> dict[str, bytes]:
    """Every named edge record (see the module docstring)."""
    rng = np.random.default_rng(seed)
    out: dict[str, bytes] = {}

    def add(case: str, **kw) -> None:
        kw.setdefault("name", case.replace("_", "-").encode())
        out[case] = encode_record(rng=rng, **kw)

    add("empty_name", l_read_name=1, name=b"", cigar=((8, 0),))
    add("unmapped_placed", flag=0x4, pos=1500, cigar=((20, 0),))
    add("unmapped_unplaced", flag=0x4, ref_id=-1, pos=-1, cigar=(),
        seq_len=0, mapq=0, bin_=4680)
    add("unmapped_unplaced_seq", flag=0x4 | 0x1 | 0x80, ref_id=-1, pos=-1,
        cigar=(), seq_len=37, mapq=0)
    for b in range(16):
        add(f"flag_bit_{b}", flag=1 << b, pos=2100 + 10 * b)
    add("flag_all", flag=0xFFFF, pos=2400)
    ops = (0, 1, 2, 3, 4, 5, 6, 7, 8)
    for n in (1, 64, 65, 300):
        cigar = [(int(rng.integers(1, 40)), ops[i % len(ops)])
                 for i in range(n)]
        add(f"cigar_{n}", cigar=cigar, pos=3000 + n)
    add("cigar_64_overflow", cigar=[((1 << 28) - 1, 0)] * 63 + [(5, 4)],
        seq_len=5, pos=3500)
    add("cigar_66_deletions", cigar=[(1000, 2)] * 65 + [(12, 0)], pos=3600)
    for name, region in tag_regions().items():
        add(name, tags=region, pos=4000 + 7 * len(out), cigar=((30, 0),))
    add("mate_fields", mapq=255, bin_=0xFFFF, tlen=-350, next_ref_id=1,
        next_pos=499_000, flag=0x1 | 0x20 | 0x40, pos=4800)
    # Interval edges of LOCI ("chr1:1000-2000", "chr1:5000-5000",
    # "chrM", "chrM:0-10").
    add("at_interval_end", pos=2000, cigar=((50, 0),))
    add("ends_at_interval_start", pos=990, cigar=((10, 0),))
    add("ends_one_past_start", pos=990, cigar=((11, 0),))
    add("spans_empty_range", pos=4990, cigar=((20, 0),))
    add("chrM_last_base", ref_id=2, pos=16_568, cigar=((1, 0),))
    add("chrM_at_length", ref_id=2, pos=16_569, cigar=((1, 0),))
    add("chrM_first", ref_id=2, pos=0, cigar=((10, 0),))
    return out


def _filler(rng: np.random.Generator, i: int, pos: int) -> bytes:
    mapped = rng.random() < 0.85
    n = int(rng.integers(40, 160))
    regions = tag_regions()
    tags = (regions["tags_nm_md"] if i % 3 == 0 else
            regions["tags_nm"] if i % 3 == 1 else b"")
    return encode_record(
        rng=rng, ref_id=int(rng.integers(0, 2)) if mapped else -1,
        pos=pos if mapped else -1, name=b"fill%05d" % i,
        flag=(0 if mapped else 0x4) | int(rng.choice([0, 0x1 | 0x40, 0x400])),
        mapq=int(rng.integers(0, 61)) if mapped else 0,
        cigar=((n, 0),) if mapped else (), seq_len=n, tags=tags,
    )


def _sized(rng: np.random.Generator, size: int) -> bytes:
    """A mapped record of exactly ``size`` bytes (a Z tag pads it)."""
    fixed = 4 + 32 + len(b"exact\x00") + 4
    n = (2 * (size - fixed - 4)) // 3
    while fixed + (n + 1) // 2 + n + 4 > size:
        n -= 1
    pad = size - (fixed + (n + 1) // 2 + n)
    rec = encode_record(rng=rng, name=b"exact", pos=6000, cigar=((n, 0),),
                        tags=tag("XP", "Z", b"p" * (pad - 4) + b"\x00"))
    assert len(rec) == size
    return rec


def write_bam(path, seed: int = 0, fillers: int = 1200) -> dict:
    """The edge records between ``fillers`` seeded reads, with a record
    ending at the first window's end and ``LONG_READS`` long reads; returns
    the manifest: ``starts`` (flat offsets of every record written),
    ``names``, ``refused`` (names the checker refuses) and sizes."""
    rng = np.random.default_rng(seed)
    edges = list(edge_records(seed).items())
    header = _header()
    stream = bytearray()
    starts: list[int] = []
    names: list[str] = []
    target = 7 * BLOCK   # the first window's end, in the record stream
    pos = 10_000

    def put(name: str, rec: bytes) -> None:
        # Every record up to the first window's end stays 200 bytes short
        # of it, until one sized record closes the gap exactly.
        if len(stream) < target and len(stream) + len(rec) > target - 200:
            starts.append(len(header) + len(stream))
            names.append("ends_at_window_end")
            stream.extend(_sized(rng, target - len(stream)))
        starts.append(len(header) + len(stream))
        names.append(name)
        stream.extend(rec)

    put(*edges[0])                      # the refused record first
    every = max(1, fillers // len(edges))
    e = 1
    for i in range(fillers):
        put(f"fill{i}", _filler(rng, i, pos))
        pos += int(rng.integers(1, 200))
        if i % every == every - 1 and e < len(edges):
            put(*edges[e])
            e += 1
        if i == fillers // 2:
            for k in range(LONG_READS):
                n = int(rng.integers(18_000, 22_000))
                put(f"long{k}", encode_record(
                    rng=rng, name=b"long%d" % k, pos=pos, cigar=((n, 0),)))
    for name, rec in edges[e:]:
        put(name, rec)
    assert len(header) + target in starts
    blob = compress_blocks(header) + b"".join(
        compress_block(bytes(stream[i: i + BLOCK]))
        for i in range(0, len(stream), BLOCK)) + BGZF_EOF
    Path(path).write_bytes(blob)
    return {
        "starts": np.array(starts, dtype=np.int64), "names": names,
        "refused": ["empty_name"], "records": len(starts),
        "header_bytes": len(header),
        "uncompressed_bytes": len(header) + len(stream),
    }


def write_refused_mid_bam(path, fillers: int = 600, seed: int = 5,
                          after: int = 300) -> dict:
    """``fillers`` seeded reads at positions 10,000 + 50·i with the refused
    empty-name record written after filler ``after`` (the 301st), in
    ``BLOCK``-byte blocks: the checker refuses every start whose chain of
    ``reads_to_check`` records reaches the empty name, while the record
    path reads through it. Returns the manifest (``starts``, ``names``,
    ``records``)."""
    rng = np.random.default_rng(seed)
    header = _header()
    stream = bytearray()
    starts: list[int] = []
    names: list[str] = []

    def put(name: str, rec: bytes) -> None:
        starts.append(len(header) + len(stream))
        names.append(name)
        stream.extend(rec)

    for i in range(fillers):
        put(f"fill{i:05d}", _filler(rng, i, 10_000 + 50 * i))
        if i == after:
            put("", edge_records(0)["empty_name"])
    blob = compress_blocks(header) + b"".join(
        compress_block(bytes(stream[i: i + BLOCK]))
        for i in range(0, len(stream), BLOCK)) + BGZF_EOF
    Path(path).write_bytes(blob)
    return {"starts": np.array(starts, dtype=np.int64), "names": names,
            "records": len(starts)}


def write_seqdoop_trap_bam(path, fillers: int = 400, seed: int = 7,
                           after: int = 200, mate_set: bool = True) -> dict:
    """``fillers`` seeded reads with the carrier of a fake record written
    after filler ``after``, the block holding the fake starting at its
    first byte. Returns the manifest: ``records`` (the real ones) and
    ``trap_block`` (that block's compressed offset)."""
    rng = np.random.default_rng(seed)
    header = _header()
    fake = encode_record(rng=rng, name=b"fa@ke", pos=123_456,
                         cigar=((50, 0),), flag=0,
                         next_ref_id=0 if mate_set else -1,
                         next_pos=99 if mate_set else -1)
    carrier = encode_record(
        rng=rng, name=b"carrier", pos=30_000, cigar=((60, 0),),
        tags=tag("XB", "B", b"C" + struct.pack("<i", len(fake)) + fake))
    stream = bytearray()
    records = 0
    for i in range(fillers):
        stream.extend(_filler(rng, i, 10_000 + 50 * i))
        records += 1
        if i == after:
            stream.extend(carrier)
            records += 1
            trap = len(stream) - len(fake)
    cuts = sorted({*range(0, len(stream), BLOCK), trap}) + [len(stream)]
    blob = bytearray(compress_blocks(header))
    trap_block = None
    for lo, hi in zip(cuts, cuts[1:]):
        if lo == trap:
            trap_block = len(blob)
        blob += compress_block(bytes(stream[lo:hi]))
    Path(path).write_bytes(bytes(blob) + BGZF_EOF)
    return {"records": records, "trap_block": trap_block}


def _header() -> bytes:
    text = ("@HD\tVN:1.6\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{ln}\n" for name, ln in CONTIGS)).encode()
    out = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text)
    out += struct.pack("<i", len(CONTIGS))
    for name, ln in CONTIGS:
        nb = name.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return bytes(out)
