"""Synthetic BAMs of any size with an exact read count.

A unit of records (mapped reads, 80-150 bp unless ``read_len`` says
otherwise, on two contigs with the GRCh38 chr1/chr2 lengths) is encoded
and BGZF-compressed once; the
compressed unit is then byte-repeated. Each repeat starts on a block and a
record boundary, so the file is a valid BAM with exactly
``reps * records_per_unit`` reads, and a multi-GiB file costs one small
compression plus file IO.

The reference's benchmark inputs (``spark_bam_tpu/benchmarks/synth.py``,
the same bytes for the same arguments): ``synthetic_fixture`` (a 2,500-read
seed BAM written by the package's own encoder), ``ensure_big_bam`` (that
fixture's record region compressed once and repeated, cached under
``cache_dir``), ``synth_longread_bam`` and ``ensure_longread_bam``
(PacBio-class reads, each repeat with one record longer than the 4 MiB
halo). ``cache_dir`` defaults to ``spark_bam_bench`` under the
temporary directory (``TMPDIR``).
"""

from __future__ import annotations

import json
import os
import struct
import tempfile
import zlib
from pathlib import Path

import numpy as np

#: Standard 28-byte BGZF EOF sentinel block.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
#: Uncompressed bytes per block (keeps BSIZE inside its u16 field).
BLOCK_PAYLOAD = 0xFF00
CONTIGS = (("chr1", 248_956_422), ("chr2", 242_193_529))


def compress_block(payload: bytes, level: int = 6) -> bytes:
    """One BGZF block: gzip header with the BC subfield, raw DEFLATE,
    CRC32 and ISIZE. Falls back to a stored block when DEFLATE would
    overflow the u16 BSIZE."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    if len(comp) + 26 > 1 << 16:
        co = zlib.compressobj(0, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 25
    header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
              + struct.pack("<H", bsize))
    return header + comp + struct.pack(
        "<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))


def compress_blocks(data: bytes, level: int = 6) -> bytes:
    return b"".join(compress_block(data[i: i + BLOCK_PAYLOAD], level)
                    for i in range(0, len(data), BLOCK_PAYLOAD))


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning index of [beg, end) (SAM spec 5.3)."""
    end -= 1
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


def encode_header(contigs=CONTIGS) -> bytes:
    text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{ln}\n" for name, ln in contigs)).encode()
    out = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text)
    out += struct.pack("<i", len(contigs))
    for name, ln in contigs:
        nb = name.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return bytes(out)


def encode_record(ref_id: int, pos: int, name: bytes, seq_codes: np.ndarray,
                  quals: np.ndarray, mapq: int = 60, flag: int = 0) -> bytes:
    """One mapped BAM record with a single ``M`` cigar op. ``seq_codes``
    are 4-bit base codes (1=A 2=C 4=G 8=T)."""
    l_seq = len(seq_codes)
    codes = seq_codes.astype(np.uint8)
    if l_seq % 2:
        codes = np.append(codes, np.uint8(0))
    packed = (codes[0::2] << 4) | codes[1::2]
    l_name = len(name) + 1
    body = struct.pack(
        "<iiBBHHHiiii", ref_id, pos, l_name, mapq,
        reg2bin(pos, pos + l_seq), 1, flag, l_seq, -1, -1, 0,
    ) + name + b"\x00" + struct.pack("<I", (l_seq << 4) | 0) \
        + packed.tobytes() + quals.astype(np.uint8).tobytes()
    return struct.pack("<i", len(body)) + body


def record_unit(seed: int, reads: int, read_len=(80, 151)) -> bytes:
    """``reads`` coordinate-sorted records split over the two contigs, of
    ``read_len`` = [lo, hi) bases each."""
    rng = np.random.default_rng(seed)
    out = []
    per_contig = -(-reads // len(CONTIGS))
    i = 0
    for ref_id in range(len(CONTIGS)):
        pos = 0
        for _ in range(min(per_contig, reads - i)):
            pos += int(rng.integers(1, 400))
            n = int(rng.integers(*read_len))
            seq = rng.choice(np.array([1, 2, 4, 8], np.uint8), n)
            quals = rng.integers(2, 41, n)
            out.append(encode_record(ref_id, pos, b"syn%08d" % i, seq, quals,
                                     mapq=int(rng.integers(1, 60))))
            i += 1
    return b"".join(out)


def synth_bam(out_path, min_uncompressed: int, seed: int = 0,
              unit_reads: int = 16384, level: int = 6,
              read_len=(80, 151)) -> dict:
    """Write a BAM of at least ``min_uncompressed`` uncompressed bytes with
    reads of ``read_len`` = [lo, hi) bases (e.g. ``(60_000, 110_000)`` for
    long reads); returns its manifest (reads, reps, sizes), also written
    beside it."""
    out_path = Path(out_path)
    hdr = encode_header()
    unit = record_unit(seed, unit_reads, read_len)
    hdr_blob = compress_blocks(hdr, level)
    unit_blob = compress_blocks(unit, level)
    reps = max(1, -(-(min_uncompressed - len(hdr)) // len(unit)))
    tmp = out_path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(hdr_blob)
        for _ in range(reps):
            f.write(unit_blob)
        f.write(BGZF_EOF)
    os.replace(tmp, out_path)
    manifest = {
        "reads": reps * unit_reads,
        "reps": reps,
        "unit_reads": unit_reads,
        "compressed_bytes": out_path.stat().st_size,
        "uncompressed_bytes": len(hdr) + reps * len(unit),
        "seed": seed,
        "level": level,
        "read_len": list(read_len),
    }
    out_path.with_suffix(".manifest.json").write_text(json.dumps(manifest))
    return manifest


def record_positions(manifest: dict) -> list[int]:
    """The positions of a ``synth_bam`` file's records, in file order,
    rebuilt from its manifest."""
    unit = record_unit(manifest["seed"], manifest["unit_reads"],
                       tuple(manifest["read_len"]))
    pos, off = [], 0
    while off < len(unit):
        size, _, p = struct.unpack_from("<iii", unit, off)
        pos.append(p)
        off += 4 + size
    return pos * manifest["reps"]


def record_flat_starts(manifest: dict) -> np.ndarray:
    """The flat (uncompressed) offsets of a ``synth_bam`` file's records,
    in file order, rebuilt from its manifest (int64)."""
    unit = record_unit(manifest["seed"], manifest["unit_reads"],
                       tuple(manifest["read_len"]))
    offs, off = [], 0
    while off < len(unit):
        offs.append(off)
        off += 4 + struct.unpack_from("<i", unit, off)[0]
    reps = np.arange(manifest["reps"], dtype=np.int64)[:, None] * len(unit)
    return (len(encode_header()) + reps
            + np.array(offs, dtype=np.int64)[None, :]).ravel()


# ------------------------------------------------- the reference's inputs

#: Reads in ``synthetic_fixture``'s default BAM.
FIXTURE_READS = 2500


def _cache_dir(cache_dir) -> Path:
    out = (Path(tempfile.gettempdir()) / "spark_bam_bench"
           if cache_dir is None else Path(cache_dir))
    out.mkdir(parents=True, exist_ok=True)
    return out


def synthetic_fixture(cache_dir=None, reads: int = FIXTURE_READS) -> Path:
    """The reference's in-package seed BAM: ``reads`` coordinate-sorted
    mapped reads (80-150 bp) over two contigs, written by the package's own
    encoder (``bam/writer.py::write_bam``, host zlib); cached in
    ``cache_dir``."""
    out = _cache_dir(cache_dir) / f"synthetic_fixture_{reads}.bam"
    if out.exists():
        return out
    import random

    from spark_bam_tpu_torch.bam.header import BamHeader
    from spark_bam_tpu_torch.bam.record import BamRecord
    from spark_bam_tpu_torch.bam.writer import write_bam

    rng = random.Random(0x5BA17)
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{length}\n" for name, length in CONTIGS)
    header = BamHeader(tuple(name for name, _ in CONTIGS),
                       np.array([ln for _, ln in CONTIGS], dtype=np.int32),
                       0, text=text)

    def records():
        per_contig = -(-reads // len(CONTIGS))
        i = 0
        for ref_id in range(len(CONTIGS)):
            pos = 0
            for _ in range(per_contig):
                if i >= reads:
                    return
                pos += rng.randrange(1, 400)
                read_len = rng.randrange(80, 151)
                yield BamRecord(
                    ref_id=ref_id, pos=pos, mapq=rng.randrange(1, 60),
                    bin=0, flag=0, next_ref_id=-1, next_pos=-1, tlen=0,
                    read_name=f"syn{i:06d}", cigar=[(read_len, 0)],
                    seq="".join(rng.choices("ACGT", k=read_len)),
                    qual=bytes(rng.randrange(2, 41)
                               for _ in range(read_len)))
                i += 1

    tmp = out.with_suffix(".tmp")
    write_bam(tmp, header, records())
    os.replace(tmp, out)
    return out


def _count_records(rec_bytes: memoryview) -> int:
    """Records in a flat record region (its length prefixes walked)."""
    n, off, total = 0, 0, len(rec_bytes)
    while off + 4 <= total:
        (size,) = struct.unpack_from("<i", rec_bytes, off)
        off += 4 + size
        n += 1
    if off != total:
        raise ValueError("record region does not end on a record boundary")
    return n


def _synth_fixture_bam(out_path, target_bytes: int, fixture=None,
                       level: int = 1) -> dict:
    """The reference's ``synth_bam``: a BAM of at least ``target_bytes``
    compressed bytes whose body is ``fixture``'s record region compressed
    once and repeated (``fixture`` None or missing: ``synthetic_fixture``).
    Returns the manifest, also written beside the file."""
    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.bgzf.flat import flatten_file

    out_path = Path(out_path)
    if fixture is None or not Path(fixture).exists():
        fixture = synthetic_fixture()
    flat = flatten_file(fixture)
    split = read_header(fixture).uncompressed_size
    rec_bytes = flat.data[split:].tobytes()
    reads_per_rep = _count_records(memoryview(rec_bytes))
    hdr_blob = compress_blocks(flat.data[:split].tobytes(), level)
    rec_blob = compress_blocks(rec_bytes, level)
    body = max(target_bytes - len(hdr_blob) - len(BGZF_EOF), len(rec_blob))
    reps = -(-body // len(rec_blob))
    tmp = out_path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(hdr_blob)
        for _ in range(reps):
            f.write(rec_blob)
        f.write(BGZF_EOF)
    os.replace(tmp, out_path)
    manifest = {
        "fixture": str(fixture),
        "reps": reps,
        "reads": reps * reads_per_rep,
        "compressed_bytes": out_path.stat().st_size,
        "uncompressed_bytes": split + reps * (flat.size - split),
        "level": level,
    }
    out_path.with_suffix(".manifest.json").write_text(json.dumps(manifest))
    return manifest


def ensure_big_bam(target_bytes: int = 1 << 30, cache_dir=None,
                   fixture=None) -> tuple[Path, dict]:
    """The reference's benchmark BAM of at least ``target_bytes``
    compressed bytes, built once into ``cache_dir`` and reused while its
    manifest matches the file."""
    out = _cache_dir(cache_dir) / f"big_{target_bytes >> 20}mb.bam"
    mf = out.with_suffix(".manifest.json")
    if out.exists() and mf.exists():
        manifest = json.loads(mf.read_text())
        if manifest.get("compressed_bytes") == out.stat().st_size:
            return out, manifest
    return out, _synth_fixture_bam(out, target_bytes, fixture)


#: The GRCh38 chr1 length: the long reads' coordinate range.
LONGREAD_CONTIG = ("chr1", 248_956_422)


def _encode_longread(name: bytes, pos: int, seq_len: int, rng) -> bytes:
    """One mapped record of a ``seq_len``-base read, its bases and
    qualities drawn by numpy (incompressible, as PacBio data is)."""
    n_name = len(name) + 1
    seq_bytes = (seq_len + 1) // 2
    remaining = 32 + n_name + 4 + seq_bytes + seq_len
    head = struct.pack("<iiiBBHHHiiii", remaining, 0, pos, n_name, 40,
                       reg2bin(pos, pos + seq_len), 1, 0, seq_len, -1, -1, 0)
    cigar = struct.pack("<I", (seq_len << 4) | 0)
    nibbles = rng.integers(0x11, 0x88, seq_bytes, dtype=np.uint8).tobytes()
    quals = rng.integers(5, 40, seq_len, dtype=np.uint8).tobytes()
    return head + name + b"\x00" + cigar + nibbles + quals


def synth_longread_bam(out_path, target_bytes: int, seed: int = 0,
                       read_lens: tuple[int, int] = (80_000, 400_000),
                       reads_per_rep: int = 12,
                       ultra_seq_len: int = 3_000_000,
                       level: int = 1) -> dict:
    """The reference's long-read BAM of at least ``target_bytes``
    compressed bytes: ``reads_per_rep`` reads of ``read_lens`` bases and
    one *ultra* read of ``ultra_seq_len`` bases (its record ~1.5x that many
    bytes, past the 4 MiB halo) a repeat, the unit compressed once and
    repeated. Returns the manifest, also written beside the file."""
    out_path = Path(out_path)
    rng = np.random.default_rng(seed)
    name, ln = LONGREAD_CONTIG
    sam = f"@HD\tVN:1.6\n@SQ\tSN:{name}\tLN:{ln}\n"
    header_blob = (b"BAM\x01" + struct.pack("<i", len(sam)) + sam.encode()
                   + struct.pack("<i", 1) + struct.pack("<i", len(name) + 1)
                   + name.encode() + b"\x00" + struct.pack("<i", ln))
    recs = []
    pos = 1000
    for i in range(reads_per_rep):
        seq_len = int(rng.integers(*read_lens))
        recs.append(_encode_longread(b"lr_%d" % i, pos, seq_len, rng))
        pos += int(rng.integers(1_000, 50_000))
    recs.append(_encode_longread(b"lr_ultra", pos, ultra_seq_len, rng))
    unit = b"".join(recs)
    hdr_blob = compress_blocks(header_blob, level)
    unit_blob = compress_blocks(unit, level)
    body = max(target_bytes - len(hdr_blob) - len(BGZF_EOF), len(unit_blob))
    reps = -(-body // len(unit_blob))
    tmp = out_path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(hdr_blob)
        for _ in range(reps):
            f.write(unit_blob)
        f.write(BGZF_EOF)
    os.replace(tmp, out_path)
    manifest = {
        "kind": "longread",
        "reps": reps,
        "reads": reps * (reads_per_rep + 1),
        "ultra_reads": reps,
        "ultra_record_bytes": len(recs[-1]),
        "compressed_bytes": out_path.stat().st_size,
        "uncompressed_bytes": len(header_blob) + reps * len(unit),
        "level": level,
        "seed": seed,
    }
    out_path.with_suffix(".manifest.json").write_text(json.dumps(manifest))
    return manifest


def ensure_longread_bam(target_bytes: int = 256 << 20, cache_dir=None,
                        **kw) -> tuple[Path, dict]:
    """The long-read BAM of at least ``target_bytes`` compressed bytes,
    built once into ``cache_dir`` and reused while its manifest matches."""
    out = _cache_dir(cache_dir) / f"longread_{target_bytes >> 20}mb.bam"
    mf = out.with_suffix(".manifest.json")
    if out.exists() and mf.exists():
        manifest = json.loads(mf.read_text())
        if (manifest.get("kind") == "longread"
                and manifest.get("compressed_bytes") == out.stat().st_size):
            return out, manifest
    return out, synth_longread_bam(out, target_bytes, **kw)
