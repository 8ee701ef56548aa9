"""Synthetic BAMs of any size with an exact read count.

A unit of records (mapped reads, 80-150 bp unless ``read_len`` says
otherwise, on two contigs with the GRCh38 chr1/chr2 lengths) is encoded
and BGZF-compressed once; the
compressed unit is then byte-repeated. Each repeat starts on a block and a
record boundary, so the file is a valid BAM with exactly
``reps * records_per_unit`` reads, and a multi-GiB file costs one small
compression plus file IO.
"""

from __future__ import annotations

import json
import os
import struct
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
