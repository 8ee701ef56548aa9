"""Structure-aware mutation fuzzing of the decode boundary (reference
``spark_bam_tpu/tools/fuzz_decode.py``), over the port's writers and
decoders.

Small pristine corpora (a BAM, its BGZF blocks, its ``.sbi`` index) come
from the port's own writers; each mutant changes one structural field (a
length prefix, a count, a magic, a size) or cuts the bytes short, and each
is decoded under the contract:

1. no hang: a parse finishes within ``TIME_LIMIT_S``;
2. no allocation blow-up: the traced host peak stays under
   ``FUZZ_LIMITS.alloc_budget``;
3. a typed failure: strict mode parses clean or raises one of
   ``TYPED_ERRORS``; tolerant mode may also quarantine and resume.

Anything else is a violation. The mutants, the per-mutant outcomes and the
``counts`` for a seed equal the reference's (the same splitmix64 stream,
the same corpora byte for byte, the reference's exception class names).
The formats are ``bam``, ``bgzf``, ``cram`` and ``sbi``. The CRAM corpus
comes from the port's ``CramWriter`` and is decoded by its ``CramReader``
(rANS blocks by the native decoder), on the host, as the reference's.

The BAM consumer is the reference's: ``load_reads_and_positions`` at the
default split size, whose one split starts at the header's end (the BAM
corpus is one data block), so it resolves nothing on the device. So that
hostile bytes reach the device's boundary resolution, every BAM mutant is
also probed: its first record start is searched from its first block's
offset 0 by ``load/boundary.py::next_read_start``, whose ``check_window``
launches ``prefilter_check_flags`` on a CUDA device, where the reference's
eager checker (``next_read_start(Pos(0, 0))``) gives the same position. A
probe may resolve or raise a typed error; anything else, a CUDA error
included, is a violation (no error is caught and classed typed unless its
class is in ``TYPED_ERRORS``). On a CUDA device the kernels are warmed on the pristine
BAM first, and the campaign's peak device memory
(``torch.cuda.max_memory_allocated``, which ``tracemalloc`` cannot see)
and the kernels' launches are logged in the summary's ``device`` entry.

``python -m spark_bam_tpu_torch fuzz-decode --seed N --mutants M
--formats bam,bgzf,cram,sbi [-o OUT] [--device DEV]`` runs a campaign and
exits 1 on a violation.
"""

from __future__ import annotations

import struct
import tempfile
import time
import tracemalloc
import zlib
from pathlib import Path

import numpy as np

from spark_bam_tpu_torch.bam.header import BamHeader, read_header
from spark_bam_tpu_torch.bam.iterators import RecordStream
from spark_bam_tpu_torch.bam.record import BamRecord
from spark_bam_tpu_torch.bam.writer import BGZF_EOF, compress_block, encode_bam_header
from spark_bam_tpu_torch.bgzf.find_block_start import HeaderSearchFailedException
from spark_bam_tpu_torch.bgzf.index_blocks import scan_blocks
from spark_bam_tpu_torch.bgzf.stream import BlockStream
from spark_bam_tpu_torch.check.checker import NoReadFoundException
from spark_bam_tpu_torch.core import guard
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.faults import (
    BlockCorruptionError,
    BlockGapError,
    ShortReadError,
)
from spark_bam_tpu_torch.core.guard import (
    DecodeLimits,
    MalformedInputError,
    scoped_limits,
)
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.cram.reader import CramReader
from spark_bam_tpu_torch.cram.writer import CramWriter
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.sbi.format import (
    PLAN_POS,
    PlanEntry,
    SbiIndex,
    decode_sbi,
    encode_sbi,
    fingerprint_of,
)

FORMATS = ("bam", "bgzf", "cram", "sbi")

#: The typed outcomes a strict parse of hostile bytes may end in.
TYPED_ERRORS = (
    MalformedInputError,
    BlockCorruptionError,
    ShortReadError,
    BlockGapError,
    EOFError,
    NoReadFoundException,
    HeaderSearchFailedException,
)

#: Per-mutant budgets: a healthy parse of these few-KiB corpora takes
#: milliseconds and a few hundred KiB.
TIME_LIMIT_S = 5.0
FUZZ_LIMITS = DecodeLimits(alloc_budget=64 << 20)

_M64 = (1 << 64) - 1


class _Rng:
    """splitmix64, as ``core/faults.py`` mixes: a campaign replays from
    its seed alone."""

    def __init__(self, seed: int):
        self.s = seed & _M64

    def next(self) -> int:
        self.s = (self.s + 0x9E3779B97F4A7C15) & _M64
        z = self.s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        return (z ^ (z >> 31)) & _M64

    def below(self, n: int) -> int:
        return self.next() % n

    def choice(self, seq):
        return seq[self.below(len(seq))]


# ------------------------------------------------------------- mutations
#: Adversarial i32 values: sign flips, the edges of the minimum record
#: body (33) and allocation-sized extremes.
_I32_POISON = (-1, -2, 0, 1, 32, 33, -(1 << 31), (1 << 31) - 1, 1 << 30)


def _mutate(data: bytes, off: int, rng: _Rng) -> bytes:
    """One structural mutation at ``off``."""
    buf = bytearray(data)
    op = rng.below(5)
    if op == 0 and off + 4 <= len(buf):
        struct.pack_into("<i", buf, off, rng.choice(_I32_POISON))
    elif op == 1:
        buf[off] ^= 1 << rng.below(8)
    elif op == 2:
        buf[off] = rng.choice((0, 0x80, 0xFF))
    elif op == 3:
        return bytes(buf[: max(off, 1)])  # cut mid-structure
    elif off + 2 <= len(buf):
        struct.pack_into("<H", buf, off, 0xFFFF)
    else:
        buf[off] ^= 0xFF
    return bytes(buf)


# --------------------------------------------------------------- corpora
_SAM_TEXT = "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:100000\n@SQ\tSN:chr2\tLN:50000\n"


def _base_records(n: int = 24) -> list[BamRecord]:
    return [
        BamRecord(i % 2, 100 + 50 * i, 30, 0, 16 if i % 3 == 0 else 0,
                  -1, -1, 0, f"read{i:03d}", [(32, 0)], "ACGT" * 8,
                  b"I" * 32, b"")
        for i in range(n)
    ]


def _bam_uncompressed() -> tuple[bytes, list[int]]:
    """The uncompressed BAM stream and every structural field offset."""
    header = BamHeader(("chr1", "chr2"),
                       np.array([100_000, 50_000], dtype=np.int32), 0,
                       Pos(0, 0), _SAM_TEXT)
    blob = bytearray(encode_bam_header(header))
    offsets = [0, 4]  # magic, l_text
    (text_len,) = struct.unpack_from("<i", blob, 4)
    o = 8 + text_len
    offsets.append(o)  # n_ref
    (n_ref,) = struct.unpack_from("<i", blob, o)
    o += 4
    for _ in range(n_ref):
        offsets.append(o)  # l_name
        (l_name,) = struct.unpack_from("<i", blob, o)
        o += 4 + l_name
        offsets.append(o)  # l_ref
        o += 4
    # The fixed fields of each record (block_size .. tlen).
    fixed = (0, 4, 8, 12, 13, 14, 16, 18, 20, 24, 28, 32)
    for rec in _base_records():
        start = len(blob)
        offsets.extend(start + d for d in fixed)
        blob += rec.encode()
    return bytes(blob), offsets


def _bgzf_compress(payload: bytes, chunk: int = 4096
                   ) -> tuple[bytes, list[int]]:
    """``payload`` in BGZF blocks of ``chunk`` bytes, and each block's
    start (the EOF block's too)."""
    out = bytearray()
    starts = []
    for i in range(0, len(payload), chunk):
        starts.append(len(out))
        out += compress_block(payload[i: i + chunk])
    starts.append(len(out))
    out += BGZF_EOF
    return bytes(out), starts


def _cram_corpus(tmp: Path) -> tuple[bytes, list[int]]:
    path = tmp / "base.cram"
    with CramWriter(path, [("chr1", 100_000)],
                    sam_text="@SQ\tSN:chr1\tLN:100000\n",
                    records_per_container=8, index=False) as w:
        for i in range(16):
            w.write(BamRecord(0, 100 + 10 * i, 30, 0, 0, -1, -1, 0, f"q{i}",
                              [(20, 0)], "ACGTACGTACGTACGTACGT", b"I" * 20,
                              b""))
    data = path.read_bytes()
    # Structural hot spots: the file definition, the SAM header's
    # container, and the first 32 bytes of every data container (its
    # header's itf8 fields and its first block headers).
    offsets = list(range(0, min(64, len(data))))
    with CramReader(path) as r:
        for info in r.container_infos():
            offsets.extend(range(info.offset,
                                 min(info.offset + 32, len(data))))
    return data, sorted(set(offsets))


def _sbi_corpus(bam_path: Path) -> tuple[bytes, list[int]]:
    fp = fingerprint_of(bam_path, Config())
    blocks = scan_blocks(bam_path)
    with open_channel(bam_path) as ch:
        stream = RecordStream.open(ch)
        starts = np.array([pos.to_htsjdk() for pos, _ in stream],
                          dtype=np.uint64)
    index = SbiIndex(
        fp, blocks=blocks,
        split_plans={65536: [PlanEntry(0, PLAN_POS, Pos(0, 0))]},
        record_starts=starts,
    )
    data = encode_sbi(index)
    # The fixed header fields, then the section table (tag, payload
    # length and each payload's leading count).
    hdr_end = 4 + 2 + 2 + 24
    offsets = [0, 4, 6, 8, 16, 24, 28, hdr_end]
    (n_sections,) = struct.unpack_from("<I", data, hdr_end)
    o = hdr_end + 4
    for _ in range(n_sections):
        offsets.extend((o, o + 4, o + 12))
        (payload_len,) = struct.unpack_from("<Q", data, o + 4)
        o += 12 + payload_len
    return data, offsets


# -------------------------------------------------------------- consumers
def _consume_bam(path, tolerant: bool, device) -> int:
    from spark_bam_tpu_torch.load.api import load_reads_and_positions

    spec = "retries=0" + (",mode=tolerant" if tolerant else "")
    ds = load_reads_and_positions(str(path), config=Config(faults=spec),
                                  device=device)
    n = 0
    for split in ds.partitions:
        for _ in ds.compute(split):
            n += 1
    return n


def _consume_bgzf(path, tolerant: bool, device) -> int:
    stream = BlockStream(open_channel(str(path)), tolerant=tolerant)
    n = 0
    try:
        while True:
            try:
                if stream.next_block() is None:
                    return n
                n += 1
            except BlockGapError as gap:
                if not tolerant:
                    raise
                if gap.resync is None:
                    return n
                # The stream already stands at the resync point.
    finally:
        stream.close()


def _consume_cram(path, tolerant: bool, device) -> int:
    with CramReader(str(path)) as r:
        return sum(1 for _ in r.records())


def _consume_sbi(path, tolerant: bool, device) -> int:
    index = decode_sbi(Path(path).read_bytes())
    n = len(index.blocks or [])
    if index.record_starts is not None:
        n += int(index.record_starts.size)
    return n


def probe_record_start(path, device) -> "tuple[int, int] | None":
    """The first record start of ``path`` from its offset 0, searched on
    ``device`` (``load/boundary.py::next_read_start``); None at a clean
    EOF."""
    from spark_bam_tpu_torch.load.boundary import next_read_start

    config = Config()
    pos = next_read_start(str(path), 0, read_header(path), config, device)
    return None if pos is None else (pos.block_pos, pos.offset)


# ----------------------------------------------------------------- engine
def _repro(seed: int, fmt: str, mutants: int) -> str:
    return (f"python -m spark_bam_tpu_torch fuzz-decode --seed {seed} "
            f"--mutants {mutants} --formats {fmt}")


def run_case(consume, path, tolerant: bool, device) -> dict:
    """One consumer under the fuzz budgets; its classified outcome."""
    rec0, blk0 = guard.loss_totals()
    tracemalloc.start()
    t0 = time.monotonic()
    outcome, detail = "clean", ""
    try:
        with scoped_limits(FUZZ_LIMITS):
            consume(path, tolerant, device)
    except TYPED_ERRORS as e:
        outcome, detail = f"malformed:{type(e).__name__}", str(e)[:200]
    except Exception as e:  # the contract breach the fuzz hunts
        outcome, detail = "untyped", f"{type(e).__name__}: {e}"[:300]
    elapsed = time.monotonic() - t0
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    rec1, blk1 = guard.loss_totals()
    if outcome == "clean" and (rec1 > rec0 or blk1 > blk0):
        outcome = "quarantined"
        detail = f"lost {rec1 - rec0} records, {blk1 - blk0} blocks"
    return {"outcome": outcome, "detail": detail,
            "elapsed_s": round(elapsed, 3), "peak_bytes": peak}


def run_probe(path, device) -> dict:
    """The device boundary probe of one BAM mutant, classified as a
    case is (``clean`` when the search found a start or a clean EOF)."""
    return run_case(lambda p, _t, d: probe_record_start(p, d), path, False,
                    device)


def mutants_for(fmt: str, tmp: Path, rng: _Rng, count: int):
    """``count`` mutated byte strings of one format."""
    if fmt == "bam":
        payload, offsets = _bam_uncompressed()
        for _ in range(count):
            off = rng.choice(offsets) if rng.below(4) else rng.below(len(payload))
            yield _bgzf_compress(_mutate(payload, off, rng))[0]
    elif fmt == "bgzf":
        payload, _ = _bam_uncompressed()
        comp, starts = _bgzf_compress(payload)
        offsets = []
        for i, s in enumerate(starts):
            # Block header fields (magic, FLG, XLEN, BC subfield, BSIZE)
            # and the previous block's CRC32 and ISIZE.
            offsets.extend(s + d for d in (0, 1, 3, 10, 12, 16, 17)
                           if s + d < len(comp))
            if i > 0:
                offsets.extend((s - 8, s - 4))
        for _ in range(count):
            off = rng.choice(offsets) if rng.below(4) else rng.below(len(comp))
            yield _mutate(comp, off, rng)
    elif fmt == "cram":
        data, offsets = _cram_corpus(tmp)
        for _ in range(count):
            off = rng.choice(offsets) if rng.below(4) else rng.below(len(data))
            yield _mutate(data, off, rng)
    elif fmt == "sbi":
        data, offsets = _sbi_corpus(tmp / "base.bam")
        body = data[:-4]
        for _ in range(count):
            off = rng.choice(offsets) if rng.below(4) else rng.below(len(body))
            mutated = _mutate(body, off, rng)
            if rng.below(4) == 0:
                # A stale trailer: the CRC gate itself.
                yield mutated + data[-4:]
            else:
                # A fixed trailer, so the mutation reaches the counts.
                yield mutated + struct.pack("<I", zlib.crc32(mutated) & 0xFFFFFFFF)
    else:
        check_formats((fmt,))


_CONSUMERS = {
    "bam": (_consume_bam, True),   # (consumer, has a tolerant mode)
    "bgzf": (_consume_bgzf, True),
    "cram": (_consume_cram, False),
    "sbi": (_consume_sbi, False),
}


def check_formats(formats) -> None:
    """Raise ``ValueError`` naming any format this port does not fuzz."""
    bad = [f for f in formats if f not in _CONSUMERS]
    if bad:
        raise ValueError(
            f"unknown fuzz format(s) {', '.join(bad)}: this port fuzzes "
            f"{', '.join(FORMATS)}")


def rng_for(seed: int, fmt: str) -> _Rng:
    return _Rng((seed << 16) ^ zlib.crc32(fmt.encode()))


def base_bam_bytes() -> bytes:
    return _bgzf_compress(_bam_uncompressed()[0])[0]


def run_fuzz(seed: int = 0, mutants_per_format: int = 200,
             formats: tuple = FORMATS, device=None) -> dict:
    """A campaign on ``device`` (CUDA unless named); its JSON-able
    summary, whose ``violations`` is empty iff every mutant kept the
    contract. ``counts`` (strict outcomes per format) is the reference's;
    ``probes`` counts the device boundary probe's outcomes of the BAM
    mutants, and on a CUDA device ``device`` holds the campaign's peak
    device memory (above what was live at its start) and the kernels'
    launches over the campaign."""
    check_formats(formats)
    dev = resolve_device(device)
    summary: dict = {
        "seed": seed,
        "mutants_per_format": mutants_per_format,
        "formats": list(formats),
        "counts": {},
        "violations": [],
    }
    launches0 = None
    with tempfile.TemporaryDirectory(prefix="sbt-fuzz-") as d:
        tmp = Path(d)
        (tmp / "base.bam").write_bytes(base_bam_bytes())
        if dev.type == "cuda":
            import torch

            from spark_bam_tpu_torch.tpu import kernels

            # The first launch in a process builds and loads the kernels
            # (hundreds of ms): pay it on the pristine BAM, not a mutant.
            probe_record_start(tmp / "base.bam", dev)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            live0 = torch.cuda.memory_allocated(dev)
            launches0 = dict(kernels.LAUNCHES)
        t0 = time.monotonic()
        n_cases = 0
        for fmt in formats:
            consume, has_tolerant = _CONSUMERS[fmt]
            counts: dict = {}
            probes: dict = {}
            for idx, mutant in enumerate(mutants_for(
                    fmt, tmp, rng_for(seed, fmt), mutants_per_format)):
                path = tmp / f"mutant.{fmt}"
                path.write_bytes(mutant)
                runs = [("strict", run_case(consume, path, False, dev))]
                if has_tolerant:
                    runs.append(("tolerant", run_case(consume, path, True,
                                                      dev)))
                if fmt == "bam":
                    runs.append(("probe", run_probe(path, dev)))
                n_cases += 1
                for mode, res in runs:
                    if mode == "strict":
                        key = res["outcome"]
                        counts[key] = counts.get(key, 0) + 1
                    elif mode == "probe":
                        key = res["outcome"]
                        probes[key] = probes.get(key, 0) + 1
                    problems = []
                    if res["outcome"] == "untyped":
                        problems.append(f"untyped error: {res['detail']}")
                    if res["elapsed_s"] > TIME_LIMIT_S:
                        problems.append(f"wall clock {res['elapsed_s']}s > "
                                        f"{TIME_LIMIT_S}s")
                    if res["peak_bytes"] > FUZZ_LIMITS.alloc_budget:
                        problems.append(f"peak alloc {res['peak_bytes']} > "
                                        f"{FUZZ_LIMITS.alloc_budget}")
                    for problem in problems:
                        summary["violations"].append({
                            "format": fmt,
                            "mutant": idx,
                            "mode": mode,
                            "problem": problem,
                            "repro": _repro(seed, fmt, mutants_per_format),
                        })
            summary["counts"][fmt] = counts
            if probes:
                summary.setdefault("probes", {})[fmt] = probes
        summary["mutants_per_s"] = n_cases / max(time.monotonic() - t0, 1e-9)
    if launches0 is not None:
        import torch

        from spark_bam_tpu_torch.tpu import kernels

        summary["device"] = {
            "name": torch.cuda.get_device_name(dev),
            # The campaign's own peak, above what was live at its start.
            "peak_bytes": int(torch.cuda.max_memory_allocated(dev)) - live0,
            "live_at_start_bytes": int(live0),
            "launches": {k: v - launches0.get(k, 0)
                         for k, v in kernels.LAUNCHES.items()
                         if v - launches0.get(k, 0)},
        }
    return summary


def add_arguments(ap) -> None:
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mutants", type=int, default=200)
    ap.add_argument("--formats", default=",".join(FORMATS))
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")


def run_from_args(args) -> int:
    """The ``fuzz-decode`` command: the campaign's JSON summary on stdout
    (and to ``-o``); 1 on a violation."""
    import json

    from spark_bam_tpu_torch.cli_app import UsageError

    formats = tuple(f.strip() for f in args.formats.split(",") if f.strip())
    try:
        check_formats(formats)
    except ValueError as e:
        raise UsageError(str(e)) from e
    summary = run_fuzz(seed=args.seed, mutants_per_format=args.mutants,
                       formats=formats, device=args.device)
    text = json.dumps(summary, indent=2, sort_keys=True)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return 1 if summary["violations"] else 0
