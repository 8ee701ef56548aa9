"""The record path (``load/api.py``'s loaders, ``load/dataset.py``, the
tolerant streams) against the JAX package: the same BAMs give the same
``(Pos, record)`` sequences from ``load_bam``, ``load_reads_and_positions``,
``load_splits_and_reads``, ``load_reads`` and ``load_bam_intervals``, at
several split sizes, past a refused record mid-file (601), on a damaged
BAM in strict mode (the same exception class) and in tolerant mode (the
same records and the same quarantine ledger), and from a warm ``.sbi``
plan (no split resolution at all). ``Dataset.aggregate`` and
``to_batches`` equal the JAX package's. Strict split starts are resolved
by the calling process, on the device it names, before any partition
runs."""

import os
import struct
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.bai import index_bam as jax_index_bam
from spark_bam_tpu.bam.header import BamHeader as JaxHeader
from spark_bam_tpu.bam.header import ContigLengths
from spark_bam_tpu.bam.record import BamRecord as JaxRecord
from spark_bam_tpu.bam.writer import BGZF_EOF, compress_block
from spark_bam_tpu.bam.writer import encode_bam_header
from spark_bam_tpu.bam.writer import write_bam as jax_write_bam
from spark_bam_tpu.bgzf import stream as jstream
from spark_bam_tpu.bgzf.index_blocks import blocks_metadata as jax_blocks
from spark_bam_tpu.core.channel import open_channel as jax_open
from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.core.pos import Pos as JaxPos
from spark_bam_tpu.load import api as japi
from spark_bam_tpu.parallel.executor import ParallelConfig as JaxParallel
from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.bam import iterators
from spark_bam_tpu_torch.bam.bai import index_bam
from spark_bam_tpu_torch.benchmarks.load_cases import write_refused_mid_bam
from spark_bam_tpu_torch.bgzf import stream
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.faults import BlockGapError
from spark_bam_tpu_torch.load import api, boundary
from spark_bam_tpu_torch.parallel.executor import ParallelConfig
from spark_bam_tpu_torch.sbi.store import reset_cache_events
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODES = ["sequential", "threads"]
TOLERANT = "mode=tolerant,backoff=0"


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_record_path")
    out = {}
    for seed in (31, 32):
        out[f"rand{seed}"] = str(d / f"rand{seed}.bam")
        random_bam(out[f"rand{seed}"], seed=seed, n_records=(120, 160),
                   read_len=(10, 300), mapped_rate=0.75)
    out["sorted"] = str(d / "sorted.bam")
    random_bam(out["sorted"], seed=33, n_records=(150, 200),
               read_len=(10, 600), sort=True, mapped_rate=0.9)
    jax_index_bam(out["sorted"], out["sorted"] + ".bai")
    index_bam(out["sorted"], str(d / "port.bai"))
    out["port_bai"] = str(d / "port.bai")
    out["refused"] = str(d / "refused.bam")
    out["refused_manifest"] = write_refused_mid_bam(out["refused"])
    out["damaged"] = str(d / "damaged.bam")
    _damaged_block_bam(out["damaged"])
    out["bad_records"] = str(d / "bad_records.bam")
    _damaged_records_bam(out["bad_records"])
    return out


def _damaged_block_bam(path):
    """One mid-file block's payload bytes flipped, so its CRC fails (the
    reference's robustness fixture)."""
    header = JaxHeader(ContigLengths({0: ("chr1", 1_000_000)}), JaxPos(0, 0),
                       0, "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000000\n")
    recs = (JaxRecord(ref_id=0, pos=100 + i * 50, mapq=60, bin=0, flag=0,
                      next_ref_id=-1, next_pos=-1, tlen=0, read_name=f"r{i}",
                      cigar=[(100, 0)], seq="ACGT" * 25, qual=bytes([30]) * 100)
            for i in range(1200))
    jax_write_bam(path, header, recs, block_payload=5000)
    metas = list(jax_blocks(path))
    data = bytearray(Path(path).read_bytes())
    data[metas[4].start + 30] ^= 0xFF
    Path(path).write_bytes(bytes(data))


def _damaged_records_bam(path):
    """60 records in 1 KiB blocks: two with a zero read-name length (the
    framing holds: the tolerant stream loses exactly those) and one with
    a length prefix no record can have (the stream resyncs past it with
    the checker)."""
    header = JaxHeader(ContigLengths({0: ("chr1", 1_000_000)}), JaxPos(0, 0),
                       0, "@SQ\tSN:chr1\tLN:1000000\n")
    payload = bytearray(encode_bam_header(header))
    offsets = []
    for i in range(60):
        offsets.append(len(payload))
        payload += JaxRecord(0, 100 + 50 * i, 60, 0, 0, -1, -1, 0, f"r{i}",
                             [(40, 0)], "ACGT" * 10, b"I" * 40, b"").encode()
    for i in (10, 25):
        payload[offsets[i] + 12] = 0
    struct.pack_into("<i", payload, offsets[40], 8)
    blob = bytearray()
    for o in range(0, len(payload), 1024):
        blob += compress_block(bytes(payload[o:o + 1024]))
    Path(path).write_bytes(bytes(blob + BGZF_EOF))


def _pairs(items):
    return [((p.block_pos, p.offset), rec.encode()) for p, rec in items]


def _port(path, split, **cfg):
    return api.load_reads_and_positions(path, split, Config(**cfg),
                                        device="cpu")


def _jax(path, split, **cfg):
    return japi.load_reads_and_positions(path, split, JaxConfig(**cfg))


@pytest.mark.parametrize("name", ["rand31", "rand32"])
@pytest.mark.parametrize("split", ["6KB", "20KB", None])
def test_loads_equal_jax(bams, name, split):
    path = bams[name]
    got, want = _port(path, split), _jax(path, split)
    assert _pairs(got.collect()) == _pairs(want.collect())
    assert got.partition_sizes() == want.partition_sizes()
    assert ([None if x is None else tuple(x[0]) for x in
             got.first_per_partition()]
            == [None if x is None else tuple(x[0]) for x in
                want.first_per_partition()])
    port_bam = api.load_bam(path, split, device="cpu")
    jax_bam = japi.load_bam(path, split)
    assert [r.encode() for r in port_bam.collect()] == [
        r.encode() for r in jax_bam.collect()]
    assert (port_bam.count() == jax_bam.count()
            == api.load_reads(path, split, device="cpu").count())


@pytest.mark.parametrize("split", ["8KB", "24KB", None])
def test_refused_mid_bam_reads_its_601_records(bams, split):
    path, manifest = bams["refused"], bams["refused_manifest"]
    got = _port(path, split).collect()
    assert _pairs(got) == _pairs(_jax(path, split).collect())
    assert len(got) == manifest["records"] == 601
    assert [r.read_name for _, r in got] == manifest["names"]


@pytest.mark.parametrize("split", ["6KB", None])
def test_load_splits_and_reads_equals_jax(bams, split):
    path = bams["rand31"]
    splits, ds = api.load_splits_and_reads(path, split, device="cpu")
    jsplits, jds = japi.load_splits_and_reads(path, split)
    assert [(tuple(s.start), tuple(s.end)) for s in splits] == [
        (tuple(s.start), tuple(s.end)) for s in jsplits]
    assert [r.encode() for r in ds.collect()] == [
        r.encode() for r in jds.collect()]


def test_load_reads_dispatch(bams, tmp_path):
    for ext in ("sam", "cram"):
        with pytest.raises(NotImplementedError, match="item 16"):
            api.load_reads(tmp_path / f"x.{ext}", device="cpu")
    with pytest.raises(ValueError, match="Can't tell format"):
        api.load_reads(tmp_path / "x.txt", device="cpu")
    with pytest.raises(ValueError, match="Can't tell format"):
        japi.load_reads(tmp_path / "x.txt")
    with pytest.raises(NotImplementedError, match="item 16"):
        api.load_bam_intervals(tmp_path / "x.sam", "chr1")


@pytest.mark.parametrize("mode", MODES)
def test_strict_damaged_block_raises_as_jax(bams, mode):
    path = bams["damaged"]
    with pytest.raises(Exception) as got:
        api.load_bam(path, "4KB", Config(), ParallelConfig(mode, 4),
                     device="cpu").collect()
    with pytest.raises(Exception) as want:
        japi.load_bam(path, "4KB", JaxConfig(), JaxParallel(mode, 4)).collect()
    assert type(got.value).__name__ == type(want.value).__name__ == \
        "BlockCorruptionError"
    assert str(got.value) == str(want.value)


def _ledger(report):
    return ([(p.index, p.status, p.error) for p in report.partitions],
            report.quarantined, report.lost_records, report.lost_blocks)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,split", [("damaged", "4KB"),
                                        ("damaged", "16KB"),
                                        ("bad_records", "2KB"),
                                        ("bad_records", None)])
def test_tolerant_mode_equals_jax(bams, mode, name, split):
    path = bams[name]
    got = api.load_reads_and_positions(path, split, Config(faults=TOLERANT),
                                       ParallelConfig(mode, 4), device="cpu")
    want = japi.load_reads_and_positions(path, split,
                                         JaxConfig(faults=TOLERANT),
                                         JaxParallel(mode, 4))
    records = got.collect()
    assert _pairs(records) == _pairs(want.collect())
    assert _ledger(got.last_report) == _ledger(want.last_report)
    assert got.last_report.summary() == want.last_report.summary()
    lost = {"damaged": (0, 1), "bad_records": (3, 0)}[name]
    assert (got.last_report.lost_records, got.last_report.lost_blocks) == lost
    assert 0 < len(records) < (1200 if name == "damaged" else 60)


def test_strict_bad_length_prefix_raises_as_jax(bams):
    path = bams["bad_records"]
    with pytest.raises(Exception) as got:
        api.load_bam(path, None, device="cpu").collect()
    with pytest.raises(Exception) as want:
        japi.load_bam(path).collect()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_tolerant_block_stream_equals_jax(bams):
    """Block by block, the tolerant stream's blocks and its one gap (the
    damaged block, the resync point) equal the reference's."""
    path = bams["damaged"]

    def port_blocks():
        s = stream.BlockStream(open_channel(path), tolerant=True)
        out = []
        while True:
            try:
                blk = s.next_block()
            except BlockGapError as gap:
                out.append(("gap", gap.damaged_start, gap.resync))
                continue
            if blk is None:
                return out
            out.append((blk[1], bytes(blk[0])))

    def jax_blocks_():
        s = jstream.BlockStream(jax_open(path), tolerant=True)
        out = []
        while True:
            try:
                blk = next(s)
            except StopIteration:
                return out
            except Exception as gap:
                out.append(("gap", gap.damaged_start, gap.resync))
                continue
            out.append((blk.start, bytes(blk.data)))

    got = port_blocks()
    assert got == jax_blocks_()
    assert sum(1 for b in got if b[0] == "gap") == 1


def test_pos_and_metadata_streams_equal_jax(bams):
    from spark_bam_tpu.bam.iterators import PosStream as JaxPosStream

    path = bams["rand32"]
    with open_channel(path) as ch:
        got = [tuple(p) for p in iterators.PosStream.open(ch)]
        metas = [(m.start, m.compressed_size, m.uncompressed_size)
                 for m in stream.MetadataStream(ch)]
    with jax_open(path) as ch:
        want = [tuple(p) for p in JaxPosStream.open(ch)]
    assert got == want
    assert metas == [(m.start, m.compressed_size, m.uncompressed_size)
                     for m in jax_blocks(path)]
    assert [tuple(p) for p in stream.pos_iterator(
        stream.Metadata(*metas[1]))][:3] == [(metas[1][0], k) for k in range(3)]


def test_seekable_record_stream_clamps_to_the_first_record(bams):
    from spark_bam_tpu.bam.iterators import SeekableRecordStream as JaxSeek

    path = bams["rand31"]
    with open_channel(path) as ch, jax_open(path) as jch:
        got, want = iterators.SeekableRecordStream.open(ch), JaxSeek.open(jch)
        for target in ((0, 0), (0, 5)):
            got.seek(api.Pos(*target))
            want.seek(JaxPos(*target))
            a = [(tuple(p), r.encode()) for _, (p, r) in zip(range(3), got)]
            b = [(tuple(p), r.encode()) for _, (p, r) in zip(range(3), want)]
            assert a == b


def test_warm_sbi_resolves_nothing(bams, tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_BAM_CACHE_DIR", str(tmp_path))
    path = bams["rand32"]
    want = _pairs(_jax(path, "6KB").collect())
    counts = []
    for cache in ("readwrite", "read"):
        reset_cache_events()
        reg = obs.configure()
        try:
            got = _port(path, "6KB", cache=cache).collect()
            counts.append(reg.counter("load.split_resolutions").value)
        finally:
            obs.shutdown()
        assert _pairs(got) == want
    assert counts[0] == -(-os.path.getsize(path) // (6 << 10))
    assert counts[1] == 0


def test_strict_starts_resolve_before_the_partitions_on_the_device(bams, monkeypatch):
    """Every strict split start is resolved by ``resolve_split_start`` on
    the caller's device, in the calling thread, before the dataset is
    returned; partitions resolve nothing."""
    calls = []
    real = boundary.resolve_split_start

    def spy(path, split, header, config, device=None):
        calls.append((split.start, str(device),
                      threading.current_thread() is threading.main_thread()))
        return real(path, split, header, config, device=device)

    monkeypatch.setattr(boundary, "resolve_split_start", spy)
    path = bams["rand31"]
    ds = api.load_bam(path, "6KB", device="cpu")
    n = len(calls)
    assert n == -(-os.path.getsize(path) // (6 << 10))
    assert all(dev == "cpu" and main for _, dev, main in calls)
    ds.count()
    assert len(calls) == n


def test_entry_points_need_cuda(bams):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (api.load_bam, api.load_reads_and_positions,
               api.load_splits_and_reads, api.load_reads):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(bams["rand31"])


@pytest.mark.parametrize("loci", ["chr1", "chr2:100k-2m", "chr1:0-50k,chr2",
                                  "chrZ:1-100", "chr1:3m-3m"])
def test_load_bam_intervals_equals_jax(bams, loci):
    path = bams["sorted"]
    got = api.load_bam_intervals(path, loci, "8KB")
    want = japi.load_bam_intervals(path, loci, "8KB")
    assert [r.encode() for r in got.collect()] == [
        r.encode() for r in want.collect()]
    assert got.num_partitions == want.num_partitions
    assert Path(bams["port_bai"]).read_bytes() == Path(
        path + ".bai").read_bytes()


def test_dataset_aggregate_equals_jax(bams):
    from spark_bam_tpu.agg.plan import AggConfig as JaxAgg
    from spark_bam_tpu_torch.agg.plan import AggConfig

    spec = "count;flagstat;mapq;tlen:max=500;coverage:bin=10000,bins=64"
    for name in ("rand31", "refused"):
        path = bams[name]
        got = api.load_bam(path, "8KB", device="cpu").aggregate(
            AggConfig.parse(spec), 3)
        want = japi.load_bam(path, "8KB").aggregate(JaxAgg.parse(spec), 3)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("rows,columns", [(64, None), (1000, "flag,pos,name"),
                                          (7, "cigar,seq,qual,tags")])
def test_to_batches_equals_jax(bams, rows, columns):
    path = bams["rand32"]
    got = list(_port(path, "6KB").to_batches(rows, columns))
    want = list(_jax(path, "6KB").to_batches(rows, columns))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.num_rows == w.num_rows
        assert g.column_names == w.column_names
        for name in g.column_names:
            a, b = g.columns[name], w.columns[name]
            if hasattr(a, "offsets"):
                np.testing.assert_array_equal(a.offsets, b.offsets)
                np.testing.assert_array_equal(a.values, b.values)
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["block_edge", "mid_block"])
def test_truncated_bam_ends_as_jax(tmp_path, case):
    """A file cut inside a block: the streams end at the cut as the
    reference's do. The strict stream once raised ``EOFError`` there when
    the record before the cut ended exactly at its block's end (the edge
    corpus's first-window record)."""
    from spark_bam_tpu.bam.iterators import RecordStream as JaxRecordStream
    from spark_bam_tpu_torch.benchmarks import load_cases
    from spark_bam_tpu_torch.bgzf.index_blocks import scan_blocks

    src = tmp_path / "edge.bam"
    load_cases.write_bam(src, fillers=300)
    data = src.read_bytes()
    metas = scan_blocks(src)
    # Block 8 starts where the header block and seven record blocks end.
    cut = (metas[8].start + 30 if case == "block_edge"
           else int(len(data) * 0.6))
    path = tmp_path / "cut.bam"
    path.write_bytes(data[:cut])
    with open_channel(path) as ch:
        got = [(tuple(p), r.encode()) for p, r in
               iterators.RecordStream.open(ch)]
    with jax_open(path) as ch:
        want = [(tuple(p), r.encode()) for p, r in
                JaxRecordStream.open(ch)]
    assert got == want and got
    for split in ("16KB", None):
        assert _pairs(_port(path, split).collect()) == _pairs(
            _jax(path, split).collect())
