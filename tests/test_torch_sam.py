"""The port's SAM (``bam/record.py``'s SAM half, ``load_sam``, the SAM
branches of ``load_reads``, ``load_bam_intervals``, ``aggregate`` and
``export``) against the JAX package's, exactly: SAM lines, rendered and
encoded tags, the loaded records at several split sizes, the interval
scan, the aggregate's int64 vectors and the export's container bytes."""

import dataclasses

import numpy as np
import pytest

from spark_bam_tpu.bam.header import ContigLengths
from spark_bam_tpu.bam.record import BamRecord as JRecord
from spark_bam_tpu.bam.record import encode_tag as jencode_tag
from spark_bam_tpu.bam.record import parse_sam_line as jparse
from spark_bam_tpu.bam.record import render_tags as jrender
from spark_bam_tpu.load import api as japi
from spark_bam_tpu_torch.bam.record import (
    BamRecord,
    encode_tag,
    parse_sam_line,
    render_tags,
)
from spark_bam_tpu_torch.benchmarks import agg_cases
from spark_bam_tpu_torch.benchmarks import text_cases as tc
from spark_bam_tpu_torch.load import api
from tests.bam_factories import random_bam


def _enc(recs):
    return [r.encode() for r in recs]


@pytest.fixture(scope="module")
def sams(tmp_path_factory):
    """SAM copies of seeded BAMs (random, sorted, tagged) with their BAM
    records."""
    d = tmp_path_factory.mktemp("torch_sam")
    out = {}
    for key, kw in (("random", dict(dup_rate=0.1)),
                    ("sorted", dict(sort=True, read_len=(10, 600),
                                    pos_step=(1, 60)))):
        bam = str(d / f"{key}.bam")
        random_bam(bam, 11, **kw)
        out[key] = bam
    out["tagged"] = str(d / "tagged.bam")
    agg_cases.write_tagged_bam(out["tagged"])
    paths = {}
    for key, bam in out.items():
        header, recs = tc.bam_records(bam)
        paths[key] = str(d / f"{key}.sam")
        tc.write_sam(header, recs, paths[key])
        paths[key + ".bam"] = bam
        paths[key + ".records"] = recs
    return paths


def test_to_sam_equals_jax(sams):
    header, _ = tc.bam_records(sams["tagged.bam"])
    contigs = ContigLengths(dict(enumerate(tc.contig_pairs(header))))
    for key in ("random", "tagged", "sorted"):
        for rec in sams[key + ".records"]:
            jrec = JRecord(**dataclasses.asdict(rec))
            line = rec.to_sam(header.contig_names)
            assert line == jrec.to_sam(contigs)
            back = parse_sam_line(line, {n: i for i, n in
                                         enumerate(header.contig_names)})
            assert back.encode() == jparse(line, {
                n: i for i, (n, _) in contigs.items()}).encode()


def test_render_tags_on_arbitrary_bytes_equals_jax():
    """Total on any bytes: the same strings, stopping where the JAX
    renderer stops."""
    rng = np.random.default_rng(3)
    good = (encode_tag("NM:i:-3") + encode_tag("XA:A:q") + encode_tag(
        "RG:Z:grp1") + encode_tag("XF:f:1.25") + encode_tag("BC:B:i,1,-2")
        + encode_tag("BF:B:f,0.5") + encode_tag("HX:H:1AE3")
        + b"XcC\x05" + b"XsS\x05\x01" + b"XbBc\x02\x00\x00\x00\xff\x01")
    assert render_tags(good) == jrender(good)
    for _ in range(400):
        n = int(rng.integers(0, 60))
        raw = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        if rng.random() < 0.5:
            cut = int(rng.integers(0, len(good)))
            raw = good[:cut] + raw
        assert render_tags(raw) == jrender(raw)


@pytest.mark.parametrize("tag", [
    "NM:i:5", "NM:i:-70000", "XA:A:z", "RG:Z:a b", "XF:f:-1e-3",
    "HX:H:00FF", "BC:B:c,-1,2", "BC:B:S,65535", "BF:B:f,1.5,2", "BE:B:i",
])
def test_encode_tag_equals_jax(tag):
    assert encode_tag(tag) == jencode_tag(tag)


def test_encode_tag_refusals_equal_jax():
    for bad in ("NM:q:1", "BC:B:x,1", "NM:i:abc"):
        with pytest.raises(Exception) as got:
            encode_tag(bad)
        with pytest.raises(Exception) as want:
            jencode_tag(bad)
        assert type(got.value) is type(want.value)


@pytest.mark.parametrize("split", [None, 3000, 20_000, "256KB"])
@pytest.mark.parametrize("key", ["random", "tagged"])
def test_load_sam_equals_jax(sams, key, split):
    ds = api.load_sam(sams[key], split)
    jds = japi.load_sam(sams[key], split)
    assert ds.partitions == jds.partitions
    got = ds.collect()
    assert _enc(got) == _enc(jds.collect())
    assert len(got) == len(sams[key + ".records"])
    assert _enc(api.load_reads(sams[key], split, device="cpu").collect()) \
        == _enc(got)


def test_scan_sam_header_equals_jax(sams):
    for key in ("random", "tagged"):
        h = api._scan_sam_header(sams[key])
        want = japi._scan_sam_header(sams[key])
        assert list(zip(h.contig_names, h.contig_lengths.tolist())) == [
            want[i] for i in range(len(want))]


@pytest.mark.parametrize("loci", ["chr1:1000-90000", "chr2",
                                  "chr1:5-6,chr2:100-20000", "chrX"])
@pytest.mark.parametrize("split", [None, 4000])
def test_sam_intervals_equal_jax(sams, loci, split):
    got = api.load_bam_intervals(sams["sorted"], loci, split)
    want = japi.load_bam_intervals(sams["sorted"], loci, split)
    assert _enc(got.collect()) == _enc(want.collect())
    assert _enc(api._load_sam_intervals(
        sams["sorted"], loci, split, api.Config(),
        api.ParallelConfig()).collect()) == _enc(got.collect())


AGG_KW = [
    {},
    {"agg": "count;flagstat;mapq;tlen:max=30;coverage:bin=1000,bins=8"},
    {"flags_required": 16},
    {"flags_forbidden": 4, "agg": "flagstat"},
    {"tags_required": ("NM",)},
    {"tags_required": ("BC",), "flags_forbidden": 16},
    {"loci": "chr1:1-50000,chr2", "agg": "count;coverage"},
    {"agg": "mapq;tlen"},
]


@pytest.mark.parametrize("kw", AGG_KW)
@pytest.mark.parametrize("key", ["tagged", "random"])
def test_aggregate_sam_equals_jax(sams, key, kw):
    got = api.aggregate(sams[key], device="cpu", **kw)
    want = japi.aggregate(sams[key], **kw)
    assert got["agg"] == want["agg"] and got["rows"] == want["rows"]
    assert got["contigs"] == want["contigs"]
    assert list(got["metrics"]) == list(want["metrics"])
    for k, v in want["metrics"].items():
        assert got["metrics"][k].dtype == np.int64
        assert np.array_equal(got["metrics"][k], np.asarray(v)), k


def test_aggregate_sam_equals_the_bams(sams):
    """The SAM's host oracle equals the BAM's device reduction (the CPU
    device here)."""
    for key in ("tagged", "random"):
        got = api.aggregate(sams[key], device="cpu")
        bam = api.aggregate(sams[key + ".bam"], device="cpu")
        assert got["rows"] == bam["rows"]
        for k in bam["metrics"]:
            assert np.array_equal(got["metrics"][k], bam["metrics"][k]), k


@pytest.mark.parametrize("kw", [{}, {"loci": "chr1:1-60000"},
                                {"flags_required": 16},
                                {"columns": "pos,cigar,seq,qual,tags"}])
def test_export_sam_equals_jax(sams, tmp_path, kw):
    kw = dict(kw)
    columns = kw.pop("columns", None)
    got = api.export(sams["tagged"], str(tmp_path / "p.sbcr"),
                     columns=columns, device="cpu", **kw)
    want = japi.export(sams["tagged"], str(tmp_path / "j.sbcr"),
                       columns=columns, **kw)
    assert (tmp_path / "p.sbcr").read_bytes() == \
        (tmp_path / "j.sbcr").read_bytes()
    assert got["rows"] == want["rows"] > 0


def test_sam_record_fields_round_trip(sams):
    """Every field SAM carries survives to_sam then load_sam (SAM has no
    bin: it parses as 0, as in the JAX package)."""
    recs = sams["random.records"]
    back = api.load_sam(sams["random"]).collect()
    for a, b in zip(recs, back):
        assert dataclasses.replace(a, bin=0) == b
    assert isinstance(back[0], BamRecord)
