"""The port's aggregation plane against the JAX package's, exactly.

The spec grammar and the wire format; ``aggregate_planes`` on seeded
planes (``benchmarks/agg_cases.py``) over every metric, its parameters,
contig counts, window sizes and a carry that drains many times; the two
inputs where the JAX device reduction leaves the wire contract, where the
port equals the JAX int64 oracle instead; the mesh's agg step on 1, 2, 4
and 8 CPU entries against the JAX shard_map step; and the ``aggregate``
entry point on random and tagged BAMs under every kind of filter.
"""

import jax
import numpy as np
import pytest

from spark_bam_tpu.agg import host as jhost
from spark_bam_tpu.agg import kernels as jkernels
from spark_bam_tpu.agg import plan as jplan
from spark_bam_tpu.bam.bai import index_bam
from spark_bam_tpu.bam.header import read_header as jread_header
from spark_bam_tpu.bam.record import BamRecord, encode_tag
from spark_bam_tpu.bam.writer import write_bam
from spark_bam_tpu.load import api as japi
from spark_bam_tpu.parallel import mesh as jmesh
from spark_bam_tpu_torch import make_mesh
from spark_bam_tpu_torch.agg import host, kernels, plan
from spark_bam_tpu_torch.benchmarks import agg_cases
from spark_bam_tpu_torch.load import api
from spark_bam_tpu_torch.parallel import mesh as pmesh
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

VALID_SPECS = ["", plan.DEFAULT_SPEC,
               "coverage:bins=64,bin=500,cap=4 ; count",
               "tlen:max=7;mapq", " flagstat ; coverage:cap=3 "] + list(
    plan.METRICS)
BAD_SPECS = ["bogus", "coverage:widths=3", "tlen:max=abc", "coverage:bins",
             "mapq;mapq", "tlen:max=0", ";;"]


def _equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        g = np.asarray(got[k])
        assert g.dtype == np.int64, k
        assert np.array_equal(g.reshape(-1),
                              np.asarray(want[k]).reshape(-1)), k


# ----------------------------------------------------------- grammar, wire
@pytest.mark.parametrize("spec", VALID_SPECS)
def test_parse_matches_jax(spec):
    got, want = plan.AggConfig.parse(spec), jplan.AggConfig.parse(spec)
    assert got.canonical() == want.canonical()
    assert plan.AggConfig.parse(got.canonical()) == got
    for nc in (0, 1, 25):
        assert got.total_length(nc) == want.total_length(nc)
        assert [s.shape(nc) for s in got.specs] == [
            s.shape(nc) for s in want.specs]


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_parse_rejects(bad):
    with pytest.raises(ValueError):
        plan.AggConfig.parse(bad)
    with pytest.raises(ValueError):
        jplan.AggConfig.parse(bad)


@pytest.mark.parametrize("spec,nc", [("", 2), ("count;mapq", 0),
                                     ("coverage:bins=3;tlen:max=4", 5)])
def test_wire_format_matches_jax(spec, nc):
    p = plan.AggConfig.parse(spec)
    rng = np.random.default_rng(nc)
    vectors = {s.name: rng.integers(-2**40, 2**40, s.length(nc))
               for s in p.specs}
    contigs = [(f"c{i}", 1000 + i) for i in range(nc)]
    meta, payload = plan.encode_result(p, nc, contigs, vectors)
    jmeta, jpayload = jplan.encode_result(jplan.AggConfig.parse(spec), nc,
                                          contigs, vectors)
    assert meta == jmeta and payload == jpayload
    back = plan.decode_result(meta, payload)
    for s in p.specs:
        assert back[s.name].shape == s.shape(nc)
        assert np.array_equal(back[s.name].reshape(-1), vectors[s.name])
    with pytest.raises(ValueError):
        plan.decode_result(meta, payload[:-8])
    with pytest.raises(ValueError):
        plan.encode_result(p, nc, contigs,
                           {**vectors, p.specs[0].name: np.zeros(1)})


def test_combine_equals_one_pass():
    p = plan.AggConfig.parse("")
    cols = agg_cases.random_planes(4, 300, 3)
    parts = [{k: v[a:b] for k, v in cols.items()}
             for a, b in ((0, 100), (100, 250), (250, 400))]
    got = host.combine([host.host_aggregate(c, p, 3) for c in parts]
                       + [None], p, 3)
    _equal(got, host.host_aggregate(cols, p, 3))


# ---------------------------------------------------------- the reduction
def _both(cols, spec, nc, chunk=None):
    got = kernels.aggregate_planes(cols, plan.AggConfig.parse(spec), nc,
                                   chunk=chunk, device="cpu")
    want = jkernels.aggregate_planes(cols, jplan.AggConfig.parse(spec), nc,
                                     chunk=chunk)
    return got, want


@pytest.mark.parametrize("spec,nc,chunk,m", [
    ("count", 2, None, 500),
    ("flagstat", 2, None, 500),
    ("mapq", 2, None, 500),
    ("tlen", 2, None, 500),
    ("coverage", 2, None, 500),
    ("", 25, None, 2000),
    ("tlen:max=1", 2, 64, 300),
    ("tlen:max=2000", 2, 64, 300),
    ("coverage:bin=1,bins=1,cap=1", 3, None, 400),
    ("coverage:bin=1000,bins=512,cap=16", 3, 256, 700),
    ("coverage:bin=7,bins=3,cap=2", 3, None, 400),
    ("", 0, None, 300),
    ("", 1, None, 300),
    ("", 2, 1, 40),
    ("", 2, 3, 100),
    ("", 2, 1 << 16, 1000),
])
def test_aggregate_planes_matches_jax(spec, nc, chunk, m):
    cols = agg_cases.random_planes(m + nc, m, nc)
    got, want = _both(cols, spec, nc, chunk)
    _equal(got, want)
    _equal(got, host.host_aggregate(cols, plan.AggConfig.parse(spec), nc))


def test_all_invalid_rows():
    cols = agg_cases.random_planes(1, 200, 2)
    cols["valid"][:] = False
    got, want = _both(cols, "", 2)
    _equal(got, want)
    assert all(not v.any() for v in got.values())


def test_carry_drains_many_times(monkeypatch):
    monkeypatch.setattr(kernels, "_FLUSH_RECORDS", 5)
    monkeypatch.setattr(jkernels, "_FLUSH_RECORDS", 5)
    drained = []
    real = kernels._state_on
    monkeypatch.setattr(kernels, "_state_on",
                        lambda *a: drained.append(1) or real(*a))
    cols = agg_cases.random_planes(2, 120, 2)
    got, want = _both(cols, "", 2, chunk=3)
    _equal(got, want)
    assert len(drained) > 20


def test_bad_chunk_and_no_cuda():
    cols = agg_cases.random_planes(0, 10, 1)
    p = plan.AggConfig.parse("count")
    with pytest.raises(ValueError):
        kernels.aggregate_planes(cols, p, 1, chunk=-1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.aggregate_planes(cols, p, 1)


@pytest.mark.parametrize("case", sorted(agg_cases.REFERENCE_FAULTS))
def test_wire_contract_where_reference_device_diverges(case):
    """The port equals the int64 oracle where the JAX device reduction
    does not: its int32 ``|tlen|`` of -2^31 stays negative and the scatter
    drops the row, and its int32 ``pos + span`` wraps near 2^31 so the
    read's bases vanish."""
    spec, nc, cols = agg_cases.REFERENCE_FAULTS[case]
    got, device = _both(cols, spec, nc)
    oracle = jhost.host_aggregate(cols, jplan.AggConfig.parse(spec), nc)
    _equal(got, oracle)
    _equal(got, host.host_aggregate(cols, plan.AggConfig.parse(spec), nc))
    if case == "tlen_min_int":
        assert int(oracle["tlen"].sum()) == 8 and oracle["tlen"][-1] == 3
        assert int(device["tlen"].sum()) == 7 and device["tlen"][-1] == 2
    else:
        cov = oracle["coverage"]
        assert int(cov.sum()) == 200 and cov[0] == cov[511] == 100
        cov = device["coverage"]
        assert int(cov.sum()) == 100 and cov[0] == 100 and cov[511] == 0


# ---------------------------------------------------------- the agg step
@pytest.mark.parametrize("n,chunk,m", [(1, None, 301), (2, 64, 301),
                                       (4, 100, 203), (8, 3, 29),
                                       (8, 1 << 16, 1001)])
def test_agg_step_matches_jax(n, chunk, m):
    cols = agg_cases.random_planes(n, m, 4)
    p, jp = plan.AggConfig.parse(""), jplan.AggConfig.parse("")
    steps = pmesh.mesh_steps(make_mesh(["cpu"] * n))
    assert steps.agg_step(p, 4) is steps.agg_step(p, 4)
    got = kernels.aggregate_planes(cols, p, 4, steps=steps, chunk=chunk)
    plain = kernels.aggregate_planes(cols, p, 4, chunk=chunk, device="cpu")
    jsteps = jmesh.mesh_steps(jmesh.make_mesh(jax.devices()[:n]))
    want = jkernels.aggregate_planes(cols, jp, 4, steps=jsteps, chunk=chunk)
    _equal(got, plain)
    _equal(got, want)


# ------------------------------------------------------- the entry point
@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_agg")
    out = {}
    for seed in (7, 11):
        out[seed] = str(d / f"r{seed}.bam")
        random_bam(out[seed], seed=seed, index=True, sort=True)
    return out


@pytest.fixture(scope="module")
def tagged(tmp_path_factory, bams):
    """The JAX package's aggregate test BAM, built the same way: 200
    mapped reads over two contigs then 40 unmapped, NM / RG / BC tags on
    every 3rd / 5th / 7th record."""
    header = jread_header(bams[11])
    rng = np.random.default_rng(3)
    recs = []
    for i in range(240):
        n = int(rng.integers(20, 150))
        mapped = i < 200
        tags = b""
        if i % 3 == 0:
            tags += encode_tag(f"NM:i:{int(rng.integers(0, 5))}")
        if i % 5 == 0:
            tags += encode_tag("RG:Z:grp1")
        if i % 7 == 0:
            tags += encode_tag("BC:B:I,1,2,3")
        recs.append(BamRecord(
            ref_id=(i // 100) if mapped else -1,
            pos=5 + 13 * (i % 100) if mapped else -1,
            mapq=int(rng.integers(0, 61)) if mapped else 0, bin=0,
            flag=(16 if i % 2 else 0) if mapped else 4,
            next_ref_id=-1, next_pos=-1,
            tlen=int(rng.integers(-900, 900)),
            read_name=f"r{i}", cigar=[(n, 0)] if mapped else [],
            seq="A" * n, qual=bytes([30] * n), tags=tags,
        ))
    p = str(tmp_path_factory.mktemp("torch_agg_tag") / "tagged.bam")
    write_bam(p, header, recs, block_payload=5000)
    index_bam(p)
    return p


def _entry(path, **kw):
    got = api.aggregate(path, device="cpu", **kw)
    want = japi.aggregate(path, **kw)
    assert got.keys() == want.keys()
    assert got["agg"] == want["agg"] and got["rows"] == want["rows"]
    assert got["contigs"] == want["contigs"]
    _equal(got["metrics"], want["metrics"])
    return got


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("kw", [
    {},
    {"loci": "chr1:100k-3m,chr2", "agg": "count;coverage:bin=5000,bins=8"},
    {"flags_required": 4, "flags_forbidden": 1024},
], ids=["whole", "loci", "flags"])
def test_aggregate_matches_jax(bams, seed, kw):
    got = _entry(bams[seed], **kw)
    assert got["rows"] > 0


@pytest.mark.parametrize("kw", [
    {},
    {"loci": "chr1:50-900", "agg": "count;mapq;coverage:bin=100,bins=16"},
    {"flags_required": 16, "flags_forbidden": 4},
    {"tags_required": ("NM",)},
    {"tags_required": ("NM", "RG"), "agg": "count;flagstat;tlen:max=500"},
    {"agg": "count;flagstat", "flags_required": 2048},
], ids=["whole", "loci", "flags", "one_tag", "two_tags", "empty"])
def test_aggregate_tagged_matches_jax(tagged, kw):
    got = _entry(tagged, **kw)
    if kw.get("flags_required") == 2048:
        assert got["rows"] == 0 and not got["metrics"]["count"].any()


def test_aggregate_unmapped_no_contigs(tmp_path):
    p = str(tmp_path / "unmapped.bam")
    n = agg_cases.write_unmapped_bam(p, 300)
    got = _entry(p)
    assert got["rows"] == n and got["contigs"] == []
    assert got["metrics"]["coverage"].shape == (0,)
    _entry(p, tags_required=("NM",))


def test_aggregate_port_bams(tmp_path):
    """The port's own tagged BAM (``agg_cases``, the card tests' input)
    against the JAX package."""
    p = str(tmp_path / "tagged.bam")
    agg_cases.write_tagged_bam(p)
    _entry(p, tags_required=("BC",))
    _entry(p, loci="chr2", flags_forbidden=16)


def test_aggregate_rejects(bams):
    with pytest.raises(ValueError, match="two chars"):
        api.aggregate(bams[7], tags_required=("NMX",), device="cpu")
    with pytest.raises(ValueError):
        api.aggregate(bams[7], agg="bogus", device="cpu")
    with pytest.raises(ValueError):
        api.aggregate(bams[7], chunk=-1, device="cpu")
    for ext in (".cram", ".sam"):
        with pytest.raises(NotImplementedError, match="loader"):
            api.aggregate("x" + ext, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.aggregate(bams[7])
