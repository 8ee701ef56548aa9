"""The ``.bai`` index (``bam/bai.py``) and ``index-bam`` against the JAX
package: the index of a coordinate-sorted BAM is byte-equal to the JAX
package's, its chunk queries and interval plans are equal, and the binning
helpers agree."""

import struct
from pathlib import Path

import pytest

from spark_bam_tpu.bam import bai as jbai
from spark_bam_tpu.bam.header import read_header as jax_read_header
from spark_bam_tpu.load import api as japi
from spark_bam_tpu.load.intervals import LociSet as JaxLoci
from spark_bam_tpu_torch import cli
from spark_bam_tpu_torch.bam import bai
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.core.guard import StructurallyInvalid, TruncatedInput
from spark_bam_tpu_torch.load import api
from spark_bam_tpu_torch.load.intervals import LociSet
from tests.bam_factories import random_bam


@pytest.fixture(scope="module")
def sorted_bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bai")
    out = []
    for seed, kw in ((51, {}), (52, {"mapped_rate": 0.5}),
                     (53, {"read_len": (10, 20000), "pos_step": (1, 50)})):
        p = str(d / f"s{seed}.bam")
        random_bam(p, seed=seed, sort=True, **{"read_len": (10, 800), **kw})
        out.append(p)
    return out


def _chunks(cs):
    return [(tuple(c.start), tuple(c.end)) for c in cs]


def test_index_bam_bytes_equal_jax(sorted_bams, tmp_path):
    for p in sorted_bams:
        ours, idx = bai.index_bam(p, tmp_path / "port.bai")
        theirs, jidx = jbai.index_bam(p, tmp_path / "jax.bai")
        assert Path(ours).read_bytes() == Path(theirs).read_bytes()
        assert idx.n_no_coor == jidx.n_no_coor
        back = bai.BaiIndex.read(ours)
        assert [tuple(x) for x in back.chunk_starts()] == [
            tuple(x) for x in jidx.chunk_starts()]
        assert [tuple(x) for x in back.all_addresses()] == [
            tuple(x) for x in jidx.all_addresses()]
        for ref in range(len(idx.references) + 1):
            for s, e in ((0, 1), (0, 10_000_000), (123_456, 130_000),
                         (4_000_000, 4_000_001), (16383, 16385)):
                assert _chunks(back.query(ref, s, e)) == _chunks(
                    jidx.query(ref, s, e))


def test_build_bai_over_a_url_equals_jax_local(sorted_bams, tmp_path):
    """``build_bai`` takes the file's end from ``path_size``, so a URL
    (the in-process fake store) indexes as the local file does: the same
    ``.bai`` bytes as the JAX ``build_bai`` over the local path."""
    from spark_bam_tpu_torch.benchmarks.fakestore import FakeObjectStore

    for p in sorted_bams:
        data = Path(p).read_bytes()
        with FakeObjectStore(data, key="x.bam") as store:
            url = f"{store.url_base}/b/x.bam"
            ours, _ = bai.index_bam(url, tmp_path / "url.bai")
        theirs, _ = jbai.index_bam(p, tmp_path / "jax.bai")
        assert Path(ours).read_bytes() == Path(theirs).read_bytes()


def test_interval_plan_equals_jax(sorted_bams):
    p = sorted_bams[2]
    bai.index_bam(p)
    header, jheader = read_header(p), jax_read_header(p)
    for loci in ("chr1", "chr2:1k-500k", "chr1:0-10,chr1:2m-3m", "chrX"):
        got = api.interval_chunks(p, LociSet.parse(loci, header), header)
        want = japi.interval_chunks(
            p, JaxLoci.parse(loci, jheader.contig_lengths), jheader)
        assert _chunks(got) == _chunks(want)
        for size in (1, 5000, 1 << 20):
            assert [_chunks(g) for g in api.pack_chunks(got, size, 3.0)] == [
                _chunks(g) for g in japi.pack_chunks(want, size, 3.0)]


@pytest.mark.parametrize("beg,end", [(0, 1), (0, 1 << 14), (1 << 14, 1 << 17),
                                     (12_345, 12_346), (100, 70_000_000),
                                     ((1 << 26) - 1, 1 << 26)])
def test_binning_equals_jax(beg, end):
    assert bai.reg2bin(beg, end) == jbai.reg2bin(beg, end)
    assert bai.reg2bins(beg, end) == jbai.reg2bins(beg, end)


def test_merge_chunks_equals_jax():
    from spark_bam_tpu.core.pos import Pos as JaxPos
    from spark_bam_tpu_torch.core.pos import Pos

    spans = [((0, 5), (0, 90)), ((0, 80), (100, 3)), ((100, 3), (100, 9)),
             ((200, 0), (300, 1)), ((250, 0), (260, 0))]
    got = bai.merge_chunks([bai.Chunk(Pos(*a), Pos(*b)) for a, b in spans])
    want = jbai.merge_chunks([jbai.Chunk(JaxPos(*a), JaxPos(*b))
                              for a, b in spans])
    assert _chunks(got) == _chunks(want)
    assert [c.size(3.0) for c in got] == [c.size(3.0) for c in want]


def test_malformed_bai_raises_as_jax(sorted_bams, tmp_path):
    good = Path(bai.index_bam(sorted_bams[0], tmp_path / "g.bai")[0]
                ).read_bytes()
    cases = {"magic": b"BAX\x01" + good[4:], "cut": good[: len(good) // 2],
             "neg": good[:4] + struct.pack("<i", -1) + good[8:]}
    for name, blob in cases.items():
        p = tmp_path / f"{name}.bai"
        p.write_bytes(blob)
        with pytest.raises((StructurallyInvalid, TruncatedInput)) as got:
            bai.BaiIndex.read(p)
        with pytest.raises(Exception) as want:
            jbai.BaiIndex.read(p)
        assert type(got.value).__name__ == type(want.value).__name__


def test_unsorted_bam_is_refused(tmp_path):
    p = tmp_path / "u.bam"
    random_bam(p, seed=54, read_len=(10, 100), mapped_rate=1.0)
    with pytest.raises(ValueError, match="not coordinate-sorted"):
        bai.build_bai(p)
    with pytest.raises(ValueError, match="not coordinate-sorted"):
        jbai.build_bai(p)


def test_index_bam_command_equals_jax(sorted_bams, tmp_path, capsys):
    from spark_bam_tpu.cli.main import main as jax_main

    p = sorted_bams[1]
    assert cli.main(["index-bam", "-o", str(tmp_path / "c.bai"), p]) == 0
    port_err = capsys.readouterr().err
    assert jax_main(["index-bam", "-o", str(tmp_path / "j.bai"), p]) == 0
    jax_err = capsys.readouterr().err
    assert (tmp_path / "c.bai").read_bytes() == (tmp_path / "j.bai"
                                                 ).read_bytes()
    line = [ln for ln in port_err.splitlines() if ln.startswith("Wrote")]
    want = [ln for ln in jax_err.splitlines() if ln.startswith("Wrote")]
    assert [ln.replace("c.bai", "X") for ln in line] == [
        ln.replace("j.bai", "X") for ln in want]
    assert len(line) == 1
