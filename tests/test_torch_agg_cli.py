"""The port's ``aggregate`` command against the JAX package's, byte for
byte: tsv and json reports of a tagged BAM (``benchmarks/agg_cases.py``)
and a random BAM under specs, loci, flag and tag filters, the report on
stdout and through ``-o``, and the same usage error for a bad spec, loci
or tag."""

import pytest

from spark_bam_tpu.cli.main import main as jmain
from spark_bam_tpu_torch.benchmarks import agg_cases
from spark_bam_tpu_torch.cli import main
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_agg_cli")
    tagged, plain = str(d / "tagged.bam"), str(d / "plain.bam")
    agg_cases.write_tagged_bam(tagged)
    random_bam(plain, seed=7, sort=True)
    return {"tagged": tagged, "plain": plain}


@pytest.mark.parametrize("bam,args", [
    ("tagged", []),
    ("tagged", ["--format", "json"]),
    ("tagged", ["-a", "count;flagstat"]),
    ("tagged", ["-a", "tlen:max=300;coverage:bin=100,bins=16,cap=4",
                "-i", "chr1:50-900,chr2", "--flags-forbidden", "16"]),
    ("tagged", ["-t", "NM", "-t", "RG", "--format", "json"]),
    ("tagged", ["--flags-required", "2048"]),
    ("plain", ["-m", "64k"]),
    ("plain", ["-a", "mapq;coverage:bin=50000", "--flags-required", "4",
               "--format", "json"]),
], ids=["tsv", "json", "spec", "loci_flags", "tags_json", "empty",
        "plain_tsv", "plain_json"])
def test_report_matches_jax(bams, tmp_path, bam, args):
    path = bams[bam]
    got, want = tmp_path / "port.out", tmp_path / "jax.out"
    assert main(["aggregate", "--device", "cpu", *args, "-o", str(got),
                 path]) == 0
    assert jmain(["aggregate", *args, "-o", str(want), path]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes()


def test_stdout_matches_jax(bams, capsys):
    assert main(["aggregate", "--device", "cpu", bams["tagged"]]) == 0
    got = capsys.readouterr()
    assert jmain(["aggregate", bams["tagged"]]) == 0
    want = capsys.readouterr()
    assert got.out == want.out and got.out.startswith("count\trecords\t240")
    assert got.err.startswith("aggregated 240 rows [count;flagstat;mapq;"
                              "tlen;coverage] in ")


@pytest.mark.parametrize("args", [
    ["-a", "bogus"], ["-a", "tlen:max=0"], ["-i", "chr1:9-3"],
    ["-t", "NMX"]], ids=["spec", "param", "loci", "tag"])
def test_usage_error_matches_jax(bams, capsys, args):
    assert main(["aggregate", "--device", "cpu", *args, bams["tagged"]]) == 2
    got = capsys.readouterr()
    assert jmain(["aggregate", *args, bams["tagged"]]) == 2
    want = capsys.readouterr()
    assert got.out == want.out == ""
    err = [ln for ln in got.err.splitlines() if ln.startswith("error:")]
    assert err and err == [ln for ln in want.err.splitlines()
                           if ln.startswith("error:")]


def test_refuses_without_cuda(bams):
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["aggregate", bams["tagged"]])
