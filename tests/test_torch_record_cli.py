"""The record path's commands against the JAX CLI: ``check-bam`` (default,
``-s``, ``-u``, ``-i``), ``check-blocks``, ``compare-splits``,
``time-load`` and the default ``count-reads`` print the JAX CLI's output
line for line, but for two things the normalisation below rewrites: the
timing numbers (and the ratios compare-splits derives from them) and an
exception's module path (``spark_bam_tpu_torch.`` for
``spark_bam_tpu.``). Inputs: random BAMs with their ``.records``
sidecars, the refused-record BAM (601 records, which both count), and a
BAM whose fake record trips hadoop-bam's guesser into an exception or a
wrong count. Split sizes keep every raw split off a last block that holds
only the EOF sentinel, where the JAX package's guesser raises (a fault of
the reference, pinned on its own below)."""

import contextlib
import io
import re

import pytest

from spark_bam_tpu.cli.main import main as jax_main
from spark_bam_tpu_torch import cli
from spark_bam_tpu_torch.bam.index_records import index_records
from spark_bam_tpu_torch.benchmarks import load_cases
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_record_cli")
    out = {"dir": d}
    out["rand"] = str(d / "rand.bam")
    random_bam(out["rand"], seed=61, read_len=(10, 300), index=True)
    out["long"] = str(d / "long.bam")
    random_bam(out["long"], seed=62, n_records=(60, 90),
               read_len=(10, 4000), index=True)
    out["refused"] = str(d / "refused.bam")
    load_cases.write_refused_mid_bam(out["refused"])
    for mate in (True, False):
        name = f"trap{int(mate)}"
        out[name] = str(d / f"{name}.bam")
        out[name + "_block"] = load_cases.write_seqdoop_trap_bam(
            out[name], mate_set=mate)["trap_block"]
    for name in ("refused", "trap0", "trap1"):
        index_records(out[name])
    out["list"] = str(d / "bams.txt")
    with open(out["list"], "w") as f:
        f.write("\n".join([out["rand"], out["refused"], out["trap0"], ""]))
    return out


def _normalise(text: str) -> str:
    text = re.sub(r"(time: )\d+", r"\1N", text)
    text = re.sub(r"(\t(?:hadoop|spark)-bam:\t)\d+", r"\1N", text)
    # compare-splits' ratios are quotients of its timings.
    text = re.sub(r"Ratios?:.*?\n\n", "Ratio: R\n\n", text, flags=re.S)
    return text.replace("spark_bam_tpu_torch.", "spark_bam_tpu.")


def _port(*argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([argv[0], "--device", "cpu", *argv[1:]]) == 0
    return buf.getvalue()


def _jax(tmp_path, *argv) -> str:
    out = tmp_path / "jax.txt"
    assert jax_main([*argv, "-o", str(out)]) == 0
    return out.read_text()


def _same(tmp_path, *argv) -> str:
    got = _port(*argv)
    assert _normalise(got) == _normalise(_jax(tmp_path, *argv))
    return got


@pytest.mark.parametrize("name", ["rand", "long", "refused", "trap0"])
@pytest.mark.parametrize("flags", [[], ["-s"], ["-u"], ["-i", "0-20000"],
                                   ["-l", "3"], ["-i", "10k+30k,70k"]])
def test_check_bam_equals_jax(bams, tmp_path, name, flags):
    got = _same(tmp_path, "check-bam", *flags, bams[name])
    assert "uncompressed positions" in got


@pytest.mark.parametrize("name", ["rand", "long", "refused", "trap0"])
@pytest.mark.parametrize("flags", [[], ["-s"], ["-u"], ["-i", "0-20000"],
                                   ["-l", "2"]])
def test_check_blocks_equals_jax(bams, tmp_path, name, flags):
    _same(tmp_path, "check-blocks", *flags, bams[name])


def test_check_bam_finds_what_seqdoop_misses(bams, tmp_path):
    """The trap's fake record is a false positive of seqdoop's only."""
    got = _same(tmp_path, "check-bam", bams["trap0"])
    assert "false positives" in got and "fa@ke" not in got


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("name,split", [("rand", None), ("rand", "16KB"),
                                        ("long", "32KB"), ("refused", None),
                                        ("refused", "8KB")])
def test_count_reads_equals_jax(bams, tmp_path, name, split, iterations):
    flags = ["-n", str(iterations)] + (["-m", split] if split else [])
    got = _same(tmp_path, "count-reads", *flags, bams[name])
    assert got.count("Read counts matched:") == iterations


def test_count_reads_where_the_reference_guesser_raises(bams, tmp_path):
    """A fault of the reference, not copied: when the last raw split holds
    only the EOF sentinel, the JAX package's seqdoop guesser raises
    ``KeyError`` and its hadoop-bam leg throws; the port's guesser finds
    no record there (``PLAN_NONE``), so its counts match."""
    from spark_bam_tpu_torch.benchmarks.split_cases import sentinel_split_size

    path = bams["long"]
    split = str(sentinel_split_size(path))
    got = _port("count-reads", "-m", split, path)
    want = _jax(tmp_path, "count-reads", "-m", split, path)
    n = re.search(r"Read counts matched: (\d+)", got).group(1)
    assert (f"spark-bam found {n} reads, hadoop-bam threw exception:\n"
            "builtins.KeyError: 'block ") in want
    assert got.splitlines()[1].startswith("hadoop-bam read-count time: ")


def test_count_reads_refused_mid_bam_matches_601(bams, tmp_path):
    got = _same(tmp_path, "count-reads", bams["refused"])
    assert "Read counts matched: 601" in got.splitlines()


@pytest.mark.parametrize("mate", [1, 0])
def test_count_reads_against_a_tripped_hadoop_bam(bams, tmp_path, mate):
    """With the fake's mate fields set, hadoop-bam's reader throws at the
    trapped split; without them it counts records past it twice."""
    name = f"trap{mate}"
    got = _same(tmp_path, "count-reads", "-m", str(bams[name + "_block"]),
                bams[name])
    if mate:
        assert ("spark_bam_tpu_torch.load.hadoop.BamFormatError: SAM "
                "validation error") in got
        assert "spark-bam found 401 reads, hadoop-bam threw exception:" in got
    else:
        assert "Read counts mismatched: 401 via spark-bam" in got


@pytest.mark.parametrize("name,split", [("rand", "16KB"), ("rand", None),
                                        ("refused", "8KB"), ("long", "32KB"),
                                        ("trap1", "trap"), ("trap0", "trap")])
def test_time_load_equals_jax(bams, tmp_path, name, split):
    if split == "trap":
        split = str(bams[name + "_block"])
    flags = ["-m", split] if split else []
    got = _same(tmp_path, "time-load", *flags, bams[name])
    assert "spark-bam first-read collection time" in got


@pytest.mark.parametrize("split", ["12KB", "24KB"])
def test_compare_splits_equals_jax(bams, tmp_path, split):
    got = _same(tmp_path, "compare-splits", "-m", split, bams["list"])
    assert "BAMs' splits" in got


def test_report_goes_to_the_out_file(bams, tmp_path, capsys):
    out = tmp_path / "port.txt"
    assert cli.main(["check-blocks", "--device", "cpu", "-o", str(out),
                     bams["rand"]]) == 0
    assert capsys.readouterr().out == ""
    assert _normalise(out.read_text()) == _normalise(
        _jax(tmp_path, "check-blocks", bams["rand"]))


def test_bad_ranges_are_usage_errors(bams, capsys):
    assert cli.main(["check-bam", "--device", "cpu", "-i", "20-10",
                     bams["rand"]]) == 2
    assert "error: Bad range" in capsys.readouterr().err
