"""``python -m spark_bam_tpu_torch`` ``count-reads --sharded``,
``full-check --sharded`` and ``check-bam --sharded`` against the JAX CLI
(``count-reads --sharded``, ``full-check --streaming --sharded``,
``check-bam --sharded``) on the same file: every line equal but the
timing of the count; check-bam's report whole, its ``.sbi`` cache line
included. The JAX CLI runs on the eight
virtual CPU devices the test configuration sets up, the port's on
``--device cpu --devices 8``. Without CUDA, and without a CPU mesh, the
sharded entry points refuse.
"""

import io
import os
import re

import pytest
import torch

from spark_bam_tpu.cli.main import main as jax_main
from spark_bam_tpu_torch import (
    Config,
    check_bam_sharded,
    cli,
    count_reads_sharded,
    full_check_summary_sharded,
    make_mesh,
)
from spark_bam_tpu_torch.bam.index_records import index_records
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_sharded_cli") / "c.bam"
    random_bam(p, seed=61, read_len=(10, 300))
    index_records(p)
    return str(p)


def _jax_cli(tmp_path, *argv) -> list[str]:
    out = tmp_path / "jax.txt"
    assert jax_main([*argv, "-o", str(out)]) == 0
    return out.read_text().split("\n")


def _port_cli(capsys, *argv) -> list[str]:
    assert cli.main([*argv, "--device", "cpu", "--devices", "8"]) == 0
    return capsys.readouterr().out.split("\n")


def test_count_reads_sharded_output(small, tmp_path, capsys):
    want = _jax_cli(tmp_path, "count-reads", "--sharded", small)
    got = _port_cli(capsys, "count-reads", "--sharded", small)
    assert re.fullmatch(r"spark-bam read-count time: \d+", got[0])
    assert got[1:] == want[1:] and want[1].startswith("Read count: ")


@pytest.mark.parametrize("limit", [None, 2])
def test_full_check_sharded_output(small, tmp_path, capsys, limit):
    extra = [] if limit is None else ["-l", str(limit)]
    want = _jax_cli(tmp_path, "full-check", "--streaming", "--sharded",
                    *extra, small)
    assert _port_cli(capsys, "full-check", "--sharded", *extra,
                     small) == want


def test_check_bam_sharded_output(small, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("SPARK_BAM_CACHE", raising=False)
    want = _jax_cli(tmp_path, "check-bam", "--sharded", small)
    got = _port_cli(capsys, "check-bam", "--sharded", small)
    assert got == want
    assert got.count("cache: off (enable with --cache readwrite; "
                     "docs/caching.md)") == 1
    assert "checked across 8 device(s)" in got and "All calls matched!" in got


@pytest.mark.parametrize("indexed", [False, True], ids=["miss", "hit"])
def test_check_bam_sharded_cache_probe(small, tmp_path, capsys, indexed):
    """``--cache read``: the line probes the sidecar check-bam does not
    consume (the same path, state and sections on both sides)."""
    if indexed:
        assert cli.main(["index", "-m", "64k", "--device", "cpu", small]) == 0
        capsys.readouterr()
    try:
        want = _jax_cli(tmp_path, "check-bam", "--sharded", "--cache", "read",
                        small)
        got = _port_cli(capsys, "check-bam", "--sharded", "--cache", "read",
                        small)
    finally:
        if indexed:
            os.unlink(small + ".sbi")
    assert got == want
    line = [ln for ln in got if ln.startswith("cache: ")]
    assert line == [f"cache: hit (5 blocks; split plans for {64 << 10})"
                    if indexed else f"cache: miss (no sidecar at {small}.sbi;"
                    " build with 'index')"]


def test_cli_refuses_what_it_cannot_serve(small, capsys):
    """check-bam without --sharded runs (eager against seqdoop); the
    sharded path refuses -u and -i, and --resident with --sharded, as the
    reference does."""
    assert cli.main(["check-bam", "--device", "cpu", small]) == 0
    out = capsys.readouterr().out
    assert "uncompressed positions" in out
    assert "funnel: off (auto: host engine, no device hot path)" in out
    assert cli.main(["check-bam", "--sharded", "-u", "--device", "cpu",
                     small]) == 2
    assert "no sharded path" in capsys.readouterr().err
    assert cli.main(["check-bam", "--sharded", "-i", "0-100", "--device",
                     "cpu", small]) == 2
    assert "not supported on the sharded path" in capsys.readouterr().err
    assert cli.main(["count-reads", "--sharded", "--resident", "--device",
                     "cpu", small]) == 2
    assert "mutually exclusive" in capsys.readouterr().err


def test_entry_points_raise_without_cuda(small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (count_reads_sharded, check_bam_sharded,
               full_check_summary_sharded):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(small, Config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.count_reads(small, out=io.StringIO(), sharded=True)
    with pytest.raises(ValueError, match="num_processes"):
        count_reads_sharded(small, Config(), mesh=make_mesh(["cpu"]),
                            num_processes=2)
