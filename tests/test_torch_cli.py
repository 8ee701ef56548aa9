"""``python -m spark_bam_tpu_torch count-reads`` and ``full-check``: the
output of the reference CLI (the default count, spark-bam's record path
against hadoop-bam's, but for its times; ``full-check --streaming`` byte
for byte), and the refusal to run without CUDA."""

import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from spark_bam_tpu.cli.main import main as jax_main
from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.tpu.stream_check import count_reads_streaming
from spark_bam_tpu_torch import cli
from tests.bam_factories import random_bam

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_cli") / "c.bam"
    random_bam(p, seed=61, read_len=(10, 300))
    return p


def _untimed(text: str) -> str:
    return re.sub(r"(read-count time: )\d+", r"\1N", text)


@pytest.mark.parametrize("iterations", [1, 2])
def test_count_reads_output_format(bam, capsys, tmp_path, iterations):
    assert cli.main(["count-reads", "-n", str(iterations), "--device", "cpu",
                     str(bam)]) == 0
    got = capsys.readouterr().out
    lines = got.split("\n")
    want = count_reads_streaming(bam, JaxConfig(), use_device=False)
    for i in range(iterations):
        assert re.fullmatch(r"spark-bam read-count time: \d+", lines[5 * i])
        assert re.fullmatch(r"hadoop-bam read-count time: \d+",
                            lines[5 * i + 1])
        assert lines[5 * i + 2] == ""
        assert lines[5 * i + 3] == f"Read counts matched: {want}"
        assert lines[5 * i + 4] == ""
    assert lines[5 * iterations:] == [""]
    out = tmp_path / "jax.txt"
    assert jax_main(["count-reads", "-n", str(iterations), str(bam), "-o",
                     str(out)]) == 0
    assert _untimed(got) == _untimed(out.read_text())


def test_funnel_line_without_stats():
    assert cli.funnel_status_line(cli.Config(), None) == "funnel: on (auto)"


@pytest.mark.parametrize("mode,full_masks,want", [
    ("auto", True, "funnel: off (auto: full per-position flag masks "
                   "requested)"),
    ("on", True, "funnel: off (on: full per-position flag masks requested)"),
    ("off", False, "funnel: off (off: disabled)"),
    ("on", False, "funnel: on (on)"),
])
def test_funnel_line_matches_jax(mode, full_masks, want):
    from spark_bam_tpu.cli.app import funnel_status_line as jax_line

    got = cli.funnel_status_line(cli.Config(funnel=mode), None, full_masks)
    assert got == want == jax_line(JaxConfig(funnel=mode),
                                   full_masks=full_masks)


def _jax_full_check(path, tmp_path, *extra) -> str:
    out = tmp_path / "jax.txt"
    assert jax_main(["full-check", "--streaming", *extra, str(path),
                     "-o", str(out)]) == 0
    return out.read_text()


@pytest.mark.parametrize("fixture", ["bam1", "bam2", "bam"])
@pytest.mark.parametrize("limit", [None, 3, 0])
def test_full_check_output_matches_jax(request, tmp_path, fixture, limit):
    path = request.getfixturevalue(fixture)
    extra = [] if limit is None else ["-l", str(limit)]
    want = _jax_full_check(path, tmp_path, *extra)
    out = io.StringIO()
    cli.full_check(path, 10 if limit is None else limit, device="cpu",
                   out=out)
    assert out.getvalue() == want
    assert want.rstrip("\n").endswith(
        "funnel: off (auto: full per-position flag masks requested)")


def test_full_check_main_prints_report(bam, capsys, tmp_path):
    assert cli.main(["full-check", "-l", "2", "--device", "cpu",
                     str(bam)]) == 0
    assert capsys.readouterr().out == _jax_full_check(bam, tmp_path, "-l",
                                                      "2")


def test_count_reads_returns_count(bam):
    from spark_bam_tpu.load.api import load_bam as jax_load_bam

    out = io.StringIO()
    got = cli.count_reads(bam, device="cpu", out=out)
    assert got == count_reads_streaming(bam, JaxConfig(), use_device=False)
    assert got == jax_load_bam(bam).count()
    assert f"Read counts matched: {got}" in out.getvalue()


def test_module_entry_point_refuses_without_cuda(bam):
    """The default device is the GPU; with no CUDA device visible the CLI
    exits non-zero with the reason, and prints no count."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "spark_bam_tpu_torch", "count-reads", str(bam)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "Read count" not in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "spark_bam_tpu_torch", "full-check", str(bam)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout == ""
