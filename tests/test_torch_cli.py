"""``python -m spark_bam_tpu_torch count-reads``: the output format of the
reference CLI's standalone count, and its refusal to run without CUDA."""

import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

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


@pytest.mark.parametrize("iterations", [1, 2])
def test_count_reads_output_format(bam, capsys, iterations):
    assert cli.main(["count-reads", "-n", str(iterations), "--device", "cpu",
                     str(bam)]) == 0
    lines = capsys.readouterr().out.split("\n")
    want = count_reads_streaming(bam, JaxConfig(), use_device=False)
    for i in range(iterations):
        assert re.fullmatch(r"spark-bam read-count time: \d+", lines[3 * i])
        assert lines[3 * i + 1] == f"Read count: {want}"
        assert lines[3 * i + 2] == ""
    funnel = lines[3 * iterations]
    m = re.fullmatch(r"funnel: on \(auto\): (\d+) positions -> (\d+) "
                     r"survivors, (\d+\.\d)x reduction", funnel)
    assert m, funnel
    assert int(m.group(1)) > int(m.group(2)) > 0
    assert lines[3 * iterations + 1:] == ["", ""]


def test_funnel_line_without_stats():
    assert cli.funnel_status_line(cli.Config(), None) == "funnel: on (auto)"


def test_count_reads_returns_count(bam):
    out = io.StringIO()
    got = cli.count_reads(bam, device="cpu", out=out)
    assert got == count_reads_streaming(bam, JaxConfig(), use_device=False)
    assert f"Read count: {got}" in out.getvalue()


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
