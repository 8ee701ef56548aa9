"""The port's split-planning commands against the JAX CLI, on the CPU:
``compute-splits`` (``-s``, ``-u``, the default comparison, ``--plan-hosts``,
cold and warm through the ``.sbi`` cache) prints the JAX CLI's report but
for its two timing lines; ``index`` (with and without ``--record-starts``),
``index-blocks`` and ``index-records`` write the same sidecar bytes.

Where the last raw split holds only the EOF sentinel, the JAX CLI's
hadoop-bam side raises ``KeyError`` (its seqdoop ``next_read_start`` looks
the sentinel up in a flat view without it); there the port's report
equals the JAX CLI's with that lookup answering "no record" instead."""

import os
import shutil

import pytest

from spark_bam_tpu.check.seqdoop import SeqdoopChecker as JaxSeqdoop
from spark_bam_tpu.cli.main import main as jax_main
from spark_bam_tpu.sbi.store import reset_cache_events as jax_reset_events
from spark_bam_tpu_torch.cli import main
from spark_bam_tpu_torch.load import boundary
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: (seed, split size) whose last raw split is the EOF sentinel alone.
SENTINEL_ONLY = {(3, "16384"), (3, "50000"), (7, "16384")}


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_splits_cli")
    out = {}
    for seed in (3, 7, 11):
        out[seed] = str(d / f"s{seed}.bam")
        random_bam(out[seed], seed=seed)
    return out


@pytest.fixture(autouse=True)
def no_cache_env(monkeypatch):
    monkeypatch.delenv("SPARK_BAM_CACHE", raising=False)
    monkeypatch.delenv("SPARK_BAM_CACHE_DIR", raising=False)


def _report(path) -> list[str]:
    lines = open(path).read().split("\n")
    timing = [ln for ln in lines if ln.startswith("Get ")]
    assert all(ln.endswith("ms") for ln in timing), timing
    return [ln for ln in lines if not ln.startswith("Get ")]


def _jax_skips_sentinel(monkeypatch):
    """The JAX seqdoop lookup answering "no record" past the last data
    block, as the port's does."""
    real = JaxSeqdoop.next_read_start

    def next_read_start(self, start, max_read_size=10_000_000):
        if start.block_pos > self.view.block_starts[-1]:
            return None
        return real(self, start, max_read_size)

    monkeypatch.setattr(JaxSeqdoop, "next_read_start", next_read_start)


def _both(tmp_path, args, path, monkeypatch=None, fix_jax=False):
    port_out, jax_out = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert main(["compute-splits", *args, "--device", "cpu", "-o",
                 str(port_out), path]) == 0
    if fix_jax:
        _jax_skips_sentinel(monkeypatch)
    assert jax_main(["compute-splits", *args, "-o", str(jax_out),
                     path]) == 0
    return _report(port_out), _report(jax_out)


@pytest.mark.parametrize("mode", ["-s", "-u", "default"])
@pytest.mark.parametrize("split", ["16384", "50000", "1MB"])
@pytest.mark.parametrize("seed", [3, 7, 11])
def test_compute_splits_equals_jax(bams, tmp_path, monkeypatch, seed, split,
                                   mode):
    args = ["-m", split] + ([] if mode == "default" else [mode])
    sentinel = (seed, split) in SENTINEL_ONLY and mode != "-s"
    if sentinel:
        with pytest.raises(KeyError, match="not in view"):
            jax_main(["compute-splits", *args, "-o",
                      str(tmp_path / "x.txt"), bams[seed]])
    got, want = _both(tmp_path, args, bams[seed], monkeypatch,
                      fix_jax=sentinel)
    assert got == want
    assert any(ln.startswith(("All splits matched!", "Split-size",
                              "First 10 of")) for ln in got), got


@pytest.mark.parametrize("extra", [["--plan-hosts", "2"],
                                   ["--plan-hosts", "3",
                                    "--devices-per-host", "2", "-l", "4"]])
def test_compute_splits_host_plan(bams, tmp_path, extra):
    got, want = _both(tmp_path, ["-s", "-m", "50000", *extra], bams[11])
    assert got == want and any("-host plan" in ln for ln in got)


@pytest.mark.parametrize("mode", ["-s", "default"])
def test_compute_splits_cold_then_warm(bams, tmp_path, monkeypatch, mode):
    """Each side under its own SPARK_BAM_CACHE_DIR: a cold run writes the
    plan, the warm run reads it with no boundary resolution."""
    path = str(tmp_path / "c.bam")
    shutil.copyfile(bams[11], path)
    args = ["--cache", "readwrite", "-m", "50000"] + (
        [mode] if mode != "default" else [])
    runs = {}
    for side, run in (("jax", jax_main), ("port", main)):
        monkeypatch.setenv("SPARK_BAM_CACHE_DIR", str(tmp_path / side))
        outs = []
        for i in range(2):
            boundary.STATS.reset()
            out = tmp_path / f"{side}{i}.txt"
            dev = ["--device", "cpu"] if side == "port" else []
            jax_reset_events()
            assert run(["compute-splits", *args, *dev, "-o", str(out),
                        path]) == 0
            outs.append(_report(out))
            if side == "port":
                assert (boundary.STATS.resolutions == 0) == bool(i)
        runs[side] = outs
    assert runs["port"] == runs["jax"]
    assert "cache: miss (no .sbi sidecar); written (" in runs["port"][0][0]
    assert runs["port"][1][0] == "cache: hit (fingerprint ok)"


def test_bad_cache_mode_is_a_usage_error(bams, capsys):
    assert main(["compute-splits", "--cache", "sideways", "--device", "cpu",
                 bams[7]]) == 2
    assert "Unknown cache mode 'sideways'" in capsys.readouterr().err
    assert jax_main(["compute-splits", "--cache", "sideways", bams[7]]) == 2


@pytest.mark.parametrize("record_starts", [False, True],
                         ids=["plan", "record_starts"])
def test_index_sidecar_bytes_equal_jax(bams, tmp_path, capsys,
                                       record_starts):
    """``-o`` names the sidecar. (The JAX CLI also opens ``-o`` as its
    report file, so its ``Wrote`` line lands in the file the sidecar then
    replaces; the port prints the line.)"""
    extra = ["--record-starts"] if record_starts else []
    port_sbi, jax_sbi = tmp_path / "port.sbi", tmp_path / "jax.sbi"
    assert main(["index", "-m", "50000", *extra, "--device", "cpu", "-o",
                 str(port_sbi), bams[7]]) == 0
    got = capsys.readouterr().out
    assert jax_main(["index", "-m", "50000", *extra, "-o", str(jax_sbi),
                     bams[7]]) == 0
    assert port_sbi.read_bytes() == jax_sbi.read_bytes()
    assert got == (f"Wrote {port_sbi}: 32 blocks, split plan @48.8KB (13 "
                   "boundaries, 13 resolved)"
                   + (", 386 record starts" if record_starts else "") + "\n")


def test_index_into_the_store_then_warm_split_plan(bams, tmp_path, capsys,
                                                   monkeypatch):
    """``index`` with no ``-o`` places the sidecar where the store looks;
    the same bytes as the JAX CLI's there, and a warm plan from it."""
    path = str(tmp_path / "i.bam")
    shutil.copyfile(bams[3], path)
    assert jax_main(["index", "-m", "16384", "--record-starts", path]) == 0
    want = open(path + ".sbi", "rb").read()
    jax_out = capsys.readouterr().out
    os.unlink(path + ".sbi")
    assert main(["index", "-m", "16384", "--record-starts", "--device",
                 "cpu", path]) == 0
    got = capsys.readouterr().out
    assert got == jax_out and got.startswith(f"Wrote {path}.sbi: ")
    assert open(path + ".sbi", "rb").read() == want
    monkeypatch.setattr(boundary, "next_read_start", None)
    assert main(["compute-splits", "-s", "-m", "16384", "--cache", "read",
                 "--device", "cpu", path]) == 0
    assert "cache: hit (fingerprint ok)" in capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["index-blocks", "index-records"])
def test_index_blocks_and_records_equal_jax(bams, tmp_path, capsys, cmd):
    got, want = tmp_path / "port", tmp_path / "jax"
    assert main([cmd, "-o", str(got), bams[11]]) == 0
    port_err = capsys.readouterr().err.replace(str(got), "OUT")
    assert jax_main([cmd, "-o", str(want), bams[11]]) == 0
    jax_err = capsys.readouterr().err.replace(str(want), "OUT")
    assert got.read_bytes() == want.read_bytes() and got.read_bytes()
    assert port_err.splitlines()[-1] == jax_err.splitlines()[-1]
