"""The port's sharded workloads where rows need more than one pass:
long reads whose chains outrun the halo (escaped steps re-derived exactly
on the host, with the JAX package's ``stats_out``), rows inflated on the
device (the tokenizer's plain version, a Python decoder) and demoted to
host zlib when the tokenizer rejects them, and many double-buffered
steps; each against the JAX package's result for the same file.
"""

import time

import jax
import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.index_records import index_records as jax_index
from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.parallel import mesh as jmesh
from spark_bam_tpu.parallel import stream_mesh as jsm
from spark_bam_tpu_torch import (
    Config,
    check_bam_sharded,
    count_reads_sharded,
    full_check_summary_sharded,
    make_mesh,
)
from spark_bam_tpu_torch.bam.index_records import index_records
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.parallel import mesh as pmesh
from spark_bam_tpu_torch.tpu import checker as ck
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEO = dict(window_uncompressed=128 << 10, halo=32 << 10)
HOST = Config(device_inflate=False)


def _summaries_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if hasattr(a[k], "shape"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _stats_equal(port: dict, want: dict) -> None:
    assert {k: port[k] for k in want} == want
    assert port["tokenize_demotions"] == 0


@pytest.fixture(scope="module")
def fz11(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_esc") / "fz11.bam"
    random_bam(p, seed=11, n_records=(200, 400), read_len=(10, 6000),
               mapped_rate=0.7)
    index_records(p)
    return str(p)


@pytest.fixture(scope="module")
def jax11(fz11):
    """The JAX workloads on two devices: count, its stats, check-bam, the
    full-check summary and its stats."""
    jm = jmesh.make_mesh(jax.devices()[:2])
    cs, fs = {}, {}
    return (jsm.count_reads_sharded(fz11, JaxConfig(), mesh=jm, stats_out=cs,
                                    **GEO), cs,
            jsm.check_bam_sharded(fz11, JaxConfig(), mesh=jm, **GEO),
            jsm.full_check_summary_sharded(fz11, JaxConfig(), mesh=jm,
                                           stats_out=fs, **GEO), fs)


def test_device_inflated_rows_match_jax(fz11, jax11):
    count, cstats, check, full, fstats = jax11
    mesh = make_mesh(["cpu"] * 2)
    cs, fs = {}, {}
    assert count_reads_sharded(fz11, Config(), mesh=mesh, stats_out=cs,
                               **GEO) == count
    _stats_equal(cs, cstats)
    assert check_bam_sharded(fz11, Config(), mesh=mesh, **GEO) == check
    got = full_check_summary_sharded(fz11, Config(), mesh=mesh,
                                     stats_out=fs, **GEO)
    _summaries_equal(got, full)
    _stats_equal(fs, fstats)


def test_many_steps_equal_one(fz11, jax11):
    """A chunk budget of one row per device splits the file into many
    steps; only the dirty ones are patched, and the results equal the
    one-step JAX run."""
    count, _, check, full, _ = jax11
    mesh = make_mesh(["cpu"] * 2)
    cs, fs = {}, {}
    assert count_reads_sharded(fz11, HOST, mesh=mesh, stats_out=cs,
                               chunk_bytes=1, **GEO) == count
    assert cs["steps"] == -(-cs["rows"] // 2) > 2
    assert 0 < cs["patched_steps"] < cs["steps"]
    assert check_bam_sharded(fz11, HOST, mesh=mesh, chunk_bytes=1,
                             **GEO) == check
    _summaries_equal(full_check_summary_sharded(
        fz11, HOST, mesh=mesh, stats_out=fs, chunk_bytes=1, **GEO), full)
    assert fs["steps"] == cs["steps"]


def test_step_buffers_not_overwritten_while_read(fz11, jax11, monkeypatch):
    """The worker thread assembles step i + 1 into the other buffer while
    step i runs: a step that reads its rows twice, slowly, sees the same
    bytes both times, and consecutive steps read different buffers."""
    mesh = make_mesh(["cpu"] * 2)
    real = pmesh.mesh_steps(mesh).count_step(10, True)
    seen = []

    def slow_step(windows, *rest):
        before = [w.clone() for w in windows]
        time.sleep(0.05)
        out = real(windows, *rest)
        time.sleep(0.05)
        assert all(torch.equal(a, b) for a, b in zip(before, windows))
        seen.append(windows[0].data_ptr())
        return out

    monkeypatch.setattr(pmesh.MeshSteps, "count_step",
                        lambda self, *a: slow_step)
    assert count_reads_sharded(fz11, HOST, mesh=mesh, chunk_bytes=1,
                               **GEO) == jax11[0]
    assert len(seen) > 2 and len(set(seen)) == 2
    assert all(a != b for a, b in zip(seen, seen[1:]))


def test_device_inflate_failure_raises(fz11, monkeypatch):
    """A failing device inflate raises; nothing falls back to host zlib."""
    def broken(staged, clens):
        raise RuntimeError("tokenize launch failed")

    monkeypatch.setattr(ck, "tokenize", broken)
    mesh = make_mesh(["cpu"] * 2)
    for fn in (count_reads_sharded, check_bam_sharded,
               full_check_summary_sharded):
        with pytest.raises(RuntimeError, match="tokenize launch failed"):
            fn(fz11, Config(), mesh=mesh, **GEO)


def test_tokenizer_rejection_demotes_the_row_exactly(fz11, jax11,
                                                     monkeypatch):
    """A tokenizer verdict of False re-inflates that row with host zlib,
    counted in ``tokenize_demotions``; the count stays exact."""
    real = ck.tokenize
    calls = []

    def rejecting(staged, clens):
        lit, dist, olens, ok = real(staged, clens)
        calls.append(1)
        return lit, dist, olens, ok & (len(calls) % 3 != 1)

    monkeypatch.setattr(ck, "tokenize", rejecting)
    stats = {}
    assert count_reads_sharded(fz11, Config(), mesh=make_mesh(["cpu"] * 2),
                               stats_out=stats, **GEO) == jax11[0]
    assert stats["tokenize_demotions"] == -(-len(calls) // 3) > 0


@pytest.fixture(scope="module")
def longread(tmp_path_factory):
    """Long reads (60-110 kb) at 256 KiB rows and a 64 KiB halo: chains
    outrun the halo at every seam."""
    p = tmp_path_factory.mktemp("torch_lr") / "lr.bam"
    manifest = synth_bam(p, 1200 << 10, seed=9, unit_reads=8,
                         read_len=(60_000, 110_000))
    jax_index(p)
    return str(p), manifest


LONG = dict(window_uncompressed=256 << 10, halo=64 << 10)


def test_long_reads_patch_exact(longread, tmp_path):
    path, manifest = longread
    jm, mesh = jmesh.make_mesh(jax.devices()[:2]), make_mesh(["cpu"] * 2)
    want_cs, got_cs = {}, {}
    want = jsm.count_reads_sharded(path, JaxConfig(), mesh=jm,
                                   stats_out=want_cs, **LONG)
    got = count_reads_sharded(path, HOST, mesh=mesh, stats_out=got_cs,
                              **LONG)
    assert got == want == manifest["reads"]
    _stats_equal(got_cs, want_cs)
    assert got_cs["escapes"] > 0 and got_cs["patched_steps"] > 0
    assert not got_cs["fallback"]

    bs = {}
    got = check_bam_sharded(path, HOST, mesh=mesh, stats_out=bs, **LONG)
    assert got == jsm.check_bam_sharded(path, JaxConfig(), mesh=jm, **LONG)
    assert bs["patched_steps"] > 0 and got["devices"] == 2
    assert got["true_positives"] == manifest["reads"]

    want_fs, got_fs = {}, {}
    want = jsm.full_check_summary_sharded(path, JaxConfig(), mesh=jm,
                                          stats_out=want_fs, **LONG)
    got = full_check_summary_sharded(path, HOST, mesh=mesh,
                                     stats_out=got_fs, **LONG)
    _summaries_equal(got, want)
    _stats_equal(got_fs, want_fs)
    assert got_fs["patched_steps"] > 0 and not got_fs["fallback"]

    _, n = index_records(path, tmp_path / "lr.records")
    with open(tmp_path / "lr.records") as a, open(path + ".records") as b:
        assert n == manifest["reads"] and a.read() == b.read()
