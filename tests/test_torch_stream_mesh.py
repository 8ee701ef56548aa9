"""The port's sharded streaming workloads against the JAX package's.

``count_reads_sharded``, ``check_bam_sharded`` and
``full_check_summary_sharded`` (and their ``stats_out``) on random BAMs
(seeds 3 and 11, as the JAX package's own mesh tests) at 1, 2 and 4
devices, rows of 128 KiB with a 32 KiB halo: the JAX side on
``jax.devices()[:n]``, the port on ``make_mesh(["cpu"] * n)``, equal
exactly. Rows come from host zlib here (device-inflated rows, long reads
and step buffering: ``test_torch_stream_mesh_escapes.py``). A 16-site
compaction falls back to the streaming summary; ``host_shard_plan``, the
row arithmetic and slicing, and the ``.records`` files equal the JAX
package's.
"""

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
    Mesh,
    check_bam_sharded,
    count_reads_sharded,
    full_check_summary_sharded,
    full_check_summary_streaming,
    host_shard_plan,
    make_mesh,
)
from spark_bam_tpu_torch.bam.index_records import index_records
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.parallel import stream_mesh as psm
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
    """The port's ``stats_out`` holds the JAX keys, equal, and reports no
    tokenizer demotion."""
    assert {k: port[k] for k in want} == want
    assert port["tokenize_demotions"] == 0


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_stream_mesh")
    out = {}
    for seed in (3, 11):
        p = d / f"fz{seed}.bam"
        random_bam(p, seed=seed, n_records=(200, 400), read_len=(10, 6000),
                   mapped_rate=0.7)
        index_records(p)
        out[seed] = str(p)
    return out


@pytest.fixture(scope="module")
def jax_results(bams):
    """The three JAX workloads per (seed, devices), computed once."""
    cache = {}

    def get(seed, n):
        if (seed, n) not in cache:
            p, jm = bams[seed], jmesh.make_mesh(jax.devices()[:n])
            cs, fs = {}, {}
            cache[seed, n] = (
                jsm.count_reads_sharded(p, JaxConfig(), mesh=jm, stats_out=cs,
                                        **GEO), cs,
                jsm.check_bam_sharded(p, JaxConfig(), mesh=jm, **GEO),
                jsm.full_check_summary_sharded(p, JaxConfig(), mesh=jm,
                                               stats_out=fs, **GEO), fs)
        return cache[seed, n]

    return get


def _port_results(path, config, n, **kw):
    mesh = make_mesh(["cpu"] * n)
    cs, bs, fs = {}, {}, {}
    return (count_reads_sharded(path, config, mesh=mesh, stats_out=cs, **GEO,
                                **kw), cs,
            check_bam_sharded(path, config, mesh=mesh, stats_out=bs, **GEO,
                              **kw),
            full_check_summary_sharded(path, config, mesh=mesh, stats_out=fs,
                                       **GEO, **kw), fs, bs)


@pytest.mark.parametrize("seed,n", [(3, 1), (3, 2), (3, 4), (11, 1),
                                    (11, 4)])
def test_workloads_match_jax(bams, jax_results, seed, n):
    count, cstats, check, full, fstats = jax_results(seed, n)
    got = _port_results(bams[seed], HOST, n)
    assert got[0] == count
    _stats_equal(got[1], cstats)
    assert got[2] == check and check["devices"] == n
    _summaries_equal(got[3], full)
    _stats_equal(got[4], fstats)
    assert got[5]["fallback"] is False and got[5]["tokenize_demotions"] == 0
    assert check["false_positives"] == check["false_negatives"] == 0
    assert check["true_positives"] == count


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """Short reads: about 2,270 two-check sites a MiB, more than 16 in
    every 128 KiB row."""
    p = tmp_path_factory.mktemp("torch_dense") / "d.bam"
    synth_bam(p, 1 << 20, seed=7, unit_reads=2048)
    return str(p)


def test_compaction_overflow_falls_back(dense):
    path = dense
    want = jsm.full_check_summary_sharded(
        path, JaxConfig(), mesh=jmesh.make_mesh(jax.devices()[:2]),
        k_positions=16, **GEO)
    stats = {}
    got = full_check_summary_sharded(path, HOST, mesh=make_mesh(["cpu"] * 2),
                                     k_positions=16, stats_out=stats, **GEO)
    assert want["devices"] == got["devices"] == 1 and stats["fallback"]
    _summaries_equal(got, want)
    got.pop("devices")
    _summaries_equal(got, full_check_summary_streaming(
        path, HOST, device="cpu", **GEO))


def test_mostly_dirty_matches_jax():
    for steps in range(12):
        for n_dirty in range(steps + 1):
            dirty = list(range(n_dirty))
            assert psm._mostly_dirty(dirty, steps) == jsm._mostly_dirty(
                dirty, steps), (n_dirty, steps)
    assert not psm._mostly_dirty([1, 2, 3], 3)
    assert psm._mostly_dirty([1, 2, 3, 4], 4)
    assert psm._mostly_dirty(list(range(9)), 10)
    assert not psm._mostly_dirty(list(range(8)), 10)


@pytest.mark.parametrize("hosts", [1, 2, 4])
@pytest.mark.parametrize("window", [128 << 10, 1 << 30])
def test_host_shard_plan_matches_jax(bams, hosts, window):
    kw = dict(num_hosts=hosts, devices_per_host=2,
              window_uncompressed=window, halo=32 << 10)
    got = host_shard_plan(bams[3], **kw)
    assert got == jsm.host_shard_plan(bams[3], **kw)
    groups = [g for p in got for g in range(*p["groups"])]
    assert groups == list(range(len(groups)))
    if window == 1 << 30:   # one group: host 0 owns it, the rest idle
        assert got[0]["groups"] == (0, 1)


def test_plan_rows_matches_jax(bams):
    from spark_bam_tpu.bgzf.index_blocks import blocks_metadata as jax_metas
    from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata

    metas, jm = blocks_metadata(bams[11]), list(jax_metas(bams[11]))
    for fresh in (64 << 10, 128 << 10, 1 << 30):
        for n_global, procs in ((1, 1), (4, 2), (8, 4), (3, 3)):
            got = psm._plan_rows(metas, fresh, n_global, procs)
            want = jsm._plan_rows(jm, fresh, n_global, procs)
            for g, w in zip(got[1:], want[1:]):
                assert np.array_equal(g, w)
            assert [len(g) for g in got[0]] == [len(g) for g in want[0]]


def test_process_slicing_covers_every_group_once(bams):
    mesh = make_mesh(["cpu"] * 4)
    whole = psm._ShardedStream(bams[3], HOST, mesh, 64 << 10, 16 << 10, None)
    owned = []
    for pid in range(2):
        st = psm._ShardedStream(bams[3], HOST, mesh, 64 << 10, 16 << 10,
                                None, num_processes=2, process_id=pid)
        assert st.per_proc * 2 == -(-len(st.groups) // 4) * 4
        assert st.step_rows_local % 2 == 0
        owned += [pid * st.per_proc + j for j in range(st.per_proc)
                  if pid * st.per_proc + j < len(st.groups)]
        steps = range(0, st.per_proc, st.step_rows_local)
        assert sorted(g for c0 in steps
                      for g in psm._step_global_rows(st, c0)) == list(
            range(len(st.groups)))
    assert sorted(owned) == list(range(len(whole.groups)))


def test_index_records_matches_jax(bams, dense, tmp_path):
    for path in (*bams.values(), dense):
        want, n = jax_index(path, tmp_path / "want.records")
        got, m = index_records(path, tmp_path / "got.records")
        assert n == m > 0
        with open(got, "rb") as g, open(want, "rb") as w:
            assert g.read() == w.read()


def test_stream_checker_metas_unchanged(bams):
    """``metas=`` reuses a block scan; the results are the same."""
    from spark_bam_tpu_torch import StreamChecker
    from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata

    path = bams[11]
    metas = blocks_metadata(path)
    a = StreamChecker(path, HOST, device="cpu", **GEO)
    b = StreamChecker(path, HOST, device="cpu", metas=metas, **GEO)
    assert b.pipeline.metas == metas and b.total == a.total
    assert a.count_reads() == b.count_reads()
    _summaries_equal(
        full_check_summary_streaming(path, HOST, device="cpu", **GEO),
        full_check_summary_streaming(path, HOST, device="cpu", metas=metas,
                                     **GEO))


def test_full_check_is_single_process(bams):
    """As in the reference, full-check refuses a mesh of several
    processes (their site lists would need an all-gather)."""
    two_procs = Mesh((torch.device("cpu"),), num_processes=2, process_id=1)
    with pytest.raises(NotImplementedError, match="single-process"):
        full_check_summary_sharded(bams[11], HOST, mesh=two_procs, **GEO)
