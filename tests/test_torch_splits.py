"""Split planning in the port (``load/boundary.py``, ``sbi/plan.py``,
``load/splits.py``) against the JAX package, on the CPU: the port's
per-boundary plan equals the JAX ``build_split_plan`` with its native scan
and with the Python checker (``backend="python"``), entry for entry, and
every resolved start is a true record start. Also the reference's
``_plan_vectorized`` fault on a sentinel-only last split, the growth
bound, and the cache around ``record_starts``, ``aggregate`` and
``blocks_metadata``: warm calls do no checker work."""

import os
import shutil

import numpy as np
import pytest

from spark_bam_tpu.bam.header import read_header as jax_read_header
from spark_bam_tpu.bam.index_records import index_records
from spark_bam_tpu.bgzf.index_blocks import blocks_metadata as jax_blocks
from spark_bam_tpu.cli.app import CheckerContext
from spark_bam_tpu.cli.splits_util import _plan_vectorized
from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu.load.splits import file_splits as jax_file_splits
from spark_bam_tpu.load.tpu_load import record_starts as jax_record_starts
from spark_bam_tpu.sbi.plan import build_split_plan as jax_build_split_plan
from spark_bam_tpu_torch import aggregate, record_starts
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bam.index_records import read_records_index
from spark_bam_tpu_torch.benchmarks.split_cases import (
    adversarial_bam,
    sentinel_split_size,
)
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf import index_blocks as ib
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.load import boundary
from spark_bam_tpu_torch.load.splits import file_splits, spark_bam_splits
from spark_bam_tpu_torch.sbi.format import PLAN_NONE, PLAN_POS, PLAN_UNRESOLVED
from spark_bam_tpu_torch.sbi.plan import build_split_plan
from spark_bam_tpu_torch.sbi.store import reset_cache_events
from spark_bam_tpu_torch.tpu import kernels
from spark_bam_tpu_torch.tpu.checker import TpuChecker
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: Contigs whose @SQ lines make a header of several BGZF blocks.
MANY_CONTIGS = tuple((f"contig_{i:04d}_" + "x" * 120, 1_000_000)
                     for i in range(700))


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_splits")
    out = {}
    for seed in (3, 7, 11):
        out[f"seed{seed}"] = str(d / f"s{seed}.bam")
        random_bam(out[f"seed{seed}"], seed=seed)
    out["long"] = str(d / "long.bam")
    synth_bam(out["long"], 1 << 20, seed=2, unit_reads=4,
              read_len=(60_000, 110_000))
    out["header"] = str(d / "header.bam")
    random_bam(out["header"], seed=5, contigs=MANY_CONTIGS,
               n_records=(40, 60), read_len=(10, 400))
    out["empty"] = str(d / "empty.bam")
    random_bam(out["empty"], seed=6, n_records=(0, 1))
    out["adversarial"] = str(d / "adv.bam")
    out["adversarial_split"], _ = adversarial_bam(out["adversarial"])
    for name in ("seed3", "seed7", "seed11", "long", "header", "empty",
                 "adversarial"):
        index_records(out[name])
    return out


def _entries(plan):
    return [(e.file_start, e.kind, None if e.pos is None else tuple(e.pos))
            for e in plan]


def _port_plan(path, split_size, **kw):
    return build_split_plan(path, file_splits(path, split_size),
                            read_header(path), Config(**kw), device="cpu")


def _jax_plan(path, split_size, **kw):
    return jax_build_split_plan(path, jax_file_splits(path, split_size),
                                jax_read_header(path), JConfig(**kw))


def _assert_plan_equals_jax(path, split_size, **kw):
    got = _entries(_port_plan(path, split_size, **kw))
    for backend in ("native", "python"):
        want = _entries(_jax_plan(path, split_size, backend=backend, **kw))
        assert got == want, backend
    truth = set(read_records_index(path + ".records"))
    header_end = tuple(read_header(path).end_pos)
    for _, kind, pos in got:
        if kind == PLAN_POS:
            assert pos in truth or (pos == header_end and not truth), pos
    return got


@pytest.mark.parametrize("split_size", [16384, 50_000, 1 << 20])
@pytest.mark.parametrize("seed", [3, 7, 11])
def test_random_bam_plan_equals_jax(bams, seed, split_size):
    boundary.STATS.reset()
    got = _assert_plan_equals_jax(bams[f"seed{seed}"], split_size)
    assert got[0][1] == PLAN_POS
    assert boundary.STATS.boundary_demotions == 0
    assert boundary.STATS.resolutions == len(got) - 1


def test_long_reads_cut_the_first_window(bams):
    """60-110 kb reads: the first boundary's chain outruns the 128 KiB
    first run, escapes, and the run grows and resumes there."""
    boundary.STATS.reset()
    got = _assert_plan_equals_jax(bams["long"], 200_000)
    assert sum(k == PLAN_POS for _, k, _ in got) >= 3
    assert boundary.STATS.windows > boundary.STATS.resolutions
    assert boundary.STATS.boundary_demotions == 0


def test_small_max_read_size_leaves_boundaries_unresolved(bams):
    got = _assert_plan_equals_jax(bams["seed7"], 16384, max_read_size=200)
    kinds = {k for _, k, _ in got}
    assert PLAN_UNRESOLVED in kinds and PLAN_POS in kinds
    port = spark_bam_splits(bams["seed7"], 16384,
                            Config(max_read_size=200), device="cpu")
    starts = [pos for _, k, pos in got if k == PLAN_POS]
    assert [tuple(s.start) for s in port] == sorted(set(starts))


@pytest.mark.parametrize("split_size", [16384, 50_000])
def test_header_of_many_blocks(bams, split_size):
    path = bams["header"]
    hdr, jhdr = read_header(path), jax_read_header(path)
    assert tuple(hdr.end_pos) == tuple(jhdr.end_pos)
    assert hdr.end_pos.block_pos > 0 and hdr.contig_names[-1].startswith(
        "contig_0699")
    _assert_plan_equals_jax(path, split_size)


def test_bam_without_records(bams):
    path = bams["empty"]
    assert tuple(read_header(path).end_pos) == \
        tuple(jax_read_header(path).end_pos) == (0, 0)
    got = _assert_plan_equals_jax(path, 40)
    assert got[0] == (0, PLAN_POS, (0, 0))
    assert {k for _, k, _ in got[1:]} == {PLAN_NONE}


def test_sentinel_only_last_split_is_none_where_jax_vectorized_raises(bams):
    """The reference fault: JAX ``_plan_vectorized`` raises ``KeyError``
    on a last split that holds only the EOF sentinel; the port's plan has
    ``PLAN_NONE`` there, as JAX ``build_split_plan`` has."""
    path = bams["seed7"]
    assert os.path.getsize(path) == 628_066
    with pytest.raises(KeyError, match="block 628038 not in view"):
        _plan_vectorized(CheckerContext(path, JConfig(backend="python")),
                         16384)
    got = _assert_plan_equals_jax(path, 16384)
    assert got[-1] == (622_592, PLAN_NONE, None)
    size = sentinel_split_size(path)
    got = _assert_plan_equals_jax(path, size)
    assert got == [(0, PLAN_POS, tuple(read_header(path).end_pos)),
                   (size, PLAN_NONE, None)]


@pytest.mark.parametrize("slack", [64 << 10, boundary.SCAN_SLACK],
                         ids=["bound_reached", "default"])
def test_growth_bound_resolves_on_the_host(bams, monkeypatch, slack):
    """A fake record with a 16 MiB ``remaining`` sits between a boundary
    and the next true start: its chain escapes every run, and at EOF too
    (its cursor leaves the int32 range). Past the growth bound, or at EOF
    under the default bound, the host engine resolves it exactly."""
    monkeypatch.setattr(boundary, "SCAN_SLACK", slack)
    boundary.STATS.reset()
    _assert_plan_equals_jax(bams["adversarial"], bams["adversarial_split"])
    assert boundary.STATS.boundary_demotions == 1


@pytest.mark.parametrize("distance", [1 << 20, 4 << 20])
def test_host_resolve_holds_no_run_past_the_bound(tmp_path, monkeypatch,
                                                   distance):
    """A fake record whose ``remaining`` jumps ``distance`` bytes into the
    file, past a 128 KiB growth bound: the host resolves that offset by
    reading the chain through a seekable stream, so the run the scan holds
    stays at the bound's size whatever the distance (growing the run to
    the chain's reach held ``distance`` bytes and more). The plan equals
    JAX ``build_split_plan``'s."""
    path = str(tmp_path / "far.bam")
    split, fake = adversarial_bam(path, remaining=distance,
                                  reads_after=distance // 128)
    flat = sum(m.uncompressed_size for m in ib.blocks_metadata(path))
    assert fake + 4 + distance < flat   # the chain lands inside the file
    index_records(path)
    monkeypatch.setattr(boundary, "SCAN_SLACK", 128 << 10)
    peak = []
    grow = boundary._Run.grow

    def spy(run, upto):
        grow(run, upto)
        peak.append(run.total)

    monkeypatch.setattr(boundary._Run, "grow", spy)
    boundary.STATS.reset()
    _assert_plan_equals_jax(path, split)
    assert boundary.STATS.boundary_demotions == 1
    assert max(peak) <= 3 * (128 << 10) < distance


# ------------------------------------------------------------------ cache

@pytest.fixture
def cached_bam(bams, tmp_path, monkeypatch):
    monkeypatch.delenv("SPARK_BAM_CACHE_DIR", raising=False)
    monkeypatch.delenv("SPARK_BAM_CACHE", raising=False)
    p = str(tmp_path / "c.bam")
    shutil.copyfile(bams["seed11"], p)
    reset_cache_events()
    return p


def _no_check(*a, **kw):
    raise AssertionError("a warm call ran the checker")


def test_record_starts_sidecar_equals_jax_and_warm_skips_check(
        cached_bam, monkeypatch):
    cold = record_starts(cached_bam, Config(cache="readwrite"),
                         device="cpu")
    port_blob = open(cached_bam + ".sbi", "rb").read()
    os.unlink(cached_bam + ".sbi")
    jax = jax_record_starts(cached_bam, JConfig(cache="readwrite"))
    assert open(cached_bam + ".sbi", "rb").read() == port_blob
    np.testing.assert_array_equal(cold.starts, jax.starts)
    monkeypatch.setattr(TpuChecker, "check_buffer", _no_check)
    kernels.reset_launch_counts()
    warm = record_starts(cached_bam, Config(cache="read"), device="cpu")
    np.testing.assert_array_equal(warm.starts, cold.starts)
    assert not any(kernels.LAUNCHES.values())


def test_warm_aggregate_equals_cold(cached_bam, monkeypatch):
    cfg = Config(cache="readwrite")
    cold = aggregate(cached_bam, config=cfg, device="cpu")
    monkeypatch.setattr(TpuChecker, "check_buffer", _no_check)
    warm = aggregate(cached_bam, config=cfg, device="cpu")
    assert cold.keys() == warm.keys() and cold["rows"] == warm["rows"] > 0
    for k, v in cold["metrics"].items():
        np.testing.assert_array_equal(warm["metrics"][k], v)


def test_warm_split_plan_skips_the_resolver(cached_bam, monkeypatch):
    cfg = Config(cache="readwrite")
    cold = spark_bam_splits(cached_bam, 50_000, cfg, device="cpu")
    monkeypatch.setattr(boundary, "next_read_start", _no_check)
    boundary.STATS.reset()
    warm = spark_bam_splits(cached_bam, 50_000, cfg, device="cpu")
    assert warm == cold and boundary.STATS.resolutions == 0


def test_blocks_metadata_tiers(cached_bam, monkeypatch):
    want = [(m.start, m.compressed_size, m.uncompressed_size)
            for m in jax_blocks(cached_bam)]

    def rows(blocks):
        return [(m.start, m.compressed_size, m.uncompressed_size)
                for m in blocks]

    # The .sbi tier: a scan written through, then served from the sidecar.
    cfg = Config(cache="readwrite")
    assert rows(ib.blocks_metadata(cached_bam, config=cfg)) == want
    monkeypatch.setattr(ib, "scan_blocks", _no_check)
    assert rows(ib.blocks_metadata(cached_bam, config=cfg)) == want
    # A .blocks sidecar wins; a stale one is ignored, or raises if strict.
    monkeypatch.undo()
    path, n = ib.index_blocks(cached_bam)
    assert n == len(want) and rows(ib.read_blocks_index(path)) == want
    assert rows(ib.blocks_metadata(cached_bam)) == want
    with open(path, "a") as f:
        f.write("999999999,10,10\n")
    assert rows(ib.blocks_metadata(cached_bam)) == want
    with pytest.raises(ib.StaleBlocksIndexError, match="gap/overlap"):
        ib.blocks_metadata(cached_bam, strict=True)
