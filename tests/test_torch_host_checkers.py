"""The host checkers (``check/eager.py``, ``full.py``, ``indexed.py``,
``find_record_start.py``, the ``make_checker`` registry), the block
planner (``check/blocks.py``) and the byte-range grammar
(``core/ranges.py``) against the JAX package's: the same verdict, flags
and next record start at every position of random BAMs, and at a dense
sample of the edge corpora's; the same block partitions and truth
alignment; the same range sets."""

import numpy as np
import pytest

from spark_bam_tpu.bgzf.flat import flatten_file as jax_flatten
from spark_bam_tpu.check import blocks as jblocks
from spark_bam_tpu.check.checker import make_checker as jax_make_checker
from spark_bam_tpu.check.eager import EagerChecker as JaxEager
from spark_bam_tpu.check.find_record_start import (
    find_record_start as jax_find_record_start,
)
from spark_bam_tpu.check.find_record_start import (
    find_record_starts_flat as jax_find_flat,
)
from spark_bam_tpu.check.full import FullChecker as JaxFull
from spark_bam_tpu.core import ranges as jranges
from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.core.pos import Pos as JaxPos
from spark_bam_tpu.parallel.executor import ParallelConfig as JaxParallel
from spark_bam_tpu_torch.bam.index_records import index_records
from spark_bam_tpu_torch.benchmarks import load_cases, split_cases
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.bgzf.index_blocks import index_blocks
from spark_bam_tpu_torch.check import blocks
from spark_bam_tpu_torch.check.checker import NoReadFoundException, make_checker
from spark_bam_tpu_torch.check.eager import EagerChecker
from spark_bam_tpu_torch.check.find_record_start import (
    find_record_start,
    find_record_starts_flat,
)
from spark_bam_tpu_torch.check.full import FullChecker
from spark_bam_tpu_torch.core import ranges
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.parallel.executor import ParallelConfig
from tests.bam_factories import random_bam


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_host_checkers")
    out = {}
    for seed in (41, 42):
        out[f"rand{seed}"] = str(d / f"rand{seed}.bam")
        random_bam(out[f"rand{seed}"], seed=seed, n_records=(20, 40),
                   read_len=(10, 200), mapped_rate=0.7,
                   block_payload=(1500, 4000))
    out["edge"] = str(d / "edge.bam")
    out["edge_manifest"] = load_cases.write_bam(out["edge"], fillers=300)
    out["refused"] = str(d / "refused.bam")
    load_cases.write_refused_mid_bam(out["refused"], fillers=120, after=60)
    out["adversarial"] = str(d / "adversarial.bam")
    split_cases.adversarial_bam(out["adversarial"])
    for name in ("rand41", "refused"):
        index_records(out[name])
    return out


def _positions(path, dense: bool):
    """Every position of the file (``dense``), else every record start
    with its neighbours and a strided sample."""
    view = flatten_file(path)
    if dense:
        flats = np.arange(view.size)
    else:
        from spark_bam_tpu_torch.bam.index_records import record_start_flats

        starts = record_start_flats(path)
        near = (starts[:, None] + np.arange(-2, 3)[None, :]).ravel()
        flats = np.unique(np.concatenate([near, np.arange(0, view.size, 97)]))
        flats = flats[(flats >= 0) & (flats < view.size)]
    return [Pos(*view.pos_of_flat(int(f))) for f in flats]


def _full_key(r):
    if type(r).__name__ == "Success":
        return ("Success", r.reads_parsed)
    return ("Flags", r.to_mask(), r.readsBeforeError)


@pytest.mark.parametrize("name,dense", [("rand41", True), ("rand42", True),
                                        ("refused", False), ("edge", False),
                                        ("adversarial", False)])
def test_eager_and_full_checkers_equal_jax(bams, name, dense):
    path = bams[name]
    eager, jeager = EagerChecker.open(path), JaxEager.open(path)
    full, jfull = FullChecker.open(path), JaxFull.open(path)
    try:
        for pos in _positions(path, dense):
            jpos = JaxPos(*pos)
            assert eager(pos) == jeager(jpos), pos
            assert _full_key(full(pos)) == _full_key(jfull(jpos)), pos
            assert full(pos).call == eager(pos)
    finally:
        for c in (eager, jeager, full, jfull):
            c.close()


@pytest.mark.parametrize("name", ["rand41", "refused", "edge", "adversarial"])
def test_find_record_start_equals_jax(bams, name):
    path = bams[name]
    view, jview = flatten_file(path), jax_flatten(path)
    eager, jeager = EagerChecker.open(path), JaxEager.open(path)
    lengths = np.asarray(eager.lengths, dtype=np.int32)
    try:
        for budget in (10_000_000, 3000):
            for start in view.block_starts.tolist():
                try:
                    got = tuple(find_record_start(eager, start, budget))
                except NoReadFoundException:
                    got = "none"
                try:
                    want = tuple(jax_find_record_start(jeager, start, budget))
                except Exception as e:
                    assert type(e).__name__ == "NoReadFoundException"
                    want = "none"
                assert got == want, start
            got = find_record_starts_flat(view, lengths,
                                          max_read_size=budget)
            want = jax_find_flat(jview, lengths, max_read_size=budget)
            assert {k: None if v is None else tuple(v)
                    for k, v in got.items()} == {
                k: None if v is None else tuple(v) for k, v in want.items()}
    finally:
        eager.close()
        jeager.close()


@pytest.mark.parametrize("checker", ["eager", "full", "indexed", "seqdoop"])
def test_make_checker_registry_equals_jax(bams, checker):
    path = bams["rand41"]
    got = make_checker(checker, path, Config())
    want = jax_make_checker(checker, path, JaxConfig())
    view = flatten_file(path)
    try:
        for flat in range(0, view.size, 7):
            pos = Pos(*view.pos_of_flat(flat))
            a, b = got(pos), want(JaxPos(*pos))
            if checker == "full":
                assert _full_key(a) == _full_key(b)
            else:
                assert bool(a) == bool(b), pos
            if checker in ("indexed", "seqdoop"):
                na = got.next_read_start(pos)
                nb = want.next_read_start(JaxPos(*pos))
                assert (None if na is None else tuple(na)) == (
                    None if nb is None else tuple(nb))
    finally:
        got.close()
        want.close()
    with pytest.raises(KeyError, match="Unknown checker"):
        make_checker("nope", path)


@pytest.mark.parametrize("spec", [
    "0-100", "10+20,5", "1k-2k,1500-3k", "0,2,4", "1KB+1KB", "5-5",
    " 7 , 100-200 ",
])
def test_ranges_equal_jax(spec):
    got, want = ranges.parse_ranges(spec), jranges.parse_ranges(spec)
    assert [(r.start, r.end) for r in got.ranges] == [
        (r.start, r.end) for r in want.ranges]
    for pos in range(0, 3500, 13):
        assert (pos in got) == (pos in want)
        assert got.overlaps(pos, pos + 50) == want.overlaps(pos, pos + 50)
    assert repr(got) == repr(want)
    assert ranges.parse_ranges(None) is None and ranges.parse_ranges(" ") is None
    with pytest.raises(ValueError):
        ranges.parse_range("20-10")


def _plan_key(plan):
    return ([[(m.start, m.compressed_size, m.uncompressed_size) for m in p]
             for p in plan.partitions], list(plan.bounds))


@pytest.mark.parametrize("sidecar", [False, True])
@pytest.mark.parametrize("split,spec", [(4096, None), (10_000, "0-30000"),
                                        (None, None), (3000, "5000+9000,40k")])
def test_plan_blocks_equals_jax(bams, tmp_path, sidecar, split, spec):
    import shutil

    path = str(tmp_path / "b.bam")
    shutil.copy(bams["edge"], path)
    if sidecar:
        index_blocks(path)
    rs = ranges.parse_ranges(spec)
    jrs = jranges.parse_ranges(spec)
    for mode in ("sequential", "threads"):
        got = blocks.plan_blocks(path, Config(split_size=split), rs,
                                 parallel=ParallelConfig(mode, 3))
        want = jblocks.plan_blocks(path, JaxConfig(split_size=split), jrs,
                                   parallel=JaxParallel(mode, 3))
        assert _plan_key(got) == _plan_key(want)
        assert got.num_blocks == want.num_blocks


def test_align_indexed_records_equals_jax(bams):
    path = bams["refused"]
    for split in (2048, 50_000):
        got_plan = blocks.plan_blocks(path, Config(split_size=split))
        want_plan = jblocks.plan_blocks(path, JaxConfig(split_size=split))
        got = blocks.align_indexed_records(got_plan, path + ".records")
        want = jblocks.align_indexed_records(want_plan, path + ".records")
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    filtered = blocks.plan_blocks(path, Config(split_size=4096),
                                  ranges.parse_ranges("0-8000"))
    with pytest.raises(ValueError, match="missing from the plan"):
        blocks.align_indexed_records(filtered, path + ".records")
    assert blocks.align_indexed_records(filtered, path + ".records",
                                        strict=False)
