"""The port's streaming and whole-file loads against the JAX package's.

``StreamChecker.read_batches`` through ``stream_read_batches`` must yield
the JAX package's ``(abs_base, batch)`` sequence (in-window batches in
window order, the exact spill batches with ``abs_base = -1``), column for
column, with the port's windows inflated on the device path or by host
zlib and with the funnel on or off; on random BAMs at two geometries, on
long reads that outrun a 64 KiB halo, and on the load edge corpus under
every filter. ``record_starts``, ``record_starts_streaming``,
``load_reads_columnar`` and ``count_reads_tpu`` must equal theirs. The
JAX side runs as its own tests run it on the CPU; the port runs its plain
versions with ``device="cpu"``. Every comparison is exact.

Every geometry here keeps each window group inside the JAX package's
kernel window: where a group outgrows it (BGZF blocks larger than the
window), the JAX package checks only the kernel window's first bytes of
the group, while the port's kernel window covers the largest group.
"""

import numpy as np
import pytest
import torch

from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.load import tpu_load as jl
from spark_bam_tpu.tpu import parser as jp
from spark_bam_tpu_torch import (
    Config,
    StreamChecker,
    count_reads_tpu,
    load_reads_columnar,
    record_starts,
    record_starts_streaming,
    stream_read_batches,
)
from spark_bam_tpu_torch.benchmarks import load_cases as lc
from spark_bam_tpu_torch.benchmarks.synth import record_positions, synth_bam
from spark_bam_tpu_torch.load import tpu_load as tl
from spark_bam_tpu_torch.tpu import stream_check
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEOMETRIES = [(64 << 10, 16 << 10), (96 << 10, 48 << 10)]


@pytest.fixture(autouse=True)
def jax_writable(monkeypatch):
    """Writable JAX parse outputs (see ``test_torch_load_parser.py``)."""
    orig = jp.parse_records

    def writable(*a, **kw):
        return {k: np.array(v) for k, v in orig(*a, **kw).items()}

    monkeypatch.setattr(jp, "parse_records", writable)


@pytest.fixture(scope="module")
def rand_bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_load") / "r.bam"
    random_bam(p, seed=91, read_len=(10, 400), n_records=(800, 900),
               mapped_rate=0.7, dup_rate=0.2)
    return p


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_load_edges") / "edges.bam"
    return p, lc.write_bam(p, seed=2)


@pytest.fixture(scope="module")
def long_bam(tmp_path_factory):
    """60-110 kb reads: every record outruns a 64 KiB halo."""
    p = tmp_path_factory.mktemp("torch_load_long") / "l.bam"
    m = synth_bam(p, 2 << 20, seed=9, unit_reads=8, read_len=(60_000, 110_000))
    return p, m


def _assert_batches_equal(got, want, label=""):
    assert [b for b, _ in got] == [b for b, _ in want], label
    for i, ((base, g), (_, w)) in enumerate(zip(got, want)):
        where = f"{label} batch {i} at {base}"
        assert g.starts.dtype == w.starts.dtype, where
        np.testing.assert_array_equal(g.starts, w.starts, err_msg=where)
        np.testing.assert_array_equal(g.buf, w.buf, err_msg=where)
        assert list(g.columns) == list(w.columns), where
        for k in w.columns:
            assert g.columns[k].dtype == w.columns[k].dtype, (where, k)
            np.testing.assert_array_equal(g.columns[k], w.columns[k],
                                          err_msg=f"{where} {k}")


def _jax_batches(path, window, halo, funnel="auto", **filters):
    cfg = JaxConfig(window_size=window, halo_size=halo, funnel=funnel)
    return list(jl.stream_read_batches(path, cfg, **filters))


def _port_batches(path, window, halo, funnel="auto", device_inflate=None,
                  **filters):
    cfg = Config(window_size=window, halo_size=halo, funnel=funnel,
                 device_inflate=device_inflate)
    return list(stream_read_batches(path, cfg, device="cpu", **filters))


@pytest.mark.parametrize("window,halo", GEOMETRIES)
@pytest.mark.parametrize("device_inflate", [None, False],
                         ids=["device_inflate", "host_zlib"])
@pytest.mark.parametrize("funnel", ["on", "off"])
def test_read_batches_match_jax(rand_bam, window, halo, device_inflate,
                                funnel):
    want = _jax_batches(rand_bam, window, halo, funnel)
    got = _port_batches(rand_bam, window, halo, funnel, device_inflate)
    _assert_batches_equal(got, want)
    assert len(got) >= 3 and all(b >= 0 for b, _ in got)


def test_long_reads_spill_exactly(long_bam):
    path, m = long_bam
    want = _jax_batches(path, 256 << 10, 64 << 10)
    got = _port_batches(path, 256 << 10, 64 << 10)
    _assert_batches_equal(got, want, "long reads")
    spills = [b for base, b in got if base == -1]
    assert spills and sum(len(b) for b in spills) > 0
    rows = sum(len(b) for _, b in got)
    assert rows == m["reads"]
    pos = np.concatenate([b["pos"] for _, b in got])
    assert sorted(pos.tolist()) == sorted(record_positions(m))


@pytest.mark.parametrize("funnel", ["on", "off"])
def test_edge_corpus_matches_jax(corpus, funnel):
    path, m = corpus
    w, h = lc.GEOMETRY
    want = _jax_batches(path, w, h, funnel)
    got = _port_batches(path, w, h, funnel)
    _assert_batches_equal(got, want, "edge corpus")
    found = [base + b.starts for base, b in got if base >= 0]
    spilled = sum(len(b) for base, b in got if base == -1)
    expected = np.setdiff1d(
        m["starts"], [m["starts"][m["names"].index(n)] for n in m["refused"]])
    assert spilled >= lc.LONG_READS
    assert sum(len(f) for f in found) + spilled == len(expected)
    assert np.isin(np.concatenate(found), expected).all()


@pytest.mark.parametrize("loci", (None,) + lc.LOCI)
def test_edge_corpus_filters_match_jax(corpus, loci):
    path, _ = corpus
    w, h = lc.GEOMETRY
    for fr, ff in lc.FLAG_FILTERS:
        want = _jax_batches(path, w, h, loci=loci, flags_required=fr,
                            flags_forbidden=ff)
        got = _port_batches(path, w, h, loci=loci, flags_required=fr,
                            flags_forbidden=ff)
        _assert_batches_equal(got, want, f"{loci} {fr:#x}/{ff:#x}")
        for tags in lc.TAG_FILTERS[:4]:
            for (_, g), (_, wb) in zip(got, want):
                np.testing.assert_array_equal(
                    tl._tag_presence_mask(g, tags),
                    jl._tag_presence_mask(wb, tags))


def test_spill_flush_every_4096_positions(tmp_path):
    """Chains of 60 records outrun 4 KB windows, so nearly every start
    spills: the first spill batch comes mid-stream with at least 4,096
    rows, spill rows come out in file order, and all rows together are
    the JAX whole-file load's."""
    p = tmp_path / "spill.bam"
    random_bam(p, seed=7, read_len=(10, 30), n_records=(4600, 4601),
               mapped_rate=1.0, block_payload=(4000, 4001))
    cfg = Config(window_size=4000, halo_size=16, device_inflate=False,
                 reads_to_check=60)
    got = list(stream_read_batches(p, cfg, device="cpu"))
    bases = [b for b, _ in got]
    first = bases.index(-1)
    assert len(got[first][1]) >= 4096
    assert any(b >= 0 for b in bases[first + 1:])
    for base, batch in got:
        if base == -1:
            assert (np.diff(batch["pos"]) > 0).all()
    whole = jl.load_reads_columnar(p)
    pos = np.sort(np.concatenate([b["pos"] for _, b in got]))
    np.testing.assert_array_equal(pos, np.sort(whole["pos"]))


@pytest.mark.parametrize("which", ["rand", "edges"])
def test_record_starts_match_jax(rand_bam, corpus, which):
    path = rand_bam if which == "rand" else corpus[0]
    want = jl.record_starts(path)
    got = record_starts(path, device="cpu")
    assert got.starts.dtype == want.starts.dtype
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.view.data, want.view.data)
    assert got.positions() == [tuple(p) for p in want.positions()]
    streamed = np.concatenate(list(record_starts_streaming(
        path, Config(window_size=64 << 10, halo_size=16 << 10),
        device="cpu")))
    np.testing.assert_array_equal(np.sort(streamed), want.starts)


def test_record_starts_takes_a_checker(rand_bam):
    from spark_bam_tpu_torch.tpu.checker import TpuChecker

    want = jl.record_starts(rand_bam).starts
    lens = record_starts(rand_bam, device="cpu").header.contig_lengths
    checker = TpuChecker(lens, window=1 << 14, halo=1 << 12, device="cpu")
    got = record_starts(rand_bam, checker=checker).starts
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filters", [
    {}, {"loci": "chr1:100-2000000"}, {"loci": "chr2", "flags_forbidden": 0x400},
    {"flags_required": 0x400}, {"loci": "chrZ"},
])
def test_load_reads_columnar_matches_jax(rand_bam, corpus, filters):
    for path in (rand_bam, corpus[0]):
        want = jl.load_reads_columnar(path, **filters)
        got = load_reads_columnar(path, device="cpu", **filters)
        _assert_batches_equal([(0, got)], [(0, want)], str(filters))


def test_count_reads_tpu_matches(rand_bam):
    cfg = Config(window_size=64 << 10, halo_size=16 << 10)
    want = jl.count_reads_tpu(
        rand_bam, JaxConfig(window_size=64 << 10, halo_size=16 << 10))
    got = count_reads_tpu(rand_bam, cfg, device="cpu")
    assert got == want == StreamChecker(rand_bam, cfg,
                                        device="cpu").count_reads()
    assert got == len(jl.record_starts(rand_bam).starts)


def test_in_window_batches_parse_on_the_checked_window(rand_bam, monkeypatch):
    """The in-window parse runs on the tensor the check ran on, and never
    through the host entry (which would upload the window again); no
    window tensor is written while the one-behind pipeline holds it."""
    checked, parsed = [], []
    real_check, real_parse = stream_check.check_window, stream_check.parse_window

    def spy_check(padded, *a, **kw):
        checked.append((padded, padded.clone()))
        return real_check(padded, *a, **kw)

    def spy_parse(padded, buf, starts):
        parsed.append(padded)
        return real_parse(padded, buf, starts)

    def refuse(*a, **kw):
        raise AssertionError("an in-window batch went through the host entry")

    monkeypatch.setattr(stream_check, "check_window", spy_check)
    monkeypatch.setattr(stream_check, "parse_window", spy_parse)
    monkeypatch.setattr(stream_check, "parse_flat_records", refuse)
    got = _port_batches(rand_bam, *GEOMETRIES[0])
    assert len(parsed) == len(got) >= 3
    assert all(any(p is c for c, _ in checked) for p in parsed)
    assert len({id(c) for c, _ in checked}) == len(checked)
    assert all(torch.equal(c, snap) for c, snap in checked)


def test_load_entry_points_require_cuda(rand_bam, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: next(stream_read_batches(rand_bam)),
                 lambda: load_reads_columnar(rand_bam),
                 lambda: record_starts(rand_bam),
                 lambda: count_reads_tpu(rand_bam),
                 lambda: next(record_starts_streaming(rand_bam))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
