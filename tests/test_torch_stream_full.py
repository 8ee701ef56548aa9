"""The port's streaming spans and full-check summary against the JAX
package's.

``spans()`` and ``full_spans()`` of the port (plain versions on the CPU,
windows inflated by the device path's tokenize and LZ77 resolve unless
``device_inflate=False``) are reassembled into per-position arrays and compared exactly with the JAX
``StreamChecker``'s, run on its NumPy engine (``use_device=False``) and on
XLA (``use_device=True``, the CPU here), at geometries whose seams fall
inside records, and on long reads whose chains outrun the halo (deferrals).
``full_check_summary_streaming`` dicts must be equal, site arrays exactly.
"""

import numpy as np
import pytest

from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.tpu.stream_check import StreamChecker as JaxStreamChecker
from spark_bam_tpu.tpu.stream_check import (
    full_check_summary_streaming as jax_summary,
)
from spark_bam_tpu_torch import (
    Config,
    StreamChecker,
    full_check_summary_streaming,
)
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf.block import BgzfError
from spark_bam_tpu_torch.tpu import checker as ck
from spark_bam_tpu_torch.tpu import stream_check
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEOMETRIES = [(64 << 10, 16 << 10), (96 << 10, 48 << 10)]


@pytest.fixture(scope="module")
def rand_bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_full") / "r.bam"
    random_bam(p, seed=81, read_len=(10, 400), n_records=(300, 500))
    return p


@pytest.fixture(scope="module")
def long_bam(tmp_path_factory):
    """60-110 kb reads: ten-record chains outrun a 64 KiB halo."""
    p = tmp_path_factory.mktemp("torch_full_long") / "l.bam"
    m = synth_bam(p, 2 << 20, seed=9, unit_reads=8, read_len=(60_000, 110_000))
    return p, m["reads"]


def _reassemble(spans, total: int, nfields: int):
    """Per-position arrays from a span stream, and the number of
    re-emissions (spans behind the tiling frontier)."""
    outs = [np.full(total, -1, dtype=np.int64) for _ in range(nfields)]
    frontier = deferred = 0
    for base, *arrays in spans:
        if base < frontier:
            deferred += 1
        else:
            assert base == frontier, "window spans must tile in order"
            frontier = base + len(arrays[0])
        for out, a in zip(outs, arrays):
            out[base: base + len(a)] = a
    assert frontier == total
    return outs, deferred


def _jax(path, window, halo, use_device, full):
    sc = JaxStreamChecker(path, JaxConfig(), window, halo,
                          use_device=use_device)
    if full:
        return _reassemble(sc.full_spans(), sc.total, 2)[0]
    return _reassemble(sc.spans(), sc.total, 1)[0]


def _port(path, window, halo, full):
    sc = StreamChecker(path, Config(), window, halo, device="cpu")
    if full:
        return _reassemble(sc.full_spans(), sc.total, 2)
    return _reassemble(sc.spans(), sc.total, 1)


def _summaries_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert len(got[k]) == len(want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("window,halo", GEOMETRIES)
@pytest.mark.parametrize("full", [True, False], ids=["full_spans", "spans"])
@pytest.mark.parametrize("use_device", [False, True], ids=["numpy", "xla"])
def test_spans_match_jax_random_bam(rand_bam, window, halo, full, use_device):
    got, _ = _port(rand_bam, window, halo, full)
    want = _jax(rand_bam, window, halo, use_device, full)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] != 0).any()


@pytest.mark.parametrize("fixture", ["bam1", "bam2"])
@pytest.mark.parametrize("full", [True, False], ids=["full_spans", "spans"])
def test_spans_match_jax_fixtures(request, fixture, full):
    path = request.getfixturevalue(fixture)
    window, halo = GEOMETRIES[0]
    got, _ = _port(path, window, halo, full)
    for use_device in (False, True):
        want = _jax(path, window, halo, use_device, full)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("full", [True, False], ids=["full_spans", "spans"])
def test_long_reads_defer_and_match_jax(long_bam, full):
    path, reads = long_bam
    got, deferred = _port(path, 256 << 10, 64 << 10, full)
    want = _jax(path, 256 << 10, 64 << 10, False, full)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert deferred > 0
    if full:
        he = StreamChecker(path, Config(), device="cpu").header_end_abs
        assert int((got[0][he:] == 0).sum()) == reads
    else:
        assert int(got[0].sum()) == reads


@pytest.mark.parametrize("window,halo", GEOMETRIES + [(None, None)])
def test_summary_matches_jax(rand_bam, window, halo):
    got = full_check_summary_streaming(rand_bam, Config(), window, halo,
                                       device="cpu")
    want = jax_summary(rand_bam, JaxConfig(), window, halo, use_device=False)
    _summaries_equal(got, want)
    assert got["considered"] > 0 and len(got["two_check_positions"]) > 0


def test_summary_matches_jax_long_reads(long_bam):
    path, _ = long_bam
    got = full_check_summary_streaming(path, Config(), 256 << 10, 64 << 10,
                                       device="cpu")
    want = jax_summary(path, JaxConfig(), 256 << 10, 64 << 10,
                       use_device=False)
    _summaries_equal(got, want)


@pytest.mark.parametrize("fixture", ["bam1", "bam2"])
def test_summary_matches_jax_fixtures(request, fixture):
    path = request.getfixturevalue(fixture)
    got = full_check_summary_streaming(path, Config(), device="cpu")
    want = jax_summary(path, JaxConfig(), use_device=False)
    _summaries_equal(got, want)


def test_record_starts_match_count(rand_bam):
    sc = StreamChecker(rand_bam, Config(), *GEOMETRIES[0], device="cpu")
    starts = np.concatenate(list(sc.record_starts()))
    assert len(starts) == len(np.unique(starts)) == sc.count_reads()
    assert starts.min() >= sc.header_end_abs


def test_funnel_off_spans_equal_funnel_on(rand_bam):
    """``Config(funnel="off")`` runs the full pass on the verdict path too;
    the verdicts, and the count, are the funnel's."""
    window, halo = GEOMETRIES[0]
    off = StreamChecker(rand_bam, Config(funnel="off"), window, halo,
                        device="cpu")
    got, _ = _reassemble(off.spans(), off.total, 1)
    want, _ = _port(rand_bam, window, halo, False)
    np.testing.assert_array_equal(got[0], want[0])
    assert off.funnel_stats is None
    assert off.count_reads() == int(want[0][off.header_end_abs:].sum())


def _counting(monkeypatch, reject_call=None):
    """Wrap the checker's ``tokenize`` to count its calls; the call numbered
    ``reject_call`` reports its first row as rejected."""
    real = ck.tokenize
    calls = []

    def tokenize(staged, clens):
        calls.append(1)
        lit, dist, olens, ok = real(staged, clens)
        if len(calls) == reject_call:
            ok = ok.clone()
            ok[0] = False
        return lit, dist, olens, ok

    monkeypatch.setattr(ck, "tokenize", tokenize)
    return calls


@pytest.mark.parametrize("full", [True, False], ids=["full_spans", "spans"])
def test_spans_inflate_on_device_unless_configured_off(rand_bam, monkeypatch,
                                                       full):
    """By default every window of ``spans``/``full_spans`` is tokenized and
    resolved by the device path; ``device_inflate=False`` inflates with host
    zlib and never tokenizes. Both give the same spans."""
    window, halo = GEOMETRIES[0]
    calls = _counting(monkeypatch)
    dev = StreamChecker(rand_bam, Config(), window, halo, device="cpu")
    got, _ = _reassemble(dev.full_spans() if full else dev.spans(), dev.total,
                         2 if full else 1)
    assert len(calls) == len(dev.pipeline.groups) >= 2
    assert dev.tokenize_demotions == 0
    calls.clear()
    host = StreamChecker(rand_bam, Config(device_inflate=False), window, halo,
                         device="cpu")
    want, _ = _reassemble(host.full_spans() if full else host.spans(),
                          host.total, 2 if full else 1)
    assert calls == []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fault", ["tok_ok", "staging"])
def test_refused_window_demotes_alone(rand_bam, monkeypatch, fault):
    """A window whose tokenizer verdict is False, or whose payloads the
    staging refuses, is inflated by host zlib instead; the other windows
    stay on the device path, and the spans equal the reference's."""
    window, halo = GEOMETRIES[0]
    if fault == "tok_ok":
        calls = _counting(monkeypatch, reject_call=2)
    else:
        calls = _counting(monkeypatch)
        real = stream_check.stage_group_device
        staged = []

        def stage(ch, group, device):
            staged.append(1)
            if len(staged) == 2:
                raise BgzfError("refused")
            return real(ch, group, device)

        monkeypatch.setattr(stream_check, "stage_group_device", stage)
    sc = StreamChecker(rand_bam, Config(), window, halo, device="cpu")
    got, _ = _reassemble(sc.full_spans(), sc.total, 2)
    assert sc.tokenize_demotions == 1
    groups = len(sc.pipeline.groups)
    assert len(calls) == (groups if fault == "tok_ok" else groups - 1)
    want = _jax(rand_bam, window, halo, False, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
