"""The port's host yardstick (``native/eager.cpp`` and
``native/inflate_zlib.cpp``, built by ``native/build.py``) against the JAX
package's native library and its host checker, exactly.

The eager verdicts, the windowed tri-state verdicts and both record-start
scans run over the edge sets: random BAMs' flat buffers
(``tests/bam_factories.random_bam``, long reads among them), the
prefilter's edge windows with their contig tables
(``benchmarks/prefilter_cases.py``), byte-damaged copies and copies cut at
arbitrary offsets (the EOF-cut windows). Every verdict equals the JAX
package's ``eager_check_native`` family and, over whole buffers, its
``check/vectorized.py::check_flat``. The inflates give zlib's bytes and
the JAX wrappers' on BGZF payloads, damaged payloads included (a block
the table decoder refuses goes through zlib, as the reference's does).
"""

import ctypes
import zlib

import numpy as np
import pytest

from spark_bam_tpu.check.vectorized import check_flat as jax_check_flat
from spark_bam_tpu.native import build as jn
from spark_bam_tpu_torch.benchmarks import deflate_cases as dc
from spark_bam_tpu_torch.benchmarks import prefilter_cases as pc
from spark_bam_tpu_torch.bgzf.flat import flatten_file, read_run_payloads
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.native import build
from tests.bam_factories import random_bam


def _buffers(tmp_path_factory) -> dict:
    """name → (flat buffer, contig lengths): whole files end at EOF."""
    root = tmp_path_factory.mktemp("native_eager")
    out = {}
    for seed, kw in ((1, {}), (2, {"read_len": (10, 200),
                                   "mapped_rate": 0.5}),
                     (3, {"read_len": (2000, 9000), "n_records": (20, 40)})):
        p = root / f"r{seed}.bam"
        random_bam(p, seed=seed, **kw)
        flat = flatten_file(p).data
        lens = np.asarray(read_header(p).contig_lengths, dtype=np.int32)
        out[f"random_{seed}"] = (np.ascontiguousarray(flat[:160_000]), lens)
    rng = np.random.default_rng(5)
    flat, lens = out["random_1"]
    damaged = flat.copy()
    hits = rng.integers(0, len(damaged), 400)
    damaged[hits] = rng.integers(0, 256, 400, dtype=np.uint8)
    out["damaged"] = (damaged, lens)
    for name, (buf, n, table, nc) in pc.prefilter_windows(1 << 16).items():
        out[f"edge_{name}"] = (np.ascontiguousarray(buf[:n]),
                               np.asarray(table[:nc], dtype=np.int32))
    return out


@pytest.fixture(scope="module")
def buffers(tmp_path_factory):
    return _buffers(tmp_path_factory)


def _cuts(n: int, seed: int) -> list[int]:
    if n < 2:
        return [n]
    rng = np.random.default_rng(seed)
    return sorted({int(x) for x in rng.integers(1, n, 3)} | {n})


def test_library_builds_for_this_host_under_the_build_dir():
    path = build.build(build.EAGER_SRC)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libsbt_eager-") and path.exists()
    assert path == build.library_path(build.EAGER_SRC)
    assert type(build.load_native()) is ctypes.CDLL
    zpath = build.build(build.ZLIB_SRC)
    assert zpath.name.startswith("libsbt_inflate_zlib-")
    # -march=native: the host token is in the name, so another host's
    # library is never loaded from a copied checkout.
    token = build._host_token()
    assert build.library_path(build.EAGER_SRC) != build.library_path(
        build.ZLIB_SRC)
    assert len(token) == 8


@pytest.mark.parametrize("rtc", [1, 10])
def test_eager_check_equals_jax_and_check_flat(buffers, rtc):
    for name, (buf, lens) in buffers.items():
        cand = np.arange(len(buf), dtype=np.int64)
        got = build.eager_check_native(buf, cand, lens, rtc)
        want = jn.eager_check_native(buf, cand, lens, rtc)
        assert got.dtype == bool and np.array_equal(got, want), name
        flat = jax_check_flat(buf, lens, at_eof=True,
                              reads_to_check=rtc).verdict
        assert np.array_equal(got, flat), name


def test_eager_verdicts_find_the_records(buffers):
    buf, lens = buffers["random_2"]
    got = build.eager_check_native(buf, np.arange(len(buf)), lens)
    assert got.sum() > 100


def test_window_verdicts_equal_jax_on_cut_windows(buffers):
    seen = set()
    for k, (name, (buf, lens)) in enumerate(sorted(buffers.items())):
        for cut in _cuts(len(buf), k):
            window = buf[:cut]
            cand = np.arange(cut, dtype=np.int64)
            for exact in (False, True):
                got = build.eager_check_window_native(window, cand, lens, 10,
                                                      exact)
                want = jn.eager_check_window_native(window, cand, lens, 10,
                                                    exact)
                assert np.array_equal(got, want), (name, cut, exact)
                seen |= set(np.unique(got).tolist())
    assert seen == {0, 1, 2}


def test_record_start_scans_equal_jax(buffers):
    for k, (name, (buf, lens)) in enumerate(sorted(buffers.items())):
        rng = np.random.default_rng(k)
        for start in (0, *rng.integers(0, max(len(buf), 1), 3).tolist()):
            for limit in (64, 10_000_000):
                got = build.find_record_start_native(buf, start, lens, 10,
                                                     limit)
                assert got == jn.find_record_start_native(
                    buf, start, lens, 10, limit), (name, start)
                for cut in _cuts(len(buf), k + start):
                    for exact in (False, True):
                        args = (buf[:cut], min(start, cut), lens, 10, limit,
                                exact)
                        assert build.find_record_start_window_native(
                            *args) == jn.find_record_start_window_native(
                            *args), (name, start, cut, exact)


def test_offsets_must_be_flat_offsets():
    buf = np.zeros(64, np.uint8)
    lens = np.array([100], np.int32)
    with pytest.raises(ValueError):
        build.eager_check_native(buf, np.array([-1]), lens)
    with pytest.raises(ValueError):
        build.find_record_start_native(buf, -3, lens)


@pytest.fixture(scope="module")
def payloads(tmp_path_factory):
    """A random BAM's BGZF payloads: (comp, offsets, lengths, sizes)."""
    p = tmp_path_factory.mktemp("native_inflate") / "r.bam"
    random_bam(p, seed=9, n_records=(600, 800))
    metas = blocks_metadata(p)
    with open_channel(p) as ch:
        comp, offs, lens = read_run_payloads(ch, metas)
    sizes = np.array([m.uncompressed_size for m in metas], np.int64)
    return (np.ascontiguousarray(comp, np.uint8), np.asarray(offs, np.int64),
            np.asarray(lens, np.int64), sizes)


def _zlib(comp, offs, lens) -> bytes:
    return b"".join(zlib.decompress(comp[o: o + n].tobytes(), -15)
                    for o, n in zip(offs, lens))


@pytest.mark.parametrize("slack", [0, 8])
def test_fast_inflate_gives_zlibs_bytes(payloads, slack):
    comp, offs, lens, sizes = payloads
    out_offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    out = np.zeros(int(sizes.sum()) + slack, np.uint8)
    assert build.inflate_blocks_fast_into(comp, offs, lens, out, out_offs,
                                          sizes) is True
    want = _zlib(comp, offs, lens)
    assert out[: len(want)].tobytes() == want
    jout = np.zeros_like(out)
    assert jn.inflate_blocks_fast_into(comp, offs, lens, jout, out_offs,
                                       sizes)
    assert np.array_equal(out, jout)


def test_zlib_inflate_equals_jax(payloads):
    comp, offs, lens, sizes = payloads
    got = build.inflate_blocks_native(comp, offs, lens, sizes)
    assert got.tobytes() == _zlib(comp, offs, lens)
    assert np.array_equal(got, jn.inflate_blocks_native(comp, offs, lens,
                                                        sizes))


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return ("raised", type(e).__name__)


def test_damaged_payloads_end_as_jax(payloads):
    """Seeded byte mutants of single payloads: the fast inflate (its zlib
    re-run included) and the zlib inflate end as the JAX wrappers do,
    with the same bytes or the same error class."""
    comp, offs, lens, sizes = payloads
    rng = np.random.default_rng(3)
    outcomes = set()
    for trial in range(40):
        i = int(rng.integers(0, len(offs)))
        data = comp[offs[i]: offs[i] + lens[i]].copy()
        hits = rng.integers(0, len(data), 1 + trial % 4)
        data[hits] ^= rng.integers(1, 256, len(hits), dtype=np.uint8)
        one = (np.array([0], np.int64), np.array([len(data)], np.int64))
        size = np.array([sizes[i]], np.int64)
        got_out = np.zeros(int(sizes[i]) + 8, np.uint8)
        want_out = np.zeros_like(got_out)
        got = _outcome(build.inflate_blocks_fast_into, data, *one, got_out,
                       np.zeros(1, np.int64), size)
        want = _outcome(jn.inflate_blocks_fast_into, data, *one, want_out,
                        np.zeros(1, np.int64), size)
        assert got == want, trial
        if got[0] == "ok":
            assert np.array_equal(got_out, want_out), trial
        zgot = _outcome(build.inflate_blocks_native, data, *one, size)
        zwant = _outcome(jn.inflate_blocks_native, data, *one, size)
        assert (zgot[0], zgot[1] if zgot[0] == "raised" else
                zgot[1].tobytes()) == (zwant[0], zwant[1] if zwant[0] ==
                                       "raised" else zwant[1].tobytes())
        outcomes.add(got[0])
    assert outcomes == {"ok", "raised"}


def test_inflate_refuses_ranges_outside_its_buffers(payloads):
    comp, offs, lens, sizes = payloads
    out = np.zeros(int(sizes.sum()), np.uint8)
    out_offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    with pytest.raises(ValueError, match="outside comp"):
        build.inflate_blocks_fast_into(comp, offs, lens + len(comp), out,
                                       out_offs, sizes)
    with pytest.raises(ValueError, match="outside out"):
        build.inflate_blocks_fast_into(comp, offs, lens, out[:-1], out_offs,
                                       sizes)
    with pytest.raises(ValueError, match="uint8"):
        build.inflate_blocks_fast_into(comp, offs, lens,
                                       out.astype(np.int16), out_offs, sizes)


def test_tokenize_deflate_native_equals_jax():
    cases = [(d, c) for d, c in dc.random_streams(12, seed=2).values()
             if len(zlib.decompress(d[:c], -15)) <= 65536]
    assert len(cases) >= 4
    comp = b"".join(d[:c] for d, c in cases)
    lens = np.array([c for _, c in cases], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    arr = np.frombuffer(comp, np.uint8)
    got = build.tokenize_deflate_native(arr, offs, lens, 65536)
    want = jn.tokenize_deflate_native(arr, offs, lens, stride=65536)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    bad = np.zeros(16, np.uint8)
    bad[0] = 0x07   # BTYPE 3: refused
    with pytest.raises(IOError, match="tokenize failed at block 0"):
        build.tokenize_deflate_native(bad, np.zeros(1, np.int64),
                                      np.full(1, 16, np.int64), 65536)


def test_build_raises_without_gxx(tmp_path, monkeypatch):
    """No ``g++`` on PATH and no library built: the yardstick raises, and
    nothing falls back to the NumPy checker."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_eager_lib", None)
    monkeypatch.setattr(build, "_zlib_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(build.NativeBuildError, match="eager.cpp"):
        build.eager_check_native(np.zeros(8, np.uint8), np.zeros(1),
                                 np.zeros(1, np.int32))
    with pytest.raises(build.NativeBuildError, match="inflate_zlib.cpp"):
        build.inflate_blocks_native(np.zeros(8, np.uint8),
                                    np.zeros(1, np.int64),
                                    np.full(1, 8, np.int64),
                                    np.ones(1, np.int64))
    assert not (tmp_path / "_build").exists()
