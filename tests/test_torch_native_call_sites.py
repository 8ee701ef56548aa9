"""The port's native engine at the reference's three host call sites, each
held against the JAX package:

- the deferral resolver's verdict projection (``_Deferred.resolve`` with
  ``fields == ("verdict",)``) retires escaped lanes through
  ``eager_check_window_native`` on every window, so ``spans()`` and
  ``record_starts()`` come out in the reference's stream order on long
  reads; the flag projections keep ``check_flat`` behind the growth gate;
- the sharded escape patch (``_exact_row_true_positions``) walks its row
  in chunks of ``PATCH_CHUNK_POSITIONS`` candidates with the tri-state
  checker;
- ``bgzf/flat.py::inflate_blocks`` inflates through
  ``inflate_blocks_fast_into`` in slices on threads, with the port's
  CRC-32 check and error classes kept.
"""

import zlib

import jax
import numpy as np
import pytest

from spark_bam_tpu.bgzf.flat import inflate_blocks as jax_inflate_blocks
from spark_bam_tpu.bgzf.index_blocks import blocks_metadata as jax_metadata
from spark_bam_tpu.core.channel import open_channel as jax_open_channel
from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.parallel import mesh as jmesh
from spark_bam_tpu.parallel import stream_mesh as jsm
from spark_bam_tpu.tpu.stream_check import StreamChecker as JaxStreamChecker
from spark_bam_tpu_torch import Config, StreamChecker, make_mesh, obs
from spark_bam_tpu_torch.benchmarks import load_cases
from spark_bam_tpu_torch.benchmarks.synth import BGZF_EOF, synth_bam
from spark_bam_tpu_torch.bgzf import flat
from spark_bam_tpu_torch.bgzf.block import BgzfError
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.compress.huffman import bgzf_member
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.faults import BlockCorruptionError
from spark_bam_tpu_torch.native import build as native_build
from spark_bam_tpu_torch.parallel import stream_mesh as psm
from spark_bam_tpu_torch.tpu import stream_check
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEOMETRIES = [(256 << 10, 64 << 10), (64 << 10, 16 << 10)]


@pytest.fixture(scope="module")
def long_bam(tmp_path_factory):
    """16 reads of 60-110 kb: ten-record chains outrun every halo here."""
    p = tmp_path_factory.mktemp("native_sites_long") / "l.bam"
    synth_bam(p, 2 << 20, seed=9, unit_reads=8, read_len=(60_000, 110_000))
    return p


# ------------------------------------------------- stream order (the fault)
def _emissions(stream):
    """``[(base, len, *arrays)]`` of a span stream, in emission order."""
    return [(int(base), len(arrays[0]), *arrays) for base, *arrays in stream]


def _assert_same_emissions(got, want):
    assert [e[:2] for e in got] == [e[:2] for e in want]
    for g, w in zip(got, want):
        for a, b in zip(g[2:], w[2:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("geo", GEOMETRIES, ids=["256k", "64k"])
def test_spans_emission_order_equals_jax(long_bam, geo):
    want = _emissions(JaxStreamChecker(long_bam, JaxConfig(), *geo,
                                       use_device=False).spans())
    got = _emissions(StreamChecker(long_bam, Config(), *geo,
                                   device="cpu").spans())
    _assert_same_emissions(got, [(b, n, v.astype(bool)) for b, n, v in want])


@pytest.mark.parametrize("geo", GEOMETRIES, ids=["256k", "64k"])
def test_record_starts_stream_order_equals_jax(long_bam, geo):
    want = np.concatenate(list(JaxStreamChecker(
        long_bam, JaxConfig(), *geo, use_device=False).record_starts()))
    got = np.concatenate(list(StreamChecker(
        long_bam, Config(), *geo, device="cpu").record_starts()))
    assert len(got) == 16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=["256k", "64k"])
def test_full_spans_emission_order_equals_jax(long_bam, geo):
    want = _emissions(JaxStreamChecker(long_bam, JaxConfig(), *geo,
                                       use_device=False).full_spans())
    got = _emissions(StreamChecker(long_bam, Config(), *geo,
                                   device="cpu").full_spans())
    _assert_same_emissions(got, want)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_verdict_projection_runs_the_native_walk(long_bam, monkeypatch):
    """``spans()`` retires its deferrals through the tri-state walk on
    every window and never through ``check_flat``; the flag projection
    still runs ``check_flat``."""
    native = _spy(monkeypatch, native_build, "eager_check_window_native")
    flags = _spy(monkeypatch, stream_check, "check_flat")
    geo = GEOMETRIES[0]
    sc = StreamChecker(long_bam, Config(), *geo, device="cpu")
    reg = obs.configure()
    try:
        list(sc.spans())
        retries = reg.counter("check.defer_retries").value
        resolved = reg.counter("check.defer_resolved").value
    finally:
        obs.shutdown()
    assert flags == []
    assert len(native) == retries > 0
    assert resolved > 0
    list(StreamChecker(long_bam, Config(), *geo, device="cpu").full_spans())
    assert len(flags) > 0


def test_deferral_counters_equal_jax(long_bam):
    geo = GEOMETRIES[1]
    from spark_bam_tpu import obs as jobs

    jobs.shutdown()
    jr = jobs.configure()
    try:
        list(JaxStreamChecker(long_bam, JaxConfig(), *geo,
                              use_device=False).spans())
        want = {k: jr.counter(k).value
                for k in ("check.defer_retries", "check.defer_resolved")}
    finally:
        jobs.shutdown()
    reg = obs.configure()
    try:
        list(StreamChecker(long_bam, Config(), *geo, device="cpu").spans())
        got = {k: reg.counter(k).value for k in want}
    finally:
        obs.shutdown()
    assert got == want
    assert want["check.defer_resolved"] > 0


# ------------------------------------------------------ the sharded patch
@pytest.fixture(scope="module")
def sharded_pair(long_bam):
    geo = dict(window_uncompressed=128 << 10, halo=32 << 10)
    jst = jsm._ShardedStream(long_bam, JaxConfig(),
                             jmesh.make_mesh(jax.devices()[:2]),
                             geo["window_uncompressed"], geo["halo"], None)
    pst = psm._ShardedStream(long_bam, Config(), make_mesh(["cpu"] * 2),
                             geo["window_uncompressed"], geo["halo"], None)
    return jst, pst


@pytest.mark.parametrize("chunk", [1 << 20, 4096], ids=["default", "4096"])
def test_exact_row_true_positions_equals_jax(sharded_pair, long_bam, chunk,
                                             monkeypatch):
    jst, pst = sharded_pair
    assert psm.PATCH_CHUNK_POSITIONS == 1 << 20
    monkeypatch.setattr(psm, "PATCH_CHUNK_POSITIONS", chunk)
    flags = _spy(monkeypatch, psm, "check_flat")
    native = _spy(monkeypatch, native_build, "eager_check_window_native")
    reg = obs.configure()
    try:
        with jax_open_channel(long_bam) as jch, open_channel(long_bam) as ch:
            for g in range(len(pst.groups)):
                for clamp in (0, pst.header_end):
                    want = jsm._exact_row_true_positions(jst, g, clamp, jch)
                    got = psm._exact_row_true_positions(pst, g, clamp, ch)
                    np.testing.assert_array_equal(got, want)
        chunks = reg.counter("mesh.patch_chunks").value
        seen = reg.histogram("mesh.patch_chunk_positions").max
    finally:
        obs.shutdown()
    assert flags == []
    assert chunks > 0 and seen <= chunk
    assert max(len(args[1]) for args in native) <= chunk
    if chunk == 4096:
        assert chunks > 2 * len(pst.groups)


# ---------------------------------------------------------- host inflate
def _mixed_levels_bam(path) -> None:
    """A small BAM's bytes re-blocked with stored (level 0), fixed-Huffman,
    dynamic and level-1 DEFLATE blocks in turn."""
    src = path.with_suffix(".src.bam")
    random_bam(src, seed=23, read_len=(10, 2000))
    data = flat.flatten_file(src).data.tobytes()
    out = bytearray()
    modes = [(0, zlib.Z_DEFAULT_STRATEGY), (6, zlib.Z_FIXED),
             (6, zlib.Z_DEFAULT_STRATEGY), (1, zlib.Z_DEFAULT_STRATEGY)]
    for k, i in enumerate(range(0, len(data), 9000)):
        chunk = data[i: i + 9000]
        level, strategy = modes[k % len(modes)]
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
        body = co.compress(chunk) + co.flush()
        out += bgzf_member(body, zlib.crc32(chunk), len(chunk))
    path.write_bytes(bytes(out) + BGZF_EOF)


@pytest.fixture(scope="module")
def inflate_bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_sites_inflate")
    bams = {}
    for seed, size in ((7, 17 << 20), (8, 2 << 20)):
        bams[f"synth{seed}"] = d / f"s{seed}.bam"
        synth_bam(bams[f"synth{seed}"], size, seed=seed)
    bams["random"] = d / "r.bam"
    random_bam(bams["random"], seed=81, read_len=(10, 400),
               n_records=(300, 500))
    bams["load_edges"] = d / "edges.bam"
    load_cases.write_bam(bams["load_edges"])
    bams["refused_mid"] = d / "refused.bam"
    load_cases.write_refused_mid_bam(bams["refused_mid"])
    bams["seqdoop_trap"] = d / "trap.bam"
    load_cases.write_seqdoop_trap_bam(bams["seqdoop_trap"])
    bams["mixed_levels"] = d / "mixed.bam"
    _mixed_levels_bam(bams["mixed_levels"])
    return bams


def _runs(metas):
    """The whole file, a run of one slice, a short run of a few slices, and
    a run from the middle."""
    n = len(metas)
    return [metas, metas[: min(n, 2 * flat.SLICE_BLOCKS - 1)],
            metas[: min(n, 20)], metas[n // 3: n // 3 + 40]]


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("case", ["synth7", "synth8", "random", "load_edges",
                                  "refused_mid", "seqdoop_trap",
                                  "mixed_levels"])
def test_inflate_blocks_equals_jax(inflate_bams, case, threads, monkeypatch):
    path = inflate_bams[case]
    metas = blocks_metadata(path)
    jmetas = list(jax_metadata(path))
    slices = _spy(monkeypatch, native_build, "inflate_blocks_fast_into")
    reg = obs.configure()
    try:
        with open_channel(path) as ch, jax_open_channel(path) as jch:
            for run, jrun in zip(_runs(metas), _runs(jmetas)):
                if not run:
                    continue
                del slices[:]
                view = flat.inflate_blocks(ch, run, threads)
                want = jax_inflate_blocks(jch, jrun, threads=threads)
                total = sum(m.uncompressed_size for m in run)
                assert view.size == len(view.data) == total
                np.testing.assert_array_equal(view.data, want.data)
                np.testing.assert_array_equal(view.block_flat,
                                              want.block_flat)
                assert len(slices) == flat.slice_count(len(run), threads)
        spans = [e for e in reg.events() if e["name"] == "inflate.window"]
    finally:
        obs.shutdown()
    assert spans and all(e["attrs"]["engine"] == "native" for e in spans)
    if case == "synth7" and threads == 8:
        assert len(metas) > 32 * threads   # the reference's eight slices too


def test_inflate_blocks_keeps_slack_out_of_the_view(inflate_bams):
    with open_channel(inflate_bams["synth8"]) as ch:
        metas = blocks_metadata(inflate_bams["synth8"])
        view = flat.inflate_blocks(ch, metas)
    total = sum(m.uncompressed_size for m in metas)
    assert view.data.shape == (total,)
    assert view.data.base is not None and view.data.base.nbytes == total + 8


def _rewrite_block(path, k: int, fn) -> int:
    """Replace block ``k`` of ``path`` with ``fn(payload, data)``'s
    ``(body, crc, isize)``; returns the block's offset."""
    metas = blocks_metadata(path)
    m = metas[k]
    blob = bytearray(path.read_bytes())
    block = bytes(blob[m.start: m.start + m.compressed_size])
    payload = block[18:-8]
    data = zlib.decompress(payload, -15)
    new = bgzf_member(*fn(payload, data))
    blob[m.start: m.start + m.compressed_size] = new
    path.write_bytes(bytes(blob))
    return m.start


#: Damage to a block: ``(payload, data) -> (body, crc, isize)``.
DAMAGE = {
    "crc": lambda b, d: (b, zlib.crc32(d) ^ 1, len(d)),   # a wrong CRC
    "short": lambda b, d: (b, zlib.crc32(d), len(d) + 1),  # ISIZE past data
    "broken": lambda b, d: (b"\xff" * 64, zlib.crc32(d), len(d)),  # no DEFLATE
}


def _damaged(tmp_path, **faults):
    """A seed-8 synth with block ``faults[kind]`` damaged by each kind of
    ``DAMAGE``; returns it and each damaged block's offset."""
    p = tmp_path / "d.bam"
    synth_bam(p, 4 << 20, seed=8)
    starts = {kind: _rewrite_block(p, k, DAMAGE[kind])
              for kind, k in faults.items()}
    return p, starts


def _per_block_error(path, metas, verify_crc: bool):
    """The error the per-block zlib route raises on ``metas``, in file
    order (the route ``inflate_blocks`` took before the fast inflate)."""
    with open_channel(path) as ch:
        comp, offsets, lengths = flat.read_run_payloads(ch, metas)
        for i, m in enumerate(metas):
            out = np.empty(m.uncompressed_size, dtype=np.uint8)
            try:
                flat._inflate_into(comp, int(offsets[i]), int(lengths[i]),
                                   out, m.uncompressed_size,
                                   m.start if verify_crc else None)
            except Exception as e:   # noqa: BLE001 (the class is compared)
                return e
    raise AssertionError("no block is damaged")


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("faults,verify_crc,cls", [
    (dict(crc=5), True, BlockCorruptionError),
    (dict(crc=5, broken=60), True, BlockCorruptionError),
    (dict(short=9), False, BgzfError),
    (dict(short=9), True, BlockCorruptionError),
    (dict(broken=40), False, zlib.error),
    (dict(broken=40), True, BlockCorruptionError),
], ids=["crc", "crc_before_broken", "short", "short_crc", "broken",
        "broken_crc"])
def test_damaged_blocks_raise_as_before(tmp_path, faults, verify_crc, cls,
                                        threads):
    path, starts = _damaged(tmp_path, **faults)
    metas = blocks_metadata(path)
    want = _per_block_error(path, metas, verify_crc)
    assert type(want) is cls
    with open_channel(path) as ch, pytest.raises(cls) as got:
        flat.inflate_blocks(ch, metas, threads, verify_crc=verify_crc)
    assert str(got.value) == str(want)
    if "crc" in faults:
        assert str(starts["crc"]) in str(got.value)


def test_a_library_that_does_not_load_raises(inflate_bams, monkeypatch):
    """No silent zlib route: a native library that fails to load raises
    from ``inflate_blocks``."""
    def no_library():
        raise OSError("libsbt_eager.so: cannot open shared object file")

    monkeypatch.setattr(native_build, "load_native", no_library)
    path = inflate_bams["synth8"]
    with open_channel(path) as ch, pytest.raises(OSError, match="cannot open"):
        flat.inflate_blocks(ch, blocks_metadata(path))


@pytest.mark.parametrize("exc", [OSError("a failure of the call"),
                                 zlib.error("a failure of the call")])
def test_a_native_failure_on_clean_data_raises(inflate_bams, monkeypatch,
                                               exc):
    """A failure of the native call on a run whose every block inflates
    (so not the data's) raises as it is, after the per-block route found
    no damaged block: the run is never handed out as inflated."""
    def failing(*args, **kwargs):
        raise exc

    monkeypatch.setattr(native_build, "inflate_blocks_fast_into", failing)
    path = inflate_bams["synth8"]
    with open_channel(path) as ch, pytest.raises(type(exc)) as got:
        flat.inflate_blocks(ch, blocks_metadata(path), verify_crc=True)
    assert got.value is exc


@pytest.mark.parametrize("blocks,threads", [(0, 8), (1, 8), (31, 8),
                                            (64, 8), (5000, 8), (5000, 1)])
def test_slice_count_bounds(blocks, threads):
    """One slice at the least, ``threads`` at the most, and never a slice
    of fewer than ``SLICE_BLOCKS`` blocks beyond the first."""
    n = flat.slice_count(blocks, threads)
    assert 1 <= n <= threads
    assert n == 1 or blocks // n >= flat.SLICE_BLOCKS


def test_crc_check_passes_clean_runs(inflate_bams):
    path = inflate_bams["mixed_levels"]
    metas = blocks_metadata(path)
    with open_channel(path) as ch:
        checked = flat.inflate_blocks(ch, metas, verify_crc=True)
        plain = flat.inflate_blocks(ch, metas)
    np.testing.assert_array_equal(checked.data, plain.data)
