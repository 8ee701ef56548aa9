"""The port's host DEFLATE tokenizer (``native/tokenize.cpp``, built by
``native/build.py``) against the JAX package's native one, exactly.

Both libraries take the same payloads into planes filled with the same
sentinel bytes, so a row either writes, or leaves alone, compares too:
every edge stream of ``benchmarks/deflate_cases.py``, seeded valid streams
and 240 seeded byte-mutants give the same planes, ``out_lens`` and
returned 1-based index of the first refused payload, one row a call and
in batches. Rows the host tokenizer accepts equal the port's device
tokenizer's plain version. Then the packing (``pack_tokens``,
``_unpack_tokens``, ``tokenize_pack``) against the reference's bytes and
errors, and the build: named by the source's hash under ``_build/``,
raising without ``g++`` or on a source it refuses.
"""

import ctypes

import numpy as np
import pytest
import torch

from spark_bam_tpu.native import build as jax_native
from spark_bam_tpu.tpu import inflate as jinf
from spark_bam_tpu_torch.benchmarks import deflate_cases as dc
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf.flat import read_run_payloads
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.native import build
from spark_bam_tpu_torch.tpu import inflate as pinf
from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE, tokenize_plain
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SENTINEL = 0xA5


def _cases() -> dict:
    edges = dc.edge_cases()
    valid = dc.random_streams(24, seed=4)
    return edges | valid | dc.mutants(edges | valid, 240, seed=11)


@pytest.fixture(scope="module")
def cases():
    return _cases()


def _jax_lib():
    lib = jax_native.load_native()
    assert lib is not None, "the JAX package's native library must load"
    return lib


def _call(lib, comp, offsets, lengths, rows: int):
    """``(rc, lit, dist, out_lens)`` of one raw ``sbt_tokenize_deflate``
    call over sentinel-filled planes."""
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    lit = np.full((rows, STRIDE), SENTINEL, dtype=np.uint8)
    dist = np.full((rows, STRIDE), SENTINEL * 257, dtype=np.uint16)
    out_lens = np.full(rows, -7, dtype=np.int64)
    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    i64 = ctypes.c_int64
    rc = lib.sbt_tokenize_deflate(
        ptr(comp, ctypes.c_uint8), ptr(offsets, i64), ptr(lengths, i64),
        len(offsets), ptr(lit, ctypes.c_uint8), ptr(dist, ctypes.c_uint16),
        STRIDE, ptr(out_lens, i64))
    return int(rc), lit, dist, out_lens


def _batch(items):
    """One buffer holding each payload's first ``clen`` bytes."""
    comp = b"".join(data[:clen] for data, clen in items)
    lengths = np.array([clen for _, clen in items], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    return np.frombuffer(comp, dtype=np.uint8), offsets, lengths


def _assert_same(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert np.array_equal(x, y)


def test_library_builds_under_the_package_build_dir():
    path = build.build()
    assert path.parent == build.BUILD_DIR == (
        build.HERE.parent / "_build")
    assert path.name.startswith("libsbt_tokenize-") and path.exists()
    assert path == build.library_path()
    lib = build.load()
    # A CDLL (not a PyDLL): ctypes releases the GIL for every call, which
    # is what lets threads tokenize row ranges at once.
    assert type(lib) is ctypes.CDLL


def test_every_case_alone_equals_reference(cases):
    """One payload a call: planes, out_lens and the index, exactly."""
    jlib, plib = _jax_lib(), build.load()
    refused = 0
    for name, (data, clen) in cases.items():
        comp, offs, lens = _batch([(data, clen)])
        want = _call(jlib, comp, offs, lens, 1)
        got = _call(plib, comp, offs, lens, 1)
        _assert_same(got, want)
        refused += got[0] != 0
    assert 30 <= refused < len(cases) - 30   # both verdicts well covered


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batches_equal_reference(cases, seed):
    """Shuffled batches of 64 payloads: the first refused index and every
    row before it (and the untouched rows after) equal the reference's."""
    jlib, plib = _jax_lib(), build.load()
    rng = np.random.default_rng(seed)
    items = list(cases.values())
    order = rng.permutation(len(items))
    for lo in range(0, len(order), 64):
        batch = [items[i] for i in order[lo: lo + 64]]
        comp, offs, lens = _batch(batch)
        _assert_same(_call(plib, comp, offs, lens, len(batch)),
                     _call(jlib, comp, offs, lens, len(batch)))


def test_valid_batch_through_binding_equals_reference_binding(cases):
    """The port's ``tokenize_deflate`` on the accepted payloads against the
    reference's ``tokenize_deflate_native``."""
    plib = build.load()
    ok = [(d, c) for d, c in cases.values()
          if _call(plib, *_batch([(d, c)]), 1)[0] == 0]
    comp, offs, lens = _batch(ok)
    want_lit, want_dist, want_lens = jax_native.tokenize_deflate_native(
        comp, offs, lens, stride=STRIDE)
    lit = np.empty((len(ok), STRIDE), np.uint8)
    dist = np.empty((len(ok), STRIDE), np.uint16)
    out_lens = np.empty(len(ok), np.int64)
    assert build.tokenize_deflate(comp, offs, lens, lit, dist, out_lens) == 0
    assert np.array_equal(lit, want_lit) and np.array_equal(dist, want_dist)
    assert np.array_equal(out_lens, want_lens)


def test_verdicts_and_accepted_rows_equal_device_tokenizer_plain(cases):
    """The host tokenizer refuses exactly the payloads the port's device
    tokenizer (plain version) rejects, and where it accepts one, the planes
    and length are the device tokenizer's: one token convention and one
    verdict for both routes."""
    plib = build.load()
    fit = {k: v for k, v in cases.items() if v[1] + 8 <= 16384}
    staged, clens, names = dc.stage(fit, 16384)
    lit, dist, olens, ok = tokenize_plain(torch.from_numpy(staged),
                                          torch.from_numpy(clens))
    accepted = 0
    for i, name in enumerate(names):
        rc, hlit, hdist, hlens = _call(plib, *_batch([fit[name]]), 1)
        assert (rc == 0) == bool(ok[i]), name
        if rc:
            continue
        accepted += 1
        assert int(olens[i]) == int(hlens[0]), name
        assert np.array_equal(lit[i].numpy(), hlit[0]), name
        assert np.array_equal(dist[i].view(torch.int16).numpy()
                              .view(np.uint16), hdist[0]), name
    assert accepted >= 60 and len(names) - accepted >= 30


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A synthetic BAM's first 40 blocks as raw payloads."""
    path = tmp_path_factory.mktemp("tok") / "g.bam"
    synth_bam(str(path), 3 << 20, seed=5)
    metas = blocks_metadata(str(path))[:40]
    with open_channel(str(path)) as ch:
        comp, offs, lens = read_run_payloads(ch, metas)
    usizes = np.array([m.uncompressed_size for m in metas], dtype=np.int64)
    return comp, offs, lens, usizes


@pytest.mark.parametrize("b", [1, 5, 32, 33, 40])
@pytest.mark.parametrize("threads", [1, 3, 8])
def test_tokenize_pack_equals_reference_bytes(group, b, threads):
    """Packed bytes, out_lens and the real block count equal the
    reference's, the batch padded to a power of two; the thread split of
    the rows changes nothing."""
    comp, offs, lens, usizes = group
    want = jinf.tokenize_pack(comp, offs[:b], lens[:b], usizes[:b])
    packed, out_lens, nb = pinf.tokenize_pack(comp, offs[:b], lens[:b],
                                              usizes[:b], threads=threads)
    assert nb == want[2] == b
    assert np.array_equal(out_lens, want[1])
    assert packed.dtype == np.uint8 and np.array_equal(packed, want[0])
    assert len(packed) == pinf.packed_nbytes(b)


def test_tokenize_pack_into_a_dirty_buffer(group):
    """Writing into a reused buffer (a staging slot) gives the same bytes:
    the pad rows and every tail are rewritten."""
    comp, offs, lens, usizes = group
    buf = np.full(pinf.packed_nbytes(40) + 100, 0x5A, dtype=np.uint8)
    packed, _, _ = pinf.tokenize_pack(comp, offs[:33], lens[:33],
                                      usizes[:33], out=buf)
    want = jinf.tokenize_pack(comp, offs[:33], lens[:33], usizes[:33])[0]
    assert np.array_equal(packed, want)


def test_pack_and_unpack_equal_reference(group):
    import jax.numpy as jnp

    comp, offs, lens, usizes = group
    lit, dist, _ = jax_native.tokenize_deflate_native(comp, offs[:8],
                                                      lens[:8], STRIDE)
    want = jinf.pack_tokens(lit, dist)
    got = pinf.pack_tokens(lit, dist)
    assert np.array_equal(got, want)
    jl, jd = jinf._unpack_tokens(jnp.asarray(want))
    pl, pd = pinf._unpack_tokens(torch.from_numpy(got))
    assert pd.dtype == torch.uint16 and tuple(pl.shape) == (8, STRIDE)
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    assert np.array_equal(pd.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(jd))
    # Views, not copies: the planes share the packed buffer.
    assert pl.data_ptr() == got.ctypes.data


@pytest.mark.parametrize("fault", ["footer", "payload"])
def test_tokenize_pack_raises_as_reference(group, fault):
    comp, offs, lens, usizes = group
    comp = comp.copy()
    usizes = usizes[:6].copy()
    if fault == "footer":
        usizes[4] += 1
        match = "disagree with block footers"
    else:
        comp[offs[3]: offs[3] + 4] = 0xFF       # btype 3 on the first bits
        match = "deflate tokenize failed at block 3"
    with pytest.raises(IOError, match=match):
        jinf.tokenize_pack(comp, offs[:6], lens[:6], usizes)
    for threads in (1, 4):
        with pytest.raises(pinf.TokenizeError, match=match):
            pinf.tokenize_pack(comp, offs[:6], lens[:6], usizes,
                               threads=threads)


def test_build_raises_without_gxx(tmp_path, monkeypatch):
    """No ``g++`` on PATH and no library built: the build raises, and
    nothing falls back to another tokenizer."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(build.NativeBuildError, match="g\\+\\+ not found"):
        build.load()
    with pytest.raises(build.NativeBuildError):
        pinf.tokenize_pack(np.zeros(8, np.uint8), np.zeros(1, np.int64),
                           np.full(1, 8, np.int64), np.zeros(1, np.int64))
    assert not (tmp_path / "_build").exists()


def test_build_raises_on_a_refused_source(tmp_path, monkeypatch):
    bad = tmp_path / "tokenize.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SRC", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(build.NativeBuildError, match="g\\+\\+ failed"):
        build.load()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_binding_refuses_mismatched_planes():
    comp = np.zeros(16, np.uint8)
    offs, lens = np.zeros(2, np.int64), np.full(2, 8, np.int64)
    with pytest.raises(ValueError):
        build.tokenize_deflate(comp, offs, lens, np.zeros((1, 64), np.uint8),
                               np.zeros((2, 64), np.uint16),
                               np.zeros(2, np.int64))
    with pytest.raises(ValueError, match="outside comp"):
        build.tokenize_deflate(comp, offs, lens * 3,
                               np.zeros((2, 64), np.uint8),
                               np.zeros((2, 64), np.uint16),
                               np.zeros(2, np.int64))
