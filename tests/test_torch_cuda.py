"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test takes the ``gpu`` fixture, which skips where no
CUDA device is present. Imports only torch, numpy and the port, so it runs
on a GPU host without JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``). Comparisons are exact.
"""

import zlib

import numpy as np
import pytest
import torch

from spark_bam_tpu_torch import (
    Config,
    StreamChecker,
    full_check_summary_streaming,
)
from spark_bam_tpu_torch.benchmarks.deflate_cases import (
    EXPECT_REJECT,
    edge_cases,
    mutants,
    random_streams,
    stage,
)
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.tpu import kernels as K
from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE

pytestmark = pytest.mark.cuda

COUNT_KERNELS = ("tokenize", "lz77_resolve", "prefilter_check_flags")
FULL_CHECK_KERNELS = ("tokenize", "lz77_resolve", "full_check_flags")


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA unavailable)")
    return torch.device("cuda", 0)


def _u16(t):
    return t.cpu().view(torch.int16).long() & 0xFFFF


def test_prefilter_kernel_matches_plain(gpu):
    rng = np.random.default_rng(1)
    w = 1 << 20
    for n in (w, w - 999):
        padded = torch.from_numpy(
            rng.integers(0, 256, w + K.PAD, dtype=np.uint8)).to(gpu)
        lens = torch.from_numpy(
            rng.integers(0, 1 << 31, 1024, dtype=np.int64).astype(np.int32)
        ).to(gpu)
        got = K.prefilter_check_flags(padded, lens, 7, n)
        want = K._prefilter_flags(padded, lens, 7, n)
        assert torch.equal(got, want)


def test_lz77_kernel_matches_plain(gpu):
    rng = np.random.default_rng(2)
    lit = torch.from_numpy(rng.integers(0, 256, (8, STRIDE), dtype=np.uint8))
    i = np.arange(STRIDE)
    d = (rng.random((8, STRIDE)) * np.minimum(i, 32768)).astype(np.int64)
    d[0, 1:] = 1
    dist = torch.from_numpy(d.astype(np.uint16))
    lit, dist = lit.to(gpu), dist.to(gpu)
    want, want_rounds = K._resolve_body(lit, dist)
    got, rounds = K.lz77_resolve(lit, dist)
    assert torch.equal(got, want)
    assert int(rounds) <= int(want_rounds) == 16
    donor = lit.clone()                      # in place, as the main path does
    K.lz77_resolve(donor, dist, out=donor)
    assert torch.equal(donor, want)


def _tokenize_both(staged, clens, gpu):
    """(kernel, plain) outputs on CPU tensors for one staged batch."""
    staged, clens = torch.from_numpy(staged), torch.from_numpy(clens)
    want = K.tokenize(staged, clens)
    got = K.tokenize(staged.to(gpu), clens.to(gpu))
    torch.cuda.synchronize()
    return [t.cpu() for t in got], want


def _assert_tokens_equal(got, want, names):
    for what, g, w in zip(("lit", "dist", "out_len", "ok"), got, want):
        if g.dtype == torch.uint16:
            g, w = _u16(g), _u16(w)
        bad = (g != w).reshape(g.shape[0], -1).any(1).nonzero().flatten()
        assert bad.numel() == 0, (
            f"{what} differs on rows "
            f"{[names[i] if i < len(names) else 'pad' for i in bad[:8]]}")


def test_tokenize_kernel_matches_plain(gpu):
    rng = np.random.default_rng(3)
    datas = [b"the quick brown fox " * 300, b"z" * 60_000, b"",
             rng.integers(0, 256, 9_000, dtype=np.uint8).tobytes(),
             b"z" * 70_000]
    comps = []
    for j, d in enumerate(datas):
        co = zlib.compressobj(9 if j % 2 else 1, zlib.DEFLATED, -15)
        comps.append(co.compress(d) + co.flush())
    for j in range(24):
        c = bytearray(comps[j % 4])
        if c:
            for h in rng.integers(0, len(c), 1 + j % 3):
                c[h] ^= int(rng.integers(1, 256))
        comps.append(bytes(c))
    staged = np.zeros((32, 16384), dtype=np.uint8)
    clens = np.zeros(32, dtype=np.int32)
    for r, c in enumerate(comps):
        staged[r, : len(c)] = np.frombuffer(c, dtype=np.uint8)
        clens[r] = len(c)
    got, want = _tokenize_both(staged, clens, gpu)
    _assert_tokens_equal(got, want, [f"stream {i}" for i in range(32)])
    assert bool(want[3][:4].all()) and not bool(want[3][4])

    # The shared edge set and 300 seeded mutants, at a row width that is
    # not a multiple of 4 (rows start at every byte alignment) and at the
    # least one (the last row's slack ends the tensor).
    cases = edge_cases()
    cases.update(mutants(cases, 300, seed=11))
    tight = max(clen for _, clen in cases.values()) + 8
    for c_pad in (16384, 16387, tight):
        staged, clens, names = stage(cases, c_pad, len(cases) + 3)
        got, want = _tokenize_both(staged, clens, gpu)
        _assert_tokens_equal(got, want, names)
        for i, name in enumerate(names):
            if name in EXPECT_REJECT:
                assert not want[3][i], name
            elif not name.startswith("mutant_"):
                assert want[3][i], name


def test_tokenize_kernel_on_random_zlib_streams(gpu):
    """zlib's own code shapes (random levels, windows, memory levels and
    strategies over varied bytes) and seeded mutants of them."""
    cases = random_streams(200, seed=5)
    cases.update(mutants(cases, 800, seed=6))
    c_pad = max(clen for _, clen in cases.values()) + 11
    staged, clens, names = stage(cases, c_pad)
    got, want = _tokenize_both(staged, clens, gpu)
    _assert_tokens_equal(got, want, names)
    assert int(want[3][:200].sum()) > 150   # most valid streams fit a row


def test_wrappers_check_their_inputs(gpu):
    with pytest.raises(TypeError):
        K.prefilter_check_flags(torch.zeros(K.PAD + 64, device=gpu),
                                torch.zeros(4, dtype=torch.int32, device=gpu),
                                1, 1)
    with pytest.raises(ValueError, match="4-byte boundary"):
        K.prefilter_check_flags(
            torch.zeros(K.PAD + 65, dtype=torch.uint8, device=gpu)[1:],
            torch.zeros(4, dtype=torch.int32, device=gpu), 1, 1)
    with pytest.raises(ValueError, match="16-byte boundary"):
        K.tokenize(
            torch.zeros(132, dtype=torch.uint8, device=gpu)[4:].view(2, 64),
            torch.zeros(2, dtype=torch.int32, device=gpu))
    with pytest.raises(ValueError):
        K.lz77_resolve(torch.zeros((1, 100), dtype=torch.uint8, device=gpu),
                       torch.zeros((1, 100), dtype=torch.uint16, device=gpu))


def test_count_on_gpu_equals_cpu(gpu, tmp_path):
    p = tmp_path / "g.bam"
    m = synth_bam(p, 3 << 20, seed=5, unit_reads=2000)
    K.reset_launch_counts()
    sc = StreamChecker(p, Config(), window_uncompressed=1 << 20,
                       halo=256 << 10)
    assert sc.count_reads() == m["reads"]
    assert all(K.LAUNCHES[k] > 0 for k in COUNT_KERNELS)
    cpu = StreamChecker(p, Config(fused_count=False),
                        window_uncompressed=1 << 20, halo=256 << 10,
                        device="cpu")
    assert cpu.count_reads() == m["reads"]


def test_default_geometry_small_file_launches_every_kernel(gpu, tmp_path):
    """A BAM of a few MiB at the default 24 MiB window / 4 MiB halo runs
    the fused loop on the card: all three kernels launch, none demotes."""
    p = tmp_path / "small.bam"
    m = synth_bam(p, 5 << 20, seed=6, unit_reads=2000)
    K.reset_launch_counts()
    sc = StreamChecker(p, Config())
    assert sc.count_reads() == m["reads"]
    assert sc.tokenize_demotions == 0
    assert all(K.LAUNCHES[k] > 0 for k in COUNT_KERNELS), K.LAUNCHES


@pytest.mark.parametrize("kind", ["random", "0x88", "bam"])
def test_full_flags_kernel_matches_plain(gpu, kind, tmp_path):
    rng = np.random.default_rng(4)
    w = 1 << 20
    if kind == "random":
        data = rng.integers(0, 256, w + K.PAD, dtype=np.uint8)
    elif kind == "0x88":
        data = np.full(w + K.PAD, 0x88, dtype=np.uint8)
    else:
        from spark_bam_tpu_torch.bgzf.flat import inflate_blocks
        from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
        from spark_bam_tpu_torch.core.channel import open_channel

        p = tmp_path / "f.bam"
        synth_bam(p, 2 << 20, seed=4, unit_reads=2000)
        with open_channel(p) as ch:
            flat = inflate_blocks(ch, blocks_metadata(p)).data
        data = np.zeros(w + K.PAD, dtype=np.uint8)
        data[:w] = flat[:w]
    padded = torch.from_numpy(data).to(gpu)
    lens = torch.zeros(1024, dtype=torch.int32)
    lens[:2] = torch.tensor([248_956_422, 242_193_529])
    lens = lens.to(gpu)
    for n in (w, w - 12345):
        got = K.full_check_flags(padded, lens, 2, n)
        want = K._compute_flags(padded, lens, 2, n)
        assert torch.equal(got, want), (kind, n)


def test_full_check_on_gpu_equals_cpu(gpu, tmp_path):
    p = tmp_path / "fc.bam"
    synth_bam(p, 3 << 20, seed=5, unit_reads=2000)
    K.reset_launch_counts()
    kw = dict(window_uncompressed=1 << 20, halo=256 << 10)
    card = full_check_summary_streaming(p, Config(), **kw)
    assert all(K.LAUNCHES[k] > 0 for k in FULL_CHECK_KERNELS), K.LAUNCHES
    host_zlib = full_check_summary_streaming(
        p, Config(device_inflate=False), **kw)
    cpu = full_check_summary_streaming(p, Config(), device="cpu", **kw)
    for other in (cpu, host_zlib):
        assert card.keys() == other.keys()
        for k in card:
            if isinstance(card[k], np.ndarray):
                np.testing.assert_array_equal(card[k], other[k])
            else:
                assert card[k] == other[k], k
