"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test takes the ``gpu`` fixture, which skips where no
CUDA device is present. Imports only torch, numpy and the port, so it runs
on a GPU host without JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``). Comparisons are exact.
"""

import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_bam_tpu_torch import (
    Config,
    StreamChecker,
    full_check_summary_streaming,
)
from spark_bam_tpu_torch.benchmarks import prefilter_cases, resolve_flag_cases
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


def _assert_prefilter_equal(got, want, label):
    """Kernel against plain: flags, candidates and survivor count."""
    for what, g, w_ in zip(("F", "cand", "n_set"), got, want):
        assert g.dtype == w_.dtype == torch.int32, (label, what)
        assert g.shape == w_.shape, (label, what)
        assert torch.equal(g, w_), (label, what)


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
        want = K._prefilter_compact(padded, lens, 7, n, K.lane_capacity(w))
        _assert_prefilter_equal(got, want, n)
        assert torch.equal(got[0], K._prefilter_flags(padded, lens, 7, n))


@pytest.mark.parametrize("w", [1 << 17, 1 << 20])
def test_prefilter_kernel_on_edge_windows(gpu, w):
    """The shared prefilter edge set and the overflowing soup, each window
    run twice back to back on one stream's tile records."""
    cases = prefilter_cases.prefilter_windows(w, seed=5)
    cases["overflow_soup"] = prefilter_cases.overflow_soup(w)
    for name, (padded, n, lens, nc) in cases.items():
        buf = torch.from_numpy(padded).to(gpu)
        lt = torch.from_numpy(lens).to(gpu)
        cap = K.lane_capacity(buf.numel() - K.PAD)
        want = K._prefilter_compact(buf, lt, nc, n, cap)
        first = K.prefilter_check_flags(buf, lt, nc, n)
        second = K.prefilter_check_flags(buf, lt, nc, n)
        _assert_prefilter_equal(first, want, name)
        _assert_prefilter_equal(second, want, name)


def test_prefilter_kernel_on_two_streams(gpu):
    """Launches on two streams at once keep their own tile records; a
    stream's second launch after the other's first still matches."""
    cases = prefilter_cases.prefilter_windows(1 << 20, seed=6)
    names = ["random_with_records", "count_capacity_plus_1",
             "tail_crosses_tile", "count_2x_capacity"]
    side = torch.cuda.Stream(gpu)
    bufs = {k: (torch.from_numpy(cases[k][0]).to(gpu), cases[k][1],
                torch.from_numpy(cases[k][2]).to(gpu), cases[k][3])
            for k in names}
    torch.cuda.synchronize()
    got = {}
    for rep in range(3):
        for j, k in enumerate(names):
            buf, n, lt, nc = bufs[k]
            stream = side if j % 2 else torch.cuda.current_stream(gpu)
            with torch.cuda.stream(stream):
                got[(rep, k)] = K.prefilter_check_flags(buf, lt, nc, n)
    torch.cuda.synchronize()
    for (rep, k), out in got.items():
        buf, n, lt, nc = bufs[k]
        want = K._prefilter_compact(buf, lt, nc, n, K.lane_capacity(1 << 20))
        _assert_prefilter_equal(out, want, (rep, k))


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


@pytest.mark.parametrize("b", [1, 133, 512])
def test_lz77_kernel_on_edge_rows(gpu, b):
    """The shared token-row edge set in batches of 1, 133 and 512 rows (not
    multiples of the SM count), out of place and in place; rounds never
    exceed the plain version's, batch and row by row."""
    rows = resolve_flag_cases.token_rows(b)
    names = list(rows)
    pick = [names[k % len(names)] for k in range(b)]
    if b == 1:
        pick = ["rle_distance_1"]
    lit, dist = (torch.from_numpy(a).to(gpu)
                 for a in resolve_flag_cases.stack_rows(rows, pick))
    want, want_rounds = K._resolve_body(lit, dist)
    got, rounds = K.lz77_resolve(lit, dist)
    assert torch.equal(got, want)
    assert int(rounds) <= int(want_rounds) <= 16
    donor = lit.clone()
    _, in_place_rounds = K.lz77_resolve(donor, dist, out=donor)
    assert torch.equal(donor, want)
    assert int(in_place_rounds) <= int(want_rounds)
    if b == 133:
        for name in names:
            one = [torch.from_numpy(a[None]).to(gpu) for a in rows[name]]
            w1, r1 = K._resolve_body(*one)
            g1, k1 = K.lz77_resolve(*one)
            assert torch.equal(g1, w1), name
            assert int(k1) <= int(r1), name


@pytest.mark.parametrize("w", [1 << 20, 1 << 25])
def test_full_flags_kernel_on_edge_windows(gpu, w):
    """The shared flag-window edge set at 2^20 and 2^25 bytes (at 2^25
    most tiles are not yet resident when the first ones look ahead), each
    window run twice in a row on the same stream's status records."""
    lens = torch.zeros(1024, dtype=torch.int32)
    lens[:2] = torch.tensor([248_956_422, 242_193_529])
    lens = lens.to(gpu)
    for name, (padded, n) in resolve_flag_cases.flag_windows(w).items():
        buf = torch.from_numpy(padded).to(gpu)
        want = K._compute_flags(buf, lens, 2, n)
        first = K.full_check_flags(buf, lens, 2, n)
        second = K.full_check_flags(buf, lens, 2, n)
        assert torch.equal(first, want), name
        assert torch.equal(second, want), name


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
    with pytest.raises(ValueError, match="16-byte boundary"):
        K.prefilter_check_flags(
            torch.zeros(K.PAD + 68, dtype=torch.uint8, device=gpu)[4:],
            torch.zeros(4, dtype=torch.int32, device=gpu), 1, 1)
    for kernel in (K.prefilter_check_flags, K.full_check_flags):
        with pytest.raises(ValueError, match="num_contigs"):
            kernel(torch.zeros(K.PAD + 64, dtype=torch.uint8, device=gpu),
                   torch.zeros(4, dtype=torch.int32, device=gpu), -1, 1)
    F, cand, n_set = K.prefilter_check_flags(
        torch.zeros(K.PAD + 63, dtype=torch.uint8, device=gpu),
        torch.zeros(4, dtype=torch.int32, device=gpu), 1, 63)
    assert F.shape == (63,) and cand.shape == (4096,) and n_set.shape == ()
    assert F.dtype == cand.dtype == n_set.dtype == torch.int32
    assert int(n_set) == 0 and bool((cand == -1).all())
    with pytest.raises(ValueError, match="16-byte boundary"):
        K.tokenize(
            torch.zeros(132, dtype=torch.uint8, device=gpu)[4:].view(2, 64),
            torch.zeros(2, dtype=torch.int32, device=gpu))
    with pytest.raises(ValueError):
        K.lz77_resolve(torch.zeros((1, 100), dtype=torch.uint8, device=gpu),
                       torch.zeros((1, 100), dtype=torch.uint16, device=gpu))
    with pytest.raises(ValueError, match="16-byte boundar"):
        K.full_check_flags(
            torch.zeros(K.PAD + 68, dtype=torch.uint8, device=gpu)[4:],
            torch.zeros(4, dtype=torch.int32, device=gpu), 1, 1)
    with pytest.raises(ValueError, match="16-byte boundar"):
        K.lz77_resolve(
            torch.zeros(STRIDE + 8, dtype=torch.uint8, device=gpu)[8:]
            .view(1, STRIDE),
            torch.zeros((1, STRIDE), dtype=torch.uint16, device=gpu))


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


def test_host_tokenize_count_on_gpu_equals_cpu(gpu, tmp_path):
    """``inflate tokenize=host``: the host tokenizer's packed planes go to
    the card in pinned slots and ``lz77_resolve`` and the prefilter count
    them; the ``tokenize`` kernel never launches. The count equals the
    CPU's packed route, the generator's, with no demotion."""
    p = tmp_path / "h.bam"
    m = synth_bam(p, 3 << 20, seed=5, unit_reads=2000)
    cfg = Config(inflate="tokenize=host")
    K.reset_launch_counts()
    sc = StreamChecker(p, cfg, window_uncompressed=1 << 20, halo=256 << 10)
    assert sc.count_reads() == m["reads"]
    assert sc.tokenize_demotions == 0
    windows = len(sc.pipeline.groups)
    assert K.LAUNCHES["tokenize"] == 0
    assert K.LAUNCHES["lz77_resolve"] == windows
    assert K.LAUNCHES["prefilter_check_flags"] >= windows
    cpu = StreamChecker(p, cfg, window_uncompressed=1 << 20, halo=256 << 10,
                        device="cpu")
    assert cpu.count_reads() == m["reads"]
    assert cpu.tokenize_demotions == 0


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


def _assert_load_equal(got, want):
    """Two ``(abs_base, ReadBatch)`` sequences, column for column."""
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.starts, w.starts)
        np.testing.assert_array_equal(g.buf, w.buf)
        assert list(g.columns) == list(w.columns)
        for k in w.columns:
            assert g.columns[k].dtype == w.columns[k].dtype, k
            np.testing.assert_array_equal(g.columns[k], w.columns[k], k)


def test_parse_on_device_window_equals_cpu(gpu):
    from spark_bam_tpu_torch.benchmarks import load_cases
    from spark_bam_tpu_torch.tpu import parser

    recs = load_cases.edge_records(0)
    del recs["cigar_64_overflow"]
    buf = np.frombuffer(b"".join(recs.values()), dtype=np.uint8)
    starts = np.cumsum([0] + [len(r) for r in recs.values()])[:-1]
    padded = torch.zeros((1 << 20) + K.PAD, dtype=torch.uint8, device=gpu)
    padded[: len(buf)] = torch.from_numpy(buf.copy()).to(gpu)
    got = parser.parse_window(padded, buf, starts)
    want = parser.parse_window(padded.cpu(), buf, starts)
    _assert_load_equal([(0, got)], [(0, want)])
    assert got.columns["span_exact"].all()


@pytest.mark.parametrize("reads_to_check", [1, 3, 20])
def test_check_window_reads_to_check_on_gpu_equals_cpu(gpu, reads_to_check,
                                                      tmp_path):
    from spark_bam_tpu_torch.bgzf.flat import flatten_file
    from spark_bam_tpu_torch.tpu.checker import check_window

    p = tmp_path / "rtc.bam"
    synth_bam(p, 2 << 20, seed=4, unit_reads=2000)
    flat = flatten_file(p).data
    w = 1 << 20
    padded = torch.zeros(w + K.PAD, dtype=torch.uint8)
    padded[:w] = torch.from_numpy(flat[:w].copy())
    lens = torch.zeros(1024, dtype=torch.int32)
    lens[:2] = torch.tensor([248_956_422, 242_193_529])
    for funnel in (True, False):
        want = check_window(padded, lens, 2, w, False, reads_to_check, funnel)
        got = check_window(padded.to(gpu), lens.to(gpu), 2, w, False,
                           reads_to_check, funnel)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (k, funnel)


def test_stream_read_batches_on_gpu_equals_cpu(gpu, tmp_path):
    """The synthetic BAM and the load edge corpus load equal on the card
    (funnel on and off) and on the CPU; the load path launches the
    inflate kernels and the prefilter, and the full pass with the funnel
    off."""
    from spark_bam_tpu_torch import stream_read_batches
    from spark_bam_tpu_torch.benchmarks import load_cases

    p = tmp_path / "ld.bam"
    m = synth_bam(p, 3 << 20, seed=5, unit_reads=2000)
    cfg = Config(window_size=1 << 20, halo_size=256 << 10)
    K.reset_launch_counts()
    card = list(stream_read_batches(p, cfg))
    assert all(K.LAUNCHES[k] > 0 for k in COUNT_KERNELS), K.LAUNCHES
    assert sum(len(b) for _, b in card) == m["reads"]
    _assert_load_equal(card, list(stream_read_batches(p, cfg, device="cpu")))

    e = tmp_path / "edges.bam"
    load_cases.write_bam(e, seed=0)
    w, h = load_cases.GEOMETRY
    ecfg = Config(window_size=w, halo_size=h)
    card = list(stream_read_batches(e, ecfg, loci=load_cases.LOCI[-1],
                                    flags_forbidden=0x400))
    cpu = list(stream_read_batches(e, ecfg, loci=load_cases.LOCI[-1],
                                   flags_forbidden=0x400, device="cpu"))
    _assert_load_equal(card, cpu)
    K.reset_launch_counts()
    off = list(stream_read_batches(
        e, Config(window_size=w, halo_size=h, funnel="off"),
        loci=load_cases.LOCI[-1], flags_forbidden=0x400))
    assert K.LAUNCHES["full_check_flags"] > 0, K.LAUNCHES
    _assert_load_equal(off, card)


def test_load_reads_columnar_on_gpu_equals_cpu(gpu, tmp_path):
    from spark_bam_tpu_torch import load_reads_columnar, record_starts

    p = tmp_path / "wf.bam"
    synth_bam(p, 3 << 20, seed=6, unit_reads=2000)
    K.reset_launch_counts()
    got = record_starts(p)
    assert K.LAUNCHES["full_check_flags"] > 0
    np.testing.assert_array_equal(got.starts,
                                  record_starts(p, device="cpu").starts)
    for kw in ({}, {"loci": "chr1:0-100000,chr2", "flags_required": 0}):
        card = load_reads_columnar(p, **kw)
        cpu = load_reads_columnar(p, device="cpu", **kw)
        _assert_load_equal([(0, card)], [(0, cpu)])


def _replay_windows(gpu, w):
    """Four windows of one W whose bytes and valid lengths all differ."""
    cases = prefilter_cases.prefilter_windows(w, seed=8)
    rng = np.random.default_rng(9)
    wins = [(cases[k][0], cases[k][1]) for k in
            ("random_with_records", "count_capacity_plus_1",
             "tail_crosses_tile")]
    wins.append((rng.integers(0, 256, w + K.PAD, dtype=np.uint8), w - 4097))
    return [(torch.from_numpy(b).to(gpu), n) for b, n in wins]


@pytest.mark.parametrize("side", [False, True], ids=["current", "second"])
def test_flag_kernels_replayed_in_a_graph_match_plain(gpu, side):
    """Both flag kernels captured once, replayed over four windows of
    different bytes and lengths (on the current stream, then on a second
    one), with eager launches between the replays: every replay and every
    eager launch is bit-identical to the plain version."""
    from spark_bam_tpu_torch.benchmarks.replay_cases import (
        replay_flag_kernels,
    )

    w = 1 << 20
    lens = torch.from_numpy(prefilter_cases.LENGTHS).to(gpu)
    stream = torch.cuda.Stream(gpu) if side else None
    out = replay_flag_kernels(_replay_windows(gpu, w), lens,
                              prefilter_cases.NUM_CONTIGS, stream)
    for name, r in out.items():
        assert r["replays"] >= 3, name
        assert r["max_abs_err"] == 0 and r["eager_err"] == 0, (name, r)


def _resident_rows(path, window, halo):
    """Three halo windows of ``path`` packed at stride kernel window + PAD
    (host numpy), with the checker's contig table."""
    from spark_bam_tpu_torch.tpu.stream_check import (
        halo_windows,
        pad_contig_lengths,
    )

    sc = StreamChecker(path, Config(), window_uncompressed=window, halo=halo,
                       device="cpu")
    w = sc.kernel_window
    stride = w + K.PAD
    rows = list(halo_windows(sc.pipeline, sc.halo, sc.header_end_abs))[:3]
    chunk = np.zeros(3 * stride, dtype=np.uint8)
    cols = np.zeros((4, 3), dtype=np.int32)
    for j, (buf, _base, own, lo, ae) in enumerate(rows):
        chunk[j * stride: j * stride + len(buf)] = buf
        cols[:, j] = (len(buf), ae, lo, own)
    return sc, chunk, cols, pad_contig_lengths(sc.lengths)


@pytest.mark.parametrize("funnel", [True, False], ids=["funnel", "full"])
def test_count_scan_graph_equals_eager(gpu, tmp_path, funnel):
    """The graph runner's sums equal the eager ``count_window`` loop over
    the same rows, replay after replay over changing chunks (3 rows in a
    4-row bucket, then 1 row in a 1-row bucket, then 3 rows again), and
    each replay adds its captured launches to the counters."""
    from spark_bam_tpu_torch import count_scan, make_count_scan

    p = tmp_path / "r.bam"
    synth_bam(p, 5 << 20, seed=12, unit_reads=2000)
    sc, chunk, cols, lens = _resident_rows(p, 1 << 20, 256 << 10)
    w = sc.kernel_window
    stride = w + K.PAD
    lens_d = torch.from_numpy(lens).to(gpu)
    nc = len(sc.lengths)
    runner = make_count_scan(w, 10, funnel, gpu)
    mutated = chunk.copy()
    rng = np.random.default_rng(3)
    mutated[rng.integers(0, len(chunk), 5000)] ^= 0x5A
    kernel = "prefilter_check_flags" if funnel else "full_check_flags"
    for data, k in ((chunk, 3), (mutated, 1), (mutated, 3), (chunk, 3)):
        host = torch.from_numpy(data).pin_memory()
        starts = np.arange(k) * stride
        before = K.LAUNCHES[kernel]
        got = runner(host, lens_d, nc, starts, *cols[:, :k])
        launched = K.LAUNCHES[kernel] - before
        want = count_scan(torch.from_numpy(data).to(gpu), lens_d, nc, starts,
                          *cols[:, :k], window=w, funnel=funnel)
        for key in ("count", "esc_count", "survivors"):
            assert int(got[key]) == int(want[key]), (k, key)
        assert launched >= k   # one per real row, more with the warm-up
    assert runner.captures == 2 and runner.replays == 4
    per = runner.launches_per_replay()
    assert per[(4, nc)][kernel] == 4 and per[(1, nc)][kernel] == 1


def test_count_reads_resident_on_gpu_equals_cpu(gpu, tmp_path):
    p = tmp_path / "r.bam"
    m = synth_bam(p, 6 << 20, seed=13, unit_reads=2000)
    geo = dict(window_uncompressed=1 << 20, halo=256 << 10)
    sc = StreamChecker(p, Config(), **geo)
    K.reset_launch_counts()
    assert sc.count_reads_resident(chunk_windows=3, first_chunk_windows=2) \
        == m["reads"]
    assert K.LAUNCHES["prefilter_check_flags"] >= len(sc.pipeline.groups)
    assert sc.scan_runner.replays >= 3
    cpu = StreamChecker(p, Config(), device="cpu", **geo)
    assert cpu.count_reads_resident(chunk_windows=3) == m["reads"]
    assert cpu.funnel_stats == sc.funnel_stats
    # The same checker again: its graphs are reused, none is captured.
    captures = sc.scan_runner.captures
    assert sc.count_reads_resident(chunk_windows=3, first_chunk_windows=2) \
        == m["reads"]
    assert sc.scan_runner.captures == captures


def _mesh_batch(path, w=1 << 17, halo=32 << 10, rows=4):
    """``rows`` windows of ``path``'s stream as a step batch, with truth
    from the ``.records`` walk; row 0 owns from the header on."""
    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.bam.index_records import record_start_flats
    from spark_bam_tpu_torch.bgzf.flat import flatten_file
    from spark_bam_tpu_torch.parallel.mesh import batch_windows
    from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths

    flat = flatten_file(path).data
    truth = np.zeros(len(flat), dtype=bool)
    truth[record_start_flats(path)] = True
    cut = rows * (w - halo) - 1000
    ws, ns, eofs, owned, tr = batch_windows(flat[:cut], w, halo, rows,
                                            at_eof=False, truth=truth[:cut])
    owns = np.array([e - s for s, e in owned], dtype=np.int64)
    header = read_header(path)
    los = np.zeros(rows, dtype=np.int64)
    los[0] = header.uncompressed_size
    return (ws, ns, eofs, los, owns, tr,
            pad_contig_lengths(header.contig_lengths),
            len(header.contig_lengths))


@pytest.mark.parametrize("entries", [1, 2])
def test_mesh_steps_on_gpu_equal_cpu(gpu, tmp_path, entries):
    """Every step on a mesh of the card (``entries`` shards of it) equals
    the same step on a CPU mesh."""
    from spark_bam_tpu_torch import make_mesh
    from spark_bam_tpu_torch.parallel import mesh as pm

    p = tmp_path / "m.bam"
    synth_bam(p, 600 << 10, seed=3, unit_reads=512)
    ws, ns, eofs, los, owns, tr, lens, nc = _mesh_batch(p)
    card, cpu = make_mesh([gpu] * entries), make_mesh(["cpu"] * entries)
    for funnel in (True, False):
        a, b = (pm.make_shard_map_count_step(m, 10, funnel)(
            m.shard(ws), ns, eofs, los, owns, lens, nc) for m in (card, cpu))
        assert a.tolist() == b.tolist() and a[0] > 0
        a, b = (pm.make_shard_map_confusion_step(m, 10, funnel)(
            m.shard(ws), ns, eofs, m.shard(tr), los, owns, lens, nc)
            for m in (card, cpu))
        assert a.tolist() == b.tolist()
    for k in (4096, 8):
        a, b = (pm.make_shard_map_full_step(m, 10, k)(
            m.shard(ws), ns, eofs, los, owns, lens, nc) for m in (card, cpu))
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    ncs = np.full(len(ns), nc, dtype=np.int32)
    per_row = np.tile(lens, (len(ns), 1))
    a, b = (pm.make_shard_map_serve_step(m, 10, True)(
        m.shard(ws), ns, eofs, los, owns, per_row, ncs) for m in (card, cpu))
    assert np.array_equal(a, b)
    (va, _, a), (vb, _, b) = (pm.make_shard_map_check_step(m, 10)(
        m.shard(ws), ns, eofs, m.shard(tr), lens, nc) for m in (card, cpu))
    assert a.tolist() == b.tolist()
    assert all(torch.equal(x.cpu(), y) for x, y in zip(va, vb))


def test_sharded_workloads_on_gpu_equal_cpu(gpu, tmp_path):
    """The three sharded workloads on the card (rows inflated there, and a
    two-entry mesh of the one card) equal the CPU mesh's."""
    from spark_bam_tpu_torch import (
        check_bam_sharded,
        count_reads_sharded,
        full_check_summary_sharded,
        make_mesh,
    )
    from spark_bam_tpu_torch.bam.index_records import index_records

    p = tmp_path / "w.bam"
    manifest = synth_bam(p, 2 << 20, seed=5, unit_reads=2048)
    index_records(p)
    geo = dict(window_uncompressed=256 << 10, halo=64 << 10)
    cpu = make_mesh(["cpu"] * 2)
    want = (count_reads_sharded(p, Config(device_inflate=False), mesh=cpu,
                                **geo),
            check_bam_sharded(p, Config(device_inflate=False), mesh=cpu,
                              **geo),
            full_check_summary_sharded(p, Config(device_inflate=False),
                                       mesh=cpu, **geo))
    assert want[0] == manifest["reads"]
    for entries in (1, 2):
        mesh = make_mesh([gpu] * entries)
        K.reset_launch_counts()
        stats = {}
        assert count_reads_sharded(p, Config(), mesh=mesh, stats_out=stats,
                                   **geo) == want[0]
        assert stats["tokenize_demotions"] == 0
        assert all(K.LAUNCHES[k] > 0 for k in COUNT_KERNELS), K.LAUNCHES
        got = check_bam_sharded(p, Config(), mesh=mesh, **geo)
        assert got == {**want[1], "devices": entries}
        K.reset_launch_counts()
        got = full_check_summary_sharded(p, Config(), mesh=mesh, **geo)
        assert all(K.LAUNCHES[k] > 0 for k in FULL_CHECK_KERNELS), K.LAUNCHES
        assert got["devices"] == entries
        for key in want[2]:
            if key != "devices":
                assert np.array_equal(got[key], want[2][key]) if hasattr(
                    got[key], "shape") else got[key] == want[2][key], key


def _agg_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.int64 and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("nc,chunk", [(0, None), (3, None), (25, 100)])
def test_aggregate_planes_on_gpu_equal_cpu(gpu, nc, chunk):
    """The reduction on the card (plain carry, and the agg step on a
    one- and two-entry mesh of the card) equals the CPU's, edge rows and
    the two reference-fault inputs included, and the int64 oracle."""
    from spark_bam_tpu_torch import make_mesh
    from spark_bam_tpu_torch.agg import AggConfig, aggregate_planes
    from spark_bam_tpu_torch.agg.host import host_aggregate
    from spark_bam_tpu_torch.benchmarks import agg_cases
    from spark_bam_tpu_torch.parallel.mesh import mesh_steps

    cols = agg_cases.random_planes(nc, 5000, nc)
    for spec in ("", "coverage:bin=7,bins=3,cap=2;tlen:max=1"):
        plan = AggConfig.parse(spec)
        want = aggregate_planes(cols, plan, nc, chunk=chunk, device="cpu")
        _agg_equal(want, host_aggregate(cols, plan, nc))
        _agg_equal(aggregate_planes(cols, plan, nc, chunk=chunk, device=gpu),
                   want)
        for entries in (1, 2):
            steps = mesh_steps(make_mesh([gpu] * entries))
            _agg_equal(aggregate_planes(cols, plan, nc, steps=steps,
                                        chunk=chunk), want)
    for spec, n, fault in agg_cases.REFERENCE_FAULTS.values():
        plan = AggConfig.parse(spec)
        _agg_equal(aggregate_planes(fault, plan, n, device=gpu),
                   host_aggregate(fault, plan, n))


@pytest.mark.parametrize("kw", [
    {}, {"tags_required": ("NM", "RG")},
    {"loci": "chr1:50-900,chr2", "flags_forbidden": 16},
    {"agg": "count;flagstat", "flags_required": 2048}])
def test_aggregate_on_gpu_equals_cpu(gpu, tmp_path, kw):
    """``aggregate`` on the card equals ``device="cpu"`` on the tagged BAM
    (the full-check kernel ran) and on an unmapped BAM with no contigs."""
    from spark_bam_tpu_torch import aggregate
    from spark_bam_tpu_torch.benchmarks import agg_cases

    tagged, unmapped = tmp_path / "t.bam", tmp_path / "u.bam"
    agg_cases.write_tagged_bam(tagged)
    agg_cases.write_unmapped_bam(unmapped)
    for p in (tagged, unmapped):
        K.reset_launch_counts()
        got = aggregate(p, **kw)
        assert K.LAUNCHES["full_check_flags"] > 0
        want = aggregate(p, device="cpu", **kw)
        assert {k: got[k] for k in ("agg", "rows", "contigs")} == {
            k: want[k] for k in ("agg", "rows", "contigs")}
        _agg_equal(got["metrics"], want["metrics"])


def _split_bam(case, path):
    """A BAM of ``case`` and the split sizes its plans are held at."""
    from spark_bam_tpu_torch.benchmarks.split_cases import (
        adversarial_bam,
        sentinel_split_size,
    )

    if case == "synth":
        synth_bam(path, 4 << 20, seed=7, unit_reads=1000)
        return [16384, 50_000, 1 << 20, sentinel_split_size(path)]
    if case == "long":
        synth_bam(path, 1 << 20, seed=2, unit_reads=4,
                  read_len=(60_000, 110_000))
        return [200_000]
    return [adversarial_bam(path)[0]]


@pytest.mark.parametrize("case", ["synth", "long", "adversarial"])
def test_split_plans_and_sidecars_on_gpu_equal_cpu(gpu, tmp_path, case):
    """Every boundary resolved on the card equals the CPU's resolution;
    ``index --record-starts`` writes the same sidecar bytes; a warm
    ``record_starts`` from it launches no kernel."""
    from spark_bam_tpu_torch import cli, record_starts
    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.load import boundary
    from spark_bam_tpu_torch.load.splits import file_splits
    from spark_bam_tpu_torch.sbi.plan import build_split_plan

    path = tmp_path / "b.bam"
    sizes = _split_bam(case, path)
    header = read_header(path)
    for size in sizes:
        splits = file_splits(path, size)
        boundary.STATS.reset()
        K.reset_launch_counts()
        got = build_split_plan(path, splits, header, Config(), device=gpu)
        assert K.LAUNCHES["prefilter_check_flags"] >= boundary.STATS.windows
        assert got == build_split_plan(path, splits, header, Config(),
                                       device="cpu"), size
    card, cpu = tmp_path / "card.sbi", tmp_path / "cpu.sbi"
    cli.index(path, sizes[0], Config(), out_path=card, record_starts=True,
              device=gpu)
    cli.index(path, sizes[0], Config(), out_path=cpu, record_starts=True,
              device="cpu")
    assert card.read_bytes() == cpu.read_bytes()
    cold = record_starts(path, Config(cache="readwrite"), device=gpu)
    K.reset_launch_counts()
    warm = record_starts(path, Config(cache="read"), device=gpu)
    assert not any(K.LAUNCHES.values())
    np.testing.assert_array_equal(warm.starts, cold.starts)


@pytest.mark.parametrize("mode", [["-s"], ["-u"], []],
                         ids=["spark", "hadoop", "compare"])
def test_compute_splits_on_gpu_equals_cpu(gpu, tmp_path, mode):
    from spark_bam_tpu_torch import cli
    from spark_bam_tpu_torch.benchmarks.split_cases import sentinel_split_size

    path = tmp_path / "b.bam"
    synth_bam(path, 4 << 20, seed=8, unit_reads=1000)
    outs = []
    for size in (50_000, sentinel_split_size(path)):
        for dev in ("cuda", "cpu"):
            out = tmp_path / f"{dev}.txt"
            assert cli.main(["compute-splits", *mode, "-m", str(size),
                             "--device", dev, "-o", str(out),
                             str(path)]) == 0
            outs.append([ln for ln in out.read_text().split("\n")
                         if not ln.startswith("Get ")])
        assert outs[-2] == outs[-1] and outs[-1]


@pytest.mark.parametrize("kw", [
    {}, {"loci": "chr1:100000-3000000,chr2", "flags_forbidden": 0x10},
    {"columns": "flag,pos,name,cigar", "config": Config(
        window_size=1 << 20, halo_size=256 << 10, columnar="codec=zlib")}],
    ids=["all", "loci_flags", "projected_zlib"])
def test_export_on_gpu_equals_cpu(gpu, tmp_path, kw):
    """The export's container bytes on the card equal the CPU's; the
    load's kernels run, the full pass does not."""
    from spark_bam_tpu_torch.load.api import export

    p = tmp_path / "ex.bam"
    m = synth_bam(p, 3 << 20, seed=7, unit_reads=2000)
    kw = dict(kw)
    cfg = kw.pop("config", Config(window_size=1 << 20, halo_size=256 << 10))
    K.reset_launch_counts()
    card = export(p, tmp_path / "card.sbcr", config=cfg, **kw)
    assert all(K.LAUNCHES[k] > 0 for k in COUNT_KERNELS), K.LAUNCHES
    assert K.LAUNCHES["full_check_flags"] == 0, K.LAUNCHES
    cpu = export(p, tmp_path / "cpu.sbcr", config=cfg, device="cpu", **kw)
    assert card["rows"] == cpu["rows"] > 0
    if not kw:
        assert card["rows"] == m["reads"]
    assert ((tmp_path / "card.sbcr").read_bytes()
            == (tmp_path / "cpu.sbcr").read_bytes())


@pytest.mark.parametrize("columnar", ["", "codec=deflate"])
def test_export_long_reads_on_gpu_equals_cpu(gpu, tmp_path, columnar):
    """60-110 kb reads at a 256 KiB window and 64 KiB halo: the spilled
    records land in file order on the card as on the CPU."""
    from spark_bam_tpu_torch.benchmarks.synth import record_positions
    from spark_bam_tpu_torch.columnar.native import NativeReader
    from spark_bam_tpu_torch.load.api import export

    p = tmp_path / "long.bam"
    m = synth_bam(p, 2 << 20, seed=9, unit_reads=8,
                  read_len=(60_000, 110_000))
    cfg = Config(window_size=256 << 10, halo_size=64 << 10, columnar=columnar)
    card = export(p, tmp_path / "card.sbcr", config=cfg)
    export(p, tmp_path / "cpu.sbcr", config=cfg, device="cpu")
    blob = (tmp_path / "card.sbcr").read_bytes()
    assert blob == (tmp_path / "cpu.sbcr").read_bytes()
    assert card["rows"] == m["reads"]
    pos = np.concatenate([b.columns["pos"] for b in
                          NativeReader(blob).iter_batches()])
    assert sorted(pos.tolist()) == sorted(record_positions(m))


# ---------------------------------------------------------------- write path


def _lanes_on(payloads, dev):
    from spark_bam_tpu_torch.compress import kernels as CK

    data, lengths, _ = CK.pack_lanes(payloads, pin=True)
    return data.to(dev), lengths.to(dev)


@pytest.mark.parametrize("b", [1, 12, 16])
def test_write_lanes_match_plain(gpu, b):
    """Both write-path kernels against their plain versions on the same
    card tensors, bit for bit: the whole packed plane, total_bits and the
    CRC (zero-length and overflowing lanes included), and against zlib's
    CRC-32 and the host fixed_pack."""
    import zlib as _zlib

    from spark_bam_tpu_torch.benchmarks.write_cases import lane_batch
    from spark_bam_tpu_torch.compress import kernels as CK
    from spark_bam_tpu_torch.compress.huffman import fixed_pack

    payloads = lane_batch(b, seed=3)
    data, lengths = _lanes_on(payloads, gpu)
    before = dict(K.LAUNCHES)
    crc = CK.crc32_lanes(data, lengths)
    packed, total_bits, crc2 = CK.deflate_fixed_lanes(data, lengths)
    torch.cuda.synchronize()
    assert K.LAUNCHES["crc32_lanes"] == before["crc32_lanes"] + 1
    assert (K.LAUNCHES["deflate_fixed_lanes"]
            == before["deflate_fixed_lanes"] + 1)
    p_packed, p_bits, p_crc = CK.deflate_fixed_lanes_plain(data, lengths)
    assert torch.equal(crc, CK.crc32_lanes_plain(data, lengths))
    assert torch.equal(crc2, p_crc) and torch.equal(crc, crc2)
    assert torch.equal(total_bits, p_bits)
    assert torch.equal(packed, p_packed)
    host = packed.cpu().numpy()
    for i, p in enumerate(payloads):
        assert int(crc[i]) == _zlib.crc32(p)
        want, bits = fixed_pack(p)
        assert int(total_bits[i]) == bits
        n = min(len(want), CK.OUT_BYTES)
        assert host[i, :n].tobytes() == want[:n]
        assert not host[i, n:].any()


def test_write_lane_launch_error_raises(gpu, monkeypatch):
    """A launch the card refuses (the C entry point returns its
    cudaGetLastError) raises and is not counted: it never reads as a row
    of zeros."""
    from spark_bam_tpu_torch.compress import kernels as CK

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1   # cudaErrorInvalidValue

    data, lengths = _lanes_on([b"abc", b""], gpu)
    monkeypatch.setattr(K, "load", lambda: Refusing())
    before = dict(K.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        CK.deflate_fixed_lanes(data, lengths)
    with pytest.raises(RuntimeError, match="launch failed"):
        CK.crc32_lanes(data, lengths)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("mode", ["stored", "fixed", "auto"])
def test_device_codec_members_equal_host(gpu, mode):
    """The codec's members from the card's lanes equal the host functions'
    (auto: fixed on the card), with two batches in flight."""
    from spark_bam_tpu_torch.benchmarks.write_cases import lane_cases
    from spark_bam_tpu_torch.compress.codec import DeviceDeflateCodec
    from spark_bam_tpu_torch.compress.config import DeflateConfig
    from spark_bam_tpu_torch.compress.huffman import (
        MAX_STORED_PAYLOAD,
        fixed_member,
        stored_member,
    )

    payloads = [p for p in lane_cases(5).values()
                if len(p) <= MAX_STORED_PAYLOAD]
    codec = DeviceDeflateCodec(DeflateConfig.parse(f"mode={mode},lanes=4"),
                               device=gpu)
    first = codec.dispatch(payloads[:4])
    second = codec.dispatch(payloads[4:])
    got = codec.materialize(first) + codec.materialize(second)
    host = stored_member if mode == "stored" else fixed_member
    assert got == [host(p) for p in payloads]
    assert codec.counts["members"] == len(payloads)
    assert codec.counts["stored"] + codec.counts["fixed"] == len(payloads)


def test_zlib_stream_on_gpu_equals_host(gpu):
    """The device branch of encode_zlib_stream equals zlib_stream, its
    windows that outgrow a lane's plane re-packed on the host and
    counted."""
    import zlib as _zlib

    from spark_bam_tpu_torch.compress import codec
    from spark_bam_tpu_torch.compress.huffman import (
        MAX_STORED_PAYLOAD,
        fixed_pack,
        zlib_stream,
    )
    from spark_bam_tpu_torch.compress.kernels import OUT_BYTES

    rng = np.random.default_rng(4)
    raw = (rng.integers(32, 127, 150_000, dtype=np.uint8).tobytes()
           + rng.integers(144, 256, 70_000, dtype=np.uint8).tobytes()
           + b"ACGT" * 10_000)
    before = dict(codec.ZLIB_STREAM_COUNTS)
    got = codec.encode_zlib_stream(raw, "mode=fixed,device=on,lanes=2",
                                   device=gpu)
    assert got == zlib_stream(raw)
    assert _zlib.decompress(got) == raw
    w = MAX_STORED_PAYLOAD
    over = sum(fixed_pack(raw[i: i + w])[1] > OUT_BYTES * 8
               for i in range(0, len(raw), w))
    assert over == 2
    assert codec.ZLIB_STREAM_COUNTS["repacks"] == before["repacks"] + over


@pytest.mark.parametrize("spec", ["mode=fixed", "mode=stored"])
def test_rewrite_on_gpu_equals_host(gpu, tmp_path, spec):
    """``rewrite -i`` on the card: the BAM and its sidecars equal the
    host functions' (device=off), and the output counts on the card."""
    from spark_bam_tpu_torch import cli

    src = tmp_path / "src.bam"
    m = synth_bam(src, 2 << 20, seed=12, unit_reads=1500)
    K.reset_launch_counts()
    outs = {}
    for dev_spec in ("", ",device=off"):
        out = tmp_path / f"out{len(outs)}.bam"
        assert cli.main(["rewrite", "-i", "-b", "20000", "--deflate",
                         spec + dev_spec, str(src), str(out)]) == 0
        outs[dev_spec] = out
    kernel = "deflate_fixed_lanes" if spec == "mode=fixed" else "crc32_lanes"
    assert K.LAUNCHES[kernel] > 0
    a, b_ = outs[""], outs[",device=off"]
    for ext in ("", ".blocks", ".records"):
        assert (Path(str(a) + ext).read_bytes()
                == Path(str(b_) + ext).read_bytes())
    assert StreamChecker(a, Config()).count_reads() == m["reads"]


def _serve_answer(svc, req: dict):
    """A service's response, without its id and ``devices``, and its
    frames."""
    r = svc.submit(dict(req)).result(timeout=600)
    frames = [bytes(f) for f in r.pop("_binary", None) or ()]
    r.pop("devices", None)
    return r, frames


@pytest.mark.parametrize("funnel", ["auto", "off"])
def test_serve_on_gpu_equals_cpu(gpu, tmp_path, funnel):
    """The serve daemon's count, plan, record_starts, batch and aggregate
    on the card equal the same service's on a CPU mesh; the count rows run
    the prefilter under the funnel and the full flag pass without it."""
    from spark_bam_tpu_torch.parallel.mesh import local_mesh
    from spark_bam_tpu_torch.serve import SplitService

    p = str(tmp_path / "s.bam")
    m = synth_bam(p, 3 << 20, seed=14, unit_reads=4000)
    size = Path(p).stat().st_size
    cfg = Config(serve="window=512KB,halo=32KB,batch=4,tick=2",
                 funnel=funnel)
    reqs = [{"op": "count", "path": p},
            {"op": "count", "path": p, "start": size // 4, "end": size // 2},
            {"op": "fleet", "paths": [p, p]},
            {"op": "plan", "path": p, "split_size": 256 << 10},
            {"op": "record_starts", "path": p, "limit": 5},
            {"op": "batch", "path": p, "batch_rows": 3000},
            {"op": "batch", "path": p, "intervals": "chr1:1-300000",
             "columns": ["pos", "cigar"]},
            {"op": "aggregate", "path": p, "flags_forbidden": 4}]
    card, cpu = SplitService(cfg), SplitService(cfg, local_mesh(["cpu"]))
    try:
        assert card.mesh.devices[0].type == "cuda"
        K.reset_launch_counts()
        got = [_serve_answer(card, r) for r in reqs]
        launches = dict(K.LAUNCHES)
        want = [_serve_answer(cpu, r) for r in reqs]
    finally:
        card.close()
        cpu.close()
    assert got == want
    assert got[0][0]["count"] == m["reads"]
    row_kernel = ("full_check_flags" if funnel == "off"
                  else "prefilter_check_flags")
    assert launches[row_kernel] > 0 and launches["full_check_flags"] > 0


def test_serve_concurrent_clients_on_gpu(gpu, tmp_path):
    """Eight threads mixing counts, record starts and aggregates on one
    card service answer what each request answers alone."""
    import threading

    from spark_bam_tpu_torch.serve import SplitService

    paths = []
    for seed in (15, 16):
        p = str(tmp_path / f"c{seed}.bam")
        synth_bam(p, 2 << 20, seed=seed, unit_reads=3000)
        paths.append(p)
    reqs = [{"op": "count", "path": paths[0]},
            {"op": "count", "path": paths[1], "start": 100_000},
            {"op": "record_starts", "path": paths[1], "limit": 4},
            {"op": "aggregate", "path": paths[0], "agg": "mapq;count"},
            {"op": "plan", "path": paths[0], "split_size": 300_000}]
    svc = SplitService(Config(serve="window=256KB,halo=32KB,batch=8,tick=2,"
                                    "workers=4"))
    try:
        want = [_serve_answer(svc, r) for r in reqs]
        bad = []

        def client(i):
            try:
                for j in range(5):
                    k = (i + j) % len(reqs)
                    if _serve_answer(svc, reqs[k]) != want[k]:
                        bad.append((i, j))
            except Exception as e:     # a thread's failure fails the test
                bad.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
    finally:
        svc.close()
    assert not bad


def test_flag_kernels_from_concurrent_threads_match_plain(gpu):
    """Host threads launching both flag kernels on one stream of one card
    get their plain versions' answers: their tile-status tickets follow
    their launches."""
    import threading

    rng = np.random.default_rng(21)
    w = 1 << 20
    lens = torch.zeros(1024, dtype=torch.int32, device=gpu)
    lens[:2] = torch.tensor([248_956_422, 242_193_529], dtype=torch.int32)
    cases = []
    for i in range(4):
        buf = torch.from_numpy(rng.integers(0, 256, w + K.PAD,
                                            dtype=np.uint8)).to(gpu)
        n = w - 997 * i
        cases.append((buf, n, K._prefilter_compact(buf, lens, 2, n,
                                                   K.lane_capacity(w)),
                      K._compute_flags(buf, lens, 2, n)))
    bad = []

    def worker(i):
        try:
            for j in range(25):
                buf, n, pre, full = cases[(i + j) % len(cases)]
                got_pre = K.prefilter_check_flags(buf, lens, 2, n)
                got_full = K.full_check_flags(buf, lens, 2, n)
                if not (all(torch.equal(a, b) for a, b in zip(got_pre, pre))
                        and torch.equal(got_full, full)):
                    bad.append((i, j))
        except Exception as e:         # a thread's failure fails the test
            bad.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not bad


@pytest.mark.parametrize("stream", [0, 1])
def test_fabric_on_gpu_equals_cpu(gpu, tmp_path, stream):
    """A router over two in-process workers on the card answers count,
    plan and ``batch`` (over sockets and shm) as the same fabric on a CPU
    mesh does, the card workers' rows launching the prefilter."""
    from spark_bam_tpu_torch.fabric import Router
    from spark_bam_tpu_torch.parallel.mesh import local_mesh
    from spark_bam_tpu_torch.serve import ServeClient, ServerThread
    from spark_bam_tpu_torch.serve import SplitService

    p = str(tmp_path / "f.bam")
    m = synth_bam(p, 3 << 20, seed=17, unit_reads=4000)
    size = Path(p).stat().st_size
    cfg = Config(serve="window=512KB,halo=32KB,batch=4,tick=2")
    fabric = f"probe=60000,autoscale=60000,stream={stream}"
    reqs = [("count", {"path": p}),
            ("count", {"path": p, "start": size // 3}),
            ("plan", {"path": p, "split_size": 256 << 10}),
            ("batch", {"path": p, "batch_rows": 3000}),
            ("batch", {"path": p, "intervals": "chr1:1-300000",
                       "columns": ["pos", "cigar"]})]

    def answers(mesh):
        svcs = [SplitService(cfg, mesh) for _ in range(2)]
        srvs = [ServerThread(s).start() for s in svcs]
        router = Router(["tcp:%s:%d" % s.address for s in srvs],
                        config=Config(fabric=fabric))
        rsrv = ServerThread(router).start()
        out = []
        try:
            for transport in ("socket", "auto"):
                with ServeClient(rsrv.address, transport=transport) as c:
                    for op, fields in reqs:
                        r = c.request(op, **fields)
                        frames = [bytes(f) for f in r.pop("_binary", ())]
                        for k in ("id", "_transport", "devices",
                                  "latency_p50_ms", "latency_p99_ms"):
                            r.pop(k, None)
                        out.append((r, frames))
        finally:
            rsrv.stop()
            for s in srvs:
                s.stop()
            for s in svcs:
                s.close()
        return out

    K.reset_launch_counts()
    got = answers(None)
    launches = dict(K.LAUNCHES)
    want = answers(local_mesh(["cpu"]))
    assert got == want
    assert got[0][0]["count"] == m["reads"]
    assert launches["prefilter_check_flags"] > 0
    assert launches["full_check_flags"] > 0     # the batch's cold starts


def test_jobs_on_gpu_equal_cpu(gpu, tmp_path):
    """A ``mode=fixed`` rewrite job and an export job on the card, each
    interrupted and resumed, equal the same jobs on the CPU; the rewrite
    launches the fixed-Huffman lanes, the export the device inflate and
    the prefilter."""
    from spark_bam_tpu_torch.jobs.runner import (
        JobCancelled,
        run_export_job,
        run_rewrite_job,
    )

    src = tmp_path / "src.bam"
    m = synth_bam(src, 3 << 20, seed=18, unit_reads=3000)
    cfg = Config(columnar="rows=2000")

    class TripAt:
        def __init__(self, n):
            self.left = n

        def is_set(self):
            self.left -= 1
            return self.left <= 0

    def run(device, tag):
        rspec = {"op": "rewrite", "path": str(src),
                 "out": str(tmp_path / f"{tag}.bam"), "block_payload": 20000,
                 "deflate": "mode=fixed"}
        espec = {"op": "export", "path": str(src),
                 "out": str(tmp_path / f"{tag}.sbcr")}
        with pytest.raises(JobCancelled):
            run_rewrite_job(rspec, str(tmp_path / f"{tag}_r"),
                            checkpoint=700, cancel=TripAt(1500),
                            device=device)
        rres = run_rewrite_job(rspec, str(tmp_path / f"{tag}_r"),
                               checkpoint=700, device=device)
        with pytest.raises(JobCancelled):
            run_export_job(espec, str(tmp_path / f"{tag}_e"), config=cfg,
                           checkpoint=2, cancel=TripAt(3), device=device)
        eres = run_export_job(espec, str(tmp_path / f"{tag}_e"), config=cfg,
                              checkpoint=2, device=device)
        return (rres, eres, (tmp_path / f"{tag}.bam").read_bytes(),
                (tmp_path / f"{tag}.sbcr").read_bytes())

    K.reset_launch_counts()
    got = run(gpu, "card")
    launches = dict(K.LAUNCHES)
    want = run("cpu", "cpu")
    strip = ("out",)
    for g, w in zip(got[:2], want[:2]):
        assert ({k: v for k, v in g.items() if k not in strip}
                == {k: v for k, v in w.items() if k not in strip})
    assert got[2:] == want[2:]
    assert got[0]["count"] == got[1]["rows"] == m["reads"]
    assert got[0]["resumed"] and got[1]["resumed"]
    for kernel in ("deflate_fixed_lanes", "tokenize", "lz77_resolve",
                   "prefilter_check_flags"):
        assert launches[kernel] > 0, kernel


def test_export_job_beside_counting_clients_on_gpu(gpu, tmp_path):
    """An export job in an in-process worker on the card, while 8 threads
    count through the same service, writes the container it writes alone;
    the counts stay right."""
    import threading
    import time

    from spark_bam_tpu_torch.serve import SplitService

    src = str(tmp_path / "e.bam")
    m = synth_bam(src, 4 << 20, seed=19, unit_reads=4000)
    cnt = str(tmp_path / "c.bam")
    mc = synth_bam(cnt, 2 << 20, seed=20, unit_reads=3000)
    svc = SplitService(Config(
        serve="window=256KB,halo=32KB,batch=8,tick=2,workers=8",
        jobs=f"dir={tmp_path / 'jobs'},frames=2,mem=1.0",
        columnar="rows=1500"))

    def export_job(out):
        jid = svc.submit({"op": "submit", "job": "export", "path": src,
                          "out": out}).result(timeout=600)["job_id"]
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            st = svc.submit({"op": "job_status", "job_id": jid}).result(
                timeout=600)
            if st["state"] != "running":
                return st
            time.sleep(0.01)
        raise AssertionError("export job did not finish")

    try:
        alone = export_job(str(tmp_path / "alone.sbcr"))
        assert alone["state"] == "done", alone
        stop = threading.Event()
        bad = []

        def client():
            try:
                while not stop.is_set():
                    r = svc.submit({"op": "count", "path": cnt}).result(
                        timeout=600)
                    if r.get("count") != mc["reads"]:
                        bad.append(r)
            except Exception as e:     # a thread's failure fails the test
                bad.append(repr(e))

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        try:
            busy = export_job(str(tmp_path / "busy.sbcr"))
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
    finally:
        svc.close()
    assert not bad
    assert busy["state"] == "done", busy
    assert busy["result"]["rows"] == alone["result"]["rows"] == m["reads"]
    assert ((tmp_path / "busy.sbcr").read_bytes()
            == (tmp_path / "alone.sbcr").read_bytes())


def test_record_path_on_gpu_equals_cpu(gpu, tmp_path):
    """``load_reads_and_positions`` with its strict split starts resolved
    on the card (``prefilter_check_flags`` launches) gives the CPU run's
    records; ``load_splits_and_reads`` the CPU run's splits; the refused
    record's BAM counts 601 either way."""
    from spark_bam_tpu_torch.benchmarks.load_cases import write_refused_mid_bam
    from spark_bam_tpu_torch.load import api

    path = tmp_path / "b.bam"
    synth_bam(path, 2 << 20, seed=8, unit_reads=1000)
    for size in ("64KB", "256KB"):
        K.reset_launch_counts()
        got = api.load_reads_and_positions(path, size, device=gpu)
        assert K.LAUNCHES["prefilter_check_flags"] > 0
        want = api.load_reads_and_positions(path, size, device="cpu")
        assert [(tuple(p), r.encode()) for p, r in got.collect()] == [
            (tuple(p), r.encode()) for p, r in want.collect()]
        splits, _ = api.load_splits_and_reads(path, size, device=gpu)
        cpu_splits, _ = api.load_splits_and_reads(path, size, device="cpu")
        assert splits == cpu_splits
    refused = tmp_path / "refused.bam"
    write_refused_mid_bam(refused)
    assert api.load_bam(refused, "8KB", device=gpu).count() == 601


def test_check_bam_eager_verdict_on_gpu_equals_cpu(gpu, tmp_path):
    """check-bam's eager verdict at every position, on the card (the
    ``full_check_flags`` kernel), equals the CPU plain run's, and the two
    reports are equal."""
    from spark_bam_tpu_torch import cli
    from spark_bam_tpu_torch.bam.index_records import index_records
    from spark_bam_tpu_torch.cli_app import CheckerContext

    path = tmp_path / "b.bam"
    synth_bam(path, 1 << 20, seed=9, unit_reads=700)
    index_records(path)
    K.reset_launch_counts()
    card = CheckerContext(path, Config(), device=gpu).eager_result
    assert K.LAUNCHES["full_check_flags"] > 0
    cpu = CheckerContext(path, Config(), device="cpu").eager_result
    for k in ("verdict", "fail_mask", "reads_before", "exact", "escaped"):
        np.testing.assert_array_equal(getattr(card, k), getattr(cpu, k), k)
    outs = []
    for dev in ("cuda", "cpu"):
        for flags in ([], ["-s"]):
            out = tmp_path / f"{dev}{len(flags)}.txt"
            assert cli.main(["check-bam", *flags, "--device", dev, "-o",
                             str(out), str(path)]) == 0
            outs.append(out.read_text())
    assert outs[:2] == outs[2:]
