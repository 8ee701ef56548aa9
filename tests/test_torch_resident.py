"""The port's resident-scan count against the JAX package's.

``count_scan`` (the chunk counter) runs on the CPU in both packages over
the same packed chunk: three windows at a 2^17 kernel window, bucketed to
four rows with a dummy row, funnel on and off; count, escapes and
survivors must be equal. ``StreamChecker.count_reads_resident`` runs on
the CPU at several chunkings and must equal the JAX package's resident
count, the port's ``count_reads`` and the generator's read count; long
reads must come out exact through the escape retry. The window scalars may
be 0-d tensors (the form a CUDA graph replays): ``count_window`` must
give the same results for them as for ints. The JAX ``count_scan``
compiles once per funnel form and chunk shape, shared by the tests here.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.bgzf.flat import flatten_file
from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.tpu import checker as jck
from spark_bam_tpu.tpu.stream_check import StreamChecker as JaxStreamChecker
from spark_bam_tpu_torch import (
    Config,
    CountScanGraphs,
    StreamChecker,
    cli,
    count_scan,
    make_count_scan,
)
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.tpu import checker as ck
from spark_bam_tpu_torch.tpu import kernels as K
from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = 1 << 17
HALO = 32 << 10
FRESH = W - HALO           # window + halo = the 2^17 kernel window
STRIDE = W + ck.PAD
CHUNKINGS = [(1, 2), (2, 2), (3, 2), (5, 2)]



@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """12 windows of short reads at the 2^17 kernel window."""
    p = tmp_path_factory.mktemp("torch_resident") / "s.bam"
    manifest = synth_bam(p, 600 << 10, seed=3, unit_reads=512)
    return p, manifest["reads"]


@pytest.fixture(scope="module")
def varied(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_resident_rb") / "r.bam"
    random_bam(p, seed=61, read_len=(10, 400), n_records=(900, 1100))
    return p


@pytest.fixture(scope="module")
def jax_resident(synth):
    """The JAX package's resident count of ``synth`` (chunks of four rows,
    the shape ``test_count_scan_matches_jax`` compiles)."""
    path, _ = synth
    sc = JaxStreamChecker(path, JaxConfig(), window_uncompressed=FRESH,
                          halo=HALO)
    assert sc.kernel_window == W
    return sc.count_reads_resident(chunk_windows=4, first_chunk_windows=4)


@pytest.fixture(scope="module")
def port_count(synth):
    """The port's ``count_reads`` of ``synth`` and its funnel totals."""
    path, _ = synth
    sc = StreamChecker(path, Config(), window_uncompressed=FRESH, halo=HALO,
                       device="cpu")
    return sc.count_reads(), sc.funnel_stats


def _checker(path, config=Config()):
    return StreamChecker(path, config, window_uncompressed=FRESH, halo=HALO,
                         device="cpu")


def _packed_chunk(path):
    """Three windows of ``path``'s stream packed at stride W + PAD (the
    first owning from the header on, the second of exactly W bytes with
    seeded byte mutations, the last at EOF) and a dummy fourth row; returns
    ``(chunk, lengths, num_contigs, starts, ns, at_eofs, los, owns)`` as
    numpy arrays."""
    sc = _checker(path)
    data = flatten_file(path).data
    rng = np.random.default_rng(17)
    n1 = W
    second = data[FRESH: FRESH + n1].copy()
    hits = rng.integers(0, n1, size=200)
    second[hits] = rng.integers(0, 256, size=200, dtype=np.uint8)
    tail = data[len(data) - 90_000:]
    rows = [(data[:FRESH + HALO], False, sc.header_end_abs, FRESH),
            (second, False, 0, n1 - HALO),
            (tail, True, 1000, len(tail))]
    chunk = np.zeros(4 * STRIDE, dtype=np.uint8)
    ns = np.zeros(4, dtype=np.int32)
    aes = np.zeros(4, dtype=bool)
    los = np.zeros(4, dtype=np.int32)
    owns = np.zeros(4, dtype=np.int32)
    for j, (buf, ae, lo, own) in enumerate(rows):
        chunk[j * STRIDE: j * STRIDE + len(buf)] = buf
        ns[j], aes[j], los[j], owns[j] = len(buf), ae, lo, own
    starts = np.arange(4, dtype=np.int32) * STRIDE
    return (chunk, pad_contig_lengths(sc.lengths), len(sc.lengths), starts,
            ns, aes, los, owns)


@pytest.mark.parametrize("funnel", [True, False], ids=["funnel", "full"])
def test_count_scan_matches_jax(varied, funnel):
    chunk, lens, nc, starts, ns, aes, los, owns = _packed_chunk(varied)
    want = jck.count_scan(
        jnp.asarray(chunk), jnp.asarray(lens), jnp.int32(nc),
        jnp.asarray(starts), jnp.asarray(ns), jnp.asarray(aes),
        jnp.asarray(los), jnp.asarray(owns), window=W, reads_to_check=10,
        flags_impl="xla", pallas_interpret=False, funnel=funnel)
    args = (torch.from_numpy(chunk), torch.from_numpy(lens), nc, starts, ns,
            aes, los, owns)
    got = count_scan(*args, window=W, funnel=funnel)
    runner = make_count_scan(W, 10, funnel, device="cpu")(*args)
    for k in ("count", "esc_count", "survivors"):
        assert got[k].dtype == torch.int32, k
        assert int(got[k]) == int(want[k]), (k, int(got[k]), int(want[k]))
        assert int(runner[k]) == int(want[k]), k
    assert int(got["count"]) > 0 and int(got["survivors"]) > 0
    # The dummy row counts nothing: the three real rows alone agree.
    three = count_scan(torch.from_numpy(chunk), torch.from_numpy(lens), nc,
                       starts[:3], ns[:3], aes[:3], los[:3], owns[:3],
                       window=W, funnel=funnel)
    assert all(int(three[k]) == int(got[k]) for k in three)


def test_count_scan_refuses_a_row_past_the_chunk():
    chunk = torch.zeros(STRIDE, dtype=torch.uint8)
    with pytest.raises(ValueError, match="runs past"):
        count_scan(chunk, torch.zeros(4, dtype=torch.int32), 1, [1], [5],
                   [True], [0], [5], window=W)


def _spy_runner(sc, calls):
    """Record the row count of every chunk the checker dispatches."""
    real = make_count_scan(sc.kernel_window, sc.config.reads_to_check,
                           sc.config.funnel_enabled(), "cpu")

    def runner(chunk, lengths, nc, starts, ns, *rest):
        calls.append(len(ns))
        return real(chunk, lengths, nc, starts, ns, *rest)

    sc.scan_runner = runner


@pytest.mark.parametrize("chunk_windows,first", CHUNKINGS)
def test_count_reads_resident_matches_jax(synth, jax_resident, port_count,
                                          chunk_windows, first):
    path, reads = synth
    sc = _checker(path)
    calls: list = []
    _spy_runner(sc, calls)
    got = sc.count_reads_resident(chunk_windows=chunk_windows,
                                  first_chunk_windows=first)
    assert got == jax_resident == port_count[0] == reads
    assert sc.funnel_stats == port_count[1]
    windows = len(sc.pipeline.groups)
    rest = windows - first
    assert calls == [first] + [chunk_windows] * (rest // chunk_windows) + (
        [rest % chunk_windows] if rest % chunk_windows else [])


def test_count_reads_resident_one_row_chunks(synth, jax_resident):
    """``resident_chunk_bytes=1`` clamps a chunk to one window row."""
    path, _ = synth
    sc = _checker(path, Config(resident_chunk_bytes=1))
    calls: list = []
    _spy_runner(sc, calls)
    assert sc.count_reads_resident() == jax_resident
    assert calls == [1] * len(sc.pipeline.groups)


def test_count_reads_resident_single_default_chunk(synth, jax_resident):
    path, _ = synth
    sc = _checker(path)
    calls: list = []
    _spy_runner(sc, calls)
    assert sc.count_reads_resident(first_chunk_windows=64) == jax_resident
    assert calls == [len(sc.pipeline.groups)]


def test_count_reads_resident_funnel_off(synth, jax_resident):
    path, _ = synth
    sc = _checker(path, Config(funnel="off"))
    assert sc.count_reads_resident(chunk_windows=3) == jax_resident
    assert sc.funnel_stats is None


def test_count_reads_resident_varied_reads(varied):
    """Reads of 10-400 bases in blocks up to 40 KB: equal to the port's
    ``count_reads`` and to the JAX streaming count."""
    from spark_bam_tpu.tpu.stream_check import count_reads_streaming

    want = count_reads_streaming(varied, JaxConfig(), window_uncompressed=FRESH,
                                 halo=HALO, use_device=False)
    sc = _checker(varied)
    assert sc.count_reads_resident(chunk_windows=3, first_chunk_windows=2) \
        == sc.count_reads() == want


def test_long_reads_escape_to_spans(tmp_path):
    """30 reads of 60-110 kb at a 256 KiB window and 64 KiB halo: the
    chains outrun the halo, the first chunk escapes, and the count comes
    out exact through ``_count_via_spans`` (whose windows come from host
    zlib here, like the resident count's, to spare the CPU tokenizer)."""
    p = tmp_path / "long.bam"
    m = synth_bam(p, 1, seed=9, unit_reads=30, read_len=(60_000, 110_000))
    assert m["reads"] == 30
    sc = StreamChecker(p, Config(device_inflate=False),
                       window_uncompressed=256 << 10, halo=64 << 10,
                       device="cpu")
    retries = []
    via_spans = sc._count_via_spans
    sc._count_via_spans = lambda: retries.append(1) or via_spans()
    assert sc.count_reads_resident(chunk_windows=4) == 30
    assert retries == [1]


@pytest.mark.parametrize("funnel", [True, False], ids=["funnel", "full"])
def test_count_window_tensor_scalars_equal_ints(varied, funnel):
    """``n``, ``at_eof``, ``lo`` and ``own`` as 0-d tensors (int32 n, an
    int32 or bool at_eof) give the int results; so do the flag passes'
    plain versions."""
    data = flatten_file(varied).data
    sc = _checker(varied)
    lens = torch.from_numpy(pad_contig_lengths(sc.lengths))
    nc = len(sc.lengths)
    padded = torch.zeros(STRIDE, dtype=torch.uint8)
    padded[:W] = torch.from_numpy(data[:W].copy())
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    for n, ae, lo, own in ((W, False, 300, W - HALO), (W - 777, True, 0,
                                                       W - 777),
                           (5000, False, 0, 5000), (0, False, 0, 0)):
        want = ck.count_window(padded, lens, nc, n, ae, lo, own, 10, funnel)
        for t_ae in (i32(int(ae)), torch.tensor(ae)):
            got = ck.count_window(padded, lens, nc, i32(n), t_ae, i32(lo),
                                  i32(own), 10, funnel)
            for k in want:
                assert int(got[k]) == int(want[k]), (n, ae, k)
        cap = K.lane_capacity(W)
        for a, b in zip(K._prefilter_compact(padded, lens, nc, n, cap),
                        K._prefilter_compact(padded, lens, nc, i32(n), cap)):
            assert torch.equal(a, b)
        assert torch.equal(K._compute_flags(padded, lens, nc, n),
                           K._compute_flags(padded, lens, nc, i32(n)))


def test_config_defaults_and_chunk_clamp(synth):
    cfg = Config()
    assert cfg.resident_scan is False
    assert cfg.resident_chunk_bytes == 256 << 20
    path, _ = synth
    rows = {}
    for budget in (1, STRIDE - 1, 3 * STRIDE, 256 << 20, 1 << 40):
        rows[budget] = _checker(path, Config(resident_chunk_bytes=budget)) \
            .resident_chunk_rows()
    # At least one row; floored to a power of two; at most 1 GiB.
    assert rows == {1: 1, STRIDE - 1: 1, 3 * STRIDE: 2,
                    256 << 20: 512, 1 << 40: 2048}
    sc = _checker(path)
    sc.kernel_window = 1 << 25       # the default geometry's kernel window
    assert sc.resident_chunk_rows() == 4


def _count_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not ln.startswith(
        "spark-bam read-count time:")]


def test_cli_resident_prints_the_default_count(synth, monkeypatch, capsys):
    """The resident count prints the count the default command (the
    record path against hadoop-bam) matches, in the standalone lines,
    from the flag and from the config's opt-in alike."""
    path, reads = synth
    assert cli.main(["count-reads", "--device", "cpu", str(path)]) == 0
    default = capsys.readouterr().out
    assert f"Read counts matched: {reads}" in default
    calls = []
    real = StreamChecker.count_reads_resident

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(StreamChecker, "count_reads_resident", spy)
    assert cli.main(["count-reads", "--resident", "--device", "cpu",
                     str(path)]) == 0
    resident = capsys.readouterr().out
    assert f"Read count: {reads}" in resident
    assert "funnel: on (auto)" in resident
    out = io.StringIO()
    assert cli.count_reads(path, device="cpu", out=out,
                           config=Config(resident_scan=True)) == reads
    assert calls == [1, 1]
    assert _count_lines(out.getvalue()) == _count_lines(resident)


def test_graph_runner_needs_cuda(monkeypatch):
    with pytest.raises(ValueError, match="CUDA device"):
        CountScanGraphs(W, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_count_scan(W)
