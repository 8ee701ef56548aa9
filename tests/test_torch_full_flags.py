"""The port's full pass (``full_check_flags``, plain version on the CPU)
against the JAX package's, bit for bit.

The same (W + PAD,) windows, made with numpy, go through JAX
``checker._compute_flags`` (and once through the Pallas kernel in
interpret mode, as the JAX package's own tests run it) and through the
port's ``kernels.full_check_flags`` on CPU tensors, which is the plain
``_compute_flags``. Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.header import contig_lengths
from spark_bam_tpu.bgzf.flat import flatten_file
from spark_bam_tpu.tpu import checker as jck
from spark_bam_tpu.tpu.pallas_kernels import TILE
from spark_bam_tpu.tpu.pallas_kernels import full_check_flags as pallas_full
from spark_bam_tpu_torch.benchmarks import resolve_flag_cases
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.tpu import kernels as K
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = 256 << 10  # a multiple of the Pallas tile (32 KiB)


def _padded(data, w=W):
    padded = np.zeros(w + K.PAD, dtype=np.uint8)
    n = min(len(data), w + K.PAD)
    padded[:n] = np.asarray(data)[:n]
    return padded


def _table(lengths, cmax=1024):
    lens = np.zeros(cmax, dtype=np.int32)
    lens[: len(lengths)] = lengths
    return lens


def _both(padded, lens, nc, n):
    want = np.asarray(jck._compute_flags(
        jnp.asarray(padded), jnp.asarray(lens), jnp.int32(nc), jnp.int32(n)))
    got = K.full_check_flags(torch.from_numpy(padded), torch.from_numpy(lens),
                             nc, n).numpy()
    return want, got


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """name → (padded (W + PAD,) u8, lengths (1024,) i32, num_contigs, n)."""
    tmp = tmp_path_factory.mktemp("torch_full_flags")
    rng = np.random.default_rng(23)
    out = {}
    p = tmp / "r.bam"
    random_bam(p, seed=230, n_records=(300, 500))
    lens = np.array(contig_lengths(p).lengths_list(), dtype=np.int32)
    out["bam"] = (_padded(flatten_file(p).data), lens)
    out["random"] = (_padded(rng.integers(0, 256, W, dtype=np.uint8)), lens)
    out["0x88"] = (_padded(np.full(W + K.PAD, 0x88, dtype=np.uint8)), lens)
    lp = tmp / "long.bam"
    synth_bam(lp, 1 << 20, seed=9, unit_reads=8, read_len=(60_000, 110_000))
    out["long"] = (_padded(flatten_file(lp).data),
                   np.array(contig_lengths(lp).lengths_list(), dtype=np.int32))
    return {k: (pad, _table(ls), len(ls)) for k, (pad, ls) in out.items()}


@pytest.mark.parametrize("name", ["bam", "random", "0x88", "long"])
@pytest.mark.parametrize("short", [False, True], ids=["n_full", "n_short"])
def test_full_flags_plain_matches_jax(windows, name, short):
    padded, lens, nc = windows[name]
    n = W - 12345 if short else W   # EOF-dependent bits mid-buffer
    want, got = _both(padded, lens, nc, n)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (W,)


def test_full_flags_0x88_is_all_valid_cigar():
    """Constant 0x88: every int is a valid cigar op and n_cigar is 34,952,
    so no offset reports invalidCigarOp; exactly the ones whose cigar runs
    past n report tooFewBytesForCigarOps."""
    padded = _padded(np.full(W + K.PAD, 0x88, dtype=np.uint8))
    _, got = _both(padded, _table([1000]), 1, W)
    from spark_bam_tpu_torch.check.flags import BIT

    i = np.arange(W - 35)
    name_end = i + 36 + 0x88           # past n: the cigar is not read
    short = (got[: W - 35] & BIT["tooFewBytesForCigarOps"]) != 0
    assert not (got & BIT["invalidCigarOp"]).any()
    np.testing.assert_array_equal(
        short, (name_end <= W) & (name_end + 4 * 0x8888 > W))


def test_full_flags_plain_matches_pallas_interpret(windows):
    """Once against the Pallas kernel itself (interpret mode) on a window
    of four tiles, at both valid lengths."""
    w = 4 * TILE
    padded, lens, nc = windows["bam"]
    padded = _padded(padded[: w + K.PAD], w)
    for n in (w, w - 12345):
        want = np.asarray(pallas_full(
            jnp.asarray(padded), jnp.asarray(lens),
            jnp.asarray(np.array([nc], dtype=np.int32)),
            jnp.asarray(np.array([n], dtype=np.int32)), interpret=True))
        got = K.full_check_flags(torch.from_numpy(padded),
                                 torch.from_numpy(lens), nc, n).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


@pytest.fixture(scope="module")
def edge_windows():
    return resolve_flag_cases.flag_windows(W)


@pytest.mark.parametrize("name", list(resolve_flag_cases.flag_windows(W)))
def test_full_flags_plain_matches_jax_on_edge_windows(edge_windows, name):
    """The shared flag-window edge set: bad cigar ops on the CUDA kernel's
    tile and lookahead edges, ``n`` around a tile boundary and below 36, a
    window that is not a whole number of tiles."""
    padded, n = edge_windows[name]
    lens = _table([248_956_422, 242_193_529])
    want, got = _both(padded, lens, 2, n)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (padded.size - K.PAD,)


@pytest.mark.parametrize("name", ["cigar_reach_last_op",
                                  "cigar_reach_past_end"])
def test_full_flags_plain_matches_jax_at_cigar_reach(name):
    """A cigar of 65,535 ops after a 255-byte name, its last op bad (or the
    one after it), at a window wide enough to hold it."""
    padded, n = resolve_flag_cases.flag_windows(1 << 19)[name]
    lens = _table([248_956_422, 242_193_529])
    want, got = _both(padded, lens, 2, n)
    np.testing.assert_array_equal(got, want)
    i0 = resolve_flag_cases.TILE - 1
    from spark_bam_tpu_torch.check.flags import BIT

    bad = bool(got[i0] & BIT["invalidCigarOp"])
    assert bad == (name == "cigar_reach_last_op")


def test_full_flags_edge_windows_match_pallas_interpret():
    """Once against the Pallas kernel (interpret mode): two edge windows
    at four Pallas tiles."""
    w = 4 * TILE
    cases = resolve_flag_cases.flag_windows(w)
    lens = _table([248_956_422, 242_193_529])
    for name in ("bad_at_tile_end", "bad_past_lookahead"):
        padded, n = cases[name]
        want = np.asarray(pallas_full(
            jnp.asarray(padded), jnp.asarray(lens),
            jnp.asarray(np.array([2], dtype=np.int32)),
            jnp.asarray(np.array([n], dtype=np.int32)), interpret=True))
        got = K.full_check_flags(torch.from_numpy(padded),
                                 torch.from_numpy(lens), 2, n).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("short", [False, True], ids=["n_full", "n_short"])
def test_full_flags_plain_matches_jax_on_bam2(bam2, short):
    data = flatten_file(bam2).data
    lens = np.array(contig_lengths(bam2).lengths_list(), dtype=np.int32)
    n = W - 12345 if short else W
    want, got = _both(_padded(data), _table(lens), len(lens), n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["bam", "long"])
@pytest.mark.parametrize("at_eof", [True, False])
@pytest.mark.parametrize("mode", ["all", "candidates"])
def test_host_engine_matches_jax(windows, name, at_eof, mode):
    """The port's NumPy engine (``check/vectorized.py``, the deferral
    resolver) against the JAX package's: every ``ChainResult`` field."""
    from spark_bam_tpu.check.vectorized import check_flat as jax_check_flat
    from spark_bam_tpu_torch.check.vectorized import check_flat

    padded, lens, nc = windows[name]
    buf = padded[: W - 777]
    cands = None
    if mode == "candidates":
        cands = np.random.default_rng(5).choice(len(buf), 4000,
                                                replace=False)
    want = jax_check_flat(buf, lens[:nc], candidates=cands, at_eof=at_eof)
    got = check_flat(buf, lens[:nc], candidates=cands, at_eof=at_eof)
    for k in ("verdict", "reads_parsed", "fail_mask", "reads_before",
              "exact", "escaped"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_report_rules_match_jax(seed):
    """``considered_mask``, ``num_failing_fields`` and the byte-histogram
    ``bit_counts`` against the JAX package's rules and a per-bit count, on
    seeded 19-bit masks with bare at-EOF markers and zeros mixed in."""
    from spark_bam_tpu.check import flags as jflags
    from spark_bam_tpu_torch.check import flags as tflags

    rng = np.random.default_rng(seed)
    n = 50_000
    fm = rng.integers(0, 1 << 19, size=n).astype(np.int32)
    fm[rng.random(n) < 0.2] = 1
    fm[rng.random(n) < 0.2] = 0
    fm[rng.random(n) < 0.2] &= 0x3
    rb = rng.integers(0, 3, size=n).astype(np.int32)
    considered = tflags.considered_mask(fm, rb)
    np.testing.assert_array_equal(considered, jflags.considered_mask(fm, rb))
    np.testing.assert_array_equal(tflags.num_failing_fields(fm, rb),
                                  jflags.num_failing_fields(fm, rb))
    masked = fm[considered]
    want = [int(((masked >> i) & 1).sum()) for i in range(19)]
    assert tflags.bit_counts(masked).tolist() == want
    assert tflags.bit_counts(masked[:0]).tolist() == [0] * 19


def test_tile_status_bookkeeping():
    """The full pass's per-stream status records: each launch's tickets
    start where the previous launch's ended, epochs only grow, a larger
    window or a dropped stream starts again from zeroed records."""
    st = K.TileStatus()
    cpu = torch.device("cpu")
    rec, base, epoch = st.next(cpu, 7, 5)
    assert (base, epoch) == (0, 1) and rec.numel() == 16 * 6
    assert not rec.any()
    again, base, epoch = st.next(cpu, 7, 5)
    assert again is rec and (base, epoch) == (5, 2)
    _, base, epoch = st.next(cpu, 8, 5)          # another stream: its own
    assert (base, epoch) == (0, 1)
    bigger, base, epoch = st.next(cpu, 7, 9)
    assert bigger is not rec and bigger.numel() == 16 * 10
    assert (base, epoch) == (0, 1)
    st.drop(cpu, 7)
    assert st.next(cpu, 7, 9)[1:] == (0, 1)


def test_tile_status_threads():
    """Threads taking launches on one stream's records at once: every
    launch gets its own epoch and a ticket range that follows the one
    before it, none lost or repeated."""
    import sys
    import threading

    st = K.TileStatus()
    cpu = torch.device("cpu")
    got = []
    lock = threading.Lock()

    def work():
        for _ in range(200):
            _, base, epoch = st.next(cpu, 7, 3)
            with lock:
                got.append((epoch, base))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(got) == [(e, 3 * (e - 1)) for e in range(1, 3201)]
