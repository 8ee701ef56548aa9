"""The fused stage-0 pass's plain version against the JAX package.

``kernels._prefilter_compact`` (the plain version of ``csrc/prefilter.cu``,
which the ``prefilter_check_flags`` wrapper runs for CPU tensors) must equal
the JAX ``prefilter_check_flags`` (the Pallas kernel in interpret mode, as
the JAX package's own tests run it on the CPU) followed by the JAX
``checker._compact_mask``, exactly: the flags at every offset, the
candidate positions and the survivor count. On the shared edge set
(``benchmarks/prefilter_cases.py``) and on seeded windows; then the
funnel's ``check_window`` and ``count_window`` against the JAX package's
on the survivor-count edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.header import contig_lengths
from spark_bam_tpu.bgzf.flat import flatten_file
from spark_bam_tpu.tpu import checker as jck
from spark_bam_tpu.tpu.pallas_kernels import TILE as PALLAS_TILE
from spark_bam_tpu.tpu.pallas_kernels import (
    prefilter_check_flags as pallas_prefilter,
)
from spark_bam_tpu_torch.benchmarks import prefilter_cases
from spark_bam_tpu_torch.tpu import checker as ck
from spark_bam_tpu_torch.tpu import kernels as K
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = 1 << 17  # 4 Pallas tiles, 8 CUDA tiles
CASES = prefilter_cases.prefilter_windows(W, seed=3)


def _jax_reference(padded, n, lens, nc):
    """JAX flags (Pallas, interpret mode) and compaction. The Pallas kernel
    takes whole 32 KiB tiles: a ragged window is zero-extended, which no
    offset below its ``w`` reads."""
    w = len(padded) - K.PAD
    wt = -(-w // PALLAS_TILE) * PALLAS_TILE
    ext = np.zeros(wt + K.PAD, dtype=np.uint8)
    ext[: len(padded)] = padded
    F = np.asarray(pallas_prefilter(
        jnp.asarray(ext), jnp.asarray(lens), jnp.int32(nc).reshape(1),
        jnp.int32(n).reshape(1), interpret=True))[:w]
    survivor = (F == 0) & (np.arange(w) < n)
    cand, n_set = jck._compact_mask(jnp.asarray(survivor),
                                    K.lane_capacity(w))
    return F, np.asarray(cand), int(n_set)


def _plain(padded, n, lens, nc):
    w = len(padded) - K.PAD
    F, cand, n_set = K._prefilter_compact(
        torch.from_numpy(padded), torch.from_numpy(lens), nc, n,
        K.lane_capacity(w))
    assert F.dtype == cand.dtype == n_set.dtype == torch.int32
    assert F.shape == (w,) and cand.shape == (K.lane_capacity(w),)
    return F.numpy(), cand.numpy(), int(n_set)


def _assert_same(got, want, label):
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"{label}: F")
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"{label}: cand")
    assert got[2] == want[2], (label, got[2], want[2])


@pytest.mark.parametrize("name", list(CASES))
def test_prefilter_compact_plain_matches_jax_on_edge_windows(name):
    padded, n, lens, nc = CASES[name]
    got = _plain(padded, n, lens, nc)
    _assert_same(got, _jax_reference(padded, n, lens, nc), name)
    F, cand, n_set = got
    cap = K.lane_capacity(len(padded) - K.PAD)
    live = cand[cand >= 0]
    assert len(live) == min(n_set, cap)
    assert (np.diff(live) > 0).all() and (F[live] == 0).all()
    if name == "survivor_at_n_minus_36":
        assert live[-1] == n - 36
    if name == "count_capacity":
        assert n_set == cap and (cand >= 0).all()
    if name == "count_capacity_plus_1":
        assert n_set == cap + 1 and (cand >= 0).all()
    if name == "count_2x_capacity":
        assert n_set == 2 * cap
    if name in ("none_at_n_minus_35", "n_35", "n_0", "count_0"):
        assert n_set == 0 and (cand == -1).all()
    if name == "first_tile_only":
        assert live[-1] < prefilter_cases.TILE
    if name == "last_tile_only":
        assert live[0] >= len(F) - prefilter_cases.TILE


@pytest.fixture(scope="module")
def bam_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_prefilter_compact")
    p = tmp / "pc.bam"
    random_bam(p, seed=501, read_len=(10, 200), n_records=(400, 600))
    lens = np.array(contig_lengths(p).lengths_list(), dtype=np.int32)
    return flatten_file(p).data, lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefilter_compact_plain_matches_jax_on_seeded_windows(bam_data,
                                                               seed):
    """Windows cut from a random BAM at a seeded offset, with seeded
    random bytes and survivor runs spliced in, at a seeded ``n``."""
    data, lengths = bam_data
    rng = np.random.default_rng(seed)
    lens = np.zeros(prefilter_cases.CMAX, dtype=np.int32)
    lens[: len(lengths)] = lengths
    padded = np.zeros(W + K.PAD, dtype=np.uint8)
    start = int(rng.integers(0, max(len(data) - W, 1)))
    chunk = data[start: start + W]
    padded[: len(chunk)] = chunk
    at = int(rng.integers(0, W // 2))
    padded[at: at + 4096] = rng.integers(0, 256, 4096, dtype=np.uint8)
    prefilter_cases.survivor_run(padded, int(rng.integers(0, W // 2)) * 2,
                                 int(rng.integers(1, 600)))
    n = int(rng.integers(W - 5000, W + 1))
    got = _plain(padded, n, lens, len(lengths))
    _assert_same(got, _jax_reference(padded, n, lens, len(lengths)),
                 f"seed {seed}")
    assert got[2] > 0


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    padded, n, lens, nc = CASES["random_with_records"]
    p, lt = torch.from_numpy(padded), torch.from_numpy(lens)
    got = K.prefilter_check_flags(p, lt, nc, n)
    want = K._prefilter_compact(p, lt, nc, n, K.lane_capacity(W))
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("name", ["count_capacity", "count_capacity_plus_1",
                                  "count_2x_capacity",
                                  "survivor_at_n_minus_36", "tail_crosses_tile",
                                  "random_with_records"])
@pytest.mark.parametrize("at_eof", [True, False])
def test_funnel_check_and_count_match_jax_on_survivor_edges(name, at_eof):
    """The funnel's window check and count (the fused pass's consumers) on
    the edge set's survivor counts and positions: every output equal."""
    padded, n, lens, nc = CASES[name]
    want = jck.check_window(
        jnp.asarray(padded), jnp.asarray(lens), jnp.int32(nc), jnp.int32(n),
        jnp.bool_(at_eof), funnel=True)
    got = ck.check_window(torch.from_numpy(padded), torch.from_numpy(lens),
                          nc, n, at_eof, funnel=True)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=f"{name}: {k}")
    lo, own = 100, n - 1000
    want_c = jck.count_window(
        jnp.asarray(padded), jnp.asarray(lens), jnp.int32(nc), jnp.int32(n),
        jnp.bool_(at_eof), jnp.int32(lo), jnp.int32(own), funnel=True)
    got_c = ck.count_window(torch.from_numpy(padded), torch.from_numpy(lens),
                            nc, n, at_eof, lo, own)
    for k in ("count", "esc_count", "survivors"):
        assert int(got_c[k]) == int(want_c[k]), (name, k)
