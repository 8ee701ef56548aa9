"""The funnel's stage 1 on the CPU route against the JAX package.

The port's lane core (``checker._check_lanes(funnel=True)``: the plain
versions ``kernels._bad_op_tables``, ``_walk_lanes`` and ``_count_lanes``
behind the wrappers that ``csrc/lanes.cu`` serves on a card) must equal the
JAX ``_check_lanes(funnel=True)`` output by output, exactly (verdicts,
masks and counts are integers): on every ``prefilter_cases`` window, the
``lane_cases`` windows (int32 wrap, long cigars, chains), three seeded
``synth_bam`` windows (one of long reads) and ``overflow_soup``, at
``reads_to_check`` 1, 3 and 10 and ``at_eof`` both ways; ``count_window``
over three owned spans; ``check_window``'s ``reads_parsed`` and
``reads_before`` on the overflowing window.

The survivor table that the card's walk reads (``kernels._survivor_table``,
the plain version of ``survivor_table``) must give, at every survivor of the
same windows and of ``lane_cases.dense_run``, the JAX ``_deep_flags_at``
mask and ``_misc_at`` step, and the walk over it (``kernels.
_walk_from_table``, the card kernel's design in PyTorch: successor ranks
and lower-bound searches) the JAX ``_check_lanes`` lanes at
``reads_to_check`` 1, 3 and 10 and ``at_eof`` both ways, under the funnel
and on the full pass's flags.

The JAX side runs jitted, its prefilter the Pallas kernel in interpret mode
(a ragged window zero-extended to whole 32 KiB Pallas tiles, which no
offset below its ``w`` reads), except on ``overflow_soup``, whose table of
2^31 - 1 contigs the interpreted Pallas kernel would loop over: there its
jnp prefilter (``flags_impl="xla"``), equal to the Pallas one on every
other window (``test_torch_prefilter_compact.py``).
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.tpu import checker as jck
from spark_bam_tpu.tpu.pallas_kernels import TILE as PALLAS_TILE
from spark_bam_tpu_torch.bam.header import contig_lengths
from spark_bam_tpu_torch.benchmarks import lane_cases, prefilter_cases
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.tpu import checker as ck
from spark_bam_tpu_torch.tpu import kernels as K
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = 1 << 17
PRE = prefilter_cases.prefilter_windows(W, seed=3)
LANE = lane_cases.lane_windows(W, seed=5)
SYNTH = {"synth_short_0": (1, {}, 0), "synth_short_1": (2, {}, 40961),
         "synth_long": (9, dict(unit_reads=8, read_len=(60_000, 110_000)),
                        70001)}
NAMES = [*PRE, *LANE, *SYNTH, "overflow_soup"]
#: The survivor table's window that the JAX package can run (the other,
#: ``tail_super_block``, holds more valid bytes than W).
DENSE = {"dense_run": lane_cases.dense_run(W)}
TABLE_NAMES = [*NAMES, *DENSE]
STATIC = ("reads_to_check", "flags_impl", "pallas_interpret", "funnel")
_jax_lanes = jax.jit(jck._check_lanes, static_argnames=STATIC)
LANE_KEYS = ("cand", "live", "res", "fail_mask", "reads_before",
             "reads_parsed", "exact")
WIDE_KEYS = ("survivor", "res0", "fail_mask0", "inexact0")


@pytest.fixture(scope="module")
def synth_windows(tmp_path_factory):
    """Windows of ``W`` bytes cut from seeded synthetic BAMs."""
    tmp = tmp_path_factory.mktemp("torch_check_lanes")
    out = {}
    for name, (seed, kw, off) in SYNTH.items():
        path = tmp / f"{name}.bam"
        synth_bam(path, 2 << 20, seed=seed, **kw)
        data = flatten_file(path).data
        lens = np.zeros(prefilter_cases.CMAX, dtype=np.int32)
        cl = contig_lengths(path).lengths_list()
        lens[: len(cl)] = cl
        padded = np.zeros(W + K.PAD, dtype=np.uint8)
        chunk = data[off: off + W]
        padded[: len(chunk)] = chunk
        out[name] = (padded, len(chunk), lens, len(cl))
    return out


@pytest.fixture
def case(request, synth_windows):
    name = request.param
    if name in PRE:
        return PRE[name]
    if name in LANE:
        return LANE[name]
    if name in DENSE:
        return DENSE[name]
    if name == "overflow_soup":
        return prefilter_cases.overflow_soup(W)
    return synth_windows[name]


def _impl(n_contigs: int) -> str:
    return "xla" if n_contigs == 0x7FFFFFFF else "pallas"


def _extended(padded):
    """The window zero-extended to whole Pallas tiles."""
    w = len(padded) - K.PAD
    wt = -(-w // PALLAS_TILE) * PALLAS_TILE
    ext = np.zeros(wt + K.PAD, dtype=np.uint8)
    ext[: len(padded)] = padded
    return ext


_JAX_LANES: dict = {}


def _jax_check_lanes(padded, n, lens, nc, at_eof, rtc, funnel=True):
    """The JAX lane core's outputs, kept by content for the tests that
    ask again (one worker runs this file)."""
    key = (hashlib.sha1(padded).hexdigest(), hashlib.sha1(lens).hexdigest(),
           n, nc, bool(at_eof), rtc, funnel)
    if key not in _JAX_LANES:
        out = _jax_lanes(jnp.asarray(_extended(padded)), jnp.asarray(lens),
                         jnp.int32(nc), jnp.int32(n), jnp.bool_(at_eof),
                         reads_to_check=rtc, flags_impl=_impl(nc),
                         pallas_interpret=True, funnel=funnel)
        _JAX_LANES[key] = {k: np.asarray(v) for k, v in out.items()}
    return _JAX_LANES[key]


def _port_check_lanes(padded, n, lens, nc, at_eof, rtc):
    out = ck._check_lanes(torch.from_numpy(padded), torch.from_numpy(lens),
                          nc, n, at_eof, rtc, funnel=True)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("at_eof", [True, False])
@pytest.mark.parametrize("rtc", [1, 3, 10])
@pytest.mark.parametrize("case", NAMES, indirect=True)
def test_lane_core_matches_jax(case, rtc, at_eof):
    padded, n, lens, nc = case
    w = len(padded) - K.PAD
    got = _port_check_lanes(padded, n, lens, nc, at_eof, rtc)
    want = _jax_check_lanes(padded, n, lens, nc, at_eof, rtc)
    for k in LANE_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in WIDE_KEYS:
        np.testing.assert_array_equal(got[k], want[k][:w], err_msg=k)
    for k in ("overflow", "n_survivors"):
        assert int(got[k]) == int(want[k]), k


@functools.lru_cache(maxsize=None)
def _jax_count(rtc: int, impl: str):
    return functools.partial(jck.count_window, reads_to_check=rtc,
                             flags_impl=impl, pallas_interpret=True,
                             funnel=True)


@pytest.mark.parametrize("at_eof", [True, False])
@pytest.mark.parametrize("case", NAMES, indirect=True)
def test_count_window_matches_jax(case, at_eof):
    """Three owned spans: the whole window, one cut inside it, and one
    that starts past it (an empty span)."""
    padded, n, lens, nc = case
    w = len(padded) - K.PAD
    ext = jnp.asarray(_extended(padded))
    count = _jax_count(10, _impl(nc))
    for lo, own in ((0, n), (100, max(n - 1000, 0)), (w + 5, w + 50)):
        got = ck.count_window(torch.from_numpy(padded),
                              torch.from_numpy(lens), nc, n, at_eof, lo, own)
        # The extension's offsets past w hold no survivor; keep the span
        # inside w so neither side counts them.
        want = count(ext, jnp.asarray(lens), jnp.int32(nc), jnp.int32(n),
                     jnp.bool_(at_eof), jnp.int32(min(lo, w)),
                     jnp.int32(min(own, w)))
        for k in ("count", "esc_count", "survivors"):
            assert int(got[k]) == int(want[k]), (lo, own, k)
            assert got[k].dtype == torch.int64, k


@pytest.mark.parametrize("name", ["overflow_soup", "overflow_chain"])
def test_check_window_overflow_reads_match_jax(name):
    """Under a capacity overflow ``check_window`` escapes every offset but
    leaves ``reads_parsed`` and ``reads_before`` unmasked: the survivors
    past the capacity walk as mask 0, as in the reference, so the first
    lane of ``overflow_chain`` parses records whose names fail."""
    if name == "overflow_soup":
        padded, n, lens, nc = prefilter_cases.overflow_soup(W)
    else:
        padded, n, lens, nc = LANE[name]
    for at_eof in (True, False):
        want = jck.check_window(jnp.asarray(padded), jnp.asarray(lens),
                                jnp.int32(nc), jnp.int32(n),
                                jnp.bool_(at_eof), funnel=True)
        got = ck.check_window(torch.from_numpy(padded),
                              torch.from_numpy(lens), nc, n, at_eof,
                              funnel=True)
        assert int(got["survivors"]) > K.lane_capacity(W)
        for k in ("reads_parsed", "reads_before", "escaped", "verdict"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        if name == "overflow_chain":
            assert int(got["reads_parsed"][64]) == 10


def test_int32_wrap_window_reaches_the_sentinels():
    """The wrap window's records pass every check and step through the
    clamped cursor: some lanes end as escapes at EOF (the untrustworthy
    edge after an overflowed cursor), and the JAX package agrees."""
    padded, n, lens, nc = LANE["int32_wrap"]
    got = _port_check_lanes(padded, n, lens, nc, True, 10)
    want = _jax_check_lanes(padded, n, lens, nc, True, 10)
    live = got["live"]
    assert (got["res"][live] == 2).sum() >= 4
    assert (got["res"][live] == 1).sum() >= 4
    np.testing.assert_array_equal(got["res"], want["res"])
    # A survivor with seq_len 2^31 - 1 (seq_len + 1 wraps) and one with
    # remaining below -2^30.
    fields = [np.frombuffer(padded[c: c + 24].tobytes(), "<i4")
              for c in got["cand"][live]]
    assert any(f[5] == 0x7FFFFFFF for f in fields)
    assert any(f[0] < -(1 << 30) for f in fields)


def test_bad_op_tables_plain_layout():
    """``_bad_op_tables``' words are the reference's ``cwords``, and each
    class summary bit is the OR of its 1,024-byte block's class bits."""
    padded, n, _lens, _nc = LANE["cigar_spans"]
    p = torch.from_numpy(padded)
    words, blocks = K._bad_op_tables(p, n)
    ref_words = np.asarray(jck._funnel_tables(jnp.asarray(padded),
                                              jnp.int32(n))[2])
    np.testing.assert_array_equal(words.numpy().view(np.uint32), ref_words)
    u = np.zeros(blocks.shape[1] * 1024, dtype=np.uint32)
    u[: words.numel()] = words.numpy().view(np.uint32)
    per = u.reshape(-1, 32)
    for c in range(4):
        any_c = ((per & np.uint32(0x11111111 << c)) != 0).any(1)
        bits = np.packbits(any_c.astype(np.uint8), bitorder="little")
        np.testing.assert_array_equal(
            blocks[c].numpy().view(np.uint32), bits.view(np.uint32))
    assert blocks.numpy().any()


def test_wrappers_take_the_plain_versions_on_cpu_tensors():
    """CPU tensors run the plain versions and launch nothing."""
    padded, n, lens, nc = PRE["random_with_records"]
    p, lt = torch.from_numpy(padded), torch.from_numpy(lens)
    before = dict(K.LAUNCHES)
    F, cand, n_set = K.prefilter_check_flags(p, lt, nc, n)
    tables = K.bad_op_tables(p, n)
    for got, want in zip(tables, K._bad_op_tables(p, n)):
        assert torch.equal(got, want)
    lanes = K.walk_lanes(p, lt, nc, n, False, F, cand, n_set, tables)
    plain = K._walk_lanes(p, lt, nc, n, False, F, cand, n_set, tables)
    for k in plain:
        assert torch.equal(lanes[k], plain[k]), k
    counted = K.count_lanes(p, lt, nc, n, False, F, cand, n_set, tables, 0, n)
    assert torch.equal(counted, K._count_lanes(p, lt, nc, n, False, F, cand,
                                               n_set, tables, 0, n))
    assert counted.dtype == torch.int64 and counted.shape == (3,)
    assert K.LAUNCHES == before


def test_zero_d_scalars_equal_python_scalars():
    """``n``, ``at_eof``, ``lo`` and ``own`` as 0-d tensors (a CUDA graph's
    form) give what Python values give."""
    padded, n, lens, nc = LANE["chains"]
    p, lt = torch.from_numpy(padded), torch.from_numpy(lens)
    for at_eof in (True, False):
        want = ck.count_window(p, lt, nc, n, at_eof, 50, n - 300)
        got = ck.count_window(p, lt, nc, torch.tensor(n, dtype=torch.int32),
                              torch.tensor(int(at_eof), dtype=torch.int32),
                              torch.tensor(50, dtype=torch.int32),
                              torch.tensor(n - 300, dtype=torch.int32))
        for k in want:
            assert int(got[k]) == int(want[k]), k


def _stage0(padded, n, lens, nc, funnel=True):
    """The port's plain stage 0 and bad-op tables of one window."""
    p, lt = torch.from_numpy(padded), torch.from_numpy(lens)
    w = len(padded) - K.PAD
    if funnel:
        F, cand, n_set = K._prefilter_compact(p, lt, nc, n,
                                              K.lane_capacity(w))
        return p, lt, F, cand, n_set, K._bad_op_tables(p, n)
    F = K._compute_flags(p, lt, nc, n)
    survivor = (F == 0) & (torch.arange(w) < n)
    cand, n_set = K._compact_mask(survivor, K.lane_capacity(w))
    return p, lt, F, cand.int(), n_set.int(), None


@pytest.mark.parametrize("case", TABLE_NAMES, indirect=True)
def test_survivor_table_matches_jax(case):
    """Each survivor's entry: the JAX ``_deep_flags_at`` mask; where it is
    0, the JAX ``_misc_at`` remaining and body end, and the list rank of
    the position the record's step lands on (``~`` its lower bound where
    no survivor lies there; ``NO_SUCC`` at or past ``n`` or ``w - 1``)."""
    padded, n, lens, nc = case
    w = len(padded) - K.PAD
    p, lt, F, cand, n_set, tables = _stage0(padded, n, lens, nc)
    table = K._survivor_table(p, lt, nc, n, F, cand, n_set, tables).numpy()
    live = min(int(n_set), cand.numel())
    assert not table[live:].any()
    q = cand[:live].numpy()
    jp = jnp.asarray(padded)
    deep = np.asarray(jck._deep_flags_at(
        jp, jnp.asarray(lens), jnp.int32(nc), jnp.int32(n),
        jck._funnel_tables(jp, jnp.int32(n)), jnp.asarray(q)))
    rem, b_end = (np.asarray(a).astype(np.int64) for a in
                  jck._misc_at(jp, jnp.int32(n), jnp.asarray(q)))
    np.testing.assert_array_equal(table[:live, 0], deep)
    walks = deep == 0
    np.testing.assert_array_equal(table[:live, 1][walks], rem[walks])
    np.testing.assert_array_equal(table[:live, 2][walks], b_end[walks])
    assert not table[:live, 1:3][~walks].any()
    # The successor, from the reference's step at a logical cursor on the
    # record (sentinels +-(n + 64)).
    bound = n + 64
    nxt = np.clip(q + 4 + np.clip(rem, -bound, bound), -bound, bound)
    nat = np.minimum(np.maximum(b_end, nxt), n)
    lb = np.searchsorted(q, nat)
    hit = (lb < live) & (q[np.minimum(lb, max(live - 1, 0))] == nat)
    want = np.where(hit, lb, ~lb)
    want = np.where(walks & (nat < n) & (nat <= w - 1), want, K.NO_SUCC)
    np.testing.assert_array_equal(table[:live, 3], want)


@pytest.mark.parametrize("at_eof", [True, False])
@pytest.mark.parametrize("rtc", [1, 3, 10])
@pytest.mark.parametrize("case", TABLE_NAMES, indirect=True)
def test_table_walk_matches_jax(case, rtc, at_eof):
    """The card walk's design over the survivor table gives the JAX lane
    core's five outputs."""
    padded, n, lens, nc = case
    p, lt, F, cand, n_set, tables = _stage0(padded, n, lens, nc)
    table = K._survivor_table(p, lt, nc, n, F, cand, n_set, tables)
    got = K._walk_from_table(p, n, at_eof, F, cand, n_set, table, rtc)
    want = _jax_check_lanes(padded, n, lens, nc, at_eof, rtc)
    for k in ("res", "fail_mask", "reads_before", "reads_parsed", "exact"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


FULL_NAMES = [*LANE, "synth_short_1", "synth_long", "random_with_records"]


@pytest.mark.parametrize("at_eof", [True, False])
@pytest.mark.parametrize("case", FULL_NAMES, indirect=True)
def test_table_walk_on_the_full_pass_matches_jax(case, at_eof):
    """Without the funnel the table holds the full pass's flags and the
    walk over it gives the JAX full-pass lane core's outputs."""
    padded, n, lens, nc = case
    p, lt, F, cand, n_set, _ = _stage0(padded, n, lens, nc, funnel=False)
    table = K._survivor_table(p, lt, nc, n, F, cand, n_set, None, False)
    live = min(int(n_set), cand.numel())
    np.testing.assert_array_equal(table[:live, 0].numpy(),
                                  F[cand[:live].long()].numpy())
    got = K._walk_from_table(p, n, at_eof, F, cand, n_set, table, 10)
    want = _jax_check_lanes(padded, n, lens, nc, at_eof, 10, funnel=False)
    np.testing.assert_array_equal(got["res"].numpy(), want["res"])
    for k in ("fail_mask", "reads_before", "reads_parsed", "exact"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
