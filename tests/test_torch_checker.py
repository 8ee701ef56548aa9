"""The port's window checker against the JAX package's, at every position.

``check_window``/``count_window`` (funnel form and full pass), the
device-resident window ``count_window_raw`` and ``TpuChecker`` run in both
packages on identical windows, contig tables and scalars; every output must
be equal (exact integers and booleans). The port runs its plain versions on
the CPU.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.header import contig_lengths
from spark_bam_tpu.bgzf.flat import flatten_file
from spark_bam_tpu.bgzf.index_blocks import blocks_metadata as jax_blocks
from spark_bam_tpu.core.channel import open_channel as jax_open
from spark_bam_tpu.tpu import checker as jck
from spark_bam_tpu.bgzf.flat import stage_run_payloads as jax_stage
from spark_bam_tpu_torch.check.flags import BIT
from spark_bam_tpu_torch.tpu import checker as ck
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = 256 << 10
KEYS = ("verdict", "fail_mask", "reads_parsed", "reads_before", "exact",
        "escaped", "survivors")


def _window(data, w=W):
    padded = np.zeros(w + ck.PAD, dtype=np.uint8)
    n = min(len(data), w)
    padded[:n] = np.asarray(data)[:n]
    return padded, n


def _table(lengths, cmax=1024, fill=0):
    lens = np.full(cmax, fill, dtype=np.int32)
    lens[: len(lengths)] = lengths
    return lens


def _both_check(padded, lens, nc, n, at_eof, funnel=True, reads_to_check=10):
    want = jck.check_window(
        jnp.asarray(padded), jnp.asarray(lens), jnp.int32(nc), jnp.int32(n),
        jnp.bool_(at_eof), reads_to_check=reads_to_check, funnel=funnel)
    got = ck.check_window(torch.from_numpy(padded), torch.from_numpy(lens),
                          nc, n, at_eof, reads_to_check, funnel=funnel)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _assert_equal(want, got, label):
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{label}: {k}")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_checker")
    out = []
    for i, kw in enumerate((
        dict(n_records=(150, 400)),
        dict(n_records=(80, 200), mapped_rate=0.3, dup_rate=0.2),
        dict(read_len=(10, 200), n_records=(300, 500)),
    )):
        p = tmp / f"c{i}.bam"
        random_bam(p, seed=300 + i, **kw)
        lens = np.array(contig_lengths(p).lengths_list(), dtype=np.int32)
        out.append((p, flatten_file(p).data, lens))
    return out


@pytest.mark.parametrize("idx", [0, 1, 2])
@pytest.mark.parametrize("at_eof", [True, False])
def test_check_window_matches_jax(corpus, idx, at_eof):
    _, data, lengths = corpus[idx]
    padded, n = _window(data)
    want, got = _both_check(padded, _table(lengths), len(lengths), n, at_eof)
    _assert_equal(want, got, f"corpus {idx} at_eof={at_eof}")
    assert got["verdict"].any()


@pytest.mark.parametrize("idx", [0, 1, 2])
@pytest.mark.parametrize("at_eof", [True, False])
def test_check_window_full_pass_matches_jax(corpus, idx, at_eof):
    """Funnel off: the full pass at every offset, then the walk over its
    survivors; all seven outputs, masks included, equal the JAX ones."""
    _, data, lengths = corpus[idx]
    padded, n = _window(data)
    want, got = _both_check(padded, _table(lengths), len(lengths), n, at_eof,
                            funnel=False)
    _assert_equal(want, got, f"full pass, corpus {idx} at_eof={at_eof}")
    assert got["verdict"].any()
    on = ck.check_window(torch.from_numpy(padded),
                         torch.from_numpy(_table(lengths)), len(lengths), n,
                         at_eof)
    np.testing.assert_array_equal(on["verdict"].numpy(), got["verdict"])


@pytest.mark.parametrize("reads_to_check", [1, 3, 20])
@pytest.mark.parametrize("funnel", [True, False], ids=["funnel", "full"])
@pytest.mark.parametrize("at_eof", [True, False])
def test_check_window_reads_to_check_matches_jax(corpus, reads_to_check,
                                                 funnel, at_eof):
    """Chains of 1, 3 and 20 records, both check forms: all seven outputs
    equal the JAX ones."""
    _, data, lengths = corpus[1]
    padded, n = _window(data, w=128 << 10)
    want, got = _both_check(padded, _table(lengths), len(lengths), n, at_eof,
                            funnel, reads_to_check)
    _assert_equal(want, got, f"rtc={reads_to_check} funnel={funnel} "
                             f"at_eof={at_eof}")
    assert got["verdict"].any()


@pytest.mark.parametrize("reads_to_check", [1, 3])
@pytest.mark.parametrize("funnel", [True, False], ids=["funnel", "full"])
def test_count_window_reads_to_check_matches_jax(corpus, reads_to_check,
                                                 funnel):
    """The owned-span count at chains of 1 and 3 records (the JAX compile
    of a 20-record count alone takes about half a minute on a CPU)."""
    _, data, lengths = corpus[1]
    padded, n = _window(data, w=128 << 10)
    lens = _table(lengths)
    lo, own = 100, n - 1000
    want = jck.count_window(
        jnp.asarray(padded), jnp.asarray(lens), jnp.int32(len(lengths)),
        jnp.int32(n), jnp.bool_(False), jnp.int32(lo), jnp.int32(own),
        reads_to_check=reads_to_check, funnel=funnel)
    got = ck.count_window(torch.from_numpy(padded), torch.from_numpy(lens),
                          len(lengths), n, False, lo, own, reads_to_check,
                          funnel)
    for k in ("count", "esc_count", "survivors"):
        assert int(got[k]) == int(want[k]), k
    assert int(got["count"]) > 0


# A 60-byte period in which three offsets pass the full pass (given a
# contig table that accepts any index and position): 1/20 of the window
# survives, more than the lane capacity (w/32).
_FULL_SURVIVOR_PERIOD = bytes([
    65, 33, 169, 0, 0, 0, 65, 114, 4, 4, 2, 1, 2, 4, 126, 0, 65, 1, 65, 126,
    1, 255, 255, 126, 0, 0, 245, 2, 2, 65, 2, 255, 2, 65, 126, 0, 104, 126,
    65, 2, 33, 126, 126, 65, 0, 0, 33, 4, 240, 126, 2, 33, 34, 65, 33, 0, 1,
    1, 0, 2,
])


@pytest.mark.parametrize("at_eof", [True, False])
def test_full_pass_capacity_overflow_escapes_whole_window(at_eof):
    reps = -(-W // len(_FULL_SURVIVOR_PERIOD))
    soup = np.frombuffer(_FULL_SURVIVOR_PERIOD * reps, dtype=np.uint8)[:W]
    padded, n = _window(soup)
    lens = np.full(1024, 0x7FFFFFFF, dtype=np.int32)
    want, got = _both_check(padded, lens, 0x7FFFFFFF, n, at_eof,
                            funnel=False)
    _assert_equal(want, got, f"full-pass overflow at_eof={at_eof}")
    assert int(got["survivors"]) > max(W // 32, 4096)
    assert got["escaped"].all() and not got["verdict"].any()


def test_tpu_checker_matches_jax(corpus):
    """``TpuChecker.check_buffer`` (windows, halo ownership, host re-check)
    against the JAX TpuChecker on a buffer of several windows."""
    _, data, lengths = corpus[2]
    buf = np.asarray(data)
    want = jck.TpuChecker(lengths, window=1 << 14, halo=1 << 12).check_buffer(
        buf, at_eof=True)
    got = ck.TpuChecker(lengths, window=1 << 14, halo=1 << 12,
                        device="cpu").check_buffer(buf, at_eof=True)
    assert len(buf) > 3 * (1 << 14)
    for k in ("verdict", "fail_mask", "reads_parsed", "reads_before", "exact",
              "escaped"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert got.verdict.any()


def test_tpu_checker_matches_jax_on_bam2(bam2):
    """As ``tests/test_pallas.py`` drives it: 256 KiB of bam2 at a 256 KiB
    window and 64 KiB halo."""
    lens = np.array(contig_lengths(bam2).lengths_list(), dtype=np.int32)
    buf = flatten_file(bam2).data[: 256 << 10]
    want = jck.TpuChecker(lens, window=1 << 18, halo=1 << 16).check_buffer(
        buf, at_eof=True)
    got = ck.TpuChecker(lens, window=1 << 18, halo=1 << 16,
                        device="cpu").check_buffer(buf, at_eof=True)
    for k in ("verdict", "fail_mask", "reads_parsed", "reads_before"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


def test_tpu_checker_requires_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ck.TpuChecker(np.array([100], dtype=np.int32))


@pytest.mark.parametrize("idx", [0, 2])
@pytest.mark.parametrize("at_eof", [True, False])
@pytest.mark.parametrize("span", ["all", "inner"])
def test_count_window_matches_jax(corpus, idx, at_eof, span):
    _, data, lengths = corpus[idx]
    padded, n = _window(data)
    lo, own = (0, n) if span == "all" else (1000, n // 2)
    lens = _table(lengths)
    want = jck.count_window(
        jnp.asarray(padded), jnp.asarray(lens), jnp.int32(len(lengths)),
        jnp.int32(n), jnp.bool_(at_eof), jnp.int32(lo), jnp.int32(own),
        funnel=True)
    got = ck.count_window(torch.from_numpy(padded), torch.from_numpy(lens),
                          len(lengths), n, at_eof, lo, own)
    for k in ("count", "esc_count", "survivors"):
        assert int(got[k]) == int(want[k]), (k, int(got[k]), int(want[k]))


def _survivor_soup(w=W) -> np.ndarray:
    """A 36-byte pattern that passes the fixed-block prefilter at three of
    every 36 offsets (given a contig table that accepts any index and
    position): 1/12 of the window survives stage 0, more than the lane
    capacity (w/32)."""
    rec = bytearray(36)
    rec[0:4] = struct.pack("<i", 0x02000000)    # remaining
    rec[12:16] = bytes([2, 2, 2, 2])            # name_len, mapq, bin
    rec[20:24] = struct.pack("<i", 0x00C00000)  # seq_len
    reps = -(-w // 36)
    return np.frombuffer(bytes(rec) * reps, dtype=np.uint8)[:w].copy()


@pytest.mark.parametrize("at_eof", [True, False])
def test_capacity_overflow_escapes_whole_window(at_eof):
    padded, n = _window(_survivor_soup())
    lens = np.full(1024, 0x7FFFFFFF, dtype=np.int32)
    nc = 0x7FFFFFFF
    want, got = _both_check(padded, lens, nc, n, at_eof)
    _assert_equal(want, got, f"overflow at_eof={at_eof}")
    assert int(got["survivors"]) > max(W // 32, 4096)
    assert got["escaped"].all() and not got["verdict"].any()
    cnt = ck.count_window(torch.from_numpy(padded), torch.from_numpy(lens),
                          nc, n, at_eof, 10, n - 10)
    assert int(cnt["count"]) == 0 and int(cnt["esc_count"]) == n - 20


def _record(ref_id=0, pos=100, name=b"rd", seq_len=10, cigar=None,
            flag=0, next_ref=-1, next_pos=-1, mapq=30, bin_=4681):
    cigar = [(seq_len << 4) | 0] if cigar is None else cigar
    body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(name) + 1, mapq,
                       bin_, len(cigar), flag, seq_len, next_ref, next_pos, 0)
    body += name + b"\x00" + b"".join(struct.pack("<I", c) for c in cigar)
    body += b"\x11" * ((seq_len + 1) // 2) + b"\x1e" * seq_len
    return struct.pack("<i", len(body)) + body


def _quirk_window():
    """Records that pin the reference quirks (docs/design.md "Parity quirks
    preserved on purpose"); returns (bytes, {name: offset}, cut)."""
    recs = [
        ("plain", _record()),
        ("pos_eq_len", _record(pos=1000)),        # strict '>': passes
        ("plain2", _record(pos=10)),
        ("empty_seq", _record(seq_len=0, cigar=[(5 << 4) | 0])),
        ("pos_len_plus1", _record(pos=1001)),
        ("bad_op", _record(cigar=[(10 << 4) | 9])),
        ("plain3", _record(ref_id=1, pos=499)),
    ] + [(f"fill{i}", _record(pos=20 + i)) for i in range(12)]
    # Last: a bad op before the EOF cutoff, the cigar array cut short.
    tail = _record(cigar=[(1 << 4) | 12, 1 << 4, 1 << 4, 1 << 4], seq_len=4)
    offs, out = {}, b""
    for name, r in recs:
        offs[name] = len(out)
        out += r
    offs["bad_op_then_eof"] = len(out)
    out += tail
    cut = offs["bad_op_then_eof"] + 36 + 3 + 6    # mid-cigar
    return np.frombuffer(out, dtype=np.uint8), offs, cut


@pytest.mark.parametrize("at_eof", [True, False])
def test_reference_quirks_match_jax(at_eof):
    data, offs, cut = _quirk_window()
    padded, _ = _window(data[:cut], w=64 << 10)
    lens = _table([1000, 500])
    want, got = _both_check(padded, lens, 2, cut, at_eof)
    _assert_equal(want, got, f"quirks at_eof={at_eof}")
    fm = got["fail_mask"]
    assert not fm[offs["pos_eq_len"]] & BIT["tooLargeReadPos"]
    assert fm[offs["pos_len_plus1"]] & BIT["tooLargeReadPos"]
    # Swapped on purpose: an empty seq reports emptyMappedCigar.
    assert fm[offs["empty_seq"]] & BIT["emptyMappedCigar"]
    assert not fm[offs["empty_seq"]] & BIT["emptyMappedSeq"]
    assert fm[offs["bad_op"]] & BIT["invalidCigarOp"]
    last = fm[offs["bad_op_then_eof"]]
    assert last & BIT["invalidCigarOp"]
    assert not last & BIT["tooFewBytesForCigarOps"]


@pytest.mark.parametrize("which", ["corpus0", "corpus2", "soup", "quirks"])
def test_prefilter_is_superset_of_full_pass(corpus, which):
    """Every bit the port's prefilter sets, the JAX full pass sets too, so
    full-pass survivors always pass stage 0."""
    lengths = corpus[0][2]
    if which == "soup":
        data = np.random.default_rng(11).integers(0, 256, W, dtype=np.uint8)
    elif which == "quirks":
        data, _, _ = _quirk_window()
        lengths = np.array([1000, 500], dtype=np.int32)
    else:
        data = corpus[int(which[-1])][1]
        lengths = corpus[int(which[-1])][2]
    padded, n = _window(data)
    lens = _table(lengths)
    pre = ck._prefilter_flags(torch.from_numpy(padded), torch.from_numpy(lens),
                              len(lengths), n).numpy()
    full = np.asarray(jck._compute_flags(
        jnp.asarray(padded), jnp.asarray(lens), jnp.int32(len(lengths)),
        jnp.int32(n)))
    assert not (pre & ~full).any()
    assert not ((full == 0) & (pre != 0)).any()


@pytest.fixture(scope="module")
def raw_groups(tmp_path_factory):
    """A small BAM cut into two window groups of staged raw payloads."""
    p = tmp_path_factory.mktemp("torch_raw") / "raw.bam"
    random_bam(p, seed=41, read_len=(10, 200), n_records=(200, 300),
               block_payload=(3000, 3001))
    metas = list(jax_blocks(p))
    half = len(metas) // 2
    with jax_open(p) as ch:
        groups = [jax_stage(ch, g) + (g,) for g in (metas[:half],
                                                    metas[half:])]
    lens = np.array(contig_lengths(p).lengths_list(), dtype=np.int32)
    from spark_bam_tpu.bam.header import read_header

    return groups, lens, read_header(p).uncompressed_size


def test_count_window_raw_matches_jax(raw_groups):
    """The device-resident window (tokenize → resolve → assemble → count,
    halo carry threaded through two windows) against the JAX package's."""
    groups, lengths, header_end = raw_groups
    halo = 8 << 10
    window = 64 << 10
    lens = _table(lengths)
    j_carry = jnp.zeros(halo, jnp.uint8)
    t_carry = torch.zeros(halo, dtype=torch.uint8)
    carry_len = base = 0
    for gi, (staged, clens, metas) in enumerate(groups):
        usizes = np.array([m.uncompressed_size for m in metas])
        exp = np.zeros(len(clens), dtype=np.int32)
        exp[: len(usizes)] = usizes
        n = carry_len + int(usizes.sum())
        at_eof = gi == len(groups) - 1
        own = n if at_eof else n - halo
        lo = min(max(header_end - base, 0), own)
        assert n <= window
        want = jck.count_window_raw(
            jnp.asarray(staged), jnp.asarray(clens), jnp.asarray(exp),
            j_carry, jnp.asarray(lens), jnp.int32(len(lengths)),
            jnp.int32(carry_len), jnp.int32(n), jnp.bool_(at_eof),
            jnp.int32(lo), jnp.int32(own), window=window, halo=halo,
            funnel=True)
        got = ck.count_window_raw(
            torch.from_numpy(staged), torch.from_numpy(clens),
            torch.from_numpy(exp), t_carry, torch.from_numpy(lens),
            len(lengths), carry_len, n, at_eof, lo, own, window=window,
            halo=halo)
        for k in ("count", "esc_count", "survivors", "rounds", "tok_ok"):
            assert int(got[k]) == int(want[k]), (gi, k)
        np.testing.assert_array_equal(got["carry"].numpy(),
                                      np.asarray(want["carry"]))
        assert bool(got["tok_ok"]) and int(got["count"]) > 0
        j_carry, t_carry = want["carry"], got["carry"]
        carry_len, base = n - own, base + own
