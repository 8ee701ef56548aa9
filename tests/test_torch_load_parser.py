"""The port's record parser against the JAX package's.

``parse_records`` (every column, on padded windows with random starts,
-1 padding, starts near and past the buffer end, and rows of 0, 1, 64, 65,
66 and 300 cigar ops), ``parse_flat_records`` with its host fix-up of long
cigars, the lazy ``ReadBatch`` payloads, and the host reference span, on
the load edge set (``benchmarks/load_cases.py``), ``random_bam`` windows
and random bytes. The port runs on the CPU; every comparison is exact.

The JAX parse's host fix-up writes into ``np.asarray`` views of jax
arrays, which this JAX hands out read-only, so any row past the cigar cap
raises ``ValueError`` there. ``jax_writable`` gives the JAX parser
writable copies of its own outputs so the fix-up runs as written.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.record import BamRecord
from spark_bam_tpu.bgzf.flat import flatten_file
from spark_bam_tpu.tpu import parser as jp
from spark_bam_tpu_torch.bam.record import reference_span
from spark_bam_tpu_torch.benchmarks import load_cases as lc
from spark_bam_tpu_torch.tpu import parser as tp
from tests.bam_factories import random_bam


@pytest.fixture
def jax_writable(monkeypatch):
    orig = jp.parse_records

    def writable(*a, **kw):
        return {k: np.array(v) for k, v in orig(*a, **kw).items()}

    monkeypatch.setattr(jp, "parse_records", writable)


def _edge_buffer(seed=0):
    recs = lc.edge_records(seed)
    names = list(recs)
    offs = np.cumsum([0] + [len(recs[k]) for k in names])[:-1]
    return (np.frombuffer(b"".join(recs.values()), dtype=np.uint8), names,
            offs.astype(np.int64))


def _parse_both(buf, starts, pad=1024):
    padded = np.zeros(len(buf) + pad, dtype=np.uint8)
    padded[: len(buf)] = buf
    st = np.asarray(starts, dtype=np.int32)
    want = jp.parse_records(jnp.asarray(padded), jnp.asarray(st))
    got = tp.parse_records(torch.from_numpy(padded), torch.from_numpy(st))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _assert_columns_equal(got: dict, want: dict, label=""):
    assert list(got) == list(want), label
    for k in want:
        assert got[k].dtype == want[k].dtype, (label, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} {k}")


def test_parse_records_edge_set_matches_jax():
    buf, names, offs = _edge_buffer()
    rng = np.random.default_rng(1)
    n = len(buf)
    starts = np.concatenate([
        offs, [-1, -1, n - 1, n - 4, n - 36, n, n + 500],
        rng.integers(0, n, 64),
    ])
    want, got = _parse_both(buf, starts)
    _assert_columns_equal(got, want, "edge set")
    cig = dict(zip(names, got["n_cigar"][: len(names)]))
    assert [cig[f"cigar_{k}"] for k in (1, 64, 65, 300)] == [1, 64, 65, 300]
    assert cig["unmapped_unplaced"] == 0
    assert not got["valid"][len(offs): len(offs) + 2].any()
    exact = dict(zip(names, got["span_exact"][: len(names)]))
    assert exact["cigar_64"] and not exact["cigar_65"]


def test_parse_records_span_wraps_as_int32():
    """64 ops of 2^28 - 1 reference bases: the device sum wraps in both."""
    buf, names, offs = _edge_buffer()
    i = names.index("cigar_64_overflow")
    want, got = _parse_both(buf, offs[i: i + 1])
    _assert_columns_equal(got, want, "overflow")
    full = 63 * ((1 << 28) - 1)
    assert full > 2**31 - 1
    assert int(got["ref_span"][0]) == ((full + 2**31) % 2**32) - 2**31


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_records_random_bam_windows_match_jax(tmp_path, seed):
    p = tmp_path / "r.bam"
    random_bam(p, seed=600 + seed, read_len=(10, 400), n_records=(200, 300))
    data = np.asarray(flatten_file(p).data)
    rng = np.random.default_rng(seed)
    for lo in (0, len(data) // 3):
        win = data[lo: lo + (64 << 10)]
        starts = np.concatenate([rng.integers(0, len(win), 300),
                                 [len(win) - 2, 0, -1]])
        want, got = _parse_both(win, starts, pad=300_000)
        _assert_columns_equal(got, want, f"window at {lo}")


def test_parse_records_random_bytes_match_jax():
    rng = np.random.default_rng(5)
    soup = rng.integers(0, 256, 20_000, dtype=np.uint8)
    soup[rng.integers(0, len(soup), 2000)] = 0x88   # cigar-op-like words
    starts = rng.integers(-3, len(soup) + 10, 500)
    want, got = _parse_both(soup, starts, pad=64)
    _assert_columns_equal(got, want, "random bytes")


def _batches_equal(got, want):
    _assert_columns_equal(got.columns, want.columns)
    np.testing.assert_array_equal(got.starts, want.starts)
    assert got.starts.dtype == want.starts.dtype
    np.testing.assert_array_equal(got.buf, want.buf)


def test_parse_flat_records_fixes_up_long_cigars(jax_writable):
    buf, names, offs = _edge_buffer()
    ok = [i for i, k in enumerate(names) if k != "cigar_64_overflow"]
    starts = offs[ok]
    want = jp.parse_flat_records(buf, starts)
    got = tp.parse_flat_records(buf, starts, device="cpu")
    _batches_equal(got, want)
    assert got.columns["span_exact"].all()
    for j, i in enumerate(ok):
        rec, _ = BamRecord.decode(buf, int(offs[i]))
        assert int(got.columns["ref_span"][j]) == rec.reference_span()


def test_fix_up_span_past_int32_raises_as_reference(jax_writable):
    """More than 64 ops whose span passes 2^31 - 1: both hosts' fix-ups
    store the exact span into the int32 column, which overflows."""
    rec = lc.encode_record(cigar=[((1 << 28) - 1, 0)] * 70, seq_len=0,
                           flag=0x4)
    buf = np.frombuffer(rec, dtype=np.uint8)
    with pytest.raises(OverflowError):
        jp.parse_flat_records(buf, np.array([0]))
    with pytest.raises(OverflowError):
        tp.parse_flat_records(buf, np.array([0]), device="cpu")


def test_reference_span_matches_codec():
    buf, names, offs = _edge_buffer(seed=3)
    for name, off in zip(names, offs):
        rec, _ = BamRecord.decode(buf, int(off))
        assert reference_span(buf, int(off)) == rec.reference_span(), name


def test_reference_span_refuses_a_cut_cigar():
    rec = lc.encode_record(cigar=[(5, 0)] * 10)
    with pytest.raises(struct.error):
        reference_span(np.frombuffer(rec[:60], dtype=np.uint8), 0)


def test_read_batch_payloads_match_jax(jax_writable):
    buf, names, offs = _edge_buffer(seed=4)
    want = jp.parse_flat_records(buf, offs)
    got = tp.parse_flat_records(buf, offs, device="cpu")
    assert len(got) == len(want) == len(names)
    for i in range(len(names)):
        assert got.name(i) == want.name(i)
        assert got.seq(i) == want.seq(i)
        assert got.qual(i) == want.qual(i)
    for k in ("pos", "flag", "ref_span"):
        np.testing.assert_array_equal(got[k], want[k])


def test_parse_window_equals_parse_flat_records():
    """The streaming path's parse on a device-window-shaped tensor (zeros
    past the bytes) gives the host entry's batch."""
    buf, _, offs = _edge_buffer(seed=5)
    padded = torch.zeros((1 << 17) + 263_168, dtype=torch.uint8)
    padded[: len(buf)] = torch.from_numpy(buf.copy())
    got = tp.parse_window(padded, buf, offs)
    want = tp.parse_flat_records(buf, offs, device="cpu")
    _batches_equal(got, want)


def test_parse_flat_records_requires_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf, _, offs = _edge_buffer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.parse_flat_records(buf, offs)


def test_parse_records_in_chunks_matches_jax(monkeypatch):
    """Row chunks (here of 7 rows) give the one-pass columns."""
    buf, _, offs = _edge_buffer(seed=6)
    starts = np.concatenate([offs, [-1, len(buf) - 3]])
    want, _ = _parse_both(buf, starts)
    monkeypatch.setattr(tp, "PARSE_CHUNK", 7)
    _, got = _parse_both(buf, starts)
    _assert_columns_equal(got, want, "chunks of 7")
