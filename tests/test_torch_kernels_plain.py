"""The port's plain kernel versions against the JAX package.

Same inputs, made with numpy, go through the JAX function (the Pallas
kernels in interpret mode, as the JAX package's own tests run them on the
CPU) and through the port's plain PyTorch version, which is what the port's
kernel wrappers run for CPU tensors. Every comparison is exact: bytes,
flag masks, lengths, verdict flags and round counts must be equal.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.header import contig_lengths
from spark_bam_tpu.bgzf.flat import flatten_file
from spark_bam_tpu.tpu import checker as jck
from spark_bam_tpu.tpu.inflate import resolve_lz77
from spark_bam_tpu.tpu.pallas_kernels import (
    prefilter_check_flags as pallas_prefilter,
)
from spark_bam_tpu.tpu.tokenize_device import tokenize_planes
from spark_bam_tpu_torch.benchmarks import resolve_flag_cases
from spark_bam_tpu_torch.benchmarks.deflate_cases import (
    EXPECT_OUT_LEN,
    EXPECT_REJECT,
    edge_cases,
    mutants,
    stage,
)
from spark_bam_tpu_torch.tpu import kernels as K
from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = 256 << 10  # a multiple of the Pallas tile (32 KiB)


# ------------------------------------------------------------- prefilter


def _overflow_window(rng) -> np.ndarray:
    """Random bytes with a record-shaped header every 64 bytes whose fields
    sit on the edges: int32-wrapping implied sizes (seq_len near ±2^31,
    n_cigar 0xFFFF, name_len 255), negative seq_len for truncating division,
    contig indices and positions around the table's bounds."""
    buf = rng.integers(0, 256, size=W, dtype=np.uint8)
    seqs = [0x7FFFFFFF, 0x7FFFFFFE, -1, -2, -3, -(1 << 31), 0, 150]
    idxs = [-2, -1, 0, 1, 2, 5]
    poss = [-2, -1, 0, 10_000_000, 10_000_001, 5_000_000, 0x7FFFFFFF]
    for k, off in enumerate(range(0, W - 64, 64)):
        fields = struct.pack(
            "<iiiBBHHHiii",
            int(rng.integers(-(1 << 31), 1 << 31)),
            idxs[k % len(idxs)], poss[k % len(poss)],
            (0, 1, 2, 255)[k % 4], 0, 0,
            0xFFFF if k % 3 else int(rng.integers(0, 1 << 16)), 0,
            seqs[k % len(seqs)], idxs[(k // 3) % len(idxs)],
            poss[(k // 5) % len(poss)],
        )
        buf[off: off + len(fields)] = np.frombuffer(fields, dtype=np.uint8)
    return buf


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """name → (padded (W + PAD,) u8, lengths (1024,) i32, num_contigs)."""
    tmp = tmp_path_factory.mktemp("torch_prefilter")
    rng = np.random.default_rng(17)
    out = {}
    for i, kw in enumerate((dict(), dict(mapped_rate=0.3, dup_rate=0.2))):
        p = tmp / f"w{i}.bam"
        random_bam(p, seed=200 + i, **kw)
        out[f"bam{i}"] = flatten_file(p).data[:W]
    lens_src = np.array(contig_lengths(p).lengths_list(), dtype=np.int32)
    out["soup"] = rng.integers(0, 256, size=W, dtype=np.uint8)
    out["overflow"] = _overflow_window(rng)
    lens = np.zeros(1024, dtype=np.int32)
    lens[: len(lens_src)] = lens_src
    res = {}
    for name, data in out.items():
        padded = np.zeros(W + K.PAD, dtype=np.uint8)
        padded[: len(data)] = data
        res[name] = (padded, lens, len(lens_src), len(data))
    return res


@pytest.mark.parametrize("name", ["bam0", "bam1", "soup", "overflow"])
@pytest.mark.parametrize("short", [False, True], ids=["n_full", "n_short"])
def test_prefilter_plain_matches_jax(windows, name, short):
    padded, lens, nc, n = windows[name]
    if short:
        n = n - 1000   # the tooFewFixedBlockBytes overwrite inside the data
    want = np.asarray(jck._prefilter_flags(
        jnp.asarray(padded), jnp.asarray(lens), jnp.int32(nc), jnp.int32(n)))
    want_pallas = np.asarray(pallas_prefilter(
        jnp.asarray(padded), jnp.asarray(lens), jnp.int32(nc).reshape(1),
        jnp.int32(n).reshape(1), interpret=True))
    got = K.prefilter_check_flags(
        torch.from_numpy(padded), torch.from_numpy(lens), nc, n)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_pallas)
    assert got.dtype == np.int32 and got.shape == (W,)


# ------------------------------------------------------------- LZ77 resolve


def _token_rows(kind: str, rng) -> tuple[np.ndarray, np.ndarray]:
    lit = rng.integers(0, 256, size=(4, STRIDE), dtype=np.uint8)
    dist = np.zeros((4, STRIDE), dtype=np.uint16)
    i = np.arange(STRIDE)
    if kind in ("rle", "mixed"):
        dist[0, 1:] = 1                      # one 65535-long chain: 16 rounds
    if kind in ("random", "mixed"):
        for r in range(1, 4):
            take = rng.random(STRIDE) < 0.6
            d = (rng.random(STRIDE) * np.minimum(i, 32768)).astype(np.int64)
            dist[r] = np.where(take & (d > 0), d, 0)
    return lit, dist


@pytest.mark.parametrize("seed,kind", [(1, "literals"), (2, "rle"),
                                       (3, "random"), (4, "mixed")])
def test_resolve_plain_matches_jax(seed, kind):
    lit, dist = _token_rows(kind, np.random.default_rng(seed))
    want, want_rounds = resolve_lz77(jnp.asarray(lit), jnp.asarray(dist))
    got, rounds = K.lz77_resolve(torch.from_numpy(lit), torch.from_numpy(dist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(rounds) == int(want_rounds)
    if kind in ("rle", "mixed"):
        assert int(rounds) == 16


@pytest.fixture(scope="module")
def edge_rows():
    return resolve_flag_cases.token_rows(0)


@pytest.mark.parametrize("name", list(resolve_flag_cases.token_rows(0)))
def test_resolve_plain_matches_jax_on_edge_rows(edge_rows, name):
    """The shared token-row edge set, one row at a time: bytes and rounds."""
    lit, dist = (a[None] for a in edge_rows[name])
    want, want_rounds = resolve_lz77(jnp.asarray(lit), jnp.asarray(dist))
    got, rounds = K.lz77_resolve(torch.from_numpy(lit), torch.from_numpy(dist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(rounds) == int(want_rounds) <= 16


# ------------------------------------------------------------- tokenizer


#: Token batch: every edge stream, seeded mutants, then zero-length pads.
TOKEN_ROWS = 128
TOKEN_MUTANTS = 90


@pytest.fixture(scope="module")
def token_rows():
    """The shared edge streams plus seeded mutants of them (truncations keep
    their cut bytes as slack), staged in one (128, 16384) batch so the JAX
    bit-reader compiles once."""
    cases = edge_cases()
    cases.update(mutants(cases, TOKEN_MUTANTS, seed=9))
    assert len(cases) < TOKEN_ROWS, "the batch must keep padding rows"
    staged, clens, names = stage(cases, 16384, TOKEN_ROWS)
    want = [np.asarray(a) for a in tokenize_planes(jnp.asarray(staged),
                                                   jnp.asarray(clens))]
    got = [a.numpy() for a in K.tokenize(torch.from_numpy(staged),
                                         torch.from_numpy(clens))]
    return names, want, got


@pytest.mark.parametrize("row", range(TOKEN_ROWS))
def test_tokenize_plain_matches_jax(token_rows, row):
    names, want, got = token_rows
    for w, g, what in zip(want, got, ("lit", "dist", "out_len", "ok")):
        np.testing.assert_array_equal(
            g[row], w[row],
            err_msg=f"{what} differs on row {row} "
                    f"({names[row] if row < len(names) else 'batch pad'})")
    if row >= len(names):                     # batch pad: clen == 0
        assert not got[3][row] and got[2][row] == 0
    elif names[row] in EXPECT_REJECT:
        assert not got[3][row], names[row]
    elif not names[row].startswith("mutant_"):
        assert got[3][row], names[row]
    if row < len(names) and names[row] in EXPECT_OUT_LEN:
        assert got[2][row] == EXPECT_OUT_LEN[names[row]], names[row]


def test_tokenize_partial_writes_on_rejection(token_rows):
    """Rejected rows keep what was written before the failing symbol: the
    stored short chunk leaves exactly one 512-byte chunk, the stream that
    outgrows 64 KiB stops below the row width, and a match through a
    missing distance code leaves the literals before it."""
    names, _, got = token_rows
    short = names.index("stored_short_chunk")
    assert got[2][short] == 512
    big = names.index("output_past_64k")
    assert 0 < got[2][big] <= STRIDE
    miss = names.index("zero_dist_code_match")
    assert got[2][miss] == 1 and got[0][miss][0] == ord("x")
    assert not got[1][miss].any()
