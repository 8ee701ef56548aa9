"""The port's plain kernel versions against the JAX package.

Same inputs, made with numpy, go through the JAX function (the Pallas
kernels in interpret mode, as the JAX package's own tests run them on the
CPU) and through the port's plain PyTorch version, which is what the port's
kernel wrappers run for CPU tensors. Every comparison is exact: bytes,
flag masks, lengths, verdict flags and round counts must be equal.
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.header import contig_lengths
from spark_bam_tpu.bgzf.flat import flatten_file
from spark_bam_tpu.tools.fuzz_decode import _mutate, _Rng
from spark_bam_tpu.tpu import checker as jck
from spark_bam_tpu.tpu.inflate import resolve_lz77
from spark_bam_tpu.tpu.pallas_kernels import (
    prefilter_check_flags as pallas_prefilter,
)
from spark_bam_tpu.tpu.tokenize_device import tokenize_planes
from spark_bam_tpu_torch.tpu import kernels as K
from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE
from tests.bam_factories import random_bam

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
        torch.from_numpy(padded), torch.from_numpy(lens), nc, n).numpy()
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


# ------------------------------------------------------------- tokenizer


def _deflate(data: bytes, level: int = 6,
             strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(data) + co.flush()


class _BitWriter:
    """LSB-first DEFLATE bit emitter for hand-built streams."""

    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int):
        self.bits += [(value >> i) & 1 for i in range(n)]

    def put_code(self, code: int, n: int):      # Huffman codes: MSB first
        self.bits += [(code >> i) & 1 for i in reversed(range(n))]

    def align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def bytes(self) -> bytes:
        self.align()
        return bytes(
            sum(b << j for j, b in enumerate(self.bits[i: i + 8]))
            for i in range(0, len(self.bits), 8)
        )


def _fixed_lit_code(sym: int) -> tuple[int, int]:
    if sym < 144:
        return 0x30 + sym, 8
    if sym < 256:
        return 0x190 + (sym - 144), 9
    if sym < 280:
        return sym - 256, 7
    return 0xC0 + (sym - 280), 8


def _fixed_stream(syms, tail=b"\x00" * 4, final=True) -> bytes:
    w = _BitWriter()
    w.put(int(final), 1)
    w.put(1, 2)
    for s in syms:
        if isinstance(s, tuple):
            w.put_code(*s)
        else:
            w.put_code(*_fixed_lit_code(s))
    return w.bytes() + tail


def _hand_built() -> dict[str, bytes]:
    rng = np.random.default_rng(3)
    fox = b"the quick brown fox " * 200
    skew = bytes(rng.choice([32, 101, 116, 97, 10, 200], size=20_000,
                            p=[.3, .25, .2, .15, .05, .05]).astype(np.uint8))
    streams = {
        "fox_default": _deflate(fox),
        "random_stored": _deflate(rng.integers(0, 256, 8_000,
                                               dtype=np.uint8).tobytes()),
        "rle_z": _deflate(b"z" * 50_000),
        "tail": _deflate(b"tail"),
        "empty": _deflate(b""),
        "level0_stored": _deflate(fox, level=0),
        "fixed_level9": _deflate(fox, level=9, strategy=zlib.Z_FIXED),
        "cl_runs_dynamic": _deflate(skew, level=9),
        "sym286": _fixed_stream([ord("A"), 286]),
        "sym287": _fixed_stream([ord("A"), 287]),
        "dist_before_start": _fixed_stream([ord("A"), 257, (3, 5), 256]),
        "garbage": b"\x07" + b"\x00" * 8,
        "truncated": _deflate(fox)[:-5],
        "output_past_64k": _deflate(b"z" * 70_000),
    }
    # A fixed block, then an empty stored final block.
    w = _BitWriter()
    w.put(0, 1)
    w.put(1, 2)
    for ch in b"abc":
        w.put_code(*_fixed_lit_code(ch))
    w.put_code(*_fixed_lit_code(256))
    w.put(1, 1)
    w.put(0, 2)
    streams["zero_len_final_stored"] = w.bytes() + b"\x00\x00\xff\xff"
    # Stored block whose NLEN is not ~LEN.
    streams["stored_nlen_mismatch"] = b"\x01" + struct.pack("<HH", 5, 5) + b"x" * 5
    # Stored block claiming 2000 bytes with 900 present: the first 512-byte
    # chunk lands, the second does not fit.
    streams["stored_short_chunk"] = (b"\x01" + struct.pack("<HH", 2000, 2000 ^ 0xFFFF)
                                     + rng.integers(0, 256, 900, dtype=np.uint8).tobytes())
    # BTYPE = 3 is reserved.
    w = _BitWriter()
    w.put(1, 1)
    w.put(3, 2)
    streams["btype3"] = w.bytes() + b"\x00" * 4
    # Dynamic header with HLIT = 287 (> 286).
    w = _BitWriter()
    w.put(1, 1)
    w.put(2, 2)
    w.put(30, 5)
    w.put(0, 5)
    w.put(0, 4)
    streams["hlit_too_big"] = w.bytes() + b"\x00" * 8
    return streams


@pytest.fixture(scope="module")
def token_rows():
    """Hand-built edge streams plus seeded mutants of four bases, staged in
    one (64, 16384) batch so the JAX bit-reader compiles once."""
    streams = _hand_built()
    rng = np.random.default_rng(9)
    bases = {
        "fox": streams["fox_default"], "stored": streams["random_stored"],
        "rle": streams["rle_z"], "dynamic": streams["cl_runs_dynamic"],
    }
    for bi, (name, comp) in enumerate(bases.items()):
        for i in range(11):
            r = _Rng(1000 * bi + i + int(rng.integers(0, 7)))
            streams[f"mutant_{name}_{i}"] = _mutate(comp, r.below(len(comp)), r)
    names = list(streams)
    assert len(names) <= 64
    staged = np.zeros((64, 16384), dtype=np.uint8)
    clens = np.zeros(64, dtype=np.int32)
    for i, name in enumerate(names):
        c = streams[name]
        staged[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
        clens[i] = len(c)
    want = [np.asarray(a) for a in tokenize_planes(jnp.asarray(staged),
                                                   jnp.asarray(clens))]
    got = [a.numpy() for a in K.tokenize(torch.from_numpy(staged),
                                         torch.from_numpy(clens))]
    return names, want, got


_EXPECT_REJECT = {"sym286", "sym287", "dist_before_start", "garbage",
                  "truncated", "output_past_64k", "stored_nlen_mismatch",
                  "stored_short_chunk", "btype3", "hlit_too_big"}


@pytest.mark.parametrize("row", range(64))
def test_tokenize_plain_matches_jax(token_rows, row):
    names, want, got = token_rows
    for w, g, what in zip(want, got, ("lit", "dist", "out_len", "ok")):
        np.testing.assert_array_equal(
            g[row], w[row],
            err_msg=f"{what} differs on row {row} "
                    f"({names[row] if row < len(names) else 'batch pad'})")
    if row >= len(names):                     # batch pad: clen == 0
        assert not got[3][row] and got[2][row] == 0
    elif names[row] in _EXPECT_REJECT:
        assert not got[3][row], names[row]
    elif not names[row].startswith("mutant_"):
        assert got[3][row], names[row]


def test_tokenize_partial_writes_on_rejection(token_rows):
    """Rejected rows keep what was written before the failing symbol: the
    stored short chunk leaves exactly one 512-byte chunk, and the stream
    that outgrows 64 KiB stops below the row width."""
    names, _, got = token_rows
    short = names.index("stored_short_chunk")
    assert got[2][short] == 512
    big = names.index("output_past_64k")
    assert 0 < got[2][big] <= STRIDE
