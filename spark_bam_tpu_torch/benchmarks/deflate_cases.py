"""Raw-DEFLATE edge streams and seeded mutants for the tokenizer.

One set, shared by the CPU tests (the plain tokenizer against the JAX
package), the card tests and ``chip_smoke.py`` (the CUDA kernel against the
plain tokenizer). Every case is ``(row bytes, clen)``: the decoder sees
``clen`` payload bytes, and whatever follows them in the row is staging
slack that must never change its verdict. Streams come from zlib or are
built bit by bit here (``dynamic_stream`` writes a dynamic block with code
lengths chosen by the caller, so codes can be incomplete, reach 15 bits or
miss on purpose).

    cases = edge_cases()
    staged, clens, names = stage(cases | mutants(cases, 200, seed=1), 16384)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# RFC 1951 3.2.5.
_LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
             51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
_LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
              4, 4, 4, 5, 5, 5, 5, 0)
_DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
              385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
              16385, 24577)
_DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
               9, 10, 10, 11, 11, 12, 12, 13, 13)
_CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)

#: Cases the plain tokenizer must reject (``ok`` False).
EXPECT_REJECT = frozenset({
    "sym286", "sym287", "dist_before_start", "garbage", "truncated",
    "output_past_64k", "stored_nlen_mismatch", "stored_short_chunk", "btype3",
    "hlit_too_big", "past_64k_by_one", "incomplete_long_miss",
    "incomplete_root_miss", "one_dist_code_miss", "zero_dist_code_match",
    "truncated_mid_15bit",
})
#: ``out_len`` the plain tokenizer must give, where the case pins it.
EXPECT_OUT_LEN = {
    "stored_short_chunk": 512, "exact_64k": 65536,
    "incomplete_long_miss": 2, "incomplete_root_miss": 2,
    "one_dist_code_miss": 3, "zero_dist_code_match": 1,
    "zero_dist_code_unused": 3, "one_dist_code": 9, "dist_codes_15bit": 316,
}


def deflate(data: bytes, level: int = 6,
            strategy: int = zlib.Z_DEFAULT_STRATEGY, mem_level: int = 8) -> bytes:
    """Raw DEFLATE (no zlib header), as a BGZF member holds it."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15, mem_level, strategy)
    return co.compress(data) + co.flush()


class BitWriter:
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


def fixed_lit_code(sym: int) -> tuple[int, int]:
    """(code, length) of a litlen symbol in the fixed code."""
    if sym < 144:
        return 0x30 + sym, 8
    if sym < 256:
        return 0x190 + (sym - 144), 9
    if sym < 280:
        return sym - 256, 7
    return 0xC0 + (sym - 280), 8


def fixed_stream(syms, tail=b"\x00" * 4, final=True) -> bytes:
    """A fixed block of litlen symbols; a tuple is a raw (code, length)."""
    w = BitWriter()
    w.put(int(final), 1)
    w.put(1, 2)
    for s in syms:
        if isinstance(s, tuple):
            w.put_code(*s)
        else:
            w.put_code(*fixed_lit_code(s))
    return w.bytes() + tail


def canonical(lens) -> list[int | None]:
    """Canonical codes (RFC 1951 3.2.2) of the lengths; None where 0."""
    count = [0] * 16
    for ln in lens:
        count[ln] += 1
    count[0] = 0
    nxt, code = [0] * 16, 0
    for ln in range(1, 16):
        code = (code + count[ln - 1]) << 1
        nxt[ln] = code
    out = []
    for ln in lens:
        out.append(nxt[ln] if ln else None)
        if ln:
            nxt[ln] += 1
    return out


def dynamic_stream(lit_lens, dist_lens, body, final=True,
                   tail=b"\x00" * 4) -> tuple[bytes, list[int]]:
    """One dynamic block with the given code lengths, then ``tail``.

    The code-length code gives symbols 0-15 four bits each (no runs).
    ``body`` items: an int (a litlen symbol), ``("match", length,
    distance)``, or ``("raw", code, nbits)`` (bits written MSB first, for
    patterns no symbol owns). Returns the bytes and the bit offset at which
    each body item starts."""
    lit_codes, dist_codes = canonical(lit_lens), canonical(dist_lens)
    w = BitWriter()
    w.put(int(final), 1)
    w.put(2, 2)
    w.put(len(lit_lens) - 257, 5)
    w.put(len(dist_lens) - 1, 5)
    w.put(19 - 4, 4)
    for sym in _CL_ORDER:
        w.put(4 if sym < 16 else 0, 3)
    for ln in list(lit_lens) + list(dist_lens):
        w.put_code(ln, 4)
    starts = []
    for item in body:
        starts.append(len(w.bits))
        if isinstance(item, int):
            w.put_code(lit_codes[item], lit_lens[item])
        elif item[0] == "raw":
            w.put_code(item[1], item[2])
        else:
            _, length, distance = item
            ls = max(i for i, b in enumerate(_LEN_BASE) if b <= length)
            w.put_code(lit_codes[257 + ls], lit_lens[257 + ls])
            w.put(length - _LEN_BASE[ls], _LEN_EXTRA[ls])
            ds = max(i for i, b in enumerate(_DIST_BASE) if b <= distance)
            w.put_code(dist_codes[ds], dist_lens[ds])
            w.put(distance - _DIST_BASE[ds], _DIST_EXTRA[ds])
    return w.bytes() + tail, starts


def _hand_dynamic() -> dict[str, bytes | tuple[bytes, int]]:
    out = {}
    # A complete litlen code reaching 15 bits: symbols 0..12 take 1..13
    # bits, symbols 13, 14, EOB and 257 (length 3) take 15; every one used.
    lit = [0] * 258
    for s in range(13):
        lit[s] = s + 1
    for s in (13, 14, 256, 257):
        lit[s] = 15
    body = list(range(15)) + [("match", 3, 1), 14, 13, 256]
    comp, starts = dynamic_stream(lit, [1], body)
    out["codes_15bit"] = comp
    # The same stream cut inside its last 15-bit literal (symbol 13), with
    # the rest of the stream left behind as slack.
    start = starts[-2]
    out["truncated_mid_15bit"] = (comp, (start + 14) // 8)
    # Incomplete litlen code: 'a' 1 bit, EOB 2 bits, 'b' 15 bits. The next
    # 15-bit pattern shares 'b''s root prefix but no symbol owns it; a
    # 3-bit pattern past every code misses in the root.
    lit = [0] * 257
    lit[ord("a")], lit[256], lit[ord("b")] = 1, 2, 15
    b_code = canonical(lit)[ord("b")]
    out["incomplete_long_miss"] = dynamic_stream(
        lit, [1], [ord("a"), ord("b"), ("raw", b_code + 1, 15), 256])[0]
    out["incomplete_root_miss"] = dynamic_stream(
        lit, [1], [ord("a"), ord("b"), ("raw", 0b111, 3), 256])[0]
    out["incomplete_ok"] = dynamic_stream(
        lit, [1], [ord("a"), ord("b"), ord("b"), ord("a"), 256])[0]
    # One distance code, of length 1 (incomplete, legal): a match through
    # it decodes; the pattern it leaves free fails.
    lit = [0] * 258
    for s in b"xyz":
        lit[s] = 3
    lit[256], lit[257] = 3, 3
    body = [ord("x"), ord("y"), ord("z"), ("match", 3, 1), ("match", 3, 1)]
    out["one_dist_code"] = dynamic_stream(lit, [1], body + [256])[0]
    lit_codes = canonical(lit)
    out["one_dist_code_miss"] = dynamic_stream(
        lit, [1], body[:3] + [("raw", lit_codes[257], 3), ("raw", 1, 1),
                              256])[0]
    # HDIST = 1 with length 0: no distance code at all. Legal until a match
    # needs one.
    out["zero_dist_code_unused"] = dynamic_stream(
        lit, [0], [ord("x"), ord("y"), ord("z"), 256])[0]
    out["zero_dist_code_match"] = dynamic_stream(
        lit, [0], [ord("x"), ("raw", lit_codes[257], 3), ("raw", 0, 1),
                   256])[0]
    # A complete distance code reaching 15 bits (symbols 0..12 take 1..13
    # bits, 13..16 take 15), each long one used by a match.
    lit = [0] * 259
    lit[ord("a")], lit[256], lit[257], lit[258] = 1, 2, 3, 3
    dist = [0] * 30
    for s in range(13):
        dist[s] = s + 1
    for s in (13, 14, 15, 16):
        dist[s] = 15
    body = [ord("a")] * 300 + [("match", 3, d) for d in (97, 129, 193, 257)]
    out["dist_codes_15bit"] = dynamic_stream(
        lit, dist, body + [("match", 4, 1), 256])[0]
    return out


def _fibonacci_bytes(rng) -> bytes:
    """21 byte values with Fibonacci counts (28,656 bytes), shuffled: a
    Huffman code over them wants 20 bits, so zlib's length limit gives the
    rare ones 15-bit codes."""
    fib = [1, 1]
    while len(fib) < 21:
        fib.append(fib[-1] + fib[-2])
    vals = np.repeat(np.arange(40, 61, dtype=np.uint8), fib)
    return rng.permutation(vals).tobytes()


def _mixed_blocks(rng) -> bytes:
    """Many small dynamic blocks (memLevel 1 flushes every 128 symbols),
    a fixed block, a stored block and an empty stored sync block between
    each, then a final dynamic block; under 64 KiB of output."""
    text = b"".join(b"read%05d\tACGTTGCA\t%d\n" % (i, i * 7) for i in range(600))
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 1)
    out = co.compress(text[:8000]) + co.flush(zlib.Z_FULL_FLUSH)
    out += co.compress(b"abc") + co.flush(zlib.Z_FULL_FLUSH)
    out += co.compress(rng.integers(0, 256, 3000, dtype=np.uint8).tobytes())
    out += co.flush(zlib.Z_FULL_FLUSH)
    out += co.compress(b"xy") + co.flush(zlib.Z_FULL_FLUSH)
    return out + co.compress(text[8000:]) + co.flush()


def edge_cases() -> dict[str, tuple[bytes, int]]:
    """Name → (row bytes, clen) for every edge stream."""
    rng = np.random.default_rng(3)
    fox = b"the quick brown fox " * 200
    skew = bytes(rng.choice([32, 101, 116, 97, 10, 200], size=20_000,
                            p=[.3, .25, .2, .15, .05, .05]).astype(np.uint8))
    streams = {
        "fox_default": deflate(fox),
        "random_stored": deflate(rng.integers(0, 256, 8_000,
                                              dtype=np.uint8).tobytes()),
        "rle_z": deflate(b"z" * 50_000),
        "tail": deflate(b"tail"),
        "empty": deflate(b""),
        "level0_stored": deflate(fox, level=0),
        "fixed_level9": deflate(fox, level=9, strategy=zlib.Z_FIXED),
        "cl_runs_dynamic": deflate(skew, level=9),
        "sym286": fixed_stream([ord("A"), 286]),
        "sym287": fixed_stream([ord("A"), 287]),
        "dist_before_start": fixed_stream([ord("A"), 257, (3, 5), 256]),
        "garbage": b"\x07" + b"\x00" * 8,
        "truncated": deflate(fox)[:-5],
        "output_past_64k": deflate(b"z" * 70_000),
    }
    # A fixed block, then an empty stored final block.
    w = BitWriter()
    w.put(0, 1)
    w.put(1, 2)
    for ch in b"abc":
        w.put_code(*fixed_lit_code(ch))
    w.put_code(*fixed_lit_code(256))
    w.put(1, 1)
    w.put(0, 2)
    streams["zero_len_final_stored"] = w.bytes() + b"\x00\x00\xff\xff"
    # Stored block whose NLEN is not ~LEN.
    streams["stored_nlen_mismatch"] = (b"\x01" + struct.pack("<HH", 5, 5)
                                       + b"x" * 5)
    # Stored block claiming 2000 bytes with 900 present: the first 512-byte
    # chunk lands, the second does not fit.
    streams["stored_short_chunk"] = (
        b"\x01" + struct.pack("<HH", 2000, 2000 ^ 0xFFFF)
        + rng.integers(0, 256, 900, dtype=np.uint8).tobytes())
    # BTYPE = 3 is reserved.
    w = BitWriter()
    w.put(1, 1)
    w.put(3, 2)
    streams["btype3"] = w.bytes() + b"\x00" * 4
    # Dynamic header with HLIT = 287 (> 286).
    w = BitWriter()
    w.put(1, 1)
    w.put(2, 2)
    w.put(30, 5)
    w.put(0, 5)
    w.put(0, 4)
    streams["hlit_too_big"] = w.bytes() + b"\x00" * 8
    # Output of exactly one row (ok), and one byte more (rejected).
    block = bytes(range(256)) * 256
    streams["exact_64k"] = deflate(block)
    streams["past_64k_by_one"] = deflate(block + b"!")
    streams["fibonacci_15bit"] = deflate(_fibonacci_bytes(rng), 9,
                                         zlib.Z_HUFFMAN_ONLY)
    # zlib's other strategies and levels: other code shapes for the tables.
    streams["skew_level1"] = deflate(skew, 1)
    streams["skew_rle"] = deflate(skew, 9, zlib.Z_RLE)
    streams["fox_filtered"] = deflate(fox + skew[:3000], 6, zlib.Z_FILTERED,
                                      mem_level=9)
    streams["mixed_blocks"] = _mixed_blocks(rng)
    streams.update(_hand_dynamic())
    return {k: v if isinstance(v, tuple) else (v, len(v))
            for k, v in streams.items()}


def random_streams(n: int, seed: int) -> dict[str, tuple[bytes, int]]:
    """``n`` valid raw-DEFLATE streams of up to 70,000 bytes (some inflate
    past one row) from zlib at random levels, window sizes, memory levels
    and strategies, over uniform, few-symbol, skewed, sequence-like and
    run-heavy bytes: the code shapes real compressors emit."""
    rng = np.random.default_rng(seed)
    strategies = (zlib.Z_DEFAULT_STRATEGY, zlib.Z_FILTERED,
                  zlib.Z_HUFFMAN_ONLY, zlib.Z_RLE, zlib.Z_FIXED)
    out = {}
    for i in range(n):
        size, kind = int(rng.integers(0, 70_000)), i % 5
        if kind == 0:
            data = rng.integers(0, 256, size, dtype=np.uint8)
        elif kind == 1:
            data = rng.integers(0, int(rng.integers(2, 40)), size,
                                dtype=np.uint8)
        elif kind == 2:
            p = rng.dirichlet(np.full(256, rng.uniform(0.02, 2)))
            data = rng.choice(256, size=size, p=p).astype(np.uint8)
        elif kind == 3:
            data = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=size,
                              p=[.24, .26, .26, .23, .01])
        else:
            data = np.repeat(rng.integers(0, 256, size // 50 + 1,
                                          dtype=np.uint8), 50)[:size]
        co = zlib.compressobj(int(rng.integers(0, 10)), zlib.DEFLATED,
                              -int(rng.integers(9, 16)),
                              int(rng.integers(1, 10)),
                              strategies[int(rng.integers(0, 5))])
        comp = co.compress(data.tobytes()) + co.flush()
        out[f"random_{i}"] = (comp, len(comp))
    return out


def mutate(data: bytes, clen: int, rng) -> tuple[bytes, int]:
    """One seeded structural mutation of a stream: a bit flip, a byte set
    to 0/0x80/0xFF, a 0xFFFF or i32 poison write, or a truncation that keeps
    the cut bytes as slack behind the new ``clen``."""
    buf = bytearray(data)
    off = int(rng.integers(0, max(clen, 1)))
    op = int(rng.integers(0, 5))
    if op == 3:
        return bytes(buf), max(off, 1)
    if not buf:
        return bytes(buf), clen
    if op == 0 and off + 4 <= clen:
        poison = (-1, -2, 0, 1, 32, 33, -(1 << 31), (1 << 31) - 1, 1 << 30)
        struct.pack_into("<i", buf, off, poison[int(rng.integers(0, 9))])
    elif op == 1:
        buf[off] ^= 1 << int(rng.integers(0, 8))
    elif op == 2:
        buf[off] = (0, 0x80, 0xFF)[int(rng.integers(0, 3))]
    elif off + 2 <= clen:
        struct.pack_into("<H", buf, off, 0xFFFF)
    else:
        buf[off] ^= 0xFF
    return bytes(buf), clen


def mutants(bases: dict[str, tuple[bytes, int]], n: int,
            seed: int) -> dict[str, tuple[bytes, int]]:
    """``n`` mutants, one to three mutations each, of the non-empty bases
    in turn: name ``mutant_<base>_<i>``."""
    rng = np.random.default_rng(seed)
    names = [k for k, (_, c) in bases.items() if c > 0]
    out = {}
    for i in range(n):
        name = names[i % len(names)]
        data, clen = bases[name]
        for _ in range(1 + int(rng.integers(0, 3))):
            data, clen = mutate(data, clen, rng)
        out[f"mutant_{name}_{i}"] = (data, clen)
    return out


def stage(cases: dict[str, tuple[bytes, int]], c_pad: int,
          rows: int | None = None):
    """Stage cases as tokenizer rows: ``(staged (rows, c_pad) u8, clens
    (rows,) i32, names)``; rows past the cases are zero-length padding. A
    row's bytes past ``c_pad`` are dropped (they can only be slack)."""
    rows = len(cases) if rows is None else rows
    if len(cases) > rows:
        raise ValueError(f"{len(cases)} cases do not fit {rows} rows")
    staged = np.zeros((rows, c_pad), dtype=np.uint8)
    clens = np.zeros(rows, dtype=np.int32)
    for i, (data, clen) in enumerate(cases.values()):
        if clen + 8 > c_pad:
            raise ValueError(f"case {i} needs {clen + 8} > {c_pad} bytes")
        data = data[:c_pad]
        staged[i, : len(data)] = np.frombuffer(data, dtype=np.uint8)
        clens[i] = clen
    return staged, clens, list(cases)
