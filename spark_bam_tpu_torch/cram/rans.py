"""rANS 4x8 entropy codec (CRAM 3.0 block compression method 4).

Asymmetric-numeral-system coding with 4 interleaved 32-bit states, byte
renormalization, and 12-bit (4096-total) normalized frequencies; order-0
(context-free) and order-1 (previous-byte context) variants. The layout
follows the CRAM 3.0 specification:

    u8  order (0|1)
    u32 compressed size   (frequency table + rANS data)
    u32 uncompressed size
    frequency table, then interleaved rANS byte stream

Decode order-0: position i uses state i mod 4. Order-1: output is split in
four quarters (the last takes the remainder, continued by state 3); each
state walks its quarter with the previous byte as context.

Both directions are implemented: the writer uses encode for CRAM block
compression. ``decompress`` runs the native decoder
(``native/rans.cpp``, built by ``native/build.py`` with g++ on first use;
a missing g++ or a failed build raises, nothing falls back). The Python
decoder stays as its plain version (``decompress_python``), which the
tests and the smoke hold the native one against.
"""

from __future__ import annotations

import struct

import numpy as np

from spark_bam_tpu_torch.core.guard import StructurallyInvalid
from spark_bam_tpu_torch.cram.nums import Cursor

TOTFREQ = 4096
_BITS = 12
_LOW = 1 << 23  # renormalization threshold


# ------------------------------------------------------------ freq tables
def _normalize(counts: list[int], total: int = TOTFREQ) -> dict[int, int]:
    """Scale raw symbol counts to sum exactly ``total``, each survivor ≥ 1."""
    t = sum(counts)
    freqs: dict[int, int] = {}
    for s in range(256):
        if counts[s]:
            freqs[s] = max(1, counts[s] * total // t)
    excess = sum(freqs.values()) - total
    # Settle the rounding debt against the largest entries.
    for s in sorted(freqs, key=lambda k: -freqs[k]):
        if excess == 0:
            break
        adj = min(freqs[s] - 1, excess) if excess > 0 else excess
        freqs[s] -= adj
        excess -= adj
    if excess:
        raise ValueError("cannot normalize frequencies")
    return freqs


def _write_freqs(freqs: dict[int, int]) -> bytes:
    """Symbol/frequency list: ascending symbols, consecutive runs
    compressed (second member of a run is followed by the count of further
    members), 1- or 2-byte frequencies, 0-terminated."""
    out = bytearray()
    syms = sorted(freqs)
    rle = 0
    for i, s in enumerate(syms):
        if rle:
            rle -= 1
        else:
            out.append(s)
            if i > 0 and syms[i - 1] == s - 1:
                run = 0
                while i + run + 1 < len(syms) and syms[i + run + 1] == s + run + 1:
                    run += 1
                out.append(run)
                rle = run
        f = freqs[s]
        if f >= 128:
            out.append(0x80 | (f >> 8))
            out.append(f & 0xFF)
        else:
            out.append(f)
    out.append(0)
    return bytes(out)


def _read_freqs(cur: Cursor) -> list[int]:
    freqs = [0] * 256
    sym = cur.u8()
    rle = 0
    while True:
        f = cur.u8()
        if f >= 0x80:
            f = ((f & 0x7F) << 8) | cur.u8()
        freqs[sym] = f
        if rle:
            rle -= 1
            sym += 1
        elif sym + 1 == cur.peek_u8():
            sym = cur.u8()
            rle = cur.u8()
        else:
            sym = cur.u8()
            if sym == 0:
                break
    return freqs


def _tables(freqs: list[int]):
    """(cumulative starts, symbol-of-slot lookup) for one context."""
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freqs[s]
    lookup = bytearray(TOTFREQ)
    for s in range(256):
        if freqs[s]:
            lookup[cum[s]: cum[s + 1]] = bytes([s]) * freqs[s]
    return cum, bytes(lookup)


# ---------------------------------------------------------------- order 0
def _enc_flush(states, out: bytearray) -> None:
    for r in (states[3], states[2], states[1], states[0]):
        out.extend(((r >> 24) & 0xFF, (r >> 16) & 0xFF, (r >> 8) & 0xFF, r & 0xFF))


def _enc_put(r: int, freq: int, start: int, out: bytearray) -> int:
    x_max = ((_LOW >> _BITS) << 8) * freq
    while r >= x_max:
        out.append(r & 0xFF)
        r >>= 8
    return ((r // freq) << _BITS) + (r % freq) + start


def _encode_o0(data: bytes) -> bytes:
    counts = np.bincount(np.frombuffer(data, dtype=np.uint8),
                         minlength=256).tolist()
    freqs = _normalize(counts)
    table = _write_freqs(freqs)
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freqs.get(s, 0)
    freq = [freqs.get(s, 0) for s in range(256)]
    x_max = [((_LOW >> _BITS) << 8) * f for f in freq]
    states = [_LOW] * 4
    rev = bytearray()
    put = rev.append
    # _enc_put inlined: this loop runs once a byte.
    for i in range(len(data) - 1, -1, -1):
        j = i & 3
        s = data[i]
        r = states[j]
        f = freq[s]
        xm = x_max[s]
        while r >= xm:
            put(r & 0xFF)
            r >>= 8
        states[j] = ((r // f) << _BITS) + (r % f) + cum[s]
    _enc_flush(states, rev)
    return table + bytes(reversed(rev))


def _decode_o0(cur: Cursor, out_sz: int) -> bytes:
    freqs = _read_freqs(cur)
    cum, lookup = _tables(freqs)
    states = [cur.u32() for _ in range(4)]
    buf = cur.buf
    p = cur.pos
    n = len(buf)
    out = bytearray(out_sz)
    for i in range(out_sz):
        j = i & 3
        r = states[j]
        m = r & (TOTFREQ - 1)
        s = lookup[m]
        out[i] = s
        r = freqs[s] * (r >> _BITS) + m - cum[s]
        while r < _LOW and p < n:
            r = (r << 8) | buf[p]
            p += 1
        states[j] = r
    cur.pos = p
    return bytes(out)


# ---------------------------------------------------------------- order 1
def _quarters(out_sz: int):
    isz4 = out_sz >> 2
    return isz4, [0, isz4, 2 * isz4, 3 * isz4]


def _encode_o1(data: bytes) -> bytes:
    out_sz = len(data)
    isz4, i4 = _quarters(out_sz)
    # (previous byte, byte) pair counts of each quarter, the first byte
    # of a quarter after context 0.
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    prev = np.empty_like(arr)
    prev[1:] = arr[:-1]
    prev[i4] = 0
    counts = np.bincount(prev * 256 + arr, minlength=65536).reshape(256, 256)
    freqs: dict[int, dict[int, int]] = {}
    for ctx in np.flatnonzero(counts.any(axis=1)).tolist():
        freqs[ctx] = _normalize(counts[ctx].tolist())

    # Outer context list uses the same run compression as the symbol list.
    table = bytearray()
    ctxs = sorted(freqs)
    rle = 0
    for i, c in enumerate(ctxs):
        if rle:
            rle -= 1
        else:
            table.append(c)
            if i > 0 and ctxs[i - 1] == c - 1:
                run = 0
                while i + run + 1 < len(ctxs) and ctxs[i + run + 1] == c + run + 1:
                    run += 1
                table.append(run)
                rle = run
        table.extend(_write_freqs(freqs[c]))
    table.append(0)

    # Per context: frequency, cumulative start and renormalisation bound
    # of every symbol, as lists (the loops below run once a byte).
    freq, cums, x_max = {}, {}, {}
    for ctx, f in freqs.items():
        fl = [f.get(s, 0) for s in range(256)]
        cum = [0] * 257
        for s in range(256):
            cum[s + 1] = cum[s] + fl[s]
        freq[ctx], cums[ctx] = fl, cum
        x_max[ctx] = [((_LOW >> _BITS) << 8) * v for v in fl]

    states = [_LOW] * 4
    rev = bytearray()
    put = rev.append
    # Reverse of the decode op sequence: remainder (state 3) first,
    # then the main loop back-to-front with states 3..0 (_enc_put
    # inlined).
    r = states[3]
    for p in range(out_sz - 1, 4 * isz4 - 1, -1):
        # State 3 continues straight out of its quarter, so the context is
        # simply the previous byte.
        ctx = data[p - 1] if p > 0 else 0
        s = data[p]
        f = freq[ctx][s]
        xm = x_max[ctx][s]
        while r >= xm:
            put(r & 0xFF)
            r >>= 8
        r = ((r // f) << _BITS) + (r % f) + cums[ctx][s]
    states[3] = r
    for i in range(isz4 - 1, -1, -1):
        for j in (3, 2, 1, 0):
            p = i4[j] + i
            ctx = data[p - 1] if i > 0 else 0
            s = data[p]
            r = states[j]
            f = freq[ctx][s]
            xm = x_max[ctx][s]
            while r >= xm:
                put(r & 0xFF)
                r >>= 8
            states[j] = ((r // f) << _BITS) + (r % f) + cums[ctx][s]
    _enc_flush(states, rev)
    return bytes(table) + bytes(reversed(rev))


def _decode_o1(cur: Cursor, out_sz: int) -> bytes:
    freqs = [None] * 256
    cums = [None] * 256
    lookups = [None] * 256
    ctx = cur.u8()
    rle = 0
    while True:
        f = _read_freqs(cur)
        cum, lookup = _tables(f)
        freqs[ctx] = f
        cums[ctx] = cum
        lookups[ctx] = lookup
        if rle:
            rle -= 1
            ctx += 1
        elif ctx + 1 == cur.peek_u8():
            ctx = cur.u8()
            rle = cur.u8()
        else:
            ctx = cur.u8()
            if ctx == 0:
                break
    isz4, i4 = _quarters(out_sz)
    states = [cur.u32() for _ in range(4)]
    last = [0, 0, 0, 0]
    buf = cur.buf
    p = cur.pos
    n = len(buf)
    out = bytearray(out_sz)
    for i in range(isz4):
        for j in range(4):
            r = states[j]
            m = r & (TOTFREQ - 1)
            s = lookups[last[j]][m]
            out[i4[j] + i] = s
            r = freqs[last[j]][s] * (r >> _BITS) + m - cums[last[j]][s]
            while r < _LOW and p < n:
                r = (r << 8) | buf[p]
                p += 1
            states[j] = r
            last[j] = s
    for pos in range(4 * isz4, out_sz):
        r = states[3]
        m = r & (TOTFREQ - 1)
        s = lookups[last[3]][m]
        out[pos] = s
        r = freqs[last[3]][s] * (r >> _BITS) + m - cums[last[3]][s]
        while r < _LOW and p < n:
            r = (r << 8) | buf[p]
            p += 1
        states[3] = r
        last[3] = s
    cur.pos = p
    return bytes(out)


# ------------------------------------------------------------- public API
def compress(data: bytes, order: int = 0) -> bytes:
    if len(data) == 0:
        body = b""
        order = 0
    elif order == 0 or len(data) < 4:
        order = 0
        body = _encode_o0(data)
    else:
        body = _encode_o1(data)
    return (
        bytes([order]) + struct.pack("<I", len(body)) + struct.pack("<I", len(data))
        + body
    )


def _header(blob: bytes, max_out: int | None):
    cur = Cursor(blob)
    order = cur.u8()
    cur.u32()  # compressed size (informational)
    out_sz = cur.u32()
    if max_out is not None and out_sz > max_out:
        # The caller (cram/container.py) knows the block's declared raw
        # size; a larger embedded out_sz is corrupt: refuse before the
        # decode loop sizes itself on it.
        raise StructurallyInvalid(
            f"rANS output size {out_sz} exceeds declared block size {max_out}"
        )
    return cur, order, out_sz


def decompress(blob: bytes, max_out: int | None = None) -> bytes:
    """Decode one rANS 4x8 stream with the native decoder. Malformed
    bytes raise ``IOError`` (the decoder's refusal) or the header's typed
    errors."""
    cur, order, out_sz = _header(blob, max_out)
    if out_sz == 0:
        return b""
    if order in (0, 1):
        from spark_bam_tpu_torch.native.build import rans_decompress_native

        return rans_decompress_native(bytes(blob), out_sz)
    raise StructurallyInvalid(f"unknown rANS order {order}")


def decompress_python(blob: bytes, max_out: int | None = None) -> bytes:
    """The plain version of ``decompress``: the same stream decoded in
    Python."""
    cur, order, out_sz = _header(blob, max_out)
    if out_sz == 0:
        return b""
    if order in (0, 1):
        return _decode_o0(cur, out_sz) if order == 0 else _decode_o1(cur, out_sz)
    raise StructurallyInvalid(f"unknown rANS order {order}")
