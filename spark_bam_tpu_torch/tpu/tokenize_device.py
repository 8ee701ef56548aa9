"""DEFLATE entropy phase: one raw-DEFLATE BGZF payload per row → per-output-
byte token planes.

``lit[i]`` is the byte where output position ``i`` came from a literal
(``dist[i] == 0``), else ``dist[i]`` is the back-reference distance of the
match that wrote it; tails past ``out_len`` are zero. ``ok`` is False
exactly where the reference bit-reader (``spark_bam_tpu/tpu/
tokenize_device.py::_tokenize_row``) rejects the stream:

- HLIT > 286 or HDIST > 30;
- repeat-previous (code 16) at index 0, or a run past HLIT + HDIST;
- no code for end-of-block (symbol 256);
- an oversubscribed code (incomplete codes are legal: decoding an absent
  code fails on first use);
- stored-block LEN/NLEN mismatch;
- litlen symbol 286/287, or a distance code with no table entry;
- a distance reaching before the stream start, or output past 64 KiB;
- truncation (a read past the payload's last bit), or no end-of-block
  before the final block ends.

At a rejection the planes and ``out_len`` hold what was written before the
failing symbol, as the reference's masked writes leave them. Zero-length
rows (batch padding) come back ``ok=False`` with ``out_len=0``.

This module holds the plain version: a row-at-a-time Python decoder. A
bit-serial decoder has no tensor form, so it is table-driven Python over
the CPU bytes. The CUDA kernel (``csrc/tokenize.cu``) reproduces it
decision for decision with a warp per row; ``tpu/kernels.py::tokenize``
dispatches.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_bam_tpu_torch.bgzf.block import MAX_BLOCK_SIZE

#: Token-row width: one BGZF block inflates to ≤ 64 KiB.
STRIDE = MAX_BLOCK_SIZE
#: Stored-block copies move at most this many bytes at a time; a copy that
#: runs out of input or output fails at the chunk that does not fit, and the
#: chunks before it stay written (the reference's windowed-write width).
STORED_CHUNK = 512

# RFC 1951 3.2.5 length/distance base + extra-bit tables.
LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
            51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
             4, 4, 5, 5, 5, 5, 0)
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
             16385, 24577)
DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9,
              10, 10, 11, 11, 12, 12, 13, 13)
# RFC 1951 3.2.7: the order code-length-code lengths appear in.
CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


def _build(lens) -> tuple[list[int], int] | None:
    """Lookup table of a canonical code (RFC 1951 3.2.2), or None when the
    code is oversubscribed. Entry ``t[w]`` for every ``nbits``-bit window
    ``w`` of the stream (LSB first) is ``(symbol << 4) | length``, or 0
    where no code is a prefix of ``w``."""
    count = [0] * 16
    for ln in lens:
        count[ln] += 1
    count[0] = 0
    left = 1
    for ln in range(1, 16):
        left = left * 2 - count[ln]
        if left < 0:
            return None
    nbits = max((ln for ln in range(16) if count[ln]), default=0)
    table = np.zeros(1 << nbits, dtype=np.int64)
    code, nxt = 0, [0] * 16
    for ln in range(1, 16):
        code = (code + count[ln - 1]) << 1
        nxt[ln] = code
    for sym, ln in enumerate(lens):
        if ln:
            c = nxt[ln]
            nxt[ln] += 1
            rev = int(f"{c:0{ln}b}"[::-1], 2)
            table[rev:: 1 << ln] = (sym << 4) | ln
    return table.tolist(), nbits


_FIXED_LIT = _build([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8)
_FIXED_DIST = _build([5] * 30)


def tokenize_row(row, clen: int):
    """Tokenize one raw-DEFLATE stream: ``row`` holds its bytes (at least
    ``clen``). Returns ``(lit bytearray, dist (STRIDE,) u16 ndarray,
    out_len, ok)``. A row outside the staging contract (``clen`` < 0, or
    fewer than 8 bytes of slack after it) is rejected undecoded."""
    lit = bytearray(STRIDE)
    dist = np.zeros(STRIDE, dtype=np.uint16)
    if clen < 0 or clen + 8 > len(row):
        return lit, dist, 0, False
    data = bytes(row[:clen]) + bytes(8)
    clen8 = clen * 8
    buf = cnt = pos = used = 0

    def bits(n: int) -> int:
        """``n`` ≤ 16 bits LSB first, or -1 past the payload's end."""
        nonlocal buf, cnt, pos, used
        if used + n > clen8:
            return -1
        if cnt < n:
            buf |= int.from_bytes(data[pos: pos + 4], "little") << cnt
            pos += 4
            cnt += 32
        v = buf & ((1 << n) - 1)
        buf >>= n
        cnt -= n
        used += n
        return v

    def decode(tab) -> int:
        nonlocal buf, cnt, pos, used
        table, nbits = tab
        if cnt < nbits:
            buf |= int.from_bytes(data[pos: pos + 4], "little") << cnt
            pos += 4
            cnt += 32
        e = table[buf & ((1 << nbits) - 1)]
        ln = e & 15
        if ln == 0 or used + ln > clen8:
            return -1
        buf >>= ln
        cnt -= ln
        used += ln
        return e >> 4

    def dynamic_tables():
        hlit, hdist, hclen = bits(5), bits(5), bits(4)
        if min(hlit, hdist, hclen) < 0:
            return None
        hlit, hdist, hclen = hlit + 257, hdist + 1, hclen + 4
        if hlit > 286 or hdist > 30:
            return None
        cl = [0] * 19
        for i in range(hclen):
            v = bits(3)
            if v < 0:
                return None
            cl[CL_ORDER[i]] = v
        cltab = _build(cl)
        if cltab is None:
            return None
        tot = hlit + hdist
        lens = [0] * tot
        i = 0
        while i < tot:
            sym = decode(cltab)
            if sym < 0:
                return None
            if sym < 16:
                lens[i] = sym
                i += 1
                continue
            if sym == 16:
                v, rep_base, val = bits(2), 3, (lens[i - 1] if i else -1)
            elif sym == 17:
                v, rep_base, val = bits(3), 3, 0
            else:
                v, rep_base, val = bits(7), 11, 0
            if v < 0 or val < 0 or i + rep_base + v > tot:
                return None
            lens[i: i + rep_base + v] = [val] * (rep_base + v)
            i += rep_base + v
        if lens[256] == 0:
            return None
        littab, disttab = _build(lens[:hlit]), _build(lens[hlit:])
        if littab is None or disttab is None:
            return None
        return littab, disttab

    o = 0
    ok = True
    while ok:
        bfinal, btype = bits(1), bits(2)
        if bfinal < 0 or btype < 0 or btype == 3:
            ok = False
            break
        if btype == 0:
            used = (used + 7) & ~7
            pos, buf, cnt = used >> 3, 0, 0
            ln, nln = bits(16), bits(16)
            if ln < 0 or nln < 0 or (ln ^ 0xFFFF) != nln:
                ok = False
                break
            while ln > 0:
                src = used >> 3
                chunk = min(ln, STORED_CHUNK)
                if src + chunk > clen or o + chunk > STRIDE:
                    ok = False
                    break
                lit[o: o + chunk] = data[src: src + chunk]
                ln -= chunk
                used += chunk * 8
                o += chunk
            pos, buf, cnt = used >> 3, 0, 0
        else:
            tabs = _FIXED_LIT, _FIXED_DIST
            if btype == 2:
                tabs = dynamic_tables()
                if tabs is None:
                    ok = False
                    break
            littab, disttab = tabs
            while True:
                sym = decode(littab)
                if sym < 0:
                    ok = False
                    break
                if sym < 256:
                    if o >= STRIDE:
                        ok = False
                        break
                    lit[o] = sym
                    o += 1
                    continue
                if sym == 256:
                    break
                s2 = sym - 257
                if s2 >= 29:
                    ok = False
                    break
                v = bits(LEN_EXTRA[s2])
                d = decode(disttab) if v >= 0 else -1
                vd = bits(DIST_EXTRA[d]) if d >= 0 else -1
                if vd < 0:
                    ok = False
                    break
                mlen = LEN_BASE[s2] + v
                mdist = DIST_BASE[d] + vd
                if mdist > o or o + mlen > STRIDE:
                    ok = False
                    break
                dist[o: o + mlen] = mdist
                o += mlen
        if bfinal:
            break
    return lit, dist, o, ok


def tokenize_plain(staged: torch.Tensor, clens: torch.Tensor):
    """The plain version of the tokenize kernel on CPU tensors: ``staged``
    (B, C_pad) u8, ``clens`` (B,) i32 → ``(lit (B, S) u8, dist (B, S) u16,
    out_lens (B,) i32, ok (B,) bool)``."""
    rows = staged.numpy()
    b = rows.shape[0]
    lit = np.zeros((b, STRIDE), dtype=np.uint8)
    dist = np.zeros((b, STRIDE), dtype=np.uint16)
    out_lens = np.zeros(b, dtype=np.int32)
    ok = np.zeros(b, dtype=bool)
    for i, clen in enumerate(clens.tolist()):
        lb, db, out_lens[i], ok[i] = tokenize_row(rows[i], clen)
        lit[i] = np.frombuffer(lb, dtype=np.uint8)
        dist[i] = db
    return (torch.from_numpy(lit), torch.from_numpy(dist),
            torch.from_numpy(out_lens), torch.from_numpy(ok))
