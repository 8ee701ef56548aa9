"""CRAM encodings: the per-data-series codecs declared in the compression
header.

An encoding is serialized as ``codec id (itf8), parameter byte-length
(itf8), parameters``. Implemented codecs (the set used by real-world
writers for the series this reader consumes):

    1 EXTERNAL        value lives in the external block `content id`
                      (ITF8 per int, raw byte per byte-series value)
    3 HUFFMAN         canonical Huffman over an explicit alphabet, read
                      from the core bit stream (0-bit codes for constants)
    4 BYTE_ARRAY_LEN  nested length encoding + nested value encoding
    5 BYTE_ARRAY_STOP values from an external block up to a stop byte
    6 BETA            fixed-width offset binary from the core bit stream
    9 GAMMA           Elias gamma from the core bit stream

Core-block bits are MSB-first. ``Slice`` wires instances to its core/
external block streams at decode time; the writer emits the same
descriptors it decodes.
"""

from __future__ import annotations

from dataclasses import dataclass

from spark_bam_tpu_torch.core.guard import StructurallyInvalid, TruncatedInput
from spark_bam_tpu_torch.cram.nums import Cursor, itf8

EXTERNAL = 1
HUFFMAN = 3
BYTE_ARRAY_LEN = 4
BYTE_ARRAY_STOP = 5
BETA = 6
GAMMA = 9

#: Widest sane bit-field: 64 bits covers every CRAM data series. A larger
#: declared width (BETA length, Huffman code length) is a corrupt header;
#: uncapped, it sizes a per-value bit loop (a 2³¹-bit read per record).
MAX_CODE_BITS = 64


class BitReader:
    """MSB-first bit reader over the core block."""

    __slots__ = ("buf", "pos", "bit")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.bit = 7

    def read_bit(self) -> int:
        try:
            b = (self.buf[self.pos] >> self.bit) & 1
        except IndexError:
            raise TruncatedInput(
                f"core bit stream exhausted at byte {self.pos}"
            ) from None
        if self.bit == 0:
            self.bit = 7
            self.pos += 1
        else:
            self.bit -= 1
        return b

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


class BitWriter:
    """MSB-first bit writer producing the core block."""

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.nbits = 0

    def write_bits(self, value: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> k) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.cur)
                self.cur = 0
                self.nbits = 0

    def getvalue(self) -> bytes:
        if self.nbits:
            return bytes(self.out) + bytes([self.cur << (8 - self.nbits)])
        return bytes(self.out)


@dataclass
class Encoding:
    codec: int
    params: bytes

    def serialize(self) -> bytes:
        return itf8(self.codec) + itf8(len(self.params)) + self.params

    @staticmethod
    def parse(cur: Cursor) -> "Encoding":
        codec = cur.itf8()
        n = cur.itf8()
        return Encoding(codec, cur.read(n))


def external(content_id: int) -> Encoding:
    return Encoding(EXTERNAL, itf8(content_id))


def byte_array_stop(stop: int, content_id: int) -> Encoding:
    return Encoding(BYTE_ARRAY_STOP, bytes([stop]) + itf8(content_id))


def byte_array_len(lengths: Encoding, values: Encoding) -> Encoding:
    return Encoding(BYTE_ARRAY_LEN, lengths.serialize() + values.serialize())


def huffman(values: list[int], lens: list[int]) -> Encoding:
    p = itf8(len(values)) + b"".join(itf8(v) for v in values)
    p += itf8(len(lens)) + b"".join(itf8(x) for x in lens)
    return Encoding(HUFFMAN, p)


def beta(offset: int, length: int) -> Encoding:
    return Encoding(BETA, itf8(offset) + itf8(length))


def _canonical_codes(values: list[int], lens: list[int]) -> dict[int, tuple[int, int]]:
    """symbol → (code, length), canonical assignment by (length, symbol)."""
    pairs = sorted(zip(lens, values))
    codes: dict[int, tuple[int, int]] = {}
    code = 0
    prev_len = pairs[0][0] if pairs else 0
    for length, sym in pairs:
        code <<= length - prev_len
        prev_len = length
        codes[sym] = (code, length)
        code += 1
    return codes


class Decoders:
    """Bind encodings to a slice's core/external streams and hand out
    per-series reader callables."""

    def __init__(self, core: BitReader, ext: dict[int, Cursor]):
        self.core = core
        self.ext = ext

    def _ext_cursor(self, params: bytes) -> Cursor:
        cid = Cursor(params).itf8()
        if cid not in self.ext:
            self.ext[cid] = Cursor(b"")  # absent block = empty series
        return self.ext[cid]

    def int_reader(self, enc: Encoding):
        if enc.codec == EXTERNAL:
            cur = self._ext_cursor(enc.params)
            return cur.itf8
        if enc.codec == HUFFMAN:
            return self._huffman_reader(enc)
        if enc.codec == BETA:
            p = Cursor(enc.params)
            offset = p.itf8()
            length = p.itf8()
            if not 0 <= length <= MAX_CODE_BITS:
                raise StructurallyInvalid(
                    f"BETA bit length {length} outside [0, {MAX_CODE_BITS}]"
                )
            core = self.core
            return lambda: core.read_bits(length) - offset
        if enc.codec == GAMMA:
            p = Cursor(enc.params)
            offset = p.itf8()
            core = self.core

            def read_gamma():
                n = 0
                while core.read_bit() == 0:
                    n += 1
                return ((1 << n) | core.read_bits(n)) - offset

            return read_gamma
        raise NotImplementedError(f"int codec {enc.codec}")

    def byte_reader(self, enc: Encoding):
        if enc.codec == EXTERNAL:
            cur = self._ext_cursor(enc.params)
            return cur.u8
        if enc.codec == HUFFMAN:
            return self._huffman_reader(enc)
        if enc.codec == BETA:
            return self.int_reader(enc)
        raise NotImplementedError(f"byte codec {enc.codec}")

    def _huffman_reader(self, enc: Encoding):
        p = Cursor(enc.params)
        n_values = p.itf8()
        if not 0 <= n_values <= p.remaining():
            # Alphabet entries are ≥ 1 byte each: a larger count is corrupt.
            raise StructurallyInvalid(
                f"Huffman alphabet count {n_values} exceeds the "
                f"{p.remaining()} parameter bytes present"
            )
        values = [p.itf8() for _ in range(n_values)]
        n_lens = p.itf8()
        if n_lens != n_values:
            raise StructurallyInvalid(
                f"Huffman table mismatch: {n_values} symbols, {n_lens} code "
                f"lengths"
            )
        lens = [p.itf8() for _ in range(n_lens)]
        if not values:
            raise StructurallyInvalid("Huffman table with empty alphabet")
        if any(not 0 <= l <= MAX_CODE_BITS for l in lens):
            raise StructurallyInvalid(
                f"Huffman code length outside [0, {MAX_CODE_BITS}]: {lens}"
            )
        if len(values) == 1 and lens[0] == 0:
            const = values[0]
            return lambda: const  # zero-bit constant
        codes = _canonical_codes(values, lens)
        by_len: dict[int, dict[int, int]] = {}
        for sym, (code, length) in codes.items():
            by_len.setdefault(length, {})[code] = sym
        core = self.core
        max_len = max(by_len)

        def read_huffman():
            code = 0
            length = 0
            while length <= max_len:
                code = (code << 1) | core.read_bit()
                length += 1
                tab = by_len.get(length)
                if tab is not None and code in tab:
                    return tab[code]
            raise StructurallyInvalid("bad Huffman code in core block")

        return read_huffman

    def bulk_reader(self, enc: Encoding):
        """callable(n) → n bytes of a byte series (fast path for EXTERNAL)."""
        if enc.codec == EXTERNAL:
            cur = self._ext_cursor(enc.params)
            return cur.read
        read_byte = self.byte_reader(enc)
        return lambda n: bytes(read_byte() for _ in range(n))

    def array_reader(self, enc: Encoding):
        """Byte-array series (RN, BB, QQ, IN, SC, tag values)."""
        if enc.codec == BYTE_ARRAY_STOP:
            p = Cursor(enc.params)
            stop = p.u8()
            cid = p.itf8()
            if cid not in self.ext:
                self.ext[cid] = Cursor(b"")
            cur = self.ext[cid]

            def read_stop() -> bytes:
                buf = cur.buf
                end = buf.find(bytes([stop]), cur.pos)
                if end < 0:
                    end = len(buf)
                v = bytes(buf[cur.pos: end])
                cur.pos = end + 1
                return v

            return read_stop
        if enc.codec == BYTE_ARRAY_LEN:
            p = Cursor(enc.params)
            len_enc = Encoding.parse(p)
            val_enc = Encoding.parse(p)
            read_len = self.int_reader(len_enc)
            if val_enc.codec == EXTERNAL:
                cur = self._ext_cursor(val_enc.params)

                def read_bal() -> bytes:
                    n = read_len()
                    return cur.read(n)

                return read_bal
            read_byte = self.byte_reader(val_enc)

            def read_bal_slow() -> bytes:
                return bytes(read_byte() for _ in range(read_len()))

            return read_bal_slow
        raise NotImplementedError(f"array codec {enc.codec}")
