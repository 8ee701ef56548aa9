"""Build the port's host C++ (the DEFLATE tokenizer ``native/tokenize.cpp``,
the CRAM rANS decoder ``native/rans.cpp``, the eager checker and fast
inflate ``native/eager.cpp`` and the zlib inflate
``native/inflate_zlib.cpp``) and bind it with ctypes.

``g++ -O3 -fPIC -shared`` compiles a source on first use into
``spark_bam_tpu_torch/_build/``, into a library named by the source and a
hash of it and the flags, so an edited source rebuilds and an unchanged
one loads at once (the way ``kernels/build.py`` builds the CUDA kernels).
A missing ``g++`` or a failed build raises :class:`NativeBuildError`:
nothing falls back to another decoder.

``tokenize_deflate`` calls ``sbt_tokenize_deflate`` on raw-DEFLATE
payloads and writes the token rows into caller-given planes, so a row
range can go straight into a pinned staging buffer. ctypes releases the
GIL for the call: threads tokenize disjoint row ranges at once.
``rans_decompress_native`` decodes one rANS 4x8 stream.

The host yardstick (reference ``spark_bam_tpu/native/build.py``, the same
names and signatures): ``eager_check_native``,
``eager_check_window_native``, ``find_record_start_native`` and
``find_record_start_window_native`` (the eager checker over a flat
buffer), ``inflate_blocks_fast_into`` (the table decoder; a block it
refuses is decoded by zlib, as the reference's is) and
``inflate_blocks_native`` (zlib through ``-lz``). ``eager.cpp`` is built
with ``-march=native``, so its library's name carries a token of the host
CPU and a checkout copied to another machine builds its own. Where the
reference returns None for a missing library, these raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE / "tokenize.cpp"
RANS_SRC = HERE / "rans.cpp"
EAGER_SRC = HERE / "eager.cpp"
ZLIB_SRC = HERE / "inflate_zlib.cpp"
BUILD_DIR = HERE.parent / "_build"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None        # the tokenizer's
_rans_lib: ctypes.CDLL | None = None
_eager_lib: ctypes.CDLL | None = None
_zlib_lib: ctypes.CDLL | None = None
#: Extra g++ arguments a source needs: flags before it, libraries after.
EXTRA = {"eager.cpp": (["-march=native"], []),
         "inflate_zlib.cpp": ([], ["-lz"])}
#: Seconds this process spent compiling the last library it built (0.0
#: when it found every library already built).
build_seconds: float = 0.0


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the source."""


def _gxx(src: Path) -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(
            f"g++ not found on PATH: {src.name} of spark_bam_tpu_torch is "
            "built from source (the host tokenizer of inflate tokenize=host, "
            "the CRAM rANS decoder and the host yardstick)")
    return cxx


def _host_token() -> str:
    """A token of this host's CPU (machine, model and feature flags), for
    the name of a library built with ``-march=native``."""
    import platform

    desc = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features", "model name")):
                    desc += line
    except OSError:
        pass
    return hashlib.sha256(desc.encode()).hexdigest()[:8]


def _args(src: Path) -> tuple[list, list]:
    pre, post = EXTRA.get(src.name, ([], []))
    return [*FLAGS, *pre], post


def library_path(src: "Path | None" = None) -> Path:
    """Where the library for ``src`` (the tokenizer's by default) and its
    flags lives."""
    src = SRC if src is None else src
    pre, post = _args(src)
    h = hashlib.sha256(" ".join(pre + post).encode())
    h.update(src.read_bytes())
    if "-march=native" in pre:
        h.update(_host_token().encode())
    return BUILD_DIR / f"libsbt_{src.stem}-{h.hexdigest()[:16]}.so"


def build(src: "Path | None" = None) -> Path:
    """Compile ``src`` (the tokenizer's by default; when it changed) and
    return the library's path."""
    global build_seconds
    src = SRC if src is None else src
    out = library_path(src)
    if out.exists():
        return out
    cxx = _gxx(src)
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        staging = Path(tmp) / out.name
        pre, post = _args(src)
        proc = subprocess.run([cxx, *pre, str(src), "-o", str(staging),
                               *post], capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ failed on {src.name} ({proc.returncode}):\n"
                f"{proc.stderr}")
        os.replace(staging, out)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The tokenizer library, built on first use, with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p = ctypes.c_void_p
            lib.sbt_tokenize_deflate.argtypes = [
                p, p, p, ctypes.c_int64, p, p, ctypes.c_int64, p]
            lib.sbt_tokenize_deflate.restype = ctypes.c_long
            _lib = lib
        return _lib


def load_rans() -> ctypes.CDLL:
    """The rANS decoder library, built on first use, with argtypes set."""
    global _rans_lib
    with _lock:
        if _rans_lib is None:
            lib = ctypes.CDLL(str(build(RANS_SRC)))
            p = ctypes.c_void_p
            lib.sbt_rans_decompress.argtypes = [p, ctypes.c_int64, p,
                                                ctypes.c_int64]
            lib.sbt_rans_decompress.restype = ctypes.c_int64
            _rans_lib = lib
        return _rans_lib


def load_native() -> ctypes.CDLL:
    """The eager checker and fast inflate library (``eager.cpp``), built on
    first use, with argtypes set (the reference's ``load_native``)."""
    global _eager_lib
    with _lock:
        if _eager_lib is None:
            lib = ctypes.CDLL(str(build(EAGER_SRC)))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.sbt_eager_check.argtypes = [p, i64, p, i64, p, i32, i32, p]
            lib.sbt_eager_check.restype = None
            lib.sbt_eager_check_window.argtypes = [p, i64, p, i64, p, i32,
                                                   i32, i32, p]
            lib.sbt_eager_check_window.restype = None
            lib.sbt_find_record_start.argtypes = [p, i64, i64, p, i32, i32,
                                                  i64]
            lib.sbt_find_record_start.restype = i64
            lib.sbt_find_record_start_window.argtypes = [p, i64, i64, p, i32,
                                                         i32, i64, i32, p]
            lib.sbt_find_record_start_window.restype = i64
            lib.sbt_inflate_blocks_fast.argtypes = [p, p, p, i64, p, p, p,
                                                    i64]
            lib.sbt_inflate_blocks_fast.restype = ctypes.c_long
            _eager_lib = lib
        return _eager_lib


def load_zlib() -> ctypes.CDLL:
    """The zlib inflate library (``inflate_zlib.cpp``, linked with -lz),
    built on first use, with argtypes set."""
    global _zlib_lib
    with _lock:
        if _zlib_lib is None:
            lib = ctypes.CDLL(str(build(ZLIB_SRC)))
            p = ctypes.c_void_p
            lib.sbt_inflate_blocks.argtypes = [p, p, p, ctypes.c_int64, p, p,
                                               p]
            lib.sbt_inflate_blocks.restype = ctypes.c_long
            _zlib_lib = lib
        return _zlib_lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def tokenize_deflate(comp: np.ndarray, offsets: np.ndarray,
                     lengths: np.ndarray, lit: np.ndarray, dist: np.ndarray,
                     out_lens: np.ndarray) -> int:
    """Entropy-decode the raw-DEFLATE payloads ``comp[offsets[i]:
    offsets[i] + lengths[i]]`` into rows ``i`` of ``lit`` (B, S) u8 and
    ``dist`` (B, S) u16, and their produced lengths into ``out_lens`` (B,)
    int64. A literal sets ``lit`` and ``dist = 0``, a copied byte ``lit =
    0`` and ``dist = d``; both planes are zero past a row's length.
    Returns 0, or the 1-based index of the first payload the decoder
    refuses (the rows before it are written, the rest are not)."""
    b = len(offsets)
    if not (lit.shape[0] >= b and dist.shape[0] >= b and len(out_lens) >= b
            and len(lengths) == b):
        raise ValueError("one offset, length, row and out_len a payload")
    if lit.dtype != np.uint8 or dist.dtype != np.uint16 \
            or out_lens.dtype != np.int64 or lit.shape[1:] != dist.shape[1:]:
        raise ValueError("lit (B, S) u8, dist (B, S) u16, out_lens int64")
    for a in (lit, dist, out_lens):
        if not a.flags.c_contiguous:
            raise ValueError("the output planes must be C-contiguous")
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    if b and (int(offsets.min()) < 0 or int((offsets + lengths).max())
              > len(comp) or int(lengths.min()) < 0):
        raise ValueError("a payload lies outside comp")
    return int(load().sbt_tokenize_deflate(
        _ptr(comp), _ptr(offsets), _ptr(lengths), b, _ptr(lit), _ptr(dist),
        lit.shape[1], _ptr(out_lens)))


def rans_decompress_native(blob: bytes, out_size: int) -> bytes:
    """Decode one rANS 4x8 stream (its 9-byte header included) into
    ``out_size`` bytes, as the reference's ``rans_decompress_native``
    does. Raises ``IOError`` when the decoder refuses the bytes."""
    lib = load_rans()
    data = np.frombuffer(blob, dtype=np.uint8)
    out = np.empty(out_size, dtype=np.uint8)
    produced = lib.sbt_rans_decompress(_ptr(data), len(data), _ptr(out),
                                       out_size)
    if produced != out_size:
        raise IOError(f"rANS decode produced {produced}, wanted {out_size}")
    return out.tobytes()


# ------------------------------------------------------------ host yardstick

def _flat_args(buf, contig_lengths):
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    lens = np.ascontiguousarray(contig_lengths, dtype=np.int32)
    return buf, lens


def _candidates(candidates) -> np.ndarray:
    cand = np.ascontiguousarray(candidates, dtype=np.int64)
    if len(cand) and int(cand.min()) < 0:
        raise ValueError("candidates are flat offsets (>= 0)")
    return cand


def eager_check_native(buf: np.ndarray, candidates: np.ndarray,
                       contig_lengths: np.ndarray,
                       reads_to_check: int = 10) -> np.ndarray:
    """The eager verdict (bool) at each candidate offset of a flat buffer
    that ends at the file's end (reference eager/Checker.scala)."""
    lib = load_native()
    buf, lens = _flat_args(buf, contig_lengths)
    cand = _candidates(candidates)
    out = np.zeros(len(cand), dtype=np.uint8)
    lib.sbt_eager_check(_ptr(buf), len(buf), _ptr(cand), len(cand),
                        _ptr(lens), len(lens), reads_to_check, _ptr(out))
    return out.astype(bool)


def eager_check_window_native(buf: np.ndarray, candidates: np.ndarray,
                              contig_lengths: np.ndarray,
                              reads_to_check: int = 10,
                              exact_eof: bool = False) -> np.ndarray:
    """Tri-state verdicts (u8) over a bounded window: 0 or 1 when the chain
    resolved on the window's bytes alone, 2 when it met the window's end
    (never 2 with ``exact_eof``: the window ends at the file's end)."""
    lib = load_native()
    buf, lens = _flat_args(buf, contig_lengths)
    cand = _candidates(candidates)
    out = np.zeros(len(cand), dtype=np.uint8)
    lib.sbt_eager_check_window(_ptr(buf), len(buf), _ptr(cand), len(cand),
                               _ptr(lens), len(lens), reads_to_check,
                               1 if exact_eof else 0, _ptr(out))
    return out


def find_record_start_native(buf: np.ndarray, start: int,
                             contig_lengths: np.ndarray,
                             reads_to_check: int = 10,
                             max_read_size: int = 10_000_000) -> int:
    """The first offset at or after ``start`` (within ``max_read_size``)
    whose eager verdict is true, or -1."""
    if start < 0:
        raise ValueError("start is a flat offset (>= 0)")
    lib = load_native()
    buf, lens = _flat_args(buf, contig_lengths)
    return int(lib.sbt_find_record_start(
        _ptr(buf), len(buf), start, _ptr(lens), len(lens), reads_to_check,
        max_read_size))


def find_record_start_window_native(buf: np.ndarray, start: int,
                                    contig_lengths: np.ndarray,
                                    reads_to_check: int = 10,
                                    max_read_size: int = 10_000_000,
                                    exact_eof: bool = False
                                    ) -> tuple[int, int]:
    """``(found, uncertain_at)`` over a bounded window: ``found`` >= 0 is
    the first offset whose chain passed on the window's bytes alone;
    ``(-1, k)`` stops at offset ``k``, the first whose verdict met the
    window's end (every earlier one certainly fails); ``(-1, -1)`` is no
    start in the scanned span."""
    if start < 0:
        raise ValueError("start is a flat offset (>= 0)")
    lib = load_native()
    buf, lens = _flat_args(buf, contig_lengths)
    uncertain = ctypes.c_int64(-1)
    found = int(lib.sbt_find_record_start_window(
        _ptr(buf), len(buf), start, _ptr(lens), len(lens), reads_to_check,
        max_read_size, 1 if exact_eof else 0, ctypes.addressof(uncertain)))
    return found, int(uncertain.value)


def _block_table(comp, offsets, lengths, out_offsets, out_lengths, out_size):
    """The five block columns as contiguous int64 arrays, each payload
    inside ``comp`` and each output range inside ``out_size`` bytes."""
    cols = [np.ascontiguousarray(c, dtype=np.int64)
            for c in (offsets, lengths, out_offsets, out_lengths)]
    off, ln, oo, ol = cols
    if not len(off) == len(ln) == len(oo) == len(ol):
        raise ValueError("one offset, length, out_offset and out_length a "
                         "block")
    if len(off) and (int(off.min()) < 0 or int(ln.min()) < 0
                     or int((off + ln).max()) > len(comp)):
        raise ValueError("a payload lies outside comp")
    if len(oo) and (int(oo.min()) < 0 or int(ol.min()) < 0
                    or int((oo + ol).max()) > out_size):
        raise ValueError("an output range lies outside out")
    return cols


def inflate_blocks_fast_into(comp: np.ndarray, offsets: np.ndarray,
                             lengths: np.ndarray, out: np.ndarray,
                             out_offsets: np.ndarray,
                             out_lengths: np.ndarray) -> bool:
    """Inflate raw-DEFLATE payloads into ``out`` (a C-contiguous u8 array)
    with the table decoder. Word copies engage only where 8 bytes of room
    remain before the end of ``out``, so an exact-size buffer is fine and
    8 bytes of slack past the last block keep the tail fast. A block the
    decoder refuses is decoded by zlib (a length other than its
    ``out_length`` raises ``IOError``), as the reference's is; returns
    True."""
    if out.dtype != np.uint8 or not out.flags.c_contiguous \
            or not out.flags.writeable:
        raise ValueError("out must be a writable C-contiguous uint8 array")
    lib = load_native()
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    offsets, lengths, out_offsets, out_lengths = _block_table(
        comp, offsets, lengths, out_offsets, out_lengths, len(out))
    count, start = len(offsets), 0
    while start < count:
        rc = lib.sbt_inflate_blocks_fast(
            _ptr(comp), _ptr(offsets[start:]), _ptr(lengths[start:]),
            count - start, _ptr(out), _ptr(out_offsets[start:]),
            _ptr(out_lengths[start:]), len(out))
        if rc == 0:
            return True
        i = start + int(rc) - 1
        o, n = int(offsets[i]), int(lengths[i])
        data = zlib.decompress(comp[o: o + n].tobytes(), -15)
        if len(data) != int(out_lengths[i]):
            raise IOError(f"inflate produced {len(data)} bytes, footer says "
                          f"{int(out_lengths[i])}")
        oo = int(out_offsets[i])
        out[oo: oo + len(data)] = np.frombuffer(data, dtype=np.uint8)
        start = i + 1
    return True


def inflate_blocks_native(comp: np.ndarray, offsets: np.ndarray,
                          lengths: np.ndarray,
                          out_lengths: np.ndarray) -> np.ndarray:
    """Inflate raw-DEFLATE payloads with zlib into one flat buffer, block
    after block; a payload that does not inflate to its ``out_length``
    raises ``IOError``."""
    lib = load_zlib()
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    out_lengths = np.ascontiguousarray(out_lengths, dtype=np.int64)
    out_offsets = np.zeros(len(out_lengths), dtype=np.int64)
    np.cumsum(out_lengths[:-1], out=out_offsets[1:])
    out = np.empty(int(out_lengths.sum()), dtype=np.uint8)
    offsets, lengths, out_offsets, out_lengths = _block_table(
        comp, offsets, lengths, out_offsets, out_lengths, len(out))
    rc = lib.sbt_inflate_blocks(_ptr(comp), _ptr(offsets), _ptr(lengths),
                                len(offsets), _ptr(out), _ptr(out_offsets),
                                _ptr(out_lengths))
    if rc != 0:
        raise IOError(f"native inflate failed at block {rc - 1}")
    return out


def tokenize_deflate_native(comp: np.ndarray, offsets: np.ndarray,
                            lengths: np.ndarray, stride: int
                            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``tokenize_deflate`` into fresh ``(lit, dist, out_lens)`` rows of
    ``stride`` tokens (the reference's signature); a refused payload
    raises ``IOError``."""
    count = len(offsets)
    lit = np.empty((count, stride), dtype=np.uint8)
    dist = np.empty((count, stride), dtype=np.uint16)
    out_lens = np.zeros(count, dtype=np.int64)
    rc = tokenize_deflate(comp, offsets, lengths, lit, dist, out_lens)
    if rc != 0:
        raise IOError(f"deflate tokenize failed at block {rc - 1}")
    return lit, dist, out_lens
