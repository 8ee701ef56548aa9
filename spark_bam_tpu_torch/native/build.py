"""Build the port's host C++ (the DEFLATE tokenizer ``native/tokenize.cpp``
and the CRAM rANS decoder ``native/rans.cpp``) and bind it with ctypes.

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
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE / "tokenize.cpp"
RANS_SRC = HERE / "rans.cpp"
BUILD_DIR = HERE.parent / "_build"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None        # the tokenizer's
_rans_lib: ctypes.CDLL | None = None
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
            "built from source (the host tokenizer of inflate tokenize=host "
            "and the CRAM rANS decoder)")
    return cxx


def library_path(src: "Path | None" = None) -> Path:
    """Where the library for ``src`` (the tokenizer's by default) and these
    flags lives."""
    src = SRC if src is None else src
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(src.read_bytes())
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
        proc = subprocess.run([cxx, *FLAGS, str(src), "-o", str(staging)],
                              capture_output=True, text=True)
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
