"""Build the host DEFLATE tokenizer (``native/tokenize.cpp``) and bind it
with ctypes.

``g++ -O3 -fPIC -shared`` compiles the source on first use into
``spark_bam_tpu_torch/_build/``, into a library named by a hash of the
source and flags, so an edited source rebuilds and an unchanged one loads
at once (the way ``kernels/build.py`` builds the CUDA kernels). A missing
``g++`` or a failed build raises :class:`NativeBuildError`: nothing falls
back to another tokenizer.

``tokenize_deflate`` calls ``sbt_tokenize_deflate`` on raw-DEFLATE
payloads and writes the token rows into caller-given planes, so a row
range can go straight into a pinned staging buffer. ctypes releases the
GIL for the call: threads tokenize disjoint row ranges at once.
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
BUILD_DIR = HERE.parent / "_build"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: Seconds this process spent compiling the library (0.0 when it found
#: the library already built).
build_seconds: float = 0.0


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the source."""


def _gxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(
            "g++ not found on PATH: the host DEFLATE tokenizer of "
            "spark_bam_tpu_torch is built from source (inflate "
            "tokenize=host)")
    return cxx


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libsbt_tokenize-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile (when the source changed) and return the library's path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    cxx = _gxx()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        staging = Path(tmp) / out.name
        proc = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(staging)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ failed on {SRC.name} ({proc.returncode}):\n"
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
