"""Build the port's CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` file of the package (with the ``csrc/*.cuh`` headers
they share) is compiled by ``nvcc`` for
``sm_90a`` (Hopper) on first use, each source in its own ``nvcc`` process,
all started together, then linked into one shared library with a plain C
interface. The library lands in ``spark_bam_tpu_torch/_build/``, named by a
hash of the sources and flags, so an edited kernel rebuilds and an
unchanged one loads at once. A missing ``nvcc`` or a failed build raises:
there is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# C entry points: name → argtypes (pointers, ints and the stream last).
SIGNATURES = {
    "sbt_prefilter": [_P, _I, _P, _I, _I, _I, _P, _P, _U, _U, _P, _P, _P, _I,
                      _P, _I, _P],
    "sbt_prefilter_ctas": [],
    "sbt_full_flags": [_P, _I, _I, _P, _I, _I, _I, _P, _P, _U, _U, _P, _P],
    "sbt_lz77_resolve": [_P, _P, _I, _P, _P, _P],
    "sbt_tokenize": [_P, _P, _I, _I, _P, _P, _P, _P, _P],
    "sbt_crc32_lanes": [_P, _P, _I, _P, _P, _P],
    "sbt_deflate_fixed_lanes": [_P, _P, _I, _P, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: What the last build printed (``-Xptxas -v``: registers, shared memory and
#: spills per kernel), for the smoke script to show.
build_log: str = ""


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        f"nvcc not found on PATH or in {home}/bin: the CUDA kernels of "
        "spark_bam_tpu_torch are built from source on the GPU host"
    )


def _digest(srcs: list[Path]) -> str:
    """Hash of the flags and of every source and header in ``csrc/``."""
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile (when the sources changed) and return the library's path."""
    global build_log
    srcs = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib_path = BUILD_DIR / f"libsbt_kernels-{_digest(srcs + headers)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [
            (s, subprocess.Popen(
                [nvcc, *ARCH, *FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for s, o in zip(srcs, objs)
        ]
        logs, failed = [], []
        for s, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                failed.append(s.name)
        build_log = "\n".join(logs)
        if failed:
            raise KernelBuildError(f"nvcc failed on {failed}:\n{build_log}")
        staging = Path(tmp) / lib_path.name
        _run([nvcc, *ARCH, "-shared", "-o", str(staging), *map(str, objs)])
        os.replace(staging, lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
