"""Atomic file writes (reference ``spark_bam_tpu/core/atomic.py`` and
``core/guard.py::map_write_error``): a same-directory temp file, fsynced
and ``os.replace``d into place on commit, so a crashed writer never
leaves a half-written file at the target path.

The temp name carries the pid, so concurrent writers to one target do
not interleave. Commit fsyncs the file and then the directory that holds
it: ``os.replace`` alone updates the directory in the page cache only.
The writes and the rename go through the disk-fault seam
(``core/faults.py`` ``wrap_disk`` / ``disk_replace``), so the job plane's
tests inject ENOSPC, torn writes and failed renames deterministically.
"""

from __future__ import annotations

import errno
import os

from spark_bam_tpu_torch.core import faults as _faults


def fsync_dir(path: str) -> None:
    """fsync the directory holding ``path``; a platform that refuses to
    open or fsync a directory skips it (the rename stays atomic)."""
    parent = os.path.dirname(os.path.abspath(str(path))) or "."
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(parent, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class AtomicFile:
    """Same-directory temp file, ``os.replace``d into place on commit."""

    def __init__(self, out_path: str):
        self.out_path = str(out_path)
        self.tmp_path = f"{self.out_path}.tmp.{os.getpid()}"
        self.f = _faults.wrap_disk(open(self.tmp_path, "wb"))

    def commit(self) -> None:
        self.f.flush()
        os.fsync(self.f.fileno())
        self.f.close()
        _faults.disk_replace(self.tmp_path, self.out_path)
        fsync_dir(self.out_path)

    def abort(self) -> None:
        try:
            self.f.close()
        finally:
            try:
                os.unlink(self.tmp_path)
            except OSError:
                pass


class ResourceExhausted(OSError):
    """The environment ran out of a resource while an artifact was being
    written: disk space (``ENOSPC``), quota (``EDQUOT``), a failing device
    (``EIO``) or memory. Retryable, unlike a wrong path or permission."""

    def __init__(self, msg: str, *, errno_: "int | None" = None, path=None):
        super().__init__(errno_ or 0, msg, str(path) if path else None)


_EXHAUSTED_ERRNOS = frozenset(
    getattr(errno, name)
    for name in ("ENOSPC", "EDQUOT", "EIO", "ENOMEM")
    if hasattr(errno, name)
)


def map_write_error(exc: OSError, what: str, path=None) -> OSError:
    """An ``OSError`` escaping a writer, classified: the exhaustion errnos
    become :class:`ResourceExhausted`; any other comes back unchanged.
    Callers ``raise map_write_error(e, ...) from e``."""
    if isinstance(exc, ResourceExhausted):
        return exc
    if exc.errno in _EXHAUSTED_ERRNOS:
        return ResourceExhausted(
            f"{what}: {exc.strerror or exc}", errno_=exc.errno, path=path
        )
    return exc
