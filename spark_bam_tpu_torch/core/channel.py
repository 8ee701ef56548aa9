"""Local-file byte channel: positioned reads straight out of an mmap.

Remote channels (http, gs, s3) are not part of this port yet."""

from __future__ import annotations

import mmap
import os


class FileChannel:
    """Read-only positioned access to a local file. ``read_at`` does not
    move any cursor, so concurrent readers may share one channel."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        self.size = os.fstat(self._f.fileno()).st_size
        self._mm = (
            mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
            if self.size else None
        )

    def read_at(self, pos: int, n: int) -> memoryview:
        """Up to ``n`` bytes at ``pos`` (short at EOF), zero-copy."""
        if self._mm is None:
            return memoryview(b"")
        return memoryview(self._mm)[pos: min(pos + n, self.size)]

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # A caller still holds a zero-copy view; the map is freed
                # with the last reference.
                pass
            self._mm = None
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_channel(path) -> FileChannel:
    if "://" in os.fspath(path):
        raise ValueError(
            f"{path}: remote channels are not ported yet; pass a local file"
        )
    return FileChannel(path)
