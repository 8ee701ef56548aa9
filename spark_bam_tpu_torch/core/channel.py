"""Byte channels: positioned, random-access byte sources (reference
``spark_bam_tpu/core/channel.py``), the one IO seam of the port.

- ``ByteChannel``: the base. A backend overrides ``_read_at`` (one
  positioned read, short at EOF) and ``size``; ``read_at`` is the bulk
  primitive concurrent readers share (it moves no cursor), and the cursor
  API (``seek``, ``read``, ``read_fully`` raising ``EOFError``, the
  little-endian ints) serves one reader at a time.
- ``MMapChannel`` (alias ``FileChannel``): a local file, served from an
  mmap. Its ``read_at`` returns a zero-copy ``memoryview``; a remote
  channel returns ``bytes``. Every consumer takes either: none keeps a
  view past its channel's life, and no view or GET buffer is the source
  of an asynchronous host-to-device copy (the device staging copies into
  fresh arrays or pinned slots first, ``tpu/inflate.py``).
- ``FileStreamChannel``: any seekable file object.
- ``CachingChannel``: an LRU cache of aligned chunks over another channel.

``open_channel`` routes ``http(s)://`` URLs to ``core/remote.py``'s
``HttpRangeChannel`` behind the remote data plane (``core/remote_plan.py``:
plan-driven coalesced prefetch, or the legacy cursor read-ahead under
``--remote mode=legacy``), ``gs://`` and ``s3://`` to ``core/cloud.py``,
and any other ``scheme://`` to a factory given to ``register_scheme``.
When ``core/faults.py`` installs chaos, every channel it hands out is
wrapped in a ``ChaosChannel``.
"""

from __future__ import annotations

import inspect
import io
import mmap
import os
import re
import struct
import threading
from collections import OrderedDict


class ByteChannel:
    """Positioned byte source. ``read_fully`` raises EOFError on a short
    read."""

    def __init__(self):
        self._pos = 0

    # -- the backend's surface ------------------------------------------
    def _read_at(self, pos: int, n: int):
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass

    # -- shared behaviour -----------------------------------------------
    def read_at(self, pos: int, n: int):
        """Up to ``n`` bytes at ``pos`` (short at EOF); moves no cursor."""
        return self._read_at(pos, n)

    def position(self) -> int:
        return self._pos

    def seek(self, pos: int) -> None:
        self._pos = pos

    def skip(self, n: int) -> None:
        self._pos += n

    def read(self, n: int):
        """Up to ``n`` bytes at the cursor (short at EOF)."""
        data = self._read_at(self._pos, n)
        self._pos += len(data)
        return data

    def read_fully(self, n: int):
        data = self.read(n)
        if len(data) != n:
            raise EOFError(
                f"wanted {n} bytes at {self._pos - len(data)}, got {len(data)}")
        return data

    def read_u8(self) -> int:
        return self.read_fully(1)[0]

    def read_i32(self) -> int:
        return struct.unpack("<i", self.read_fully(4))[0]

    def read_u16(self) -> int:
        return struct.unpack("<H", self.read_fully(2))[0]

    def read_u64(self) -> int:
        return struct.unpack("<Q", self.read_fully(8))[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MMapChannel(ByteChannel):
    """A local file through an mmap: ``read_at`` is a zero-copy view."""

    def __init__(self, path):
        super().__init__()
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        self._size = os.fstat(self._f.fileno()).st_size
        self._mm = (
            mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
            if self._size else None
        )

    def _read_at(self, pos: int, n: int) -> memoryview:
        if self._mm is None or pos >= self._size or n <= 0:
            return memoryview(b"")
        return memoryview(self._mm)[pos: min(pos + n, self._size)]

    @property
    def size(self) -> int:
        return self._size

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


#: The local channel's earlier name.
FileChannel = MMapChannel


class FileStreamChannel(ByteChannel):
    """Positioned reads over any seekable file object (seek and read under
    one lock)."""

    def __init__(self, fobj: io.RawIOBase, size: int | None = None):
        super().__init__()
        self._f = fobj
        self._size = size
        self._io_lock = threading.Lock()

    def _read_at(self, pos: int, n: int) -> bytes:
        with self._io_lock:
            self._f.seek(pos)
            return self._f.read(n) or b""

    @property
    def size(self) -> int:
        if self._size is None:
            with self._io_lock:
                if self._size is None:
                    cur = self._f.tell()
                    self._size = self._f.seek(0, io.SEEK_END)
                    self._f.seek(cur)
        return self._size

    def close(self) -> None:
        self._f.close()


class CachingChannel(ByteChannel):
    """An LRU cache of fixed, aligned chunks over another channel (the
    reference's ``CachingChannel``, load/.../Channels.scala:9-27)."""

    def __init__(self, inner: ByteChannel, chunk_size: int = 256 << 10,
                 max_chunks: int = 64):
        super().__init__()
        self.inner = inner
        self.chunk_size = chunk_size
        self.max_chunks = max_chunks
        self._cache: OrderedDict[int, bytes] = OrderedDict()
        self._cache_lock = threading.Lock()

    def _chunk(self, idx: int) -> bytes:
        with self._cache_lock:
            chunk = self._cache.get(idx)
            if chunk is not None:
                self._cache.move_to_end(idx)
                return chunk
        # Fetched outside the lock: two misses of one chunk may both fetch
        # it (the last one stays).
        chunk = bytes(self.inner._read_at(idx * self.chunk_size,
                                          self.chunk_size))
        with self._cache_lock:
            self._cache[idx] = chunk
            if len(self._cache) > self.max_chunks:
                self._cache.popitem(last=False)
        return chunk

    def _read_at(self, pos: int, n: int) -> bytes:
        out = []
        remaining = n
        while remaining > 0:
            idx, off = divmod(pos, self.chunk_size)
            piece = self._chunk(idx)[off: off + remaining]
            if not piece:
                break
            out.append(piece)
            pos += len(piece)
            remaining -= len(piece)
        return b"".join(out)

    @property
    def size(self) -> int:
        return self.inner.size

    def close(self) -> None:
        self.inner.close()


# URL scheme → channel factory (``register_scheme``; tests register
# latency-injected fakes, deployments their own stores).
_SCHEMES: dict = {}

# The chaos seam (``core/faults.py::install_chaos``): when set, every
# channel ``open_channel`` hands out goes through it.
_CHAOS_WRAPPER = None

_URL_RE = re.compile(r"^([a-z][a-z0-9+.-]*)://")


def set_chaos_wrapper(wrapper) -> None:
    """Install ``wrapper(ch, path) -> ByteChannel`` over every opened
    channel; ``None`` uninstalls."""
    global _CHAOS_WRAPPER
    _CHAOS_WRAPPER = wrapper


def register_scheme(scheme: str, factory) -> None:
    """Serve ``scheme://`` paths with ``factory(url) -> ByteChannel``."""
    _SCHEMES[scheme] = factory


def _ensure_builtin_scheme(scheme: str) -> None:
    """Load the built-in ``gs`` and ``s3`` backends on first use (their
    module registers both; an explicit registration wins)."""
    if scheme in ("gs", "s3") and scheme not in _SCHEMES:
        import spark_bam_tpu_torch.core.cloud  # noqa: F401


def is_url(path) -> bool:
    return bool(_URL_RE.match(str(path)))


def _raw_url_channel(url: str) -> ByteChannel:
    """The bare backend of a URL, without read-ahead: for a size probe or
    one ranged GET."""
    scheme = _URL_RE.match(url).group(1)
    _ensure_builtin_scheme(scheme)
    if scheme in _SCHEMES:
        fn = _SCHEMES[scheme]
        if "prefetch" in inspect.signature(fn).parameters:
            return fn(url, prefetch=False)
        return fn(url)
    if scheme in ("http", "https"):
        from spark_bam_tpu_torch.core.remote import HttpRangeChannel

        return HttpRangeChannel(url)
    raise ValueError(f"no channel backend for scheme {scheme!r}: {url}")


def path_size(path) -> int:
    """Byte size of a path or URL."""
    if is_url(path):
        with _raw_url_channel(str(path)) as ch:
            return ch.size
    return os.path.getsize(os.fspath(path))


def read_text(path) -> str:
    """The whole text of a path or URL (the ``.blocks`` and ``.records``
    sidecars)."""
    if is_url(path):
        with _raw_url_channel(str(path)) as ch:
            return bytes(ch.read_at(0, ch.size)).decode()
    with open(os.fspath(path), "rt") as f:
        return f.read()


def path_exists(path) -> bool:
    """Whether a path or URL exists. A URL is probed for its size: only a
    definite "missing" (``FileNotFoundError``, an HTTP 404) reads as
    absent; a transport or auth failure raises."""
    if is_url(path):
        try:
            with _raw_url_channel(str(path)) as ch:
                return ch.size >= 0
        except FileNotFoundError:
            return False
    return os.path.exists(os.fspath(path))


def open_channel(path, cached: bool = False) -> ByteChannel:
    """A channel over a local path or a URL, behind the chaos seam when
    chaos is installed, and behind a ``CachingChannel`` when ``cached``."""
    s = os.fspath(path) if not isinstance(path, str) else path
    m = _URL_RE.match(s)
    if m:
        scheme = m.group(1)
        _ensure_builtin_scheme(scheme)
        if scheme in _SCHEMES:
            ch: ByteChannel = _SCHEMES[scheme](s)
        elif scheme in ("http", "https"):
            from spark_bam_tpu_torch.core.remote import HttpRangeChannel
            from spark_bam_tpu_torch.core.remote_plan import wrap_remote

            ch = wrap_remote(HttpRangeChannel(s))
        else:
            raise ValueError(f"no channel backend for scheme {scheme!r}: {s}")
    else:
        ch = MMapChannel(s)
    if _CHAOS_WRAPPER is not None:
        ch = _CHAOS_WRAPPER(ch, s)
    return CachingChannel(ch) if cached else ch
