"""Shared-memory frame transport: ring segments and descriptor records
(reference ``spark_bam_tpu/serve/shm.py``, the same bytes on the wire and
in the segment). Host memory only: nothing here touches the device.

A connection that negotiates ``transport=shm`` in the hello exchange gets
a file-backed ring segment (``/dev/shm`` when present) created by the
server and mapped read-write by the client. Data frames are written once
into the ring; only small *descriptor records* cross the socket, each sent
after its frame's bytes are in the ring, so the client may map the range
the moment the descriptor arrives.

**Record grammar** (one ``kind`` byte, then a kind-specific body):

- ``kind 0`` (inline): ``u64 length`` and that many frame bytes, the
  per-frame fallback (ring full past the ack wait, frame larger than the
  ring, or a severed segment);
- ``kind 1`` (shm ref): ``<u32 seg_id, u64 offset, u64 length, u32 crc>``:
  the frame lives at monotone ring ``offset`` (physical position ``offset
  % capacity``) of segment ``seg_id``; ``crc`` is a guard crc32 over the
  frame's length and its first and last ``GUARD_WINDOW`` bytes;
- ``kind 2`` (segment announce): ``<u32 seg_id, u16 path_len>`` and the
  segment's utf-8 path; announces do not count toward ``binary_frames``.

**Reclaim** (consumer ack): the segment header holds two monotone u64
cursors, ``head`` (written by the server) and ``tail`` (the client's
consumed-through position); the server treats ``head - tail`` as bytes in
flight and waits, up to the ``shm_wait`` knob, for the ring to drain
before it falls back to an inline record.

**Orphans**: segment names embed the creating pid
(``sbt-shm-<pid>-<id>-<nonce>``); the server unlinks on connection close
and ``sweep_orphans`` unlinks segments whose creator is dead.
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
import zlib

from spark_bam_tpu_torch import obs

#: record kinds (first byte of every transport record).
REC_INLINE = 0
REC_SHM = 1
REC_SEGMENT = 2

#: shm-ref descriptor body: seg_id u32, offset u64, length u64, crc u32.
DESC = struct.Struct("<IQQI")
#: segment-announce body prefix: seg_id u32, path_len u16.
SEG = struct.Struct("<IH")
#: inline body prefix (same u64 as classic socket framing).
U64 = struct.Struct("<Q")

#: segment header: magic, version, seg_id, capacity, head, tail.
#: head/tail are 8-byte aligned (offsets 24/32) — single-word cursors
#: the two sides update without locks.
_HDR = struct.Struct("<8sIIQQQ")
_MAGIC = b"SBTSHM1\0"
_VERSION = 1
#: data region starts one page in, leaving the header its own page.
DATA_OFF = 4096
_HEAD_OFF = 24
_TAIL_OFF = 32

#: guard-crc window: first/last N bytes + the length, not the whole
#: frame — the transport check stays O(1) per frame (module docstring).
GUARD_WINDOW = 4096

_PREFIX = "sbt-shm-"


class ShmError(ConnectionError):
    """Client-side shm fault (stale or corrupt descriptor, dead segment).
    A ``ConnectionError`` so the client's reconnect and ``resume_from``
    loop survives it."""


class ChaosTruncation(Exception):
    """Seeded ``shm_trunc`` injection: carries the half-written descriptor
    so the server puts exactly those bytes on the wire, then aborts."""

    def __init__(self, partial: bytes):
        self.partial = partial
        super().__init__("chaos: descriptor truncated mid-record")


def guard_crc(frame) -> int:
    """crc32 over ``len`` + the frame's first/last :data:`GUARD_WINDOW`
    bytes (the whole frame when small)."""
    view = memoryview(frame)
    n = len(view)
    crc = zlib.crc32(U64.pack(n))
    if n <= 2 * GUARD_WINDOW:
        crc = zlib.crc32(view, crc)
    else:
        crc = zlib.crc32(view[:GUARD_WINDOW], crc)
        crc = zlib.crc32(view[n - GUARD_WINDOW:], crc)
    return crc & 0xFFFFFFFF


def pack_inline(frame) -> bytes:
    return b"".join([bytes([REC_INLINE]), U64.pack(len(frame)), bytes(frame)])


def pack_desc(seg_id: int, offset: int, length: int, crc: int) -> bytes:
    return bytes([REC_SHM]) + DESC.pack(seg_id, offset, length, crc)


def pack_segment(seg_id: int, path: str) -> bytes:
    raw = str(path).encode()
    return bytes([REC_SEGMENT]) + SEG.pack(seg_id, len(raw)) + raw


def segment_dir() -> str:
    """Where ring segments live: ``SPARK_BAM_SHM_DIR`` override, else
    ``/dev/shm`` (a real tmpfs — the point), else the temp dir."""
    override = os.environ.get("SPARK_BAM_SHM_DIR")
    if override:
        return override
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    return tempfile.gettempdir()


class SegmentWriter:
    """Server-side ring segment: one per negotiated connection.

    Contiguous allocation with wrap-skip (a frame never straddles the
    ring boundary — the allocator skips the tail fragment instead), so
    every descriptor maps to one contiguous range. ``try_write`` is
    non-blocking: the caller owns the wait-for-ack pacing and the
    inline fallback."""

    def __init__(self, capacity: int, seg_id: int = 1,
                 directory: "str | None" = None):
        self.capacity = max(int(capacity), DATA_OFF)
        self.seg_id = int(seg_id)
        self.head = 0
        self.alive = True
        d = directory or segment_dir()
        nonce = os.urandom(4).hex()
        self.path = os.path.join(
            d, f"{_PREFIX}{os.getpid()}-{self.seg_id}-{nonce}"
        )
        fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, DATA_OFF + self.capacity)
            self._mm = mmap.mmap(fd, DATA_OFF + self.capacity)
        finally:
            os.close(fd)
        _HDR.pack_into(self._mm, 0, _MAGIC, _VERSION, self.seg_id,
                       self.capacity, 0, 0)
        obs.count("serve.shm_segments")

    def _tail(self) -> int:
        (tail,) = U64.unpack_from(self._mm, _TAIL_OFF)
        return tail

    def free_bytes(self) -> int:
        return self.capacity - (self.head - self._tail())

    def try_write(self, frame) -> "tuple[int, int, int, int] | None":
        """Copy ``frame`` into the ring and return its descriptor tuple
        ``(seg_id, offset, length, crc)``, or None when it doesn't fit
        right now (ring backlog) or ever (frame > capacity, or the segment
        closed) — the caller waits or falls back to an inline record."""
        if not self.alive:
            return None
        length = len(frame)
        if length > self.capacity:
            return None
        pos = self.head % self.capacity
        skip = self.capacity - pos if pos + length > self.capacity else 0
        if (self.head - self._tail()) + skip + length > self.capacity:
            return None
        if skip:
            self.head += skip
            pos = 0
        self._mm[DATA_OFF + pos:DATA_OFF + pos + length] = bytes(frame)
        offset = self.head
        self.head += length
        U64.pack_into(self._mm, _HEAD_OFF, self.head)
        return (self.seg_id, offset, length, guard_crc(frame))

    def sever(self) -> None:
        """Kill the segment mid-stream (the ``shm_unlink`` chaos seam):
        unlink the file and stop allocating. Frames already described stay
        readable through the client's mapping; later ones go inline."""
        self.alive = False
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def drained(self) -> bool:
        """True once the consumer's ack cursor has caught up with every
        byte written — the signal that the segment may be unlinked
        without racing a reader that has seen descriptors but not yet
        mapped the file (the relay teardown seam)."""
        return self._tail() >= self.head

    def close(self) -> None:
        self.alive = False
        try:
            self._mm.close()
        except Exception:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


class SegmentReader:
    """Client-side mapping of a server's ring segment (read frames,
    write the ``tail`` ack cursor)."""

    def __init__(self, path: str, seg_id: int):
        self.path = str(path)
        self.seg_id = int(seg_id)
        fd = os.open(self.path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, 0)
        finally:
            os.close(fd)
        magic, version, sid, capacity, _, _ = _HDR.unpack_from(self._mm, 0)
        if magic != _MAGIC or version != _VERSION:
            self._mm.close()
            raise ShmError(f"{self.path}: not a transport segment")
        # ``seg_id`` is the ANNOUNCED id, the key descriptors reference.
        # The header keeps the writer's own id, which a relay may remap,
        # so the two are not compared; the magic and every frame's guard
        # crc catch a wrong-file map.
        self.writer_seg_id = sid
        self.capacity = capacity
        self._acked = 0

    def read(self, offset: int, length: int, crc: int) -> memoryview:
        """Map the described range (zero-copy). Raises :class:`ShmError`
        on a stale descriptor (already reclaimed) or guard-crc mismatch
        — both mean the stream is unsafe and must resume."""
        if length > self.capacity:
            raise ShmError(f"descriptor length {length} exceeds segment")
        if offset < self._acked:
            raise ShmError(
                f"stale descriptor: offset {offset} already acked "
                f"({self._acked})"
            )
        pos = offset % self.capacity
        view = memoryview(self._mm)[DATA_OFF + pos:DATA_OFF + pos + length]
        if guard_crc(view) != crc:
            obs.count("serve.shm_crc_errors")
            raise ShmError(
                f"guard crc mismatch at offset {offset} (+{length})"
            )
        return view

    def ack(self, offset: int, length: int) -> None:
        """Advance the consumed-through cursor — the reclaim signal the
        server's allocator waits on. Monotone; out-of-order acks are
        collapsed to the furthest point."""
        through = offset + length
        if through > self._acked:
            self._acked = through
            U64.pack_into(self._mm, _TAIL_OFF, through)

    def close(self) -> None:
        try:
            self._mm.close()
        except Exception:
            pass


def sweep_orphans(directory: "str | None" = None) -> int:
    """Unlink segments whose creating process is dead (worker start /
    ``serve_worker`` bring-up). Returns how many were removed."""
    d = directory or segment_dir()
    removed = 0
    try:
        names = os.listdir(d)
    except OSError:
        return 0
    for name in names:
        if not name.startswith(_PREFIX):
            continue
        try:
            pid = int(name[len(_PREFIX):].split("-", 1)[0])
        except ValueError:
            continue
        try:
            os.kill(pid, 0)
            continue          # creator alive: not an orphan
        except ProcessLookupError:
            pass
        except OSError:
            continue          # EPERM etc: someone else's live process
        try:
            os.unlink(os.path.join(d, name))
            removed += 1
        except OSError:
            pass
    if removed:
        obs.count("serve.shm_orphans_cleaned", removed)
    return removed
