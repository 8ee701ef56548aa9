"""The job journal and segmented output (reference ``spark_bam_tpu/jobs/
journal.py``), in the reference's formats: either package reads, recovers
and resumes the other's.

The journal is JSONL with a checksum frame a line::

    SBJ1 <crc32:08x> <json>\\n

- Every record is a JSON object with a ``"t"`` tag ("spec", "ckpt",
  "seg", "done", "note"). A reader skips tags it does not know, as the
  ``.sbi`` container does.
- Recovery truncates a torn tail: appends are fsynced, but a crash (or
  an injected torn write, ``core/faults.py``) can leave a partial last
  line. The first line that fails its frame (magic, CRC, JSON, newline)
  ends the valid prefix, and the file is cut back to it.
- A non-empty file that does not start with the magic is not a journal:
  :class:`JournalError`, never a truncation of somebody else's file.

Output lands in committed segment files (``seg-00000``, ``seg-00001``,
...) through :class:`SegmentedOutput`: each is written as ``.part``,
fsynced, size-checked and renamed into place, and only then does the
journal record the checkpoint that covers it. Resume keeps every
committed segment, deletes orphaned ``.part`` files (the work past the
last checkpoint, counted as ``jobs.redone_bytes``) and restarts the
producer from the checkpointed state.
"""

from __future__ import annotations

import json
import os
import zlib

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core import faults as _faults
from spark_bam_tpu_torch.core.atomic import AtomicFile, fsync_dir, map_write_error

MAGIC = "SBJ1"
#: tags this version understands; anything else is skipped on read.
KNOWN_TAGS = frozenset({"spec", "ckpt", "seg", "done", "note"})


class JournalError(ValueError):
    """The file at the journal path is not a journal (no magic at offset
    0): deterministic, never retried, never truncated."""


def _frame(record: dict) -> bytes:
    payload = json.dumps(
        record, separators=(",", ":"), sort_keys=True
    ).encode("utf-8")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return b"%s %08x %s\n" % (MAGIC.encode(), crc, payload)


def _parse_line(line: bytes) -> "dict | None":
    """One framed line → its record, or ``None`` when the frame is invalid
    (a torn tail or a flipped byte)."""
    if not line.endswith(b"\n"):
        return None
    body = line[:-1]
    parts = body.split(b" ", 2)
    if len(parts) != 3 or parts[0] != MAGIC.encode():
        return None
    try:
        crc = int(parts[1], 16)
    except ValueError:
        return None
    if len(parts[1]) != 8 or (zlib.crc32(parts[2]) & 0xFFFFFFFF) != crc:
        return None
    try:
        record = json.loads(parts[2])
    except ValueError:
        return None
    return record if isinstance(record, dict) else None


def read_journal(path) -> "list[dict]":
    """The known-tag records of a journal's durable prefix, in order, with
    the file untouched; unknown tags are counted (``jobs.journal_skipped``)
    and dropped. Raises :class:`JournalError` on a non-empty file without
    the magic."""
    records, _ = _scan(path)
    return records


def _scan(path) -> "tuple[list[dict], int]":
    """(known-tag records of the valid prefix, the prefix's length)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return [], 0
    if raw and not raw.startswith(MAGIC.encode() + b" "):
        raise JournalError(
            f"{path} is not a job journal (missing {MAGIC!r} magic); "
            "refusing to recover over a foreign file"
        )
    records: "list[dict]" = []
    good = 0
    pos = 0
    while pos < len(raw):
        nl = raw.find(b"\n", pos)
        line = raw[pos: nl + 1] if nl >= 0 else raw[pos:]
        record = _parse_line(line)
        if record is None:
            break  # a torn tail or a flipped byte: the prefix ends here
        pos = nl + 1
        good = pos
        if record.get("t") in KNOWN_TAGS:
            records.append(record)
        else:
            obs.count("jobs.journal_skipped")
    return records, good


class Journal:
    """Append-only journal, fsynced a record, with torn-tail recovery.

    ``Journal.open`` cuts a torn tail back to the last valid line
    (counting ``jobs.journal_truncated``) and exposes the surviving
    records as ``.records``. Appends go through the disk-fault seam."""

    def __init__(self, path, records: "list[dict]", f):
        self.path = str(path)
        self.records = records
        self._f = f

    @classmethod
    def open(cls, path) -> "Journal":
        records, good = _scan(path)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size > good:
            # The magic check in _scan made sure this is a journal.
            with open(path, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())
            obs.count("jobs.journal_truncated")
        f = _faults.wrap_disk(open(path, "ab"))
        return cls(path, records, f)

    def append(self, record: dict) -> None:
        """Durably append one record (write, flush, fsync). A failed write
        maps through ``map_write_error``: a full disk pauses the job, and
        the torn frame is cut at the next recovery."""
        data = _frame(record)
        try:
            self._f.write(data)
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError as exc:
            raise map_write_error(
                exc, "journal append", path=self.path
            ) from exc
        self.records.append(record)
        obs.count("jobs.journal_appends")

    def last(self, tag: str) -> "dict | None":
        for record in reversed(self.records):
            if record.get("t") == tag:
                return record
        return None

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class SegmentedOutput:
    """Checkpointed output: bytes land in ``seg-NNNNN`` files, each
    committed (fsync, size check, rename, directory fsync) before the
    journal records the checkpoint that covers it."""

    def __init__(self, directory):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self._f = None
        self._index = -1
        self._written = 0

    def _name(self, index: int) -> str:
        return os.path.join(self.dir, f"seg-{index:05d}")

    def committed(self) -> "list[str]":
        """Committed segment paths in order, up to the first gap."""
        out = []
        i = 0
        while os.path.exists(self._name(i)):
            out.append(self._name(i))
            i += 1
        return out

    def discard_parts(self) -> int:
        """Delete orphaned ``.part`` files (work past the last durable
        checkpoint); returns their bytes, the resume's ``redone_bytes``."""
        lost = 0
        try:
            entries = os.listdir(self.dir)
        except OSError:
            return 0
        for name in entries:
            if name.endswith(".part"):
                full = os.path.join(self.dir, name)
                try:
                    lost += os.path.getsize(full)
                    os.unlink(full)
                except OSError:
                    pass
        return lost

    def begin(self, index: int):
        """Open ``seg-<index>.part`` for writing, behind the seam."""
        assert self._f is None, "previous segment not committed or aborted"
        self._index = index
        self._written = 0
        path = self._name(index) + ".part"
        try:
            self._f = _faults.wrap_disk(open(path, "wb"))
        except OSError as exc:
            raise map_write_error(
                exc, "segment open", path=path
            ) from exc
        return self._f

    def write(self, data: bytes) -> None:
        try:
            self._f.write(data)
        except OSError as exc:
            raise map_write_error(
                exc, "segment write", path=self._name(self._index) + ".part"
            ) from exc
        self._written += len(data)

    def commit(self) -> "tuple[str, int]":
        """Durably commit the open segment: flush and fsync, check that the
        file holds the bytes handed to :meth:`write` (a silently torn write
        fails here), rename ``.part`` to its final name, fsync the
        directory. Returns (path, bytes)."""
        part = self._name(self._index) + ".part"
        final = self._name(self._index)
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
            size = os.fstat(self._f.fileno()).st_size
            self._f.close()
            if size != self._written:
                raise OSError(
                    5,  # EIO: the device lied about a write
                    f"segment {part}: wrote {self._written} bytes, "
                    f"disk holds {size}",
                )
            _faults.disk_replace(part, final)
            fsync_dir(final)
        except OSError as exc:
            self.abort()
            raise map_write_error(exc, "segment commit", path=part) from exc
        self._f = None
        n, self._written = self._written, 0
        return final, n

    def abort(self) -> None:
        if self._f is None:
            return
        try:
            self._f.close()
        except OSError:
            pass
        try:
            os.unlink(self._name(self._index) + ".part")
        except OSError:
            pass
        self._f = None

    def assemble(self, out_path) -> int:
        """The committed segments concatenated into the final artifact,
        atomically (``core/atomic.py``); returns its bytes."""
        total = 0
        out = AtomicFile(out_path)
        try:
            for seg in self.committed():
                with open(seg, "rb") as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        out.f.write(chunk)
                        total += len(chunk)
            out.commit()
        except OSError as exc:
            out.abort()
            raise map_write_error(
                exc, "artifact assembly", path=out_path
            ) from exc
        except BaseException:
            out.abort()
            raise
        return total

    def remove(self) -> None:
        """Delete the segment files (after a successful assembly)."""
        for seg in self.committed():
            try:
                os.unlink(seg)
            except OSError:
                pass
