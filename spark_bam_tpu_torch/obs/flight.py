"""Flight recorder: a bounded ring of recent request and error events
(reference ``spark_bam_tpu/obs/flight.py``; the same JSONL, so either
package's ``read_dump`` reads the other's dumps).

Failover recovers from a worker's death but loses the explanation: the
SIGKILLed worker's in-flight requests, its last errors. This module keeps a
small always-on ring (one deque append per recorded event; events are per
request, not per row) that can be dumped to a postmortem JSONL:

- the worker dumps on SIGTERM drain and on crash;
- the router dumps on an observed ``WorkerLost`` (the SIGKILL case, where
  the dead worker cannot speak for itself), naming the lost worker and the
  request ids in flight on its link.

Dumps land in ``SPARK_BAM_FLIGHT_DIR``; without it ``dump_auto`` is a no-op,
so normal runs scatter no files. The ring records whether or not the obs
registry is configured.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

FLIGHT_DIR_ENV = "SPARK_BAM_FLIGHT_DIR"
_RING_CAP = 512

# Process-wide dump context: stable facts every artifact must carry to be
# reproducible on its own (the chaos seed and spec, primarily), merged into
# each dump's flight_meta line.
_context: dict = {}
_context_lock = threading.Lock()


def set_context(**fields) -> None:
    """Attach reproducibility facts (e.g. ``chaos_seed``/``chaos_spec``)
    to every subsequent dump from this process."""
    with _context_lock:
        _context.update(fields)


def clear_context(*names) -> None:
    """Drop named context keys (all of them when called bare)."""
    with _context_lock:
        if not names:
            _context.clear()
        for n in names:
            _context.pop(n, None)


def context() -> dict:
    """A snapshot of the current dump context."""
    with _context_lock:
        return dict(_context)


class FlightRecorder:
    """Thread-safe bounded event ring with a JSONL dump."""

    def __init__(self, cap: int = _RING_CAP):
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=cap)
        self.cap = cap

    def record(self, kind: str, **fields) -> None:
        ev = {"e": kind, "t": round(time.time(), 6)}
        for k, v in fields.items():
            ev[k] = (v if isinstance(v, (int, float, str, bool, list, dict,
                                         type(None))) else str(v))
        with self._lock:
            self._ring.append(ev)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self, path, reason: str, extra: dict | None = None) -> str:
        """Write meta + ring to ``path`` as JSONL; returns the path."""
        lines = [json.dumps({
            "e": "flight_meta",
            "version": 1,
            "reason": reason,
            "t": round(time.time(), 6),
            "pid": os.getpid(),
            **context(),
            **(extra or {}),
        })]
        for ev in self.events():
            lines.append(json.dumps(ev))
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return str(path)


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    """The process-wide flight recorder."""
    return _recorder


def record(kind: str, **fields) -> None:
    _recorder.record(kind, **fields)


def dump_path(reason: str, who: str | None = None) -> str | None:
    """Where an automatic dump for ``reason`` would land, or None when
    ``SPARK_BAM_FLIGHT_DIR`` is unset (auto-dumping disabled)."""
    d = os.environ.get(FLIGHT_DIR_ENV)
    if not d:
        return None
    tag = f"-{who}" if who else ""
    return os.path.join(d, f"flight-{os.getpid()}{tag}-{reason}.jsonl")


def dump_auto(reason: str, who: str | None = None,
              extra: dict | None = None) -> str | None:
    """Dump the ring if ``SPARK_BAM_FLIGHT_DIR`` is configured.

    Never raises: a postmortem writer that crashes the postmortem path
    would be worse than no artifact.
    """
    path = dump_path(reason, who)
    if path is None:
        return None
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return _recorder.dump(path, reason, extra=extra)
    except OSError:
        return None


def read_dump(path) -> list[dict]:
    """Parse a flight dump back into event dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
