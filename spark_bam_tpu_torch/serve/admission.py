"""Admission control: bounded per-class inflight limits with load
shedding (reference ``spark_bam_tpu/serve/admission.py``).

Three request classes share the daemon: *plan* (split plans, record-start
indexes: bursty, index-bound), *scan* (count verdicts, fleet loads,
batches, aggregates, rewrites: device-bound) and *control* (the
durable-job ops: table lookups and thread starts; the job manager gates
the real capacity). Each has its own inflight cap so
a flood of one class cannot starve the other. Over-limit arrivals are
rejected synchronously with :class:`Overloaded` carrying a Retry-After
hint from the observed service-latency median
(``core.faults.LatencyTracker``).
"""

from __future__ import annotations

import threading

from spark_bam_tpu_torch import obs

#: op → admission class. ping/stats bypass admission entirely.
CLASS_OF = {
    "plan": "plan",
    "record_starts": "plan",
    "count": "scan",
    "fleet": "scan",
    "batch": "scan",
    "aggregate": "scan",
    "rewrite": "scan",
    "submit": "control",
    "job_status": "control",
    "job_cancel": "control",
}


class Overloaded(Exception):
    """Request rejected at admission; retry after ``retry_after_ms``."""

    def __init__(self, klass: str, limit: int, retry_after_ms: float):
        self.klass = klass
        self.limit = limit
        self.retry_after_ms = float(retry_after_ms)
        super().__init__(
            f"{klass} queue full ({limit} inflight); "
            f"retry after {self.retry_after_ms:.0f} ms"
        )


class AdmissionGate:
    """Per-class inflight counters with hard limits.

    ``admit`` either reserves a slot or raises :class:`Overloaded`;
    ``release`` must be called exactly once per successful ``admit``
    (the service does so when the response future resolves).
    """

    def __init__(self, limits: "dict[str, int]"):
        self.limits = dict(limits)
        self._inflight = {k: 0 for k in limits}
        self._lock = threading.Lock()

    def admit(self, klass: str, retry_after_ms: float) -> None:
        with self._lock:
            if self._inflight[klass] >= self.limits[klass]:
                obs.count("serve.overloaded")
                raise Overloaded(klass, self.limits[klass], retry_after_ms)
            self._inflight[klass] += 1
            depth = sum(self._inflight.values())
        obs.gauge("serve.queue_depth").set(depth)

    def set_limit(self, klass: str, limit: int) -> int:
        """Retarget one class's inflight cap (the ``tune`` op / fabric
        autoscaler actuator). In-flight requests above a lowered cap
        drain naturally; only new admissions see the new limit."""
        limit = int(limit)
        if limit < 1:
            raise ValueError(f"admission limit must be >= 1: {limit}")
        with self._lock:
            if klass not in self.limits:
                raise KeyError(klass)
            self.limits[klass] = limit
        return limit

    def release(self, klass: str) -> None:
        with self._lock:
            self._inflight[klass] -= 1
            depth = sum(self._inflight.values())
        obs.gauge("serve.queue_depth").set(depth)

    def inflight(self) -> "dict[str, int]":
        with self._lock:
            return dict(self._inflight)
