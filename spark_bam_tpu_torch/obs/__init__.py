"""Counters, gauges, histograms and timed spans (a minimal counterpart of
the reference's ``spark_bam_tpu/obs`` registry).

Every entry point is a no-op until ``configure()`` installs a process-wide
``Registry``; ``registry()`` is None until then. The serve daemon's
``stats`` op reads ``load.split_resolutions`` from it, so a warm plan can
be shown to resolve nothing. ``account`` is the per-request cost
accountant the daemon always runs. Trace context, exporters, rings and
the SLO engine of the reference are not part of this port.
"""

from __future__ import annotations

import contextlib
import threading
import time

_VALUES_CAP = 4096


class Counter:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("name", "value", "max")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.max = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.max:
            self.max = v


class Histogram:
    """Count, sum, min, max and the last ``_VALUES_CAP`` observations."""

    __slots__ = ("name", "count", "sum", "min", "max", "values", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.values: list = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.values.append(v)
            if len(self.values) > _VALUES_CAP:
                del self.values[: len(self.values) - _VALUES_CAP]


class Registry:
    """Named series, created on first use. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}

    def _get(self, table: dict, cls, name: str):
        with self._lock:
            m = table.get(name)
            if m is None:
                m = table[name] = cls(name)
            return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, Gauge, name)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._hists, Histogram, name)

    def snapshot(self) -> dict:
        """Every series as plain values, in the reference's layout."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._hists.values())
        return {
            "counters": [{"name": c.name, "labels": {}, "value": c.value}
                         for c in counters],
            "gauges": [{"name": g.name, "labels": {}, "value": g.value,
                        "max": g.max} for g in gauges],
            "hists": [{"name": h.name, "labels": {}, "count": h.count,
                       "sum": h.sum, "min": h.min, "max": h.max,
                       "values": list(h.values)} for h in hists],
        }


class _Noop:
    """The shared metric while no registry is configured."""

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v=None) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


NOOP = _Noop()
_registry: Registry | None = None
_lock = threading.Lock()


def configure() -> Registry:
    """Install a fresh process-wide registry and return it."""
    global _registry
    with _lock:
        _registry = Registry()
        return _registry


def shutdown() -> None:
    global _registry
    with _lock:
        _registry = None


def registry() -> Registry | None:
    return _registry


def gauge(name: str):
    reg = _registry
    return reg.gauge(name) if reg is not None else NOOP


def count(name: str, n: int = 1) -> None:
    reg = _registry
    if reg is not None:
        reg.counter(name).inc(n)


def observe(name: str, v: float) -> None:
    reg = _registry
    if reg is not None:
        reg.histogram(name).observe(v)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time the block into the ``<name>.ms`` histogram (attributes are
    accepted and dropped: this registry keeps no span events)."""
    reg = _registry
    if reg is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        reg.histogram(name + ".ms").observe(
            (time.perf_counter() - t0) * 1e3)
