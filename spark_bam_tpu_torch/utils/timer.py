"""Timers, heartbeats and the profiler hook (reference
``spark_bam_tpu/utils/timer.py``), thin shims over ``obs``: a named
``Timer`` feeds its duration into the live registry's ``timer.<name>``
histogram (unit ms), a heartbeat bumps ``progress.beats``, and
``profile_trace`` records a ``torch.profiler`` trace of a block when
``SPARK_BAM_PROFILE_DIR`` is set and does nothing otherwise. New
instrumentation should use ``obs.span``/``obs.count`` directly.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

from spark_bam_tpu_torch import obs

log = logging.getLogger(__name__)


class Timer:
    """Named stage timer: ``with Timer("x") as t: ...``, then ``t.seconds``
    (float) or ``t.ms``; ``echo`` (a callable) gets ``"x: 1.234ms"``."""

    def __init__(self, name: str = "", echo=None):
        self.name = name
        self.echo = echo
        self.seconds = 0.0

    @property
    def ms(self) -> float:
        return self.seconds * 1e3

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.name:
            # lint: allow[obs-contract] timer names are literal strings at
            # the Timer(...) call sites, a fixed and reviewed set
            obs.observe(f"timer.{self.name}", self.ms, unit="ms")
            if self.echo is not None:
                self.echo(f"{self.name}: {self.ms:.3f}ms")


@contextlib.contextmanager
def heartbeat(what: str, interval_seconds: float = 10.0):
    """Yields ``beat(progress)``, which counts a beat and logs at most once
    every ``interval_seconds``."""
    last = time.monotonic()

    def beat(progress):
        nonlocal last
        obs.count("progress.beats")
        now = time.monotonic()
        if now - last >= interval_seconds:
            log.info("%s: %s", what, progress)
            last = now

    yield beat


@contextlib.contextmanager
def profile_trace(name: str = "spark-bam-tpu"):
    """A ``torch.profiler`` trace of the block (host and, when a card is
    present, CUDA activity) written as ``<SPARK_BAM_PROFILE_DIR>/<name>/
    trace-<pid>.json`` (Chrome trace format) when that variable is set;
    otherwise nothing."""
    trace_dir = os.environ.get("SPARK_BAM_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(trace_dir, name)
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, f"trace-{os.getpid()}.json"))
