"""Serving-daemon knobs: batching, admission limits, resident budgets
(reference ``spark_bam_tpu/serve/config.py``: the same keys, defaults and
refusals).

Parsed from the same compact ``k=v,...`` spec pattern as ``FaultPolicy``,
so it threads through ``Config.serve`` / ``SPARK_BAM_SERVE`` / ``--serve``
unchanged. Tuning notes in the reference's docs/serving.md.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

from spark_bam_tpu_torch.core.config import parse_bytes

#: Per-row contig-dictionary capacity of the serve step. Fixed so every
#: batch shares one row shape whichever files it mixes; a file with more
#: contigs is answered with a typed error.
MAX_CONTIGS = 1024


@dataclass(frozen=True)
class ServeConfig:
    """Knobs for the long-running split/record service (serve/)."""

    batch_rows: int = 8           # window rows per device dispatch (rounded
                                  # up to a mesh-size multiple at startup)
    tick_ms: float = 2.0          # batcher gather window after first arrival
    plan_queue: int = 64          # admission cap, plan class (plan/record_starts)
    scan_queue: int = 64          # admission cap, scan class (count/fleet)
    workers: int = 2              # plan-class handler / row-prep threads
    window: int = 1 << 20         # uncompressed bytes per row window
    halo: int = 1 << 16           # trailing lookahead per row
    flat_cache: int = 256 << 20   # resident flat-view byte budget (LRU)
    # --- zero-copy transport (serve/shm.py)
    shm: int = 1                  # offer transport=shm in the hello exchange
    shm_bytes: int = 64 << 20     # ring-segment capacity per connection
    shm_wait_ms: float = 200.0    # ack wait before a full ring goes inline

    def __post_init__(self):
        if self.batch_rows < 1 or self.workers < 1:
            raise ValueError(
                f"serve batch_rows/workers must be >= 1: "
                f"{self.batch_rows}/{self.workers}"
            )
        if self.tick_ms < 0:
            raise ValueError(f"serve tick must be >= 0 ms: {self.tick_ms}")
        if self.plan_queue < 1 or self.scan_queue < 1:
            raise ValueError(
                f"serve queue limits must be >= 1: "
                f"plan={self.plan_queue} scan={self.scan_queue}"
            )
        if self.halo < 1 or self.window <= self.halo:
            raise ValueError(
                f"serve window {self.window} must exceed halo {self.halo} "
                "(>= 1)"
            )
        if self.flat_cache < 1:
            raise ValueError(f"serve flat cache must be >= 1: {self.flat_cache}")
        if self.shm_bytes < 1 << 16:
            raise ValueError(
                f"serve shm_bytes must be >= 64KB: {self.shm_bytes}"
            )
        if self.shm_wait_ms < 0:
            raise ValueError(
                f"serve shm_wait must be >= 0 ms: {self.shm_wait_ms}"
            )

    _KEYS = {
        "batch": "batch_rows",
        "batch_rows": "batch_rows",
        "tick": "tick_ms",
        "tick_ms": "tick_ms",
        "plan_queue": "plan_queue",
        "planq": "plan_queue",
        "scan_queue": "scan_queue",
        "scanq": "scan_queue",
        "workers": "workers",
        "window": "window",
        "halo": "halo",
        "cache": "flat_cache",
        "flat_cache": "flat_cache",
        "shm": "shm",
        "shm_bytes": "shm_bytes",
        "shm_wait": "shm_wait_ms",
        "shm_wait_ms": "shm_wait_ms",
    }
    _BYTE_KEYS = ("window", "halo", "flat_cache", "shm_bytes")

    @staticmethod
    @lru_cache(maxsize=64)
    def parse(spec: str) -> "ServeConfig":
        """``"batch=16,tick=2,scan_queue=128,window=1MB,halo=64KB"`` (any
        subset; ``""`` ⇒ defaults). Byte-valued keys take size shorthand."""
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"Bad serve-config entry {part!r} in {spec!r}")
            key, value = (t.strip() for t in part.split("=", 1))
            field = ServeConfig._KEYS.get(key.replace("-", "_"))
            if field is None:
                raise ValueError(
                    f"Unknown serve-config key {key!r}: expected one of "
                    f"{', '.join(sorted(set(ServeConfig._KEYS)))}"
                )
            if field in ServeConfig._BYTE_KEYS:
                kw[field] = parse_bytes(value)
            elif field in ("tick_ms", "shm_wait_ms"):
                kw[field] = float(value)
            else:
                kw[field] = int(value)
        return ServeConfig(**kw)

    @staticmethod
    def from_env(env=None) -> "ServeConfig":
        return ServeConfig.parse((env or os.environ).get("SPARK_BAM_SERVE", ""))
