"""Fabric control-plane knobs: pool size, latency target, probe and eject
pacing (reference ``spark_bam_tpu/fabric/config.py``: the same keys,
aliases, defaults and refusal messages).

Parsed from the compact ``k=v,...`` spec pattern of ``ServeConfig`` and
``FaultPolicy``, so it threads through ``Config.fabric``,
``SPARK_BAM_FABRIC`` and ``--fabric`` unchanged. The floors and ceilings
bound what the autoscaler may ``tune`` on each worker; the worker applies
whatever it is told, so the bounds live here, in the controller.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache


@dataclass(frozen=True)
class FabricConfig:
    """Knobs for the serve fabric (router, health, autoscaler)."""

    workers: int = 3              # serve workers to launch (local pool mode)
    slo_p99_ms: float = 500.0     # autoscaler target for per-worker p99
    probe_ms: float = 500.0       # health-probe period per healthy worker
    probe_timeout_ms: float = 3000.0  # ping timeout before ejection
    eject_ms: float = 250.0       # first re-probe delay after ejection
    eject_max_ms: float = 8000.0  # re-probe backoff ceiling (doubles)
    autoscale_ms: float = 1000.0  # control-loop period per worker
    spill: int = 8                # affinity target inflight before spillover
    # --- resilience (fabric/resilience.py) ---
    budget: int = 32              # retry-budget token-bucket capacity
    budget_rate: float = 0.1      # tokens earned per admitted request
    flap_k: int = 4               # breaker openings within flap_window_ms ...
    flap_window_ms: float = 10_000.0  # ... that trigger hold-down
    holddown_ms: float = 5000.0   # re-probe floor while flapping
    brownout: int = 0             # opt-in: shed by class when unhealthy
    brownout_frac: float = 0.5    # healthy fraction at/below which to shed
    # --- streaming failover + chaos (both opt-in; zero cost unset) ---
    stream: int = 0               # relay batch frames as they arrive
    chaos: str = ""               # "SEED:SPEC" (fabric/chaos.py grammar)
    # --- descriptor relay (serve/shm.py; needs stream=1) ---
    shm: int = 1                  # offer transport=shm to router clients
    # --- autoscaler actuation bounds (per worker, via the ``tune`` op) ---
    batch_floor: int = 1          # batch_rows floor (mesh-rounded upward)
    batch_ceil: int = 64          # batch_rows ceiling
    tick_floor: float = 0.0       # tick_ms floor
    tick_ceil: float = 20.0       # tick_ms ceiling
    scanq_floor: int = 4          # scan admission-cap floor
    scanq_ceil: int = 256         # scan admission-cap ceiling
    planq_floor: int = 4          # plan admission-cap floor
    planq_ceil: int = 256         # plan admission-cap ceiling

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"fabric workers must be >= 1: {self.workers}")
        if self.slo_p99_ms <= 0:
            raise ValueError(f"fabric slo must be > 0 ms: {self.slo_p99_ms}")
        for name in ("probe_ms", "probe_timeout_ms", "eject_ms",
                     "eject_max_ms", "autoscale_ms"):
            if getattr(self, name) <= 0:
                raise ValueError(
                    f"fabric {name} must be > 0: {getattr(self, name)}"
                )
        if self.eject_max_ms < self.eject_ms:
            raise ValueError(
                f"fabric eject_max {self.eject_max_ms} must be >= "
                f"eject {self.eject_ms}"
            )
        if self.spill < 1:
            raise ValueError(f"fabric spill must be >= 1: {self.spill}")
        if self.budget < 0 or self.budget_rate < 0:
            raise ValueError(
                f"fabric budget/budget_rate must be >= 0: "
                f"{self.budget}/{self.budget_rate}"
            )
        if self.flap_k < 1:
            raise ValueError(f"fabric flap_k must be >= 1: {self.flap_k}")
        if self.flap_window_ms <= 0 or self.holddown_ms <= 0:
            raise ValueError(
                f"fabric flap_window/holddown must be > 0 ms: "
                f"{self.flap_window_ms}/{self.holddown_ms}"
            )
        if not 0.0 < self.brownout_frac <= 1.0:
            raise ValueError(
                f"fabric brownout_frac must be in (0, 1]: {self.brownout_frac}"
            )
        if self.chaos:
            # Validate the sub-spec eagerly so a mistyped --fabric fails at
            # parse time, not mid-storm (a local import keeps the
            # unconfigured path lean).
            from spark_bam_tpu_torch.fabric.chaos import parse_fabric_chaos
            parse_fabric_chaos(self.chaos)
        for lo, hi in (("batch_floor", "batch_ceil"),
                       ("tick_floor", "tick_ceil"),
                       ("scanq_floor", "scanq_ceil"),
                       ("planq_floor", "planq_ceil")):
            if getattr(self, lo) > getattr(self, hi):
                raise ValueError(
                    f"fabric {lo} {getattr(self, lo)} exceeds "
                    f"{hi} {getattr(self, hi)}"
                )
        if self.batch_floor < 1 or self.scanq_floor < 1 or self.planq_floor < 1:
            raise ValueError("fabric batch/scanq/planq floors must be >= 1")
        if self.tick_floor < 0:
            raise ValueError(f"fabric tick_floor must be >= 0: {self.tick_floor}")

    _KEYS = {
        "workers": "workers",
        "slo": "slo_p99_ms",
        "slo_p99_ms": "slo_p99_ms",
        "probe": "probe_ms",
        "probe_ms": "probe_ms",
        "probe_timeout": "probe_timeout_ms",
        "probe_timeout_ms": "probe_timeout_ms",
        "eject": "eject_ms",
        "eject_ms": "eject_ms",
        "eject_max": "eject_max_ms",
        "eject_max_ms": "eject_max_ms",
        "autoscale": "autoscale_ms",
        "autoscale_ms": "autoscale_ms",
        "spill": "spill",
        "budget": "budget",
        "budget_rate": "budget_rate",
        "flap_k": "flap_k",
        "flap_window": "flap_window_ms",
        "flap_window_ms": "flap_window_ms",
        "holddown": "holddown_ms",
        "holddown_ms": "holddown_ms",
        "brownout": "brownout",
        "brownout_frac": "brownout_frac",
        "stream": "stream",
        "chaos": "chaos",
        "shm": "shm",
        "batch_floor": "batch_floor",
        "batch_ceil": "batch_ceil",
        "tick_floor": "tick_floor",
        "tick_ceil": "tick_ceil",
        "scanq_floor": "scanq_floor",
        "scanq_ceil": "scanq_ceil",
        "planq_floor": "planq_floor",
        "planq_ceil": "planq_ceil",
    }
    _FLOAT_KEYS = ("slo_p99_ms", "probe_ms", "probe_timeout_ms", "eject_ms",
                   "eject_max_ms", "autoscale_ms", "tick_floor", "tick_ceil",
                   "budget_rate", "flap_window_ms", "holddown_ms",
                   "brownout_frac")
    _STR_KEYS = ("chaos",)

    @staticmethod
    @lru_cache(maxsize=64)
    def parse(spec: str) -> "FabricConfig":
        """``"workers=3,slo=200,probe=500,spill=8,batch_ceil=32"`` (any
        subset; ``""`` ⇒ defaults)."""
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"Bad fabric-config entry {part!r} in {spec!r}")
            key, value = (t.strip() for t in part.split("=", 1))
            field = FabricConfig._KEYS.get(key.replace("-", "_"))
            if field is None:
                raise ValueError(
                    f"Unknown fabric-config key {key!r}: expected one of "
                    f"{', '.join(sorted(set(FabricConfig._KEYS)))}"
                )
            if field in FabricConfig._STR_KEYS:
                kw[field] = value
            elif field in FabricConfig._FLOAT_KEYS:
                kw[field] = float(value)
            else:
                kw[field] = int(value)
        return FabricConfig(**kw)

    @staticmethod
    def from_env(env=None) -> "FabricConfig":
        return FabricConfig.parse(
            (env or os.environ).get("SPARK_BAM_FABRIC", "")
        )
