"""Serve fabric: the control plane above the serve daemon (reference
``spark_bam_tpu/fabric/``, its protocol unchanged).

A router with file-path affinity fronts N serve workers (one per host over
``torch.distributed``, or N local processes), each running its own accept
loop, mesh steps, flat-view LRU and ``.sbi`` warm tier. Health probes drive
a per-link circuit breaker (closed, open, half-open, with flap hold-down); a
worker dying mid-request fails idempotent ops over to another worker under
a router-wide retry budget, byte for byte, and with ``stream=1`` even
mid-stream through ``resume_from`` tokens. A seeded chaos layer
(``chaos=SEED:SPEC``, ``fabric/chaos.py``) attacks all of it
deterministically. ``python -m spark_bam_tpu_torch fabric`` runs it.
"""

from spark_bam_tpu_torch.fabric.autoscaler import autoscale_worker, decide
from spark_bam_tpu_torch.fabric.chaos import (
    ChaosStorm,
    ChaosWorkerLink,
    FabricChaos,
    FabricChaosSpec,
    parse_fabric_chaos,
    storm_schedule,
)
from spark_bam_tpu_torch.fabric.config import FabricConfig
from spark_bam_tpu_torch.fabric.health import monitor_worker
from spark_bam_tpu_torch.fabric.resilience import (
    CircuitBreaker,
    RetryBudget,
    brownout_level,
)
from spark_bam_tpu_torch.fabric.router import (
    IDEMPOTENT_OPS,
    Router,
    WorkerLink,
    WorkerLost,
    rendezvous_weight,
)
from spark_bam_tpu_torch.fabric.worker import WorkerPool, serve_worker

__all__ = [
    "ChaosStorm",
    "ChaosWorkerLink",
    "CircuitBreaker",
    "FabricChaos",
    "FabricChaosSpec",
    "FabricConfig",
    "IDEMPOTENT_OPS",
    "RetryBudget",
    "Router",
    "WorkerLink",
    "WorkerLost",
    "WorkerPool",
    "autoscale_worker",
    "brownout_level",
    "decide",
    "monitor_worker",
    "parse_fabric_chaos",
    "rendezvous_weight",
    "serve_worker",
    "storm_schedule",
]
