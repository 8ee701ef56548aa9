"""The ``.sbi`` split-index cache (reference ``spark_bam_tpu/sbi/``): a
versioned binary sidecar (``sbi.format``) holding the file fingerprint,
BGZF block metadata, resolved split plans and record-start virtual
positions, and a ``CacheStore`` (``sbi.store``) that places sidecars next
to the BAM or content-addressed under ``SPARK_BAM_CACHE_DIR``, validates
on read (stale or corrupt: invalidate and recompute, never a wrong
answer), writes atomically and evicts by LRU under
``SPARK_BAM_CACHE_BUDGET``. ``Config.cache`` / ``SPARK_BAM_CACHE`` /
``--cache`` govern it; the ``index`` command builds sidecars ahead of
time. Sidecars are byte-compatible with the reference package's."""

from spark_bam_tpu_torch.sbi.format import (
    Fingerprint,
    PlanEntry,
    SbiFormatError,
    SbiIndex,
    config_digest,
    decode_sbi,
    encode_sbi,
    fingerprint_of,
)
from spark_bam_tpu_torch.sbi.store import (
    CacheMode,
    CacheStore,
    StaleCacheError,
    cache_events,
    cache_status_line,
    reset_cache_events,
)

__all__ = [
    "CacheMode",
    "CacheStore",
    "Fingerprint",
    "PlanEntry",
    "SbiFormatError",
    "SbiIndex",
    "StaleCacheError",
    "cache_events",
    "cache_status_line",
    "config_digest",
    "decode_sbi",
    "encode_sbi",
    "fingerprint_of",
    "reset_cache_events",
]
