"""Timers, heartbeats and the profiler hook (``timer.py``)."""

from spark_bam_tpu_torch.utils.timer import Timer, heartbeat, profile_trace

__all__ = ["Timer", "heartbeat", "profile_trace"]
