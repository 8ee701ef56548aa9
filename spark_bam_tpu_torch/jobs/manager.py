"""Job admission and lifecycle: submit, status, cancel, pause on
exhaustion, resume from the journal (reference ``spark_bam_tpu/jobs/
manager.py``).

A job's identity is ``blake2b`` of its canonical spec JSON, the
reference's, so resubmitting a spec is idempotent: a running job answers
its status, and one whose previous attempt died (a worker SIGKILL, an
ENOSPC pause) resumes from its journal instead of restarting. That makes
the serve ops safe to retry and the fabric router's orphan rescue safe to
re-dispatch.

Admission is guarded twice before a byte is written:

- **capacity**: at most ``max_active`` running jobs, and none admitted
  while host memory use is past ``mem_watermark``. Both defer with a typed,
  retryable ``ResourceExhausted`` (``jobs.deferred``, ``retry_after_ms``
  1000), never an unbounded queue.
- **space**: ``core.guard.preflight_space`` against the output
  filesystem, sized from the input (``jobs.preflight_rejects``).

A running job that hits ``ResourceExhausted`` mid-write pauses: the
journal and the committed segments stay, the state turns ``paused`` and
the manager's ``alert_fn`` fires. Any other exception fails the job with
the error recorded; nothing re-runs it elsewhere.

Each job runs on the manager's ``device`` (a serve worker passes its
mesh's first device; ``None`` is the current CUDA device and raises
without one, in the job).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core.atomic import ResourceExhausted
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.guard import preflight_space
from spark_bam_tpu_torch.jobs.runner import RUNNERS, JobCancelled

#: job states; the terminal ones keep their result or error.
STATES = ("running", "done", "paused", "failed", "cancelled")


def default_jobs_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "spark-bam-jobs")


@dataclass(frozen=True)
class JobsConfig:
    """The parsed ``SPARK_BAM_JOBS`` spec (``dir=...,checkpoint=...,
    frames=...,mem=0.92,max=2``)."""

    dir: str = ""               # journal and segment root ("": tmpdir)
    checkpoint: int = 5000      # rewrite/transcode: records a checkpoint
    frames: int = 8             # export: frames a checkpoint
    mem_watermark: float = 0.92  # defer admission past this used fraction
    max_active: int = 2         # concurrent running jobs

    def __post_init__(self):
        if self.checkpoint < 1 or self.frames < 1 or self.max_active < 1:
            raise ValueError("jobs checkpoint/frames/max must be >= 1")
        if not (0.0 < self.mem_watermark <= 1.0):
            raise ValueError(
                f"jobs mem watermark must be in (0,1]: {self.mem_watermark}"
            )

    def root(self) -> str:
        return self.dir or default_jobs_dir()

    @staticmethod
    def parse(spec: str) -> "JobsConfig":
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"Bad jobs entry {part!r} in {spec!r}")
            key, value = (t.strip() for t in part.split("=", 1))
            key = key.replace("-", "_")
            if key == "dir":
                kw["dir"] = value
            elif key in ("checkpoint", "ckpt"):
                kw["checkpoint"] = int(value)
            elif key == "frames":
                kw["frames"] = int(value)
            elif key in ("mem", "mem_watermark"):
                kw["mem_watermark"] = float(value)
            elif key in ("max", "max_active"):
                kw["max_active"] = int(value)
            else:
                raise ValueError(
                    f"Unknown jobs knob {key!r}: expected "
                    "dir/checkpoint/frames/mem/max"
                )
        return JobsConfig(**kw)

    @staticmethod
    def from_env(env=None) -> "JobsConfig":
        return JobsConfig.parse(
            (env or os.environ).get("SPARK_BAM_JOBS", "")
        )


def job_id_of(spec: dict) -> str:
    """A job's identity: the hash of its canonical spec."""
    canon = json.dumps(spec, separators=(",", ":"), sort_keys=True)
    return hashlib.blake2b(canon.encode(), digest_size=8).hexdigest()


def memory_used_fraction() -> "float | None":
    """The host's used memory fraction from ``/proc/meminfo``; ``None``
    where it cannot be read (the watermark check is then skipped)."""
    try:
        with open("/proc/meminfo") as f:
            info = {}
            for line in f:
                key, _, rest = line.partition(":")
                info[key.strip()] = rest
        total = int(info["MemTotal"].split()[0])
        avail = int(info["MemAvailable"].split()[0])
    except (OSError, KeyError, ValueError, IndexError):
        return None
    if total <= 0:
        return None
    return 1.0 - (avail / total)


@dataclass
class _Job:
    job_id: str
    spec: dict
    state: str = "running"
    result: "dict | None" = None
    error: str = ""
    submitted: float = 0.0
    finished: float = 0.0
    cancel: threading.Event = field(default_factory=threading.Event)
    thread: "threading.Thread | None" = None

    def status(self) -> dict:
        out = {
            "job_id": self.job_id,
            "op": self.spec.get("op"),
            "state": self.state,
            "submitted": self.submitted,
        }
        if self.finished:
            out["finished"] = self.finished
        if self.result is not None:
            out["result"] = self.result
        if self.error:
            out["error"] = self.error
        return out


class JobManager:
    """The job table and one daemon thread a running job."""

    def __init__(self, jcfg: "JobsConfig | None" = None,
                 config: Config = Config(), alert_fn=None,
                 mem_fn=memory_used_fraction, device=None):
        # An explicit jcfg wins over the config's ``jobs`` knob (which
        # Config.from_env fills from SPARK_BAM_JOBS).
        self.jcfg = jcfg if jcfg is not None else config.jobs_config
        self.config = config
        self.alert_fn = alert_fn      # (name, **fields) → the alert sink
        self.mem_fn = mem_fn
        self.device = device
        self._jobs: "dict[str, _Job]" = {}
        self._lock = threading.Lock()

    # ---------------------------------------------------------- admission
    def _defer(self, why: str, **extra) -> ResourceExhausted:
        obs.count("jobs.deferred")
        exc = ResourceExhausted(f"job deferred: {why}")
        exc.retry_after_ms = 1000.0
        exc.extra = extra
        return exc

    def _admit(self) -> None:
        with self._lock:
            active = sum(1 for j in self._jobs.values()
                         if j.state == "running")
        if active >= self.jcfg.max_active:
            raise self._defer(
                f"{active} jobs running (max {self.jcfg.max_active})",
                active=active,
            )
        used = self.mem_fn() if self.mem_fn else None
        if used is not None and used >= self.jcfg.mem_watermark:
            raise self._defer(
                f"host memory at {used:.0%} "
                f"(watermark {self.jcfg.mem_watermark:.0%})",
                mem_used=round(used, 3),
            )

    def _preflight(self, spec: dict) -> None:
        try:
            need = os.path.getsize(spec["path"])
        except OSError:
            return  # a missing input fails in the runner as NotFound
        try:
            preflight_space(spec["out"], need)
        except ResourceExhausted:
            obs.count("jobs.preflight_rejects")
            raise

    # ------------------------------------------------------------ surface
    def submit(self, spec: dict) -> dict:
        """Admit (or idempotently re-attach to) the job of ``spec``; raises
        :class:`ResourceExhausted` on a deferral or a preflight refusal,
        else returns the job's status."""
        op = spec.get("op")
        if op not in RUNNERS:
            raise ValueError(
                f"unknown job op {op!r}: expected one of "
                f"{', '.join(sorted(RUNNERS))}"
            )
        if not spec.get("path") or not spec.get("out"):
            raise ValueError("job spec needs 'path' and 'out'")
        spec = {k: v for k, v in sorted(spec.items()) if v is not None}
        jid = job_id_of(spec)
        with self._lock:
            job = self._jobs.get(jid)
            if job is not None and job.state in ("running", "done"):
                return job.status()  # idempotent resubmit
        # paused, failed, cancelled or unknown: (re)start; the runner
        # resumes from whatever the journal holds.
        self._admit()
        self._preflight(spec)
        with self._lock:
            job = self._jobs.get(jid)
            if job is not None and job.state in ("running", "done"):
                return job.status()
            job = _Job(jid, spec, submitted=round(time.time(), 3))
            self._jobs[jid] = job
            job.thread = threading.Thread(
                target=self._run, args=(job,),
                name=f"job-{jid}", daemon=True,
            )
            job.thread.start()
        obs.count("jobs.submitted")
        return job.status()

    def status(self, job_id: str) -> "dict | None":
        with self._lock:
            job = self._jobs.get(job_id)
            return job.status() if job is not None else None

    def cancel(self, job_id: str) -> "dict | None":
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            return None
        if job.state == "running":
            job.cancel.set()
        return job.status()

    def jobs(self) -> "list[dict]":
        with self._lock:
            return [j.status() for j in self._jobs.values()]

    def close(self, timeout: float = 5.0) -> None:
        with self._lock:
            jobs = list(self._jobs.values())
        for job in jobs:
            job.cancel.set()
        for job in jobs:
            if job.thread is not None:
                job.thread.join(timeout)

    # ------------------------------------------------------------- worker
    def job_dir(self, job_id: str) -> str:
        return os.path.join(self.jcfg.root(), job_id)

    def _run(self, job: _Job) -> None:
        runner = RUNNERS[job.spec["op"]]
        checkpoint = (self.jcfg.frames if job.spec["op"] == "export"
                      else self.jcfg.checkpoint)
        try:
            result = runner(
                job.spec, self.job_dir(job.job_id),
                config=self.config, checkpoint=checkpoint,
                cancel=job.cancel, device=self.device,
            )
            job.result = result
            job.state = "done"
            obs.count("jobs.completed")
        except JobCancelled as exc:
            job.error = str(exc)
            job.state = "cancelled"
            obs.count("jobs.cancelled")
        except ResourceExhausted as exc:
            # Paused, not failed: the journal and the committed segments
            # are durable, and a resubmit resumes.
            job.error = str(exc)
            job.state = "paused"
            obs.count("jobs.paused")
            if self.alert_fn is not None:
                try:
                    self.alert_fn(
                        "jobs.paused", job_id=job.job_id,
                        op=job.spec.get("op"), error=str(exc),
                    )
                except Exception:
                    pass
        except Exception as exc:
            job.error = f"{type(exc).__name__}: {exc}"
            job.state = "failed"
            obs.count("jobs.failed")
        finally:
            job.finished = round(time.time(), 3)
