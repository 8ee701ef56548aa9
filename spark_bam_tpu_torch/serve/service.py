"""The split service: warm state and handlers behind an admission gate
(reference ``spark_bam_tpu/serve/service.py``).

The long-running counterpart of the one-shot paths. Three resident tiers
do the work the one-shot paths rebuild per call:

- ``MeshSteps`` (``parallel/mesh.py``): the serve step and the aggregate's
  agg step, built once per mesh and reused by every dispatch;
- the ``_FileState`` LRU: flat views, contig dictionaries, lazy record
  starts, a warm record parse and encoded frames per file, bounded by
  ``ServeConfig.flat_cache`` bytes;
- the ``.sbi`` cache (``sbi/``): a repeat plan request resolves entirely
  from the sidecar, zero ``load.split_resolutions``.

Scan-class requests (``count``, ``fleet``) are cut into window rows and
answered through the :class:`~spark_bam_tpu_torch.serve.batcher.Batcher`;
``batch`` and ``aggregate`` run on the worker pool over the warm parse;
``rewrite`` runs the write path (``rewrite.py``) on the worker pool;
plan-class requests (``plan``, ``record_starts``) run on the worker pool
against the index tier. Control-class requests (``submit``,
``job_status``, ``job_cancel``) reach the durable job plane
(``jobs/manager.py``): each job runs on a daemon thread of its own,
beside the batcher's ticks on the same device.

Every device step runs on the mesh's devices: the batcher's ticks across
the mesh, the starts, the parse, the filters, the rewrite's codec lanes
and every job on its first device, the aggregate through the mesh's agg
step. A failure there is an error response (a job's: its ``failed``
state); nothing answers in the device's place. The mesh defaults to
every visible CUDA device (``local_mesh()``), raising without one; pass
``mesh=local_mesh(["cpu"])`` to serve from the CPU (the plain versions).

The one op this port does not serve yet, ``telemetry``, answers
``Unsupported`` naming the ROADMAP item that will (Queue 1 item 15).
``alerts`` answers as the reference does without a configured SLO, and a
paused job's alert takes the reference's no-SLO branch: a ``slo_alert``
record in the flight recorder.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout

import numpy as np

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.core.atomic import ResourceExhausted
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.faults import LatencyTracker
from spark_bam_tpu_torch.jobs.manager import JobManager
from spark_bam_tpu_torch.obs import account as obs_account
from spark_bam_tpu_torch.obs import flight
from spark_bam_tpu_torch.parallel.mesh import local_mesh, mesh_steps
from spark_bam_tpu_torch.serve.admission import CLASS_OF, AdmissionGate
from spark_bam_tpu_torch.serve.batcher import Batcher, RowTask
from spark_bam_tpu_torch.serve.config import MAX_CONTIGS, ServeConfig
from spark_bam_tpu_torch.serve.protocol import (
    encode,
    error_response,
    ok_response,
)
from spark_bam_tpu_torch.tpu.kernels import PAD
from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths

#: Retry-After fallback before the latency tracker has enough samples.
_RETRY_AFTER_DEFAULT_MS = 50.0

#: Per-op latency window behind the ``stats`` percentiles (p50/p99).
_LATENCY_WINDOW = 512

#: Ops of the protocol this port answers ``Unsupported``, with the ROADMAP
#: Queue 1 item that will serve each.
UNSERVED = {
    "telemetry": "15",
}

#: The kernels take rows that start on 16-byte boundaries.
_ROW_ALIGN = 16


def unsupported_response(req: dict) -> dict:
    """The ``Unsupported`` answer to an op of ``UNSERVED``, naming the
    ROADMAP item that will serve it (the router answers with it too)."""
    op = req.get("op")
    return error_response(
        req, "Unsupported",
        f"op {op!r} is not served by this port yet; ROADMAP Queue 1 item "
        f"{UNSERVED[op]} will serve it",
    )


def _percentile(samples, q: float) -> "float | None":
    """Nearest-rank percentile over a small sample window."""
    if not samples:
        return None
    s = sorted(samples)
    i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return round(s[i], 3)


class ServiceError(Exception):
    """Handler failure with a stable wire ``error`` type."""

    def __init__(self, error: str, message: str, **extra):
        self.error = error
        self.extra = extra
        super().__init__(message)


def _norm_tags(raw) -> "tuple[str, ...]":
    """A request's ``tags_required`` (a string or a list) as the tuple of
    two-character tag names; malformed names raise ``ValueError``."""
    if not raw:
        return ()
    if isinstance(raw, str):
        raw = [t for t in raw.replace(";", ",").split(",") if t]
    tags = tuple(str(t).strip() for t in raw)
    for t in tags:
        if len(t) != 2:
            raise ValueError(f"tag names are exactly two chars: {t!r}")
    return tags


def _resume(chunks: list, req: dict, out: dict) -> list:
    """The frames from the request's ``resume_from`` on, noting the token
    and the full count in ``out``."""
    total_frames = len(chunks)
    resume_from = int(req.get("resume_from") or 0)
    if resume_from:
        if not 0 <= resume_from < total_frames:
            raise ServiceError(
                "ProtocolError",
                f"resume_from={resume_from} out of range "
                f"(0..{total_frames - 1})",
            )
        chunks = chunks[resume_from:]
        out["resume_from"] = resume_from
        out["total_frames"] = total_frames
    return chunks


class _FileState:
    """Warm per-file tier: flat view, contig dictionary, lazy starts, a
    warm parse and the encoded-frame cache."""

    #: distinct query shapes kept hot per file.
    _FRAME_CACHE_SLOTS = 8

    def __init__(self, path: str, device):
        self.path = str(path)
        self.device = device
        st = os.stat(self.path)
        self.stamp = (st.st_size, st.st_mtime_ns)
        header = read_header(self.path)
        self.header = header
        self.contigs = [(str(name), int(length)) for name, length in
                        zip(header.contig_names, header.contig_lengths)]
        lens = np.asarray(header.contig_lengths, dtype=np.int32)
        if len(lens) > MAX_CONTIGS:
            raise ServiceError(
                "Unsupported",
                f"{self.path}: {len(lens)} contigs exceeds the serve "
                f"step's fixed dictionary ({MAX_CONTIGS}); use the one-shot "
                "CLI path",
            )
        self.lengths = pad_contig_lengths(lens, cmax=MAX_CONTIGS)
        self.nc = len(lens)
        self.header_end = header.uncompressed_size
        self.flat = flatten_file(self.path)
        self.nbytes = int(self.flat.data.nbytes)
        self._starts: "np.ndarray | None" = None
        self._starts_lock = threading.Lock()
        self._read_batch = None
        self._read_batch_lock = threading.Lock()
        # Encoded frames per query shape: an unchanged file and query
        # always encode the same frame list (file changes evict the whole
        # state through ``fresh()``).
        self._frame_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._frame_cache_lock = threading.Lock()

    def frame_cache_get(self, key: tuple):
        with self._frame_cache_lock:
            hit = self._frame_cache.get(key)
            if hit is not None:
                self._frame_cache.move_to_end(key)
            return hit

    def frame_cache_put(self, key: tuple, chunks: tuple, rows: int) -> None:
        with self._frame_cache_lock:
            self._frame_cache[key] = (chunks, rows)
            self._frame_cache.move_to_end(key)
            while len(self._frame_cache) > self._FRAME_CACHE_SLOTS:
                self._frame_cache.popitem(last=False)

    def fresh(self) -> bool:
        try:
            st = os.stat(self.path)
        except OSError:
            return False
        return (st.st_size, st.st_mtime_ns) == self.stamp

    def starts(self, config: Config) -> np.ndarray:
        """Exact whole-file record starts (cache-aware; the escape
        fallback and the ``record_starts`` op), computed once on the
        device and kept warm."""
        with self._starts_lock:
            if self._starts is None:
                from spark_bam_tpu_torch.load.tpu_load import record_starts

                self._starts = np.asarray(
                    record_starts(self.path, config, device=self.device,
                                  view=self.flat).starts, dtype=np.int64)
            return self._starts

    def read_batch(self, config: Config):
        """The warm parsed ``ReadBatch`` over the flat view (parsed on the
        device once; repeat queries re-filter its planes)."""
        with self._read_batch_lock:
            if self._read_batch is None:
                from spark_bam_tpu_torch.tpu.parser import parse_flat_records

                starts = self.starts(config)
                with obs.span("serve.parse", records=len(starts)):
                    self._read_batch = parse_flat_records(
                        self.flat.data, starts, device=self.device)
            return self._read_batch


class SplitService:
    """Handlers and warm tiers; see the module docstring. Thread-safe."""

    def __init__(self, config: Config = Config(), mesh=None):
        self.config = config
        self.serve_cfg: ServeConfig = config.serve_config
        self.policy = config.fault_policy
        # Transport knobs the accept loop reads when answering ``hello``.
        self.shm_enabled = bool(self.serve_cfg.shm)
        self.shm_bytes = int(self.serve_cfg.shm_bytes)
        self.shm_wait_ms = float(self.serve_cfg.shm_wait_ms)
        self.shm_chaos = self._build_shm_chaos(config)
        self.mesh = mesh if mesh is not None else local_mesh()
        self.device = self.mesh.devices[0]
        self.steps = mesh_steps(self.mesh)
        # Row width: the window rounded up to the kernels' row alignment,
        # then the check's padding.
        row = -(-self.serve_cfg.window // _ROW_ALIGN) * _ROW_ALIGN
        self.batcher = Batcher(
            self.steps,
            width=row + PAD,
            batch_rows=self.serve_cfg.batch_rows,
            tick_ms=self.serve_cfg.tick_ms,
            reads_to_check=config.reads_to_check,
            funnel=config.funnel_enabled(),
        )
        self.gate = AdmissionGate({
            "plan": self.serve_cfg.plan_queue,
            "scan": self.serve_cfg.scan_queue,
            "control": 8,
        })
        self.jobs = JobManager(config=config, alert_fn=self._job_alert,
                               device=self.device)
        self.pool = ThreadPoolExecutor(
            max_workers=self.serve_cfg.workers, thread_name_prefix="serve-worker"
        )
        # Split resolution fans out beneath a plan handler; a separate pool
        # keeps that nesting from deadlocking the request workers.
        self.resolve_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="serve-resolve"
        )
        self.latency = LatencyTracker()
        self._files: "OrderedDict[str, _FileState]" = OrderedDict()
        self._files_lock = threading.Lock()
        self.served = 0
        # op → [requests, rows, bytes, ms], the per-op ledger of ``stats``.
        self._op_stats: "dict[str, list]" = {}
        # op → recent latencies (ms) behind the stats p50/p99.
        self._op_lat: "dict[str, deque]" = {}
        self._op_lock = threading.Lock()
        self._closed = False
        self.draining = False
        self.accountant = obs_account.Accountant()

    @staticmethod
    def _build_shm_chaos(config: Config):
        """The seeded shm-seam fault source (``fabric/chaos.py``) when the
        fabric ``chaos=`` spec sets any ``shm_*`` rate; the accept loop
        rolls it per frame record. A lazy import, so an unconfigured
        service never loads the fabric."""
        arg = config.fabric_config.chaos
        if not arg:
            return None
        from spark_bam_tpu_torch.fabric.chaos import (
            FabricChaos,
            parse_fabric_chaos,
        )

        seed, spec = parse_fabric_chaos(arg)
        if not (spec.shm_crc or spec.shm_trunc or spec.shm_unlink):
            return None
        return FabricChaos(seed, spec)

    def _job_alert(self, name: str, **fields) -> None:
        """A paused job pages where the reference's alerts land without an
        SLO engine: the flight recorder."""
        flight.record("slo_alert", objective=name, state="firing", **fields)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._closed = True
        self.jobs.close(timeout=1.0)
        self.batcher.close()
        self.pool.shutdown(wait=False, cancel_futures=True)
        self.resolve_pool.shutdown(wait=False, cancel_futures=True)

    # ------------------------------------------------------------ admission
    def retry_after_ms(self) -> float:
        med = self.latency.median()
        return med if med is not None else _RETRY_AFTER_DEFAULT_MS

    def submit(self, req: dict, conn=None) -> "Future[dict]":
        """Admit ``req`` and return a future of its full response. Raises
        :class:`~spark_bam_tpu_torch.serve.admission.Overloaded` at once
        when the request's class is at its inflight limit; every other
        failure is a typed error response on the future. ``conn`` is the
        accept loop's per-connection transport state, unused here."""
        fut: "Future[dict]" = Future()
        op = req.get("op")
        if op == "ping":
            fut.set_result(ok_response(req, pong=True,
                                       devices=int(self.mesh.n_local)))
            return fut
        if op == "stats":
            fut.set_result(ok_response(req, **self.stats()))
            return fut
        if op == "drain":
            fut.set_result(ok_response(req, **self.drain()))
            return fut
        if op == "tune":
            try:
                fut.set_result(ok_response(req, **self.tune(req)))
            except (KeyError, TypeError, ValueError) as exc:
                fut.set_result(error_response(req, "ProtocolError", str(exc)))
            return fut
        if op == "alerts":
            fut.set_result(ok_response(req, **self.alerts()))
            return fut
        if op in UNSERVED:
            fut.set_result(unsupported_response(req))
            return fut
        klass = CLASS_OF[op]
        if self._closed:
            raise RuntimeError("service is closed")
        if self.draining:
            # In-flight work finishes unshed; new work is refused with a
            # typed error a router reroutes on.
            fut.set_result(error_response(
                req, "Draining", "service is draining; route elsewhere",
            ))
            return fut
        self.gate.admit(klass, self.retry_after_ms())  # may raise Overloaded
        obs.count("serve.requests")
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is not None:
            deadline_ts = time.monotonic() + float(deadline_ms) / 1000.0
        elif self.policy.deadline is not None:
            deadline_ts = time.monotonic() + self.policy.deadline
        else:
            deadline_ts = None
        t0 = time.monotonic()
        self.pool.submit(self._run, op, req, fut, klass, deadline_ts, t0)
        return fut

    def _run(self, op, req, fut, klass, deadline_ts, t0) -> None:
        handler = getattr(self, f"_handle_{op}")
        # The cost accumulator travels by contextvar: RowTask captures it
        # at creation, the batcher bills each row at dispatch.
        cost = self.accountant.begin(op, req.get("tenant"))
        cost_token = obs_account.bind(cost)
        try:
            with obs.span("serve.request", op=op):
                if deadline_ts is not None and time.monotonic() > deadline_ts:
                    obs.count("serve.shed")
                    raise ServiceError(
                        "DeadlineExceeded",
                        f"{op} deadline expired before service started",
                    )
                resp = ok_response(req, **handler(req, deadline_ts))
        except ServiceError as exc:
            resp = error_response(req, exc.error, str(exc), **exc.extra)
        except TimeoutError as exc:
            obs.count("serve.shed")
            resp = error_response(req, "DeadlineExceeded", str(exc))
        except ResourceExhausted as exc:
            # Retryable exhaustion (disk, memory, the job plane's
            # deferrals), typed so clients and the router pace a retry.
            resp = error_response(
                req, "ResourceExhausted", str(exc),
                retry_after_ms=round(getattr(
                    exc, "retry_after_ms", self.retry_after_ms()
                ), 3),
            )
        except FileNotFoundError as exc:
            resp = error_response(req, "NotFound", str(exc))
        except Exception as exc:
            resp = error_response(
                req, "Internal", f"{type(exc).__name__}: {exc}"
            )
        finally:
            self.gate.release(klass)
            obs_account.reset(cost_token)
        ms = (time.monotonic() - t0) * 1000.0
        ok = bool(resp.get("ok"))
        self.latency.record(ms)
        obs.observe("serve.latency_ms", ms)
        nbytes = self._note_op(op, ms, resp)
        self.accountant.finish(cost, ms, nbytes, ok=ok)
        if not ok:
            obs.count("serve.errors")
        with self._op_lock:
            self.served += 1
        fut.set_result(resp)

    def _note_op(self, op: str, ms: float, resp: dict) -> int:
        """Per-op request, row and byte accounting. Rows come from
        whichever cardinality the op reports (``rows``/``count``/
        ``total``); bytes are the encoded JSON line plus any binary
        frames (returned, so the cost accountant bills the same)."""
        rows = 0
        if resp.get("ok"):
            for key in ("rows", "count", "total"):
                if isinstance(resp.get(key), int):
                    rows = resp[key]
                    break
        chunks = resp.get("_binary") or ()
        nbytes = sum(len(c) for c in chunks)
        nbytes += len(encode(
            {k: v for k, v in resp.items() if k != "_binary"}
        ))
        with self._op_lock:
            acc = self._op_stats.setdefault(op, [0, 0, 0, 0.0])
            acc[0] += 1
            acc[1] += rows
            acc[2] += nbytes
            acc[3] += ms
            lat = self._op_lat.get(op)
            if lat is None:
                lat = self._op_lat[op] = deque(maxlen=_LATENCY_WINDOW)
            lat.append(ms)
        return nbytes

    # -------------------------------------------------------------- admin ops
    def drain(self) -> dict:
        """Stop admitting work ops; in-flight requests and queued ticks
        complete unshed. ping/stats/tune keep answering."""
        self.draining = True
        return {"draining": True, "inflight": self.gate.inflight()}

    def tune(self, req: dict) -> dict:
        """Retarget the batching and admission knobs at runtime. Returns
        the applied values (batch_rows after mesh rounding)."""
        applied: dict = {}
        if req.get("batch_rows") is not None:
            applied["batch_rows"] = self.batcher.set_batch_rows(
                int(req["batch_rows"])
            )
        if req.get("tick_ms") is not None:
            applied["tick_ms"] = self.batcher.set_tick_ms(
                float(req["tick_ms"])
            )
        for key, klass in (("plan_queue", "plan"), ("scan_queue", "scan")):
            if req.get(key) is not None:
                applied[key] = self.gate.set_limit(klass, int(req[key]))
        if not applied:
            raise ValueError(
                "tune needs at least one of batch_rows/tick_ms/"
                "plan_queue/scan_queue"
            )
        obs.count("serve.tuned")
        return {"applied": applied, **self._knobs()}

    def alerts(self) -> dict:
        """The reference's answer with no SLO objectives configured."""
        return {"slo": {"enabled": False, "objectives": [],
                        "firing": [], "ledger": []}}

    def _knobs(self) -> dict:
        return {
            "batch_rows": int(self.batcher.batch_rows),
            "tick_ms": round(self.batcher.tick_s * 1000.0, 3),
            "limits": dict(self.gate.limits),
        }

    # ------------------------------------------------------------ warm tier
    def file_state(self, path) -> _FileState:
        path = str(path)
        with self._files_lock:
            fs = self._files.get(path)
            if fs is not None and fs.fresh():
                self._files.move_to_end(path)
                return fs
            if fs is not None:
                del self._files[path]
        fs = _FileState(path, self.device)
        with self._files_lock:
            self._files[path] = fs
            self._files.move_to_end(path)
            total = sum(f.nbytes for f in self._files.values())
            while total > self.serve_cfg.flat_cache and len(self._files) > 1:
                _, evicted = self._files.popitem(last=False)
                total -= evicted.nbytes
        return fs

    # ------------------------------------------------------------- handlers
    def _handle_plan(self, req: dict, deadline_ts) -> dict:
        from spark_bam_tpu_torch.load.api import split_starts

        path = req["path"]
        splits = split_starts(path, split_size=req.get("split_size"),
                              config=self.config, pool=self.resolve_pool,
                              device=self.device)
        return {
            "path": str(path),
            "splits": [
                {
                    "start": s.start,
                    "end": s.end,
                    "pos": None if p is None else [p.block_pos, p.offset],
                    "vpos": None if p is None else p.to_htsjdk(),
                }
                for s, p in splits
            ],
        }

    def _handle_record_starts(self, req: dict, deadline_ts) -> dict:
        fs = self.file_state(req["path"])
        starts = fs.starts(self.config)
        limit = int(req.get("limit", 0))
        blocks, offs = fs.flat.pos_of_flat_many(starts[:limit] if limit else
                                                starts[:0])
        return {
            "path": fs.path,
            "count": int(len(starts)),
            "vpos": [
                (int(b) << 16) | int(o) for b, o in zip(blocks, offs)
            ],
        }

    def _handle_count(self, req: dict, deadline_ts) -> dict:
        fs = self.file_state(req["path"])
        lo, hi = self._flat_range(fs, req)
        tasks = self._scan_rows(fs, lo, hi, deadline_ts)
        count, escaped = self._gather(tasks, deadline_ts)
        exact_fallback = False
        if escaped:
            count = self._exact_count(fs, lo, hi)
            exact_fallback = True
        return {
            "path": fs.path,
            "count": int(count),
            "escaped": int(escaped),
            "exact_fallback": exact_fallback,
        }

    def _handle_fleet(self, req: dict, deadline_ts) -> dict:
        paths = req["paths"]
        if not isinstance(paths, list) or not paths:
            raise ServiceError("ProtocolError",
                               "fleet needs a non-empty 'paths' list")
        # Every file's rows go in before any is awaited: rows of the whole
        # fleet share batcher ticks.
        per_path = []
        for p in paths:
            fs = self.file_state(p)
            lo, hi = fs.header_end, fs.flat.size
            per_path.append((fs, lo, hi,
                             self._scan_rows(fs, lo, hi, deadline_ts)))
        counts = {}
        total = 0
        for fs, lo, hi, tasks in per_path:
            count, escaped = self._gather(tasks, deadline_ts)
            if escaped:
                count = self._exact_count(fs, lo, hi)
            counts[fs.path] = int(count)
            total += int(count)
        return {"paths": counts, "total": total}

    def _handle_rewrite(self, req: dict, deadline_ts) -> dict:
        """Re-block and re-compress ``path`` into ``out`` through the write
        path (``rewrite.py``): the card's lanes when the service config (or
        the request's ``deflate`` spec) turns them on, the sidecars written
        from the packing metadata when ``index`` is set. Scan-class: the
        codec competes with count and fleet for the device."""
        from spark_bam_tpu_torch.compress.config import DeflateConfig
        from spark_bam_tpu_torch.rewrite import rewrite_bam

        path = req["path"]
        out = req.get("out")
        if not out:
            raise ServiceError("ProtocolError", "rewrite needs an 'out' path")
        deflate = req.get("deflate")
        if deflate is not None:
            try:
                DeflateConfig.parse(deflate)
            except ValueError as exc:
                raise ServiceError("ProtocolError", str(exc)) from exc
        # ``resume_from`` is accepted and ignored: rewrite sends no frames,
        # and its output commit is atomic, so a failover re-runs it.
        try:
            block_payload = int(req.get("block_payload") or 0xFF00)
            level = int(req.get("level") or 6)
        except (TypeError, ValueError) as exc:
            raise ServiceError("ProtocolError", str(exc)) from exc
        with obs.span("serve.rewrite", path=str(path)):
            res = rewrite_bam(
                path, out,
                block_payload=block_payload, level=level, deflate=deflate,
                index=bool(req.get("index")), config=self.config,
                device=self.device,
            )
        return {
            "path": str(path),
            "out": str(out),
            "count": res.count,
            "n_blocks": res.n_blocks,
            "bytes_out": res.bytes_out,
            "sidecars": dict(res.sidecars),
        }

    # ----------------------------------------------------------- job plane
    #: request fields forwarded into a job spec.
    _JOB_FIELDS = ("path", "out", "block_payload", "level", "deflate",
                   "index", "columns", "batch_rows")

    def _handle_submit(self, req: dict, deadline_ts) -> dict:
        """Admit a durable job (``jobs/manager.py``): ``job`` picks the
        runner (rewrite, export, transcode), the spec fields are the
        one-shot ops'. A spec's job id is deterministic, so a retry is
        idempotent and a resubmit of a paused or dead job resumes it."""
        from spark_bam_tpu_torch.jobs.runner import RUNNERS

        job = req.get("job")
        if job not in RUNNERS:
            raise ServiceError(
                "ProtocolError",
                f"submit needs job ∈ {{{', '.join(sorted(RUNNERS))}}}, "
                f"got {job!r}",
            )
        spec = {"op": job}
        spec.update(
            (k, req[k]) for k in self._JOB_FIELDS
            if req.get(k) is not None
        )
        try:
            status = self.jobs.submit(spec)
        except ValueError as exc:
            raise ServiceError("ProtocolError", str(exc)) from exc
        return status

    def _job_or_404(self, req: dict) -> str:
        jid = req.get("job_id")
        if not jid:
            raise ServiceError("ProtocolError", "missing 'job_id'")
        return str(jid)

    def _handle_job_status(self, req: dict, deadline_ts) -> dict:
        status = self.jobs.status(self._job_or_404(req))
        if status is None:
            raise ServiceError(
                "NotFound", f"no job {req.get('job_id')!r} on this worker"
            )
        return status

    def _handle_job_cancel(self, req: dict, deadline_ts) -> dict:
        status = self.jobs.cancel(self._job_or_404(req))
        if status is None:
            raise ServiceError(
                "NotFound", f"no job {req.get('job_id')!r} on this worker"
            )
        return status

    def _filtered(self, fs: _FileState, req: dict, tags_required,
                  deadline_ts, what: str):
        """A copy of the warm parse with the request's loci, flag and tag
        filters applied to its ``valid`` mask (the warm tier keeps the
        unfiltered mask)."""
        from spark_bam_tpu_torch.load.tpu_load import _apply_filter
        from spark_bam_tpu_torch.tpu.parser import ReadBatch

        warm = fs.read_batch(self.config)
        if deadline_ts is not None and time.monotonic() > deadline_ts:
            obs.count("serve.shed")
            raise ServiceError(
                "DeadlineExceeded", f"{what} deadline expired during parse"
            )
        batch = ReadBatch(dict(warm.columns), warm.starts, buf=warm.buf)
        batch.columns["valid"] = np.array(warm.columns["valid"], copy=True)
        loci = req.get("intervals") or None
        flags_required = int(req.get("flags_required") or 0)
        flags_forbidden = int(req.get("flags_forbidden") or 0)
        if loci or flags_required or flags_forbidden or tags_required:
            _apply_filter(batch, fs.header, loci, flags_required,
                          flags_forbidden, tags_required=tags_required,
                          device=self.device)
        return batch

    def _handle_batch(self, req: dict, deadline_ts) -> dict:
        """Columnar record batches of a (possibly filtered) file as
        native-container frames (``columnar/native.py``; Arrow IPC stream
        frames with ``wire=arrow``), over the warm flat view and parse:
        the frames equal ``load.api.export(fmt="native")``'s file for the
        same query."""
        from spark_bam_tpu_torch.columnar.from_parser import (
            read_batch_to_record_batches,
        )
        from spark_bam_tpu_torch.columnar.native import (
            batch_frame,
            container_head,
            container_meta,
            end_frame,
        )
        from spark_bam_tpu_torch.columnar.schema import normalize_columns

        fs = self.file_state(req["path"])
        ccfg = self.config.columnar_config
        try:
            columns = normalize_columns(req.get("columns") or ccfg.columns)
        except ValueError as exc:
            raise ServiceError("ProtocolError", str(exc)) from exc
        batch_rows = int(req.get("batch_rows") or ccfg.batch_rows)
        if batch_rows <= 0:
            raise ServiceError("ProtocolError", "batch_rows must be positive")
        wire = str(req.get("wire") or "sbcr")
        if wire not in ("sbcr", "arrow"):
            raise ServiceError(
                "ProtocolError",
                f"wire must be 'sbcr' or 'arrow', got {wire!r}",
            )
        if wire == "arrow":
            from spark_bam_tpu_torch.columnar.arrow_ipc import arrow_available

            if not arrow_available():
                raise ServiceError(
                    "Unsupported",
                    "wire=arrow needs pyarrow (the [arrow] extra); "
                    "the default sbcr wire has no dependencies",
                )
        loci = req.get("intervals") or None
        flags_required = int(req.get("flags_required") or 0)
        flags_forbidden = int(req.get("flags_forbidden") or 0)
        tags_required = _norm_tags(req.get("tags_required"))
        # Encoded frames are a pure function of (file, query): repeat
        # queries skip filter and encode.
        cache_key = (wire, columns, batch_rows, repr(loci), flags_required,
                     flags_forbidden, tags_required, ccfg.codec, ccfg.level)
        cached = fs.frame_cache_get(cache_key)
        if cached is not None:
            obs.count("serve.frame_cache_hits")
            chunks, rows = list(cached[0]), cached[1]
        else:
            obs.count("serve.frame_cache_misses")
            batch = self._filtered(fs, req, tags_required, deadline_ts,
                                   "batch")
            if wire == "arrow":
                from spark_bam_tpu_torch.columnar.arrow_ipc import (
                    stream_frames,
                )

                with obs.span("serve.batch_encode", path=fs.path):
                    chunks, rows = stream_frames(batch, batch_rows, columns)
            else:
                meta = container_meta(
                    columns, codec=ccfg.codec, level=ccfg.level,
                    contigs=fs.contigs,
                )
                chunks = [container_head(meta)]
                rows = 0
                with obs.span("serve.batch_encode", path=fs.path):
                    for rb in read_batch_to_record_batches(
                        batch, batch_rows, columns
                    ):
                        chunks.append(batch_frame(rb, meta))
                        rows += rb.num_rows
                chunks.append(end_frame(rows, len(chunks) - 1))
            fs.frame_cache_put(cache_key, tuple(chunks), rows)
        out: dict = {}
        chunks = _resume(chunks, req, out)
        nbytes = sum(len(c) for c in chunks)
        obs.count("columnar.rows", rows)
        obs.count("columnar.bytes_out", nbytes)
        if wire == "arrow":
            # Only the non-default wire is echoed.
            out["wire"] = wire
        out.update({
            "path": fs.path,
            "rows": int(rows),
            "columns": list(columns),
            "batch_rows": int(batch_rows),
            "binary_frames": len(chunks),
            "binary_bytes": int(nbytes),
            "_binary": chunks,
        })
        return out

    def _handle_aggregate(self, req: dict, deadline_ts) -> dict:
        """The aggregate over the warm parse: the same filters as
        ``batch`` narrow ``valid``, the mesh's agg step reduces the planes
        (``agg.kernels.aggregate_planes``) and one frame of int64 vectors
        comes back, equal to the int64 oracle's. A device failure is an
        ``Internal`` error response: no host answer stands in."""
        from spark_bam_tpu_torch.agg.kernels import aggregate_planes
        from spark_bam_tpu_torch.agg.plan import AggConfig, encode_result

        fs = self.file_state(req["path"])
        try:
            plan = AggConfig.parse(req.get("agg") or self.config.agg)
            tags_required = _norm_tags(req.get("tags_required"))
            chunk = req.get("chunk")
            if chunk is not None:
                chunk = int(chunk)
                if chunk < 1:
                    raise ValueError(f"agg chunk must be >= 1: {chunk}")
        except (TypeError, ValueError) as exc:
            raise ServiceError("ProtocolError", str(exc)) from exc
        batch = self._filtered(fs, req, tags_required, deadline_ts,
                               "aggregate")
        rows = int(np.count_nonzero(batch.columns["valid"]))
        with obs.span("agg.reduce", path=fs.path):
            vectors = aggregate_planes(batch.columns, plan, fs.nc,
                                       steps=self.steps, chunk=chunk)
        with obs.span("agg.encode", path=fs.path):
            meta, payload = encode_result(plan, fs.nc, fs.contigs, vectors)
        out: dict = {}
        chunks = _resume([payload], req, out)
        nbytes = sum(len(c) for c in chunks)
        obs.count("agg.requests")
        obs.count("agg.rows", rows)
        obs.count("agg.bytes_out", nbytes)
        out.update({
            "path": fs.path,
            "rows": rows,
            "agg": plan.canonical(),
            "result": meta,
            "binary_frames": len(chunks),
            "binary_bytes": int(nbytes),
            "_binary": chunks,
        })
        return out

    # ------------------------------------------------------------- scanning
    def _flat_range(self, fs: _FileState, req: dict) -> "tuple[int, int]":
        """Flat [lo, hi) of a request: the whole file, or the blocks whose
        compressed starts land in the request's compressed [start, end)."""
        start, end = req.get("start"), req.get("end")
        if start is None and end is None:
            return fs.header_end, fs.flat.size
        bs, bf = fs.flat.block_starts, fs.flat.block_flat
        lo = fs.header_end
        hi = fs.flat.size
        if start is not None:
            i = int(np.searchsorted(bs, int(start), side="left"))
            lo = max(fs.header_end, int(bf[i]) if i < len(bf) else fs.flat.size)
        if end is not None:
            i = int(np.searchsorted(bs, int(end), side="left"))
            hi = int(bf[i]) if i < len(bf) else fs.flat.size
        return lo, max(lo, hi)

    def _scan_rows(self, fs: _FileState, lo: int, hi: int,
                   deadline_ts) -> "list[RowTask]":
        """Cut [lo, hi) into batcher rows with ``batch_windows``'s tiling
        (the same step and ownership arithmetic, so the verdicts equal the
        one-shot path's)."""
        window = self.serve_cfg.window
        halo = self.serve_cfg.halo
        step = max(window - halo, 1)
        n_total = fs.flat.size
        buf = fs.flat.data
        tasks: "list[RowTask]" = []
        if lo >= hi:
            return tasks
        for s in range(0, n_total, step):
            e = min(s + window, n_total)
            own_end = e if e == n_total else min(s + step, n_total)
            if own_end <= lo:
                if e == n_total:
                    break
                continue
            if s >= hi:
                break
            row_lo = max(lo, s) - s
            row_own = min(hi, own_end) - s
            if row_lo >= row_own:
                if e == n_total:
                    break
                continue
            t = RowTask(
                window=buf[s:e],
                n=e - s,
                at_eof=(e == n_total),
                lo=row_lo,
                own=row_own,
                lengths=fs.lengths,
                nc=fs.nc,
                deadline_ts=deadline_ts,
            )
            self.batcher.submit(t)
            tasks.append(t)
            if e == n_total:
                break
        return tasks

    def _gather(self, tasks: "list[RowTask]",
                deadline_ts) -> "tuple[int, int]":
        count = escaped = 0
        for t in tasks:
            left = None
            if deadline_ts is not None:
                left = max(deadline_ts - time.monotonic(), 0.001)
            try:
                c, esc = t.future.result(timeout=left)
            except FutureTimeout:
                raise TimeoutError(
                    "deadline expired waiting for device verdict"
                ) from None
            count += c
            escaped += esc
        return count, escaped

    def _exact_count(self, fs: _FileState, lo: int, hi: int) -> int:
        starts = fs.starts(self.config)
        return int(np.searchsorted(starts, hi, side="left")
                   - np.searchsorted(starts, lo, side="left"))

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._op_lock:
            ops = {
                op: {
                    "requests": int(n),
                    "rows": int(rows),
                    "bytes": int(nbytes),
                    "ms": round(ms, 3),
                    "rows_per_s": round(rows / (ms / 1000.0), 1) if ms else 0.0,
                    "bytes_per_s": round(nbytes / (ms / 1000.0), 1) if ms else 0.0,
                    "p50_ms": _percentile(self._op_lat.get(op), 0.50),
                    "p99_ms": _percentile(self._op_lat.get(op), 0.99),
                }
                for op, (n, rows, nbytes, ms) in sorted(self._op_stats.items())
            }
            all_lat = [v for d in self._op_lat.values() for v in d]
        inflight = self.gate.inflight()
        # The warm-tier proof, None while obs is unconfigured.
        reg = obs.registry()
        resolutions = (
            int(reg.counter("load.split_resolutions").value)
            if reg is not None else None
        )
        return {
            "served": int(self.served),
            "inflight": inflight,
            "queue_depth": int(sum(inflight.values())),
            "backlog": int(self.batcher.backlog()),
            "draining": bool(self.draining),
            "files_resident": len(self._files),
            "batch_sizes": {
                str(k): int(v)
                for k, v in sorted(self.batcher.batch_sizes.items())
            },
            "devices": int(self.mesh.n_local),
            "latency_p50_ms": _percentile(all_lat, 0.50),
            "latency_p99_ms": _percentile(all_lat, 0.99),
            "split_resolutions": resolutions,
            "ops": ops,
            # The durable-job table: id → state (job_status has the rest).
            "jobs": {
                j["job_id"]: j["state"] for j in self.jobs.jobs()
            },
            "accounting": self.accountant.snapshot(),
            "slo": None,
            **self._knobs(),
        }
