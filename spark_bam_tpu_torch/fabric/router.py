"""Fabric router: affinity placement, spillover, failover, admin fan-out
(reference ``spark_bam_tpu/fabric/router.py``).

The front end of the serve fabric. It speaks the same newline-JSON (and
``batch`` frame) protocol as a single worker, so clients cannot tell a
router from a worker, and it reuses the serve accept loop unchanged
(``serve/server.py`` ``_handle_connection`` takes any object with
``submit``).

Placement: requests carrying a ``path`` go to the worker that wins a
rendezvous (highest-random-weight) hash over ``(worker id, path)``, so
repeat queries for a file land on the worker whose flat-view LRU and
``.sbi`` store are already warm. When that worker already has
``FabricConfig.spill`` requests in flight, the request spills to the
least-loaded healthy worker instead (counted ``spilled``). Path-less ops
(``fleet``) always go least-loaded.

Failover: a worker dying mid-request fails every request pending on its
link with :class:`WorkerLost`; idempotent ops are re-dispatched to another
worker while the router-wide
:class:`~spark_bam_tpu_torch.fabric.resilience.RetryBudget` holds tokens,
so retries cannot amplify into a storm. Everything else answers a typed
``WorkerLost`` error. By default the router buffers a worker's complete
response (JSON and every binary frame) before relaying it, so a mid-stream
death never leaks partial frames; with ``stream=1`` the ``batch`` and
``aggregate`` ops relay frames as they arrive over a dedicated upstream
connection and, on a mid-stream death, resume on a replacement worker from
a frame-sequence token (``resume_from=N``): byte-identical output without
holding a whole response in router memory.

Upstream ``Overloaded`` and ``Draining`` answers spill across the
remaining workers; only when every healthy worker sheds does the router
pace a jittered ``FaultPolicy`` retry round, and after the rounds it
relays the shed response for the client's own retry loop. With
``brownout=1`` the router itself sheds by admission class while the
healthy fraction of the fleet sits at or below ``brownout_frac``.

Chaos: ``chaos=SEED:SPEC`` in the fabric spec swaps the links for
``fabric/chaos.py``'s :class:`ChaosWorkerLink` and (with ``accept>0``) the
accept-loop entry point for a delaying wrapper, both chosen at
construction, so an unconfigured router runs no chaos branch.

The job plane: ``submit`` places by path affinity and fails over across
workers (a spec's job id is deterministic and the workers share a jobs
dir, so a re-dispatch resumes from the journal); ``job_status`` and
``job_cancel`` go to the job's owner. A watchdog re-sends the original
``submit`` of a tracked, unfinished job whose owner went down to a
survivor (``fabric.job_rescues``).

Not ported yet: ``telemetry`` answers ``Unsupported`` with the worker's
message (ROADMAP Queue 1 item 15). The router mints no trace and opens no
``fabric.relay`` span: a request's own ``trace`` field is forwarded as it
came, as the reference does with its metrics off.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import random
import struct
import time
from collections import deque

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.faults import FaultPolicy, LatencyTracker
from spark_bam_tpu_torch.fabric.config import FabricConfig
from spark_bam_tpu_torch.fabric.resilience import RetryBudget, brownout_level
from spark_bam_tpu_torch.obs import flight
from spark_bam_tpu_torch.serve import shm
from spark_bam_tpu_torch.serve.admission import CLASS_OF
from spark_bam_tpu_torch.serve.protocol import error_response, ok_response
from spark_bam_tpu_torch.serve.server import MAX_LINE, ServeAddress
from spark_bam_tpu_torch.serve.service import unsupported_response

#: ops safe to re-dispatch after a mid-request worker death: pure reads
#: whose answers are deterministic for unchanged files, plus ``rewrite``
#: (its output commit is atomic: a re-run overwrites, never interleaves)
#: and the durable-job control ops (``submit`` keys a job by a hash of its
#: spec and resumes from the journal; status and cancel are lookups).
IDEMPOTENT_OPS = frozenset(
    {"plan", "record_starts", "count", "batch", "aggregate", "rewrite",
     "submit", "job_status", "job_cancel"}
)

#: ops the router answers ``Unsupported`` itself, as the port's worker does,
#: until the ROADMAP item its message names ports them.
_ROUTER_UNSERVED = frozenset({"telemetry"})

#: job states the orphan watchdog stops tracking.
_JOB_TERMINAL = frozenset({"done", "failed", "cancelled"})


class WorkerLost(ConnectionError):
    """The worker died (or its link closed) with this request pending."""


def rendezvous_weight(wid: str, path: str) -> int:
    """Stable highest-random-weight score for (worker, path). blake2b,
    not ``hash()`` — placement must agree across processes and runs."""
    h = hashlib.blake2b(f"{wid}|{path}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class WorkerLink:
    """One multiplexed upstream connection to a serve worker.

    Requests are re-keyed to router-assigned ids so many client
    connections share the link; one reader task resolves responses
    (JSON line + in-order binary frames) back to their futures. A dead
    connection fails every pending future with :class:`WorkerLost` and
    marks the link unhealthy immediately — the health monitor owns
    re-probe and reinstatement.
    """

    def __init__(self, wid: str, address: str):
        self.wid = wid
        self.address = ServeAddress(
            address if str(address).startswith(("unix:", "tcp:"))
            else str(address)
        )
        self.healthy = False
        self.draining = False
        self.breaker = None      # attached by fabric/health.monitor_worker
        self._reader = None
        self._writer = None
        self._reader_task = None
        self._pending: "dict[int, asyncio.Future]" = {}
        # uid → (original client id, op): the postmortem ledger — when
        # the link dies, the flight dump names exactly what was in
        # flight on it (the dead worker can't dump for itself).
        self._pending_meta: "dict[int, tuple]" = {}
        self._next_id = 0
        self._conn_lock = asyncio.Lock()

    @property
    def inflight(self) -> int:
        return len(self._pending)

    async def connect(self) -> None:
        async with self._conn_lock:
            if self._writer is not None:
                return
            if self.address.kind == "unix":
                r, w = await asyncio.open_unix_connection(
                    self.address.path, limit=MAX_LINE
                )
            else:
                r, w = await asyncio.open_connection(
                    self.address.host, self.address.port, limit=MAX_LINE
                )
            self._reader, self._writer = r, w
            self._reader_task = asyncio.ensure_future(self._read_loop())
            self.healthy = True

    async def request(self, req: dict) -> dict:
        """Send ``req`` upstream and await its COMPLETE response (frames
        included). Raises :class:`WorkerLost` if the link dies first."""
        if self._writer is None:
            try:
                await self.connect()
            except (ConnectionError, OSError) as exc:
                self.healthy = False
                raise WorkerLost(f"worker {self.wid}: {exc}") from exc
        self._next_id += 1
        uid = self._next_id
        orig_id = req.get("id")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[uid] = fut
        self._pending_meta[uid] = (orig_id, req.get("op"))
        try:
            self._writer.write(
                (json.dumps({**req, "id": uid}) + "\n").encode()
            )
            await self._writer.drain()
        except (ConnectionError, OSError) as exc:
            self._pending.pop(uid, None)
            self._pending_meta.pop(uid, None)
            self._fail(exc)
            raise WorkerLost(f"worker {self.wid}: {exc}") from exc
        resp = await fut
        resp["id"] = orig_id
        return resp

    async def _read_loop(self) -> None:
        try:
            while True:
                line = await self._reader.readline()
                if not line:
                    raise ConnectionError("worker closed the connection")
                resp = json.loads(line)
                n = int(resp.get("binary_frames") or 0)
                if n:
                    frames = []
                    for _ in range(n):
                        hdr = await self._reader.readexactly(8)
                        (length,) = struct.unpack("<Q", hdr)
                        frames.append(await self._reader.readexactly(length))
                    resp["_binary"] = frames
                self._resolve(resp)
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            self._fail(exc)

    def _resolve(self, resp: dict) -> None:
        """Hand a complete response to its waiting future. A second
        delivery of the same id (duplicate under chaos) finds the future
        already popped and falls on the floor — id-dedup is structural."""
        uid = resp.get("id")
        fut = self._pending.pop(uid, None)
        self._pending_meta.pop(uid, None)
        if fut is not None and not fut.done():
            fut.set_result(resp)

    def eject(self, exc: BaseException) -> None:
        """Forcibly eject the worker: fail every pending future with
        :class:`WorkerLost` and tear the connection down. The health
        monitor calls this on probe timeout — a WEDGED (SIGSTOPped)
        worker keeps its socket open and never answers, so requests in
        flight on it would otherwise hang forever."""
        self._fail(exc)

    def _fail(self, exc: BaseException, expected: bool = False) -> None:
        """Connection-level death: mark down NOW (placement must stop
        choosing this link before any probe runs) and fail all pending.

        Unexpected deaths (everything but a deliberate ``close``) are the
        router-observed ``WorkerLost``: the flight recorder notes the
        lost worker and the request ids in flight on the link, and — when
        ``SPARK_BAM_FLIGHT_DIR`` is set — dumps a postmortem JSONL,
        because a SIGKILLed worker leaves no artifact of its own."""
        self.healthy = False
        pending, self._pending = self._pending, {}
        meta, self._pending_meta = self._pending_meta, {}
        if not expected:
            inflight = [
                {"id": orig_id, "op": op} for orig_id, op in meta.values()
            ]
            flight.record(
                "worker_lost", worker=self.wid, address=self.address.spec,
                error=str(exc), inflight=inflight,
            )
            flight.dump_auto(
                "worker_lost", who=self.wid,
                extra={"worker": self.wid, "address": self.address.spec,
                       "error": str(exc), "inflight": inflight},
            )
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(
                    WorkerLost(f"worker {self.wid} died: {exc}")
                )
        self._teardown()

    def _teardown(self) -> None:
        w, self._writer = self._writer, None
        self._reader = None
        if w is not None:
            try:
                w.close()
            except Exception:
                pass

    async def close(self) -> None:
        self.healthy = False
        if self._reader_task is not None:
            self._reader_task.cancel()
            self._reader_task = None
        self._fail(ConnectionError("link closed"), expected=True)


class Router:
    """Fabric front end; see the module docstring. Lives on one event
    loop (the serve accept loop's); ``submit`` returns an awaitable, so
    it slots into ``server._handle_connection`` where a
    :class:`~spark_bam_tpu_torch.serve.service.SplitService` otherwise goes.
    """

    def __init__(self, addresses: "list[str]",
                 config: "Config | None" = None):
        self.config = config if config is not None else Config()
        self.fcfg: FabricConfig = self.config.fabric_config
        self.policy: FaultPolicy = self.config.fault_policy
        # Chaos is decided HERE, once: a configured fabric gets chaos
        # link subclasses and (for accept>0) a delaying submit wrapper;
        # an unconfigured fabric gets the plain classes — zero chaos
        # branches anywhere on its hot path.
        self.chaos = None
        if self.fcfg.chaos:
            from spark_bam_tpu_torch.fabric.chaos import (
                ChaosWorkerLink,
                FabricChaos,
                install_context,
                parse_fabric_chaos,
            )
            seed, spec = parse_fabric_chaos(self.fcfg.chaos)
            self.chaos = FabricChaos(seed, spec)
            install_context(self.chaos)
            self.links = [
                ChaosWorkerLink(f"w{i}", addr, self.chaos)
                for i, addr in enumerate(addresses)
            ]
            if spec.accept > 0:
                self.submit = self._chaos_submit
        else:
            self.links = [
                WorkerLink(f"w{i}", addr) for i, addr in enumerate(addresses)
            ]
        self.budget = RetryBudget(self.fcfg.budget, self.fcfg.budget_rate)
        # Descriptor relay: the accept loop reads these to answer ``hello``
        # exactly as it does for a worker, so a local client maps the
        # router's ring; ring sizing comes from the fleet's serve config.
        scfg = self.config.serve_config
        self.shm_enabled = bool(self.fcfg.shm) and bool(scfg.shm)
        self.shm_bytes = int(scfg.shm_bytes)
        self.shm_wait_ms = float(scfg.shm_wait_ms)
        self.shm_chaos = None   # fleet chaos hits links, not the client ring
        self._latency = LatencyTracker(window=128)
        self.draining = False
        self.counters: "dict[str, int]" = {}
        # Autoscale move ledger: {t, worker, move, reason}, so the
        # ``alerts`` op answers "why did the fleet downscale" by itself.
        self.moves: "deque[dict]" = deque(maxlen=256)
        # Durable-job ownership: job_id → {"req": the original submit,
        # "wid": the owning worker, "state": the last seen}. The watchdog
        # re-dispatches jobs whose owner died; status and cancel go to
        # the owner.
        self._job_owners: "dict[str, dict]" = {}
        self._tasks: "list[asyncio.Task]" = []
        self._start_task: "asyncio.Task | None" = None

    # ------------------------------------------------------------ lifecycle
    async def ensure_started(self) -> None:
        """Connect links and spawn health/autoscale loops on the RUNNING
        loop — lazily, because the serve accept loop owns the loop and
        only enters async context once a request arrives. Concurrent
        first requests all await the SAME bring-up task: routing before
        the links connect would misread every worker as unhealthy."""
        if self._start_task is None:
            self._start_task = asyncio.ensure_future(self._start())
        await self._start_task

    async def _start(self) -> None:
        for link in self.links:
            try:
                await link.connect()
            except Exception:
                link.healthy = False   # monitor takes it from here
        from spark_bam_tpu_torch.fabric.autoscaler import autoscale_worker
        from spark_bam_tpu_torch.fabric.health import monitor_worker

        for link in self.links:
            self._tasks.append(asyncio.ensure_future(
                monitor_worker(link, self.fcfg, self._count)
            ))
            self._tasks.append(asyncio.ensure_future(
                autoscale_worker(link, self.fcfg, self._count,
                                 note_move=self._note_move,
                                 hold=self._autoscale_hold)
            ))
        self._tasks.append(asyncio.ensure_future(self._job_watchdog()))

    async def aclose(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        for link in self.links:
            await link.close()

    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        # _count call sites, all enumerated in obs/names.py
        obs.count(f"fabric.{name}", n)

    def _note_move(self, entry: dict) -> None:
        """Autoscaler move-ledger hook: stamp and retain the move (with
        its cited reason) and mirror it into the flight recorder."""
        entry = dict(entry, t=round(time.time(), 3))
        self.moves.append(entry)
        flight.record("autoscale_move", **entry)

    # ------------------------------------------------------------ placement
    def healthy_links(self, exclude=()) -> "list[WorkerLink]":
        return [l for l in self.links
                if l.healthy and not l.draining and l.wid not in exclude]

    def pick(self, path: "str | None",
             exclude=()) -> "WorkerLink | None":
        """Affinity target (rendezvous winner) unless saturated, else
        least-loaded; path-less requests always go least-loaded."""
        cands = self.healthy_links(exclude)
        if not cands:
            return None
        if path:
            primary = max(
                cands, key=lambda l: rendezvous_weight(l.wid, str(path))
            )
            if primary.inflight < self.fcfg.spill:
                return primary
            spill = min(cands, key=lambda l: l.inflight)
            if spill is not primary:
                self._count("spilled")
            return spill
        return min(cands, key=lambda l: l.inflight)

    # ----------------------------------------------------------- resilience
    def _shed_hint_ms(self, hint_ms: float = 0.0) -> float:
        """Pacing hint for a shed response: the upstream worker's own
        ``retry_after_ms`` when it sent one, else the router's rolling
        relay-latency median — a worker too overloaded to even attach a
        hint shouldn't earn an IMMEDIATE retry. Jittered (``FaultPolicy.
        jitter``) so a thundering herd of pacing clients decorrelates."""
        if hint_ms > 0:
            return hint_ms
        med = self._latency.median()
        if med is None:
            return 0.0
        j = self.policy.jitter
        return med * (1.0 - j + 2.0 * j * random.random())

    def _brownout(self) -> int:
        return brownout_level(
            len(self.healthy_links()), len(self.links), self.fcfg,
            self.budget.exhausted,
        )

    def _autoscale_hold(self) -> bool:
        """The autoscaler must not retune workers from brownout traffic —
        shed-heavy stats would read as idleness and downscale the exact
        capacity the fleet is trying to win back."""
        return self._brownout() > 0

    async def _chaos_submit(self, req: dict, conn=None) -> dict:
        """Accept-loop chaos (installed as ``self.submit`` when the spec
        sets ``accept>0``): delay a seeded subset of client requests at
        the fleet edge before normal routing."""
        chaos = self.chaos
        if chaos.roll("accept"):
            obs.count("fabric.chaos.accept_delays")
            await asyncio.sleep(chaos.spec.delay_ms / 1000.0)
        return await Router.submit(self, req, conn=conn)

    # -------------------------------------------------------------- serving
    async def submit(self, req: dict, conn=None) -> dict:
        """The accept loop's entry point (awaitable counterpart of
        ``SplitService.submit``). ``conn`` is the accept loop's
        per-connection transport state: when the client negotiated shm,
        the streaming relay forwards same-host workers' frame
        descriptors instead of re-copying bytes."""
        await self.ensure_started()
        op = req.get("op")
        if op == "ping":
            return ok_response(
                req, pong=True, fabric=True,
                workers=len(self.healthy_links()),
            )
        if op == "stats":
            return await self._stats(req)
        if op == "drain":
            return await self._drain(req)
        if op == "tune":
            return await self._tune(req)
        if op in _ROUTER_UNSERVED:
            return unsupported_response(req)
        if op == "alerts":
            return await self._alerts(req)
        if self.draining:
            return error_response(
                req, "Draining", "fabric is draining; route elsewhere",
            )
        if op in ("submit", "job_status", "job_cancel"):
            return await self._route_job(req)
        return await self._route(req, conn=conn)

    async def _route(self, req: dict, conn=None) -> dict:
        op = req.get("op")
        path = req.get("path")
        self.budget.note_request()
        level = self._brownout()
        if level and (level >= 2 or CLASS_OF.get(op) == "scan"):
            # Shed at the edge, BEFORE placement: brownout exists to keep
            # the survivors' queues from collapsing under full load.
            self._count("brownout_shed")
            return error_response(
                req, "Overloaded",
                f"fabric brownout (level {level}): shedding "
                f"{CLASS_OF.get(op, op)}-class work",
                retry_after_ms=round(self._shed_hint_ms(), 3),
            )
        if op in ("batch", "aggregate") and self.fcfg.stream:
            return await self._stream_route(req, conn=conn)
        idempotent = op in IDEMPOTENT_OPS
        shed_resp = None
        for round_no in range(self.policy.max_retries + 1):
            tried: set = set()
            while True:
                link = self.pick(path, exclude=tried)
                if link is None:
                    break           # every healthy worker tried this round
                tried.add(link.wid)
                t0 = time.monotonic()
                try:
                    resp = await link.request(req)
                except WorkerLost:
                    if not idempotent:
                        self._count("lost")
                        return error_response(
                            req, "WorkerLost",
                            f"worker {link.wid} died mid-{op}; "
                            "op is not re-dispatchable",
                        )
                    if not self.budget.try_spend():
                        # Budget empty: surfacing the loss beats joining
                        # a retry storm. The client owns the next retry.
                        self._count("lost")
                        self._count("budget_exhausted")
                        return error_response(
                            req, "WorkerLost",
                            f"worker {link.wid} died mid-{op}; "
                            "retry budget exhausted",
                        )
                    self._count("failovers")
                    self._count("budget_spent")
                    continue        # re-dispatch (budget-gated)
                if (resp.get("ok") is False
                        and resp.get("error") in ("Overloaded", "Draining")):
                    shed_resp = resp
                    continue        # spill to the next-best worker
                self._latency.record((time.monotonic() - t0) * 1000.0)
                self._count("routed")
                return resp
            if shed_resp is None:
                return error_response(
                    req, "WorkerLost", "no healthy workers in the fabric",
                )
            if round_no >= self.policy.max_retries:
                break
            if not self.budget.try_spend():
                self._count("budget_exhausted")
                break               # relay the shed answer; client paces
            self._count("budget_spent")
            hint_ms = self._shed_hint_ms(
                float(shed_resp.get("retry_after_ms") or 0.0)
            )
            await asyncio.sleep(
                max(hint_ms / 1000.0, self.policy.backoff_delay(round_no))
            )
        self._count("relayed_overload")
        return shed_resp

    # ------------------------------------------------------------ job plane
    def _link_by_wid(self, wid: str) -> "WorkerLink | None":
        return next((l for l in self.links if l.wid == wid), None)

    def _note_job(self, jid: str, resp: dict, req=None, wid=None) -> None:
        """Update the ownership table from a job response."""
        entry = self._job_owners.get(jid)
        if entry is None:
            if req is None or wid is None:
                return
            entry = self._job_owners[jid] = {"req": dict(req), "wid": wid}
        if wid is not None:
            entry["wid"] = wid
        state = resp.get("state")
        if state:
            entry["state"] = state

    async def _route_job(self, req: dict) -> dict:
        """Job-plane routing: ``submit`` places by path affinity and fails
        over across workers (the deterministic job id and the shared
        journal dir make a re-dispatch resume, not restart);
        ``job_status`` and ``job_cancel`` go to the job's owner."""
        op = req.get("op")
        self.budget.note_request()
        if op == "submit":
            tried: set = set()
            while True:
                link = self.pick(req.get("path"), exclude=tried)
                if link is None:
                    return error_response(
                        req, "WorkerLost",
                        "no healthy workers in the fabric",
                    )
                tried.add(link.wid)
                try:
                    resp = await link.request(req)
                except WorkerLost:
                    if not self.budget.try_spend():
                        self._count("lost")
                        self._count("budget_exhausted")
                        return error_response(
                            req, "WorkerLost",
                            f"worker {link.wid} died mid-submit; "
                            "retry budget exhausted",
                        )
                    self._count("failovers")
                    self._count("budget_spent")
                    continue
                if resp.get("ok") and resp.get("job_id"):
                    self._note_job(
                        resp["job_id"], resp, req=req, wid=link.wid
                    )
                self._count("routed")
                return resp
        # status and cancel: the owner first; after a rescue re-homed the
        # job any healthy worker can answer.
        jid = req.get("job_id")
        entry = self._job_owners.get(jid) if jid else None
        link = None
        if entry is not None:
            owner = self._link_by_wid(entry["wid"])
            if owner is not None and owner.healthy and not owner.draining:
                link = owner
        if link is None:
            link = self.pick(None)
        if link is None:
            return error_response(
                req, "WorkerLost", "no healthy workers in the fabric",
            )
        try:
            resp = await link.request(req)
        except WorkerLost:
            return error_response(
                req, "WorkerLost", f"worker {link.wid} died mid-{op}",
            )
        if resp.get("ok") and jid:
            self._note_job(jid, resp)
        self._count("routed")
        return resp

    async def _job_watchdog(self) -> None:
        """Orphan rescue: a tracked, unfinished job whose owner's link is
        down has its original ``submit`` re-sent to a survivor, which
        resumes it from the journal in the shared jobs dir. Budget-gated
        like any failover."""
        interval = max(self.fcfg.probe_ms / 1000.0, 0.05)
        while True:
            await asyncio.sleep(interval)
            for jid, entry in list(self._job_owners.items()):
                if entry.get("state") in _JOB_TERMINAL:
                    continue
                owner = self._link_by_wid(entry["wid"])
                if owner is not None and owner.healthy:
                    continue
                nxt = self.pick(entry["req"].get("path"),
                                exclude={entry["wid"]})
                if nxt is None or not self.budget.try_spend():
                    continue
                self._count("budget_spent")
                try:
                    resp = await nxt.request(dict(entry["req"]))
                except WorkerLost:
                    continue
                if resp.get("ok"):
                    self._count("job_rescues")
                    flight.record("job_rescue", job_id=jid,
                                  worker=nxt.wid, was=entry["wid"])
                    self._note_job(jid, resp, wid=nxt.wid)

    # ------------------------------------------------------------ streaming
    @staticmethod
    def _link_local(link: WorkerLink) -> bool:
        """Whether the worker plausibly shares this host — the only
        placement where relaying its shm descriptors can work (the
        client must be able to map the segment path)."""
        addr = link.address
        if addr.kind == "unix":
            return True
        host = str(addr.host)
        return host.startswith("127.") or host in ("::1", "localhost")

    async def _stream_open(self, link: WorkerLink, req: dict,
                           resume_from: int, shm_offer: bool = False):
        """Open a DEDICATED upstream connection for one streaming
        response and read its head. The multiplexed link must buffer
        complete responses (frames from different requests would
        interleave); a stream gets its own socket so the router can relay
        frames the moment they arrive. With ``shm_offer`` a ``hello``
        rides the SAME buffered write as the request (one syscall, no
        extra round-trip); a granted upstream answers with frame
        descriptors the relay forwards without touching the bytes.
        Returns ``(head, reader, writer, up_shm)`` — ``up_shm`` is the
        granted ``{"segment", "segment_id"}`` or None; raises
        :class:`WorkerLost` when the worker can't be reached or dies
        before the head."""
        addr = link.address
        try:
            if addr.kind == "unix":
                reader, writer = await asyncio.open_unix_connection(
                    addr.path, limit=MAX_LINE
                )
            else:
                reader, writer = await asyncio.open_connection(
                    addr.host, addr.port, limit=MAX_LINE
                )
        except (ConnectionError, OSError) as exc:
            raise WorkerLost(f"worker {link.wid}: {exc}") from exc
        fwd = {k: v for k, v in req.items() if k != "id"}
        fwd["id"] = 1
        if resume_from:
            fwd["resume_from"] = int(resume_from)
        try:
            payload = b""
            if shm_offer:
                payload += (json.dumps(
                    {"op": "hello", "transport": "shm", "id": 0}
                ) + "\n").encode()
            payload += (json.dumps(fwd) + "\n").encode()
            writer.write(payload)
            await writer.drain()
            up_shm = None
            if shm_offer:
                hline = await reader.readline()
                if not hline:
                    raise ConnectionError("worker closed during hello")
                h = json.loads(hline)
                if h.get("ok") and h.get("transport") == "shm":
                    up_shm = {"segment": str(h["segment"]),
                              "segment_id": int(h["segment_id"])}
            line = await reader.readline()
            if not line:
                raise ConnectionError("worker closed before the stream head")
            head = json.loads(line)
        except (ConnectionError, OSError, ValueError, KeyError,
                asyncio.IncompleteReadError) as exc:
            try:
                writer.close()
            except Exception:
                pass
            raise WorkerLost(f"worker {link.wid}: {exc}") from exc
        return head, reader, writer, up_shm

    async def _stream_route(self, req: dict, conn=None) -> dict:
        """Streaming relay for ``batch`` (``stream=1``): forward the head
        as soon as the first worker answers, then hand the accept loop an
        async frame iterator (``_binary_iter``) that relays each frame as
        it arrives. A mid-stream :class:`WorkerLost` at frame N re-opens
        on a replacement worker with ``resume_from = N`` (plus whatever
        resume base the CLIENT sent — the token composes end-to-end), so
        the delivered frame sequence is byte-identical to an undisturbed
        run without the router ever buffering the response.

        When the CLIENT negotiated shm (``conn.transport == "shm"``) and
        the chosen worker is same-host and grants shm upstream, the
        relay switches to DESCRIPTOR mode (``_records_iter``): the
        worker's segment is announced downstream under a router-assigned
        id and its descriptors are remapped and forwarded — the frame
        bytes never enter router memory, and the client acks straight
        into the worker's ring. Any other combination (socket client,
        remote worker, shm-less worker, failover onto one) degrades to
        byte relay per frame — inline records downstream cost one copy,
        exactly the classic path."""
        path = req.get("path")
        client_base = int(req.get("resume_from") or 0)
        want_shm = (conn is not None
                    and getattr(conn, "transport", "socket") == "shm"
                    and bool(self.fcfg.shm))
        tried: set = set()
        shed_resp = None
        while True:
            link = self.pick(path, exclude=tried)
            if link is None:
                if shed_resp is not None:
                    self._count("relayed_overload")
                    return shed_resp
                return error_response(
                    req, "WorkerLost", "no healthy workers in the fabric",
                )
            tried.add(link.wid)
            try:
                head, reader, writer, up_shm = await self._stream_open(
                    link, req, client_base,
                    shm_offer=want_shm and self._link_local(link),
                )
            except WorkerLost:
                if not self.budget.try_spend():
                    self._count("lost")
                    self._count("budget_exhausted")
                    return error_response(
                        req, "WorkerLost",
                        f"worker {link.wid} died opening stream; "
                        "retry budget exhausted",
                    )
                self._count("failovers")
                self._count("budget_spent")
                continue
            if head.get("ok") is False:
                try:
                    writer.close()
                except Exception:
                    pass
                if head.get("error") in ("Overloaded", "Draining"):
                    shed_resp = dict(head, id=req.get("id"))
                    continue        # spill to the next-best worker
                return dict(head, id=req.get("id"))   # typed worker error
            break
        total = int(head.get("binary_frames") or 0)
        self._count("routed")
        self._count("streamed")

        async def frames():
            nonlocal reader, writer
            delivered = 0
            cur_wid = link.wid
            chaos = self.chaos
            try:
                while delivered < total:
                    try:
                        if chaos is not None and chaos.roll("trunc"):
                            obs.count("fabric.chaos.truncs")
                            raise ConnectionError("chaos: stream truncated")
                        hdr = await reader.readexactly(8)
                        (length,) = struct.unpack("<Q", hdr)
                        frame = await reader.readexactly(length)
                    except (ConnectionError, OSError,
                            asyncio.IncompleteReadError) as exc:
                        flight.record(
                            "stream_lost", worker=cur_wid,
                            op=req.get("op", "batch"),
                            delivered=delivered, total=total,
                            error=str(exc),
                        )
                        reader, writer, cur_wid, _ = (
                            await self._stream_resume(
                                req, cur_wid,
                                client_base + delivered, total - delivered,
                                writer,
                            )
                        )
                        continue
                    delivered += 1
                    self._count("stream_frames")
                    yield frame
            finally:
                try:
                    writer.close()
                except Exception:
                    pass

        async def records():
            # Descriptor relay: upstream RECORDS in, remapped records
            # out. ``segmap`` translates worker segment ids into this
            # downstream connection's id space (drawn from the same
            # allocator as the connection's own ring, so they can never
            # collide); a failover onto a shm-less upstream downgrades
            # to wrapping its plain frames as inline records mid-stream.
            nonlocal reader, writer
            delivered = 0
            cur_wid = link.wid
            chaos = self.chaos
            up_mode = "records"
            segmap: "dict[int, int]" = {}
            ds = conn.alloc_seg_id()
            segmap[int(up_shm["segment_id"])] = ds
            obs.count("transport.segment_announces")
            yield shm.pack_segment(ds, up_shm["segment"])
            try:
                while delivered < total:
                    try:
                        if chaos is not None and chaos.roll("trunc"):
                            obs.count("fabric.chaos.truncs")
                            raise ConnectionError("chaos: stream truncated")
                        if up_mode == "frames":
                            hdr = await reader.readexactly(8)
                            (length,) = struct.unpack("<Q", hdr)
                            rec = shm.pack_inline(
                                await reader.readexactly(length)
                            )
                        else:
                            kb = await reader.readexactly(1)
                            kind = kb[0]
                            if kind == shm.REC_SEGMENT:
                                body = await reader.readexactly(
                                    shm.SEG.size
                                )
                                up_id, plen = shm.SEG.unpack(body)
                                spath = (
                                    await reader.readexactly(plen)
                                ).decode()
                                nds = conn.alloc_seg_id()
                                segmap[up_id] = nds
                                obs.count("transport.segment_announces")
                                yield shm.pack_segment(nds, spath)
                                continue    # announces aren't frames
                            if kind == shm.REC_INLINE:
                                hdr = await reader.readexactly(8)
                                (length,) = struct.unpack("<Q", hdr)
                                rec = kb + hdr + (
                                    await reader.readexactly(length)
                                )
                            elif kind == shm.REC_SHM:
                                body = await reader.readexactly(
                                    shm.DESC.size
                                )
                                up_id, offset, length, crc = (
                                    shm.DESC.unpack(body)
                                )
                                mapped = segmap.get(up_id)
                                if mapped is None:
                                    raise ConnectionError(
                                        "descriptor for unannounced "
                                        f"segment {up_id}"
                                    )
                                obs.count("transport.relay_descriptors")
                                rec = shm.pack_desc(
                                    mapped, offset, length, crc
                                )
                            else:
                                raise ConnectionError(
                                    f"unknown record kind {kind}"
                                )
                    except (ConnectionError, OSError,
                            asyncio.IncompleteReadError) as exc:
                        flight.record(
                            "stream_lost", worker=cur_wid,
                            op=req.get("op", "batch"),
                            delivered=delivered, total=total,
                            error=str(exc),
                        )
                        reader, writer, cur_wid, new_shm = (
                            await self._stream_resume(
                                req, cur_wid,
                                client_base + delivered, total - delivered,
                                writer, shm_offer=True,
                            )
                        )
                        if new_shm is not None:
                            # Replacement worker's segment, fresh id —
                            # the failover re-announce.
                            up_mode = "records"
                            segmap = {}
                            nds = conn.alloc_seg_id()
                            segmap[int(new_shm["segment_id"])] = nds
                            obs.count("transport.segment_announces")
                            yield shm.pack_segment(nds, new_shm["segment"])
                        else:
                            up_mode = "frames"
                        continue
                    delivered += 1
                    self._count("stream_frames")
                    yield rec
            finally:
                try:
                    writer.close()
                except Exception:
                    pass

        resp = {k: v for k, v in head.items()
                if k not in ("resume_from", "total_frames")}
        resp["id"] = req.get("id")
        resp["binary_frames"] = total
        if want_shm and up_shm is not None:
            resp["_records_iter"] = records()
        else:
            resp["_binary_iter"] = frames()
        return resp

    async def _stream_resume(self, req: dict, dead_wid: str,
                             resume_from: int, need: int, old_writer,
                             shm_offer: bool = False):
        """Find a replacement worker mid-stream and re-open from the
        resume token. Budget-gated like any failover; raises
        :class:`WorkerLost` when the budget or the fleet runs out (the
        accept loop then ABORTS the client connection — a half-delivered
        frame sequence must never look complete). Returns ``(reader,
        writer, wid, up_shm)`` — ``up_shm`` is the replacement's granted
        segment when ``shm_offer`` held and the worker is same-host."""
        try:
            old_writer.close()
        except Exception:
            pass
        exclude = {dead_wid}
        while True:
            if not self.budget.try_spend():
                self._count("budget_exhausted")
                raise WorkerLost(
                    f"stream lost at resume_from={resume_from}; "
                    "retry budget exhausted"
                )
            self._count("failovers")
            self._count("budget_spent")
            nxt = self.pick(req.get("path"), exclude=exclude)
            if nxt is None:
                raise WorkerLost("no healthy workers to resume the stream")
            try:
                head, reader, writer, up_shm = await self._stream_open(
                    nxt, req, resume_from,
                    shm_offer=shm_offer and self._link_local(nxt),
                )
            except WorkerLost:
                exclude.add(nxt.wid)
                continue
            if head.get("ok") is False:
                try:
                    writer.close()
                except Exception:
                    pass
                if head.get("error") in ("Overloaded", "Draining"):
                    await asyncio.sleep(max(
                        self._shed_hint_ms(
                            float(head.get("retry_after_ms") or 0.0)
                        ) / 1000.0,
                        self.policy.backoff_delay(0),
                    ))
                    continue
                raise WorkerLost(
                    f"worker {nxt.wid} refused stream resume: "
                    f"{head.get('error')}"
                )
            got = int(head.get("binary_frames") or 0)
            if got != need:
                try:
                    writer.close()
                except Exception:
                    pass
                raise WorkerLost(
                    f"resume mismatch: worker {nxt.wid} offered {got} "
                    f"frames at resume_from={resume_from}, need {need}"
                )
            self._count("resumed")
            flight.record("stream_resume", worker=nxt.wid,
                          resume_from=resume_from, frames=need)
            return reader, writer, nxt.wid, up_shm

    # ------------------------------------------------------------ admin ops
    def _admin_targets(self, req: dict) -> "list[WorkerLink]":
        wid = req.get("worker")
        if wid is None:
            return list(self.links)
        links = [l for l in self.links if l.wid == wid]
        if not links:
            raise KeyError(f"unknown worker {wid!r}")
        return links

    async def _forward_admin(self, req: dict,
                             links: "list[WorkerLink]") -> dict:
        fwd = {k: v for k, v in req.items() if k != "worker"}

        async def one(link):
            try:
                resp = await link.request(dict(fwd))
                return {k: v for k, v in resp.items() if k != "id"}
            except Exception as exc:
                return {"ok": False, "error": "WorkerLost", "message": str(exc)}

        results = await asyncio.gather(*(one(l) for l in links))
        return {l.wid: r for l, r in zip(links, results)}

    async def _drain(self, req: dict) -> dict:
        """Router-level graceful drain: stop routing new work, forward
        ``drain`` so each worker refuses its own new arrivals, report the
        remaining inflight so the operator can watch it reach zero. A
        ``worker`` field narrows the drain to one worker (the router just
        stops placing work there)."""
        try:
            links = self._admin_targets(req)
        except KeyError as exc:
            return error_response(req, "ProtocolError", str(exc))
        if req.get("worker") is None:
            self.draining = True
        for link in links:
            link.draining = True
        self._count("drained", len(links))
        per_worker = await self._forward_admin({"op": "drain"}, links)
        return ok_response(
            req, draining=True,
            workers={w: r.get("inflight") for w, r in per_worker.items()},
        )

    async def _tune(self, req: dict) -> dict:
        """Fan a ``tune`` out to one worker (``worker`` field) or all —
        the autoscaler uses the per-worker form; operators may broadcast."""
        try:
            links = self._admin_targets(req)
        except KeyError as exc:
            return error_response(req, "ProtocolError", str(exc))
        per_worker = await self._forward_admin(req, links)
        ok = all(r.get("ok") for r in per_worker.values())
        if not ok:
            return error_response(
                req, "Internal", "tune failed on some workers",
                workers=per_worker,
            )
        return ok_response(req, workers=per_worker)

    async def _stats(self, req: dict) -> dict:
        links = list(self.links)

        async def one(link):
            if not link.healthy:
                return None
            try:
                resp = await link.request({"op": "stats"})
            except Exception:
                return None
            return {k: v for k, v in resp.items() if k not in ("id", "ok")}

        upstream = await asyncio.gather(*(one(l) for l in links))
        workers = {
            l.wid: {
                "address": l.address.spec,
                "healthy": bool(l.healthy),
                "draining": bool(l.draining),
                "inflight": int(l.inflight),
                "breaker": (l.breaker.state if l.breaker is not None
                            else None),
                "stats": stats,
            }
            for l, stats in zip(links, upstream)
        }
        extra = {}
        if self.chaos is not None:
            extra["chaos"] = {
                "seed": self.chaos.seed,
                "spec": self.chaos.describe(),
                "injected": dict(self.chaos.injected),
            }
        return ok_response(
            req, fabric=True, draining=bool(self.draining),
            counters=dict(sorted(self.counters.items())),
            budget={
                "tokens": round(self.budget.tokens, 3),
                "capacity": self.budget.capacity,
                "spent": self.budget.spent,
                "denied": self.budget.denied,
            },
            brownout=self._brownout(),
            moves=list(self.moves),
            workers=workers,
            **extra,
        )

    async def _alerts(self, req: dict) -> dict:
        """Fleet alert view: every healthy worker's SLO status plus the
        router's autoscale move ledger, the one payload that answers
        "what is firing and what did the fleet do about it"."""
        links = [l for l in self.links if l.healthy]
        per_worker = await self._forward_admin({"op": "alerts"}, links)
        firing = sorted({
            name
            for r in per_worker.values()
            for name in (r.get("slo") or {}).get("firing", ())
        })
        ledger = sorted(
            (dict(e, worker=w)
             for w, r in per_worker.items()
             for e in (r.get("slo") or {}).get("ledger", ())),
            key=lambda e: e.get("t", 0.0),
        )
        return ok_response(
            req, fabric=True, firing=firing, ledger=ledger,
            moves=list(self.moves), workers=per_worker,
        )
