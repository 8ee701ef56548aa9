"""Fleet-level deterministic chaos: faults at the fabric and protocol seam
(reference ``spark_bam_tpu/fabric/chaos.py``; the same grammar and the same
splitmix64 rolls, so one seed gives both packages one fault schedule).

Every fault decision is a pure function of ``(seed, kind, event index)``
(``core/faults.py`` ``_mix`` and ``_roll``), so a chaos run's artifacts
carry everything needed to reproduce it: the seed and spec land in every
flight-recorder dump through ``obs.flight``'s dump context.

Installed via the fabric spec — ``--fabric "...,chaos=SEED:SPEC"`` —
where SPEC is ``+``-separated ``k=v`` entries (``+`` because the outer
fabric spec already splits on commas; ``,`` also works when the spec is
parsed standalone):

    chaos=42:drop=0.05+delay=0.1x20+trunc=0.02+dup=0.05+slow=0.1x5+accept=0.05

Faults at the router↔worker link (:class:`ChaosWorkerLink`, substituted
for ``WorkerLink`` at router construction — the plain link class carries
ZERO chaos branches, so an unconfigured fabric pays nothing):

- ``drop``   — sever the connection before a send: every request pending
  on the link fails with ``WorkerLost`` (failover/budget path).
- ``delay``  — hold a response ``delay_ms`` before resolving it: delayed
  responses complete after later-arriving peers, i.e. reordering (safe
  because responses are id-keyed to futures — the property under test).
- ``trunc``  — kill the connection mid-response-stream: the router sees
  a frame sequence cut short (the resume-token path for streaming ops).
- ``dup``    — deliver a response twice: the second copy must fall on
  the floor (its future was already popped).
- ``slow``   — slow-link throttle: ``slow_ms`` extra latency per send.
- ``accept`` — delay at the client↔router accept loop (edge latency).

Faults at the shared-memory transport seam (rolled by the serve accept
loop per frame record when any rate is set: ``serve/service.py`` builds a
:class:`FabricChaos` from the same ``chaos=`` spec):

- ``shm_crc``    — corrupt a descriptor's guard crc: the client must
  detect the mismatch and resume, never trust the frame.
- ``shm_trunc``  — cut the connection mid-descriptor: a half-written
  record then a hard abort (the resume-token path).
- ``shm_unlink`` — unlink the ring segment mid-stream: frames already
  described stay readable; later frames fall back to inline records.

Process-level storms (:func:`storm_schedule` + :class:`ChaosStorm`,
driving a ``WorkerPool``): seeded rolling SIGKILL (**crash** — the
worker vanishes, TCP resets, the router fails over instantly) and
SIGSTOP (**wedge** — the worker stays connected but answers nothing;
only the probe timeout can eject it, the strictly harder failure). Dead
workers respawn on their original port after ``revive_ms`` so a long
storm rolls across the fleet instead of annihilating it.
"""

from __future__ import annotations

import asyncio
import json
import struct
import threading
import time
from dataclasses import dataclass

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core.faults import _mix, _roll
from spark_bam_tpu_torch.fabric.router import WorkerLink, WorkerLost
from spark_bam_tpu_torch.obs import flight

#: distinct splitmix64 streams per fault kind (the reference keeps 1..4
#: for its byte-channel kinds; the fleet kinds extend the space).
_KINDS = {
    "drop": 11, "delay": 12, "trunc": 13, "dup": 14, "slow": 15,
    "accept": 16, "storm": 17, "shm_crc": 18, "shm_trunc": 19,
    "shm_unlink": 20,
}


@dataclass(frozen=True)
class FabricChaosSpec:
    """Which fleet faults to inject and how often. Rates are per event
    (request sent / response received / connection accepted); the storm
    fields size the :func:`storm_schedule` a caller drives."""

    drop: float = 0.0      # connection-drop rate (per request send)
    delay: float = 0.0     # response-delay rate (per response)
    delay_ms: float = 20.0
    trunc: float = 0.0     # mid-stream truncation rate (per response)
    dup: float = 0.0       # duplicate-delivery rate (per response)
    slow: float = 0.0      # slow-link rate (per request send)
    slow_ms: float = 5.0
    accept: float = 0.0    # accept-loop delay rate (per request)
    # shm-transport seam (serve/shm.py; rolled per frame record by the
    # serve accept loop, not the router: the faults live where the
    # descriptors are minted):
    shm_crc: float = 0.0     # stale/corrupt descriptor crc rate
    shm_trunc: float = 0.0   # descriptor truncated mid-record rate
    shm_unlink: float = 0.0  # segment unlinked mid-stream rate
    kills: int = 0         # storm: SIGKILL events
    wedges: int = 0        # storm: SIGSTOP (wedge) events
    storm_ms: float = 500.0   # storm: pacing between events
    revive_ms: float = 400.0  # storm: kill→respawn / wedge→SIGCONT delay

    _FLOAT = ("drop", "delay", "trunc", "dup", "slow", "accept",
              "shm_crc", "shm_trunc", "shm_unlink",
              "storm_ms", "revive_ms")
    _INT = ("kills", "wedges")

    @staticmethod
    def parse(spec: str) -> "FabricChaosSpec":
        """``"drop=0.05+delay=0.1x20+kills=5+wedges=1"`` — entries split
        on ``+`` (or ``,`` standalone); ``delay``/``slow`` take the same
        optional ``xMS`` suffix as the byte-channel chaos grammar."""
        kw: dict = {}
        norm = (spec or "").replace("+", ",")
        for part in norm.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"Bad fabric-chaos entry {part!r} in {spec!r}")
            key, value = (t.strip() for t in part.split("=", 1))
            key = {"storm": "storm_ms", "revive": "revive_ms"}.get(key, key)
            if key in ("delay", "slow") and "x" in value:
                rate, ms = value.split("x", 1)
                kw[key], kw[f"{key}_ms"] = float(rate), float(ms)
            elif key in FabricChaosSpec._FLOAT:
                kw[key] = float(value)
            elif key in FabricChaosSpec._INT:
                kw[key] = int(value)
            else:
                raise ValueError(
                    f"Unknown fabric-chaos key {key!r}: expected one of "
                    f"{', '.join(FabricChaosSpec._FLOAT + FabricChaosSpec._INT)}"
                )
        return FabricChaosSpec(**kw)


def parse_fabric_chaos(arg: str) -> "tuple[int, FabricChaosSpec]":
    """``"SEED:SPEC"`` — the ``chaos=`` value inside a fabric spec."""
    seed, _, spec = arg.partition(":")
    try:
        seed_i = int(seed)
    except ValueError:
        raise ValueError(
            f"Bad fabric-chaos seed {seed!r} in {arg!r} (want SEED:SPEC)"
        ) from None
    return seed_i, FabricChaosSpec.parse(spec)


class FabricChaos:
    """One installation's decision source + injected-fault tallies.

    Decisions key each fault kind's own monotone event counter into the
    splitmix64 roll, so the *set* of faulty event indices is a pure
    function of the seed. All rolls happen on the router's event loop —
    no locks. Tallies mirror into ``fabric.chaos.*`` obs counters."""

    def __init__(self, seed: int, spec: FabricChaosSpec):
        self.seed = int(seed)
        self.spec = spec
        self.injected: "dict[str, int]" = {k: 0 for k in _KINDS}
        self._n: "dict[str, int]" = {k: 0 for k in _KINDS}

    def roll(self, kind: str) -> bool:
        """Deterministic per-event fault decision for ``kind``."""
        rate = getattr(self.spec, kind)
        i = self._n[kind]
        self._n[kind] = i + 1
        if _roll(self.seed, _KINDS[kind], i, rate):
            self.injected[kind] += 1
            return True
        return False

    def describe(self) -> str:
        """Compact ``seed:spec`` string for artifacts/announcements."""
        s = self.spec
        parts = []
        for k in FabricChaosSpec._FLOAT + FabricChaosSpec._INT:
            v = getattr(s, k)
            if v and k not in ("storm_ms", "revive_ms", "delay_ms", "slow_ms"):
                parts.append(f"{k}={v}")
        return f"{self.seed}:{'+'.join(parts)}"


class ChaosWorkerLink(WorkerLink):
    """A ``WorkerLink`` with seeded faults at the protocol seam. The
    router constructs these INSTEAD of plain links when ``chaos=`` is
    set — the base class keeps zero chaos branches.

    Send side: ``drop`` severs the connection (everything pending fails
    with ``WorkerLost``, exactly like a worker crash); ``slow`` adds
    ``slow_ms`` before the send. Receive side (overridden ``_read_loop``):
    ``trunc`` kills the connection mid-response-stream, ``delay`` holds a
    complete response ``delay_ms`` before resolving it (later responses
    on the link overtake it — reordering), ``dup`` resolves a response a
    second time (the duplicate must fall on the floor via id-dedup)."""

    def __init__(self, wid: str, address: str, chaos: "FabricChaos"):
        super().__init__(wid, address)
        self.chaos = chaos

    async def request(self, req: dict) -> dict:
        c = self.chaos
        if c.roll("drop"):
            obs.count("fabric.chaos.drops")
            self._fail(ConnectionError("chaos: connection dropped"))
            raise WorkerLost(f"worker {self.wid}: chaos connection drop")
        if c.roll("slow"):
            obs.count("fabric.chaos.slowed")
            await asyncio.sleep(c.spec.slow_ms / 1000.0)
        return await super().request(req)

    async def _read_loop(self) -> None:
        c = self.chaos
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
                        if c.roll("trunc"):
                            obs.count("fabric.chaos.truncs")
                            raise ConnectionError(
                                "chaos: response truncated mid-frame"
                            )
                        hdr = await self._reader.readexactly(8)
                        (length,) = struct.unpack("<Q", hdr)
                        frames.append(
                            await self._reader.readexactly(length)
                        )
                    resp["_binary"] = frames
                if c.roll("delay"):
                    obs.count("fabric.chaos.delays")
                    # Resolve later WITHOUT blocking the reader: the next
                    # response overtakes this one — reordering, which the
                    # id-keyed futures must absorb.
                    asyncio.get_running_loop().call_later(
                        c.spec.delay_ms / 1000.0, self._resolve, resp
                    )
                    continue
                self._resolve(resp)
                if c.roll("dup"):
                    obs.count("fabric.chaos.dups")
                    self._resolve(dict(resp))   # must fall on the floor
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            self._fail(exc)


def install_context(chaos: "FabricChaos") -> None:
    """Stamp the chaos seed and spec into the flight-recorder dump
    context: any artifact a chaos run leaves behind is reproducible from
    the artifact alone."""
    flight.set_context(chaos_seed=chaos.seed, chaos_spec=chaos.describe())


# ------------------------------------------------------------------ storms
def storm_schedule(seed: int, workers: int,
                   spec: FabricChaosSpec) -> "list[tuple[float, int, str]]":
    """Deterministic rolling storm: ``(at_s, victim, action)`` events,
    ``action`` ∈ {``kill``, ``wedge``}. Victims and the wedge positions
    are splitmix64-drawn from the seed; events pace ``storm_ms`` apart
    so the fleet is hit *rolling*, not all at once."""
    total = spec.kills + spec.wedges
    if total <= 0 or workers <= 0:
        return []
    k = _KINDS["storm"]
    # Draw wedge slots without replacement from the event indices.
    order = sorted(range(total), key=lambda i: _mix(seed, k, 1000 + i))
    wedge_slots = set(order[:spec.wedges])
    out = []
    for i in range(total):
        victim = _mix(seed, k, i) % workers
        action = "wedge" if i in wedge_slots else "kill"
        out.append(((i + 1) * spec.storm_ms / 1000.0, victim, action))
    return out


class ChaosStorm:
    """Drive a :func:`storm_schedule` against a ``WorkerPool`` from a
    background thread (callers are synchronous). Each ``kill`` is a
    SIGKILL followed by a same-port respawn after ``revive_ms``; each
    ``wedge`` is a SIGSTOP followed by SIGCONT — the wedged worker keeps
    its sockets open and says nothing, so only the router's probe
    timeout (breaker path) can get traffic off it."""

    def __init__(self, pool, seed: int, spec: FabricChaosSpec):
        self.pool = pool
        self.seed = int(seed)
        self.spec = spec
        self.schedule = storm_schedule(self.seed, len(pool.procs), spec)
        self.events: "list[dict]" = []
        self._thread = threading.Thread(
            target=self._run, name="chaos-storm", daemon=True
        )

    def start(self) -> "ChaosStorm":
        self._thread.start()
        return self

    def join(self, timeout_s: float = 120.0) -> None:
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            raise TimeoutError("chaos storm did not finish in time")

    def _note(self, action: str, victim: int) -> None:
        ev = {"t": round(time.time(), 3), "victim": victim,
              "action": action}
        self.events.append(ev)
        flight.record("chaos_storm", **ev)
        obs.count(f"fabric.chaos.{'kills' if action == 'kill' else 'wedges'}")

    def _run(self) -> None:
        t0 = time.monotonic()
        revive_s = self.spec.revive_ms / 1000.0
        for at_s, victim, action in self.schedule:
            time.sleep(max(0.0, t0 + at_s - time.monotonic()))
            if action == "kill":
                self.pool.kill(victim, hard=True)
                self._note("kill", victim)
                time.sleep(revive_s)
                try:
                    self.pool.respawn(victim)
                    flight.record("chaos_respawn", victim=victim)
                except Exception as exc:   # a failed respawn ends no storm
                    flight.record("chaos_respawn_failed", victim=victim,
                                  error=str(exc))
            else:
                self.pool.wedge(victim)
                self._note("wedge", victim)
                time.sleep(revive_s)
                self.pool.unwedge(victim)
                flight.record("chaos_unwedge", victim=victim)
