"""The port's fleet chaos and resilience against the JAX package's.

The primitives against the JAX functions on the same inputs: the chaos
spec grammar (accepted and refused specs with their messages), the seeded
rolls of ``FabricChaos`` for several seeds, ``storm_schedule``,
``RetryBudget`` and ``CircuitBreaker`` state sequences under an injected
clock, and ``brownout_level``. Then the reference's chaos tests in the
port's form, over port workers on ``local_mesh(["cpu"])``: reorder, dup
and slow absorbed byte-exactly, drops failing over within the budget, the
streaming relay byte-identical and resumed after a mid-stream cut (over
sockets and over the descriptor relay), each shm fault leaving the
client's frames byte-identical, a wedged worker ejected with its pending
request failed over, brownout shedding scan-class work with a pacing
hint, the autoscaler holding during brownout, the seed in the flight
dumps, and a storm schedule driven against a pool.

Seeds are searched with the same ``_roll`` the injector uses, so each test
states its fault-pattern requirement instead of hard-coding a seed.
"""

import asyncio
import contextlib
import dataclasses
import json
import struct
import threading
import time

import pytest

from spark_bam_tpu.benchmarks.synth import synthetic_fixture
from spark_bam_tpu.fabric import CircuitBreaker as JCircuitBreaker
from spark_bam_tpu.fabric import FabricChaos as JFabricChaos
from spark_bam_tpu.fabric import FabricChaosSpec as JFabricChaosSpec
from spark_bam_tpu.fabric import FabricConfig as JFabricConfig
from spark_bam_tpu.fabric import RetryBudget as JRetryBudget
from spark_bam_tpu.fabric import brownout_level as jbrownout_level
from spark_bam_tpu.fabric import parse_fabric_chaos as jparse_fabric_chaos
from spark_bam_tpu.fabric import storm_schedule as jstorm_schedule
from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.faults import FaultPolicy, _roll
from spark_bam_tpu_torch.fabric import (
    ChaosStorm,
    ChaosWorkerLink,
    CircuitBreaker,
    FabricChaos,
    FabricChaosSpec,
    FabricConfig,
    RetryBudget,
    Router,
    WorkerLink,
    brownout_level,
    parse_fabric_chaos,
    rendezvous_weight,
    storm_schedule,
)
from spark_bam_tpu_torch.fabric.autoscaler import autoscale_worker
from spark_bam_tpu_torch.fabric.chaos import _KINDS
from spark_bam_tpu_torch.fabric.resilience import CLOSED, HALF_OPEN, OPEN
from spark_bam_tpu_torch.obs import flight
from spark_bam_tpu_torch.parallel.mesh import local_mesh
from spark_bam_tpu_torch.serve import (
    ServeClient,
    ServeClientError,
    ServerThread,
    SplitService,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = [pytest.mark.fabric, pytest.mark.chaos]

SERVE_SPEC = "window=64KB,halo=8KB,batch=8,tick=5,workers=4"
QUIET_FABRIC = "probe=60000,autoscale=60000"
COLS = ["pos", "mapq", "name"]


@pytest.fixture(scope="module")
def bam_path(tmp_path_factory):
    return str(synthetic_fixture(tmp_path_factory.mktemp("torch_chaos")))


@pytest.fixture(scope="module")
def small_path(tmp_path_factory):
    """700 reads: a count short enough (~0.1 s on one CPU thread) that the
    fast probes do not roll a drop into nearly every one."""
    return str(synthetic_fixture(tmp_path_factory.mktemp("torch_chaos_s"),
                                 reads=700))


@pytest.fixture(autouse=True)
def _clean_flight_context():
    """Chaos routers stamp the process-wide dump context at construction;
    one test's seed must not leak into the next."""
    yield
    flight.clear_context()


def _service(serve_spec=SERVE_SPEC, **config):
    return SplitService(Config(serve=serve_spec, **config),
                        mesh=local_mesh(["cpu"]))


@contextlib.contextmanager
def _fabric(n=2, fabric_spec=QUIET_FABRIC, serve_spec=SERVE_SPEC):
    """``n`` port workers and a port router on in-process accept loops."""
    services = [_service(serve_spec) for _ in range(n)]
    srvs = [ServerThread(s).start() for s in services]
    addrs = [f"tcp:{h}:{p}" for h, p in (s.address for s in srvs)]
    router = Router(addrs, config=Config(fabric=fabric_spec))
    rsrv = ServerThread(router).start()
    try:
        yield rsrv.address, router, services, addrs
    finally:
        rsrv.stop()
        for s in srvs:
            s.stop()
        for s in services:
            s.close()


@pytest.fixture(scope="module")
def ref_frames(bam_path):
    """A direct worker's undisturbed ``batch`` frames (three and more)."""
    with _fabric(n=1) as (_r, _router, _s, addrs):
        with ServeClient(addrs[0], transport="socket") as c:
            frames = c.request("batch", path=bam_path, columns=COLS,
                               batch_rows=400)["_binary"]
    assert len(frames) >= 5
    return [bytes(f) for f in frames]


def _batch(client, bam_path) -> list:
    resp = client.request("batch", path=bam_path, columns=COLS,
                          batch_rows=400)
    return [bytes(f) for f in resp["_binary"]]


def _find_seed(kind, rate, want_true_before, want_false_at=(), start=1):
    """The smallest seed whose ``kind`` pattern has a True roll among the
    first ``want_true_before`` events and False at every index of
    ``want_false_at``."""
    k = _KINDS[kind]
    for seed in range(start, start + 10_000):
        if any(_roll(seed, k, i, rate) for i in range(want_true_before)) \
                and not any(_roll(seed, k, i, rate) for i in want_false_at):
            return seed
    raise AssertionError("no seed found: the roll distribution is broken")


# ------------------------------------------------------- primitives = JAX
CHAOS_SPECS = [
    "42:", "42:drop=0.05+delay=0.1x25+kills=5+wedges=1",
    "7:slow=0.2x5,dup=0.1", "7:slow=0.2+delay=0.3",
    "1:trunc=0.02+accept=0.05+shm_crc=0.02+shm_trunc=0.1+shm_unlink=0.3",
    "3:storm=900+revive=400+kills=2", "3:storm_ms=10+revive_ms=20",
    "-5:drop=1", "0:drop=0.5x3",
    "42:nope=1", "42:drop", "notanint:drop=0.1", "", "42:kills=1.5",
    "42:delay=ax5",
]


def _parse(parse, arg):
    try:
        seed, spec = parse(arg)
        return ("ok", seed, dataclasses.asdict(spec))
    except ValueError as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("arg", CHAOS_SPECS)
def test_parse_fabric_chaos_equals_jax(arg):
    assert _parse(parse_fabric_chaos, arg) == \
        _parse(jparse_fabric_chaos, arg)


def test_fabric_config_validates_chaos_eagerly():
    fcfg = FabricConfig.parse("probe=100,chaos=42:drop=0.05+kills=3")
    assert fcfg.chaos == "42:drop=0.05+kills=3"
    for bad in ("chaos=42:bogus=1", "chaos=xx:drop=0.1"):
        with pytest.raises(ValueError):
            FabricConfig.parse(bad)


@pytest.mark.parametrize("seed", [0, 1, 42, 99, 12345, 2**63 + 7])
def test_chaos_rolls_equal_jax(seed):
    arg = f"{seed}:drop=0.2+delay=0.3x7+trunc=0.05+dup=0.1+slow=0.25+" \
          "accept=0.5+shm_crc=0.3+shm_trunc=0.02+shm_unlink=0.9"
    s, spec = parse_fabric_chaos(arg)
    js, jspec = jparse_fabric_chaos(arg)
    a, b = FabricChaos(s, spec), JFabricChaos(js, jspec)
    kinds = [k for k in _KINDS if k != "storm"]
    order = [kinds[(i * 7) % len(kinds)] for i in range(2000)]
    assert [a.roll(k) for k in order] == [b.roll(k) for k in order]
    assert a.injected == b.injected and sum(a.injected.values()) > 0
    assert a.describe() == b.describe()


@pytest.mark.parametrize("seed", [1, 7, 8, 1234, 99991])
@pytest.mark.parametrize("workers", [1, 3, 5])
def test_storm_schedule_equals_jax(seed, workers):
    for arg in ("kills=5+wedges=1+storm=500", "kills=3+wedges=3+storm=90",
                "wedges=2", ""):
        got = storm_schedule(seed, workers, FabricChaosSpec.parse(arg))
        assert got == jstorm_schedule(seed, workers,
                                      JFabricChaosSpec.parse(arg))
    sched = storm_schedule(seed, workers,
                           FabricChaosSpec.parse("kills=5+wedges=1"))
    assert [a for _, _, a in sched].count("wedge") == 1
    assert all(0 <= v < workers for _, v, _ in sched)


def test_retry_budget_sequence_equals_jax():
    ops = ["spend"] * 5 + ["note"] * 3 + ["spend"] * 3 + ["note"] * 40 + \
        ["spend"] * 7
    for cap, rate in ((4, 0.5), (0, 1.0), (32, 0.1)):
        trace = []
        for b in (RetryBudget(cap, rate), JRetryBudget(cap, rate)):
            seq = []
            for op in ops:
                out = b.try_spend() if op == "spend" else b.note_request()
                seq.append((out, b.tokens, b.spent, b.denied, b.exhausted))
            trace.append(seq)
        assert trace[0] == trace[1]


def _breaker_trace(cls, spec, steps):
    now = [0.0]
    br = cls(spec, clock=lambda: now[0])
    out = []
    for op, arg in steps:
        if op == "t":
            now[0] += arg
            continue
        r = getattr(br, op)()
        out.append((op, r, br.state, br.backoff_s, br.open_until,
                    br.opened, br.holddowns, br.delay_s()))
    return out


@pytest.mark.parametrize("spec", [
    "eject=100,eject_max=400",
    "eject=100,eject_max=400,flap_k=3,flap_window=60000,holddown=5000",
    "eject=10,eject_max=10000,flap_k=1,holddown=50",
])
def test_circuit_breaker_sequence_equals_jax(spec):
    steps = [("record_failure", None), ("allow_probe", None), ("t", 0.05),
             ("allow_probe", None), ("t", 0.2), ("allow_probe", None),
             ("allow_probe", None), ("record_success", None)]
    steps += [("record_failure", None), ("t", 0.01)] * 5
    steps += [("t", 20.0), ("allow_probe", None), ("record_failure", None),
              ("t", 0.3), ("allow_probe", None), ("record_success", None),
              ("record_failure", None), ("t", 6.0), ("allow_probe", None)]
    got = _breaker_trace(CircuitBreaker, FabricConfig.parse(spec), steps)
    want = _breaker_trace(JCircuitBreaker, JFabricConfig.parse(spec), steps)
    assert got == want


def test_circuit_breaker_lifecycle():
    now = [0.0]
    br = CircuitBreaker(FabricConfig.parse("eject=100,eject_max=400"),
                        clock=lambda: now[0])
    assert br.state == CLOSED and br.delay_s() == 0.0
    assert br.record_failure() == OPEN
    assert br.delay_s() == pytest.approx(0.1)
    assert not br.allow_probe()
    now[0] = 0.11
    assert br.allow_probe() and br.state == HALF_OPEN
    assert not br.allow_probe()            # one probe per open period
    assert br.record_success() == CLOSED


def test_brownout_level_equals_jax():
    for spec in ("", "brownout=1", "brownout=1,brownout_frac=0.9",
                 "brownout=1,brownout_frac=0.25", "brownout=1,"
                 "brownout_frac=1"):
        f, jf = FabricConfig.parse(spec), JFabricConfig.parse(spec)
        for total in range(0, 7):
            for healthy in range(0, total + 1):
                for ex in (False, True):
                    assert brownout_level(healthy, total, f, ex) == \
                        jbrownout_level(healthy, total, jf, ex)
    on = FabricConfig.parse("brownout=1,brownout_frac=0.5")
    assert [brownout_level(h, 4, on) for h in range(5)] == [0, 2, 1, 0, 0]


def test_unconfigured_router_has_no_chaos_machinery():
    router = Router(["tcp:127.0.0.1:1"], config=Config(fabric=QUIET_FABRIC))
    assert router.chaos is None
    assert type(router.links[0]) is WorkerLink
    assert "submit" not in vars(router)
    chaotic = Router(["tcp:127.0.0.1:1"], config=Config(
        fabric=QUIET_FABRIC + ",chaos=42:drop=0.1+accept=0.1"))
    assert type(chaotic.links[0]) is ChaosWorkerLink
    assert chaotic.chaos.seed == 42
    assert "submit" in vars(chaotic)            # accept chaos installed
    assert _service().shm_chaos is None
    svc = _service(fabric="chaos=3:drop=0.5")
    assert svc.shm_chaos is None                 # no shm_* rate set
    svc.close()
    svc = _service(fabric="chaos=3:shm_unlink=0.5")
    assert svc.shm_chaos.seed == 3
    svc.close()


# ------------------------------------------------------- injected faults
def test_chaos_reorder_dup_slow_absorbed_byte_exactly(small_path):
    spec = "delay=0.3x30+dup=0.3+slow=0.2x2"
    with _fabric(fabric_spec=QUIET_FABRIC + ",chaos=11:" + spec) as (
            raddr, router, _services, addrs):
        with ServeClient(addrs[0]) as c:
            expected = c.request("count", path=small_path)["count"]
        results, errors = [], []

        def load():
            try:
                with ServeClient(raddr) as c:
                    for _ in range(8):
                        results.append(
                            c.request("count", path=small_path)["count"])
            except Exception as exc:   # pragma: no cover - fail loudly
                errors.append(exc)

        threads = [threading.Thread(target=load) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors
        assert results == [expected] * 24          # none lost, none wrong
        inj = router.chaos.injected
        assert inj["delay"] > 0 and inj["dup"] > 0 and inj["slow"] > 0
        with ServeClient(raddr) as c:
            stats = c.request("stats")
        assert stats["chaos"]["seed"] == 11
        assert stats["chaos"]["injected"]["delay"] == inj["delay"]


def test_chaos_drop_fails_over_within_budget(small_path):
    seed = _find_seed("drop", 0.25, want_true_before=12,
                      want_false_at=(0, 1, 2))
    with _fabric(fabric_spec=f"probe=60,eject=30,eject_max=120,holddown=120,"
                             f"autoscale=60000,budget=64,budget_rate=1,"
                             f"chaos={seed}:drop=0.25") as (
            raddr, router, _services, addrs):
        with ServeClient(addrs[0]) as c:
            expected = c.request("count", path=small_path)["count"]
        with ServeClient(raddr) as c:
            for _ in range(20):
                for _attempt in range(40):
                    try:
                        assert c.request("count",
                                         path=small_path)["count"] == expected
                        break
                    except ServeClientError as exc:
                        assert exc.error == "WorkerLost"
                        time.sleep(0.15)
                else:
                    pytest.fail("the fleet never recovered from drops")
        assert router.chaos.injected["drop"] >= 1
        assert router.counters.get("failovers", 0) >= 1
        assert router.counters.get("budget_spent", 0) >= 1


# ----------------------------------------------------- streaming failover
@pytest.mark.parametrize("transport", ["socket", "auto"])
def test_stream_relay_is_byte_identical(bam_path, ref_frames, transport):
    obs.configure()
    try:
        with _fabric(fabric_spec=QUIET_FABRIC + ",stream=1") as (
                raddr, router, _s, _a):
            with ServeClient(raddr, transport=transport) as c:
                assert _batch(c, bam_path) == ref_frames
                want = "shm" if transport == "auto" else "socket"
                assert c.transport == want
        assert router.counters.get("streamed", 0) == 1
        assert router.counters.get("stream_frames", 0) == len(ref_frames)
        counters = {c["name"]: c["value"]
                    for c in obs.registry().snapshot()["counters"]}
        if transport == "auto":
            # Worker descriptors forwarded: no payload byte crossed the
            # router on this path.
            assert counters["transport.relay_descriptors"] >= \
                len(ref_frames)
            assert counters["transport.segment_announces"] >= 1
    finally:
        obs.shutdown()


@pytest.mark.parametrize("transport", ["socket", "auto"])
def test_stream_resumes_after_midstream_cut(bam_path, ref_frames,
                                            transport):
    seed = _find_seed("trunc", 0.25, want_true_before=len(ref_frames) - 1,
                      want_false_at=(0,))
    with _fabric(fabric_spec=QUIET_FABRIC + f",stream=1,budget=64,"
                 f"budget_rate=1,chaos={seed}:trunc=0.25") as (
            raddr, router, _s, _a):
        with ServeClient(raddr, transport=transport) as c:
            assert _batch(c, bam_path) == ref_frames
        assert router.counters.get("resumed", 0) >= 1
        assert router.chaos.injected["trunc"] >= 1


def test_relay_with_shmless_workers_and_shm_off(bam_path, ref_frames):
    with _fabric(fabric_spec=QUIET_FABRIC + ",stream=1,shm=1",
                 serve_spec=SERVE_SPEC + ",shm=0") as (raddr, _r, _s, _a):
        with ServeClient(raddr) as c:
            assert c.transport == "shm"   # repacked into the router's ring
            assert _batch(c, bam_path) == ref_frames
    with _fabric(fabric_spec=QUIET_FABRIC + ",stream=1,shm=0") as (
            raddr, _r, _s, _a):
        with ServeClient(raddr) as c:
            assert c.transport == "socket"
            assert _batch(c, bam_path) == ref_frames


class _CutOnceWorker:
    """Serves ``batch`` of three frames but cuts the first attempt after
    frame 0: the client must reconnect and ask with ``resume_from=1``."""

    FRAMES = [b"A" * 32, b"B" * 48, b"C" * 16]

    def __init__(self):
        self.port = None
        self.resume_tokens = []
        self._attempts = 0
        self._loop = None
        self._stop = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        assert self._started.wait(10)
        return self

    def stop(self):
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(timeout=10)

    def _run(self):
        asyncio.run(self._main())

    async def _main(self):
        server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        self.port = server.sockets[0].getsockname()[1]
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        self._started.set()
        async with server:
            await self._stop.wait()

    async def _handle(self, reader, writer):
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                req = json.loads(line)
                rid = req.get("id")
                if req.get("op") == "hello":
                    writer.write((json.dumps(
                        {"id": rid, "ok": True, "transport": "socket"}
                    ) + "\n").encode())
                    await writer.drain()
                    continue
                base = int(req.get("resume_from") or 0)
                self.resume_tokens.append(req.get("resume_from"))
                self._attempts += 1
                tail = self.FRAMES[base:]
                writer.write((json.dumps(
                    {"id": rid, "ok": True, "binary_frames": len(tail),
                     "total_frames": len(self.FRAMES), "resume_from": base}
                ) + "\n").encode())
                if self._attempts == 1:
                    writer.write(struct.pack("<Q", len(tail[0])) + tail[0])
                    await writer.drain()
                    return
                for fr in tail:
                    writer.write(struct.pack("<Q", len(fr)) + fr)
                await writer.drain()
        finally:
            with contextlib.suppress(Exception):
                writer.close()


def test_client_reconnects_and_resumes_midstream():
    w = _CutOnceWorker().start()
    try:
        with ServeClient(f"tcp:127.0.0.1:{w.port}",
                         policy=FaultPolicy(max_retries=3)) as c:
            resp = c.request("batch", path="/x.bam")
            assert resp["_binary"] == _CutOnceWorker.FRAMES
            assert resp["binary_frames"] == 3
            assert "resume_from" not in resp and "total_frames" not in resp
        assert w.resume_tokens == [None, 1]
    finally:
        w.stop()


# ---------------------------------------------------------- the shm seam
@pytest.mark.parametrize("kind,rate,requests", [
    ("shm_crc", 0.4, 4), ("shm_trunc", 0.3, 1), ("shm_unlink", 0.5, 3)])
def test_shm_chaos_leaves_frames_byte_identical(bam_path, ref_frames, kind,
                                                rate, requests):
    """A corrupt guard crc, a descriptor cut mid-record, a segment unlinked
    mid-stream: the client's frames equal an undisturbed read."""
    seed = _find_seed(kind, rate, want_true_before=len(ref_frames),
                      want_false_at=(0,) if kind == "shm_trunc" else ())
    svc = _service(fabric=QUIET_FABRIC + f",chaos={seed}:{kind}={rate}")
    try:
        assert svc.shm_chaos is not None
        with ServerThread(svc) as srv:
            with ServeClient(srv.address,
                             policy=FaultPolicy(max_retries=6)) as c:
                assert c.transport == "shm"
                for _ in range(requests):
                    assert _batch(c, bam_path) == ref_frames
        assert svc.shm_chaos.injected[kind] >= 1
    finally:
        svc.close()


# ----------------------------------------------------------- wedge, eject
class _SilentWorker:
    """Accepts connections and never answers: a SIGSTOPped worker as the
    router sees it."""

    def __init__(self):
        self.port = None
        self._loop = None
        self._stop = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        assert self._started.wait(10)
        return self

    def stop(self):
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(timeout=10)

    def _run(self):
        asyncio.run(self._main())

    async def _main(self):
        server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        self.port = server.sockets[0].getsockname()[1]
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        self._started.set()
        async with server:
            await self._stop.wait()

    async def _handle(self, reader, writer):
        with contextlib.suppress(Exception):
            while await reader.readline():
                pass                          # swallow, never reply


def test_wedged_worker_is_ejected_and_pending_fails_over(bam_path):
    wedged = _SilentWorker().start()
    service = _service()
    try:
        with ServerThread(service) as srv:
            h, p = srv.address
            real, dead = f"tcp:{h}:{p}", f"tcp:127.0.0.1:{wedged.port}"
            with ServeClient(real) as c:
                expected = c.request("count", path=bam_path)["count"]
            wedged_first = rendezvous_weight("w0", bam_path) > \
                rendezvous_weight("w1", bam_path)
            addrs = [dead, real] if wedged_first else [real, dead]
            router = Router(addrs, config=Config(
                fabric="probe=100,probe_timeout=300,eject=50,"
                       "autoscale=60000"))
            with ServerThread(router) as rsrv:
                t0 = time.monotonic()
                with ServeClient(rsrv.address) as c:
                    assert c.request("count",
                                     path=bam_path)["count"] == expected
                waited = time.monotonic() - t0
            assert router.counters.get("failovers", 0) >= 1
            link = router.links[0 if wedged_first else 1]
            assert link.healthy is False
            assert link.breaker is not None and link.breaker.state != CLOSED
            assert waited < 10.0           # bounded by the probe cycle
    finally:
        service.close()
        wedged.stop()


# ---------------------------------------------------------------- brownout
def test_brownout_sheds_scan_class_with_pacing_hint(bam_path):
    services = [_service() for _ in range(2)]
    srvs = [ServerThread(s).start() for s in services]
    addrs = [f"tcp:{h}:{p}" for h, p in (s.address for s in srvs)]
    router = Router(addrs, config=Config(
        fabric="probe=50,eject=30,autoscale=60000,brownout=1,"
               "brownout_frac=0.9"))
    rsrv = ServerThread(router).start()
    try:
        with ServeClient(rsrv.address, policy=None) as c:
            c.request("count", path=bam_path)
            srvs[0].stop()                     # worker 0 vanishes
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and router.links[0].healthy:
                time.sleep(0.05)
            assert router.links[0].healthy is False
            with pytest.raises(ServeClientError) as exc:
                c.request("count", path=bam_path)     # scan class: shed
            assert exc.value.error == "Overloaded"
            assert "retry_after_ms" in exc.value.resp
            assert "brownout (level 1)" in exc.value.resp["message"]
            assert c.request("plan", path=bam_path,
                             split_size=256 << 10)["ok"]  # plan class
            assert c.request("stats")["brownout"] == 1
        assert router.counters.get("brownout_shed", 0) >= 1
        assert router._autoscale_hold() is True
    finally:
        rsrv.stop()
        srvs[1].stop()
        for s in services:
            s.close()


def test_shed_hint_derives_from_latency_median_jittered():
    router = Router([], config=Config(fabric=QUIET_FABRIC))
    assert router._shed_hint_ms(25.0) == 25.0     # the upstream hint wins
    assert router._shed_hint_ms() == 0.0          # no samples yet
    for ms in (10.0, 12.0, 14.0):
        router._latency.record(ms)
    j = router.policy.jitter
    for _ in range(20):
        hint = router._shed_hint_ms()
        assert 12.0 * (1 - j) <= hint <= 12.0 * (1 + j)


def test_autoscaler_holds_while_brownout_active():
    class _Link:
        wid = "w0"
        healthy = True
        draining = False

        def __init__(self):
            self.ops = []

        async def request(self, req):
            self.ops.append(req["op"])
            if req["op"] == "stats":
                return {"ok": True, "served": len(self.ops),
                        "latency_p99_ms": 500.0, "batch_rows": 16,
                        "tick_ms": 8.0, "limits": {"scan": 64, "plan": 64}}
            return {"ok": True, "applied": {}}

    async def run(hold_value):
        link = _Link()
        fcfg = FabricConfig.parse("autoscale=5,slo=200")
        counts, moves = [], []
        task = asyncio.ensure_future(autoscale_worker(
            link, fcfg, lambda *a: counts.append(a),
            note_move=moves.append, hold=lambda: hold_value))
        await asyncio.sleep(0.1)
        task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await task
        return link.ops, counts, moves

    ops, counts, moves = asyncio.run(run(True))
    assert "tune" not in ops and not counts and not moves
    ops, counts, moves = asyncio.run(run(False))
    assert "tune" in ops and counts
    assert moves[0]["move"] == {"batch_rows": 8, "tick_ms": 4.0,
                                "scan_queue": 32, "plan_queue": 32}
    assert moves[0]["reason"] == "p99=500.0ms>slo=200.0ms"


# -------------------------------------------------------- artifact context
def test_chaos_seed_lands_in_flight_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_DIR_ENV, str(tmp_path))
    router = Router([], config=Config(
        fabric=QUIET_FABRIC + ",chaos=77:drop=0.5"))
    assert router.chaos is not None
    try:
        assert flight.context()["chaos_seed"] == 77
        meta = flight.read_dump(flight.dump_auto("chaos_test",
                                                 who="router"))[0]
        assert meta["chaos_seed"] == 77
        assert meta["chaos_spec"].startswith("77:drop=0.5")
    finally:
        flight.clear_context("chaos_seed", "chaos_spec")
    meta = flight.read_dump(flight.dump_auto("after", who="router"))[0]
    assert "chaos_seed" not in meta


class _FakePool:
    """Records the verbs a storm sends to a pool."""

    def __init__(self, n):
        self.procs = [None] * n
        self.calls = []

    def kill(self, i, hard=False):
        self.calls.append(("kill", i, hard))

    def respawn(self, i):
        self.calls.append(("respawn", i))

    def wedge(self, i):
        self.calls.append(("wedge", i))

    def unwedge(self, i):
        self.calls.append(("unwedge", i))


def test_chaos_storm_drives_the_pool_on_schedule():
    spec = FabricChaosSpec.parse("kills=2+wedges=1+storm=20+revive=5")
    pool = _FakePool(3)
    storm = ChaosStorm(pool, 1234, spec).start()
    storm.join(timeout_s=30)
    want = []
    for _t, victim, action in storm_schedule(1234, 3, spec):
        want += ([("kill", victim, True), ("respawn", victim)]
                 if action == "kill" else
                 [("wedge", victim), ("unwedge", victim)])
    assert pool.calls == want
    assert [e["action"] for e in storm.events] == \
        [a for _, _, a in storm.schedule]
    kinds = [e["e"] for e in flight.recorder().events()]
    assert kinds.count("chaos_storm") >= 3
