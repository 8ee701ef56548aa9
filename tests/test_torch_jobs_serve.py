"""The port's job-plane ops behind its serve daemon and its fabric router,
against the JAX package's, exactly.

The port's ``SplitService`` (on ``local_mesh(["cpu"])``) and the JAX one
(on the conftest's virtual CPU mesh), each behind its package's
``ServerThread``, answer one request sequence: ``submit`` polled by
``job_status`` until done, the idempotent resubmit, ``stats["jobs"]``,
``job_cancel`` of a finished job, ``NotFound`` and ``ProtocolError``,
a typed deferral, an export job and the one-shot ``rewrite``; the answers
are compared without their timing fields (``submitted``, ``finished``,
``latency_*``) and ``devices``. The same sequence then runs through the
port's router over two port workers, the JAX router over two JAX workers,
and both cross pairings. Then the rescues: in process, two workers share
one jobs dir and the owner's server is closed mid-job; across processes, a
``WorkerPool`` worker is stopped and SIGKILLed mid-job. Both times the
router's watchdog re-homes the job and the artifact equals the clean
run's byte for byte.
"""

import contextlib
import os
import shutil
import signal
import subprocess
import time
from pathlib import Path

import pytest

from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu.fabric import Router as JRouter
from spark_bam_tpu.jobs import runner as jrunner
from spark_bam_tpu.serve import ServeClient as JServeClient
from spark_bam_tpu.serve import ServerThread as JServerThread
from spark_bam_tpu.serve import SplitService as JSplitService
from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.core import faults
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.fabric import Router, WorkerPool, rendezvous_weight
from spark_bam_tpu_torch.jobs.journal import read_journal
from spark_bam_tpu_torch.jobs.manager import job_id_of
from spark_bam_tpu_torch.jobs.scrub import scrub_paths
from spark_bam_tpu_torch.obs import flight
from spark_bam_tpu_torch.parallel.mesh import local_mesh
from spark_bam_tpu_torch.rewrite import rewrite_bam
from spark_bam_tpu_torch.serve import (
    ServeClient,
    ServeClientError,
    ServerThread,
    SplitService,
)
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = [pytest.mark.jobs, pytest.mark.fabric]

SERVE_SPEC = "window=64KB,halo=8KB,batch=8,tick=5,workers=4"
#: Long probe and autoscale periods: only the watchdog tests want probes.
QUIET_FABRIC = "probe=60000,autoscale=60000"
BLOCK = 4096
#: Fields that time or count the server, left out of every comparison.
TIMING = ("submitted", "finished", "latency_p50_ms", "latency_p99_ms",
          "devices")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ("SPARK_BAM_DEFLATE", "SPARK_BAM_CACHE", "SPARK_BAM_CACHE_DIR",
                "SPARK_BAM_JOBS", "SPARK_BAM_DISK_CHAOS", "SPARK_BAM_METRICS_OUT",
                "SPARK_BAM_COLUMNAR"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_jobs_serve")
    small, big = d / "in.bam", d / "big.bam"
    random_bam(small, seed=29, n_records=(380, 420), read_len=(20, 600))
    # A job on this one under mode=fixed's plain lanes runs for seconds on
    # the CPU: long enough to kill its owner mid-run.
    random_bam(big, seed=31, n_records=(2400, 2401), read_len=(50, 500))
    return {"small": str(small), "big": str(big)}


def _norm(resp: dict) -> dict:
    out = {k: v for k, v in resp.items()
           if k not in ("id", "_transport", "_binary", *TIMING)}
    if isinstance(out.get("result"), dict):
        out["result"] = {k: v for k, v in out["result"].items()
                         if k not in TIMING}
    return out


def _ask(client, op, **fields) -> dict:
    try:
        return client.request(op, **fields)
    except Exception as exc:          # either package's ServeClientError
        if not hasattr(exc, "resp"):
            raise
        return exc.resp


def _until_done(client, jid, timeout=60.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = _ask(client, "job_status", job_id=jid)
        if st.get("state") not in ("running", None):
            return st
        time.sleep(0.02)
    pytest.fail(f"job {jid} still running")


def _sequence(client, bams, work: Path) -> list:
    """The job-plane request sequence; the normalized answers in order.
    The submit's own answer may already say done, so its state is kept
    only as running-or-done."""
    out = []
    small = bams["small"]
    res = str(work / "out.bam")
    first = _ask(client, "submit", job="rewrite", path=small, out=res,
                 block_payload=BLOCK)
    assert first["state"] in ("running", "done"), first
    jid = first["job_id"]
    out.append(_norm(dict(first, state="running-or-done", result=None)))
    out.append(_norm(_until_done(client, jid)))
    out.append(_norm(_ask(client, "submit", job="rewrite", path=small,
                          out=res, block_payload=BLOCK)))
    out.append(_norm(_ask(client, "job_cancel", job_id=jid)))
    out.append(_norm(_ask(client, "job_status", job_id="beefbeefbeefbeef")))
    out.append(_norm(_ask(client, "job_cancel", job_id="beefbeefbeefbeef")))
    out.append(_norm(_ask(client, "job_status")))
    out.append(_norm(_ask(client, "submit", job="mine_bitcoin", path=small,
                          out=res)))
    out.append(_norm(_ask(client, "submit", job="export", path=small)))
    ex = _ask(client, "submit", job="export", path=small,
              out=str(work / "out.sbcr"), columns=["flag", "pos", "name"],
              batch_rows=50)
    out.append(_norm(_until_done(client, ex["job_id"])))
    tr = _ask(client, "submit", job="transcode", path=small,
              out=str(work / "tr.bam"), block_payload=BLOCK,
              deflate="mode=fixed")
    out.append(_norm(_until_done(client, tr["job_id"])))
    out.append(_norm(_ask(client, "rewrite", path=small,
                          out=str(work / "rw.bam"), block_payload=8192,
                          index=True)))
    out.append(_norm(_ask(client, "rewrite", path=small)))
    out.append(_norm(_ask(client, "rewrite", path=small,
                          out=str(work / "x.bam"), deflate="mode=bogus")))
    out.append(_norm(_ask(client, "rewrite", path=str(work / "none.bam"),
                          out=str(work / "x.bam"))))
    return out


def _service(pkg, jobs_dir, **kw):
    jobs = f"dir={jobs_dir},checkpoint=60,mem=1.0"
    if pkg == "jax":
        return JSplitService(JConfig(serve=SERVE_SPEC, jobs=jobs, **kw))
    return SplitService(Config(serve=SERVE_SPEC, jobs=jobs, **kw),
                        mesh=local_mesh(["cpu"]))


def _client(pkg, address):
    return (JServeClient if pkg == "jax" else ServeClient)(address,
                                                           policy=None)


def _fresh(work: Path) -> Path:
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    return work


def _artifacts(work: Path) -> dict:
    return {name: (work / name).read_bytes()
            for name in ("out.bam", "out.sbcr", "tr.bam", "tr.bam.blocks",
                         "tr.bam.records", "rw.bam", "rw.bam.blocks")}


@pytest.fixture(scope="module")
def jax_service_answers(bams, tmp_path_factory):
    """The JAX service's answers and artifacts; its work dir is left empty
    for the port to run with the same paths (so the job ids and the
    answers' paths agree)."""
    base = tmp_path_factory.mktemp("jobs_serve_jax")
    work = _fresh(base / "work")
    svc = _service("jax", base / "jobs")
    try:
        with JServerThread(svc) as srv, _client("jax", srv.address) as c:
            answers = _sequence(c, bams, work)
            stats = c.request("stats")["jobs"]
            # Deferral: typed and retryable.
            svc.jobs.mem_fn = lambda: 1.0
            deferred = _ask(c, "submit", job="rewrite", path=bams["small"],
                            out=str(work / "late.bam"))
    finally:
        svc.close()
    files = _artifacts(work)
    shutil.rmtree(work)
    return answers, stats, deferred, files, work


def test_serve_job_ops_equal_jax(bams, jax_service_answers, tmp_path):
    want, want_jobs, want_deferred, want_files, work = jax_service_answers
    _fresh(work)
    svc = _service("port", tmp_path / "jobs")
    try:
        with ServerThread(svc) as srv, _client("port", srv.address) as c:
            got = _sequence(c, bams, work)
            stats = c.request("stats")
            svc.jobs.mem_fn = lambda: 1.0
            deferred = _ask(c, "submit", job="rewrite", path=bams["small"],
                            out=str(work / "late.bam"))
        files = _artifacts(work)
    finally:
        svc.close()
        shutil.rmtree(work, ignore_errors=True)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    assert stats["jobs"] == want_jobs and len(want_jobs) == 3
    assert files == want_files
    assert _norm(deferred) == _norm(want_deferred)
    assert deferred["error"] == "ResourceExhausted"
    assert deferred["retry_after_ms"] == 1000.0


def test_paused_job_alert_lands_in_the_flight_record(bams, tmp_path):
    flight.recorder().clear()
    svc = _service("port", tmp_path / "jobs")
    out = tmp_path / "out.bam"
    try:
        with ServerThread(svc) as srv, _client("port", srv.address) as c:
            with faults.disk_chaos("3:enospc=1.0"):
                jid = c.request("submit", job="rewrite", path=bams["small"],
                                out=str(out))["job_id"]
                st = _until_done(c, jid)
            assert st["state"] == "paused" and "ENOSPC" in st["error"]
            alerts = [e for e in flight.recorder().events()
                      if e["e"] == "slo_alert"]
            assert len(alerts) == 1
            assert {k: alerts[0][k] for k in ("objective", "state", "job_id",
                                              "op", "error")} == {
                "objective": "jobs.paused", "state": "firing",
                "job_id": jid, "op": "rewrite", "error": st["error"]}
            # The resubmit (no chaos) completes.
            again = c.request("submit", job="rewrite", path=bams["small"],
                              out=str(out))
            assert again["job_id"] == jid
            assert _until_done(c, jid)["state"] == "done"
            assert c.request("stats")["jobs"] == {jid: "done"}
    finally:
        svc.close()
    plain = tmp_path / "plain.bam"
    rewrite_bam(bams["small"], plain, device="cpu")
    assert out.read_bytes() == plain.read_bytes()


# ------------------------------------------------------------------ router
def _router(pkg, addrs, spec=QUIET_FABRIC):
    if pkg == "jax":
        return JRouter(addrs, config=JConfig(fabric=spec))
    return Router(addrs, config=Config(fabric=spec))


@contextlib.contextmanager
def _fabric(router_pkg, worker_pkg, jobs_dir, fabric=QUIET_FABRIC, n=2,
            **kw):
    services = [_service(worker_pkg, jobs_dir, **kw) for _ in range(n)]
    thread = JServerThread if worker_pkg == "jax" else ServerThread
    srvs = [thread(s).start() for s in services]
    addrs = [f"tcp:{h}:{p}" for h, p in (s.address for s in srvs)]
    router = _router(router_pkg, addrs, fabric)
    rsrv = (JServerThread if router_pkg == "jax" else ServerThread)(
        router).start()
    try:
        yield rsrv.address, router, services, srvs
    finally:
        rsrv.stop()
        for s in srvs:
            # A rescue test stops its owner's server itself.
            with contextlib.suppress(RuntimeError):
                s.stop()
        for s in services:
            s.close()


def _router_sequence(router_pkg, worker_pkg, bams, work: Path,
                     jobs_dir: Path):
    """The sequence through a router over two workers, in ``work`` (left
    empty after): the answers, the artifacts, the routed count."""
    _fresh(work)
    try:
        with _fabric(router_pkg, worker_pkg, jobs_dir) as (raddr, router,
                                                           _s, _w):
            with _client(router_pkg, raddr) as c:
                answers = _sequence(c, bams, work)
            routed = dict(router.counters).get("routed")
        return answers, _artifacts(work), routed
    finally:
        shutil.rmtree(work, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_router_answers(bams, tmp_path_factory):
    base = tmp_path_factory.mktemp("jobs_router")
    return base / "work", _router_sequence("jax", "jax", bams, base / "work",
                                           base / "jobs_jax")


@pytest.mark.parametrize("router_pkg,worker_pkg",
                         [("port", "port"), ("port", "jax"),
                          ("jax", "port")])
def test_router_job_plane_equals_jax(bams, jax_router_answers, tmp_path,
                                     router_pkg, worker_pkg):
    work, (want, want_files, want_routed) = jax_router_answers
    got, files, routed = _router_sequence(router_pkg, worker_pkg, bams, work,
                                          tmp_path / "jobs")
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    assert files == want_files
    # Every request was routed (the polls too, so the count is timing's).
    assert routed >= len(got) and want_routed >= len(want)


def test_router_answers_a_job_op_as_its_worker(bams, tmp_path):
    """Through the hop: ``job_status`` reaches the owner, which is the
    path's rendezvous winner."""
    with _fabric("port", "port", tmp_path / "jobs") as (raddr, router,
                                                       services, _):
        with ServeClient(raddr) as c:
            st = c.request("submit", job="rewrite", path=bams["small"],
                           out=str(tmp_path / "o.bam"))
            done = _until_done(c, st["job_id"])
        owner = max(range(2), key=lambda i: rendezvous_weight(
            f"w{i}", bams["small"]))
        assert services[owner].jobs.status(st["job_id"])["state"] == "done"
        assert services[1 - owner].jobs.status(st["job_id"]) is None
        entry = router._job_owners[st["job_id"]]
        assert (entry["wid"], entry["state"]) == (f"w{owner}", "done")
        assert done["result"]["count"] > 0


def _wait_ckpt(journal_path, deadline) -> None:
    while time.monotonic() < deadline:
        try:
            tags = [r["t"] for r in read_journal(journal_path)]
        except OSError:
            tags = []
        assert "done" not in tags, "the job finished before the kill"
        if "ckpt" in tags:
            return
        time.sleep(0.005)
    pytest.fail("no checkpoint in time")


@pytest.fixture(scope="module")
def big_clean(bams, tmp_path_factory):
    """The clean transcode of the big BAM under mode=fixed: bytes of the
    BAM and its .blocks and .records."""
    d = tmp_path_factory.mktemp("jobs_big_clean")
    out = d / "clean.bam"
    jrunner.run_transcode_job(
        {"op": "transcode", "path": bams["big"], "out": str(out),
         "block_payload": BLOCK, "deflate": "mode=fixed"},
        str(d / "job"), checkpoint=150)
    return {ext: Path(str(out) + ext).read_bytes()
            for ext in ("", ".blocks", ".records")}


def _rescue_spec(bams, out):
    return {"job": "transcode", "path": bams["big"], "out": str(out),
            "block_payload": BLOCK, "deflate": "mode=fixed"}


def test_in_process_rescue(bams, big_clean, tmp_path):
    """Two workers share one jobs dir; the owner's server is closed
    mid-job (its job cancelled first); the watchdog re-homes the job on
    the survivor, which resumes it: ``job_rescues`` 1, the clean bytes."""
    jobs = tmp_path / "jobs"
    out = tmp_path / "out.bam"
    reg = obs.configure()
    try:
        with _fabric("port", "port", jobs,
                     fabric="probe=100,autoscale=60000") as (
                raddr, router, services, srvs):
            spec = _rescue_spec(bams, out)
            with ServeClient(raddr) as c:
                jid = c.request("submit", **spec)["job_id"]
                owner = max(range(2), key=lambda i: rendezvous_weight(
                    f"w{i}", bams["big"]))
                _wait_ckpt(jobs / jid / "journal.sbj",
                           time.monotonic() + 60)
                services[owner].jobs.close(timeout=30)
                assert services[owner].jobs.status(jid)["state"] in (
                    "cancelled",)
                srvs[owner].stop()
                st = _until_done(c, jid, timeout=90)
            assert st["state"] == "done", st
            assert router.counters.get("job_rescues") == 1
            assert reg.counter("fabric.job_rescues").value == 1
            assert services[1 - owner].jobs.status(jid)["state"] == "done"
    finally:
        obs.shutdown()
    assert st["result"]["resumed"] is True
    seg = [r["seg_bytes"] for r in read_journal(jobs / jid / "journal.sbj")
           if r["t"] == "ckpt"]
    assert st["result"]["redone_bytes"] <= 2 * max(seg)
    for ext, blob in big_clean.items():
        assert Path(str(out) + ext).read_bytes() == blob, ext
    report = scrub_paths([str(out)], source=bams["big"])
    assert report.clean, report.summary()


def test_worker_pool_sigkill_mid_job_rescued(bams, big_clean, tmp_path):
    """The reference's storm test on a small BAM: two ``fabric.worker``
    processes on the CPU share a jobs dir; the owner is stopped as soon as
    its journal holds a checkpoint, then SIGKILLed; the router's watchdog
    re-sends the submit to the survivor, which finishes the job
    byte-identically, with a clean scrub."""
    jobs = tmp_path / "jobs"
    out = tmp_path / "out.bam"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               SPARK_BAM_JOBS=f"dir={jobs},checkpoint=150,mem=1.0")
    env.pop("PYTHONPATH", None)
    pool = WorkerPool(workers=2, device="cpu", serve=SERVE_SPEC, env=env,
                      stderr=subprocess.DEVNULL)
    pool.start(timeout_s=120)
    try:
        router = Router(pool.addresses,
                        config=Config(fabric="probe=100,autoscale=60000"))
        with ServerThread(router) as rsrv, ServeClient(rsrv.address) as c:
            spec = _rescue_spec(bams, out)
            jid = c.request("submit", **spec)["job_id"]
            assert jid == job_id_of({"op": "transcode", **{
                k: v for k, v in spec.items() if k != "job"}})
            owner = max(range(2), key=lambda i: rendezvous_weight(
                f"w{i}", bams["big"]))
            _wait_ckpt(jobs / jid / "journal.sbj", time.monotonic() + 60)
            pool.wedge(owner)
            pool.kill(owner, hard=True)
            deadline = time.monotonic() + 90
            st = None
            while time.monotonic() < deadline:
                try:
                    st = c.request("job_status", job_id=jid)
                except (ServeClientError, ConnectionError, OSError):
                    time.sleep(0.1)        # the owner is gone; rescue due
                    continue
                if st["state"] == "done":
                    break
                time.sleep(0.1)
            assert st is not None and st["state"] == "done", st
            assert router.counters.get("job_rescues") == 1
    finally:
        pool.terminate(timeout_s=30)
    assert pool.procs[owner].returncode == -signal.SIGKILL
    seg = [r["seg_bytes"] for r in read_journal(jobs / jid / "journal.sbj")
           if r["t"] == "ckpt"]
    assert st["result"]["resumed"] is True
    assert st["result"]["redone_bytes"] <= 2 * max(seg)
    for ext, blob in big_clean.items():
        assert Path(str(out) + ext).read_bytes() == blob, ext
    report = scrub_paths([str(out)], source=bams["big"])
    assert report.clean, report.summary()
