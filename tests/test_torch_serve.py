"""The port's split service against the JAX package's, exactly.

The same requests go to the JAX ``SplitService`` on the conftest's
8-device virtual CPU mesh and to the port's ``SplitService`` on a CPU mesh
of 1 and of 4 entries; the responses are compared with their latency
fields and ``devices`` left out, their binary frames byte for byte. Then
the reference's serve tests in the port's form (batched = sequential
counts, admission, deadlines, the warm plan, freshness, the transports,
``stats`` / ``tune`` / ``drain``, client retries), the two packages'
clients and servers against each other, the config, address and protocol
parsing against the JAX functions, the ``serve`` command, concurrent ops,
and device failures that must answer with an error, never a host answer.
"""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_bam_tpu import obs as jobs_obs
from spark_bam_tpu.agg import host as jhost
from spark_bam_tpu.agg import plan as jplan
from spark_bam_tpu.benchmarks.synth import synthetic_fixture
from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu.serve import ServeAddress as JServeAddress
from spark_bam_tpu.serve import ServeClient as JServeClient
from spark_bam_tpu.serve import ServeConfig as JServeConfig
from spark_bam_tpu.serve import ServerThread as JServerThread
from spark_bam_tpu.serve import SplitService as JSplitService
from spark_bam_tpu.serve import decode_request as jdecode
from spark_bam_tpu.sbi.store import reset_shared_store
from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.agg.plan import AggConfig, encode_result
from spark_bam_tpu_torch.benchmarks import agg_cases
from spark_bam_tpu_torch.benchmarks.load_cases import encode_record
from spark_bam_tpu_torch.benchmarks.synth import encode_header
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.faults import FaultPolicy
from spark_bam_tpu_torch.parallel.mesh import local_mesh
from spark_bam_tpu_torch.serve import (
    Overloaded,
    ProtocolError,
    ServeAddress,
    ServeClient,
    ServeClientError,
    ServeConfig,
    ServerThread,
    SplitService,
    decode_request,
    encode,
    error_response,
    ok_response,
)
from spark_bam_tpu_torch.tpu import kernels as K
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.serve

ROOT = Path(__file__).resolve().parent.parent
#: The JAX serve tests' spec: small windows, so the 2,500-read fixture
#: spans many rows per request.
SERVE_SPEC = "window=64KB,halo=8KB,batch=8,tick=5,workers=4"
#: Response fields that time or count the server itself.
TIMING = ("latency_p50_ms", "latency_p99_ms", "devices")


# ---------------------------------------------------------------- inputs
@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    out = {
        "main": str(synthetic_fixture(d / "a")),
        "second": str(synthetic_fixture(d / "b", reads=700)),
        "tagged": str(d / "tagged.bam"),
        "faults": str(d / "faults.bam"),
        "many_contigs": str(d / "many.bam"),
    }
    agg_cases.write_tagged_bam(out["tagged"])
    # The two inputs where the JAX device reduction leaves the wire
    # contract (``agg_cases.REFERENCE_FAULTS``) as records of one BAM: a
    # tlen of -2^31, and a read whose pos + span passes 2^31.
    rng = np.random.default_rng(4)
    recs = [encode_record(pos=0, tlen=t, name=b"t%d" % i, cigar=((50, 0),),
                          rng=rng)
            for i, t in enumerate([0, 5, -5, 2000, 2001, -3000, -(1 << 31),
                                   17])]
    recs += [encode_record(pos=(1 << 31) - 10, name=b"far",
                           cigar=((100, 0),), rng=rng, bin_=0),
             encode_record(pos=500, name=b"near", cigar=((100, 0),),
                           rng=rng)]
    agg_cases._write(out["faults"], encode_header((("big", (1 << 31) - 1),)),
                     recs)
    contigs = tuple((f"c{i}", 1000) for i in range(1025))
    agg_cases._write(out["many_contigs"], encode_header(contigs),
                     [encode_record(pos=5, name=b"m%d" % i, rng=rng)
                      for i in range(30)])
    return out


@pytest.fixture(scope="module")
def jsvc():
    svc = JSplitService(JConfig(serve=SERVE_SPEC))
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def psvcs():
    made = {}

    def get(k):
        if k not in made:
            made[k] = SplitService(Config(serve=SERVE_SPEC),
                                   mesh=local_mesh(["cpu"] * k))
        return made[k]
    yield get
    for svc in made.values():
        svc.close()


@pytest.fixture()
def service():
    svc = SplitService(Config(serve=SERVE_SPEC), mesh=local_mesh(["cpu"]))
    yield svc
    svc.close()


def _split(resp: dict):
    """``(encoded response without timing fields, frames as bytes)``."""
    resp = dict(resp)
    frames = [bytes(f) for f in resp.pop("_binary", None) or ()]
    resp.pop("_transport", None)
    for k in TIMING:
        resp.pop(k, None)
    return encode(resp), frames


def _ask(svc, req: dict, timeout: float = 300):
    return svc.submit(dict(req)).result(timeout=timeout)


# --------------------------------------------------------- the differential
REQUESTS = {
    "count": lambda b: {"op": "count", "path": b["main"]},
    "count_range": lambda b: {"op": "count", "path": b["main"],
                              "start": 20_000, "end": 90_000},
    "count_from": lambda b: {"op": "count", "path": b["main"],
                             "start": 40_000},
    "count_to": lambda b: {"op": "count", "path": b["main"], "end": 50_000},
    "count_empty_range": lambda b: {"op": "count", "path": b["main"],
                                    "start": 90_000, "end": 90_000},
    "count_tagged": lambda b: {"op": "count", "path": b["tagged"]},
    "fleet": lambda b: {"op": "fleet", "paths": [b["main"], b["second"],
                                                 b["tagged"]]},
    "plan": lambda b: {"op": "plan", "path": b["main"],
                       "split_size": 64 << 10},
    "plan_default_size": lambda b: {"op": "plan", "path": b["second"]},
    "record_starts": lambda b: {"op": "record_starts", "path": b["main"],
                                "limit": 7},
    "record_starts_nolimit": lambda b: {"op": "record_starts",
                                        "path": b["tagged"]},
    "batch": lambda b: {"op": "batch", "path": b["main"],
                        "columns": ["pos", "mapq", "name"]},
    "batch_all_columns": lambda b: {"op": "batch", "path": b["main"],
                                    "batch_rows": 1000},
    "batch_filtered": lambda b: {"op": "batch", "path": b["main"],
                                 "intervals": "chr1:1k-100k,chr2",
                                 "flags_forbidden": 16, "batch_rows": 300},
    "batch_flags_required": lambda b: {"op": "batch", "path": b["tagged"],
                                       "flags_required": 16},
    "batch_tags": lambda b: {"op": "batch", "path": b["tagged"],
                             "tags_required": "NM,RG",
                             "columns": ["flag", "tags"]},
    "batch_resume": lambda b: {"op": "batch", "path": b["main"],
                               "batch_rows": 500, "resume_from": 2},
    "batch_arrow": lambda b: {"op": "batch", "path": b["main"],
                              "wire": "arrow", "batch_rows": 700,
                              "columns": ["pos", "cigar", "seq"]},
    "batch_arrow_resume": lambda b: {"op": "batch", "path": b["tagged"],
                                     "wire": "arrow", "batch_rows": 50,
                                     "resume_from": 3},
    "aggregate": lambda b: {"op": "aggregate", "path": b["main"]},
    "aggregate_filtered": lambda b: {
        "op": "aggregate", "path": b["main"], "intervals": "chr2",
        "agg": "coverage:bin=1000,bins=64;tlen:max=500;count"},
    "aggregate_tags": lambda b: {"op": "aggregate", "path": b["tagged"],
                                 "tags_required": ["NM"], "agg": "mapq;count",
                                 "chunk": 37},
    "aggregate_flags": lambda b: {"op": "aggregate", "path": b["tagged"],
                                  "flags_forbidden": 4, "agg": "flagstat"},
    "error_not_found": lambda b: {"op": "count", "path": b["main"] + ".x"},
    "error_not_found_batch": lambda b: {"op": "batch",
                                        "path": b["main"] + ".x"},
    "error_fleet_paths": lambda b: {"op": "fleet", "paths": []},
    "error_columns": lambda b: {"op": "batch", "path": b["main"],
                                "columns": ["bogus"]},
    "error_wire": lambda b: {"op": "batch", "path": b["main"],
                             "wire": "parquet"},
    "error_resume_range": lambda b: {"op": "batch", "path": b["main"],
                                     "resume_from": 999},
    "error_agg_spec": lambda b: {"op": "aggregate", "path": b["main"],
                                 "agg": "bogus"},
    "error_agg_chunk": lambda b: {"op": "aggregate", "path": b["main"],
                                  "chunk": 0},
    "error_tag_name": lambda b: {"op": "batch", "path": b["main"],
                                 "tags_required": "ABC"},
    "error_many_contigs": lambda b: {"op": "count",
                                     "path": b["many_contigs"]},
    "alerts": lambda b: {"op": "alerts"},
    "ping": lambda b: {"op": "ping"},
}


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", list(REQUESTS))
def test_responses_equal_jax(bams, jsvc, psvcs, name, k):
    req = dict(REQUESTS[name](bams), id=name)
    want = _split(_ask(jsvc, req))
    got = _split(_ask(psvcs(k), req))
    assert got[0] == want[0]
    assert got[1] == want[1]
    if name.startswith("error_"):
        assert b'"ok":false' in got[0]


def test_aggregate_follows_the_oracle_where_jax_device_diverges(bams, jsvc):
    """On records with a tlen of -2^31 and a read past 2^31 the port's
    response carries the int64 oracle's vectors; the JAX service's
    device reduction does not."""
    path = bams["faults"]
    spec = "tlen;coverage"
    req = {"op": "aggregate", "path": path, "agg": spec, "id": 1}
    got = _ask(SplitService(Config(serve=SERVE_SPEC),
                            mesh=local_mesh(["cpu"] * 2)), req)
    want_j = _ask(jsvc, req)
    assert got["ok"] and got["rows"] == want_j["rows"] == 10
    # The oracle over the same parsed planes, encoded as the wire does.
    from spark_bam_tpu.load.tpu_load import record_starts as jstarts
    from spark_bam_tpu.tpu.parser import parse_flat_records as jparse

    res = jstarts(path)
    cols = jparse(res.view.data, np.asarray(res.starts, np.int64)).columns
    oracle = jhost.host_aggregate(cols, jplan.AggConfig.parse(spec), 1)
    meta, payload = encode_result(AggConfig.parse(spec), 1,
                                  [("big", (1 << 31) - 1)], oracle)
    assert got["result"] == meta
    assert bytes(got["_binary"][0]) == payload
    assert bytes(want_j["_binary"][0]) != payload
    # Every row lands in the oracle's tlen histogram, the -2^31 one too.
    assert int(oracle["tlen"].sum()) == 10


def test_unserved_ops_name_their_roadmap_item(service):
    for op, item in (("telemetry", "15"),):
        resp = _ask(service, {"op": op, "id": 3})
        assert resp == {"id": 3, "ok": False, "error": "Unsupported",
                        "message": f"op {op!r} is not served by this port "
                                   f"yet; ROADMAP Queue 1 item {item} will "
                                   "serve it"}


def test_stats_keys_equal_jax(bams, jsvc, psvcs):
    path = bams["second"]
    for svc in (jsvc, psvcs(1)):
        assert _ask(svc, {"op": "count", "path": path})["ok"]
    want, got = jsvc.stats(), psvcs(1).stats()
    assert sorted(got) == sorted(want)
    assert got["jobs"] == {} and got["slo"] is None
    assert got["split_resolutions"] is None
    assert sorted(got["accounting"]) == sorted(want["accounting"])
    assert sorted(got["ops"]["count"]) == sorted(want["ops"]["count"])
    assert got["limits"] == want["limits"]
    assert got["tick_ms"] == want["tick_ms"]


# ------------------------------------------------------------ warm plans
@pytest.mark.parametrize("split_size", [64 << 10, 200_000])
def test_warm_plan_does_zero_split_resolutions(bams, tmp_path, monkeypatch,
                                               split_size):
    """Cold, a plan resolves as many splits as the JAX service does; warm
    from the ``.sbi`` sidecar it resolves none, with the same answer."""
    path = bams["main"]
    req = {"op": "plan", "path": path, "split_size": split_size, "id": 1}
    counts, answers = {}, {}
    for pkg in ("jax", "port"):
        monkeypatch.setenv("SPARK_BAM_CACHE_DIR", str(tmp_path / pkg))
        reset_shared_store()
        svc = (JSplitService(JConfig(serve=SERVE_SPEC, cache="readwrite"))
               if pkg == "jax" else
               SplitService(Config(serve=SERVE_SPEC, cache="readwrite"),
                            mesh=local_mesh(["cpu"])))
        o = jobs_obs if pkg == "jax" else obs
        try:
            for label in ("cold", "warm"):
                reg = o.configure()
                try:
                    answers[pkg, label] = _split(_ask(svc, req))
                    n = {c["name"]: c["value"]
                         for c in reg.snapshot()["counters"]}
                    counts[pkg, label] = n.get("load.split_resolutions", 0)
                    if pkg == "port":
                        stats = _ask(svc, {"op": "stats"})
                        assert stats["split_resolutions"] == \
                            counts[pkg, label]
                finally:
                    o.shutdown()
        finally:
            svc.close()
            reset_shared_store()
    n_splits = -(-os.path.getsize(path) // split_size)
    assert counts["jax", "cold"] == counts["port", "cold"] == n_splits
    assert counts["jax", "warm"] == counts["port", "warm"] == 0
    assert len({enc for enc, _ in answers.values()}) == 1


@pytest.mark.parametrize("cache", ["", "readwrite"])
def test_split_starts_equal_jax_cold_and_warm(bams, tmp_path, monkeypatch,
                                              cache):
    """``load.api.split_starts`` gives the JAX function's splits and
    starts and counts as many ``load.split_resolutions``; warm from a
    sidecar both count none."""
    from spark_bam_tpu.load import api as japi
    from spark_bam_tpu_torch.load import api

    path = bams["main"]
    counts, got = {}, {}
    for label in ("cold", "warm"):
        for pkg, o in (("jax", jobs_obs), ("port", obs)):
            monkeypatch.setenv("SPARK_BAM_CACHE_DIR", str(tmp_path / pkg))
            reset_shared_store()
            reg = o.configure()
            try:
                if pkg == "jax":
                    res = japi.split_starts(path, 60_000,
                                            JConfig(cache=cache))
                else:
                    res = api.split_starts(path, 60_000, Config(cache=cache),
                                           device="cpu")
                counts[pkg, label] = reg.counter(
                    "load.split_resolutions").value
            finally:
                o.shutdown()
            got[pkg, label] = [
                (s.start, s.end, None if p is None else
                 (p.block_pos, p.offset)) for s, p in res]
    reset_shared_store()
    n = -(-os.path.getsize(path) // 60_000)
    assert len({tuple(v) for v in got.values()}) == 1
    assert counts["jax", "cold"] == counts["port", "cold"] == n
    warm = 0 if cache else n
    assert counts["jax", "warm"] == counts["port", "warm"] == warm


def test_warm_compute_splits_counts_no_resolution(bams, tmp_path,
                                                  monkeypatch):
    import io

    from spark_bam_tpu_torch import cli

    monkeypatch.setenv("SPARK_BAM_CACHE_DIR", str(tmp_path))
    path = bams["main"]
    counts = []
    for cfg in (Config(cache="readwrite"), Config(cache="read")):
        reg = obs.configure()
        try:
            cli.compute_splits(path, 50_000, cfg, spark_bam=True,
                               device="cpu", out=io.StringIO())
            counts.append(reg.counter("load.split_resolutions").value)
        finally:
            obs.shutdown()
    assert counts == [-(-os.path.getsize(path) // 50_000), 0]


def test_plan_cache_read_only_miss_resolves_live(bams, tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_BAM_CACHE_DIR", str(tmp_path))
    svc = SplitService(Config(serve=SERVE_SPEC, cache="read"),
                       mesh=local_mesh(["cpu"]))
    try:
        reg = obs.configure()
        resp = _ask(svc, {"op": "plan", "path": bams["second"],
                          "split_size": 50_000})
        assert reg.counter("load.split_resolutions").value == \
            len(resp["splits"])
        assert not list(tmp_path.iterdir())     # read mode writes nothing
    finally:
        obs.shutdown()
        svc.close()


def test_batch_keeps_the_checker_starts_past_a_refused_record(
        tmp_path, jsvc, service):
    """``batch`` parses the checker's record starts, as the reference's
    does: where the checker refuses a record mid-file its frames hold the
    591 accepted rows (the export follows the record path: 601)."""
    from spark_bam_tpu_torch.benchmarks.load_cases import (
        write_refused_mid_bam,
    )

    path = str(tmp_path / "refused_mid.bam")
    write_refused_mid_bam(path)
    req = {"op": "batch", "path": path}
    got, want = _ask(service, req), _ask(jsvc, req)
    assert _split(got) == _split(want)
    assert got["rows"] == 591


# ------------------------------------------------------------ coalescing
def test_batched_counts_equal_sequential(service, bams):
    """Concurrent requests coalesced into shared ticks answer byte for
    byte what the same requests answer one at a time."""
    path = bams["main"]
    seq = [_ask(service, {"op": "count", "path": path}) for _ in range(3)]
    service.batcher.pause()
    futs = [service.submit({"op": "count", "path": path}) for _ in range(6)]
    time.sleep(0.3)   # the worker pool cuts every request into rows
    service.batcher.resume()
    batched = [f.result(timeout=300) for f in futs]
    assert seq[0]["ok"] and seq[0]["count"] == 2500
    for resp in seq[1:] + batched:
        assert _split(resp) == _split(seq[0])
    assert any(size > 1 for size in service.batcher.batch_sizes)


def test_fleet_coalesces_across_files(service, bams):
    paths = [bams["main"], bams["second"]]
    single = {p: _ask(service, {"op": "count", "path": p})["count"]
              for p in paths}
    fleet = _ask(service, {"op": "fleet", "paths": paths})
    assert fleet["paths"] == single
    assert fleet["total"] == sum(single.values()) == 3200


def test_long_rows_escape_to_the_exact_count(bams, tmp_path):
    """Records longer than the row's halo escape: the count comes from
    the exact starts (``exact_fallback``) and equals the JAX service's."""
    rng = np.random.default_rng(9)
    recs = [encode_record(pos=100 * i, name=b"L%d" % i,
                          cigar=((30_000, 0),), rng=rng) for i in range(12)]
    path = str(tmp_path / "long.bam")
    agg_cases._write(path, encode_header(), recs, block=20_000)
    spec = "window=64KB,halo=8KB,batch=4,tick=2"
    req = {"op": "count", "path": path, "id": 1}
    p = SplitService(Config(serve=spec), mesh=local_mesh(["cpu"]))
    j = JSplitService(JConfig(serve=spec))
    try:
        got, want = _ask(p, req), _ask(j, req)
    finally:
        p.close()
        j.close()
    assert got["escaped"] > 0 and got["exact_fallback"] is True
    assert got["count"] == 12
    assert _split(got) == _split(want)


# -------------------------------------------------------------- admission
def test_admission_rejects_over_limit_with_overloaded(bams):
    path = bams["main"]
    svc = SplitService(Config(serve=SERVE_SPEC + ",scanq=1"),
                       mesh=local_mesh(["cpu"]))
    try:
        svc.batcher.pause()
        first = svc.submit({"op": "count", "path": path})
        time.sleep(0.1)
        with pytest.raises(Overloaded) as exc:
            svc.submit({"op": "count", "path": path})
        assert exc.value.klass == "scan" and exc.value.retry_after_ms >= 0
        assert _ask(svc, {"op": "ping"})["pong"]
        svc.batcher.resume()
        assert first.result(timeout=300)["ok"]
        assert _ask(svc, {"op": "count", "path": path})["ok"]
    finally:
        svc.close()


def test_deadline_expiry_sheds_queued_work(bams):
    path = bams["main"]
    reg = obs.configure()
    svc = SplitService(Config(serve=SERVE_SPEC), mesh=local_mesh(["cpu"]))
    try:
        svc.batcher.pause()
        fut = svc.submit({"op": "count", "path": path, "deadline_ms": 30})
        time.sleep(0.3)
        svc.batcher.resume()
        resp = fut.result(timeout=300)
        assert not resp["ok"] and resp["error"] == "DeadlineExceeded"
        assert reg.counter("serve.shed").value >= 1
        assert _ask(svc, {"op": "count", "path": path})["ok"]
        # A deadline already past when a batch handler starts.
        late = _ask(svc, {"op": "batch", "path": path, "deadline_ms": 0})
        assert late["error"] == "DeadlineExceeded"
    finally:
        svc.close()
        obs.shutdown()


def test_fault_policy_deadline_is_the_default(bams):
    svc = SplitService(Config(serve=SERVE_SPEC, faults="deadline=0"),
                       mesh=local_mesh(["cpu"]))
    try:
        resp = _ask(svc, {"op": "count", "path": bams["main"]})
        assert resp["error"] == "DeadlineExceeded"
    finally:
        svc.close()


def test_drain_refuses_new_work_keeps_inflight(bams):
    path = bams["main"]
    svc = SplitService(Config(serve=SERVE_SPEC), mesh=local_mesh(["cpu"]))
    try:
        expected = _ask(svc, {"op": "count", "path": path})["count"]
        svc.batcher.pause()
        held = svc.submit({"op": "count", "path": path})
        time.sleep(0.1)
        drained = _ask(svc, {"op": "drain"})
        assert drained["draining"] is True
        assert drained["inflight"]["scan"] == 1
        refused = _ask(svc, {"op": "count", "path": path})
        assert refused["error"] == "Draining"
        assert _ask(svc, {"op": "ping"})["pong"]
        assert _ask(svc, {"op": "stats"})["draining"]
        svc.batcher.resume()
        assert held.result(timeout=300)["count"] == expected
    finally:
        svc.close()


def test_tune_applies_rounds_and_rejects():
    svc = SplitService(Config(serve=SERVE_SPEC), mesh=local_mesh(["cpu"] * 4))
    try:
        r = _ask(svc, {"op": "tune", "batch_rows": 3, "tick_ms": 2.5,
                       "scan_queue": 16})
        assert r["applied"] == {"batch_rows": 4, "tick_ms": 2.5,
                                "scan_queue": 16}
        assert svc.batcher.batch_rows == 4 and svc.gate.limits["scan"] == 16
        assert _ask(svc, {"op": "tune"})["error"] == "ProtocolError"
        assert _ask(svc, {"op": "tune", "scan_queue": 0})["error"] == \
            "ProtocolError"
    finally:
        svc.close()


def test_stats_reports_percentiles_and_knobs(service, bams):
    for _ in range(3):
        assert _ask(service, {"op": "count", "path": bams["main"]})["ok"]
    stats = service.stats()
    assert stats["latency_p50_ms"] is not None
    assert stats["latency_p99_ms"] >= stats["latency_p50_ms"]
    per_op = stats["ops"]["count"]
    assert per_op["requests"] == 3 and per_op["rows"] == 7500
    assert per_op["p99_ms"] >= per_op["p50_ms"]
    assert stats["draining"] is False and stats["queue_depth"] == 0
    assert stats["limits"] == {"plan": 64, "scan": 64, "control": 8}
    assert stats["tick_ms"] == pytest.approx(5.0)
    assert stats["accounting"]["totals"]["requests"] == 3


# -------------------------------------------------------------- warm tier
def test_file_state_is_resident_and_stat_fresh(service, bams, tmp_path):
    path = str(tmp_path / "copy.bam")
    Path(path).write_bytes(Path(bams["second"]).read_bytes())
    first = service.file_state(path)
    assert service.file_state(path) is first
    starts = first.starts(service.config)
    assert len(starts) == _ask(service, {"op": "record_starts",
                                         "path": path})["count"] == 700
    assert np.all(np.diff(starts) > 0)
    # A changed file is a new state: the count follows the new bytes.
    Path(path).write_bytes(Path(bams["main"]).read_bytes())
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert service.file_state(path) is not first
    assert _ask(service, {"op": "count", "path": path})["count"] == 2500


# ---------------------------------------------------------------- servers
def test_tcp_server_roundtrip(service, bams):
    path = bams["main"]
    with ServerThread(service) as srv:
        with ServeClient(srv.address) as c:
            assert c.request("ping")["devices"] == 1
            count = c.request("count", path=path)["count"]
            assert count == c.request("count", path=path)["count"] == 2500
            stats = c.request("stats")
            assert stats["batch_rows"] == 8 and stats["served"] >= 2
            starts = c.request("record_starts", path=path, limit=5)
            assert starts["count"] == count and len(starts["vpos"]) == 5
            with pytest.raises(ServeClientError) as exc:
                c.request("count", path=path + ".missing")
            assert exc.value.error == "NotFound"
            with pytest.raises(ServeClientError) as exc:
                c.request("bogus-op")
            assert exc.value.error == "ProtocolError"


def test_unix_server_roundtrip(service, bams, tmp_path):
    with ServerThread(service, f"unix:{tmp_path}/serve.sock") as srv:
        with ServeClient(srv.address) as c:
            assert c.transport == "shm"
            assert c.request("count", path=bams["main"])["count"] == 2500
            agg = c.request("aggregate", path=bams["main"], agg="count")
            assert agg["rows"] == 2500 and len(agg["_binary"]) == 1


def _raw_lines(address, lines: "list[bytes]") -> "list[bytes]":
    host, port = address
    with socket.create_connection((host, port), timeout=60) as s:
        f = s.makefile("rb")
        out = []
        for line in lines:
            s.sendall(line)
            out.append(f.readline())
        return out


def test_protocol_errors_on_the_wire_equal_jax(bams):
    """Malformed lines get the same bytes from both packages' servers."""
    lines = [b"not json\n", b'["a list"]\n', b'{"op": "unknown", "id": 1}\n',
             b'{"id": 2}\n']
    svc = SplitService(Config(serve=SERVE_SPEC), mesh=local_mesh(["cpu"]))
    jsvc = JSplitService(JConfig(serve=SERVE_SPEC))
    try:
        with ServerThread(svc) as srv, JServerThread(jsvc) as jsrv:
            got = _raw_lines(srv.address, lines)
            want = _raw_lines(jsrv.address, lines)
    finally:
        svc.close()
        jsvc.close()
    assert got == want
    assert all(b'"error":"ProtocolError"' in g for g in got)


def test_typed_errors_on_the_wire_equal_jax(bams):
    """``Overloaded`` (a held scan slot, Retry-After at its default),
    ``DeadlineExceeded`` and ``Draining`` leave both packages' servers as
    the same bytes."""
    path = bams["main"]
    spec = SERVE_SPEC + ",scanq=1"
    count = b'{"op": "count", "id": 5, "path": "%s"}\n' % path.encode()
    late = b'{"op": "plan", "id": 6, "path": "%s", "deadline_ms": 0}\n' % (
        path.encode())
    got = {}
    for pkg in ("port", "jax"):
        svc = (SplitService(Config(serve=spec), mesh=local_mesh(["cpu"]))
               if pkg == "port" else JSplitService(JConfig(serve=spec)))
        thread = ServerThread if pkg == "port" else JServerThread
        try:
            with thread(svc) as srv:
                svc.batcher.pause()
                held = svc.submit({"op": "count", "path": path})
                time.sleep(0.1)
                lines = _raw_lines(srv.address, [count, late])
                svc.batcher.resume()
                assert held.result(timeout=300)["ok"]
                svc.submit({"op": "drain"}).result(timeout=60)
                lines += _raw_lines(srv.address, [count])
        finally:
            svc.close()
        got[pkg] = lines
    assert got["port"] == got["jax"]
    assert [b'"error":"%s"' % e in ln for e, ln in zip(
        (b"Overloaded", b"DeadlineExceeded", b"Draining"), got["port"])] == \
        [True] * 3


def test_client_retries_overloaded_until_slot_frees(bams):
    path = bams["main"]
    svc = SplitService(Config(serve=SERVE_SPEC + ",scanq=1"),
                       mesh=local_mesh(["cpu"]))
    try:
        with ServerThread(svc) as srv:
            with ServeClient(srv.address) as c:
                expected = c.request("count", path=path)["count"]
            svc.batcher.pause()
            held = svc.submit({"op": "count", "path": path})
            time.sleep(0.1)
            with ServeClient(srv.address, policy=None) as c:
                with pytest.raises(ServeClientError) as exc:
                    c.request("count", path=path)
            assert exc.value.error == "Overloaded"
            assert exc.value.retry_after_ms >= 0
            timer = threading.Timer(0.3, svc.batcher.resume)
            timer.start()
            try:
                pol = FaultPolicy(max_retries=8, backoff_base=0.05,
                                  backoff_max=0.25, jitter=0.5)
                with ServeClient(srv.address, policy=pol) as c:
                    assert c.request("count", path=path)["count"] == expected
            finally:
                timer.join()
            assert held.result(timeout=300)["count"] == expected
    finally:
        svc.close()


@pytest.mark.parametrize("transport", ["socket", "auto"])
def test_jax_client_against_port_server(bams, transport):
    path = bams["main"]
    svc = SplitService(Config(serve=SERVE_SPEC), mesh=local_mesh(["cpu"]))
    try:
        with ServerThread(svc) as srv:
            with JServeClient(srv.address, transport=transport) as c:
                assert c.request("count", path=path)["count"] == 2500
                resp = c.request("batch", path=path, columns=["pos"])
                frames = [bytes(f) for f in resp["_binary"]]
                assert c.request("plan", path=path)["splits"]
        want = _ask(svc, {"op": "batch", "path": path, "columns": ["pos"]})
        assert frames == [bytes(f) for f in want["_binary"]]
    finally:
        svc.close()


@pytest.mark.parametrize("transport", ["socket", "auto"])
def test_port_client_against_jax_server(bams, transport):
    path = bams["main"]
    jsvc = JSplitService(JConfig(serve=SERVE_SPEC))
    try:
        with JServerThread(jsvc) as srv:
            with ServeClient(srv.address, transport=transport) as c:
                assert c.transport == ("shm" if transport == "auto"
                                       else "socket")
                assert c.request("count", path=path)["count"] == 2500
                resp = c.request("aggregate", path=path, agg="mapq")
                frames = [bytes(f) for f in resp["_binary"]]
        want = _ask(jsvc, {"op": "aggregate", "path": path, "agg": "mapq"})
        assert frames == [bytes(f) for f in want["_binary"]]
    finally:
        jsvc.close()


# ------------------------------------------------------ parsing surfaces
@pytest.mark.parametrize("spec", [
    "", "window=128KB,halo=16KB,batch=16,tick=1.5,planq=8,scanq=4,workers=3,"
        "cache=64MB", SERVE_SPEC, "batch_rows=3,tick_ms=0,plan_queue=1",
    "shm=0,shm_bytes=1MB,shm_wait=10", "flat-cache=1GB", "nope=1", "batch=0",
    "workers=0", "tick=-1", "scanq=0", "window=8KB,halo=8KB", "halo=0",
    "cache=0", "shm_bytes=1KB", "shm_wait=-2", "window", "batch=x",
])
def test_serve_config_equals_jax(spec):
    try:
        want = JServeConfig.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as exc:
            ServeConfig.parse(spec)
        assert str(exc.value) == str(e)
        return
    got = ServeConfig.parse(spec)
    for f in ("batch_rows", "tick_ms", "plan_queue", "scan_queue", "workers",
              "window", "halo", "flat_cache", "shm", "shm_bytes",
              "shm_wait_ms"):
        assert getattr(got, f) == getattr(want, f), f


def test_config_carries_serve_and_faults_specs(monkeypatch):
    assert Config(serve="batch=32").serve_config.batch_rows == 32
    assert Config().serve_config == ServeConfig()
    assert Config(faults="retries=5,deadline=2").fault_policy == \
        FaultPolicy(max_retries=5, deadline=2.0)
    monkeypatch.setenv("SPARK_BAM_SERVE", "batch=4")
    monkeypatch.setenv("SPARK_BAM_FAULTS", "mode=tolerant")
    cfg = Config.from_env()
    want = JConfig.from_env()
    assert (cfg.serve, cfg.faults) == (want.serve, want.faults)
    assert cfg.serve_config.batch_rows == 4 and cfg.fault_policy.tolerant


@pytest.mark.parametrize("spec", [
    "unix:/tmp/x.sock", "tcp:0.0.0.0:9000", "127.0.0.1:0", "tcp::80",
    "tcp:[::1]:7", "unix:", "tcp:nowhere", "nowhere", "tcp:host:port",
])
def test_serve_address_equals_jax(spec):
    try:
        want = JServeAddress(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as exc:
            ServeAddress(spec)
        assert str(exc.value) == str(e)
        return
    got = ServeAddress(spec)
    assert got.kind == want.kind
    assert vars(got) == vars(want)


@pytest.mark.parametrize("line", [
    b'{"op": "ping", "id": 7}\n', b'{"op": "count", "path": "x"}',
    b"not json\n", b'["not", "a", "dict"]\n', b'{"op": "unknown"}\n',
    b"{}", b'{"op": "hello", "transport": "shm"}', b'{"op": 3}',
])
def test_protocol_parsing_equals_jax(line):
    try:
        want = jdecode(line)
    except ValueError as e:
        with pytest.raises(ProtocolError) as exc:
            decode_request(line)
        assert str(exc.value) == str(e)
        return
    got = decode_request(line)
    assert got == want
    assert encode(ok_response(got, x=1)) == encode(
        {"id": got.get("id"), "ok": True, "x": 1})
    err = error_response(got, "Overloaded", "full", retry_after_ms=12.5)
    assert not err["ok"] and err["retry_after_ms"] == 12.5


# ----------------------------------------------------- device, CLI, threads
def test_service_without_a_mesh_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SplitService(Config(serve=SERVE_SPEC))


def test_serve_command_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "spark_bam_tpu_torch", "serve", "--listen",
         "tcp:127.0.0.1:0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "serving on" not in proc.stderr


def test_serve_command_on_the_cpu_answers(bams, tmp_path):
    sock = tmp_path / "cli.sock"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_bam_tpu_torch", "serve", "--device",
         "cpu", "--listen", f"unix:{sock}", "--serve", SERVE_SPEC],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert line.startswith(f"serving on unix:{sock} ({sock}; 1 devices)")
        for _ in range(600):        # the socket binds after the line
            if sock.exists():
                break
            time.sleep(0.1)
        with ServeClient(f"unix:{sock}") as c:
            assert c.request("count", path=bams["main"])["count"] == 2500
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stderr.close()


def test_serve_command_usage_errors():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for args in (["--serve", "nope=1"], ["--listen", "tcp:nowhere"]):
        proc = subprocess.run(
            [sys.executable, "-m", "spark_bam_tpu_torch", "serve", "--device",
             "cpu", *args], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 2 and proc.stderr.startswith("error: ")


def test_concurrent_ops_equal_sequential(bams):
    """Eight client threads mixing counts, record starts and aggregates on
    one service answer what each request answers alone."""
    svc = SplitService(Config(serve=SERVE_SPEC), mesh=local_mesh(["cpu"] * 2))
    reqs = [{"op": "count", "path": bams["main"]},
            {"op": "count", "path": bams["second"], "start": 10_000},
            {"op": "record_starts", "path": bams["tagged"], "limit": 9},
            {"op": "aggregate", "path": bams["main"], "agg": "mapq;count"},
            {"op": "aggregate", "path": bams["tagged"],
             "tags_required": ["RG"]},
            {"op": "fleet", "paths": [bams["main"], bams["tagged"]]}]
    try:
        want = [_split(_ask(svc, r)) for r in reqs]
        errors = []

        def client(i):
            try:
                for j in range(6):
                    r = reqs[(i + j) % len(reqs)]
                    if _split(_ask(svc, r)) != want[(i + j) % len(reqs)]:
                        errors.append((i, j))
            except Exception as e:       # surfaced by the assert below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert svc.stats()["served"] == len(reqs) + 48
    finally:
        svc.close()


def test_failing_tick_fails_every_row(bams, monkeypatch):
    """A serve step that raises fails the tick's requests with an error
    response; nothing counts in the device's place."""
    svc = SplitService(Config(serve=SERVE_SPEC), mesh=local_mesh(["cpu"]))
    try:
        def broken(*a, **kw):
            raise RuntimeError("device lost")
        monkeypatch.setattr(svc.batcher, "_step", broken)
        resp = _ask(svc, {"op": "count", "path": bams["main"]})
        assert resp["error"] == "Internal"
        assert "device lost" in resp["message"]
        fleet = _ask(svc, {"op": "fleet", "paths": [bams["main"]]})
        assert fleet["error"] == "Internal"
    finally:
        svc.close()


@pytest.mark.parametrize("target", ["aggregate_planes", "parse_flat_records",
                                    "record_starts"])
def test_device_failures_are_error_responses(bams, monkeypatch, target):
    """A failing aggregate reduction, parse or starts pass answers
    ``Internal``: there is no host aggregate, parse or count instead."""
    from spark_bam_tpu_torch.agg import kernels as agg_kernels
    from spark_bam_tpu_torch.load import tpu_load
    from spark_bam_tpu_torch.tpu import parser

    mod, failing = {
        "aggregate_planes": (agg_kernels, {"aggregate"}),
        "parse_flat_records": (parser, {"aggregate", "batch"}),
        "record_starts": (tpu_load, {"aggregate", "batch", "record_starts"}),
    }[target]

    def broken(*a, **kw):
        raise RuntimeError(f"{target} failed on the device")
    monkeypatch.setattr(mod, target, broken)
    svc = SplitService(Config(serve=SERVE_SPEC), mesh=local_mesh(["cpu"]))
    try:
        for req in ({"op": "aggregate", "path": bams["main"]},
                    {"op": "batch", "path": bams["main"]},
                    {"op": "record_starts", "path": bams["main"]}):
            resp = _ask(svc, req)
            if req["op"] not in failing:
                assert resp["ok"]
                continue
            assert resp["error"] == "Internal", (req, resp)
            assert f"{target} failed on the device" in resp["message"]
    finally:
        svc.close()


def test_tile_status_tickets_follow_launch_order():
    """Host threads that take tile-status tickets and enqueue on one
    stream under ``ordered`` enqueue in ticket order: the epochs rise by
    one and the ticket bases tile, whatever the threads' interleaving."""
    status = K.TileStatus(4)
    dev = torch.device("cpu")
    # Records sized for the largest launch up front (a larger launch
    # replaces them and restarts the epochs).
    _, base0, epoch0 = status.next(dev, 7, 21)
    stream = [(base0, epoch0, 21)]

    def launcher(tiles):
        for _ in range(50):
            with status.ordered:
                _, base, epoch = status.next(dev, 7, tiles)
                time.sleep(0)        # a launch that yields the GIL
                stream.append((base, epoch, tiles))

    threads = [threading.Thread(target=launcher, args=(t,))
               for t in (3, 5, 8, 13, 3, 5, 8, 13, 21, 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert [e for _, e, _ in stream] == list(range(1, len(stream) + 1))
    base = 0
    for b, _, tiles in stream:
        assert b == base
        base = (base + tiles) & 0xFFFFFFFF


def test_serve_modules_import_no_jax():
    probe = ("import sys; import spark_bam_tpu_torch.serve, "
             "spark_bam_tpu_torch.obs.account, spark_bam_tpu_torch.core.faults"
             "; bad = [n for n in sys.modules if n.split('.')[0] in "
             "('jax', 'jaxlib', 'spark_bam_tpu')]; print(bad)")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"

