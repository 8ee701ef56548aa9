"""The port's remote channels (``core/remote.py``, ``core/prefetch.py``,
``core/remote_plan.py``, ``core/cloud.py``) and its URL consumers against
the JAX package's, both reading one in-process fake object store
(``benchmarks/fakestore.py``, loopback only): the same bytes, the same
ranged GETs for the same plan, the same refusals, and over a URL the same
streaming count, full-check summary, records, ``.sbi`` bytes, fingerprint
and fleet load as the JAX package's over that URL."""

import contextlib
import io
import os
import re
import threading
import time

import numpy as np
import pytest

import spark_bam_tpu.core.cloud as jcloud
import spark_bam_tpu.core.remote as jremote
import spark_bam_tpu.core.remote_plan as jplan
import spark_bam_tpu_torch.core.cloud as tcloud
import spark_bam_tpu_torch.core.remote as tremote
import spark_bam_tpu_torch.core.remote_plan as tplan
from spark_bam_tpu.bgzf.index_blocks import blocks_metadata as jax_blocks
from spark_bam_tpu.core.channel import ByteChannel as JByteChannel
from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu.core.guard import StructurallyInvalid as JStructurallyInvalid
from spark_bam_tpu.core.prefetch import PrefetchChannel as JPrefetch
from spark_bam_tpu.load import api as japi
from spark_bam_tpu.parallel.executor import ParallelConfig as JParallel
from spark_bam_tpu.sbi.format import fingerprint_of as jax_fingerprint
from spark_bam_tpu.tpu.stream_check import (
    count_reads_streaming as jax_count,
    full_check_summary_streaming as jax_summary,
)
from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.benchmarks.fakestore import FakeObjectStore
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.core.channel import ByteChannel, open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.faults import FaultPolicy
from spark_bam_tpu_torch.core.guard import StructurallyInvalid
from spark_bam_tpu_torch.core.prefetch import PrefetchChannel
from spark_bam_tpu_torch.load import api
from spark_bam_tpu_torch.parallel.executor import ParallelConfig
from spark_bam_tpu_torch.sbi.format import fingerprint_of
from spark_bam_tpu_torch.tpu.stream_check import (
    StreamChecker,
    full_check_summary_streaming,
)
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WINDOW, HALO = 64 << 10, 16 << 10


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_remote")
    out = []
    for i, seed in enumerate((61, 62, 63)):
        p = d / f"r{i}.bam"
        random_bam(p, seed=seed, read_len=(10, 300), n_records=(300, 500))
        out.append(str(p))
    return out


@pytest.fixture(scope="module")
def store(bams):
    objects = {os.path.basename(p): open(p, "rb").read() for p in bams}
    with FakeObjectStore(objects=objects) as s:
        yield s


def _url(store, path) -> str:
    return f"{store.url_base}/bucket/{os.path.basename(path)}"


@pytest.fixture(autouse=True)
def _clean_remote():
    tplan.set_remote_config(None)
    yield
    tplan.set_remote_config(None)


# ------------------------------------------------------------ range channel
def test_http_range_channel_reads_and_eof(bams, store):
    data = open(bams[0], "rb").read()
    url = _url(store, bams[0])
    with tremote.HttpRangeChannel(url) as t, jremote.HttpRangeChannel(url) as j:
        assert t.size == j.size == len(data)
        for pos, n in ((0, 100), (777, 65_536), (len(data) - 10, 100),
                       (len(data), 10), (len(data) + 5, 10), (3, 0)):
            got = t.read_at(pos, n)
            assert got == j.read_at(pos, n) == data[pos: pos + n]
        t.seek(len(data) - 3)
        with pytest.raises(EOFError):
            t.read_fully(8)   # a short read at EOF


def test_missing_object_reads_as_absent(store):
    from spark_bam_tpu_torch.core.channel import path_exists

    url = f"{store.url_base}/bucket/none.bam"
    with pytest.raises(FileNotFoundError):
        tremote.HttpRangeChannel(url).size
    assert not path_exists(url) and not path_exists(url + ".blocks")


def test_ignored_range_is_refused_as_jax(bams):
    data = open(bams[0], "rb").read()
    with FakeObjectStore(data, key="x.bam", ignore_range=True) as s:
        url = f"{s.url_base}/b/x.bam"
        with pytest.raises(StructurallyInvalid, match="ignored Range"):
            tremote.HttpRangeChannel(url).read_at(100, 50)
        with pytest.raises(JStructurallyInvalid, match="ignored Range"):
            jremote.HttpRangeChannel(url).read_at(100, 50)
        # The honest whole object from byte 0 is accepted.
        assert tremote.HttpRangeChannel(url).read_at(0, len(data) + 10) == data


def test_throttle_is_retried_after_retry_after(bams):
    data = open(bams[0], "rb").read()
    with FakeObjectStore(data, key="x.bam", throttle_rate=0.5,
                         retry_after_s=0.01, seed=3) as s:
        url = f"{s.url_base}/b/x.bam"
        ch = tremote.HttpRangeChannel(url, retries=8)
        for pos in range(0, 40_000, 4_000):
            assert ch.read_at(pos, 1000) == data[pos: pos + 1000]
        assert s.stats["throttles"] > 0


@pytest.mark.parametrize("value", [
    None, "", "bytes 0-99/12345", "bytes */12345", "bytes 77-80/100",
    "items 1-2/3", "bytes x-1/2"])
def test_content_range_start_equals_jax(value):
    assert tremote._content_range_start(value) == \
        jremote._content_range_start(value)


@pytest.mark.parametrize("value", [None, "", "3", "0.25", "nan", "inf",
                                   "Wed, 21 Oct 2015 07:28:00 GMT", "soon"])
def test_parse_retry_after_equals_jax(value):
    assert tremote._parse_retry_after(value) == \
        jremote._parse_retry_after(value)


# ------------------------------------------------------------ read-ahead
class _Logged:
    """Wraps a range channel and logs every inner GET (pos, n)."""

    def __init__(self, base, inner):
        self.log = []
        outer = self

        class Inner(base):
            url = inner.url

            def _read_at(self, pos, n):
                with lock:
                    outer.log.append((pos, n))
                return inner._read_at(pos, n)

            @property
            def size(self):
                return inner.size

            def close(self):
                inner.close()

        lock = threading.Lock()
        self.ch = Inner()


def test_prefetch_channel_equals_jax(bams, store):
    data = open(bams[1], "rb").read()
    url = _url(store, bams[1])
    logs = []
    for base, cls, rc in ((ByteChannel, PrefetchChannel, tremote),
                          (JByteChannel, JPrefetch, jremote)):
        inner = _Logged(base, rc.HttpRangeChannel(url))
        ch = cls(inner.ch, chunk_size=16 << 10, depth=2, workers=2)
        pos = 0
        while pos < len(data):
            assert bytes(ch.read_at(pos, 5000)) == data[pos: pos + 5000]
            pos += 5000
        ch.close()
        logs.append(sorted(set(inner.log)))
    assert logs[0] == logs[1]


def _planned_gets(plan_mod, base, rc, url, plan, reads, **cfg):
    inner = _Logged(base, rc.HttpRangeChannel(url))
    ch = plan_mod.PlannedChannel(
        inner.ch, plan=plan, config=plan_mod.RemoteConfig(hedge=0, **cfg),
        policy=plan_mod.FaultPolicy())
    out = [bytes(ch.read_at(p, n)) for p, n in reads]
    ch.close()
    return out, sorted(inner.log), len(inner.log)


@pytest.mark.parametrize("plan_kind", ["blocks", "none", "sparse"])
def test_planned_channel_gets_equal_jax(bams, store, plan_kind):
    """With hedging off, the GETs a ``PlannedChannel`` issues (ranges and
    count) for one plan and one read sequence equal the reference's."""
    url = _url(store, bams[0])
    metas = blocks_metadata(bams[0])
    table = [(m.start, m.start + m.compressed_size) for m in metas]
    plan = {"blocks": table, "none": None, "sparse": table[::3]}[plan_kind]
    reads = [(m.start, m.compressed_size) for m in metas]
    kw = dict(max_request=32 << 10, coalesce_gap=1 << 10, depth=2)
    t = _planned_gets(tplan, ByteChannel, tremote, url, plan, reads, **kw)
    j = _planned_gets(jplan, JByteChannel, jremote, url, plan, reads, **kw)
    assert t[0] == j[0]
    assert t[1:] == j[1:]
    data = open(bams[0], "rb").read()
    assert b"".join(t[0]) == data[: sum(n for _, n in reads)]


def test_blocks_metadata_gets_equal_jax(bams, store):
    url = _url(store, bams[2])
    n0 = store.stats["requests"]
    want = [(m.start, m.compressed_size, m.uncompressed_size)
            for m in jax_blocks(url)]
    jax_requests = store.stats["requests"] - n0
    n0 = store.stats["requests"]
    got = [(m.start, m.compressed_size, m.uncompressed_size)
           for m in blocks_metadata(url)]
    assert got == want == [(m.start, m.compressed_size, m.uncompressed_size)
                           for m in blocks_metadata(bams[2])]
    assert store.stats["requests"] - n0 == jax_requests


def test_remote_config_parse_equals_jax():
    for spec in ("", "mode=plan,depth=8,gap=128KB,request=512KB,hedge=3",
                 "mode=legacy", "hedge=off,pool=4,bucket=2,cache=1MB",
                 "max_depth=3,coalesce_gap=0"):
        assert tplan.RemoteConfig.parse(spec).__dict__ == \
            jplan.RemoteConfig.parse(spec).__dict__
    for bad in ("mode=x", "depth=-1", "pool=0", "nope=1", "depth"):
        with pytest.raises(ValueError):
            tplan.RemoteConfig.parse(bad)
        with pytest.raises(ValueError):
            jplan.RemoteConfig.parse(bad)


def test_legacy_mode_wraps_in_prefetch(bams, store):
    tplan.set_remote_config("mode=legacy")
    with open_channel(_url(store, bams[0])) as ch:
        assert isinstance(ch, PrefetchChannel)
    tplan.set_remote_config(None)
    with open_channel(_url(store, bams[0])) as ch:
        assert isinstance(ch, tplan.PlannedChannel)


def test_adaptive_depth_grows_on_stalls(bams):
    data = open(bams[0], "rb").read()
    with FakeObjectStore(data, key="x.bam", latency_s=0.01) as s:
        inner = tremote.HttpRangeChannel(f"{s.url_base}/b/x.bam")
        ch = tplan.PlannedChannel(inner, config=tplan.RemoteConfig(
            max_request=4096, hedge=0))
        assert ch.depth == 8
        pos = 0
        while pos < len(data):
            assert bytes(ch.read_at(pos, 4096)) == data[pos: pos + 4096]
            pos += 4096
        assert ch.depth > 8
        ch.close()


def test_hedging_cuts_a_straggler(bams):
    """Seeded stragglers at 25x the base latency: hedged GETs bring the
    scan in well under the stragglers' cost."""
    data = open(bams[0], "rb").read()[: 256 << 10]
    reg = obs.configure()
    try:
        with FakeObjectStore(data, key="x.bam", latency_s=0.01,
                             straggler_rate=0.3, straggler_factor=25,
                             seed=5) as s:
            inner = tremote.HttpRangeChannel(f"{s.url_base}/b/x.bam")
            ch = tplan.PlannedChannel(
                inner, config=tplan.RemoteConfig(max_request=8192, depth=1,
                                                 hedge=2.0),
                policy=FaultPolicy())
            t0 = time.monotonic()
            pos = 0
            while pos < len(data):
                assert bytes(ch.read_at(pos, 8192)) == data[pos: pos + 8192]
                pos += 8192
            wall = time.monotonic() - t0
            ch.close()
            stragglers = s.stats["stragglers"]
        hedges = reg.counter("remote.hedges").value
    finally:
        obs.shutdown()
    assert stragglers > 0 and hedges > 0
    assert wall < stragglers * 0.25


def test_bucket_quota_holds(bams):
    data = open(bams[0], "rb").read()
    tplan.reset_bucket_stats()
    with FakeObjectStore(data, key="x.bam", latency_s=0.02) as s:
        url = f"{s.url_base}/b/x.bam"
        cfg = tplan.RemoteConfig(max_request=4096, depth=16, hedge=0,
                                 bucket_quota=2)
        chans = [tplan.PlannedChannel(tremote.HttpRangeChannel(url),
                                      config=cfg) for _ in range(3)]

        def scan(ch):
            for pos in range(0, 64 << 10, 4096):
                assert bytes(ch.read_at(pos, 4096)) == data[pos: pos + 4096]

        threads = [threading.Thread(target=scan, args=(c,)) for c in chans]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = tplan.bucket_inflight_stats()[s.url_base]
        for c in chans:
            c.close()
    assert 1 <= stats["high"] <= 2


# ------------------------------------------------------------------ clouds
def test_gs_bearer_and_s3_unsigned(bams, monkeypatch):
    data = open(bams[0], "rb").read()
    with FakeObjectStore(data, key="obj.bam", require_bearer="tok") as s:
        monkeypatch.setenv("SPARK_BAM_GS_ENDPOINT", s.url_base)
        monkeypatch.delenv("GOOGLE_OAUTH_ACCESS_TOKEN", raising=False)
        monkeypatch.delenv("SPARK_BAM_GS_TOKEN", raising=False)
        with pytest.raises(IOError):
            open_channel("gs://bkt/obj.bam").read_at(0, 10)
        monkeypatch.setenv("SPARK_BAM_GS_TOKEN", "tok")
        with open_channel("gs://bkt/obj.bam") as ch:
            assert bytes(ch.read_at(5, 1000)) == data[5:1005]
        assert s.stats["auth_failures"] >= 1
        assert tcloud.gs_https_url("gs://bkt/a b.bam")[0] == \
            jcloud.gs_https_url("gs://bkt/a b.bam")[0]
    with FakeObjectStore(data, key="obj.bam") as s:
        monkeypatch.setenv("SPARK_BAM_S3_ENDPOINT", s.url_base)
        for k in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY"):
            monkeypatch.delenv(k, raising=False)
        with open_channel("s3://bkt/obj.bam") as ch:
            assert bytes(ch.read_at(0, len(data))) == data
        assert tcloud.s3_https_url("s3://bkt/obj.bam")[1]("GET") == {}


@pytest.mark.parametrize("method,token", [("GET", None), ("HEAD", "sess")])
def test_sigv4_headers_equal_jax(method, token):
    args = (method, "bkt.s3.eu-west-1.amazonaws.com", "/dir/a b+c.bam",
            "eu-west-1", "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG", token,
            "20240102T030405Z")
    got = tcloud._sigv4_headers(*args)
    assert got == jcloud._sigv4_headers(*args)
    assert got["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20240102/eu-west-1/s3/")


# ------------------------------------------------------- URL consumers
@pytest.mark.parametrize("device_inflate", [True, False],
                         ids=["device_inflate", "host_zlib"])
def test_streaming_count_over_url_equals_jax(bams, store, device_inflate):
    url = _url(store, bams[0])
    want = jax_count(url, JConfig(), window_uncompressed=WINDOW, halo=HALO,
                     use_device=False)
    sc = StreamChecker(url, Config(device_inflate=device_inflate),
                       window_uncompressed=WINDOW, halo=HALO, device="cpu")
    assert sc.count_reads() == want == StreamChecker(
        bams[0], Config(), window_uncompressed=WINDOW, halo=HALO,
        device="cpu").count_reads()
    assert sc.tokenize_demotions == 0


def test_full_check_summary_over_url_equals_jax(bams, store):
    url = _url(store, bams[1])
    got = full_check_summary_streaming(url, Config(), WINDOW, HALO,
                                       device="cpu")
    want = jax_summary(url, JConfig(), WINDOW, HALO, use_device=False)
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def _records(ds):
    return [(p.block_pos, p.offset, r.encode()) for p, r in ds.collect()]


@pytest.mark.parametrize("split", ["16KB", "64KB"])
def test_load_bam_over_url_equals_jax(bams, store, split):
    url = _url(store, bams[2])
    got = _records(api.load_reads_and_positions(
        url, split, Config(), ParallelConfig("threads", 2), device="cpu"))
    want = [(p.block_pos, p.offset, r.encode()) for p, r in
            japi.load_reads_and_positions(url, split, JConfig(),
                                          JParallel("threads", 2)).collect()]
    assert got == want and len(got) > 100
    assert api.load_bam(url, split, device="cpu").count() == len(want)


def test_load_fleet_over_urls_equals_jax(bams, store):
    urls = [_url(store, p) for p in bams]
    got = [(u, p.block_pos, p.offset, r.encode()) for u, p, r in
           api.load_fleet(urls, "32KB", Config(), ParallelConfig("threads", 3),
                          device="cpu").collect()]
    want = [(u, p.block_pos, p.offset, r.encode()) for u, p, r in
            japi.load_fleet(urls, "32KB", JConfig(),
                            JParallel("threads", 3)).collect()]
    assert got == want
    assert {u for u, *_ in got} == set(urls)


def test_fingerprint_over_url_equals_jax(bams, store):
    url = _url(store, bams[0])
    n0 = store.stats["requests"]
    got = fingerprint_of(url, Config())
    assert store.stats["requests"] - n0 == 1   # one ranged GET
    assert got.__dict__ == jax_fingerprint(url, JConfig()).__dict__


def test_index_sbi_over_url_equals_jax(bams, store, tmp_path, monkeypatch):
    """``index`` of a URL BAM writes its ``.sbi`` only under the shared
    cache dir (keyed by the URL), byte for byte the JAX CLI's."""
    from spark_bam_tpu.cli.main import main as jax_main
    from spark_bam_tpu_torch import cli
    from spark_bam_tpu_torch.sbi.store import CacheStore

    url = _url(store, bams[1])
    sides = {}
    for name, run in (("port", lambda: cli.main(
            ["index", "-m", "16KB", "--device", "cpu", url])),
            ("jax", lambda: jax_main(["index", "-m", "16KB", url]))):
        d = tmp_path / name
        monkeypatch.setenv("SPARK_BAM_CACHE_DIR", str(d))
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert run() == 0
        sidecar = CacheStore.from_env().sidecar_path(url)
        assert sidecar.startswith(str(d)) and os.path.exists(sidecar)
        sides[name] = open(sidecar, "rb").read()
    assert sides["port"] == sides["jax"]
    monkeypatch.delenv("SPARK_BAM_CACHE_DIR")
    # No shared dir: nothing is written beside a URL.
    from spark_bam_tpu_torch.sbi import store as tstore

    tstore.reset_cache_events()
    cfg = Config(cache="readwrite")
    assert api.split_starts(url, "16KB", cfg, device="cpu")
    assert any("SPARK_BAM_CACHE_DIR" in e.reason
               for e in tstore.cache_events())


def test_count_reads_cli_over_url_under_chaos(bams, store):
    """The record path's count over a URL with seeded channel faults: the
    retried reads give the count unchanged."""
    from spark_bam_tpu_torch import cli

    url = _url(store, bams[0])
    out = []
    for extra in ([], ["--chaos", "7:io=0.05", "--faults", "retries=5"]):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert cli.main(["count-reads", "-m", "16KB", "--device", "cpu"]
                            + extra + [url]) == 0
        out.append(buf.getvalue())
    count = re.search(r"spark-bam found (\d+) reads|Read counts matched: (\d+)",
                      out[0])
    n = next(g for g in count.groups() if g)
    assert re.search(rf"spark-bam found {n} reads|Read counts matched: {n}",
                     out[1])
    assert "chaos(seed=7): injected io=" in out[1]
