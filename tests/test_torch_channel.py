"""The port's channel layer, fetch planner, channel chaos and decode-limit
surface (``core/channel.py``, ``core/ranges.py``, ``core/faults.py``,
``core/guard.py``) against the JAX package's: the same bytes, the same
reads reaching the inner channel, the same GET plans, the same faults at
the same offsets for a seed, and the same limits from the same specs."""

import os
import random
import time

import numpy as np
import pytest

import spark_bam_tpu.core.channel as jch
import spark_bam_tpu.core.faults as jfaults
import spark_bam_tpu.core.guard as jguard
import spark_bam_tpu.core.ranges as jranges
import spark_bam_tpu_torch.core.channel as tch
import spark_bam_tpu_torch.core.faults as tfaults
import spark_bam_tpu_torch.core.guard as tguard
import spark_bam_tpu_torch.core.ranges as tranges
from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu_torch.core.config import Config as TConfig


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    rng = np.random.default_rng(7)
    p = tmp_path_factory.mktemp("torch_channel") / "blob.bin"
    p.write_bytes(rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes())
    return str(p)


# ----------------------------------------------------------------- channels
def test_mmap_channel_reads_equal_jax(blob):
    rng = random.Random(3)
    with tch.open_channel(blob) as t, jch.open_channel(blob) as j:
        assert isinstance(t, tch.MMapChannel) and tch.FileChannel is tch.MMapChannel
        assert t.size == j.size == os.path.getsize(blob)
        for _ in range(200):
            pos = rng.randrange(0, t.size + 100)
            n = rng.randrange(0, 5000)
            assert bytes(t.read_at(pos, n)) == bytes(j.read_at(pos, n))
        t.seek(299_990)
        j.seek(299_990)
        assert (t.read_i32(), t.read_u16(), t.read_u8()) == \
            (j.read_i32(), j.read_u16(), j.read_u8())
        assert t.position() == j.position()
        with pytest.raises(EOFError):
            t.read_fully(10)
        with pytest.raises(EOFError):
            j.read_fully(10)


def test_empty_file_channel(tmp_path):
    p = tmp_path / "empty"
    p.write_bytes(b"")
    with tch.open_channel(p) as t:
        assert t.size == 0 and bytes(t.read_at(0, 10)) == b""


class _Logged:
    """An inner channel that logs every positioned read."""

    def __init__(self, base, path):
        self.ch = base.MMapChannel(path)
        self.log = []
        self.wrapped = None

    def wrap(self, base):
        outer = self

        class Inner(base.ByteChannel):
            def _read_at(self, pos, n):
                outer.log.append((pos, n))
                return bytes(outer.ch._read_at(pos, n))

            @property
            def size(self):
                return outer.ch.size

            def close(self):
                outer.ch.close()

        return Inner()


@pytest.mark.parametrize("chunk,cache", [(4096, 4), (65536, 64), (1000, 2)])
def test_caching_channel_equals_jax(blob, chunk, cache):
    logs, datas = [], []
    for base in (tch, jch):
        inner = _Logged(base, blob)
        ch = base.CachingChannel(inner.wrap(base), chunk_size=chunk,
                                 max_chunks=cache)
        rng = random.Random(11)
        out = [bytes(ch.read_at(rng.randrange(0, 310_000),
                                rng.randrange(1, 20_000)))
               for _ in range(120)]
        ch.close()
        logs.append(inner.log)
        datas.append(out)
    assert datas[0] == datas[1]
    assert logs[0] == logs[1]


def test_registered_scheme_serves_both_packages(blob):
    """A ``slow://`` scheme (a local file behind 2 ms a read), as the
    reference's remote tests register one: each package's
    ``open_channel`` dispatches it, with the chaos seam and the cache."""
    calls = []

    def factory(base):
        def make(url):
            path = url[len("slow://"):]
            inner = base.MMapChannel(path)

            class Slow(base.ByteChannel):
                def _read_at(self, pos, n):
                    calls.append(base.__name__)
                    time.sleep(0.002)
                    return bytes(inner._read_at(pos, n))

                @property
                def size(self):
                    return inner.size

                def close(self):
                    inner.close()

            return Slow()
        return make

    tch.register_scheme("slow", factory(tch))
    jch.register_scheme("slow", factory(jch))
    try:
        url = "slow://" + blob
        assert tch.is_url(url) and not tch.is_url(blob)
        with tch.open_channel(url, cached=True) as t, \
                jch.open_channel(url, cached=True) as j:
            assert isinstance(t, tch.CachingChannel)
            assert bytes(t.read_at(1000, 70_000)) == \
                bytes(j.read_at(1000, 70_000))
        assert tch.path_size(url) == jch.path_size(url) == os.path.getsize(blob)
        assert tch.path_exists(url) and tch.path_exists(blob)
        assert not tch.path_exists(blob + ".missing")
        assert calls.count(tch.__name__) == calls.count(jch.__name__) > 0
    finally:
        tch._SCHEMES.pop("slow", None)
        jch._SCHEMES.pop("slow", None)
    with pytest.raises(ValueError, match="no channel backend"):
        tch.open_channel("nosuch://x/y")


def test_read_text_of_local_sidecar(tmp_path):
    p = tmp_path / "x.blocks"
    p.write_text("0,10,20\n10,5,6\n")
    assert tch.read_text(p) == jch.read_text(str(p))


# -------------------------------------------------------------- fetch plans
def _block_table(rng, n):
    starts, pos = [], 0
    for _ in range(n):
        size = rng.randrange(20, 70_000)
        starts.append((pos, pos + size))
        pos += size + (rng.randrange(0, 300_000) if rng.random() < 0.2 else 0)
    return starts


@pytest.mark.parametrize("seed", range(6))
def test_plan_fetches_equals_jax(seed):
    rng = random.Random(seed)
    table = _block_table(rng, rng.randrange(0, 400))
    gap = rng.choice([0, 1 << 10, 128 << 10, 1 << 20])
    req = rng.choice([4096, 100_000, 512 << 10, 4 << 20])
    t = tranges.plan_fetches([tranges.ByteRange(a, b) for a, b in table],
                             gap=gap, max_request=req)
    j = jranges.plan_fetches([jranges.ByteRange(a, b) for a, b in table],
                             gap=gap, max_request=req)
    assert [(r.start, r.end) for r in t] == [(r.start, r.end) for r in j]
    assert all(r.end - r.start <= req for r in t)


def test_plan_fetches_rejects_as_jax():
    for kw in ({"gap": -1}, {"max_request": 0}):
        with pytest.raises(ValueError):
            tranges.plan_fetches([], **kw)
        with pytest.raises(ValueError):
            jranges.plan_fetches([], **kw)


# -------------------------------------------------------------------- chaos
def _chaos_run(base, faults, blob, spec, seed):
    """Reads at seeded offsets through a ChaosChannel, with one retry a
    failed read: (outcome per read, injected tallies)."""
    inner = base.MMapChannel(blob)
    seed_i, cspec = faults.parse_chaos(f"{seed}:{spec}")
    ch = faults.ChaosChannel(inner, seed_i, cspec)
    rng = random.Random(seed)
    out = []
    for _ in range(400):
        pos, n = rng.randrange(0, 300_000), rng.randrange(1, 3000)
        for _attempt in range(2):
            try:
                out.append(("ok", pos, bytes(ch.read_at(pos, n))))
                break
            except faults.ChaosError as e:
                out.append((type(e).__name__, pos, str(e)))
    ch.close()
    return out, dict(ch.state.injected)


@pytest.mark.parametrize("spec", ["io=0.1", "short=0.2",
                                  "corrupt=0.001", "latency=0.02x1",
                                  "io=0.05,short=0.05,corrupt=1e-4"])
@pytest.mark.parametrize("seed", [7, 42])
def test_chaos_channel_replays_jax_faults(blob, spec, seed):
    t = _chaos_run(tch, tfaults, blob, spec, seed)
    j = _chaos_run(jch, jfaults, blob, spec, seed)
    assert t == j
    assert sum(t[1].values()) > 0


def test_chaos_spec_parse_equals_jax():
    for spec in ("", "io=0.1", "latency=0.05x20,short=0.02,corrupt=1e-6",
                 "latency=0.3"):
        assert tfaults.ChaosSpec.parse(spec).__dict__ == \
            jfaults.ChaosSpec.parse(spec).__dict__
    for bad in ("io", "bogus=1", "io=x"):
        with pytest.raises(ValueError):
            tfaults.ChaosSpec.parse(bad)
        with pytest.raises(ValueError):
            jfaults.ChaosSpec.parse(bad)
    with pytest.raises(ValueError, match="seed"):
        tfaults.parse_chaos("x:io=0.1")


def test_install_chaos_wraps_every_opened_channel(blob):
    assert tfaults.installed_chaos() is None
    with tfaults.chaos("3:io=1.0") as state:
        assert tfaults.installed_chaos() is state
        with tch.open_channel(blob) as ch:
            assert isinstance(ch, tfaults.ChaosChannel)
            with pytest.raises(tfaults.ChaosError):
                ch.read_at(0, 10)
            assert bytes(ch.read_at(1, 10))   # the region's fault fired once
        assert state.injected["io"] == 1
    assert tfaults.installed_chaos() is None
    with tch.open_channel(blob) as ch:
        assert isinstance(ch, tch.MMapChannel)


def test_short_read_error_is_retryable():
    assert tfaults.retryable(tfaults.ShortReadError("x"))
    assert tfaults.retryable(tfaults.ChaosError("x"))
    assert not tfaults.retryable(tguard.StructurallyInvalid("x"))


# ------------------------------------------------------------------- limits
@pytest.mark.parametrize("spec", [
    "", "record=32MB", "refs=1000,name=10", "cigar=7,seq=1KB,alloc=1GB",
    "header_text=1MB,max_refs=5", "max-record-bytes=100",
])
def test_decode_limits_parse_equals_jax(spec):
    assert tguard.DecodeLimits.parse(spec).__dict__ == \
        jguard.DecodeLimits.parse(spec).__dict__


@pytest.mark.parametrize("bad", ["record", "nope=1", "record=0",
                                 "refs=-1", "alloc=lots"])
def test_decode_limits_refuse_as_jax(bad):
    with pytest.raises(ValueError):
        tguard.DecodeLimits.parse(bad)
    with pytest.raises(ValueError):
        jguard.DecodeLimits.parse(bad)


def test_limits_env_and_scopes_equal_jax(monkeypatch):
    monkeypatch.setenv("SPARK_BAM_LIMITS", "record=1MB,refs=9")
    assert tguard.current_limits().__dict__ == \
        jguard.current_limits().__dict__
    assert tguard.current_limits().max_refs == 9
    assert TConfig.from_env().limits == JConfig.from_env().limits
    assert TConfig.from_env().decode_limits.max_record_bytes == 1 << 20
    with tguard.scoped_limits("refs=3") as outer:
        assert tguard.current_limits() is outer and outer.max_refs == 3
        with tguard.scoped_limits(tguard.DecodeLimits(max_refs=4)):
            assert tguard.current_limits().max_refs == 4
        assert tguard.current_limits().max_refs == 3
    assert tguard.current_limits().max_refs == 9
    tguard.set_limits("refs=5")
    try:
        assert tguard.current_limits().max_refs == 5
    finally:
        tguard.set_limits(None)
    monkeypatch.delenv("SPARK_BAM_LIMITS")
    assert tguard.current_limits() == tguard.DecodeLimits()


@pytest.mark.parametrize("n,limit", [(-1, None), (5, 4), (4, 4), (0, None)])
def test_check_count_equals_jax(n, limit):
    def outcome(g):
        try:
            return g.check_count(n, "field", limit, pos=3)
        except g.MalformedInputError as e:
            return type(e).__name__, str(e)
    assert outcome(tguard) == outcome(jguard)


def test_check_available_equals_jax():
    for g in (tguard, jguard):
        g.check_available(4, 4, "x")
        with pytest.raises(g.TruncatedInput, match="need 5 bytes, have 4"):
            g.check_available(4, 5, "x")
    assert issubclass(tguard.TruncatedInput, EOFError)


def test_record_decoder_reads_scoped_limits():
    """The record decoder reads ``current_limits()``: a scoped override
    reaches it."""
    from spark_bam_tpu_torch.bam.record import BamRecord

    rec = BamRecord(0, 10, 30, 0, 0, -1, -1, 0, "r", [(4, 0)] * 8, "ACGT" * 8,
                    b"I" * 32, b"")
    blob = rec.encode()
    assert BamRecord.decode(blob)[0] == rec
    with tguard.scoped_limits("cigar=7"):
        with pytest.raises(tguard.LimitExceeded):
            BamRecord.decode(blob)


def test_config_knobs_from_env(monkeypatch):
    monkeypatch.setenv("SPARK_BAM_REMOTE", "depth=4,hedge=off")
    cfg = TConfig.from_env()
    assert cfg.remote == JConfig.from_env().remote == "depth=4,hedge=off"
    assert cfg.remote_config.depth == 4 and cfg.remote_config.hedge == 0.0
    assert "limits" in TConfig.ENV_KNOBS and "remote" in TConfig.ENV_KNOBS
