"""The names the port's public surface gained, against the JAX package's:
``Block``/``Header`` and ``BlockStream`` iteration (hostile bytes raise the
reference's classes), ``ContigLengths`` and ``contig_lengths``, ``Counts``
and ``flags_fields``, ``parse_pos``, the locality provider, the shared
cache store, ``stream_verdicts`` and ``count_reads_streaming`` (on the
CPU), and ``utils``' timer, heartbeat and profiler hook.
"""

import logging

import numpy as np
import pytest

from spark_bam_tpu.bam.header import contig_lengths as jax_contig_lengths
from spark_bam_tpu.bgzf.block import Block as JBlock
from spark_bam_tpu.bgzf.header import Header as JHeader
from spark_bam_tpu.bgzf.stream import BlockStream as JBlockStream
from spark_bam_tpu.bgzf.stream import SeekableBlockStream as JSeekable
from spark_bam_tpu.check import flags as jflags
from spark_bam_tpu.core.channel import open_channel as jopen
from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu.core.pos import parse_pos as jparse_pos
from spark_bam_tpu.load import splits as jsplits
from spark_bam_tpu.tpu.stream_check import count_reads_streaming as jcount
from spark_bam_tpu.tpu.stream_check import stream_verdicts as jverdicts
from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.bam.header import ContigLengths, contig_lengths
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bgzf import (
    Block,
    BlockStream,
    Header,
    HeaderParseException,
    SeekableBlockStream,
)
from spark_bam_tpu_torch.check.flags import Counts, Flags, flags_fields
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.guard import MalformedInputError
from spark_bam_tpu_torch.core.pos import Pos, parse_pos
from spark_bam_tpu_torch.load import splits
from spark_bam_tpu_torch.sbi import store
from spark_bam_tpu_torch.tpu.stream_check import (
    count_reads_streaming,
    stream_verdicts,
)
from spark_bam_tpu_torch.utils import Timer, heartbeat, profile_trace
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("surface") / "r.bam"
    random_bam(p, seed=33, read_len=(10, 500), n_records=(300, 400))
    return str(p)


def _as_tuple(b):
    return (bytes(b.data), b.start, b.compressed_size, b.idx,
            b.uncompressed_size, tuple(b.pos), b.next_start,
            tuple(b.metadata().__dict__.values()))


@pytest.mark.parametrize("seekable", [False, True])
def test_block_stream_iteration_equals_jax(bam, seekable):
    cls, jcls = ((SeekableBlockStream, JSeekable) if seekable
                 else (BlockStream, JBlockStream))
    with open_channel(bam) as ch, jopen(bam) as jch:
        got = [_as_tuple(b) for b in cls(ch)]
        want = [_as_tuple(b) for b in jcls(jch)]
    assert got == want and len(got) >= 3
    with open_channel(bam) as ch:
        blocks = list(BlockStream(ch))
    assert all(isinstance(b, Block) for b in blocks)
    assert blocks[1].start == blocks[0].next_start


def test_block_stream_keeps_next_block(bam):
    with open_channel(bam) as ch:
        s = BlockStream(ch)
        data, start = s.next_block()
        nxt = next(s)
    assert start == 0 and nxt.start > 0 and len(data) > 0


def test_block_values_equal_jax():
    b, j = Block(b"abc", 10, 40, idx=2), JBlock(b"abc", 10, 40, idx=2)
    assert _as_tuple(b) == _as_tuple(j)
    assert b == Block(b"abc", 10, 40)   # the cursor is not compared


def _header_outcome(cls, buf):
    try:
        h = cls.parse(buf)
        return ("ok", h.size, h.compressed_size)
    except (MalformedInputError, EOFError) as e:
        return ("raised", type(e).__name__, str(e))
    except Exception as e:  # noqa: BLE001 - the JAX package's classes
        return ("raised", type(e).__name__, str(e))


def test_header_parse_equals_jax_on_hostile_bytes(bam):
    with open(bam, "rb") as f:
        good = f.read(18)
    rng = np.random.default_rng(4)
    cases = [good, good[:17], b""]
    for i in range(200):
        buf = bytearray(good)
        for j in rng.integers(0, 18, 1 + i % 3):
            buf[j] = int(rng.integers(0, 256))
        cases.append(bytes(buf))
    kinds = set()
    for buf in cases:
        got, want = _header_outcome(Header, buf), _header_outcome(JHeader, buf)
        assert got == want, buf.hex()
        kinds.add(got[1] if got[0] == "raised" else "ok")
    assert {"ok", "HeaderParseException", "StructurallyInvalid",
            "EOFError"} <= kinds
    with pytest.raises(HeaderParseException):
        Header.parse(b"\x1f\x8b\x08\x00" + good[4:])


def test_header_read_consumes_the_header(bam):
    with open_channel(bam) as ch, jopen(bam) as jch:
        h, jh = Header.read(ch), JHeader.read(jch)
        assert (h.size, h.compressed_size) == (jh.size, jh.compressed_size)
        assert ch.position() == jch.position() == h.size


def test_contig_lengths_equal_jax(bam):
    got, want = contig_lengths(bam), jax_contig_lengths(bam)
    assert dict(got) == dict(want) and repr(got) == repr(want)
    assert got.lengths_list() == want.lengths_list()
    assert got.name(-1) == "*" and got.name(1) == want.name(1)
    header = read_header(bam)
    assert ContigLengths.of(header) == got
    assert got == ContigLengths(enumerate(zip(
        header.contig_names, header.contig_lengths.tolist())))


def test_counts_and_flags_fields_equal_jax():
    assert flags_fields() == jflags.flags_fields()
    rng = np.random.default_rng(2)
    got, want = Counts(), jflags.Counts()
    for mask in rng.integers(0, 1 << 19, 50):
        got.add(Flags.from_mask(int(mask), 1))
        want.add(jflags.Flags.from_mask(int(mask), 1))
    hist = {int(m): int(c) for m, c in zip(rng.integers(0, 1 << 19, 20),
                                          rng.integers(1, 9, 20))}
    got.add_mask_counts(hist)
    want.add_mask_counts(hist)
    assert dict(got) == dict(want) and got.show() == want.show()
    assert dict(got.merge(got)) == dict(want.merge(want))
    for mask in (0, 5, (1 << 19) - 1):
        assert Flags.from_mask(mask, 2).num_checks_failed() == \
            jflags.Flags.from_mask(mask, 2).num_checks_failed()


@pytest.mark.parametrize("text", ["123:45", "77", "0:0", "9:65535"])
def test_parse_pos_equals_jax(text):
    assert parse_pos(text) == tuple(jparse_pos(text))
    assert isinstance(parse_pos(text), Pos)


def test_locality_provider_equals_jax():
    calls = []

    def provider(path, start, end):
        calls.append((path, start, end))
        return (f"h{start % 3}", "h9")

    fs = splits.FileSplit("x.bam", 5, 10)
    jfs = jsplits.FileSplit("x.bam", 5, 10)
    assert splits.preferred_hosts(fs) == jsplits.preferred_hosts(jfs) == []
    splits.set_locality_provider(provider)
    jsplits.set_locality_provider(provider)
    try:
        assert splits.preferred_hosts(fs) == jsplits.preferred_hosts(jfs) \
            == ["h2", "h9"]
    finally:
        splits.set_locality_provider(None)
        jsplits.set_locality_provider(None)
    assert calls == [("x.bam", 5, 10)] * 2
    assert splits.preferred_hosts(fs) == []


def test_shared_store_is_one_until_reset(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_BAM_CACHE_DIR", str(tmp_path / "a"))
    store.reset_shared_store()
    try:
        first = store.shared_store()
        assert store.shared_store() is first
        assert str(first.cache_dir) == str(tmp_path / "a")
        monkeypatch.setenv("SPARK_BAM_CACHE_DIR", str(tmp_path / "b"))
        assert store.shared_store() is first
        store.reset_shared_store()
        assert str(store.shared_store().cache_dir) == str(tmp_path / "b")
    finally:
        store.reset_shared_store()


WINDOW, HALO = 48 << 10, 16 << 10


def test_stream_wrappers_equal_jax_on_the_cpu(bam):
    cfg, jcfg = Config(), JConfig(device_inflate=False)
    got = list(stream_verdicts(bam, cfg, WINDOW, HALO, device="cpu"))
    want = list(jverdicts(bam, jcfg, WINDOW, HALO, use_device=False))
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, v), (_, jv) in zip(got, want):
        assert np.array_equal(np.asarray(v), np.asarray(jv))
    n = count_reads_streaming(bam, cfg, WINDOW, HALO, device="cpu")
    assert n == jcount(bam, jcfg, WINDOW, HALO, use_device=False)
    assert n == sum(int(np.asarray(v).sum()) for _, v in got) > 300


def test_timer_and_heartbeat_feed_the_registry(caplog):
    reg = obs.configure()
    try:
        echoed = []
        with Timer("stage", echo=echoed.append) as t:
            pass
        assert t.seconds >= 0 and t.ms == t.seconds * 1e3
        assert echoed and echoed[0].startswith("stage: ")
        with Timer() as quiet:
            pass
        assert quiet.seconds >= 0
        with caplog.at_level(logging.INFO), heartbeat("w", 0.0) as beat:
            beat("step 1")
            beat("step 2")
        snap = reg.snapshot()
        text = str(snap)
        assert "timer.stage" in text and "progress.beats" in text
        assert "w: step 2" in caplog.text
    finally:
        obs.shutdown()


def test_profile_trace_is_inert_without_its_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("SPARK_BAM_PROFILE_DIR", raising=False)
    with profile_trace("x"):
        pass
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("SPARK_BAM_PROFILE_DIR", str(tmp_path))
    import torch

    with profile_trace("run"):
        torch.ones(4).sum()
    traces = list((tmp_path / "run").glob("trace-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
