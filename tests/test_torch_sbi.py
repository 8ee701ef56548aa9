"""The port's ``.sbi`` split-index cache (``spark_bam_tpu_torch/sbi/``)
against the JAX package's: the same bytes for the same index, each side
decoding the other's sidecars, the same damage rejected, and the store's
events and status lines equal on both sides, scenario by scenario, in
temporary directories."""

import errno
import os
import shutil
import struct
import types
import zlib

import numpy as np
import pytest

import spark_bam_tpu.sbi.format as jfmt
import spark_bam_tpu.sbi.store as jstore
import spark_bam_tpu_torch.sbi.format as tfmt
import spark_bam_tpu_torch.sbi.store as tstore
from spark_bam_tpu.bgzf.block import Metadata as JMetadata
from spark_bam_tpu.bgzf.flat import flatten_file as jax_flatten
from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu.core.pos import Pos as JPos
from spark_bam_tpu_torch.benchmarks.fakestore import FakeObjectStore
from spark_bam_tpu_torch.bgzf.block import Metadata as TMetadata
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.core.config import Config as TConfig
from spark_bam_tpu_torch.core.pos import Pos as TPos
from tests.bam_factories import random_bam

JAX = types.SimpleNamespace(fmt=jfmt, store=jstore, Metadata=JMetadata,
                            Pos=JPos, Config=JConfig)
PORT = types.SimpleNamespace(fmt=tfmt, store=tstore, Metadata=TMetadata,
                             Pos=TPos, Config=TConfig)


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_sbi") / "t.bam"
    random_bam(p, seed=21)
    return str(p)


# ----------------------------------------------------------------- format

def _index(side, blocks=True, plans=True, starts="some"):
    f = side.fmt
    idx = f.SbiIndex(f.Fingerprint(1000, 2000, 3000,
                                   f.config_digest(side.Config())))
    if blocks:
        idx.blocks = [side.Metadata(0, 50, 120), side.Metadata(50, 60, 80)]
    if plans:
        idx.split_plans = {
            2 << 20: [
                f.PlanEntry(0, f.PLAN_POS, side.Pos(0, 104)),
                f.PlanEntry(100, f.PLAN_NONE, None),
                f.PlanEntry(200, f.PLAN_UNRESOLVED, None),
            ],
            16384: [f.PlanEntry(0, f.PLAN_POS, side.Pos(7, 3))],
        }
    if starts == "some":
        idx.record_starts = np.array([104, 9999, (7 << 16) | 3],
                                     dtype=np.uint64)
    elif starts == "empty":
        idx.record_starts = np.empty(0, dtype=np.uint64)
    return idx


INDEXES = {
    "all": {}, "no_blocks": dict(blocks=False), "no_plans": dict(plans=False),
    "no_starts": dict(starts=None), "empty_starts": dict(starts="empty"),
    "fingerprint_only": dict(blocks=False, plans=False, starts=None),
}


def _view(idx):
    """An index as plain values, comparable across the packages."""
    return (
        tuple(idx.fingerprint.__dict__.values()),
        None if idx.blocks is None else [
            (m.start, m.compressed_size, m.uncompressed_size)
            for m in idx.blocks],
        {k: [(e.file_start, e.kind, None if e.pos is None else tuple(e.pos))
             for e in v] for k, v in idx.split_plans.items()},
        None if idx.record_starts is None else idx.record_starts.tolist(),
    )


@pytest.mark.parametrize("kw", INDEXES.values(), ids=INDEXES.keys())
def test_encode_equals_jax_and_cross_decodes(kw):
    jblob = jfmt.encode_sbi(_index(JAX, **kw))
    tblob = tfmt.encode_sbi(_index(PORT, **kw))
    assert tblob == jblob
    assert _view(tfmt.decode_sbi(jblob)) == _view(jfmt.decode_sbi(tblob)) \
        == _view(_index(PORT, **kw))


def _inner_count(blob: bytes) -> bytes:
    """The blocks section's u64 count set huge, the trailer CRC refreshed."""
    b = bytearray(blob)
    struct.pack_into("<Q", b, 4 + 2 + 2 + 24 + 4 + 4 + 8, 1 << 40)
    body = bytes(b[:-4])
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


DAMAGE = {
    "truncated": lambda b: b[: len(b) // 2],
    "missing_trailer_byte": lambda b: b[:-1],
    "bad_magic": lambda b: bytes([b[0] ^ 0xFF]) + b[1:],
    "bit_flip": lambda b: b[:30] + bytes([b[30] ^ 0x01]) + b[31:],
    "stale_trailer": lambda b: b[:10] + bytes([b[10] ^ 0xFF]) + b[11:],
    "inner_count": _inner_count,
    "short": lambda b: b[:20],
}


@pytest.mark.parametrize("mutate", DAMAGE.values(), ids=DAMAGE.keys())
def test_damage_rejected_on_both_sides(mutate):
    blob = mutate(tfmt.encode_sbi(_index(PORT)))
    with pytest.raises(jfmt.SbiFormatError):
        jfmt.decode_sbi(blob)
    with pytest.raises(tfmt.SbiFormatError):
        tfmt.decode_sbi(blob)
    assert issubclass(tfmt.SbiFormatError, ValueError)


@pytest.mark.parametrize("kw", [
    {}, dict(reads_to_check=11), dict(bgzf_blocks_to_check=6),
    dict(max_read_size=1), dict(split_size=1 << 20, cache="read")])
def test_config_digest_equals_jax(kw):
    assert tfmt.config_digest(TConfig(**kw)) == \
        jfmt.config_digest(JConfig(**kw))


@pytest.mark.parametrize("spec", ["", "off", "read", "write", "readwrite",
                                  "readwrite,strict", "strict,read",
                                  "sideways"])
def test_cache_mode_parse_equals_jax(spec):
    try:
        want = jstore.CacheMode.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            tstore.CacheMode.parse(spec)
        return
    got = tstore.CacheMode.parse(spec)
    assert (got.read, got.write, got.strict, got.enabled) == \
        (want.read, want.write, want.strict, want.enabled)
    assert TConfig(cache=spec).cache_mode == got


def test_env_cache_spec(monkeypatch):
    monkeypatch.setenv("SPARK_BAM_CACHE", "read")
    monkeypatch.setenv("SPARK_BAM_CACHE_DIR", "/nonexistent/cache")
    assert TConfig.from_env().cache == JConfig.from_env().cache == "read"
    monkeypatch.delenv("SPARK_BAM_CACHE")
    assert TConfig.from_env() == TConfig()


def test_fingerprint_and_virtual_offsets_equal_jax(bam):
    assert tfmt.fingerprint_of(bam, TConfig()).__dict__ == \
        jfmt.fingerprint_of(bam, JConfig()).__dict__
    view, jview = flatten_file(bam), jax_flatten(bam)
    flat = np.unique(np.random.default_rng(0).integers(0, view.size, 500))
    virt = tfmt.record_starts_to_virtual(view, flat)
    np.testing.assert_array_equal(
        virt, jfmt.record_starts_to_virtual(jview, flat))
    np.testing.assert_array_equal(tfmt.record_starts_to_flat(view, virt),
                                  flat)
    with pytest.raises(tfmt.SbiFormatError):
        tfmt.record_starts_to_flat(view, np.array([7 << 16], np.uint64))
    # A URL's fingerprint (mtime 0, one ranged GET) equals the JAX
    # package's over the same store.
    with open(bam, "rb") as f:
        data = f.read()
    with FakeObjectStore(data, key="t.bam") as store:
        url = f"{store.url_base}/bucket/t.bam"
        got = tfmt.fingerprint_of(url, TConfig())
        assert got.__dict__ == jfmt.fingerprint_of(url, JConfig()).__dict__
        assert got.mtime_ns == 0 and got.size == len(data)


# ------------------------------------------------------------------ store

def _sample(side, bam, cfg, **kw):
    idx = _index(side, **kw)
    idx.fingerprint = side.fmt.fingerprint_of(bam, cfg)
    return idx


def _scenario_miss_write_hit(side, bam, d):
    cfg = side.Config(cache="readwrite")
    store = side.store.CacheStore()
    out = [store.load(bam, cfg) is None]
    out.append(store.store(bam, _sample(side, bam, cfg)) == bam + ".sbi")
    out.append(_view(store.load(bam, cfg)) == _view(_sample(side, bam, cfg)))
    out.append(store.probe(bam, cfg))
    return out


def _scenario_stale_mtime(side, bam, d):
    cfg = side.Config(cache="readwrite")
    store = side.store.CacheStore()
    store.store(bam, _sample(side, bam, cfg))
    st = os.stat(bam)
    os.utime(bam, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    return [store.probe(bam, cfg), store.load(bam, cfg) is None]


def _scenario_stale_config(side, bam, d):
    store = side.store.CacheStore()
    cfg = side.Config(cache="readwrite")
    store.store(bam, _sample(side, bam, cfg))
    other = side.Config(cache="readwrite", reads_to_check=7)
    return [store.probe(bam, other), store.load(bam, other) is None,
            store.load(bam, cfg) is not None]


def _scenario_corrupt(side, bam, d):
    cfg = side.Config(cache="readwrite")
    store = side.store.CacheStore()
    store.store(bam, _sample(side, bam, cfg))
    with open(bam + ".sbi", "r+b") as f:
        f.seek(12)
        f.write(b"\xff\xff")
    return [store.probe(bam, cfg), store.load(bam, cfg) is None]


def _scenario_strict(side, bam, d):
    cfg = side.Config(cache="readwrite,strict")
    store = side.store.CacheStore()
    store.store(bam, _sample(side, bam, side.Config()))
    try:
        store.load(bam, side.Config(reads_to_check=3), strict=True)
    except side.store.StaleCacheError as e:
        return ["raised", str(e).replace(d, "D"), cfg.cache_mode.strict]
    return ["no raise"]


def _scenario_merge(side, bam, d):
    cfg = side.Config(cache="readwrite")
    store = side.store.CacheStore()
    store.store(bam, _sample(side, bam, cfg, plans=False, starts=None))
    store.merge_and_store(bam, cfg, _sample(side, bam, cfg, blocks=False))
    idx = store.load(bam, cfg)
    return [_view(idx), store.probe(bam, cfg)]


def _scenario_paths(side, bam, d):
    shared = side.store.CacheStore(cache_dir=os.path.join(d, "shared"))
    cfg = side.Config()
    path = shared.store(bam, _sample(side, bam, cfg))
    return [os.path.relpath(path, d),
            side.store.CacheStore().sidecar_path(bam) == bam + ".sbi",
            os.path.exists(path), shared.load(bam, cfg) is not None]


def _scenario_evict(side, bam, d):
    cache = os.path.join(d, "lru")
    cfg = side.Config()
    store = side.store.CacheStore(cache_dir=cache, budget_bytes=600)
    kept = []
    for i in range(4):
        other = os.path.join(d, f"copy{i}.bam")
        with open(bam, "rb") as src, open(other, "wb") as dst:
            dst.write(src.read())
        os.utime(other, ns=(10**18, 10**18 + i))
        path = store.store(other, _sample(side, other, cfg))
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, 10**18 + i))
        kept.append(sorted(os.listdir(cache)))
    return [kept, os.path.exists(path)]


def _scenario_degrade(side, bam, d):
    """A full disk latches write-through off until it is re-armed."""
    cfg = side.Config(cache="readwrite")
    store = side.store.CacheStore()
    real = os.replace

    def full(src, dst):
        raise OSError(errno.ENOSPC, "No space left on device")

    os.replace = full
    try:
        out = [store.store(bam, _sample(side, bam, cfg))]
    finally:
        os.replace = real
    out.append(store.store(bam, _sample(side, bam, cfg)))
    side.store.reset_cache_write_degrade()
    out.append(store.store(bam, _sample(side, bam, cfg)) == bam + ".sbi")
    return out + [sorted(os.listdir(d))]


SCENARIOS = {
    "miss_write_hit": _scenario_miss_write_hit,
    "stale_mtime": _scenario_stale_mtime,
    "stale_config": _scenario_stale_config,
    "corrupt": _scenario_corrupt,
    "strict": _scenario_strict,
    "merge": _scenario_merge,
    "paths": _scenario_paths,
    "evict": _scenario_evict,
    "degrade": _scenario_degrade,
}


def _run(side, scenario, tmp_path, bam):
    """One scenario in a fresh ``tmp_path/w`` (the same absolute paths on
    both sides, so shared-dir digests agree)."""
    d = str(tmp_path / "w")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    p = os.path.join(d, "t.bam")
    with open(bam, "rb") as src, open(p, "wb") as dst:
        dst.write(src.read())
    os.utime(p, ns=(10**18, 10**18))
    side.store.reset_cache_events()
    out = SCENARIOS[scenario](side, p, d)
    events = [(e.state, e.reason.replace(d, "D"), e.path.replace(d, "D"))
              for e in side.store.cache_events()]
    line = side.store.cache_status_line(p, side.Config(cache="read"))
    side.store.reset_cache_events()
    return repr(out).replace(d, "D"), events, line.replace(d, "D")


#: A state each scenario's events must show.
EXPECT = {"miss_write_hit": "hit", "stale_mtime": "invalidated",
          "stale_config": "invalidated", "corrupt": "invalidated",
          "strict": "invalidated", "merge": "written", "paths": "written",
          "evict": "evicted", "degrade": "skipped"}


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_store_scenario_equals_jax(scenario, tmp_path, bam):
    got = _run(PORT, scenario, tmp_path, bam)
    want = _run(JAX, scenario, tmp_path, bam)
    assert got == want
    assert EXPECT[scenario] in [state for state, _, _ in got[1]], got


def test_status_line_off_and_probe(bam, tmp_path):
    for side in (JAX, PORT):
        side.store.reset_cache_events()
    assert tstore.cache_status_line(bam, TConfig()) == \
        jstore.cache_status_line(bam, JConfig())
    assert tstore.cache_status_line(bam, TConfig(cache="read")) == \
        jstore.cache_status_line(bam, JConfig(cache="read"))
    assert "no sidecar at" in tstore.cache_status_line(
        bam, TConfig(cache="read"))
