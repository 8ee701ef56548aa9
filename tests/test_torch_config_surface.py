"""The port's ``Config`` surface against the JAX package's.

Two faults of the port, pinned here: ``Config(checker="eager",
backend="auto")`` (the first example of the reference's API doc) raised
``TypeError``, and ``Config.from_env`` read only the compact-spec knobs,
so ``SPARK_BAM_READS_TO_CHECK=5`` and ``SPARK_BAM_SPLIT_SIZE=2MB`` were
ignored. Now ``from_env``, ``from_dict`` and ``replace`` give the JAX
package's values, field by field, on a table that covers every field
type, ``auto``/``none``, byte strings and unknown keys.
"""

import dataclasses
import os

import pytest

from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu.core.config import default_config as jdefault
from spark_bam_tpu_torch.core.config import Config, default_config

FIELDS = [f.name for f in dataclasses.fields(Config)]


def _same(port: Config, ref: JConfig) -> None:
    for name in FIELDS:
        assert getattr(port, name) == getattr(ref, name), name


def test_the_fields_are_the_references():
    assert {f.name: f.type for f in dataclasses.fields(Config)} == \
        {f.name: f.type for f in dataclasses.fields(JConfig)}
    _same(Config(), JConfig())


def test_the_api_doc_example_constructs():
    cfg = Config(checker="eager", backend="auto")
    assert (cfg.checker, cfg.backend, cfg.warn,
            cfg.post_partition_size) == ("eager", "auto", False, 100_000)
    _same(cfg, JConfig(checker="eager", backend="auto"))


def test_the_issue_environment():
    env = {"SPARK_BAM_READS_TO_CHECK": "5", "SPARK_BAM_SPLIT_SIZE": "2MB"}
    cfg = Config.from_env(env)
    assert cfg.reads_to_check == 5 and cfg.split_size == 2097152
    _same(cfg, JConfig.from_env(env))


ENVS = {
    "empty": {},
    "ints_and_sizes": {"SPARK_BAM_READS_TO_CHECK": "20",
                       "SPARK_BAM_MAX_READ_SIZE": "1MB",
                       "SPARK_BAM_WINDOW_SIZE": "8m",
                       "SPARK_BAM_HALO_SIZE": "65536",
                       "SPARK_BAM_BGZF_BLOCKS_TO_CHECK": "3",
                       "SPARK_BAM_POST_PARTITION_SIZE": "1k"},
    "optional_int": {"SPARK_BAM_SPLIT_SIZE": "32MB",
                     "SPARK_BAM_FLUSH_EVERY": "auto"},
    "optional_int_none": {"SPARK_BAM_SPLIT_SIZE": "none",
                          "SPARK_BAM_FLUSH_EVERY": "4"},
    "float": {"SPARK_BAM_ESTIMATED_COMPRESSION_RATIO": "2.5"},
    "bools": {"SPARK_BAM_WARN": "yes", "SPARK_BAM_RESIDENT_SCAN": "1",
              "SPARK_BAM_DEVICE_INFLATE": "false",
              "SPARK_BAM_FUSED_COUNT": "auto"},
    "optional_bool_none": {"SPARK_BAM_DEVICE_INFLATE": "none",
                           "SPARK_BAM_FUSED_COUNT": "TRUE"},
    "strings": {"SPARK_BAM_CHECKER": "seqdoop", "SPARK_BAM_BACKEND": "numpy",
                "SPARK_BAM_FUNNEL": "off"},
    "spec_knobs": {"SPARK_BAM_CACHE": "readwrite,strict",
                   "SPARK_BAM_COLUMNAR": "rows=5,codec=zlib",
                   "SPARK_BAM_DEFLATE": "mode=fixed,lanes=128",
                   "SPARK_BAM_FAULTS": "retries=3,deadline=60",
                   "SPARK_BAM_SERVE": "batch=16,tick=2",
                   "SPARK_BAM_FABRIC": "workers=3",
                   "SPARK_BAM_JOBS": "checkpoint=5000",
                   "SPARK_BAM_DISK_CHAOS": "9:enospc=0.05",
                   "SPARK_BAM_INFLATE": "host",
                   "SPARK_BAM_LIMITS": "record=32MB",
                   "SPARK_BAM_REMOTE": "depth=4,hedge=off",
                   "SPARK_BAM_SLO": "serve.latency:p99<1500ms@5m",
                   "SPARK_BAM_AGG": "count;mapq"},
    "not_knobs": {"SPARK_BAM_CACHE_DIR": "/x", "SPARK_BAM_CACHE_BUDGET": "1GB",
                  "SPARK_BAM_GS_TOKEN": "t", "SPARK_BAM_S3_ENDPOINT": "e",
                  "SPARK_BAM_PROFILE": "/p", "SPARK_BAM_PROFILE_DIR": "/q",
                  "SPARK_BAM_METRICS_OUT": "/m", "SPARK_BAM_FLIGHT_DIR": "/f",
                  "SPARK_BAM_READS_TO_CHECK": "7", "OTHER": "1"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_from_env_equals_jax(name):
    env = ENVS[name]
    _same(Config.from_env(env), JConfig.from_env(env))


def test_from_env_over_a_base_equals_jax():
    env = {"SPARK_BAM_HALO_SIZE": "1MB"}
    got = Config.from_env(env, base=Config(reads_to_check=3))
    _same(got, JConfig.from_env(env, base=JConfig(reads_to_check=3)))
    assert Config.from_env({}, base=Config(halo_size=5)).halo_size == 5


def test_an_unknown_env_knob_raises_as_jax():
    env = {"SPARK_BAM_NOT_A_KNOB": "1"}
    with pytest.raises(KeyError, match="Unknown config key: not_a_knob"):
        JConfig.from_env(env)
    with pytest.raises(KeyError, match="Unknown config key: not_a_knob"):
        Config.from_env(env)


def test_serve_ring_directory_is_not_a_knob():
    """``SPARK_BAM_SHM_DIR`` (serve's ring directory, read by
    ``serve/shm.py`` in both packages) is skipped by the port's
    ``from_env``; the JAX package's raises ``KeyError`` on it, so a daemon
    started with it could not read its config (a divergence kept on
    purpose)."""
    env = {"SPARK_BAM_SHM_DIR": "/dev/shm/x", "SPARK_BAM_REMOTE": "depth=2"}
    with pytest.raises(KeyError):
        JConfig.from_env(env)
    assert Config.from_env(env) == Config(remote="depth=2")


DICTS = {
    "spark_keys": {"spark.bam.reads_to_check": 4,
                   "spark.bam.split.size": "64KB",
                   "spark.bam.max-read-size": "2MB"},
    "bare_keys": {"reads_to_check": "6", "estimated_compression_ratio": 4,
                  "warn": True, "resident_scan": "no"},
    "native_values": {"window_size": 1 << 20, "split_size": 1 << 21,
                      "device_inflate": None, "fused_count": False,
                      "flush_every": None},
    "auto_strings": {"split_size": "", "flush_every": "AUTO",
                     "device_inflate": "auto"},
    "checker_surface": {"spark.bam.checker": "full",
                        "spark.bam.backend": "tpu"},
}


@pytest.mark.parametrize("name", sorted(DICTS))
def test_from_dict_equals_jax(name):
    d = DICTS[name]
    _same(Config.from_dict(d), JConfig.from_dict(d))
    base, jbase = Config(halo_size=1 << 16), JConfig(halo_size=1 << 16)
    _same(Config.from_dict(d, base=base), JConfig.from_dict(d, base=jbase))


def test_an_unknown_dict_key_raises_as_jax():
    for d in ({"spark.bam.nope": 1}, {"reads.to.checkk": 1}):
        with pytest.raises(KeyError) as j:
            JConfig.from_dict(d)
        with pytest.raises(KeyError) as p:
            Config.from_dict(d)
        assert str(p.value) == str(j.value)


def test_replace_equals_jax():
    for kw in ({"split_size": "2MB"}, {"split_size": 4096},
               {"split_size": None, "reads_to_check": 2},
               {"checker": "indexed", "warn": True}):
        _same(Config().replace(**kw), JConfig().replace(**kw))
    assert Config().replace(split_size="1KB").split_size == 1024


def test_default_config_reads_the_environment(monkeypatch):
    for key in list(os.environ):
        if key.startswith("SPARK_BAM_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("SPARK_BAM_READS_TO_CHECK", "12")
    monkeypatch.setenv("SPARK_BAM_SPLIT_SIZE", "1MB")
    _same(default_config(), jdefault())
    assert default_config().split_size == 1 << 20


@pytest.mark.parametrize("knob,value", [("checker", "nope"),
                                        ("backend", "gpu")])
def test_a_bad_checker_or_backend_is_refused(knob, value):
    """An unknown engine would silently take another path (the reference
    treats any unknown backend as the host's); the port refuses it."""
    with pytest.raises(ValueError, match=f"Bad {knob}"):
        Config(**{knob: value})


def test_backend_selects_the_host_or_the_device_verdict(tmp_path,
                                                      monkeypatch):
    """``Config.backend`` is read where the reference reads it: the check
    commands' eager verdict. numpy, python and native take the host pass
    ``check_flat``, the others the device's ``TpuChecker`` (here its plain
    version); both give the same verdicts."""
    import numpy as np

    from spark_bam_tpu_torch import cli_app
    from spark_bam_tpu_torch.benchmarks.synth import synth_bam

    path = tmp_path / "s.bam"
    synth_bam(path, 300 << 10, seed=4, unit_reads=256)
    host_calls = []
    real = cli_app.check_flat
    monkeypatch.setattr(cli_app, "check_flat",
                        lambda *a, **k: host_calls.append(1) or real(*a, **k))
    results = {}
    for backend in ("numpy", "python", "native", "auto", "tpu", "pallas"):
        before = len(host_calls)
        ctx = cli_app.CheckerContext(str(path), Config(backend=backend),
                                     device="cpu")
        results[backend] = ctx.eager_result.verdict
        took_host = len(host_calls) > before
        assert took_host == Config(backend=backend).host_backend, backend
    for backend, verdict in results.items():
        assert np.array_equal(verdict, results["auto"]), backend
