"""The port's configuration, BGZF/BAM layers and synthetic BAM writer
against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.header import read_header as jax_read_header
from spark_bam_tpu.bgzf.flat import flatten_file
from spark_bam_tpu.bgzf.flat import stage_run_payloads as jax_stage
from spark_bam_tpu.bgzf.index_blocks import blocks_metadata as jax_blocks
from spark_bam_tpu.core.channel import open_channel as jax_open
from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.tpu.inflate import window_plan as jax_window_plan
from spark_bam_tpu.tpu.stream_check import count_reads_streaming
from spark_bam_tpu_torch import compat
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf.flat import inflate_blocks, stage_run_payloads
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config, InflateConfig
from spark_bam_tpu_torch.tpu.inflate import window_plan
from tests.bam_factories import random_bam


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_cfg") / "b.bam"
    random_bam(p, seed=71)
    return p


def test_defaults_match_reference():
    ref = JaxConfig()
    cfg = Config()
    for f in dataclasses.fields(Config):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("kw", [
    dict(), dict(reads_to_check=5, window_size=1 << 20, halo_size=1 << 18),
    dict(flush_every=3, ring_depth=1, fused_count=False),
    dict(inflate="tokenize=device,donate=on", funnel="on"),
    dict(funnel="off"),
])
def test_from_reference(kw):
    ref = JaxConfig(**kw)
    cfg, lens = compat.from_reference(dataclasses.asdict(ref), [10, 20, 30])
    for f in dataclasses.fields(Config):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert lens.dtype == torch.int32 and lens.shape == (1024,)
    assert lens[:4].tolist() == [10, 20, 30, 0]
    for w in (1 << 16, 32 << 20, 1 << 30):
        assert cfg.flush_every_for(w) == ref.flush_every_for(w)


@pytest.mark.parametrize("kw,needle", [
    (dict(funnel="OFF"), "Bad funnel mode"),
    (dict(funnel="maybe"), "Bad funnel mode"),
    (dict(inflate="kernel=pallas"), "one device tokenizer"),
    (dict(inflate="donate=off"), "always resolves LZ77 in place"),
    (dict(inflate="bogus=1"), "Unknown inflate key"),
])
def test_unserved_values_raise(kw, needle):
    with pytest.raises(ValueError, match=needle):
        Config(**kw)


def test_tokenize_host_parses_and_routes_to_the_host_tokenizer():
    """``inflate="tokenize=host"`` is served: it parses as the reference's
    spec does, and the streaming count's producer is the host tokenizer
    (``tokenize_group`` into packed planes), not the raw staging."""
    from spark_bam_tpu.core.inflate_config import InflateConfig as JInflate
    from spark_bam_tpu_torch.tpu import stream_check

    cfg = Config(inflate="tokenize=host")
    assert cfg.inflate_config.tokenize == JInflate.parse(
        "tokenize=host").tokenize == "host"
    assert cfg.inflate_config.resolve_tokenize() == "host"
    assert Config().inflate_config.resolve_tokenize() == "device"
    sc = object.__new__(stream_check.StreamChecker)
    sc.config, sc.device = cfg, torch.device("cpu")
    sc.pipeline = stream_check.InflatePipeline.__new__(
        stream_check.InflatePipeline)
    produce, refusals = sc._producer(ch=None)
    assert stream_check.TokenizeError in refusals
    assert "tokenize_group" in produce.__code__.co_names


@pytest.mark.parametrize("mode", ["on", "off", "auto"])
@pytest.mark.parametrize("full_masks", [False, True])
def test_funnel_enabled_matches_reference(mode, full_masks):
    """``funnel="off"`` parses now that the full pass exists, and the
    funnel's truth table is the reference's."""
    assert Config(funnel=mode).funnel_enabled(full_masks) == \
        JaxConfig(funnel=mode).funnel_enabled(full_masks)


def test_inflate_config_parse():
    cfg = InflateConfig.parse("")
    assert (cfg.tokenize, cfg.kernel, cfg.donate) == ("auto", "auto", "on")
    assert InflateConfig.parse("device").tokenize == "device"
    assert InflateConfig.parse("tokenize=auto,donate=on").donate == "on"


def test_blocks_header_and_staging_match_reference(bam):
    metas = blocks_metadata(bam)
    ref = list(jax_blocks(bam))
    assert [(m.start, m.compressed_size, m.uncompressed_size) for m in metas] \
        == [(m.start, m.compressed_size, m.uncompressed_size) for m in ref]
    hdr, jhdr = read_header(bam), jax_read_header(bam)
    assert hdr.contig_lengths.tolist() == jhdr.contig_lengths.lengths_list()
    assert hdr.uncompressed_size == jhdr.uncompressed_size
    assert [len(g) for g in window_plan(metas, 64 << 10)] == \
        [len(g) for g in jax_window_plan(ref, 64 << 10)]
    with open_channel(bam) as ch, jax_open(bam) as jch:
        staged, clens = stage_run_payloads(ch, metas[:5])
        jstaged, jclens = jax_stage(jch, ref[:5])
        np.testing.assert_array_equal(staged, jstaged)
        np.testing.assert_array_equal(clens, jclens)
        flat = inflate_blocks(ch, metas, threads=4)
    np.testing.assert_array_equal(flat.data, flatten_file(bam).data)


def test_synth_long_reads_count_is_exact(tmp_path):
    """``read_len``: 60-110 kb reads, counted exactly by the JAX package."""
    p = tmp_path / "long.bam"
    m = synth_bam(p, 1 << 20, seed=2, unit_reads=4,
                  read_len=(60_000, 110_000))
    assert m["read_len"] == [60_000, 110_000] and m["reps"] >= 2
    assert count_reads_streaming(p, JaxConfig(), use_device=False) == m["reads"]


def test_block_table_matches_reference(bam):
    from spark_bam_tpu.bgzf.flat import metas_block_table as jax_table
    from spark_bam_tpu.bgzf.flat import pos_of_flat_tables as jax_pos
    from spark_bam_tpu_torch.bgzf.flat import (
        metas_block_table,
        pos_of_flat_tables,
    )

    starts, flat = metas_block_table(blocks_metadata(bam))
    jstarts, jflat = jax_table(list(jax_blocks(bam)))
    np.testing.assert_array_equal(starts, jstarts)
    np.testing.assert_array_equal(flat, jflat)
    for i in (0, 1, int(flat[1]) - 1, int(flat[1]), int(flat[-1]) + 7):
        assert pos_of_flat_tables(starts, flat, i) == jax_pos(jstarts, jflat, i)


def test_synth_bam_count_is_exact(tmp_path):
    """The port's writer: the JAX package reads the file and counts exactly
    the generator's reads."""
    p = tmp_path / "synth.bam"
    m = synth_bam(p, 700 << 10, seed=3, unit_reads=1000)
    assert m["reps"] >= 2
    assert count_reads_streaming(p, JaxConfig(), use_device=False) == m["reads"]
    hdr = read_header(p)
    assert hdr.contig_names == ("chr1", "chr2")
    assert hdr.contig_lengths.tolist() == [248_956_422, 242_193_529]
    assert sum(b.uncompressed_size for b in blocks_metadata(p)) == \
        m["uncompressed_bytes"]
