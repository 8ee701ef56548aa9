"""The ``tokenize=host`` route of the port against the JAX package's, on
the CPU, exactly.

``inflate tokenize=host`` puts the DEFLATE entropy phase on the host (the
C++ tokenizer) and ships packed token planes to the device, where
``lz77_resolve`` runs. The JAX package takes that route on the CPU only
when its config sets ``device_inflate=True`` (its ``auto`` resolves to
host zlib off the TPU). Held equal here: ``count_window_tokens`` against
the JAX program field for field, window after window with each side's
carry; ``count_reads`` (the fused loop), ``full_check_summary_streaming``,
the load's batches, ``inflate_file_device`` and the sharded count against
the JAX package's under ``tokenize=host`` and against the port's device
route; a block the tokenizer refuses demotes its work to host zlib,
counted, with exact results, and a payload no decoder accepts demotes and
then raises, as the JAX package's count does; ``--inflate`` and
``SPARK_BAM_INFLATE``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.core.inflate_config import InflateConfig as JaxInflateConfig
from spark_bam_tpu.parallel import mesh as jmesh
from spark_bam_tpu.parallel import stream_mesh as jsm
from spark_bam_tpu.tpu import checker as jck
from spark_bam_tpu.tpu import inflate as jinf
from spark_bam_tpu.tpu.stream_check import StreamChecker as JaxStreamChecker
from spark_bam_tpu.tpu.stream_check import (
    full_check_summary_streaming as jax_summary,
)
from spark_bam_tpu_torch import (
    Config,
    count_reads_sharded,
    full_check_summary_streaming,
    make_mesh,
)
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.bgzf.flat import flatten_file, read_run_payloads
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.cli import main
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import InflateConfig
from spark_bam_tpu_torch.load.tpu_load import stream_read_batches
from spark_bam_tpu_torch.native import build
from spark_bam_tpu_torch.parallel import stream_mesh as psm
from spark_bam_tpu_torch.tpu import checker as pck
from spark_bam_tpu_torch.tpu import inflate as pinf
from spark_bam_tpu_torch.tpu.stream_check import (
    StreamChecker,
    pad_contig_lengths,
)
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WINDOW, HALO = 128 << 10, 32 << 10
HOST = "tokenize=host"
JHOST = JaxConfig(device_inflate=True, inflate=HOST)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    monkeypatch.delenv("SPARK_BAM_INFLATE", raising=False)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_host_inflate")
    out = {"synth": str(d / "synth.bam"), "rand": str(d / "rand.bam"),
           "corrupt": str(d / "corrupt.bam")}
    out["synth_reads"] = synth_bam(out["synth"], 1 << 20, seed=21)["reads"]
    random_bam(out["rand"], seed=11, n_records=(200, 400),
               read_len=(10, 6000), mapped_rate=0.7)
    # The synthetic BAM with one middle block's DEFLATE payload starting in
    # a block of type 3, which no decoder accepts.
    blob = bytearray(Path(out["synth"]).read_bytes())
    metas = blocks_metadata(out["synth"])
    m = metas[len(metas) // 2]
    blob[m.start + 18] = 0xFF
    Path(out["corrupt"]).write_bytes(bytes(blob))
    return out


def _geo(**kw):
    return Config(window_size=WINDOW, halo_size=HALO, **kw)


def _port_count(path, **kw):
    sc = StreamChecker(path, _geo(**kw), device="cpu")
    return sc.count_reads(), sc


# ------------------------------------------------------ the fused program
@pytest.mark.parametrize("funnel", [True, False], ids=["funnel", "full"])
def test_count_window_tokens_equals_jax(bams, funnel):
    """Each window of the synthetic BAM through both programs: count,
    esc_count, survivors, rounds and the next carry, equal; each side
    feeds its own carry on."""
    path = bams["synth"]
    sc = StreamChecker(path, _geo(), device="cpu")
    w, halo = sc.kernel_window, sc.halo
    lens = pad_contig_lengths(sc.lengths)
    nc = len(sc.lengths)
    jkernel = jck.make_count_window_tokens(w, halo, 10, funnel=funnel)
    pcarry = torch.zeros(halo, dtype=torch.uint8)
    jcarry = jnp.zeros(halo, jnp.uint8)
    carry_len = base = 0
    groups = sc.pipeline.groups
    assert len(groups) >= 4
    with open_channel(path) as ch:
        for gi, g in enumerate(groups):
            jpacked, jlens, _ = jinf.tokenize_group(ch, g)
            group = pinf.tokenize_group(ch, g)
            assert np.array_equal(group.packed, jpacked)
            n = carry_len + int(group.out_lens.sum())
            at_eof = gi == len(groups) - 1
            own = n if at_eof else max(n - halo, 0)
            lo = min(max(sc.header_end_abs - base, 0), own)
            got = pck.count_window_tokens(
                group.to_device(torch.device("cpu")),
                torch.from_numpy(group.out_lens), pcarry,
                torch.from_numpy(lens), nc, carry_len, n, at_eof, lo, own,
                window=w, halo=halo, funnel=funnel)
            want = jkernel(
                jnp.asarray(jpacked), jnp.asarray(jlens.astype(np.int32)),
                jcarry, jnp.asarray(lens), jnp.int32(nc),
                jnp.int32(carry_len), jnp.int32(n), jnp.bool_(at_eof),
                jnp.int32(lo), jnp.int32(own))
            assert set(got) == set(want)
            for k in want:
                assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
            pcarry, jcarry = got["carry"], want["carry"]
            carry_len, base = n - own, base + own


# ------------------------------------------------------------ the routes
def test_count_reads_equals_jax_and_device_route(bams):
    """The fused count under ``tokenize=host`` against the JAX package's
    fused count over packed tokens and the port's device route."""
    for path in (bams["synth"], bams["rand"]):
        got, sc = _port_count(path, inflate=HOST)
        assert sc.tokenize_demotions == 0
        device_route, _ = _port_count(path)
        jsc = JaxStreamChecker(path, JHOST, WINDOW, HALO)
        assert jsc.pipeline.device_copy
        assert got == device_route == jsc.count_reads()
    assert got == _port_count(bams["rand"], inflate=HOST)[0]
    assert _port_count(bams["synth"], inflate=HOST)[0] == bams["synth_reads"]


def test_fused_count_takes_the_packed_route(bams, monkeypatch):
    """Under ``tokenize=host`` every window of the fused count goes through
    ``count_window_tokens``, never the device tokenizer."""
    calls = []
    real = pck.count_window_tokens

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def no_kernel(*a, **kw):
        raise AssertionError("the device tokenizer ran")

    from spark_bam_tpu_torch.tpu import stream_check

    monkeypatch.setattr(stream_check, "count_window_tokens", spy)
    monkeypatch.setattr(stream_check, "count_window_raw", no_kernel)
    monkeypatch.setattr(pck, "tokenize", no_kernel)
    got, sc = _port_count(bams["synth"], inflate=HOST)
    assert got == bams["synth_reads"]
    assert len(calls) == len(sc.pipeline.groups)


def test_full_check_summary_equals_jax_and_device_route(bams):
    for path in (bams["synth"], bams["rand"]):
        got = full_check_summary_streaming(path, _geo(inflate=HOST),
                                           device="cpu")
        dev = full_check_summary_streaming(path, _geo(), device="cpu")
        want = jax_summary(path, JHOST, WINDOW, HALO, use_device=False)
        for other in (dev, want):
            assert got.keys() == other.keys()
            for k in got:
                if isinstance(got[k], np.ndarray):
                    np.testing.assert_array_equal(got[k], other[k],
                                                  err_msg=k)
                else:
                    assert got[k] == other[k], k


def test_load_batches_equal_device_route(bams):
    """The load's window batches parse the same records from packed-route
    windows as from device-tokenized ones."""
    def rows(config):
        out = []
        for base, batch in stream_read_batches(bams["rand"], config,
                                               device="cpu"):
            v = batch.columns["valid"]
            out.append((base, batch.starts[v].tolist(),
                        {k: c[v].tolist() for k, c in batch.columns.items()}))
        return out

    assert rows(_geo(inflate=HOST)) == rows(_geo())


def test_inflate_file_device_equals_flatten_and_jax(bams, monkeypatch):
    for path in (bams["synth"], bams["rand"]):
        want = flatten_file(path)
        got = pinf.inflate_file_device(path, HOST, device="cpu")
        assert np.array_equal(got.data, want.data)
        assert np.array_equal(got.block_starts, want.block_starts)
        assert np.array_equal(got.block_flat, want.block_flat)
        assert got.at_eof and got.file_total == want.file_total
        monkeypatch.setenv("SPARK_BAM_INFLATE", HOST)
        jview = jinf.inflate_file_device(path)
        assert np.array_equal(got.data, jview.data)
        # None reads SPARK_BAM_INFLATE, as the reference does.
        assert np.array_equal(
            pinf.inflate_file_device(path, device="cpu").data, want.data)
        monkeypatch.delenv("SPARK_BAM_INFLATE")
        assert np.array_equal(
            pinf.inflate_file_device(path, "", device="cpu").data, want.data)


def test_inflate_blocks_device_equals_reference(bams):
    metas = blocks_metadata(bams["rand"])
    with open_channel(bams["rand"]) as ch:
        comp, offs, lens = read_run_payloads(ch, metas)
    usizes = np.array([m.uncompressed_size for m in metas], dtype=np.int64)
    got = pinf.inflate_blocks_device(comp, offs, lens, usizes, device="cpu")
    assert np.array_equal(got, jinf.inflate_blocks_device(comp, offs, lens,
                                                          usizes))
    assert np.array_equal(got, flatten_file(bams["rand"]).data)


@pytest.mark.parametrize("n", [1, 2])
def test_sharded_count_equals_jax(bams, n):
    path = bams["rand"]
    stats: dict = {}
    got = count_reads_sharded(path, Config(inflate=HOST),
                              mesh=make_mesh(["cpu"] * n),
                              window_uncompressed=WINDOW, halo=HALO,
                              stats_out=stats)
    assert stats["tokenize_demotions"] == 0
    want = jsm.count_reads_sharded(
        path, JHOST, mesh=jmesh.make_mesh(jax.devices()[:n]),
        window_uncompressed=WINDOW, halo=HALO)
    dev = count_reads_sharded(path, Config(), mesh=make_mesh(["cpu"] * n),
                              window_uncompressed=WINDOW, halo=HALO)
    assert got == want == dev


# -------------------------------------------------------------- refusals
def _refuse_block(monkeypatch, path, k: int):
    """Make the host tokenizer refuse block ``k`` of ``path`` (whichever
    thread's row range holds it)."""
    metas = blocks_metadata(path)
    with open_channel(path) as ch:
        comp, offs, lens = read_run_payloads(ch, metas[k: k + 1])
    target = bytes(comp[offs[0]: offs[0] + lens[0]])
    real = pinf.tokenize_deflate

    def refusing(comp, offsets, lengths, lit, dist, out_lens):
        for i, (o, n) in enumerate(zip(offsets, lengths)):
            if bytes(comp[o: o + n]) == target:
                rc = real(comp, offsets[:i], lengths[:i], lit, dist,
                          out_lens)
                return rc or i + 1
        return real(comp, offsets, lengths, lit, dist, out_lens)

    monkeypatch.setattr(pinf, "tokenize_deflate", refusing)


def test_refused_group_demotes_counted_with_exact_results(bams,
                                                          monkeypatch):
    """One block the host tokenizer refuses: the fused count moves to the
    classic loop, full-check's window and the sharded row to host zlib,
    each counted once, and every result equals host zlib's."""
    path = bams["synth"]
    want = _port_count(path, device_inflate=False)[0]
    hz = [tuple(a) for a in StreamChecker(
        path, _geo(device_inflate=False), device="cpu").full_spans()]
    _refuse_block(monkeypatch, path, 3)
    got, sc = _port_count(path, inflate=HOST)
    assert (got, sc.tokenize_demotions) == (want, 1)
    fc = StreamChecker(path, _geo(inflate=HOST), device="cpu")
    spans = list(fc.full_spans())
    assert fc.tokenize_demotions == 1
    assert len(spans) == len(hz)
    for a, b in zip(spans, hz):
        assert a[0] == b[0]
        assert all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
    stats: dict = {}
    mesh = make_mesh(["cpu"] * 2)
    assert count_reads_sharded(path, Config(inflate=HOST), mesh=mesh,
                               window_uncompressed=WINDOW, halo=HALO,
                               stats_out=stats) == want
    # Every row that holds the block (its own or in its halo) demotes.
    rows = psm._ShardedStream(path, Config(inflate=HOST), mesh, WINDOW, HALO,
                              None)
    block = blocks_metadata(path)[3]
    holding = sum(block in rows._row_range(g)[0]
                  for g in range(len(rows.groups)))
    assert stats["tokenize_demotions"] == holding >= 1
    with pytest.raises(pinf.TokenizeError, match="failed at block 3"):
        pinf.inflate_file_device(path, HOST, device="cpu", threads=1)


def test_corrupt_payload_demotes_then_raises_as_jax(bams):
    """A payload no decoder accepts: the host tokenizer refuses it (one
    counted demotion), then host zlib refuses it too, so the count raises,
    as the JAX package's does; no count comes out."""
    path = bams["corrupt"]
    sc = StreamChecker(path, _geo(inflate=HOST), device="cpu")
    with pytest.raises(Exception):
        sc.count_reads()
    assert sc.tokenize_demotions == 1
    with pytest.raises(Exception):
        JaxStreamChecker(path, JHOST, WINDOW, HALO).count_reads()


# ------------------------------------------------------------- the knob
@pytest.mark.parametrize("spec", ["tokenize=host", "host", "device",
                                  "tokenize=auto", "", "tokenize=device,"
                                  "kernel=auto,donate=on"])
def test_inflate_spec_parses_as_reference(spec):
    got, want = InflateConfig.parse(spec), JaxInflateConfig.parse(spec)
    assert got.tokenize == want.tokenize
    assert got.resolve_tokenize() == ("host" if want.tokenize == "host"
                                      else "device")
    assert Config(inflate=spec).inflate_config == got


def test_spark_bam_inflate_env_and_cli(bams, monkeypatch, capsys):
    monkeypatch.setenv("SPARK_BAM_INFLATE", "host")
    assert Config.from_env().inflate == "host"
    assert JaxConfig.from_env().inflate == "host"
    calls = []
    real = pinf.tokenize_group
    from spark_bam_tpu_torch.parallel import stream_mesh

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    # The sharded count inflates on the device route (the default
    # count-reads is the record path's load_bam, which reads with host
    # zlib, as the reference's does).
    sharded = ["count-reads", "--sharded", "--device", "cpu", "--devices",
               "1"]
    monkeypatch.setattr(stream_mesh, "tokenize_group", spy)
    assert main([*sharded, bams["rand"]]) == 0
    env_out = capsys.readouterr().out
    assert calls
    monkeypatch.delenv("SPARK_BAM_INFLATE")
    calls.clear()
    assert main([*sharded, "--inflate", "tokenize=host", bams["rand"]]) == 0
    assert calls
    flag_out = capsys.readouterr().out
    calls.clear()
    assert main([*sharded, bams["rand"]]) == 0
    assert not calls
    plain_out = capsys.readouterr().out
    count = [ln for ln in plain_out.splitlines() if ln.startswith("Read")]
    assert count and all(count[0] in out for out in (env_out, flag_out))
    for cmd in (["full-check"], ["check-bam", "--sharded"], ["aggregate"],
                ["compute-splits"], ["index"], ["export", "-o", "x"]):
        assert main([*cmd, "--device", "cpu", "--inflate", "tokenize=bad",
                     bams["rand"]]) == 2
        assert "Bad inflate tokenize" in capsys.readouterr().err


def test_host_tokenizer_build_failure_raises_in_the_count(bams, tmp_path,
                                                          monkeypatch):
    """No compiler: the count raises; it never demotes to another
    tokenizer or to host zlib."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(build.NativeBuildError):
        _port_count(bams["rand"], inflate=HOST)
