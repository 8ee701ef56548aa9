"""The port's ``rewrite`` against the JAX CLI's ``htsjdk-rewrite``, on the
CPU, exactly: ``python -m spark_bam_tpu_torch rewrite --device cpu
[-i] [--deflate SPEC]`` and the JAX command give the same output BAM,
``.blocks`` and ``.records`` byte for byte and the same printed lines but
for the paths; the ``.sbi`` decodes to the same blocks, record starts and
split plans, and its fingerprint is the port's ``fingerprint_of`` of the
output; a warm ``compute-splits`` of the output resolves no boundary.
``BamRecord.decode`` / ``encode`` round-trip equals the JAX one on the
load edge corpus, malformed records raise the same typed errors, and a bad
``--deflate`` spec fails before any output exists."""

import dataclasses
import struct

import pytest

from spark_bam_tpu.bam.record import BamRecord as JaxBamRecord
from spark_bam_tpu.cli.main import main as jax_main
from spark_bam_tpu.core import guard as jguard
from spark_bam_tpu_torch import cli
from spark_bam_tpu_torch.bam.iterators import RecordStream
from spark_bam_tpu_torch.bam.record import BamRecord
from spark_bam_tpu_torch.benchmarks import load_cases as lc
from spark_bam_tpu_torch.benchmarks.synth import BGZF_EOF, compress_blocks
from spark_bam_tpu_torch.core import guard
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.load import boundary
from spark_bam_tpu_torch.sbi.format import decode_sbi, fingerprint_of
from spark_bam_tpu_torch.sbi.store import reset_cache_events
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ("SPARK_BAM_DEFLATE", "SPARK_BAM_CACHE", "SPARK_BAM_CACHE_DIR",
                "SPARK_BAM_SPLIT_SIZE", "SPARK_BAM_METRICS_OUT"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rewrite")
    out = {}
    for seed in (77, 5):
        p = str(d / f"s{seed}.bam")
        random_bam(p, seed=seed, n_records=(300, 301))
        out[seed] = p
    out["edges"] = str(d / "edges.bam")
    lc.write_bam(out["edges"], seed=2, fillers=200)
    return out


def _both(tmp_path, capsys, src, *flags):
    """(port lines, JAX lines, port out, JAX out) of one rewrite."""
    j_out, p_out = str(tmp_path / "j.bam"), str(tmp_path / "p.bam")
    assert jax_main(["htsjdk-rewrite", *flags, src, j_out]) == 0
    j_lines = capsys.readouterr().out.replace(j_out, "OUT").splitlines()
    reset_cache_events()
    assert cli.main(["rewrite", "--device", "cpu", *flags, src, p_out]) == 0
    p_lines = capsys.readouterr().out.replace(p_out, "OUT").splitlines()
    return p_lines, j_lines, p_out, j_out


@pytest.mark.parametrize("flags", [
    [], ["-i"], ["-b", "8192"], ["--level", "1", "-b", "30000"],
    ["-i", "--deflate", "mode=fixed"], ["--deflate", "mode=stored"],
    ["-i", "-b", "4000", "--deflate", "mode=auto"],
    ["--deflate", "mode=auto,device=off"],
    ["--deflate", "fixed,lanes=3"],
], ids=["zlib", "zlib_i", "b8192", "level1", "fixed_i", "stored", "auto_i",
        "auto_off", "fixed_lanes3"])
@pytest.mark.parametrize("src", [77, "edges"])
def test_rewrite_equals_jax(bams, tmp_path, capsys, flags, src):
    p_lines, j_lines, p_out, j_out = _both(tmp_path, capsys, bams[src],
                                           *flags)
    assert p_lines == j_lines and p_lines[0].startswith("Wrote ")
    exts = ["", ".blocks", ".records"] if "-i" in flags else [""]
    for ext in exts:
        with open(p_out + ext, "rb") as a, open(j_out + ext, "rb") as b:
            assert a.read() == b.read(), ext


def test_rewrite_sbi_equals_jax_and_loads_warm(bams, tmp_path, capsys,
                                              monkeypatch):
    """At 64 KiB splits (JAX's from ``SPARK_BAM_SPLIT_SIZE``, the port's
    from ``-m``): the ``.sbi`` sections equal JAX's, the fingerprint is the
    output's, and a warm ``compute-splits`` reads the plan from it with no
    boundary resolved, giving the cold splits."""
    monkeypatch.setenv("SPARK_BAM_SPLIT_SIZE", "65536")
    src = bams[5]
    p_out, j_out = str(tmp_path / "p.bam"), str(tmp_path / "j.bam")
    assert jax_main(["htsjdk-rewrite", "-i", "--deflate", "mode=fixed",
                     "-b", "20000", src, j_out]) == 0
    assert cli.main(["rewrite", "-i", "--deflate", "mode=fixed", "-b",
                     "20000", "-m", "64KB", "--device", "cpu", src,
                     p_out]) == 0
    capsys.readouterr()
    with open(p_out, "rb") as a, open(j_out, "rb") as b:
        assert a.read() == b.read()
    with open(p_out + ".sbi", "rb") as f:
        port = decode_sbi(f.read())
    with open(j_out + ".sbi", "rb") as f:
        jax = decode_sbi(f.read())
    assert port.blocks == jax.blocks and len(port.blocks) > 3
    assert (port.record_starts == jax.record_starts).all()
    assert port.split_plans == jax.split_plans
    assert list(port.split_plans) == [65536]
    assert len(port.split_plans[65536]) > 2
    cfg = Config(split_size=65536)
    assert port.fingerprint == fingerprint_of(p_out, cfg)

    outs = {}
    for cache in ("off", "read"):
        boundary.STATS.reset()
        reset_cache_events()
        out = tmp_path / f"{cache}.txt"
        assert cli.main(["compute-splits", "-s", "-m", "64KB", "--cache",
                         cache, "--device", "cpu", "-o", str(out),
                         p_out]) == 0
        lines = out.read_text().splitlines()
        outs[cache] = [ln for ln in lines
                       if not ln.startswith(("Get ", "cache: "))]
        if cache == "read":
            assert "cache: hit (fingerprint ok)" in lines
            assert boundary.STATS.resolutions == 0
        else:
            assert boundary.STATS.resolutions > 0
    assert outs["read"] == outs["off"] and outs["off"]


def _record_fields(rec) -> dict:
    return {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)}


def test_record_decode_encode_equals_jax():
    """Every load edge record (cigars of 65 and 300 ops, empty and
    unplaced records, odd sequence lengths, tags), and a record whose
    sequence holds letters outside the code table, through both codecs."""
    recs = lc.edge_records(seed=3)
    for name, buf in recs.items():
        got, n = BamRecord.decode(buf)
        want, jn = JaxBamRecord.decode(buf)
        assert n == jn == len(buf), name
        assert _record_fields(got) == _record_fields(want), name
        assert got.encode() == want.encode() == buf, name
    odd = dataclasses.replace(got, seq="ACgTxĀN=", qual=b"\x01\x02")
    jodd = JaxBamRecord(**_record_fields(odd))
    assert odd.encode() == jodd.encode()
    assert odd.reference_span() == jodd.reference_span()


def _bad_records():
    good = lc.edge_records(seed=0)["unmapped_placed"]
    size = struct.unpack_from("<i", good)[0]
    return {
        "short": good[:30],
        "block_size_small": struct.pack("<i", 20) + good[4:],
        "declared_past_end": struct.pack("<i", size + 10) + good[4:],
        "no_name": good[:12] + b"\x00" + good[13:],
        "seq_negative": good[:20] + struct.pack("<i", -3) + good[24:],
        "fields_past_size": good[:20] + struct.pack("<i", 4000) + good[24:],
    }


@pytest.mark.parametrize("case", list(_bad_records()))
def test_malformed_record_raises_as_jax(case):
    buf = _bad_records()[case]
    with pytest.raises(jguard.MalformedInputError) as want:
        JaxBamRecord.decode(buf)
    with pytest.raises(guard.MalformedInputError) as got:
        BamRecord.decode(buf)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_record_stream_raises_typed_error_with_position(tmp_path):
    """A length prefix under the fixed fields stops the strict stream with
    ``StructurallyInvalid`` at the record's virtual position."""
    from spark_bam_tpu_torch.benchmarks.synth import encode_header

    rec = lc.edge_records(seed=0)["unmapped_placed"]
    path = tmp_path / "bad.bam"
    raw = encode_header() + rec + struct.pack("<i", 12) + bytes(40)
    path.write_bytes(compress_blocks(raw) + BGZF_EOF)
    with open_channel(path) as ch:
        stream = RecordStream.open(ch)
        it = iter(stream)
        pos, first = next(it)
        assert first.encode() == rec
        with pytest.raises(guard.StructurallyInvalid, match="at 0:"):
            next(it)


@pytest.mark.parametrize("how", ["flag", "env"])
def test_bad_deflate_spec_fails_before_output(bams, tmp_path, capsys,
                                              monkeypatch, how):
    out = tmp_path / "o.bam"
    flags = ["--deflate", "mode=bogus"] if how == "flag" else []
    if how == "env":
        monkeypatch.setenv("SPARK_BAM_DEFLATE", "lanes=0")
    assert cli.main(["rewrite", "-i", "--device", "cpu", *flags, bams[77],
                     str(out)]) == 2
    assert "error:" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
