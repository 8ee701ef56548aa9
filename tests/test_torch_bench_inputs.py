"""The benchmark's inputs and instruments against the JAX package's.

``synthetic_fixture``, ``ensure_big_bam`` (a few MiB, cached under
``tmp_path``) and ``synth_longread_bam`` (small lengths) write the JAX
package's bytes and manifests for the same arguments; ``harvest`` turns
both CLIs' ``check-bam``/``check-blocks`` reports into the same rows; and
``count_repeat`` (the chip-rate instrument) equals ``iters`` times the
fused count and the JAX package's ``count_repeat`` at a small window.
"""

import contextlib
import io
import json
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_bam_tpu.benchmarks import harvest as jharvest
from spark_bam_tpu.benchmarks import synth as jsynth
from spark_bam_tpu.cli.main import main as jax_main
from spark_bam_tpu.tpu import checker as jck
from spark_bam_tpu_torch import cli
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.benchmarks import harvest, load_cases, synth
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.tpu import checker as ck
from spark_bam_tpu_torch.tpu import kernels as K
from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_inputs")
    return (synth.synthetic_fixture(root / "port"),
            jsynth.synthetic_fixture(root / "jax"), root)


def test_synthetic_fixture_is_the_references(fixtures):
    port, jax, _ = fixtures
    assert port.name == jax.name == "synthetic_fixture_2500.bam"
    assert port.read_bytes() == jax.read_bytes()
    assert read_header(port).contig_names == ("chr1", "chr2")


def test_synthetic_fixture_is_cached(fixtures, monkeypatch):
    port, _, _ = fixtures
    mtime = port.stat().st_mtime_ns
    from spark_bam_tpu_torch.bam import writer

    monkeypatch.setattr(writer, "write_bam",
                        lambda *a: pytest.fail("rewrote a cached fixture"))
    assert synth.synthetic_fixture(port.parent) == port
    assert port.stat().st_mtime_ns == mtime


def _manifest_without_paths(m: dict) -> dict:
    return {k: v for k, v in m.items() if k != "fixture"}


@pytest.mark.parametrize("target", [3 << 20, 5 << 20])
def test_ensure_big_bam_is_the_references(fixtures, target):
    port_fx, jax_fx, root = fixtures
    p, pm = synth.ensure_big_bam(target, root / f"pbig{target}", port_fx)
    j, jm = jsynth.ensure_big_bam(target, root / f"jbig{target}", jax_fx)
    assert p.name == j.name and p.read_bytes() == j.read_bytes()
    assert _manifest_without_paths(pm) == _manifest_without_paths(jm)
    assert pm["reads"] % 2500 == 0 and pm["compressed_bytes"] >= target
    # A second call reuses the file through its manifest.
    again, am = synth.ensure_big_bam(target, root / f"pbig{target}",
                                     port_fx)
    assert again == p and am == pm


def test_ensure_big_bam_falls_back_to_the_fixture(tmp_path, monkeypatch):
    """A missing fixture (or none) means the synthetic one, which is
    cached under the temporary directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    p, m = synth.ensure_big_bam(1 << 20, tmp_path / "big",
                                tmp_path / "absent.bam")
    fx = tmp_path / "tmp" / "spark_bam_bench" / "synthetic_fixture_2500.bam"
    assert m["fixture"] == str(fx) and fx.exists()
    j, jm = jsynth.ensure_big_bam(1 << 20, tmp_path / "jbig", fx)
    assert p.read_bytes() == j.read_bytes()
    assert json.loads(p.with_suffix(".manifest.json").read_text()) == m


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_longread_bam_is_the_references(tmp_path, seed):
    kw = dict(seed=seed, read_lens=(2_000, 9_000), reads_per_rep=5,
              ultra_seq_len=70_000)
    pm = synth.synth_longread_bam(tmp_path / "p.bam", 1 << 20, **kw)
    jm = jsynth.synth_longread_bam(tmp_path / "j.bam", 1 << 20, **kw)
    port = (tmp_path / "p.bam").read_bytes()
    assert port == (tmp_path / "j.bam").read_bytes()
    assert pm == jm and pm["ultra_reads"] == pm["reps"]
    p, m = synth.ensure_longread_bam(1 << 20, tmp_path / "c", **kw)
    assert p.read_bytes() == port and m == pm


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both CLIs' check-bam and check-blocks reports of two BAMs."""
    d = tmp_path_factory.mktemp("harvest")
    rand, trap = str(d / "rand.bam"), str(d / "trap.bam")
    random_bam(rand, seed=61, read_len=(10, 300), index=True)
    load_cases.write_seqdoop_trap_bam(trap, mate_set=False)
    from spark_bam_tpu_torch.bam.index_records import index_records

    index_records(trap)
    out = []
    for bam in (rand, trap):
        for cmd in ("check-bam", "check-blocks"):
            stem = f"{bam}.{cmd}"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main([cmd, "--device", "cpu", bam]) == 0
            with open(stem + ".port", "w") as f:
                f.write(buf.getvalue())
            assert jax_main([cmd, bam, "-o", stem + ".jax"]) == 0
            out += [stem + ".port", stem + ".jax"]
    return out


def test_parse_output_equals_jax_on_both_packages_reports(reports):
    seen = set()
    for path in reports:
        got, want = harvest.parse_output(path), jharvest.parse_output(path)
        assert got.tsv_row() == want.tsv_row(), path
        seen.add((got.all_matched, got.false_positives > 0,
                  got.num_blocks is not None))
    assert len(seen) >= 3   # matched, false positives, block reports


def test_main_prints_the_references_table(reports, capsys):
    assert harvest.main(reports) == 0
    got = capsys.readouterr().out
    assert jharvest.main(reports) == 0
    assert got == capsys.readouterr().out
    assert got.splitlines()[0] == "\t".join(harvest.BamInfo.FIELDS)


W = 1 << 17


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    p = tmp_path_factory.mktemp("count_repeat") / "r.bam"
    random_bam(p, seed=71, read_len=(10, 400), n_records=(700, 900))
    data = flatten_file(p).data[:W]
    buf = np.zeros(W + ck.PAD, np.uint8)
    buf[: len(data)] = data
    lengths = pad_contig_lengths(read_header(p).contig_lengths)
    return buf, lengths, 2, len(data)


@pytest.mark.parametrize("funnel", [True, False], ids=["funnel", "full"])
def test_count_repeat_is_iters_times_the_count_and_jaxs(window, funnel):
    buf, lengths, nc, n = window
    at_eof = n < W
    t = torch.from_numpy(buf)
    lens = torch.from_numpy(lengths)
    one = int(ck.count_window(t, lens, nc, n, at_eof, 0, n, 10,
                              funnel)["count"])
    assert one > 100
    got = ck.count_repeat(t, lens, nc, n, at_eof, window=W, iters=3,
                          funnel=funnel)
    assert got.dtype == torch.int32 and int(got) == 3 * one
    want = jck.count_repeat(jnp.asarray(buf), jnp.asarray(lengths),
                            jnp.int32(nc), jnp.int32(n), jnp.bool_(at_eof),
                            window=W, iters=3, reads_to_check=10,
                            flags_impl="xla", pallas_interpret=False,
                            funnel=funnel)
    assert int(got) == int(want)
    run = ck.make_count_repeat(W, 10, funnel, device="cpu")
    assert int(run(t, lens, nc, n, at_eof, 2)) == 2 * one


def test_count_repeat_on_cpu_tensors_launches_nothing(window):
    buf, lengths, nc, n = window
    t, lens = torch.from_numpy(buf), torch.from_numpy(lengths)
    before = dict(K.LAUNCHES)
    ck.count_repeat(t, lens, nc, n, False, window=W, iters=4, funnel=True)
    # CPU tensors run the plain versions: nothing is launched.
    assert K.LAUNCHES == before
    with pytest.raises(ValueError, match="window \\+ PAD"):
        ck.count_repeat(t[:-1], lens, nc, n, False, window=W, iters=1)
