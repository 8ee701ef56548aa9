"""The port's decode fuzz (``tools/fuzz_decode.py``) against the JAX
package's: for two seeds and the ``bam``, ``bgzf`` and ``sbi`` corpora,
the same mutants byte for byte, the same outcome for every mutant in
strict and tolerant mode, the same per-format ``counts`` from
``run_fuzz``, no violation, and the device boundary probe of every BAM
mutant (``next_read_start`` through ``check_window``, the plain kernels
here) at the JAX eager checker's record start."""

import contextlib
import io
import json
import zlib
from pathlib import Path

import pytest

import spark_bam_tpu.tools.fuzz_decode as J
import spark_bam_tpu_torch.tools.fuzz_decode as P
from spark_bam_tpu.bam.header import read_header as jax_read_header
from spark_bam_tpu.bgzf.stream import SeekableBlockStream as JBlockStream
from spark_bam_tpu.bgzf.stream import SeekableUncompressedBytes as JBytes
from spark_bam_tpu.check.eager import EagerChecker as JEager
from spark_bam_tpu.core.channel import open_channel as jax_open
from spark_bam_tpu.core.config import Config as JConfig
from spark_bam_tpu.core.pos import Pos as JPos
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.fuzz

MUTANTS = 100
SEEDS = (0, 1)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fuzz")
    (d / "base.bam").write_bytes(J._bgzf_compress(J._bam_uncompressed()[0])[0])
    return d


def test_pristine_corpora_equal_jax(corpus_dir):
    assert P.base_bam_bytes() == (corpus_dir / "base.bam").read_bytes()
    assert P._bam_uncompressed() == J._bam_uncompressed()
    assert P._sbi_corpus(corpus_dir / "base.bam") == \
        J._sbi_corpus(corpus_dir / "base.bam")


def _jax_mutants(fmt, d, seed):
    rng = J._Rng((seed << 16) ^ zlib.crc32(fmt.encode()))
    return list(J._mutants_for(fmt, d, rng, MUTANTS))


def _jax_probe(path):
    try:
        header = jax_read_header(str(path))
        checker = JEager(JBytes(JBlockStream(jax_open(str(path)))),
                         header.contig_lengths, JConfig().reads_to_check)
        try:
            pos = checker.next_read_start(JPos(0, 0), JConfig().max_read_size)
        finally:
            checker.close()
        return None if pos is None else (pos.block_pos, pos.offset)
    except Exception as e:
        return type(e).__name__


def _port_probe(path):
    try:
        return P.probe_record_start(path, "cpu")
    except Exception as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fmt", P.FORMATS)
def test_mutants_and_outcomes_equal_jax(corpus_dir, fmt, seed):
    want = _jax_mutants(fmt, corpus_dir, seed)
    got = list(P.mutants_for(fmt, corpus_dir, P.rng_for(seed, fmt), MUTANTS))
    assert got == want
    consume, tolerant_too = P._CONSUMERS[fmt]
    jconsume, _ = J._CONSUMERS[fmt]
    path = corpus_dir / f"mutant.{fmt}"
    outcomes, probes = [], 0
    for idx, mutant in enumerate(want):
        path.write_bytes(mutant)
        for tolerant in ((False, True) if tolerant_too else (False,)):
            ours = P.run_case(consume, path, tolerant, "cpu")
            theirs = J._run_case(jconsume, path, tolerant)
            assert ours["outcome"] == theirs["outcome"], (idx, tolerant, ours,
                                                          theirs)
            assert ours["outcome"] != "untyped"
            outcomes.append(ours["outcome"])
        if fmt == "bam":
            port = _port_probe(path)
            assert port == _jax_probe(path), idx
            probes += isinstance(port, tuple)
    assert len(set(outcomes)) > 1
    if fmt == "bam":
        assert probes > MUTANTS // 2


@pytest.mark.parametrize("seed", SEEDS)
def test_run_fuzz_counts_equal_jax(seed):
    formats = ("bam", "bgzf", "sbi")
    got = P.run_fuzz(seed, MUTANTS, formats, device="cpu")
    want = J.run_fuzz(seed, MUTANTS, formats)
    assert got["counts"] == want["counts"]
    assert got["violations"] == want["violations"] == []
    assert sum(got["probes"]["bam"].values()) == MUTANTS
    assert "device" not in got   # logged on a CUDA device only


def test_cli_fuzz_decode_and_cram_refusal(tmp_path):
    from spark_bam_tpu_torch import cli

    out = tmp_path / "fuzz.json"
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = cli.main(["fuzz-decode", "--seed", "3", "--mutants", "20",
                       "--formats", "bgzf,sbi", "--device", "cpu",
                       "-o", str(out)])
    assert rc == 0
    summary = json.loads(buf.getvalue())
    assert summary == json.loads(out.read_text())
    assert summary["counts"] == J.run_fuzz(3, 20, ("bgzf", "sbi"))["counts"]
    # CRAM runs now, with the JAX tool's outcome counts.
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert cli.main(["fuzz-decode", "--seed", "3", "--mutants", "20",
                         "--formats", "bgzf,cram", "--device", "cpu"]) == 0
    assert json.loads(buf.getvalue())["counts"] == J.run_fuzz(
        3, 20, ("bgzf", "cram"))["counts"]
    assert P.run_fuzz(0, 1, ("cram",), device="cpu")["counts"] == \
        J.run_fuzz(0, 1, ("cram",))["counts"]
    # An unknown format is still a usage error.
    with contextlib.redirect_stderr(io.StringIO()) as err:
        assert cli.main(["fuzz-decode", "--formats", "bam,vcf",
                         "--device", "cpu"]) == 2
    assert "vcf" in err.getvalue()
    with pytest.raises(ValueError, match="vcf"):
        P.run_fuzz(0, 1, ("vcf",), device="cpu")


def test_typed_errors_keep_the_reference_names():
    assert {e.__name__ for e in P.TYPED_ERRORS} == \
        {e.__name__ for e in J.TYPED_ERRORS}
    assert P.FUZZ_LIMITS.__dict__ == J.FUZZ_LIMITS.__dict__
    assert P.TIME_LIMIT_S == J.TIME_LIMIT_S
    assert Path(P.__file__).name == "fuzz_decode.py"
