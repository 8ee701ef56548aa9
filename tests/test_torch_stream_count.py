"""The port's whole-file count against the JAX package's streaming count.

Both of the port's loops (the fused device-resident loop and the classic
host-zlib loop, run on the CPU with the plain kernel versions) must return
exactly ``count_reads_streaming(..., use_device=False)`` at several
window/halo geometries, including seams that fall inside records and
chains that outrun the halo (the escape retry through ``spans()``).
"""

import numpy as np
import pytest
import torch

from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.tpu.stream_check import count_reads_streaming
from spark_bam_tpu_torch import Config, StreamChecker
from spark_bam_tpu_torch.tpu import checker as ck
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_stream") / "s.bam"
    random_bam(p, seed=51, read_len=(10, 300), n_records=(400, 600))
    return p


@pytest.fixture(scope="module")
def long_bam(tmp_path_factory):
    """Records of 3-4.5 KB: ten-record chains outrun a 16 KiB halo."""
    p = tmp_path_factory.mktemp("torch_stream_long") / "l.bam"
    random_bam(p, seed=52, read_len=(2000, 3000), n_records=(40, 60))
    return p


GEOMETRIES = [(64 << 10, 16 << 10), (128 << 10, 32 << 10), (96 << 10, 48 << 10)]


def _reference(path, window, halo):
    return count_reads_streaming(path, JaxConfig(), window_uncompressed=window,
                                 halo=halo, use_device=False)


@pytest.mark.parametrize("window,halo", GEOMETRIES)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "classic"])
def test_count_matches_jax(bam, window, halo, fused):
    want = _reference(bam, window, halo)
    sc = StreamChecker(bam, Config(fused_count=fused), window_uncompressed=window,
                       halo=halo, device="cpu")
    assert sc.count_reads() == want
    assert sc.tokenize_demotions == 0
    assert sc.funnel_stats["survivors"] > 0


def test_window_seams_fall_inside_records(bam):
    """The geometry above really cuts records: a window boundary that is not
    a record start exists (so the halo carry is exercised)."""
    from spark_bam_tpu.bgzf.flat import flatten_file
    from spark_bam_tpu.check.vectorized import check_flat
    from spark_bam_tpu.bam.header import contig_lengths

    data = flatten_file(bam).data
    lens = np.array(contig_lengths(bam).lengths_list(), dtype=np.int32)
    starts = set(np.flatnonzero(check_flat(data, lens).verdict).tolist())
    sc = StreamChecker(bam, Config(), window_uncompressed=64 << 10,
                       halo=16 << 10, device="cpu")
    seams = np.cumsum([sum(m.uncompressed_size for m in g)
                       for g in sc.pipeline.groups])[:-1]
    assert len(seams) >= 2
    assert any(int(s) not in starts for s in seams)


def test_default_geometry_serves_small_files_fused(bam, monkeypatch):
    """At the default 24 MiB window and 4 MiB halo, a file far smaller than
    the halo still runs the fused loop: the kernel window covers every
    window's carry plus group, so nothing moves to the classic loop."""
    def no_classic(self):
        raise AssertionError("the fused loop handed the count to host zlib")

    monkeypatch.setattr(StreamChecker, "_count_reads_classic", no_classic)
    sc = StreamChecker(bam, Config(), device="cpu")
    assert sc.kernel_window < sc.halo
    assert sc.count_reads() == _reference(bam, None, None)
    assert sc.tokenize_demotions == 0


def test_rejected_row_demotes_with_equal_count(bam, monkeypatch):
    """A tokenizer verdict of False on one row demotes the whole count to the
    classic loop: the count is still exact and the demotion is counted."""
    real = ck.tokenize

    def reject_first_row(staged, clens):
        lit, dist, olens, ok = real(staged, clens)
        ok = ok.clone()
        ok[0] = False
        return lit, dist, olens, ok

    monkeypatch.setattr(ck, "tokenize", reject_first_row)
    sc = StreamChecker(bam, Config(), window_uncompressed=64 << 10,
                       halo=16 << 10, device="cpu")
    assert sc.count_reads() == _reference(bam, 64 << 10, 16 << 10)
    assert sc.tokenize_demotions == 1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "classic"])
def test_escapes_raise_count_escaped(long_bam, fused):
    """Chains longer than the halo escape; the count no longer raises on
    them but re-runs the file through the exact spans/deferral path, and
    equals the reference's count at the same geometry (one retry)."""
    sc = StreamChecker(long_bam, Config(fused_count=fused),
                       window_uncompressed=64 << 10, halo=16 << 10,
                       device="cpu")
    retries = []
    via_spans = sc._count_via_spans
    sc._count_via_spans = lambda: retries.append(1) or via_spans()
    assert sc.count_reads() == _reference(long_bam, 64 << 10, 16 << 10)
    assert retries == [1]
    assert sc.tokenize_demotions == 0
    big = StreamChecker(long_bam, Config(fused_count=fused),
                        window_uncompressed=256 << 10, halo=128 << 10,
                        device="cpu")
    assert big.count_reads() == _reference(long_bam, 64 << 10, 16 << 10)


def test_device_none_requires_cuda(bam, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamChecker(bam, Config())


def test_flush_every_one_and_ring_depth_one(bam):
    """Flushing every window and syncing every window change nothing."""
    sc = StreamChecker(bam, Config(flush_every=1, ring_depth=1),
                       window_uncompressed=64 << 10, halo=16 << 10,
                       device="cpu")
    assert sc.count_reads() == _reference(bam, 64 << 10, 16 << 10)
