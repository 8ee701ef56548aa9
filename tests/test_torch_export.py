"""The port's ``export`` against the JAX package's, on the CPU: the
port's output file (its streaming check and record parse run with
``device="cpu"``) equals JAX ``export``'s byte for byte. JAX ``export``
goes through the record path (``load_bam`` / ``load_bam_intervals`` and
decoded records); the port builds its batches from the parse and puts
spilled and deferred rows back in file order. Cases: sorted and indexed
random BAMs under loci and flag filters, projections, row targets and
codecs; the load edge corpus (cigars of 65 and 300 ops, an empty name at
the header's end); an empty name mid-file, whose chained records the
checker refuses and the record path reads; long reads whose records spill, with the spill flush
threshold at 1, 3 and its default; chains that escape the halo and
resolve through the deferral path; an empty selection. Arrow and Parquet
read back (pyarrow) to the JAX sinks' tables, and ``python -m
spark_bam_tpu_torch export`` prints the JAX CLI's line but for the
seconds."""

import dataclasses
import errno
import re

import numpy as np
import pytest
import torch

from spark_bam_tpu.bam.bai import index_bam
from spark_bam_tpu.cli.main import main as jax_main
from spark_bam_tpu.columnar import read_container as jax_read_container
from spark_bam_tpu.core.config import Config as JaxConfig
from spark_bam_tpu.load.api import export as jax_export
from spark_bam_tpu_torch import Config
from spark_bam_tpu_torch.benchmarks import load_cases as lc
from spark_bam_tpu_torch.benchmarks.synth import record_positions, synth_bam
from spark_bam_tpu_torch.cli import main
from spark_bam_tpu_torch.columnar import export as cex
from spark_bam_tpu_torch.columnar import native, sink
from spark_bam_tpu_torch.columnar.native import NativeReader
from spark_bam_tpu_torch.columnar.schema import VAR_COLUMNS, RecordBatch
from spark_bam_tpu_torch.core import atomic
from spark_bam_tpu_torch.load import api
from spark_bam_tpu_torch.tpu import stream_check
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEEDS = (0, 3, 7, 11)
LOCI = ("chr1:100k-3m", "chr2", "chr1:5k-40k,chr2:1m-2m")
FLAGS = ((0, 0x4), (0x1, 0x400))
LONG_GEOMETRY = dict(window_size=256 << 10, halo_size=64 << 10)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ("SPARK_BAM_DEFLATE", "SPARK_BAM_COLUMNAR", "SPARK_BAM_CACHE",
                "SPARK_BAM_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_export")
    out = {}
    for seed in SEEDS:
        p = str(d / f"s{seed}.bam")
        random_bam(p, seed=seed, sort=True)
        index_bam(p)
        out[seed] = p
    out["edges"] = str(d / "edges.bam")
    out["edges_manifest"] = lc.write_bam(out["edges"], seed=2)
    out["long"] = str(d / "long.bam")
    out["long_manifest"] = synth_bam(out["long"], 2 << 20, seed=9,
                                     unit_reads=8, read_len=(60_000, 110_000))
    out["escape"] = str(d / "escape.bam")
    random_bam(out["escape"], seed=52, read_len=(2000, 3000),
               n_records=(40, 60))
    return out


def _both(tmp_path, path, port_config=Config(), columnar="", **kw):
    """(port bytes, JAX bytes, port summary) of one export query."""
    port_out, jax_out = tmp_path / "port.sbcr", tmp_path / "jax.sbcr"
    summary = api.export(path, str(port_out), device="cpu",
                         config=dataclasses.replace(port_config,
                                                    columnar=columnar), **kw)
    want = jax_export(path, str(jax_out), config=JaxConfig(columnar=columnar),
                      **kw)
    assert {k: v for k, v in summary.items() if k not in ("seconds", "path")} \
        == {k: v for k, v in want.items() if k not in ("seconds", "path")}
    return port_out.read_bytes(), jax_out.read_bytes(), summary


@pytest.mark.parametrize("query", [
    {}, *({"loci": loci} for loci in LOCI),
    *({"flags_required": r, "flags_forbidden": f} for r, f in FLAGS)],
    ids=["all", "loci0", "loci1", "loci2", "forbid_unmapped", "paired_nodup"])
@pytest.mark.parametrize("seed", SEEDS)
def test_export_equals_jax(bams, tmp_path, seed, query):
    got, want, summary = _both(tmp_path, bams[seed], **query)
    assert got == want
    if query.get("flags_required") == 0x1:
        assert summary["rows"] == 0 and summary["batches"] == 0
    elif not query:
        assert summary["rows"] > 100


@pytest.mark.parametrize("columns", ["flag,pos", "name,cigar", None])
def test_projection_equals_jax(bams, tmp_path, columns):
    got, want, _ = _both(tmp_path, bams[7], columns=columns)
    assert got == want


@pytest.mark.parametrize("columnar", ["rows=1", "rows=100", "",
                                      "codec=zlib", "codec=deflate",
                                      "codec=zlib,level=1,rows=50",
                                      "columns=seq+qual+tags"])
def test_columnar_spec_equals_jax(bams, tmp_path, columnar):
    got, want, summary = _both(tmp_path, bams[3], columnar=columnar,
                               loci="chr1")
    assert got == want
    if columnar == "rows=1":
        assert summary["batches"] == summary["rows"] > 1


@pytest.mark.parametrize("columnar", ["", "codec=zlib"])
def test_edge_corpus_equals_jax(bams, tmp_path, columnar):
    """Every edge record, the refused empty name at the header's end
    included (the record path reads the first record unchecked), and
    the records with 65 and 300 cigar ops (which the JAX parse refuses)."""
    w, h = lc.GEOMETRY
    got, want, summary = _both(tmp_path, bams["edges"],
                               Config(window_size=w, halo_size=h),
                               columnar=columnar)
    assert got == want
    m = bams["edges_manifest"]
    assert summary["rows"] == m["records"]
    names = []
    for b in NativeReader(got).iter_batches():
        names += [b.columns["name"].value(i) for i in range(b.num_rows)]
    want_names = [n.replace("_", "-").encode() if not n.startswith(
        ("fill", "long", "ends_at")) else None for n in m["names"]]
    for got_name, want_name, case in zip(names, want_names, m["names"]):
        if case == "empty_name":
            assert got_name == b""
        elif want_name is not None:
            assert got_name == want_name, case


def _names(blob: bytes) -> list:
    names = []
    for b in NativeReader(blob).iter_batches():
        names += [b.columns["name"].value(i) for i in range(b.num_rows)]
    return names


@pytest.mark.parametrize("geometry", [None, lc.GEOMETRY],
                         ids=["default", "edge_geometry"])
def test_refused_record_mid_file_exports_its_chain(tmp_path, geometry):
    """A refused record mid-file: every start whose chain of
    ``reads_to_check`` records reaches it is refused by the checker, yet
    the record path reads them all, so the export writes all 601 rows as
    JAX's does (591 before the export followed the chain)."""
    path = str(tmp_path / "refused_mid.bam")
    m = lc.write_refused_mid_bam(path)
    cfg = Config() if geometry is None else Config(window_size=geometry[0],
                                                   halo_size=geometry[1])
    got, want, summary = _both(tmp_path, path, cfg)
    assert got == want
    assert summary["rows"] == m["records"] == 601
    assert _names(got) == [n.encode() for n in m["names"]]


@pytest.mark.parametrize("split_size", [2_000, 5_000, 9_000])
def test_refused_record_chain_per_split_equals_jax(tmp_path, split_size):
    """The record path chains each split from its own first start; at
    small split sizes the port's chain walk still equals JAX's export,
    with and without a flag filter."""
    path = str(tmp_path / "refused_mid.bam")
    lc.write_refused_mid_bam(path)
    for kw in ({}, {"flags_forbidden": 0x4}):
        p_out, j_out = tmp_path / "p.sbcr", tmp_path / "j.sbcr"
        api.export(path, str(p_out), device="cpu",
                   config=Config(split_size=split_size), **kw)
        jax_export(path, str(j_out), config=JaxConfig(split_size=split_size),
                   **kw)
        assert p_out.read_bytes() == j_out.read_bytes()


def _pieces(path, config):
    """The ordered pieces' offsets, in arrival order."""
    sc = stream_check.StreamChecker(path, config, device="cpu")
    return [(a.copy(), floor) for a, _, floor in sc.ordered_read_batches()]


@pytest.mark.parametrize("flush", [1, 3, stream_check.SPILL_FLUSH])
def test_long_reads_land_in_file_order(bams, tmp_path, monkeypatch, flush):
    """60-110 kb reads at a 256 KiB window and 64 KiB halo: most records
    spill and decode after their window's rows; the merge puts them back.
    The flush threshold changes when spills decode, never the bytes."""
    monkeypatch.setattr(stream_check, "SPILL_FLUSH", flush)
    cfg = Config(**LONG_GEOMETRY)
    pieces = _pieces(bams["long"], cfg)
    arrival = np.concatenate([a for a, _ in pieces])
    assert (np.diff(arrival) < 0).any()        # out of order as they come
    floors = [f for _, f in pieces]
    assert floors == sorted(floors)
    got, want, summary = _both(tmp_path, bams["long"], cfg)
    assert got == want
    m = bams["long_manifest"]
    assert summary["rows"] == m["reads"]
    pos = np.concatenate([b.columns["pos"] for b in
                          NativeReader(got).iter_batches()])
    assert sorted(pos.tolist()) == sorted(record_positions(m))


@pytest.mark.parametrize("flush", [1, stream_check.SPILL_FLUSH])
def test_deferred_rows_land_in_file_order(bams, tmp_path, monkeypatch, flush):
    """Ten-record chains of 2-3 kb reads outrun a 16 KiB halo: their starts
    defer and resolve windows later, behind later rows."""
    monkeypatch.setattr(stream_check, "SPILL_FLUSH", flush)
    added = []
    real_add = stream_check.StreamChecker._Deferred.add

    def spy(self, positions, *a):
        added.append(len(positions))
        return real_add(self, positions, *a)

    monkeypatch.setattr(stream_check.StreamChecker._Deferred, "add", spy)
    got, want, _ = _both(tmp_path, bams["escape"],
                         Config(window_size=64 << 10, halo_size=16 << 10))
    assert sum(added) > 0
    assert got == want


def test_file_order_refuses_a_late_row():
    """The merge's own check: a row below what it already released."""
    order = cex.FileOrder()
    one = RecordBatch({"flag": np.array([1], np.int32)}, 1)
    order.add(np.array([100]), one)
    assert len(list(order.release(200))) == 1
    with pytest.raises(RuntimeError, match="arrived after"):
        order.add(np.array([50]), one)


def test_empty_selection_writes_valid_container(bams, tmp_path):
    got, want, summary = _both(tmp_path, bams[0], loci="chr1:1-2")
    assert got == want and summary["rows"] == 0 == summary["batches"]
    reader = NativeReader(got)
    assert list(reader.iter_batches()) == []
    assert got.endswith(native.end_frame(0, 0))


class _FullDisk:
    """A file whose writes after the first fail with ENOSPC."""

    def __init__(self, f):
        self.f, self.writes = f, 0

    def write(self, data):
        self.writes += 1
        if self.writes > 1:
            raise OSError(errno.ENOSPC, "No space left on device")
        return self.f.write(data)

    def __getattr__(self, name):
        return getattr(self.f, name)


def test_failed_export_leaves_no_file(bams, tmp_path, monkeypatch):
    """A bad format fails before any file exists; an encoder that raises
    and a full disk (``ResourceExhausted``) leave no temp file behind."""
    out = tmp_path / "never.sbcr"
    with pytest.raises(ValueError, match="unknown export format"):
        api.export(bams[0], str(out), fmt="sideways", device="cpu")
    assert not list(tmp_path.iterdir())

    def boom(batch, meta):
        raise RuntimeError("encoder failed")

    with monkeypatch.context() as mp:
        mp.setattr(sink, "batch_frame", boom)
        with pytest.raises(RuntimeError, match="encoder failed"):
            api.export(bams[0], str(out), device="cpu")
    assert not list(tmp_path.iterdir())

    real_init = atomic.AtomicFile.__init__

    def full_disk(self, path):
        real_init(self, path)
        self.f = _FullDisk(self.f)

    monkeypatch.setattr(atomic.AtomicFile, "__init__", full_disk)
    with pytest.raises(atomic.ResourceExhausted):
        api.export(bams[0], str(out), device="cpu")
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("path", ["x.sam", "x.cram"])
def test_sam_and_cram_raise(tmp_path, path):
    with pytest.raises(NotImplementedError, match="item 16"):
        api.export(str(tmp_path / path), str(tmp_path / "o"), device="cpu")


def test_device_deflate_raises_and_leaves_no_file(bams, tmp_path,
                                                  monkeypatch):
    """A ``SPARK_BAM_DEFLATE`` that turns the device lanes on resolves them
    to CUDA; without a card the export raises, with no host fallback, and
    leaves no file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SPARK_BAM_DEFLATE", "mode=fixed")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.export(bams[0], str(tmp_path / "o"), device="cpu",
                   config=Config(columnar="codec=deflate"))
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("fmt", ["arrow", "parquet"])
@pytest.mark.parametrize("columns", [None, "flag,pos,name"])
def test_arrow_and_parquet_equal_jax(bams, tmp_path, fmt, columns):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    port_out, jax_out = tmp_path / f"p.{fmt}", tmp_path / f"j.{fmt}"
    s = api.export(bams[11], str(port_out), fmt=fmt, columns=columns,
                   device="cpu")
    jax_export(bams[11], str(jax_out), fmt=fmt, columns=columns)
    read = ((lambda p: pa.ipc.open_file(str(p)).read_all()) if fmt == "arrow"
            else (lambda p: pq.read_table(str(p))))
    got, want = read(port_out), read(jax_out)
    assert got.num_rows == s["rows"] > 0
    assert got.schema == want.schema
    assert got.equals(want)
    # And the native container's rows, column for column.
    rows = jax_read_container(jax_export(bams[11], str(tmp_path / "n"),
                                         columns=columns)["path"])[1]
    for name in got.column_names:
        col = np.concatenate([
            [b.columns[name].value(i) for i in range(b.num_rows)]
            if name in VAR_COLUMNS else b.columns[name] for b in rows])
        py = got.column(name).to_pylist()
        if name in ("name", "cigar", "seq"):
            py = [v.encode("latin-1") for v in py]
        assert list(col) == py, name


@pytest.mark.parametrize("fmt", ["arrow", "parquet"])
def test_empty_arrow_and_parquet(bams, tmp_path, fmt):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    out = tmp_path / f"e.{fmt}"
    s = api.export(bams[0], str(out), fmt=fmt, loci="chr1:1-2",
                   device="cpu")
    table = (pa.ipc.open_file(str(out)).read_all() if fmt == "arrow"
             else pq.read_table(str(out)))
    assert s["rows"] == table.num_rows == 0
    assert table.column_names == s["columns"]


_SECONDS = re.compile(r" in \d+\.\d\ds \[")


def _line(text: str, out_path) -> str:
    line = [ln for ln in text.splitlines() if ln.startswith("exported")]
    assert len(line) == 1, text
    assert _SECONDS.search(line[0]), line[0]
    return _SECONDS.sub(" in S [", line[0]).replace(str(out_path), "OUT")


@pytest.mark.parametrize("args", [
    [], ["-i", "chr2"], ["--columns", "flag,name", "--columnar", "rows=10"],
    ["--format", "parquet"], ["-m", "16k", "--columnar", "codec=zlib"]],
    ids=["plain", "loci", "projected", "parquet", "split_size_zlib"])
def test_cli_prints_the_jax_line(bams, tmp_path, capsys, args):
    if "parquet" in args:
        pytest.importorskip("pyarrow")
    port_out, jax_out = tmp_path / "port.out", tmp_path / "jax.out"
    assert main(["export", *args, "--device", "cpu", "-o", str(port_out),
                 bams[7]]) == 0
    got = _line(capsys.readouterr().out, port_out)
    assert jax_main(["export", *args, "-o", str(jax_out), bams[7]]) == 0
    want = _line(capsys.readouterr().out, jax_out)
    assert got == want
    if "parquet" not in args:
        assert port_out.read_bytes() == jax_out.read_bytes()


def test_cli_reads_spark_bam_columnar(bams, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SPARK_BAM_COLUMNAR", "rows=9,codec=zlib")
    assert main(["export", "--device", "cpu", "-o", str(tmp_path / "a"),
                 bams[0]]) == 0
    monkeypatch.delenv("SPARK_BAM_COLUMNAR")
    assert main(["export", "--device", "cpu", "--columnar",
                 "rows=9,codec=zlib", "-o", str(tmp_path / "b"), bams[0]]) == 0
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert NativeReader(str(tmp_path / "a")).meta["codec"] == "zlib"


@pytest.mark.parametrize("bad", [
    ["-i", "chr1:5-x"], ["--columns", "bin"], ["--columnar", "codec=lz4"],
    ["--columns", "flag,,nope"]])
def test_cli_rejects_bad_input_before_any_work(bams, tmp_path, capsys,
                                               monkeypatch, bad):
    def no_work(*a, **kw):
        raise AssertionError("the export started")

    monkeypatch.setattr(api, "export", no_work)
    monkeypatch.setattr(stream_check.StreamChecker, "__init__", no_work)
    assert main(["export", *bad, "--device", "cpu", "-o",
                 str(tmp_path / "o"), bams[0]]) == 2
    assert capsys.readouterr().err.startswith("error: ")
    assert not list(tmp_path.iterdir())
