"""The port's vectorized renderings of the variable-length columns
(``columnar/from_parser.py::render_columns``) against the row-by-row
``_var_piece``, the port's copy and the JAX package's, on the CPU.

Both sides take the same parsed ``ReadBatch``: every record of the load
edge corpus (``benchmarks/load_cases.py``, written as
``test_torch_load_stream.py::corpus`` writes it, at the generator's
starts, so the empty name the checker refuses is rendered too), and the
checked starts of ``random_bam`` seeds 0 and 91; then rows whose fields
point outside the buffer, where a Python slice clips. Every comparison
is exact."""

import numpy as np
import pytest

from spark_bam_tpu.columnar import from_parser as jfp
from spark_bam_tpu_torch import record_starts
from spark_bam_tpu_torch.benchmarks import load_cases as lc
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.columnar import from_parser as pfp
from spark_bam_tpu_torch.columnar import schema as ps
from spark_bam_tpu_torch.tpu.parser import ReadBatch, parse_flat_records
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

VAR = ps.VAR_COLUMNS


@pytest.fixture(scope="module")
def parsed(tmp_path_factory):
    """name → a ReadBatch over the whole flat buffer."""
    d = tmp_path_factory.mktemp("torch_render")
    out = {}
    edges = d / "edges.bam"
    m = lc.write_bam(edges, seed=2)
    out["edges"] = parse_flat_records(flatten_file(edges).data, m["starts"],
                                      device="cpu")
    out["edges"].manifest = m
    for seed in (0, 91):
        p = d / f"r{seed}.bam"
        if seed == 91:
            random_bam(p, seed=91, read_len=(10, 400), n_records=(800, 900),
                       mapped_rate=0.7, dup_rate=0.2)
        else:
            random_bam(p, seed=0)
        res = record_starts(p, device="cpu")
        out[f"random{seed}"] = parse_flat_records(res.view.data, res.starts,
                                                  device="cpu")
    return out


def _rowwise(mod, batch, name, rows):
    vals = [mod._var_piece(name, batch, int(i)) for i in rows]
    offsets = np.zeros(len(vals) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in vals], out=offsets[1:])
    return offsets, np.frombuffer(b"".join(vals), dtype=np.uint8)


@pytest.mark.parametrize("column", VAR)
@pytest.mark.parametrize("which", ["edges", "random0", "random91"])
def test_vectorized_equals_var_piece(parsed, which, column):
    batch = parsed[which]
    rows = np.flatnonzero(batch.columns["valid"])
    assert len(rows) > 300
    got = pfp.render_columns(batch, rows, (column,))[column]
    for mod in (pfp, jfp):
        offsets, values = _rowwise(mod, batch, column, rows)
        np.testing.assert_array_equal(got.offsets, offsets)
        np.testing.assert_array_equal(got.values, values)
    if which == "edges":
        names = batch.manifest["names"]
        assert set(names) >= {"cigar_65", "cigar_300", "empty_name",
                              "unmapped_unplaced", "tags_stray_bytes"}
        piece = dict(zip(names, (got.value(i) for i in range(len(rows)))))
        if column == "name":
            assert piece["empty_name"] == b""
        if column == "cigar":
            assert piece["unmapped_unplaced"] == b"*"
            assert piece["cigar_300"].count(b"M") >= 30
        if column == "seq":
            assert piece["unmapped_unplaced"] == b""


@pytest.mark.parametrize("batch_rows", [7, 8192])
def test_record_batches_equal_jax(parsed, batch_rows):
    """``read_batch_to_record_batches`` frame for frame, every column."""
    batch = parsed["edges"]
    got = list(pfp.read_batch_to_record_batches(batch, batch_rows))
    want = list(jfp.read_batch_to_record_batches(batch, batch_rows))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.num_rows == w.num_rows and g.column_names == w.column_names
        for name in w.column_names:
            gc, wc = g.columns[name], w.columns[name]
            if name in VAR:
                np.testing.assert_array_equal(gc.offsets, wc.offsets)
                np.testing.assert_array_equal(gc.values, wc.values)
            else:
                assert gc.dtype == wc.dtype
                np.testing.assert_array_equal(gc, wc)


def _odd_batch():
    """Rows whose fields reach outside a 400-byte buffer: a zero name
    length, odd and negative ``l_seq``, a block size ending before the
    qualities, a record running off the buffer's end, and every cigar op
    code with lengths of one to nine digits."""
    rng = np.random.default_rng(8)
    # Bit 3 clear: every byte read as a cigar word's first has op 0-7.
    buf = rng.integers(0, 256, 400, dtype=np.uint8) & 0xF7
    lengths = [0, 7, 42, 123, 9999, 12345, 654321, 7654321, 87654321]
    words = np.array([(n << 4) | (k % 9) for k, n in enumerate(lengths)],
                     dtype="<u4")
    buf[200:200 + 4 * len(words)] = np.frombuffer(words.tobytes(), np.uint8)
    rows = {  # start, l_read_name, n_cigar, l_seq, block_size
        "zero_name": (0, 0, 0, 5, 60),
        "odd_seq": (10, 3, 1, 7, 80),
        "negative_seq": (20, 4, 0, -9, 70),
        "short_block": (30, 8, 2, 20, 10),
        "off_the_end": (300, 12, 3, 120, 500),
        "all_ops": (200 - 36 - 2, 2, len(words), 11, 150),
        "empty_seq": (50, 1, 0, 0, 40),
    }
    starts = np.array([r[0] for r in rows.values()], dtype=np.int64)
    cols = {
        "name_offset": (starts + 36).astype(np.int32),
        "l_read_name": np.array([r[1] for r in rows.values()], np.int32),
        "n_cigar": np.array([r[2] for r in rows.values()], np.int32),
        "l_seq": np.array([r[3] for r in rows.values()], np.int32),
        "block_size": np.array([r[4] for r in rows.values()], np.int32),
        "valid": np.ones(len(rows), dtype=bool),
    }
    for c in ps.FIXED_COLUMNS:
        cols[c] = rng.integers(-100, 100, len(rows)).astype(np.int32)
    return ReadBatch(cols, starts, buf=buf)


@pytest.mark.parametrize("column", VAR)
def test_clipped_slices_equal_var_piece(column):
    batch = _odd_batch()
    rows = np.arange(len(batch.starts))
    got = pfp.render_columns(batch, rows, (column,))[column]
    for mod in (pfp, jfp):
        offsets, values = _rowwise(mod, batch, column, rows)
        np.testing.assert_array_equal(got.offsets, offsets)
        np.testing.assert_array_equal(got.values, values)
    if column == "cigar":
        assert got.value(5) == (b"0M7I42D123N9999S12345H654321P7654321="
                                b"87654321X")


def test_cigar_op_without_letter_raises_as_var_piece():
    """Op codes 9-15 have no letter: both row-by-row versions raise
    ``IndexError``, and so does the vectorized one."""
    batch = _odd_batch()
    batch.buf[200] = (batch.buf[200] & 0xF0) | 9
    rows = np.array([5])
    for mod in (pfp, jfp):
        with pytest.raises(IndexError):
            mod._var_piece("cigar", batch, 5)
    with pytest.raises(IndexError):
        pfp.render_columns(batch, rows, ("cigar",))


@pytest.mark.parametrize("columns", [("flag", "name", "seq"), ps.COLUMNS])
def test_arrow_stream_frames_equal_jax(parsed, columns):
    """The Arrow IPC stream frames of a parsed batch (``arrow_ipc.py``)
    equal the JAX package's, and read back to its rows."""
    pytest.importorskip("pyarrow")
    from spark_bam_tpu.columnar import arrow_ipc as jai
    from spark_bam_tpu_torch.columnar import arrow_ipc as pai

    assert pai.arrow_available()
    assert pai.arrow_schema(columns) == jai.arrow_schema(columns)
    batch = parsed["random91"]
    got, rows = pai.stream_frames(batch, 100, columns)
    want, want_rows = jai.stream_frames(batch, 100, columns)
    assert rows == want_rows == int(batch.columns["valid"].sum())
    assert got == want and got[-1] == pai.EOS
    table = pai.open_stream(b"".join(got)).read_all()
    assert table.num_rows == rows and table.column_names == list(columns)
