"""The port's load filters and their inputs against the JAX package's.

``interval_flag_filter`` on seeded columns (wrapping ends, unmapped and
unplaced rows, every interval-table shape), ``_tag_presence_mask`` on
every tag value type and on malformed and randomly damaged tag regions,
``_apply_filter`` over loci, flags and tags on the load edge corpus,
``_interval_table`` and ``LociSet.parse`` (whole-contig expansion,
contigs absent from the header, every error), ``Pos``, the flat view's
block tables and the seekable stream. Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_bam_tpu.bam.header import read_header as jax_read_header
from spark_bam_tpu.bgzf.flat import flatten_file as jax_flatten
from spark_bam_tpu.bgzf.stream import SeekableBlockStream as JaxBlocks
from spark_bam_tpu.bgzf.stream import SeekableUncompressedBytes as JaxBytes
from spark_bam_tpu.core.channel import open_channel as jax_open
from spark_bam_tpu.core.pos import Pos as JaxPos
from spark_bam_tpu.load import intervals as jint
from spark_bam_tpu.load import tpu_load as jl
from spark_bam_tpu.tpu import parser as jp
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.benchmarks import load_cases as lc
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.bgzf.stream import (
    SeekableBlockStream,
    SeekableUncompressedBytes,
)
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.load import intervals as tint
from spark_bam_tpu_torch.load import tpu_load as tl
from spark_bam_tpu_torch.tpu import parser as tp


@pytest.fixture(autouse=True)
def jax_writable(monkeypatch):
    """Writable JAX parse outputs (see ``test_torch_load_parser.py``)."""
    orig = jp.parse_records

    def writable(*a, **kw):
        return {k: np.array(v) for k, v in orig(*a, **kw).items()}

    monkeypatch.setattr(jp, "parse_records", writable)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_load_filters") / "edges.bam"
    m = lc.write_bam(p, seed=1, fillers=400)
    return p, m


def _random_columns(seed, m=2000):
    rng = np.random.default_rng(seed)
    i32 = np.iinfo(np.int32)
    pos = rng.integers(-2, 3000, m).astype(np.int32)
    pos[:20] = i32.max - rng.integers(0, 50, 20)        # pos + span wraps
    span = rng.integers(-5, 400, m).astype(np.int32)
    span[20:40] = i32.max - rng.integers(0, 10, 20)
    return {
        "pos": pos, "ref_span": span,
        "ref_id": rng.integers(-2, 4, m).astype(np.int32),
        "flag": rng.integers(0, 1 << 16, m).astype(np.int32),
        "valid": rng.random(m) < 0.9,
    }


INTERVALS = {
    "empty": [(-2, 0, 0)],
    "one": [(0, 100, 2000)],
    "edges": [(0, 500, 500), (1, 0, 1), (2, 2999, 3000), (0, -5, 10)],
    "wide": [(0, 0, 2**31 - 1), (1, 0, 2**31 - 1), (3, 10, 20)],
}


@pytest.mark.parametrize("table", list(INTERVALS))
@pytest.mark.parametrize("flags", [(0, 0), (0x1, 0), (0, 0x400),
                                   (0x41, 0x904), (0xFFFF, 0)])
def test_interval_flag_filter_matches_jax(table, flags):
    cols = _random_columns(seed=len(table) + flags[0])
    ivs = np.array(INTERVALS[table], dtype=np.int32)
    want = np.asarray(jp.interval_flag_filter(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(ivs),
        jnp.int32(flags[0]), jnp.int32(flags[1])))
    got = tp.interval_flag_filter(
        {k: torch.from_numpy(v) for k, v in cols.items()},
        torch.from_numpy(ivs), *flags).numpy()
    np.testing.assert_array_equal(got, want)
    if table != "empty" and flags == (0, 0):
        assert got.any()


def _tag_batch(regions, parse):
    recs = [lc.encode_record(name=b"t%d" % i, tags=r, cigar=((12, 0),))
            for i, r in enumerate(regions)]
    buf = np.frombuffer(b"".join(recs), dtype=np.uint8)
    starts = np.cumsum([0] + [len(r) for r in recs])[:-1].astype(np.int64)
    if parse is jp.parse_flat_records:
        return parse(buf, starts)
    return parse(buf, starts, device="cpu")


def _damaged_regions(seed, k=60):
    """Seeded byte mutants of the edge tag regions: random flips and cuts,
    so walks meet unknown types, bad counts and truncations anywhere."""
    rng = np.random.default_rng(seed)
    base = [r for r in lc.tag_regions().values() if r]
    out = []
    for i in range(k):
        r = bytearray(base[i % len(base)])
        for j in rng.integers(0, len(r), 1 + i % 3):
            r[j] = int(rng.integers(0, 256))
        if i % 4 == 0:
            r = r[: int(rng.integers(0, len(r) + 1))]
        out.append(bytes(r))
    return out


@pytest.mark.parametrize("tags", lc.TAG_FILTERS + (("Xc", "XH", "Xb"),))
@pytest.mark.parametrize("which", ["edge", "damaged"])
def test_tag_presence_mask_matches_jax(tags, which):
    regions = (list(lc.tag_regions().values()) if which == "edge"
               else _damaged_regions(seed=len(tags)))
    want = jl._tag_presence_mask(_tag_batch(regions, jp.parse_flat_records),
                                 tags)
    got = tl._tag_presence_mask(_tag_batch(regions, tp.parse_flat_records),
                                tags)
    np.testing.assert_array_equal(got, want)


def test_tag_walk_stops_at_malformed_entries():
    names = list(lc.tag_regions())
    batch = _tag_batch(list(lc.tag_regions().values()), tp.parse_flat_records)
    nm = dict(zip(names, tl._tag_presence_mask(batch, ("NM",))))
    md = dict(zip(names, tl._tag_presence_mask(batch, ("MD",))))
    every = dict(zip(names, tl._tag_presence_mask(
        batch, ("XA", "Xc", "XC", "Xs", "XS", "Xi", "XI", "Xf", "XZ", "XH",
                "XB", "Xb"))))
    assert every["tags_every_type"] and md["tags_every_type"]
    assert nm["tags_unterminated_z"]
    for bad in ("tags_bad_b_count", "tags_unknown_b_type",
                "tags_unknown_type"):
        assert nm[bad] and not md[bad], bad     # MD sits after the bad entry
    assert md["tags_truncated_i"] and md["tags_stray_bytes"]
    assert not nm["tags_none"]


def _whole(path, parse):
    if parse is jp.parse_flat_records:
        res = jl.record_starts(path)
        return res, parse(res.view.data, res.starts)
    res = tl.record_starts(path, device="cpu")
    return res, parse(res.view.data, res.starts, device="cpu")


@pytest.mark.parametrize("loci", (None,) + lc.LOCI)
def test_apply_filter_matches_jax(corpus, loci):
    path, _ = corpus
    jres, jbatch = _whole(path, jp.parse_flat_records)
    tres, tbatch = _whole(path, tp.parse_flat_records)
    jvalid, tvalid = jbatch.columns["valid"], tbatch.columns["valid"]
    for fr, ff in lc.FLAG_FILTERS + ((0, 0),):
        for tags in (None, ("NM",), ("MD", "NM"), ("XB",)):
            jbatch.columns["valid"] = jvalid.copy()
            tbatch.columns["valid"] = tvalid.copy()
            want = jl._apply_filter(jbatch, jres.header, loci, fr, ff, tags)
            got = tl._apply_filter(tbatch, tres.header, loci, fr, ff, tags,
                                   device="cpu")
            np.testing.assert_array_equal(
                got.columns["valid"], want.columns["valid"],
                err_msg=f"{loci} {fr:#x}/{ff:#x} {tags}")


def test_flag_only_filter_keeps_unmapped(corpus):
    path, _ = corpus
    res, batch = _whole(path, tp.parse_flat_records)
    unmapped = int(((batch.columns["flag"] & 4) != 0).sum())
    out = tl._apply_filter(batch, res.header, None, 0, 0x400)
    kept = out["flag"]
    assert 0 < int(((kept & 4) != 0).sum()) <= unmapped
    assert not (kept & 0x400).any()


def test_bad_tag_names_raise(corpus):
    path, _ = corpus
    res, batch = _whole(path, tp.parse_flat_records)
    for bad in (("N",), ("NMX",), (7,)):
        with pytest.raises(ValueError, match="Bad tag name"):
            tl._apply_filter(batch, res.header, None, 0, 0, bad)


LOCI_STRINGS = [
    "chr1:100-200,chr2,chr3:5k-10k", "chr1:1.5k-2k", "chrM", "chrZ",
    "chrZ:1-100,chr2:100k-200k", "chr1:5000-5000", " chr1:0-1m , ,chrM:0-10",
    "chr1:1g-2g", "chr2,chr2:5-6", "",
]


@pytest.mark.parametrize("s", LOCI_STRINGS)
def test_loci_parse_and_interval_table_match_jax(corpus, s):
    path, _ = corpus
    jh, th = jax_read_header(path), read_header(path)
    assert (tint.LociSet.parse(s).intervals
            == jint.LociSet.parse(s).intervals)
    assert (tint.LociSet.parse(s, th).intervals
            == jint.LociSet.parse(s, jh.contig_lengths).intervals)
    np.testing.assert_array_equal(tl._interval_table(th, s),
                                  jl._interval_table(jh, s))
    loci = tint.LociSet.parse(s, th)
    ref = jint.LociSet.parse(s, jh.contig_lengths)
    for contig in ("chr1", "chr2", "chrM", "chrZ"):
        assert loci.ranges_for(contig) == ref.ranges_for(contig)
        for a, b in ((0, 1), (150, 160), (4999, 5001), (10**9, 2 * 10**9)):
            assert loci.overlaps(contig, a, b) == ref.overlaps(contig, a, b)
    assert bool(loci) == bool(ref)


@pytest.mark.parametrize("s", ["chr1:100", "chr1:200-100", "chr1:-5-10",
                               "chr1:1.5-3", "chr1:1x-2", "chr1:5k-1.0001k",
                               "chr1:a-b"])
def test_bad_loci_raise_as_jax(s):
    with pytest.raises(jint.BadLociError) as want:
        jint.LociSet.parse(s)
    with pytest.raises(tint.BadLociError) as got:
        tint.LociSet.parse(s)
    assert str(got.value) == str(want.value)
    assert issubclass(tint.BadLociError, ValueError)


def test_pos_matches_jax():
    for b, o in ((0, 0), (123_456, 65_535), (2**40, 7)):
        p, q = Pos(b, o), JaxPos(b, o)
        assert (str(p), p.to_htsjdk()) == (str(q), q.to_htsjdk())
        assert Pos.from_htsjdk(q.to_htsjdk()) == tuple(q)


def test_flat_view_tables_match_jax(corpus):
    path, m = corpus
    got, want = flatten_file(path), jax_flatten(path)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.block_starts, want.block_starts)
    np.testing.assert_array_equal(got.block_flat, want.block_flat)
    assert (got.size, got.file_total, got.at_eof) == (
        want.size, want.file_total, want.at_eof)
    flats = np.concatenate([m["starts"], want.block_flat, [0, want.size - 1]])
    for a, b in zip(got.pos_of_flat_many(flats), want.pos_of_flat_many(flats)):
        np.testing.assert_array_equal(a, b)
    for f in flats[::17]:
        assert got.pos_of_flat(int(f)) == want.pos_of_flat(int(f))
        assert got.flat_of_pos(*got.pos_of_flat(int(f))) == int(f)
    with pytest.raises(KeyError):
        got.flat_of_pos(1, 0)
    # The header's uncompressed size is the reference's header end.
    jh = jax_read_header(path)
    assert read_header(path).uncompressed_size == want.flat_of_pos(
        jh.end_pos.block_pos, jh.end_pos.offset)


def test_seekable_stream_reads_what_the_reference_reads(corpus):
    path, m = corpus
    view = flatten_file(path)
    rng = np.random.default_rng(2)
    flats = np.concatenate([m["starts"][::40], view.block_flat,
                            rng.integers(0, view.size, 20)])
    ours = SeekableUncompressedBytes(SeekableBlockStream(open_channel(path)))
    ref = JaxBytes(JaxBlocks(jax_open(path)))
    try:
        for f in flats:
            pos = view.pos_of_flat(int(f))
            n = int(rng.integers(1, 70_000))
            ours.seek(Pos(*pos))
            ref.seek(JaxPos(*pos))
            got, want = ours.read(n), ref.read(n)
            assert got == want
            assert got == bytes(view.data[f: f + n])
    finally:
        ours.close()
        ref.close()
