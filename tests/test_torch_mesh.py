"""The port's mesh steps against the JAX package's, exactly.

One ``batch_windows`` batch of eight 64 KiB windows (16 KiB halo) cut
from a random BAM's flat stream, the first owning from the header on,
goes through each JAX step on ``jax.devices()[:n]`` (``flags_impl="xla"``)
and through the port's step on ``make_mesh(["cpu"] * n)``: the count,
confusion, full (all five outputs, at K = 4,096 and at a K that
overflows), serve and check steps, at n = 1, 2, 4 and 8 devices,
``reads_to_check`` 1 and 10 and both funnel forms where the step takes
them. Each JAX step compiles once per case, so the cases are a spread
over those axes rather than their product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_bam_tpu.parallel import mesh as jmesh
from spark_bam_tpu_torch import Config, Mesh, make_mesh
from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bam.index_records import record_start_flats
from spark_bam_tpu_torch.bgzf.flat import flatten_file
from spark_bam_tpu_torch.parallel import mesh as pmesh
from spark_bam_tpu_torch.parallel.stream_mesh import _step_rows
from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths
from tests.bam_factories import random_bam
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, HALO, ROWS = 1 << 16, 16 << 10, 8


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """``(windows, ns, at_eofs, los, owns, truth, lengths, num_contigs)``
    of eight windows; row 0's owned span starts at the header's end. Some
    records get a position past their contig's end, so that positions where
    exactly one check fails (critical sites) exist."""
    p = tmp_path_factory.mktemp("torch_mesh") / "m.bam"
    random_bam(p, seed=3, n_records=(200, 400), read_len=(10, 6000),
               mapped_rate=0.7)
    flat = flatten_file(p).data
    truth = np.zeros(len(flat), dtype=bool)
    starts = record_start_flats(p)
    truth[starts] = True
    for at in starts[5::17]:
        flat[at + 8: at + 12] = (0x7F, 0xFF, 0xFF, 0x7F)   # ref pos 2^31 - 129
    step = W - HALO
    cut = ROWS * step - 1000
    ws, ns, eofs, owned, tr = jmesh.batch_windows(
        flat[:cut], W, HALO, ROWS, at_eof=False, truth=truth[:cut])
    assert ws.shape[0] == len(owned) == ROWS
    owns = np.array([e - s for s, e in owned], dtype=np.int32)
    los = np.zeros(ROWS, dtype=np.int32)
    header = read_header(p)
    los[0] = header.uncompressed_size
    lens = pad_contig_lengths(header.contig_lengths)
    return ws, ns, eofs, los, owns, tr, lens, len(header.contig_lengths)


def _jax_args(n, *arrays):
    mesh = jmesh.make_mesh(jax.devices()[:n])
    shard = NamedSharding(mesh, P("data"))
    return mesh, [jax.device_put(a, shard) for a in arrays]


def _repl(mesh, a):
    return jax.device_put(a, NamedSharding(mesh, P()))


@pytest.mark.parametrize("n,rtc,funnel", [
    (1, 10, False), (2, 1, True), (4, 1, False), (8, 10, False)])
def test_count_step_matches_jax(batch, n, rtc, funnel):
    ws, ns, eofs, los, owns, _, lens, nc = batch
    jm, args = _jax_args(n, ws, ns, eofs, los, owns)
    want = np.asarray(jmesh.make_shard_map_count_step(
        jm, rtc, flags_impl="xla", funnel=funnel)(
            *args, _repl(jm, lens), jnp.int32(nc)))
    mesh = make_mesh(["cpu"] * n)
    got = pmesh.make_shard_map_count_step(mesh, rtc, funnel)(
        mesh.shard(ws), ns, eofs, los, owns, lens, nc)
    assert got.dtype == np.int64 and got.tolist() == want.tolist()
    assert got[0] > 0


@pytest.mark.parametrize("n,rtc,funnel", [
    (1, 1, True), (2, 10, False), (8, 1, False)])
def test_confusion_step_matches_jax(batch, n, rtc, funnel):
    ws, ns, eofs, los, owns, tr, lens, nc = batch
    jm, args = _jax_args(n, ws, ns, eofs, tr, los, owns)
    want = np.asarray(jmesh.make_shard_map_confusion_step(
        jm, rtc, flags_impl="xla", funnel=funnel)(
            *args, _repl(jm, lens), jnp.int32(nc)))
    mesh = make_mesh(["cpu"] * n)
    got = pmesh.make_shard_map_confusion_step(mesh, rtc, funnel)(
        mesh.shard(ws), ns, eofs, mesh.shard(tr), los, owns, lens, nc)
    assert got.tolist() == want.tolist()
    assert got[0] > 0


@pytest.mark.parametrize("n,rtc,k", [
    (1, 10, 4096), (2, 1, 8), (4, 10, 8), (8, 1, 4096)])
def test_full_step_matches_jax(batch, n, rtc, k):
    ws, ns, eofs, los, owns, _, lens, nc = batch
    jm, args = _jax_args(n, ws, ns, eofs, los, owns)
    want = [np.asarray(a) for a in jmesh.make_shard_map_full_step(
        jm, rtc, flags_impl="xla", k_positions=k)(
            *args, _repl(jm, lens), jnp.int32(nc))]
    mesh = make_mesh(["cpu"] * n)
    got = pmesh.make_shard_map_full_step(mesh, rtc, k)(
        mesh.shard(ws), ns, eofs, los, owns, lens, nc)
    assert got[0].tolist() == want[0].tolist()
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == np.int32 and g.shape == (ROWS, k)
        assert np.array_equal(g, w.astype(np.int32))
    two_ct = int(want[0][3])
    assert two_ct > 0 and int(want[0][2]) > 0
    listed = int((got[3] >= 0).sum())
    # At K = 8 a row's list overflows: fewer listed than counted.
    assert (listed < two_ct) == (k == 8)


@pytest.mark.parametrize("n,rtc,funnel", [(2, 10, False), (4, 1, True)])
def test_serve_step_matches_jax(batch, n, rtc, funnel):
    ws, ns, eofs, los, owns, _, lens, nc = batch
    per_row_lens = np.tile(lens, (ROWS, 1))
    per_row_lens[1::2, 0] = 1000   # rows of another file's contig table
    ncs = np.full(ROWS, nc, dtype=np.int32)
    jm, args = _jax_args(n, ws, ns, eofs, los, owns, per_row_lens, ncs)
    want = np.asarray(jmesh.make_shard_map_serve_step(
        jm, rtc, flags_impl="xla", funnel=funnel)(*args))
    mesh = make_mesh(["cpu"] * n)
    got = pmesh.make_shard_map_serve_step(mesh, rtc, funnel)(
        mesh.shard(ws), ns, eofs, los, owns, per_row_lens, ncs)
    assert got.shape == (ROWS, 2) and np.array_equal(got, want)


def test_sharded_check_step_matches_jax(batch):
    ws, ns, eofs, _, _, tr, lens, nc = batch
    jm, args = _jax_args(8, ws, ns, eofs, tr)
    v, e, stats = jmesh.sharded_check_step(
        *args, _repl(jm, lens), jnp.int32(nc), reads_to_check=10)
    mesh = make_mesh(["cpu"] * 8)
    gv, ge, gstats = pmesh.sharded_check_step(
        mesh.shard(ws), ns, eofs, mesh.shard(tr), lens, nc, 10, mesh)
    assert gstats == {k: int(x) for k, x in stats.items()}
    assert np.array_equal(torch.cat(gv).numpy(), np.asarray(v))
    assert np.array_equal(torch.cat(ge).numpy(), np.asarray(e))


def test_check_step_matches_jax(batch):
    ws, ns, eofs, _, _, tr, lens, nc = batch
    jm, args = _jax_args(2, ws, ns, eofs, tr)
    v, totals = jmesh.make_shard_map_check_step(jm, 1)(
        *args, _repl(jm, lens), jnp.int32(nc))
    mesh = make_mesh(["cpu"] * 2)
    gv, _, got = pmesh.make_shard_map_check_step(mesh, 1)(
        mesh.shard(ws), ns, eofs, mesh.shard(tr), lens, nc)
    assert got.tolist() == np.asarray(totals).tolist()
    assert np.array_equal(torch.cat(gv).numpy(), np.asarray(v))


def test_mesh_steps_one_object_per_key():
    mesh = make_mesh(["cpu"] * 2)
    st = pmesh.mesh_steps(mesh)
    assert pmesh.mesh_steps(make_mesh(["cpu"] * 2)) is st
    assert pmesh.mesh_steps(make_mesh(["cpu"] * 4)) is not st
    assert st.count_step(10, True) is st.count_step(10, True)
    assert st.count_step(10, True) is not st.count_step(10, False)
    assert st.full_step(10, 16) is not st.full_step(10, 4096)
    for name in ("confusion_step", "serve_step", "check_step"):
        assert getattr(st, name)() is getattr(st, name)()
    shards = st.put(np.arange(8).reshape(4, 2))
    assert [s.tolist() for s in shards] == [[[0, 1], [2, 3]], [[4, 5],
                                                               [6, 7]]]


def test_mesh_layout():
    mesh = make_mesh(["cpu"] * 4)
    assert (mesh.n_local, mesh.n_global, mesh.num_processes) == (4, 4, 1)
    assert mesh.reduce_device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard(np.zeros((6, 3)))
    assert mesh.reduce([torch.tensor([1, 2], dtype=torch.int32)] * 4
                       ).tolist() == [4, 8]


def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.local_mesh()


def test_init_distributed_refuses_bad_backends():
    assert pmesh.init_distributed() == 1   # nothing asked: one process
    with pytest.raises(ValueError, match="backend"):
        pmesh.init_distributed(init_file="/nonexistent/x", backend="mpi")
    with pytest.raises(ValueError, match="not both"):
        pmesh.init_distributed("localhost:1", init_file="/nonexistent/x")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            pmesh.init_distributed(init_file="/nonexistent/x",
                                   backend="nccl")


def test_step_positions_stay_int32():
    """A step's positions stay below 2^31 at the default geometry for any
    device count (the reference's argument for int32 per-step totals);
    the port widens every device's sums to int64 before adding them."""
    cfg = Config()
    kw = 1 << (cfg.window_size + cfg.halo_size + 2 * (64 << 10) - 1
               ).bit_length()
    assert kw == 32 << 20
    for n_local in (1, 2, 4, 8, 64):
        rows = _step_rows(kw, n_local, 192 << 20)
        assert rows % n_local == 0
        per_device = rows // n_local
        assert per_device * kw < 1 << 31
        if n_local <= 4:
            assert rows * kw < 1 << 31


def test_mesh_is_a_value():
    a, b = make_mesh(["cpu", "cpu"]), Mesh((torch.device("cpu"),) * 2)
    assert a == b and hash(a) == hash(b)
