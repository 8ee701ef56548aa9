"""Device-mesh execution: sharded checking across GPUs and processes
(reference ``spark_bam_tpu/parallel/mesh.py``).

The workload is data-parallel over windows of uncompressed bytes: a step
takes a batch of rows, places them as one contiguous shard of rows per
device this process drives (the ``P(axis)`` placement of the batch
dimension, ``Mesh.shard``), runs the same per-row check on every device,
all devices enqueued before any result is read, and reduces the small
per-row statistics: int32 sums per device, widened to int64 and summed
over the devices on the host side, then ``dist.all_reduce`` (SUM) over the
process group when there is one. Cross-row record chains are the
stream's business: each row carries a trailing halo.

Two levels, as in the reference: one process drives ``n_local`` devices
(``Mesh.devices``; repeats allowed, so ``["cpu"] * 4`` is a 4-entry CPU
mesh and ``["cuda:0"] * 2`` two shards on one card), and
``torch.distributed`` joins ``num_processes`` such processes
(``init_distributed``). The all-reduced tensor lives where the backend
needs it: the process's CUDA device for NCCL, the CPU for gloo.

The step makers (``make_shard_map_*_step``) return callables kept per mesh
by ``MeshSteps`` (``mesh_steps(mesh)``), so repeated calls reuse their
state: the count step's per-device ``checker.make_count_scan`` runners
(on a CUDA device one CUDA graph replay per shard). Their per-row
reductions are plain PyTorch around the check's kernels; the agg step
(``AggStep``) carries the aggregate's reduction over record planes.
"""

from __future__ import annotations

import contextlib
import datetime
import threading
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from spark_bam_tpu_torch.agg.kernels import PLANES, _reduce_chunk
from spark_bam_tpu_torch.check.flags import BIT, FLAG_NAMES
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.tpu.checker import PAD, check_window, make_count_scan
from spark_bam_tpu_torch.tpu.kernels import _compact_mask

BACKENDS = ("nccl", "gloo")
#: Columns of the full step's totals: the head, then one per flag.
FULL_HEAD = ("passes", "bare_eof", "crit", "two", "defer")


@dataclass(frozen=True)
class Mesh:
    """The devices this process drives, in shard order, and its place in
    the process group (``group`` None: one process)."""

    devices: tuple
    num_processes: int = 1
    process_id: int = 0
    group: object = field(default=None, compare=False)
    backend: str | None = None

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def n_global(self) -> int:
        return self.n_local * self.num_processes

    @property
    def reduce_device(self) -> torch.device:
        """Where the all-reduced totals live: the first device for NCCL,
        else the CPU."""
        if self.backend == "nccl":
            return self.devices[0]
        return torch.device("cpu")

    def rows(self, k: int) -> list[slice]:
        """Device ``d``'s rows ``[d·k/n, (d+1)·k/n)`` of a k-row batch."""
        n = self.n_local
        if k % n:
            raise ValueError(f"a {k}-row batch does not split over {n} "
                             f"devices")
        per = k // n
        return [slice(d * per, (d + 1) * per) for d in range(n)]

    def shard(self, batch) -> list[torch.Tensor]:
        """A (k, ...) host array or tensor as one contiguous shard of rows
        per device (the ``P(axis)`` placement)."""
        t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(batch))
        return [t[s].to(dev) for s, dev in zip(self.rows(t.shape[0]),
                                               self.devices)]

    def reduce(self, per_device: list[torch.Tensor]) -> np.ndarray:
        """Per-device int totals summed as int64, then all-reduced (SUM)
        over the process group: a host int64 array, equal on every
        process."""
        dev = self.reduce_device
        total = None
        for t in per_device:
            t = t.to(dev, torch.int64)
            total = t if total is None else total + t
        if self.group is not None:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        return total.cpu().numpy()


def _devices(devices) -> tuple:
    if devices is None:
        resolve_device(None)   # raises without CUDA
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return tuple(out)


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device, and
    without CUDA a ``RuntimeError``; explicit devices are taken as given,
    repeats included). Under an initialized ``torch.distributed`` the mesh
    spans the default group: every process must drive the same number of
    devices, which one ``all_gather`` checks here."""
    devs = _devices(devices)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(devs)
    group = dist.group.WORLD
    backend = str(dist.get_backend(group))
    if backend == "nccl" and devs[0].type != "cuda":
        raise ValueError("the NCCL backend needs a mesh of CUDA devices")
    size = dist.get_world_size(group)
    where = devs[0] if backend == "nccl" else torch.device("cpu")
    mine = torch.tensor([len(devs)], dtype=torch.int64, device=where)
    counts = [torch.zeros_like(mine) for _ in range(size)]
    dist.all_gather(counts, mine, group=group)
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        raise ValueError(f"every process must drive the same number of "
                         f"devices; the processes drive {counts}")
    return Mesh(devs, size, dist.get_rank(group), group, backend)


def local_mesh(devices=None) -> Mesh:
    """A mesh over this process's devices alone, outside any process group
    (a serving loop answering its own requests must not enter another
    process's collectives)."""
    return Mesh(_devices(devices))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     init_file=None,
                     device_type: str | None = None,
                     timeout_s: float = 600.0) -> int:
    """Join ``num_processes`` processes through ``torch.distributed``
    (reference ``init_distributed``, which brings up ``jax.distributed``).

    ``coordinator`` ``HOST:PORT`` is the TCP rendezvous of process 0;
    ``init_file`` a shared ``file://`` store instead. With neither, nothing
    is initialized. ``backend`` defaults to ``"nccl"`` when the mesh will
    be CUDA devices (``device_type``, default: CUDA when available) and to
    ``"gloo"`` for CPU meshes. A bad backend or a failed rendezvous raises.
    Returns the number of processes."""
    if coordinator is None and init_file is None:
        return dist.get_world_size() if dist.is_initialized() else 1
    if coordinator is not None and init_file is not None:
        raise ValueError("give a coordinator or an init file, not both")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs CUDA, which is not "
                           "available here")
    method = (f"tcp://{coordinator}" if coordinator is not None
              else f"file://{init_file}")
    dist.init_process_group(
        backend, init_method=method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()


# ------------------------------------------------------------ row bodies
def _lengths_on(lengths, dev) -> torch.Tensor:
    t = lengths if isinstance(lengths, torch.Tensor) else torch.from_numpy(
        np.asarray(lengths, dtype=np.int32))
    return t.to(dev)


def _col(a) -> list:
    """A per-row scalar column as Python values."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a).tolist()


def _popcount19(fm: torch.Tensor) -> torch.Tensor:
    """Set bits of int32 masks below 2^19 (SWAR, no int32 overflow)."""
    x = fm - ((fm >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF)


def _full_row(row, lengths, nc: int, n: int, at_eof: bool, lo: int,
              own: int, reads_to_check: int, k_positions: int):
    """The full step's ``one`` for one row: ``check_window`` with the full
    pass (funnel off, so every position carries its whole mask), reduced
    over the owned span [lo, own) to ``(totals (24,) int64, crit_idx,
    crit_mask, two_idx, two_mask)``; the four (K,) int32 site lists hold
    window-relative positions in order then -1, and their masks then 0."""
    res = check_window(row, lengths, nc, n, at_eof, reads_to_check,
                       funnel=False)
    fm = res["fail_mask"][lo:own]
    rb = res["reads_before"][lo:own]
    bare = (fm == BIT["tooFewFixedBlockBytes"]) & (rb == 0)
    considered = (fm != 0) & ~bare
    nf = _popcount19(fm) + (rb > 0).int()
    crit = considered & (nf == 1)
    two = considered & (nf == 2)
    defer = (res["escaped"] | ~res["exact"])[lo:own]
    fmc = torch.where(considered, fm, 0)
    totals = torch.stack(
        [(fm == 0).sum(), bare.sum(), crit.sum(), two.sum(), defer.sum()]
        + [((fmc >> b) & 1).sum() for b in range(len(FLAG_NAMES))])
    sites = []
    for mask in (crit, two):
        idx, _ = _compact_mask(mask, k_positions)
        hit = idx >= 0
        at = torch.where(hit, fm[idx.clamp(min=0)], 0)
        sites += [torch.where(hit, idx + lo, -1).int(), at.int()]
    return (totals.long(), *sites)


def _empty_full_row(dev, k_positions: int):
    """A row that owns nothing: zero totals and no sites."""
    fill = torch.full((k_positions,), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros(k_positions, dtype=torch.int32, device=dev)
    return (torch.zeros(len(FULL_HEAD) + len(FLAG_NAMES), dtype=torch.int64,
                        device=dev), fill, zero, fill.clone(), zero.clone())


class _Step:
    """A step over one mesh: per-device row loops, all devices enqueued
    before any result is read (the shared scaffolding of the reference's
    ``_make_sharded_stats_step``)."""

    def __init__(self, mesh: Mesh, reads_to_check: int):
        self.mesh = mesh
        self.reads_to_check = reads_to_check

    def _shards(self, windows, *cols):
        """``(device, rows tensor, per-row columns)`` per device."""
        k = sum(w.shape[0] for w in windows)
        if len(windows) != self.mesh.n_local:
            raise ValueError(f"{len(windows)} shards for a mesh of "
                             f"{self.mesh.n_local} devices")
        cols = [_col(c) for c in cols]
        for c in cols:
            if len(c) != k:
                raise ValueError(f"a column of {len(c)} rows for {k} rows")
        for s, dev, rows in zip(self.mesh.rows(k), self.mesh.devices,
                                windows):
            if rows.device != dev:
                raise ValueError(f"shard on {rows.device}, mesh device {dev}")
            yield dev, rows, [c[s] for c in cols]


class CountStep(_Step):
    """``make_shard_map_count_step``: per step ``[Σ verdict & m, Σ escaped &
    m]`` over the owned spans, by the resident-chunk counter
    (``checker.make_count_scan``: the plain loop on the CPU, one CUDA graph
    replay per shard on a CUDA device)."""

    def __init__(self, mesh: Mesh, reads_to_check: int = 10,
                 funnel: bool = False):
        super().__init__(mesh, reads_to_check)
        self.funnel = funnel
        self.runners: dict = {}

    def runner(self, d: int, window: int):
        key = (d, window)
        if key not in self.runners:
            self.runners[key] = make_count_scan(
                window, self.reads_to_check, self.funnel,
                self.mesh.devices[d])
        return self.runners[key]

    def __call__(self, windows, ns, at_eofs, los, owns, lengths,
                 num_contigs: int) -> np.ndarray:
        outs = []
        shards = self._shards(windows, ns, at_eofs, los, owns)
        for d, (dev, rows, (n, ae, lo, own)) in enumerate(shards):
            k, stride = rows.shape
            run = self.runner(d, stride - PAD)
            # A CUDA graph captures and replays on the current device.
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                r = run(rows.reshape(-1), _lengths_on(lengths, dev),
                        int(num_contigs), np.arange(k) * stride, n, ae, lo,
                        own)
            outs.append(torch.stack([r["count"], r["esc_count"]]))
        return self.mesh.reduce(outs)


class ConfusionStep(_Step):
    """``make_shard_map_confusion_step``: verdicts against the truth rows at
    every owned position, per step ``[tp, fp, fn, escapes]`` (record-scale
    counters; true negatives are the caller's, from its owned spans)."""

    def __init__(self, mesh: Mesh, reads_to_check: int = 10,
                 funnel: bool = False):
        super().__init__(mesh, reads_to_check)
        self.funnel = funnel

    def __call__(self, windows, ns, at_eofs, truth, los, owns, lengths,
                 num_contigs: int) -> np.ndarray:
        outs = []
        shards = self._shards(windows, ns, at_eofs, los, owns)
        for (dev, rows, (n, ae, lo, own)), tr in zip(shards, truth):
            lens = _lengths_on(lengths, dev)
            acc = torch.zeros(4, dtype=torch.int64, device=dev)
            for j in range(rows.shape[0]):
                if own[j] <= lo[j]:
                    continue   # owns nothing: padding rows, header-only rows
                res = check_window(rows[j], lens, int(num_contigs), n[j],
                                   bool(ae[j]), self.reads_to_check,
                                   self.funnel)
                v = res["verdict"][lo[j]:own[j]]
                t = tr[j][lo[j]:own[j]]
                acc += torch.stack([(v & t).sum(), (v & ~t).sum(),
                                    (~v & t).sum(),
                                    res["escaped"][lo[j]:own[j]].sum()])
            outs.append(acc)
        return self.mesh.reduce(outs)


class FullStep(_Step):
    """``make_shard_map_full_step``: every owned position's 19-flag mask
    (the full pass, funnel off) reduced on the device, row by row
    (``_full_row``). Returns ``(totals, crit_idx, crit_mask, two_idx,
    two_mask)``: ``totals`` (24,) int64 ``[passes, bare_eof, crit_ct,
    two_ct, defer_ct, per_flag[0..18]]`` all-reduced; the site lists
    (rows, K) int32 of this process's rows, window-relative (fill -1,
    masks 0). A row with more than K sites under-reports its list against
    its count, which callers detect. Only the totals and the site lists
    leave the devices."""

    def __init__(self, mesh: Mesh, reads_to_check: int = 10,
                 k_positions: int = 4096):
        super().__init__(mesh, reads_to_check)
        self.k_positions = k_positions

    def __call__(self, windows, ns, at_eofs, los, owns, lengths,
                 num_contigs: int):
        K = self.k_positions
        totals, sites = [], []
        shards = self._shards(windows, ns, at_eofs, los, owns)
        for dev, rows, (n, ae, lo, own) in shards:
            lens = _lengths_on(lengths, dev)
            acc = torch.zeros(len(FULL_HEAD) + len(FLAG_NAMES),
                              dtype=torch.int64, device=dev)
            dev_sites = []
            for j in range(rows.shape[0]):
                if own[j] <= lo[j]:
                    out = _empty_full_row(dev, K)
                else:
                    out = _full_row(rows[j], lens, int(num_contigs), n[j],
                                    bool(ae[j]), lo[j], own[j],
                                    self.reads_to_check, K)
                acc += out[0]
                dev_sites.append(torch.stack(out[1:]))
            totals.append(acc)
            sites.append(torch.stack(dev_sites) if dev_sites else
                         torch.empty((0, 4, K), dtype=torch.int32))
        host = torch.cat([s.cpu() for s in sites]).numpy()
        out = self.mesh.reduce(totals)
        return (out, host[:, 0], host[:, 1], host[:, 2], host[:, 3])


class ServeStep(_Step):
    """``make_shard_map_serve_step``: per-row ``(count, escapes)`` over the
    owned spans with no reduction; contig tables per row, so rows of
    different files share a step. A row is one ``check_window`` on its
    device (rows that own nothing are not checked). Returns (k, 2)
    int32."""

    def __init__(self, mesh: Mesh, reads_to_check: int = 10,
                 funnel: bool = False):
        super().__init__(mesh, reads_to_check)
        self.funnel = funnel

    def __call__(self, windows, ns, at_eofs, los, owns, lengths, ncs
                 ) -> np.ndarray:
        k = sum(w.shape[0] for w in windows)
        lengths = (lengths if isinstance(lengths, torch.Tensor)
                   else torch.from_numpy(np.asarray(lengths, np.int32)))
        outs = []
        shards = self._shards(windows, ns, at_eofs, los, owns, ncs)
        for s, (dev, rows, (n, ae, lo, own, nc)) in zip(self.mesh.rows(k),
                                                         shards):
            lens = lengths[s].to(dev)
            pairs = []
            for j in range(rows.shape[0]):
                a = max(lo[j], 0)
                b = max(own[j], a)
                if b == a:
                    # A row that owns nothing (the batcher's padding)
                    # counts nothing: no check.
                    pairs.append(torch.zeros(2, dtype=torch.int64,
                                             device=dev))
                    continue
                res = check_window(rows[j], lens[j], int(nc[j]), n[j],
                                   bool(ae[j]), self.reads_to_check,
                                   self.funnel)
                pairs.append(torch.stack([res["verdict"][a:b].sum(),
                                          res["escaped"][a:b].sum()]))
            outs.append(torch.stack(pairs).int() if pairs else
                        torch.empty((0, 2), dtype=torch.int32, device=dev))
        return torch.cat([o.cpu() for o in outs]).numpy()


class CheckStep(_Step):
    """``make_shard_map_check_step`` (the multi-process worker's step):
    per row ``check_window`` (funnel off) against its truth over the valid
    bytes ``[0, n)``. Returns ``(verdicts, escapes, totals)``: per-device
    (rows, W) bool tensors, and ``[tp, fp, fn, tn, positions]`` int64
    all-reduced."""

    def __call__(self, windows, ns, at_eofs, truth, lengths,
                 num_contigs: int):
        verdicts, escapes, outs = [], [], []
        shards = self._shards(windows, ns, at_eofs)
        for (dev, rows, (n, ae)), tr in zip(shards, truth):
            lens = _lengths_on(lengths, dev)
            w = rows.shape[1] - PAD
            vs, es = [], []
            acc = torch.zeros(5, dtype=torch.int64, device=dev)
            for j in range(rows.shape[0]):
                res = check_window(rows[j], lens, int(num_contigs), n[j],
                                   bool(ae[j]), self.reads_to_check,
                                   funnel=False)
                in_range = torch.arange(w, device=dev) < n[j]
                v = res["verdict"] & in_range
                t = tr[j] & in_range
                # Positions past n are true negatives, as in the reference.
                acc += torch.stack([(v & t).sum(), (v & ~t).sum(),
                                    (~v & t).sum(), (~v & ~t).sum(),
                                    in_range.sum()])
                vs.append(v)
                es.append(res["escaped"] & in_range)
            empty = torch.zeros((0, w), dtype=torch.bool, device=dev)
            verdicts.append(torch.stack(vs) if vs else empty)
            escapes.append(torch.stack(es) if es else empty)
            outs.append(acc)
        return verdicts, escapes, self.mesh.reduce(outs)


class AggStep(_Step):
    """``make_shard_map_agg_step``: the aggregate's carry step over the
    mesh. ``Mesh.shard`` puts each device's contiguous slice of a window's
    padded record planes on that device, each device reduces its slice
    (``agg.kernels._reduce_chunk``, int32), and the deltas, one flat
    vector a device in plan order, are summed through ``Mesh.reduce``
    (all-reduced over the process group). The state is int32 on the host,
    equal in every process (the replicated state); it wraps as the JAX
    package's int32 ``psum`` does, and the caller drains it into int64.
    Under a process group every process steps the same number of times."""

    state_device = torch.device("cpu")

    def __init__(self, mesh: Mesh, plan, nc: int):
        super().__init__(mesh, 0)
        self.plan = plan
        self.nc = nc
        self.lengths = [spec.length(nc) for spec in plan.specs]

    def __call__(self, state: dict, planes: dict) -> dict:
        names = [spec.name for spec in self.plan.specs]
        shards = [self.mesh.shard(planes[k]) for k in PLANES]
        outs = []
        for d in range(self.mesh.n_local):
            delta = _reduce_chunk(self.plan, self.nc,
                                  {k: sh[d] for k, sh in zip(PLANES, shards)})
            outs.append(torch.cat([delta[k] for k in names]))
        total = torch.from_numpy(self.mesh.reduce(outs)).to(torch.int32)
        return {k: state[k] + t
                for k, t in zip(names, total.split(self.lengths))}


def make_shard_map_count_step(mesh: Mesh, reads_to_check: int = 10,
                              funnel: bool = False) -> CountStep:
    return CountStep(mesh, reads_to_check, funnel)


def make_shard_map_confusion_step(mesh: Mesh, reads_to_check: int = 10,
                                  funnel: bool = False) -> ConfusionStep:
    return ConfusionStep(mesh, reads_to_check, funnel)


def make_shard_map_full_step(mesh: Mesh, reads_to_check: int = 10,
                             k_positions: int = 4096) -> FullStep:
    return FullStep(mesh, reads_to_check, k_positions)


def make_shard_map_serve_step(mesh: Mesh, reads_to_check: int = 10,
                              funnel: bool = False) -> ServeStep:
    return ServeStep(mesh, reads_to_check, funnel)


def make_shard_map_check_step(mesh: Mesh, reads_to_check: int = 10
                              ) -> CheckStep:
    return CheckStep(mesh, reads_to_check)


def make_shard_map_agg_step(mesh: Mesh, plan, nc: int) -> AggStep:
    return AggStep(mesh, plan, nc)


def sharded_check_step(windows, ns, at_eofs, truth, lengths, num_contigs,
                       reads_to_check: int = 10, mesh: Mesh | None = None):
    """One sharded unit of work over per-device row shards (``mesh``
    defaults to one process over the shards' devices): ``(verdicts,
    escapes, stats)``, the per-device (rows, W) verdicts and escapes over
    the valid bytes and the reduced confusion stats."""
    if mesh is None:
        mesh = Mesh(tuple(w.device for w in windows))
    verdicts, escapes, t = CheckStep(mesh, reads_to_check)(
        windows, ns, at_eofs, truth, lengths, num_contigs)
    names = ("true_positives", "false_positives", "false_negatives",
             "true_negatives", "positions")
    return verdicts, escapes, {k: int(v) for k, v in zip(names, t)}


class MeshSteps:
    """The steps of one mesh, built once per static parameter set and
    reused for the mesh's lifetime (the count step keeps its CUDA graphs).
    Thread-safe."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._steps: dict = {}
        self._lock = threading.Lock()

    def put(self, arr) -> list[torch.Tensor]:
        """Place a batch-dim array as per-device row shards."""
        return self.mesh.shard(arr)

    def _get(self, key, maker):
        with self._lock:
            step = self._steps.get(key)
            if step is None:
                step = self._steps[key] = maker()
            return step

    def count_step(self, reads_to_check: int = 10, funnel: bool = False):
        return self._get(("count", reads_to_check, funnel),
                         lambda: make_shard_map_count_step(
                             self.mesh, reads_to_check, funnel))

    def confusion_step(self, reads_to_check: int = 10, funnel: bool = False):
        return self._get(("confusion", reads_to_check, funnel),
                         lambda: make_shard_map_confusion_step(
                             self.mesh, reads_to_check, funnel))

    def full_step(self, reads_to_check: int = 10, k_positions: int = 4096):
        return self._get(("full", reads_to_check, k_positions),
                         lambda: make_shard_map_full_step(
                             self.mesh, reads_to_check, k_positions))

    def serve_step(self, reads_to_check: int = 10, funnel: bool = False):
        return self._get(("serve", reads_to_check, funnel),
                         lambda: make_shard_map_serve_step(
                             self.mesh, reads_to_check, funnel))

    def check_step(self, reads_to_check: int = 10):
        return self._get(("check", reads_to_check),
                         lambda: make_shard_map_check_step(
                             self.mesh, reads_to_check))

    def agg_step(self, plan, nc: int):
        """The aggregate's carry step for one (plan, contig count); the
        plan is a frozen ``AggConfig`` and hashes into the key."""
        return self._get(("agg", plan, nc),
                         lambda: make_shard_map_agg_step(self.mesh, plan, nc))


_mesh_steps: dict = {}
_mesh_steps_lock = threading.Lock()


def mesh_steps(mesh: Mesh) -> MeshSteps:
    """The process-wide ``MeshSteps`` of ``mesh``: every workload shares
    the same steps instead of rebuilding them per call."""
    key = (mesh, id(mesh.group))
    with _mesh_steps_lock:
        st = _mesh_steps.get(key)
        if st is None:
            st = _mesh_steps[key] = MeshSteps(mesh)
        return st


def release_mesh_steps(group) -> None:
    """Forget the cached steps of every mesh over ``group``: after this
    (and ``dist.destroy_process_group``) the process group lives only as
    long as the caller's own meshes do."""
    with _mesh_steps_lock:
        for key in [k for k, st in _mesh_steps.items()
                    if st.mesh.group is group]:
            del _mesh_steps[key]


def batch_windows(buf: np.ndarray, window: int, halo: int, batch: int,
                  at_eof: bool = True, truth: np.ndarray | None = None):
    """Cut a flat buffer into a (B, W + PAD) batch of overlapping windows.

    Each window's trailing ``halo`` lets chains started in its owned span
    complete; ownership spans tile the buffer exactly. Returns (windows,
    ns, at_eofs, owned ranges, truth windows)."""
    n_total = len(buf)
    step = max(window - halo, 1)
    starts = list(range(0, max(n_total, 1), step))
    starts = [s for s in starts if s == 0 or s < n_total]
    b = max(batch, len(starts))
    ws = np.zeros((b, window + PAD), dtype=np.uint8)
    ns = np.zeros(b, dtype=np.int32)
    eofs = np.zeros(b, dtype=bool)
    owned = []
    tr = np.zeros((b, window), dtype=bool)
    for i, s in enumerate(starts):
        e = min(s + window, n_total)
        ws[i, : e - s] = buf[s:e]
        ns[i] = e - s
        eofs[i] = at_eof and e == n_total
        own_end = e if e == n_total else min(s + step, n_total)
        owned.append((s, own_end))
        if truth is not None:
            tr[i, : e - s] = truth[s:e]
        if e == n_total:
            break
    return ws, ns, eofs, owned, tr
