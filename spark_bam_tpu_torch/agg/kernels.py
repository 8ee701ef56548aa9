"""The aggregation reduction over the parser's flat planes (the JAX
package's ``spark_bam_tpu/agg/kernels.py``), in plain PyTorch.

Each metric of an :class:`~spark_bam_tpu_torch.agg.plan.AggConfig` is a
masked sum or an int32 scatter-add (``index_add_``) over the parsed record
planes (``flag``, ``mapq``, ``tlen``, ``l_seq``, ``pos``, ``ref_span``,
``ref_id``, masked by ``valid``), a window of ``chunk`` records at a time,
with the int32 carry kept on the device between windows. The filters ran
before this (``load.tpu_load._apply_filter`` narrows ``valid``), so the
reduction reads only the mask.

Overflow discipline: the device state is int32, and
:func:`aggregate_planes` drains the carry into host int64 totals every
``_FLUSH_RECORDS`` records (at most 2^30 bases accumulate between flushes
at ≤ 512 b mean read length). The wire result is int64 (``agg/plan.py``).

Every scatter index is clamped into its vector, so inactive lanes (padding,
unmapped reads at ``pos`` -1) add 0 in range: an out-of-range index raises
in PyTorch where XLA drops the update. ``|tlen|`` and the coverage bucket
arithmetic are int64, so ``tlen`` = -2^31 lands in the overflow bucket and
a read ending past 2^31 keeps its bases, as the int64 oracle
(``agg/host.py``) has them.

Two execution shapes share ``_reduce_chunk``: the plain carry step
(:func:`update_fn`) on one device, and the mesh's agg step
(``parallel.mesh.make_shard_map_agg_step``), which reduces each device's
slice and sums the deltas through ``Mesh.reduce``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spark_bam_tpu_torch.agg.plan import FLAG_BITS, AggConfig
from spark_bam_tpu_torch.device import resolve_device

#: Planes a reduction reads, in the order every step takes them.
PLANES = ("valid", "flag", "mapq", "tlen", "l_seq", "pos", "ref_span",
          "ref_id")

#: Default records per device window (a power of two: at most log2
#: distinct window shapes across files).
DEFAULT_CHUNK = 1 << 16

#: Host-flush interval, in records: ≤ 2^30 bases accumulate in the int32
#: carry between flushes at ≤ 512 b mean reads.
_FLUSH_RECORDS = 1 << 21


def state_zeros(plan: AggConfig, nc: int) -> "dict[str, np.ndarray]":
    """Fresh int32 carry for one reduction pass."""
    return {
        spec.name: np.zeros(spec.length(nc), dtype=np.int32)
        for spec in plan.specs
    }


def _state_on(plan: AggConfig, nc: int, dev) -> "dict[str, torch.Tensor]":
    return {k: torch.from_numpy(v).to(dev)
            for k, v in state_zeros(plan, nc).items()}


def _histogram(n: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """(n,) int32: ``val`` added at ``idx`` (every index in [0, n))."""
    out = torch.zeros(n, dtype=torch.int32, device=val.device)
    return out.index_add_(0, idx, val)


def _reduce_chunk(plan: AggConfig, nc: int, planes: dict) -> dict:
    """One window's partial vectors (int32): the core shared by the plain
    carry step and the mesh's agg step."""
    valid = planes["valid"].int()
    flag = planes["flag"]
    out: dict = {}
    for spec in plan.specs:
        if spec.name == "count":
            mapped = valid * ((flag & 4) == 0).int()
            out["count"] = torch.stack([
                valid.sum(dtype=torch.int32), mapped.sum(dtype=torch.int32),
                (valid * planes["l_seq"]).sum(dtype=torch.int32)])
        elif spec.name == "flagstat":
            shifts = torch.arange(len(FLAG_BITS), device=flag.device)
            per_bit = ((flag[:, None] >> shifts) & 1).int() * valid[:, None]
            out["flagstat"] = torch.cat([
                valid.sum(dtype=torch.int32)[None],
                per_bit.sum(0, dtype=torch.int32)])
        elif spec.name == "mapq":
            idx = planes["mapq"].long().clamp(0, 255)
            out["mapq"] = _histogram(256, idx, valid)
        elif spec.name == "tlen":
            mx = spec.get("max")
            idx = planes["tlen"].long().abs().clamp(max=mx + 1)
            out["tlen"] = _histogram(mx + 2, idx, valid)
        elif spec.name == "coverage":
            out["coverage"] = _coverage_chunk(spec, nc, planes, valid)
    return out


def _coverage_chunk(spec, nc: int, planes: dict,
                    valid: torch.Tensor) -> torch.Tensor:
    """Segment sum of [pos, pos + span) intervals into per-contig buckets:
    a ``cap``-step walk over the buckets each read touches, each step one
    masked scatter-add (the wire contract's clamps: last-bucket collapse,
    ``cap``-bucket truncation; ``agg/plan.py``). The bounds are int64."""
    B, bins, cap = spec.get("bin"), spec.get("bins"), spec.get("cap")
    if nc == 0:
        return torch.zeros(0, dtype=torch.int32, device=valid.device)
    ref = planes["ref_id"].long()
    s = planes["pos"].long()
    flag = planes["flag"]
    e = s + planes["ref_span"].long().clamp(min=1)
    use = ((valid > 0) & ((flag & 4) == 0) & (ref >= 0) & (ref < nc)
           & (s >= 0))
    sb = torch.div(s, B, rounding_mode="floor").clamp(max=bins - 1)
    eb = torch.minimum(
        torch.div(e - 1, B, rounding_mode="floor").clamp(max=bins - 1),
        sb + cap - 1)
    base = ref.clamp(0, nc - 1) * bins
    cov = torch.zeros(nc * bins, dtype=torch.int32, device=valid.device)
    for j in range(cap):
        k = sb + j
        lo = torch.maximum(s, k * B)
        hi = torch.where(k == bins - 1, e, torch.minimum(e, (k + 1) * B))
        ov = torch.where(use & (k <= eb), (hi - lo).clamp(min=0), 0)
        cov.index_add_(0, base + k.clamp(0, bins - 1), ov.int())
    return cov


@functools.lru_cache(maxsize=64)
def update_fn(plan: AggConfig, nc: int):
    """The plain carry step ``state' = state + reduce(planes)`` (int32,
    wrapping as the JAX package's does), cached per (plan, nc)."""

    def update(state: dict, planes: dict) -> dict:
        delta = _reduce_chunk(plan, nc, planes)
        return {k: state[k] + delta[k] for k in state}

    return update


def _pad_planes(columns: dict, lo: int, hi: int, multiple: int) -> dict:
    """Records [lo, hi) of each plane, padded with ``valid=False`` rows to
    a power of two and to at least ``multiple`` (the mesh's device
    count), so a step sees at most log2 distinct shapes."""
    m = hi - lo
    m_pad = max(1 << max(0, (max(m, 1) - 1).bit_length()), multiple)
    out = {}
    for name in PLANES:
        col = np.asarray(columns[name])
        pad = np.zeros(m_pad, dtype=bool if name == "valid" else np.int32)
        pad[:m] = col[lo:hi]
        out[name] = pad
    return out


def aggregate_planes(
    columns: "dict[str, np.ndarray]",
    plan: AggConfig,
    nc: int,
    *,
    steps=None,
    chunk: "int | None" = None,
    device=None,
) -> "dict[str, np.ndarray]":
    """Reduce flat planes to the plan's int64 vectors on the device.

    ``steps`` is a ``parallel.mesh.MeshSteps``: when given, each window
    goes through its agg step, sharded over the mesh's devices; otherwise
    the plain carry runs on ``device`` (default: the current CUDA device,
    raising without one; ``"cpu"`` runs on the CPU). ``chunk`` bounds the
    records per window. Returns metric name → int64 vector, equal to the
    int64 oracle's (``agg/host.py``)."""
    m = len(columns["valid"])
    chunk = int(chunk or DEFAULT_CHUNK)
    if chunk < 1:
        raise ValueError(f"agg chunk must be >= 1: {chunk}")
    if steps is not None:
        step = steps.agg_step(plan, nc)
        multiple = steps.mesh.n_local
        dev = step.state_device
    else:
        step = update_fn(plan, nc)
        multiple = 1
        dev = resolve_device(device)
    totals = {
        spec.name: np.zeros(spec.length(nc), dtype=np.int64)
        for spec in plan.specs
    }

    def drain(state):
        for k, v in state.items():
            totals[k] += v.cpu().numpy().astype(np.int64)

    state = _state_on(plan, nc, dev)
    since_flush = 0
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        planes = _pad_planes(columns, lo, hi, multiple)
        if steps is None:
            planes = {k: torch.from_numpy(v).to(dev)
                      for k, v in planes.items()}
        state = step(state, planes)       # device-to-device carry
        since_flush += hi - lo
        if since_flush >= _FLUSH_RECORDS:
            drain(state)
            state = _state_on(plan, nc, dev)
            since_flush = 0
    drain(state)
    return totals
