"""The int64 oracle of the aggregation plane (the JAX package's
``spark_bam_tpu/agg/host.py``).

An independent implementation of every metric in ``agg/plan.py``, written
against the wire contract (vector layouts, clamps) rather than sharing
code with the device reduction, so the checks compare two derivations of
one definition. All arithmetic is int64 end to end: the oracle has no
overflow discipline to manage, which is why it is the truth the int32
device carry is held to. ``load.api.aggregate`` never calls it; it is no
fallback. ``columns_from_records`` bridges records to its planes, so the
record loaders' ``Dataset.aggregate`` reduces through it.
"""

from __future__ import annotations

import numpy as np

from spark_bam_tpu_torch.agg.plan import FLAG_BITS, AggConfig


def host_aggregate(
    columns: "dict[str, np.ndarray]", plan: AggConfig, nc: int,
) -> "dict[str, np.ndarray]":
    """Reduce parser flat planes (numpy arrays, ``valid`` already
    narrowed by any filter) to the plan's int64 vectors. ``columns``
    needs ``valid`` plus whichever planes the plan's metrics read
    (``flag``, ``mapq``, ``tlen``, ``l_seq``, ``pos``, ``ref_span``,
    ``ref_id``)."""
    valid = np.asarray(columns["valid"], dtype=bool)
    out: "dict[str, np.ndarray]" = {}
    for spec in plan.specs:
        if spec.name == "count":
            flag = np.asarray(columns["flag"], dtype=np.int64)[valid]
            lseq = np.asarray(columns["l_seq"], dtype=np.int64)[valid]
            out["count"] = np.array(
                [valid.sum(), int((flag & 4 == 0).sum()), int(lseq.sum())],
                dtype=np.int64,
            )
        elif spec.name == "flagstat":
            flag = np.asarray(columns["flag"], dtype=np.int64)[valid]
            vec = np.zeros(1 + len(FLAG_BITS), dtype=np.int64)
            vec[0] = len(flag)
            for i, bit in enumerate(FLAG_BITS):
                vec[1 + i] = int((flag & bit != 0).sum())
            out["flagstat"] = vec
        elif spec.name == "mapq":
            mapq = np.asarray(columns["mapq"], dtype=np.int64)[valid]
            out["mapq"] = np.bincount(
                np.clip(mapq, 0, 255), minlength=256
            ).astype(np.int64)
        elif spec.name == "tlen":
            mx = spec.get("max")
            tlen = np.abs(np.asarray(columns["tlen"], dtype=np.int64)[valid])
            out["tlen"] = np.bincount(
                np.minimum(tlen, mx + 1), minlength=mx + 2
            ).astype(np.int64)
        elif spec.name == "coverage":
            out["coverage"] = _host_coverage(columns, spec, nc, valid)
    return out


def _host_coverage(columns, spec, nc: int, valid) -> np.ndarray:
    """Per-contig binned base depth: the per-record bucket walk, applying
    the wire contract's clamps (last-bucket collapse, ``cap``-bucket
    truncation) literally."""
    B, bins, cap = spec.get("bin"), spec.get("bins"), spec.get("cap")
    ref = np.asarray(columns["ref_id"], dtype=np.int64)
    pos = np.asarray(columns["pos"], dtype=np.int64)
    span = np.maximum(np.asarray(columns["ref_span"], dtype=np.int64), 1)
    flag = np.asarray(columns["flag"], dtype=np.int64)
    use = valid & (flag & 4 == 0) & (ref >= 0) & (ref < nc) & (pos >= 0)
    cov = np.zeros((nc, bins), dtype=np.int64)
    idx = np.flatnonzero(use)
    for r, s, n in zip(ref[idx].tolist(), pos[idx].tolist(),
                       span[idx].tolist()):
        e = s + n
        sb = min(s // B, bins - 1)
        eb = min(min((e - 1) // B, bins - 1), sb + cap - 1)
        row = cov[r]
        for k in range(sb, eb + 1):
            lo = max(s, k * B)
            hi = e if k == bins - 1 else min(e, (k + 1) * B)
            if hi > lo:
                row[k] += hi - lo
    return cov.reshape(-1)


#: CIGAR op codes that consume reference bases: M, D, N, =, X, the set
#: the device parser folds into ``ref_span`` (tpu/parser.py).
_REF_CONSUMING = {0, 2, 3, 7, 8}


def record_ref_span(rec) -> int:
    """Reference span of one ``BamRecord``: the cigar lengths over the
    ref-consuming ops, as the parser's ``ref_span`` plane holds it."""
    return sum(n for n, op in (rec.cigar or []) if op in _REF_CONSUMING)


def columns_from_records(records) -> "dict[str, np.ndarray]":
    """Flat-plane columns of an iterable of ``BamRecord``s (or tuples
    whose last element is one, the ``(Pos, record)`` load shape)."""
    flag, mapq, tlen, lseq, pos, span, ref = [], [], [], [], [], [], []
    for rec in records:
        if isinstance(rec, tuple):
            rec = rec[-1]
        flag.append(int(rec.flag))
        mapq.append(int(rec.mapq))
        tlen.append(int(rec.tlen))
        lseq.append(len(rec.seq) if rec.seq and rec.seq != "*" else 0)
        pos.append(int(rec.pos))
        span.append(record_ref_span(rec))
        ref.append(int(rec.ref_id))
    n = len(flag)
    return {
        "valid": np.ones(n, dtype=bool),
        "flag": np.asarray(flag, dtype=np.int32),
        "mapq": np.asarray(mapq, dtype=np.int32),
        "tlen": np.asarray(tlen, dtype=np.int32),
        "l_seq": np.asarray(lseq, dtype=np.int32),
        "pos": np.asarray(pos, dtype=np.int32),
        "ref_span": np.asarray(span, dtype=np.int32),
        "ref_id": np.asarray(ref, dtype=np.int32),
    }


def combine(
    parts: "list[dict[str, np.ndarray]]", plan: AggConfig, nc: int,
) -> "dict[str, np.ndarray]":
    """Sum per-partition partial vectors: every metric is a pure sum, so
    the order of the parts does not matter. A ``None`` part (a partition
    that produced nothing) is skipped."""
    out = {
        spec.name: np.zeros(spec.length(nc), dtype=np.int64)
        for spec in plan.specs
    }
    for part in parts:
        if part is None:
            continue
        for name, vec in part.items():
            out[name] += np.asarray(vec, dtype=np.int64).ravel()
    return out
