"""Aggregation specs and the typed result schema (the JAX package's
``spark_bam_tpu/agg/plan.py``, numpy only).

The ``AggSpec`` grammar is a compact string spec (``Config.agg`` /
``--agg``): ``metric[:k=v,...]`` entries joined by ``;`` —

    coverage:bin=1000,bins=512,cap=16;flagstat;mapq;tlen:max=2000;count

Metrics (every result vector is int64; the layouts below are the wire
contract, which the device reduction (``agg/kernels.py``) and the int64
oracle (``agg/host.py``) both produce):

``count``     ``[records, mapped, bases]``: valid records, records with
              the unmapped bit (0x4) clear, and Σ ``l_seq``.
``flagstat``  13 entries: total valid records, then one count per SAM
              flag bit 0x1..0x800.
``mapq``      256-bucket histogram of MAPQ (one bucket per value).
``tlen``      ``max+2`` buckets of \\|tlen\\|: bucket ``i`` counts
              records with \\|tlen\\| == i for i ≤ max; the final bucket
              collapses everything beyond ``max``.
``coverage``  per-contig binned base depth, shape ``(ncontigs, bins)``
              flattened row-major. A record covering reference span
              ``[pos, pos+max(ref_span,1))`` adds its per-bucket overlap
              (in bases) to buckets of width ``bin``; buckets at or past
              ``bins-1`` collapse into the last bucket, and a single
              record contributes to at most ``cap`` consecutive buckets
              (spans beyond that are truncated). Only mapped records with
              a contig in range contribute.

A result serializes as one small JSON directory (name, params, element
offset/length/shape per metric, and the contig dictionary) and one binary
payload, the concatenated little-endian int64 vectors.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

#: SAM flag bits, flagstat order (0x1 paired .. 0x800 supplementary).
FLAG_BITS = tuple(1 << b for b in range(12))

#: metric name → (param name → default). Unknown names/params are
#: ValueError at parse time, so a typo fails before any device work.
METRICS: "dict[str, dict[str, int]]" = {
    "count": {},
    "flagstat": {},
    "mapq": {},
    "tlen": {"max": 2000},
    "coverage": {"bin": 1000, "bins": 512, "cap": 16},
}

#: What an empty spec ("" / unset Config.agg) means: every metric at
#: defaults, in this canonical order.
DEFAULT_SPEC = "count;flagstat;mapq;tlen;coverage"


@dataclass(frozen=True)
class AggSpec:
    """One parsed ``metric[:params]`` entry. ``params`` is a sorted
    tuple of (key, value) pairs so the spec stays hashable: the
    ``MeshSteps`` registry keys its agg steps by the plan."""

    name: str
    params: "tuple[tuple[str, int], ...]" = ()

    def get(self, key: str) -> int:
        for k, v in self.params:
            if k == key:
                return v
        return METRICS[self.name][key]

    def canonical(self) -> str:
        if not self.params:
            return self.name
        body = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.name}:{body}"

    def length(self, nc: int) -> int:
        """Result vector length (int64 elements) for ``nc`` contigs."""
        if self.name == "count":
            return 3
        if self.name == "flagstat":
            return 1 + len(FLAG_BITS)
        if self.name == "mapq":
            return 256
        if self.name == "tlen":
            return self.get("max") + 2
        return nc * self.get("bins")          # coverage

    def shape(self, nc: int) -> "tuple[int, ...]":
        if self.name == "coverage":
            return (nc, self.get("bins"))
        return (self.length(nc),)


@dataclass(frozen=True)
class AggConfig:
    """The parsed plan: an ordered tuple of :class:`AggSpec`."""

    specs: "tuple[AggSpec, ...]"

    @staticmethod
    @lru_cache(maxsize=128)
    def parse(spec: str) -> "AggConfig":
        """Parse ``"metric[:k=v,...];..."``; ``""`` ⇒ :data:`DEFAULT_SPEC`."""
        spec = (spec or "").strip() or DEFAULT_SPEC
        specs: "list[AggSpec]" = []
        seen: set = set()
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            name, _, body = entry.partition(":")
            name = name.strip()
            if name not in METRICS:
                raise ValueError(
                    f"Unknown agg metric {name!r}: expected one of "
                    f"{', '.join(sorted(METRICS))}"
                )
            if name in seen:
                raise ValueError(f"Duplicate agg metric {name!r} in {spec!r}")
            seen.add(name)
            params: "dict[str, int]" = {}
            for part in body.split(","):
                part = part.strip()
                if not part:
                    continue
                if "=" not in part:
                    raise ValueError(
                        f"Bad agg param {part!r} in {entry!r} "
                        f"(expected k=v)"
                    )
                key, value = (t.strip() for t in part.split("=", 1))
                if key not in METRICS[name]:
                    raise ValueError(
                        f"Unknown agg param {key!r} for metric {name!r}: "
                        f"expected one of "
                        f"{', '.join(sorted(METRICS[name])) or '(none)'}"
                    )
                try:
                    params[key] = int(value)
                except ValueError as exc:
                    raise ValueError(
                        f"Bad agg param value {part!r} in {entry!r}"
                    ) from exc
                if params[key] < 1:
                    raise ValueError(f"agg param {part!r} must be >= 1")
            specs.append(AggSpec(name, tuple(sorted(params.items()))))
        if not specs:
            raise ValueError(f"Empty agg spec: {spec!r}")
        return AggConfig(tuple(specs))

    def canonical(self) -> str:
        return ";".join(s.canonical() for s in self.specs)

    def total_length(self, nc: int) -> int:
        return sum(s.length(nc) for s in self.specs)


# ------------------------------------------------------------ wire schema
def encode_result(
    plan: AggConfig, nc: int, contigs, vectors: "dict[str, np.ndarray]",
) -> "tuple[dict, bytes]":
    """(JSON-able metric directory, one binary payload). The payload is
    the plan's int64 vectors concatenated little-endian in spec order;
    each directory entry locates its vector by element offset/length.
    Deterministic: the same plan and the same answers give the same
    bytes."""
    directory: "list[dict]" = []
    parts: "list[np.ndarray]" = []
    offset = 0
    for spec in plan.specs:
        vec = np.ascontiguousarray(vectors[spec.name], dtype=np.int64).ravel()
        want = spec.length(nc)
        if len(vec) != want:
            raise ValueError(
                f"metric {spec.name!r}: vector has {len(vec)} elements, "
                f"plan wants {want}"
            )
        directory.append({
            "name": spec.name,
            "spec": spec.canonical(),
            "offset": offset,
            "length": want,
            "shape": list(spec.shape(nc)),
        })
        parts.append(vec)
        offset += want
    payload = b"".join(p.astype("<i8", copy=False).tobytes() for p in parts)
    meta = {
        "agg": plan.canonical(),
        "dtype": "int64",
        "elements": offset,
        "metrics": directory,
        "contigs": [[str(n), int(l)] for n, l in (contigs or [])],
    }
    return meta, payload


def decode_result(meta: dict, payload: bytes) -> "dict[str, np.ndarray]":
    """Inverse of :func:`encode_result`: metric name → shaped int64
    array. Validates the directory against the payload length."""
    n = int(meta.get("elements", 0))
    flat = np.frombuffer(payload, dtype="<i8")
    if len(flat) != n:
        raise ValueError(
            f"agg payload has {len(flat)} int64 elements, "
            f"directory declares {n}"
        )
    out: "dict[str, np.ndarray]" = {}
    for ent in meta.get("metrics", []):
        off, length = int(ent["offset"]), int(ent["length"])
        if off < 0 or off + length > n:
            raise ValueError(f"agg metric {ent.get('name')!r}: bad extent")
        out[ent["name"]] = flat[off: off + length].reshape(
            tuple(int(d) for d in ent["shape"])
        ).copy()
    return out
