"""Typed configuration: the subset of the ``spark.bam.*`` knobs that the
count-reads, full-check, load, aggregate, split-planning, export and write
paths read, under the reference package's names and defaults, with the
byte-size shorthand (``parse_bytes``, ``format_bytes``) the split sizes
take.

Values this port cannot serve yet raise ``ValueError`` naming what will
serve them, so a run never silently takes another path than asked for.
"""

from __future__ import annotations

import functools
import os
import re
from dataclasses import dataclass

TOKENIZE = ("host", "device", "auto")
KERNEL = ("xla", "pallas", "auto")
ONOFF = ("on", "off")

_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kKmMgGtTpP]?)i?[bB]?\s*$")
_SIZE_FACTORS = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30,
                 "t": 1 << 40, "p": 1 << 50}
_UNITS = (("PB", 50), ("TB", 40), ("GB", 30), ("MB", 20), ("KB", 10))


def parse_bytes(s) -> int:
    """Byte-size shorthand: ``"2MB"``, ``"32m"``, ``"100KB"``, ``1024``
    (1024-based units)."""
    if isinstance(s, int):
        return s
    m = _SIZE_RE.match(str(s))
    if not m:
        raise ValueError(f"Bad byte-size: {s!r}")
    value, unit = m.groups()
    return int(float(value) * _SIZE_FACTORS[unit.lower()])


def format_bytes(n: int) -> str:
    """``32MB`` for whole units, else one decimal (``613.3KB``), else
    ``NB``."""
    for unit, shift in _UNITS:
        if n >= (1 << shift) and n % (1 << shift) == 0:
            return f"{n >> shift}{unit}"
    for unit, shift in _UNITS:
        if n >= (1 << shift):
            return f"{n / (1 << shift):.1f}{unit}"
    return f"{n}B"


@dataclass(frozen=True)
class InflateConfig:
    """The ``Config.inflate`` spec: ``tokenize=…,kernel=…,donate=…``.

    ``tokenize`` says where the DEFLATE entropy phase runs. This port has
    only the device tokenizer (the hand-written CUDA kernel), so ``auto``
    resolves to ``device`` and ``host`` is refused. ``kernel`` names a
    tokenizer engine of the reference package; the port has one engine,
    so only ``auto`` is served. ``donate`` names the reference's jit buffer
    donation; eager PyTorch has none, and the port always resolves LZ77 in
    place over the literal plane, so only ``on`` is served.
    """

    tokenize: str = "auto"
    kernel: str = "auto"
    donate: str = "on"

    @staticmethod
    @functools.lru_cache(maxsize=64)
    def parse(spec: str) -> "InflateConfig":
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                if part in TOKENIZE:
                    kw["tokenize"] = part
                    continue
                raise ValueError(
                    f"Bad inflate spec {spec!r}: {part!r} is not key=value"
                )
            key, value = (s.strip() for s in part.split("=", 1))
            allowed = {"tokenize": TOKENIZE, "kernel": KERNEL,
                       "donate": ONOFF}.get(key)
            if allowed is None:
                raise ValueError(f"Unknown inflate key {key!r} in {spec!r}")
            if value not in allowed:
                raise ValueError(
                    f"Bad inflate {key} {value!r}: expected "
                    f"{' | '.join(allowed)}"
                )
            kw[key] = value
        cfg = InflateConfig(**kw)
        if cfg.tokenize == "host":
            raise ValueError(
                "inflate tokenize=host needs a host DEFLATE tokenizer, which "
                "the slice that ports the host tokenizer will serve; this "
                "port tokenizes on the device (tokenize=device or auto)"
            )
        if cfg.kernel != "auto":
            raise ValueError(
                f"inflate kernel={cfg.kernel} names an engine of the JAX "
                "package; this port has one device tokenizer (kernel=auto)"
            )
        if cfg.donate != "on":
            raise ValueError(
                "inflate donate=off names the JAX package's jit buffer "
                "donation; this port always resolves LZ77 in place (donate=on)"
            )
        return cfg


@dataclass(frozen=True)
class Config:
    bgzf_blocks_to_check: int = 5       # consecutive headers a block start chains
    reads_to_check: int = 10            # consecutive records a boundary must chain
    max_read_size: int = 10_000_000     # byte budget for a boundary scan
    # Split planning: bytes per raw file split (None: the command's default)
    # and the ratio a split's length estimate assumes.
    split_size: int | None = None
    estimated_compression_ratio: float = 3.0
    # The .sbi split-index cache: off | read | write | readwrite, with an
    # optional ",strict" ("" = off); ``cache_mode`` parses it.
    cache: str = ""
    # Uncompressed bytes per streaming window; window + halo rounds up to a
    # power-of-two kernel window (24 MiB + 4 MiB → 32 MiB).
    window_size: int = 24 << 20
    halo_size: int = 4 << 20            # trailing bytes so chains can complete
    funnel: str = "auto"                # on | off | auto
    # None = auto: on (the device inflate is the only one this port has).
    device_inflate: bool | None = None
    # None = auto: follows device_inflate.
    fused_count: bool | None = None
    inflate: str = ""                   # InflateConfig spec
    flush_every: int | None = None      # windows between device→host flushes
    ring_depth: int = 2                 # un-synced windows in the count ring
    # Resident-scan counting (StreamChecker.count_reads_resident): host-zlib
    # windows packed into device-resident chunks, one dispatch per chunk
    # through checker.make_count_scan (on the GPU one CUDA graph replay of
    # the chunk's window bodies) instead of one per window. Opt-in: a
    # chunk holds hundreds of MiB of device memory, and the count is the
    # only projection the chunk counter serves.
    resident_scan: bool = False
    # Device memory budget for one resident chunk, bytes: clamped to at
    # most 1 GiB (int32 row offsets and per-chunk sums) and at least one
    # window row, then floored to a power of two of rows.
    resident_chunk_bytes: int = 256 << 20
    # Compact AggConfig spec of ``load.api.aggregate`` and the aggregate
    # command ("coverage:bin=1000,bins=512;flagstat;mapq;tlen:max=2000;
    # count"; "" = every metric at defaults); ``agg_config`` parses it.
    agg: str = ""
    # Compact ColumnarConfig spec of ``load.api.export`` and the export
    # command ("rows=8192,codec=zlib,level=6,columns=flag+pos+name"; "" =
    # defaults); ``columnar_config`` parses it.
    columnar: str = ""
    # Compact DeflateConfig spec of the write path ("mode=fixed,level=6,
    # lanes=16,device=auto"; "" = host zlib): the block codec behind
    # ``bam.writer.write_bam_result`` and the rewrite command;
    # ``deflate_config`` parses it.
    deflate: str = ""

    #: The load path's raw split size (hadoop's file-split default).
    LOAD_SPLIT_SIZE_DEFAULT = 32 << 20

    def __post_init__(self):
        if self.funnel not in ("on", "off", "auto"):
            raise ValueError(
                f"Bad funnel mode: {self.funnel!r} (expected on | off | auto)"
            )
        InflateConfig.parse(self.inflate)

    @property
    def cache_mode(self):
        """The parsed ``CacheMode`` of this config's ``cache`` spec."""
        from spark_bam_tpu_torch.sbi.store import CacheMode

        return CacheMode.parse(self.cache)

    def split_size_or(self, default: int) -> int:
        return self.split_size if self.split_size is not None else default

    #: The knobs ``from_env`` reads, as ``SPARK_BAM_<KNOB>``.
    ENV_KNOBS = ("cache", "columnar", "deflate")

    @classmethod
    def from_env(cls, env=None) -> "Config":
        """The defaults with ``SPARK_BAM_CACHE`` as the ``cache`` spec,
        ``SPARK_BAM_COLUMNAR`` as the ``columnar`` spec and
        ``SPARK_BAM_DEFLATE`` as the ``deflate`` spec, as the
        reference's ``Config.from_env`` maps them (the store's
        ``SPARK_BAM_CACHE_DIR`` and ``SPARK_BAM_CACHE_BUDGET`` are read by
        ``sbi.store.CacheStore.from_env``)."""
        env = os.environ if env is None else env
        kw = {k: env[f"SPARK_BAM_{k.upper()}"] for k in cls.ENV_KNOBS
              if f"SPARK_BAM_{k.upper()}" in env}
        return cls(**kw)

    @property
    def inflate_config(self) -> InflateConfig:
        return InflateConfig.parse(self.inflate)

    @property
    def columnar_config(self):
        """The parsed ``ColumnarConfig`` of this config's ``columnar``
        spec."""
        from spark_bam_tpu_torch.columnar.config import ColumnarConfig

        return ColumnarConfig.parse(self.columnar)

    @property
    def deflate_config(self):
        """The parsed ``DeflateConfig`` of this config's ``deflate`` spec."""
        from spark_bam_tpu_torch.compress.config import DeflateConfig

        return DeflateConfig.parse(self.deflate)

    @property
    def agg_config(self):
        """The parsed ``AggConfig`` of this config's ``agg`` spec."""
        from spark_bam_tpu_torch.agg.plan import AggConfig

        return AggConfig.parse(self.agg)

    def funnel_enabled(self, full_masks: bool = False) -> bool:
        """Whether a projection runs the two-stage candidate funnel.
        Projections whose product is the per-position flag mask
        (``full_masks``, full-check) always take the full pass: under the
        funnel, rejected positions carry only the prefilter bits."""
        return self.funnel != "off" and not full_masks

    def flush_every_for(self, kernel_window: int) -> int:
        """Windows between flushes of the device accumulators: the explicit
        knob when set, else the int32-safe auto value; either way at most
        2^30 positions accumulate between flushes."""
        auto = max(1, (1 << 30) // max(kernel_window, 1))
        if self.flush_every is None:
            return auto
        return max(1, min(self.flush_every, auto))
