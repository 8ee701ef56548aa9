"""Typed configuration: the subset of the ``spark.bam.*`` knobs that the
count-reads, full-check, load, aggregate, split-planning, export, write,
serve and job paths read, under the reference package's names and
defaults, with the byte-size shorthand (``parse_bytes``, ``format_bytes``)
the split sizes take.

Values this port cannot serve yet raise ``ValueError`` naming what will
serve them, so a run never silently takes another path than asked for.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
from dataclasses import dataclass

TOKENIZE = ("host", "device", "auto")
CHECKERS = ("eager", "full", "indexed", "seqdoop")
#: ``Config.backend`` values that take the host engine; the rest
#: (auto, tpu, pallas) take the card.
HOST_BACKENDS = ("numpy", "python", "native")
BACKENDS = ("auto", "tpu", "pallas", *HOST_BACKENDS)
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

    ``tokenize`` says where the DEFLATE entropy phase runs: ``device`` (the
    hand-written CUDA kernel over the raw payloads), ``host`` (the C++
    host tokenizer, whose packed token planes ship to the device), or
    ``auto``, which in this port resolves to ``device`` on every device
    (the reference's ``auto`` means ``host`` off the TPU). ``kernel`` names a
    tokenizer engine of the reference package; the port has one engine,
    so only ``auto`` is served. ``donate`` names the reference's jit buffer
    donation; eager PyTorch has none, and the port always resolves LZ77 in
    place over the literal plane, so only ``on`` is served.
    """

    tokenize: str = "auto"
    kernel: str = "auto"
    donate: str = "on"

    def resolve_tokenize(self) -> str:
        """``host`` or ``device``: where the entropy phase runs."""
        return "host" if self.tokenize == "host" else "device"

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
    # The Checker plugin surface (reference docs/api.md): the checker a
    # check command scores (eager | full | indexed | seqdoop) and the engine
    # of the check commands' eager verdict: tpu, pallas and auto take the
    # card; numpy, python and native the host pass ``check/vectorized.py::
    # check_flat``. Split starts resolve on the card under every backend.
    checker: str = "eager"
    backend: str = "auto"
    # The .sbi split-index cache: off | read | write | readwrite, with an
    # optional ",strict" ("" = off); ``cache_mode`` parses it.
    cache: str = ""
    # Uncompressed bytes per streaming window; window + halo rounds up to a
    # power-of-two kernel window (24 MiB + 4 MiB → 32 MiB).
    window_size: int = 24 << 20
    halo_size: int = 4 << 20            # trailing bytes so chains can complete
    funnel: str = "auto"                # on | off | auto
    # None = auto: on (the device inflate; host zlib only when False).
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
    # Compact FaultPolicy spec ("retries=3,deadline=60"; "" = defaults):
    # the serve daemon's default request deadline and the retries of its
    # header and split reads; ``fault_policy`` parses it.
    faults: str = ""
    # Compact ServeConfig spec of the serve daemon ("batch=16,tick=2,
    # scan_queue=128,window=1MB"; "" = defaults): batching, admission
    # limits and resident budgets; ``serve_config`` parses it.
    serve: str = ""
    # Compact FabricConfig spec of the serve fabric ("workers=3,probe=500,
    # spill=8"; "" = defaults): the router's pool size, affinity
    # spillover, probe and eject pacing, retry budget and the autoscaler's
    # target and bounds; ``fabric_config`` parses it.
    fabric: str = ""
    # Compact JobsConfig spec of the durable job plane ("dir=/var/jobs,
    # checkpoint=5000,frames=8,mem=0.92,max=2"; "" = defaults): the journal
    # and segment root, the checkpoint cadence of the rewrite, transcode and
    # export jobs, and the manager's admission limits; ``jobs_config``
    # parses it.
    jobs: str = ""
    # The disk-fault seam's "SEED:SPEC" ("9:enospc=0.05+torn=0.01"; "" =
    # off), carried so SPARK_BAM_DISK_CHAOS round-trips through
    # ``from_env``. Installing it happens at process entry
    # (``core.faults.maybe_install_disk_chaos_from_env`` / ``--disk-chaos``),
    # never lazily; ``disk_chaos_config`` parses it.
    disk_chaos: str = ""
    # Compact DecodeLimits spec of the untrusted-byte decoders
    # ("record=32MB,refs=1000"; "" = defaults); ``decode_limits`` parses
    # it. The ``--limits`` flag also installs it process-wide
    # (``core.guard.set_limits``), which the record decoder reads.
    limits: str = ""
    # Compact RemoteConfig spec of the remote data plane ("mode=plan,
    # depth=8,gap=128KB,hedge=3"; "" = plan-driven, adaptive depth);
    # ``remote_config`` parses it. The ``--remote`` flag also installs it
    # process-wide (``core.remote_plan.set_remote_config``).
    remote: str = ""
    # SLO objectives and the burn-rate engine's knobs
    # ("serve.latency:p99<1500ms@5m;serve.errors:ratio<0.1%@1h;sample=0.1";
    # "" = no objectives); ``slo_config`` parses it (obs/slo.py).
    slo: str = ""
    warn: bool = False       # the root log-level toggle (LogArgs.scala:30-33)
    # Accepted so reference invocations parse unchanged (PostPartitionArgs
    # -p, default 100000) and inert: disagreement positions are one host
    # array, annotated vectorized, with no partition count to tune.
    post_partition_size: int = 100_000

    #: The load path's raw split size (hadoop's file-split default).
    LOAD_SPLIT_SIZE_DEFAULT = 32 << 20
    #: The block planner's partition size (reference Blocks.scala:64).
    CHECK_SPLIT_SIZE_DEFAULT = 2 << 20

    def __post_init__(self):
        for knob, allowed in (("checker", CHECKERS), ("backend", BACKENDS)):
            if getattr(self, knob) not in allowed:
                raise ValueError(f"Bad {knob} {getattr(self, knob)!r} "
                                 f"(expected {' | '.join(allowed)})")
        if self.funnel not in ("on", "off", "auto"):
            raise ValueError(
                f"Bad funnel mode: {self.funnel!r} (expected on | off | auto)"
            )
        InflateConfig.parse(self.inflate)

    @property
    def host_backend(self) -> bool:
        """Whether ``backend`` asks for the host engine (numpy, python or
        native) where the check commands score the eager verdict."""
        return self.backend in HOST_BACKENDS

    @property
    def cache_mode(self):
        """The parsed ``CacheMode`` of this config's ``cache`` spec."""
        from spark_bam_tpu_torch.sbi.store import CacheMode

        return CacheMode.parse(self.cache)

    def split_size_or(self, default: int) -> int:
        return self.split_size if self.split_size is not None else default

    def replace(self, **kw) -> "Config":
        """A copy with ``kw`` set; a ``split_size`` may be a byte string."""
        if kw.get("split_size") is not None:
            kw["split_size"] = parse_bytes(kw["split_size"])
        return dataclasses.replace(self, **kw)

    _PREFIX = "spark.bam."

    @classmethod
    def from_dict(cls, d: dict, base: "Config | None" = None) -> "Config":
        """``base`` (the defaults) with the knobs of a flat ``spark.bam.*``
        or bare-key mapping set, as the reference's ``from_dict``: ``.`` and
        ``-`` read as ``_``, an unknown key raises ``KeyError``, and each
        value is coerced by its field's type (byte strings for ints,
        ``auto``/``none``/empty as None where a field takes None, ``1``/
        ``true``/``yes`` as True)."""
        base = base or cls()
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for key, value in d.items():
            name = key[len(cls._PREFIX):] if key.startswith(cls._PREFIX) \
                else key
            name = name.replace(".", "_").replace("-", "_")
            if name not in fields:
                raise KeyError(f"Unknown config key: {key}")
            ftype = fields[name].type
            if ftype == "int":
                value = parse_bytes(value) if isinstance(value, str) \
                    else int(value)
            elif ftype == "int | None":
                value = (None if value is None or str(value).lower()
                         in ("auto", "none", "") else parse_bytes(value))
            elif ftype == "float":
                value = float(value)
            elif ftype in ("bool", "bool | None") \
                    and not isinstance(value, bool):
                s = str(value).lower()
                value = (None if ftype == "bool | None"
                         and s in ("auto", "none", "")
                         else s in ("1", "true", "yes"))
            kw[name] = value
        return base.replace(**kw)

    #: The compact-spec knobs (each parsed by its own ``*_config``), read
    #: from ``SPARK_BAM_<KNOB>`` as strings.
    ENV_KNOBS = ("cache", "columnar", "deflate", "faults", "serve", "fabric",
                 "jobs", "disk_chaos", "inflate", "limits", "remote", "slo")

    #: ``SPARK_BAM_*`` names that are not knobs: the cloud endpoints and
    #: tokens (``core/cloud.py``), the store's directory and budget
    #: (``sbi/store.py``), the telemetry paths (``obs/``) and serve's ring
    #: directory (``serve/shm.py``). The bare ``SPARK_BAM_CACHE`` is the
    #: ``cache`` knob.
    _ENV_NON_CONFIG = ("gs_", "s3_", "profile", "cache_", "metrics_out",
                       "flight_dir", "shm_dir")

    @classmethod
    def from_env(cls, env=None, base: "Config | None" = None) -> "Config":
        """``base`` (the defaults) with every ``SPARK_BAM_<KNOB>`` of
        ``env`` (``os.environ`` by default) read through ``from_dict``, as
        the reference's ``from_env`` reads them: ``SPARK_BAM_SPLIT_SIZE=2MB``
        is ``split_size=2097152``, ``SPARK_BAM_CACHE`` the ``cache`` spec;
        the names in ``_ENV_NON_CONFIG`` are skipped and any other
        unknown one raises ``KeyError``."""
        env = os.environ if env is None else env
        d = {key[len("SPARK_BAM_"):].lower(): value
             for key, value in env.items() if key.startswith("SPARK_BAM_")}
        d = {k: v for k, v in d.items()
             if not k.startswith(cls._ENV_NON_CONFIG)}
        return cls.from_dict(d, base=base) if d else (base or cls())

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
    def decode_limits(self):
        """The parsed ``DecodeLimits`` of this config's ``limits`` spec."""
        from spark_bam_tpu_torch.core.guard import DecodeLimits

        return DecodeLimits.parse(self.limits)

    @property
    def remote_config(self):
        """The parsed ``RemoteConfig`` of this config's ``remote`` spec."""
        from spark_bam_tpu_torch.core.remote_plan import RemoteConfig

        return RemoteConfig.parse(self.remote)

    @property
    def fault_policy(self):
        """The parsed ``FaultPolicy`` of this config's ``faults`` spec."""
        from spark_bam_tpu_torch.core.faults import FaultPolicy

        return FaultPolicy.parse(self.faults)

    @property
    def fabric_config(self):
        """The parsed ``FabricConfig`` of this config's ``fabric`` spec."""
        from spark_bam_tpu_torch.fabric.config import FabricConfig

        return FabricConfig.parse(self.fabric)

    @property
    def slo_config(self):
        """The parsed ``SloConfig`` of this config's ``slo`` spec."""
        from spark_bam_tpu_torch.obs.slo import SloConfig

        return SloConfig.parse(self.slo)

    @property
    def jobs_config(self):
        """The parsed ``JobsConfig`` of this config's ``jobs`` spec."""
        from spark_bam_tpu_torch.jobs.manager import JobsConfig

        return JobsConfig.parse(self.jobs)

    @property
    def disk_chaos_config(self):
        """The parsed ``(seed, DiskChaosSpec)`` of this config's
        ``disk_chaos`` spec, or ``None`` when it is off."""
        from spark_bam_tpu_torch.core.faults import parse_disk_chaos

        return parse_disk_chaos(self.disk_chaos) if self.disk_chaos else None

    @property
    def serve_config(self):
        """The parsed ``ServeConfig`` of this config's ``serve`` spec."""
        from spark_bam_tpu_torch.serve.config import ServeConfig

        return ServeConfig.parse(self.serve)

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


def default_config() -> Config:
    """The defaults with the environment's ``SPARK_BAM_*`` knobs."""
    return Config.from_env()
