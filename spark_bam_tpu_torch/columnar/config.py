"""The columnar knobs: the ``Config.columnar`` spec (reference
``spark_bam_tpu/columnar/config.py``), as ``SPARK_BAM_COLUMNAR`` and the
``--columnar`` flag give it:

    rows=8192,codec=zlib,level=6,columns=flag+pos+name

``rows`` is the record-batch row target (the frame segmentation of the
native container), ``codec`` compresses the container's per-column
buffers (``none | zlib | deflate``; ``deflate`` writes literal-only
fixed-Huffman zlib streams through ``compress.encode_zlib_stream``),
``level`` is zlib's level and ``columns`` a ``+``-separated default
projection.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from spark_bam_tpu_torch.columnar.schema import normalize_columns

_CODECS = ("none", "zlib", "deflate")


@dataclass(frozen=True)
class ColumnarConfig:
    batch_rows: int = 8192
    codec: str = "none"
    level: int = 6
    columns: "tuple[str, ...] | None" = None

    @staticmethod
    @functools.lru_cache(maxsize=64)
    def parse(spec: str) -> "ColumnarConfig":
        """Parse a ``rows=...,codec=...,level=...,columns=a+b`` spec (""
        gives the defaults). Raises ``ValueError`` on an unknown key or
        value."""
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"Bad columnar spec {spec!r}: {part!r} is not key=value"
                )
            key, value = part.split("=", 1)
            key, value = key.strip(), value.strip()
            if key in ("rows", "batch_rows"):
                rows = int(value)
                if rows <= 0:
                    raise ValueError(f"columnar rows must be positive: {value}")
                kw["batch_rows"] = rows
            elif key == "codec":
                if value not in _CODECS:
                    raise ValueError(
                        f"Bad columnar codec {value!r}: expected "
                        f"{' | '.join(_CODECS)}"
                    )
                kw["codec"] = value
            elif key == "level":
                level = int(value)
                if not 0 <= level <= 9:
                    raise ValueError(f"columnar level must be 0..9: {value}")
                kw["level"] = level
            elif key == "columns":
                kw["columns"] = normalize_columns(value)
            else:
                raise ValueError(f"Unknown columnar key: {key!r}")
        return ColumnarConfig(**kw)
