"""The write path's knobs: the ``deflate`` spec (reference
``spark_bam_tpu/compress/config.py``), as ``SPARK_BAM_DEFLATE`` gives it:

    mode=fixed,level=6,lanes=32,device=auto

``mode`` is the block codec (``off``: host zlib; ``stored``; ``fixed``:
literal-only fixed Huffman, or stored where that is no larger; ``auto``),
``level`` the host zlib level, ``lanes`` the payloads of one device
dispatch and ``device`` whether the device lanes run (``on | off |
auto``). A bare mode name is shorthand for ``mode=NAME``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

MODES = ("off", "stored", "fixed", "auto")
DEVICE = ("on", "off", "auto")


@dataclass(frozen=True)
class DeflateConfig:
    mode: str = "off"
    level: int = 6
    lanes: int = 16
    device: str = "auto"

    @property
    def enabled(self) -> bool:
        """Whether writes go through the codec family at all."""
        return self.mode != "off"

    @property
    def deterministic(self) -> bool:
        """Whether the bytes are the same wherever they were computed."""
        return self.mode in ("stored", "fixed")

    @staticmethod
    @functools.lru_cache(maxsize=64)
    def parse(spec: str) -> "DeflateConfig":
        """Parse a ``mode=...,level=...,lanes=...,device=...`` spec (""
        gives the defaults: host zlib). Raises ``ValueError`` on an
        unknown key or value."""
        kw: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                if part in MODES:
                    kw["mode"] = part
                    continue
                raise ValueError(
                    f"Bad deflate spec {spec!r}: {part!r} is not key=value"
                )
            key, value = part.split("=", 1)
            key, value = key.strip(), value.strip()
            if key == "mode":
                if value not in MODES:
                    raise ValueError(
                        f"Bad deflate mode {value!r}: expected "
                        f"{' | '.join(MODES)}"
                    )
                kw["mode"] = value
            elif key == "level":
                level = int(value)
                if not 0 <= level <= 9:
                    raise ValueError(f"deflate level must be 0..9: {value}")
                kw["level"] = level
            elif key == "lanes":
                lanes = int(value)
                if lanes <= 0:
                    raise ValueError(f"deflate lanes must be positive: {value}")
                kw["lanes"] = lanes
            elif key == "device":
                if value not in DEVICE:
                    raise ValueError(
                        f"Bad deflate device {value!r}: expected "
                        f"{' | '.join(DEVICE)}"
                    )
                kw["device"] = value
            else:
                raise ValueError(f"Unknown deflate key {key!r} in {spec!r}")
        return DeflateConfig(**kw)
