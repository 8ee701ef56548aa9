"""The checker plug-in surface (reference ``spark_bam_tpu/check/
checker.py``, Checker.scala:7-28): a checker is ``Pos → call`` over one
BAM, built by name from the registry (``eager``, ``full``, ``indexed``,
``seqdoop``: the host oracles), with the record structure's shared
constants and the scan-budget error.
"""

from __future__ import annotations

from typing import Callable, Protocol

from spark_bam_tpu_torch.core.pos import Pos

FIXED_FIELDS_SIZE = 36  # 9 × i32 at the start of every BAM record
MAX_CIGAR_OP = 8

# Read-name alphabet: '!'..'~' without '@' (reference Checker.scala:12-17).
ALLOWED_NAME_CHAR_MIN = 0x21  # '!'
ALLOWED_NAME_CHAR_MAX = 0x7E  # '~'
EXCLUDED_NAME_CHAR = 0x40     # '@'


def name_char_allowed(b: int) -> bool:
    return (ALLOWED_NAME_CHAR_MIN <= b <= ALLOWED_NAME_CHAR_MAX
            and b != EXCLUDED_NAME_CHAR)


class Checker(Protocol):
    def __call__(self, pos: Pos): ...


class NoReadFoundException(Exception):
    """The scan budget (``max_read_size``) ran out mid-file without a
    record start. Reaching a clean EOF is not this error: the split then
    owns no record start and loads empty."""

    def __init__(self, path, start, max_read_size: int):
        super().__init__(
            f"Failed to find a valid read-start in {max_read_size} attempts"
            f" in {path} from {start}"
        )
        self.path = path
        self.start = start
        self.max_read_size = max_read_size


_REGISTRY: dict[str, Callable] = {}


def register_checker(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def make_checker(name: str, path, config=None, **kw) -> Checker:
    """Build the checker ``name`` for the BAM at ``path``. Factories take
    ``(path, config, **kw)`` and return a ``Pos → call`` object, with a
    ``next_read_start(pos)`` where the checker has one."""
    # Imported for their registrations.
    from spark_bam_tpu_torch.check import eager, full, indexed, seqdoop  # noqa: F401
    from spark_bam_tpu_torch.core.config import Config

    if name not in _REGISTRY:
        raise KeyError(f"Unknown checker {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](path, config or Config(), **kw)
