"""Payload lanes for the write path's kernels (``compress/kernels.py``),
shared by the CPU tests, the card tests and ``chip_smoke.py``; made from a
seed with NumPy.

The lengths: 0, 1, 3, 4 and 5 (a CRC group and its edges), 4,000,
``MAX_STORED_PAYLOAD`` (the largest member payload) and ``STRIDE`` (a
full lane); text bytes (all below 144, the fixed alphabet's 8-bit codes),
random bytes, and bytes all at or above 144, whose fixed stream (9 bits a
byte) outgrows ``OUT_BYTES``.
"""

from __future__ import annotations

import numpy as np

from spark_bam_tpu_torch.compress.huffman import MAX_STORED_PAYLOAD
from spark_bam_tpu_torch.compress.kernels import STRIDE


def lane_cases(seed: int = 0) -> "dict[str, bytes]":
    """Name → payload, the overflowing full lane first."""
    rng = np.random.default_rng(seed)

    def text(n):
        return rng.integers(32, 127, n, dtype=np.uint8).tobytes()

    def binary(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def high(n):
        return rng.integers(144, 256, n, dtype=np.uint8).tobytes()

    return {
        "high_stride": high(STRIDE),
        "empty": b"",
        "one": binary(1),
        "three": binary(3),
        "four": high(4),
        "five": binary(5),
        "text_4000": text(4000),
        "binary_4000": binary(4000),
        "text_max_stored": text(MAX_STORED_PAYLOAD),
        "binary_max_stored": binary(MAX_STORED_PAYLOAD),
        "high_max_stored": high(MAX_STORED_PAYLOAD),
        "text_stride": text(STRIDE),
    }


def lane_batch(b: int, seed: int = 0) -> "list[bytes]":
    """``b`` payloads: the cases in order, again with new bytes (the next
    seed) as often as ``b`` needs."""
    out: list[bytes] = []
    k = 0
    while len(out) < b:
        out.extend(list(lane_cases(seed + k).values())[: b - len(out)])
        k += 1
    return out
