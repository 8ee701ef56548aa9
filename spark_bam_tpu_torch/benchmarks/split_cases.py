"""BAMs for the split-planning edge cases, written with ``synth``'s
encoders (no JAX):

- ``adversarial_bam``: a long carrier record whose qualities hold a fake
  record header with a 16 MiB ``remaining``: a split boundary's scan meets
  the fake before the next true start, and the fake's chain escapes every
  window until EOF (the growth bound of ``load/boundary.py``);
- ``sentinel_split_size``: a split size whose last raw split holds only
  the 28-byte EOF sentinel.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from spark_bam_tpu_torch.benchmarks.synth import (
    BGZF_EOF,
    compress_block,
    encode_header,
    encode_record,
)

#: The fake record's ``remaining``: its chain ends far past any test file.
FAKE_REMAINING = 16 << 20


def _reads(rng, n: int, pos0: int) -> list[bytes]:
    out, pos = [], pos0
    for i in range(n):
        pos += int(rng.integers(1, 400))
        k = int(rng.integers(80, 151))
        out.append(encode_record(
            0, pos, b"r%06d" % (pos0 + i),
            rng.choice(np.array([1, 2, 4, 8], np.uint8), k),
            rng.integers(2, 41, k)))
    return out


def adversarial_bam(path, seed: int = 0, block_payload: int = 4096
                    ) -> tuple[int, int]:
    """Write the carrier BAM; returns ``(split_size, fake_flat)``: a split
    size one of whose boundaries is a block start inside the carrier
    before the fake, and the fake header's flat offset."""
    rng = np.random.default_rng(seed)
    fake = bytearray(encode_record(
        0, 100, b"fake", np.full(20, 1, np.uint8), np.full(20, 30)))
    fake[:4] = struct.pack("<i", FAKE_REMAINING)
    quals = rng.integers(2, 41, 24_000).astype(np.uint8)
    at = 20_000
    quals[at: at + len(fake)] = np.frombuffer(bytes(fake), np.uint8)
    carrier = encode_record(0, 50_000, b"carrier",
                            rng.choice(np.array([1, 2, 4, 8], np.uint8),
                                       len(quals)), quals)
    before = _reads(rng, 300, 0)
    after = _reads(rng, 600, 60_000)
    header = encode_header()
    data = header + b"".join(before) + carrier + b"".join(after)
    carrier_flat = len(header) + sum(len(r) for r in before)
    # 36 fixed bytes, the name, one cigar op and the packed bases precede
    # the qualities.
    fake_flat = carrier_flat + 36 + len(b"carrier") + 1 + 4 \
        + (len(quals) + 1) // 2 + at
    blocks = [compress_block(data[i: i + block_payload])
              for i in range(0, len(data), block_payload)]
    # The first block that starts inside the carrier, before the fake.
    b = -(-(carrier_flat + 1) // block_payload)
    if not b * block_payload < fake_flat:
        raise AssertionError("no block start between carrier and fake")
    split_size = sum(len(blk) for blk in blocks[:b])
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.writelines(blocks)
        f.write(BGZF_EOF)
    os.replace(tmp, path)
    return split_size, fake_flat


def sentinel_split_size(path) -> int:
    """A split size whose last raw split is exactly the EOF sentinel."""
    return os.path.getsize(path) - len(BGZF_EOF)
