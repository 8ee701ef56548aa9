"""BGZF inflate feeding the device (reference ``spark_bam_tpu/tpu/
inflate.py``): the window plan, the staging of raw payloads for the device
tokenizer, and the host-zlib pipeline of the classic count loop.

The device side of inflate is two kernels: ``tokenize`` (entropy phase:
bitstream → per-output-byte literal/distance tokens) and ``lz77_resolve``
(copy phase: every byte takes the literal at the root of its back-reference
chain). Both live in ``tpu/kernels.py`` beside their plain versions;
``checker.count_window_raw`` chains them with the count.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from spark_bam_tpu_torch.bgzf.block import Metadata
from spark_bam_tpu_torch.bgzf.flat import FlatView, inflate_blocks, stage_run_payloads
from spark_bam_tpu_torch.bgzf.index_blocks import blocks_metadata
from spark_bam_tpu_torch.core.channel import open_channel
from spark_bam_tpu_torch.tpu.kernels import _resolve_body, lz77_resolve
from spark_bam_tpu_torch.tpu.tokenize_device import STRIDE

__all__ = [
    "STRIDE", "InflatePipeline", "_resolve_body", "lz77_resolve",
    "stage_group_device", "window_plan",
]


def stage_group_device(ch, metas: list[Metadata], device: torch.device):
    """Read and stage one window group's raw payloads and copy them to the
    device: ``(staged (B_pad, C_pad) u8, clens (B_pad,) i32, usizes (B,)
    i64 ndarray)``. Runs on the pipeline's worker threads, ahead of the
    window that consumes it."""
    staged, clens = stage_run_payloads(ch, metas)
    usizes = np.array([m.uncompressed_size for m in metas], dtype=np.int64)
    return (torch.from_numpy(staged).to(device),
            torch.from_numpy(clens).to(device), usizes)


def window_plan(metas: list[Metadata], window_uncompressed: int
                ) -> list[list[Metadata]]:
    """Group consecutive blocks into ≈window-sized uncompressed runs."""
    groups: list[list[Metadata]] = []
    cur: list[Metadata] = []
    size = 0
    for m in metas:
        if cur and size + m.uncompressed_size > window_uncompressed:
            groups.append(cur)
            cur, size = [], 0
        cur.append(m)
        size += m.uncompressed_size
    if cur:
        groups.append(cur)
    return groups


class InflatePipeline:
    """Window groups of a BGZF file and their host-zlib inflation, ``depth``
    groups in flight on worker threads while the consumer takes the oldest.
    The fused device count reads only ``groups``, ``depth`` and ``total``;
    iterating yields ``FlatView`` windows for the classic count loop.
    ``metas`` reuses a block scan the caller already made."""

    threads = 8   # zlib workers per group (zlib releases the GIL)
    depth = 2     # groups prepared ahead of the consumer

    def __init__(self, path, window_uncompressed: int, metas=None):
        self.path = path
        self.metas = blocks_metadata(path) if metas is None else list(metas)
        self.total = sum(m.uncompressed_size for m in self.metas)
        self.groups = window_plan(self.metas, window_uncompressed)

    def __iter__(self) -> Iterator[FlatView]:
        ch = open_channel(self.path)
        pool = ThreadPoolExecutor(max_workers=self.depth)
        try:
            pending = [
                pool.submit(inflate_blocks, ch, g, self.threads)
                for g in self.groups[: self.depth]
            ]
            for i in range(len(self.groups)):
                view = pending.pop(0).result()
                nxt = i + self.depth
                if nxt < len(self.groups):
                    pending.append(pool.submit(
                        inflate_blocks, ch, self.groups[nxt], self.threads))
                view.at_eof = i == len(self.groups) - 1
                yield view
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            ch.close()
