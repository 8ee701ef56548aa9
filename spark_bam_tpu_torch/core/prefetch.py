"""Cursor-relative read-ahead for high-latency channels (reference
``spark_bam_tpu/core/prefetch.py``): the legacy remote wrapper, taken under
``--remote mode=legacy``.

``PrefetchChannel`` keeps a bounded pipeline of aligned chunks in flight
ahead of each read on a thread pool, so a sequential scan overlaps its
round trips whatever the backend's latency. Retention is LRU over a bounded
chunk set, with the chunks a read is consuming pinned, so readers at
different offsets do not evict each other's chunks mid-read.
"""


from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

from spark_bam_tpu_torch.core.channel import ByteChannel


class PrefetchChannel(ByteChannel):
    def __init__(
        self,
        inner: ByteChannel,
        chunk_size: int = 1 << 20,
        depth: int = 4,
        workers: int = 4,
        max_chunks: int | None = None,
    ):
        super().__init__()
        self.inner = inner
        self.chunk_size = chunk_size
        self.depth = depth
        # Retention is LRU over a bounded chunk set (not cursor-relative):
        # multiple readers at different offsets (InflatePipeline keeps two
        # windows in flight) must not evict each other's chunks mid-read.
        self.max_chunks = max_chunks or max(4 * (depth + 1), 16)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._inflight: OrderedDict[int, Future] = OrderedDict()
        self._pins: dict[int, int] = {}
        self._lock = threading.Lock()

    def _fetch(self, idx: int) -> Future:
        # read_at callers fan out across threads (block inflater, bench
        # pipelines); the in-flight map is the only shared state.
        with self._lock:
            fut = self._inflight.get(idx)
            if fut is not None:
                self._inflight.move_to_end(idx)
            else:
                fut = self._pool.submit(
                    self.inner._read_at, idx * self.chunk_size, self.chunk_size
                )
                self._inflight[idx] = fut
        return fut

    def _read_at(self, pos: int, n: int) -> bytes:
        first = pos // self.chunk_size
        last = (pos + max(n, 1) - 1) // self.chunk_size
        # Pin the window this read will consume: eviction must not race a
        # concurrent reader at a far-apart offset into dropping our chunks
        # between fetch and result() (two readers with a small max_chunks
        # would otherwise thrash each other into re-fetching everything).
        with self._lock:
            for idx in range(first, last + 1):
                self._pins[idx] = self._pins.get(idx, 0) + 1
        try:
            # Kick off the window we need plus read-ahead.
            for idx in range(first, last + 1 + self.depth):
                self._fetch(idx)
            out = []
            remaining = n
            cur = pos
            for idx in range(first, last + 1):
                chunk = self._fetch(idx).result()
                off = cur - idx * self.chunk_size
                piece = chunk[off: off + remaining]
                if not piece:
                    break
                out.append(piece)
                cur += len(piece)
                remaining -= len(piece)
                if remaining <= 0:
                    break
        finally:
            with self._lock:
                for idx in range(first, last + 1):
                    left = self._pins.get(idx, 0) - 1
                    if left <= 0:
                        self._pins.pop(idx, None)
                    else:
                        self._pins[idx] = left
                self._evict_locked()
        return b"".join(out)

    def _evict_locked(self) -> None:
        # Retire least-recently-used chunks to bound memory — but never a
        # pinned chunk (an outstanding reader holds it) or a pending fetch
        # (dropping it just re-pays the request). May transiently stay over
        # max_chunks while every chunk is pinned or in flight.
        excess = len(self._inflight) - self.max_chunks
        if excess <= 0:
            return
        for idx in list(self._inflight):
            if excess <= 0:
                break
            fut = self._inflight[idx]
            if self._pins.get(idx) or not fut.done():
                continue
            del self._inflight[idx]
            excess -= 1

    @property
    def size(self) -> int:
        return self.inner.size

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        self.inner.close()
