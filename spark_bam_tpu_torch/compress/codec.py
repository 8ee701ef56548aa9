"""The zlib-stream encoder of the columnar container's ``codec=deflate``
buffers (reference ``spark_bam_tpu/compress/codec.py::
encode_zlib_stream``), host half.

A deflate spec that leaves the device off (``mode=off``, the default, or
``device=off``) gives :func:`~spark_bam_tpu_torch.compress.huffman.
zlib_stream`'s bytes, as the reference does. A spec that turns the
device lanes on names work of the write path's slice (ROADMAP Queue 1
item 11), which ports those lanes: until then it raises rather than
take the host path in their place.
"""

from __future__ import annotations

import os

from spark_bam_tpu_torch.compress.config import DeflateConfig
from spark_bam_tpu_torch.compress.huffman import zlib_stream


def encode_zlib_stream(raw: bytes, spec: "str | None" = None) -> bytes:
    """A zlib stream of literal-only fixed-Huffman blocks over ``raw``.
    ``spec`` is a deflate spec; ``None`` reads ``SPARK_BAM_DEFLATE``."""
    if spec is None:
        spec = os.environ.get("SPARK_BAM_DEFLATE", "")
    cfg = DeflateConfig.parse(spec)
    if not cfg.enabled or cfg.device == "off":
        return zlib_stream(raw)
    raise NotImplementedError(
        f"deflate spec {spec!r} turns on the device deflate lanes, which "
        "come with the write path's codec (ROADMAP Queue 1 item 11); "
        "mode=off or device=off encodes on the host"
    )
