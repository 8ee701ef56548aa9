"""Block metadata of a BGZF file or URL (reference ``spark_bam_tpu/bgzf/
index_blocks.py``): by a header walk, from a ``.blocks`` sidecar, or from
the ``.sbi`` cache's block section.

``blocks_metadata`` keeps the reference's precedence: for a local file a
``.blocks`` sidecar that checks out against the file, else the ``.sbi``
tier (fingerprint-validated, when ``Config.cache`` reads), else the walk,
written through to the ``.sbi`` tier when ``Config.cache`` writes; for a
URL the ``.sbi`` tier first (a warm hit costs the fingerprint's one GET,
where the sidecar probe alone is a round trip to a file that is usually
absent), then the sidecar, then the walk. Over a URL the walk's two small
reads a block are served by the remote channel's whole-file plan
(``core/remote_plan.py``): a few large GETs, not two round trips a block.
``index_blocks`` writes the ``.blocks`` sidecar: one
``start,compressedSize,uncompressedSize`` line per block (reference
IndexBlocks.scala:11-52).
"""

from __future__ import annotations

import logging
import os

from spark_bam_tpu_torch.bgzf.block import (
    FOOTER_SIZE,
    HEADER_SIZE,
    MAX_BLOCK_SIZE,
    BgzfError,
    Metadata,
    parse_header,
)
from spark_bam_tpu_torch.core.channel import (
    is_url,
    open_channel,
    path_exists,
    path_size,
    read_text,
)

log = logging.getLogger(__name__)


class StaleBlocksIndexError(IOError):
    """Strict mode: the ``.blocks`` sidecar contradicts the BAM it names."""


def scan_blocks(path) -> list[Metadata]:
    """Every block's ``Metadata`` in file order, without inflating. The
    28-byte EOF sentinel (an empty payload) ends the walk and is not
    listed; a file that ends without one ends at its last whole block."""
    out: list[Metadata] = []
    with open_channel(path) as ch:
        pos = 0
        while pos + HEADER_SIZE <= ch.size:
            header_size, csize = parse_header(ch.read_at(pos, HEADER_SIZE))
            if pos + csize > ch.size:
                break
            footer = ch.read_at(pos + csize - 4, 4)
            usize = int.from_bytes(footer, "little")
            if usize > MAX_BLOCK_SIZE:
                raise BgzfError(
                    f"BGZF ISIZE {usize} at {pos} exceeds {MAX_BLOCK_SIZE}"
                )
            if csize - header_size - FOOTER_SIZE == 2:
                break
            out.append(Metadata(pos, csize, usize))
            pos += csize
    return out


def format_block_line(meta: Metadata) -> str:
    return f"{meta.start},{meta.compressed_size},{meta.uncompressed_size}"


def parse_block_line(line: str) -> Metadata:
    parts = line.strip().split(",")
    if len(parts) != 3:
        raise ValueError(f"Bad blocks-index line: {line!r}")
    return Metadata(int(parts[0]), int(parts[1]), int(parts[2]))


def read_blocks_index(path) -> list[Metadata]:
    return [parse_block_line(line) for line in read_text(path).splitlines()
            if line.strip()]


def index_blocks(bam_path, out_path=None) -> tuple[str, int]:
    """Write the ``.blocks`` sidecar of ``bam_path`` (to a pid-suffixed
    tmp file, then renamed); returns ``(path, number of blocks)``."""
    out_path = (str(out_path) if out_path is not None
                else str(bam_path) + ".blocks")
    blocks = scan_blocks(bam_path)
    tmp_path = f"{out_path}.tmp{os.getpid()}"
    try:
        with open(tmp_path, "w") as out:
            out.writelines(format_block_line(m) + "\n" for m in blocks)
        os.replace(tmp_path, out_path)
    finally:
        if os.path.exists(tmp_path):  # failure path only
            os.unlink(tmp_path)
    return out_path, len(blocks)


def validate_blocks_index(blocks: list[Metadata], file_size: int
                          ) -> str | None:
    """Why ``blocks`` cannot describe a BAM of ``file_size`` bytes, or None
    when it checks out: non-empty, starting at 0, a contiguous chain, and
    covering the file up to an optional 28-byte EOF sentinel."""
    if not blocks:
        return "empty index for a non-empty file" if file_size else None
    if blocks[0].start != 0:
        return f"first block starts at {blocks[0].start}, not 0"
    for prev, cur in zip(blocks, blocks[1:]):
        if prev.start + prev.compressed_size != cur.start:
            return (
                f"gap/overlap at offset {cur.start}: previous block ends at "
                f"{prev.start + prev.compressed_size}"
            )
    last_end = blocks[-1].start + blocks[-1].compressed_size
    if file_size - last_end not in (0, 28):
        return (
            f"index covers {last_end} of {file_size} bytes "
            "(not an EOF-sentinel remainder)"
        )
    return None


def blocks_metadata(path, strict: bool = False, config=None
                    ) -> list[Metadata]:
    """All block ``Metadata`` of a BAM: from a ``.blocks`` sidecar
    consistent with the file, else the ``.sbi`` tier (a URL asks that tier
    first), else by the walk (written through to the ``.sbi`` tier).
    ``strict`` raises ``StaleBlocksIndexError`` on a stale sidecar instead
    of rescanning."""
    from spark_bam_tpu_torch.sbi.store import cached_blocks, store_blocks

    remote = is_url(str(path))
    if remote:
        blocks = cached_blocks(path, config)
        if blocks is not None:
            return blocks
    sidecar = str(path) + ".blocks"
    if path_exists(sidecar):
        blocks = read_blocks_index(sidecar)
        reason = validate_blocks_index(blocks, path_size(path))
        if reason is None:
            return blocks
        if strict:
            raise StaleBlocksIndexError(f"{sidecar}: {reason}")
        log.warning("ignoring stale .blocks sidecar %s (%s); rescanning",
                    sidecar, reason)
    if not remote:
        blocks = cached_blocks(path, config)
        if blocks is not None:
            return blocks
    blocks = scan_blocks(path)
    try:
        store_blocks(path, blocks, config)
    except Exception:  # the write-through accelerates; it never fails a run
        log.debug("block-table write-through failed", exc_info=True)
    return blocks
