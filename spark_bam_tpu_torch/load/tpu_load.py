"""The load path (reference ``spark_bam_tpu/load/tpu_load.py``): BGZF
blocks → windows on the device → boundary check → columnar record parse
with the interval/flag filters where the columns are.

- ``record_starts``: every record-start flat offset of a file, from the
  whole-file check (``TpuChecker.check_buffer``), or from a valid ``.sbi``
  sidecar with no checker work when ``Config.cache`` reads (a miss writes
  the starts through when it writes);
- ``record_starts_streaming``: the same per window, in O(window) memory;
- ``count_reads_tpu``: the record count, per-window counts reduced on the
  device;
- ``stream_read_batches``: ``ReadBatch``es per window, filtered;
- ``stream_ordered_batches``: the export's records (the record path's
  chains over the checker's starts) with each row's flat offset and a
  floor, for the export's merge into file order;
- ``load_reads_columnar``: one ``ReadBatch`` of every (or every filtered)
  record of a file.

Every entry point runs on the CUDA device unless ``device`` names another
(``device="cpu"`` runs the plain versions).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spark_bam_tpu_torch.bam.header import read_header
from spark_bam_tpu_torch.bgzf.flat import FlatView, flatten_file
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.core.pos import Pos
from spark_bam_tpu_torch.device import resolve_device
from spark_bam_tpu_torch.load.intervals import LociSet
from spark_bam_tpu_torch.tpu.checker import TpuChecker
from spark_bam_tpu_torch.tpu.parser import (
    ReadBatch,
    interval_flag_filter,
    parse_flat_records,
)
from spark_bam_tpu_torch.tpu.stream_check import StreamChecker


@dataclass
class TpuLoadResult:
    view: FlatView
    header: object
    starts: np.ndarray  # flat record-start offsets

    def positions(self) -> list[Pos]:
        blocks, offs = self.view.pos_of_flat_many(self.starts)
        return [Pos(int(b), int(o)) for b, o in zip(blocks, offs)]


def _cached_record_starts(view, path, config, store, strict):
    """Flat record-start offsets from a valid ``.sbi`` sidecar, or None.
    The sidecar holds virtual positions; they map to flat offsets through
    the view's block tables."""
    from spark_bam_tpu_torch.sbi.format import (
        SbiFormatError,
        record_starts_to_flat,
    )

    index = store.load(path, config, strict=strict)
    if index is None or index.record_starts is None:
        return None
    try:
        return record_starts_to_flat(view, index.record_starts)
    except SbiFormatError:
        # A position names a block the file lacks (the fingerprint should
        # preclude it): recompute rather than trust it.
        return None


def record_starts(path, config: Config = Config(),
                  checker: TpuChecker | None = None,
                  device=None, view: FlatView | None = None) -> TpuLoadResult:
    """Whole-file record starts with the flat view retained (small files,
    callers that need the bytes); ``view`` is the file's flat view when
    the caller already holds it. For inputs larger than memory use
    ``record_starts_streaming`` or ``count_reads_tpu``. With
    ``Config.cache`` on, a valid ``.sbi`` sidecar supplies the starts
    with no checker work, and a miss writes them through."""
    from spark_bam_tpu_torch.sbi.store import CacheStore

    dev = resolve_device(device) if checker is None else checker.device
    header = read_header(path)
    view = flatten_file(path) if view is None else view
    mode = config.cache_mode
    store = CacheStore.from_env() if mode.enabled else None
    if store is not None and mode.read:
        starts = _cached_record_starts(view, path, config, store, mode.strict)
        if starts is not None:
            return TpuLoadResult(view, header, starts)
    if checker is None:
        # Size the window to the input: a small file in one kernel call,
        # big files through config.window_size windows, as powers of two.
        want = min(config.window_size, max(view.size, 1))
        window = 1 << max(20, (want - 1).bit_length())
        checker = TpuChecker(
            header.contig_lengths, window=window,
            halo=min(config.halo_size, window // 4),
            reads_to_check=config.reads_to_check, device=dev,
        )
    res = checker.check_buffer(view.data, at_eof=True)
    # The header's uncompressed size is the flat offset of record 0.
    starts = np.flatnonzero(res.verdict)
    starts = starts[starts >= header.uncompressed_size]
    if store is not None and mode.write:
        from spark_bam_tpu_torch.sbi.format import (
            SbiIndex,
            fingerprint_of,
            record_starts_to_virtual,
        )

        store.merge_and_store(
            path, config,
            SbiIndex(fingerprint_of(path, config),
                     record_starts=record_starts_to_virtual(view, starts)),
        )
    return TpuLoadResult(view, header, starts)


def record_starts_streaming(path, config: Config = Config(), device=None):
    """Absolute flat record-start offsets, streamed per window in
    O(window) host memory."""
    yield from StreamChecker(path, config, device=device).record_starts()


def _interval_table(header, loci: LociSet | str) -> np.ndarray:
    """(R, 3) int32 rows of (ref_id, start, end) for the device filter; a
    contig the header lacks is skipped, and ``(-2, 0, 0)`` stands for an
    empty table."""
    if isinstance(loci, str):
        loci = LociSet.parse(loci, header)
    name_to_idx = {name: idx for idx, name in enumerate(header.contig_names)}
    rows = []
    for contig, ivs in loci.intervals.items():
        if contig not in name_to_idx:
            continue
        ref = name_to_idx[contig]
        if not ivs:
            ivs = [(0, int(header.contig_lengths[ref]))]
        rows.extend((ref, s, e) for s, e in ivs)
    return np.array(rows or [(-2, 0, 0)], dtype=np.int32)


#: tag value-type byte → fixed payload size; Z/H are NUL-terminated and
#: B is typed-array-counted, both handled inline by the scan.
_TAG_SIZES = {
    ord("A"): 1, ord("c"): 1, ord("C"): 1,
    ord("s"): 2, ord("S"): 2,
    ord("i"): 4, ord("I"): 4, ord("f"): 4,
}


def _tag_presence_mask(batch: ReadBatch, tags_required) -> np.ndarray:
    """Per-row mask: does the record's tag region hold every tag in
    ``tags_required`` (two-character names, e.g. ``("NM", "MD")``)?

    Every offset is clamped to the buffer, the walk is bounded by the
    record's declared extent, and a malformed entry (unknown type byte,
    truncated payload, unbounded B-array count) stops the walk: the tags
    after it read as absent. The walk never raises on record bytes."""
    cols = batch.columns
    buf = batch.buf
    wanted = [t.encode("latin-1") for t in tags_required]
    mask = np.zeros(len(cols["valid"]), dtype=bool)
    if buf is None:
        raise ValueError(
            "tag filter needs the flat record buffer (batch.buf)"
        )
    nbuf = len(buf)
    starts = batch.starts
    name_off = cols["name_offset"]
    l_name = cols["l_read_name"]
    n_cigar = cols["n_cigar"]
    l_seq = cols["l_seq"]
    block_size = cols["block_size"]
    for i in np.flatnonzero(cols["valid"]):
        ls = int(l_seq[i])
        p = (int(name_off[i]) + int(l_name[i]) + 4 * int(n_cigar[i])
             + (ls + 1) // 2 + ls)
        end = int(starts[i]) + 4 + int(block_size[i])
        end = max(0, min(end, nbuf))
        p = max(0, min(p, end))
        present = set()
        while p + 3 <= end:
            tag = bytes(buf[p: p + 2])
            typ = int(buf[p + 2])
            p += 3
            if typ in _TAG_SIZES:
                q = p + _TAG_SIZES[typ]
            elif typ in (ord("Z"), ord("H")):
                nuls = np.flatnonzero(buf[p:end] == 0)
                if len(nuls) == 0:
                    break                     # unterminated: stop clean
                q = p + int(nuls[0]) + 1
            elif typ == ord("B"):
                if p + 5 > end:
                    break
                elem = _TAG_SIZES.get(int(buf[p]))
                count = (int(buf[p + 1]) | (int(buf[p + 2]) << 8)
                         | (int(buf[p + 3]) << 16) | (int(buf[p + 4]) << 24))
                if elem is None or count < 0 or count > end - p:
                    break                     # malformed: stop clean
                q = p + 5 + elem * count
            else:
                break                         # unknown type byte: stop clean
            if q > end:
                break                         # truncated payload: stop clean
            present.add(tag)
            p = q
        mask[i] = all(t in present for t in wanted)
    return mask


def _apply_filter(
    batch: ReadBatch,
    header,
    loci: LociSet | str | None,
    flags_required: int,
    flags_forbidden: int,
    tags_required=None,
    device=None,
) -> ReadBatch:
    """Narrow a batch's ``valid`` mask by loci, flags and tag presence.
    Flag-only filtering is a pure flag predicate (unmapped reads pass
    unless a flag excludes them); only a loci filter imposes the rule that
    unmapped reads never overlap (CanLoadBam.scala:109-133), and it runs
    on ``device``. ``tags_required`` names two-character tags that must
    all be present in a record's tag region."""
    if tags_required:
        for t in tags_required:
            if not isinstance(t, str) or len(t) != 2:
                raise ValueError(
                    f"Bad tag name {t!r}: expected two characters (e.g. 'NM')"
                )
        batch.columns["valid"] = (
            batch.columns["valid"] & _tag_presence_mask(batch, tags_required)
        )
    if loci is None:
        flag = batch.columns["flag"]
        ok = ((flag & flags_required) == flags_required) & (
            (flag & flags_forbidden) == 0
        )
        batch.columns["valid"] = batch.columns["valid"] & ok
        return batch
    dev = resolve_device(device)
    cols = {k: torch.from_numpy(batch.columns[k]).to(dev)
            for k in ("pos", "ref_span", "ref_id", "flag", "valid")}
    ivs = torch.from_numpy(_interval_table(header, loci)).to(dev)
    mask = interval_flag_filter(cols, ivs, flags_required,
                                flags_forbidden).cpu().numpy()
    batch.columns["valid"] = batch.columns["valid"] & mask
    return batch


def stream_read_batches(
    path,
    config: Config = Config(),
    loci: LociSet | str | None = None,
    flags_required: int = 0,
    flags_forbidden: int = 0,
    device=None,
):
    """Columnar ``ReadBatch``es per streaming window in O(window) host
    memory, with the interval/flag filters applied per window. Yields
    ``(abs_base, batch)``; ``(-1, batch)`` entries carry records longer
    than the window's lookahead, decoded exactly from the seekable
    stream."""
    checker = StreamChecker(path, config, device=device)
    gen = checker.read_batches()
    if loci is None and not flags_required and not flags_forbidden:
        yield from gen
        return
    for base, batch in gen:
        yield base, _apply_filter(batch, checker.header, loci, flags_required,
                                  flags_forbidden, device=checker.device)


def stream_ordered_batches(
    path,
    config: Config = Config(),
    loci: LociSet | str | None = None,
    flags_required: int = 0,
    flags_forbidden: int = 0,
    device=None,
):
    """The export's records, for consumers that put rows back in file
    order: ``(abs_starts, batch, floor)`` items from
    ``StreamChecker.ordered_read_batches``, following the record path's
    split chains (``load.record_chain``: a refused record that a chain
    runs through is read, at ``config``'s split size), filtered as
    ``stream_read_batches`` filters. Nothing runs until the first item is
    asked for."""
    from spark_bam_tpu_torch.load.record_chain import RecordChain

    checker = StreamChecker(path, config, device=device)
    chain = RecordChain(
        checker, config.split_size_or(Config.LOAD_SPLIT_SIZE_DEFAULT))
    filtered = loci is not None or flags_required or flags_forbidden
    for abs_starts, batch, floor in chain.follow(
            checker.ordered_read_batches()):
        if filtered:
            batch = _apply_filter(batch, checker.header, loci,
                                  flags_required, flags_forbidden,
                                  device=checker.device)
        yield abs_starts, batch, floor


def count_reads_tpu(path, config: Config = Config(), device=None) -> int:
    """count-reads through the streaming checker: O(window) host memory,
    per-window counts reduced on the device."""
    return StreamChecker(path, config, device=device).count_reads()


def load_reads_columnar(
    path,
    loci: LociSet | str | None = None,
    flags_required: int = 0,
    flags_forbidden: int = 0,
    config: Config = Config(),
    device=None,
) -> ReadBatch:
    """All records of a BAM as columnar arrays, filters applied."""
    dev = resolve_device(device)
    result = record_starts(path, config, device=dev)
    batch = parse_flat_records(result.view.data, result.starts, device=dev)
    if loci is None and not flags_required and not flags_forbidden:
        return batch
    return _apply_filter(batch, result.header, loci, flags_required,
                         flags_forbidden, device=dev)
