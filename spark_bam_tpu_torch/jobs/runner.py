"""Job runners: checkpointed rewrite, export and transcode (reference
``spark_bam_tpu/jobs/runner.py``).

Each runner drives its producer into a :class:`SegmentedOutput` and
journals a checkpoint at every durable segment boundary. Checkpoints sit
where the producer can re-enter exactly:

- **rewrite / transcode**: BGZF member boundaries. The codec is flushed
  (every complete payload becomes a member on disk; under a device codec
  every member is copied back to the host first), and the checkpoint
  records the writer's residual buffer (the tail under one block that no
  payload holds yet), its flat and compressed offsets, and the segment's
  block and record-start deltas. Resume skips the records already written
  and seeds a fresh ``BgzfWriter`` with the residue: payloads are carved
  and compressed independently, so the remaining members come out
  byte-identical to an uninterrupted run under host zlib and
  ``mode=fixed`` (``mode=auto`` is ``fixed`` on the card here).
- **export**: native-container frame boundaries. The frames are a pure
  function of (file, columns, columnar config): the device parse's rows
  come back in file order through ``columnar.export.FileOrder``, so a
  resume recomputes the stream and skips the first N frames without
  encoding them.

A mid-run ``ResourceExhausted`` (ENOSPC or EIO, real or injected) leaves
the journal and the committed segments in place; the manager pauses the
job, and a later run of the same spec resumes instead of restarting.

Every device step runs on the job's ``device`` (``None``: the current
CUDA device, raising without one); no step falls back to the host.
"""

from __future__ import annotations

import base64
import itertools
import os

from spark_bam_tpu_torch import obs
from spark_bam_tpu_torch.bam.writer import (
    BgzfWriter,
    WriteResult,
    encode_bam_header,
)
from spark_bam_tpu_torch.bgzf.block import Metadata
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.jobs.journal import Journal, SegmentedOutput


class JobCancelled(RuntimeError):
    """The manager's cancel flag was set; the job stopped at the next
    record or frame. Its committed checkpoints stay: a resubmit resumes."""


class _SegSink:
    """File-object face of a :class:`SegmentedOutput` for writers that
    call ``write`` and ``flush``."""

    def __init__(self, segout: SegmentedOutput):
        self._segout = segout

    def write(self, data: bytes) -> int:
        self._segout.write(data)
        return len(data)

    def flush(self) -> None:
        pass


def _flush_members(w: BgzfWriter) -> None:
    """Every complete payload through the codec and onto the segment,
    leaving only the residual tail in ``w.buf``: the state a checkpoint
    can serialize. ``_write_oldest`` copies a device batch's members back
    to the host before it writes them, so none is left in flight."""
    w._dispatch_batch()
    while w._pending:
        w._write_oldest()


def _drop_uncovered_segments(segout: SegmentedOutput, first: int) -> int:
    """Delete committed segments the journal does not cover (a crash
    between a segment's commit and its checkpoint); returns their bytes.
    The re-run writes them again, byte for byte."""
    lost = 0
    i = first
    while True:
        path = os.path.join(segout.dir, f"seg-{i:05d}")
        if not os.path.exists(path):
            return lost
        try:
            lost += os.path.getsize(path)
            os.unlink(path)
        except OSError:
            pass
        i += 1


def _open_job(job_dir: str, spec: dict
              ) -> "tuple[Journal, SegmentedOutput, dict | None, int]":
    """The recovered journal and segment directory of ``spec``:
    (journal, segout, last checkpoint or None, redone bytes)."""
    os.makedirs(job_dir, exist_ok=True)
    journal = Journal.open(os.path.join(job_dir, "journal.sbj"))
    if journal.last("spec") is None:
        journal.append({"t": "spec", "spec": spec})
    segout = SegmentedOutput(os.path.join(job_dir, "segments"))
    redone = segout.discard_parts()
    ck = journal.last("ckpt")
    redone += _drop_uncovered_segments(
        segout, (ck["seq"] + 1) if ck is not None else 0
    )
    if redone:
        obs.count("jobs.redone_bytes", redone)
    if ck is not None:
        obs.count("jobs.resumed")
    return journal, segout, ck, redone


def _note_checkpoint(nbytes: int) -> None:
    obs.count("jobs.checkpoints")
    obs.count("jobs.checkpoint_bytes", nbytes)


def _cancelled(cancel) -> bool:
    return cancel is not None and cancel.is_set()


# ----------------------------------------------------------------- rewrite

def run_rewrite_job(
    spec: dict,
    job_dir: str,
    config: Config = Config(),
    checkpoint: int = 5000,
    cancel=None,
    device=None,
) -> dict:
    """Checkpointed ``rewrite``: ``spec["path"]`` re-blocked and
    re-compressed into ``spec["out"]``, journaled every ``checkpoint``
    records. ``spec``'s keys are the serve ``rewrite`` op's: ``path``,
    ``out``, ``block_payload``, ``level``, ``deflate``, ``index``. The
    codec's lanes run on ``device``. Returns the result (also journaled in
    the ``done`` record); raises :class:`JobCancelled` when ``cancel``
    fires."""
    from spark_bam_tpu_torch.bam.iterators import RecordStream
    from spark_bam_tpu_torch.compress.codec import make_codec
    from spark_bam_tpu_torch.core.channel import open_channel
    from spark_bam_tpu_torch.rewrite import emit_sidecars

    journal, segout, ck, redone = _open_job(job_dir, spec)
    done = journal.last("done")
    if done is not None:
        journal.close()
        return dict(done["result"], resumed=True, redone_bytes=0)

    block_payload = int(spec.get("block_payload") or 0xFF00)
    level = int(spec.get("level") or 6)
    dspec = spec.get("deflate")
    if dspec is None:
        dspec = config.deflate
    try:
        codec = make_codec(dspec, level=level, device=device)
    except BaseException:
        journal.close()
        raise

    blocks: "list[Metadata]" = []
    flats: "list[int]" = []
    flats_new: "list[int]" = []
    skip = 0
    seg_next = 0
    header_len = 0
    checkpoints = 0
    if ck is not None:
        skip = int(ck["records"])
        seg_next = int(ck["seq"]) + 1
        header_len = int(ck["header_len"])
        for record in journal.records:
            if record.get("t") == "ckpt":
                blocks.extend(Metadata(*b) for b in record["blocks"])
                flats.extend(record["flats"])
                checkpoints += 1

    w = BgzfWriter(_SegSink(segout), block_payload, level, codec=codec)
    if ck is not None:
        w.buf = bytearray(base64.b64decode(ck["buf"]))
        w._flat = int(ck["flat"])
        w._offset = int(ck["offset"])
    mark = 0
    count = skip
    try:
        segout.begin(seg_next)
        with obs.span("jobs.rewrite", path=str(spec["path"]), resumed=skip):
            with open_channel(spec["path"]) as channel:
                stream = RecordStream.open(channel)
                if ck is None:
                    w.write(encode_bam_header(stream.header))
                    header_len = w.flat_tell
                for _, rec in itertools.islice(stream, skip, None):
                    flats_new.append(w.flat_tell)
                    w.write(rec.encode())
                    count += 1
                    if count % checkpoint == 0:
                        _flush_members(w)
                        _, nbytes = segout.commit()
                        delta = w.blocks[mark:]
                        journal.append({
                            "t": "ckpt", "seq": seg_next, "records": count,
                            "flat": w._flat, "offset": w._offset,
                            "buf": base64.b64encode(bytes(w.buf)).decode(),
                            "header_len": header_len, "seg_bytes": nbytes,
                            "blocks": [
                                [m.start, m.compressed_size,
                                 m.uncompressed_size]
                                for m in delta
                            ],
                            "flats": flats_new,
                        })
                        _note_checkpoint(nbytes)
                        checkpoints += 1
                        blocks.extend(delta)
                        flats.extend(flats_new)
                        mark = len(w.blocks)
                        flats_new = []
                        seg_next += 1
                        segout.begin(seg_next)
                    if _cancelled(cancel):
                        raise JobCancelled(f"job cancelled at {count} records")
            w.close()
            segout.commit()
            blocks.extend(w.blocks[mark:])
            flats.extend(flats_new)
            total = segout.assemble(spec["out"])
            result = WriteResult(
                count=count, header_len=header_len, blocks=blocks,
                record_flats=flats, bytes_out=w._offset,
            )
            sidecars = (
                emit_sidecars(spec["out"], result, config)
                if spec.get("index") else {}
            )
    except BaseException:
        segout.abort()
        journal.close()
        raise
    res = {
        "path": str(spec["path"]), "out": str(spec["out"]),
        "count": count, "n_blocks": len(blocks), "bytes_out": total,
        "sidecars": dict(sidecars), "checkpoints": checkpoints,
        "redone_bytes": redone, "resumed": bool(ck is not None),
    }
    journal.append({"t": "done", "result": res})
    segout.remove()
    journal.close()
    return res


# ------------------------------------------------------------------ export

def _export_frames(path, config: Config, ccfg, columns, device):
    """The export's frames, in file order: the device parse's pieces
    (``load.tpu_load.stream_ordered_batches``) rendered and merged by
    ``columnar.export.ordered_record_batches``, re-cut by a ``Rebatcher``
    at ``ccfg.batch_rows``; the same frames as ``load.api.export``'s."""
    from spark_bam_tpu_torch.columnar.export import ordered_record_batches
    from spark_bam_tpu_torch.columnar.schema import Rebatcher
    from spark_bam_tpu_torch.load.tpu_load import stream_ordered_batches

    pieces = stream_ordered_batches(path, config, device=device)
    batches = ordered_record_batches(pieces, columns)
    rebatcher = Rebatcher(ccfg.batch_rows)
    try:
        for batch in batches:
            yield from rebatcher.feed(batch)
        yield from rebatcher.flush()
    finally:
        # A cancelled or failed job stops the device parse here, not at
        # garbage collection.
        batches.close()
        pieces.close()


def run_export_job(
    spec: dict,
    job_dir: str,
    config: Config = Config(),
    checkpoint: int = 8,
    cancel=None,
    device=None,
) -> dict:
    """Checkpointed BAM → native-container export, journaled every
    ``checkpoint`` frames; the parse runs on ``device`` (``None``: the
    current CUDA device, raising without one), as ``load.api.export``'s
    does. The frames are a pure function of (path, columns, columnar
    config), so a resume recomputes and skips. ``spec``: ``path``,
    ``out``, optional ``columns`` and ``batch_rows``."""
    from dataclasses import replace

    from spark_bam_tpu_torch.bam.header import read_header
    from spark_bam_tpu_torch.columnar.native import (
        batch_frame,
        container_head,
        container_meta,
        end_frame,
    )
    from spark_bam_tpu_torch.columnar.schema import normalize_columns
    from spark_bam_tpu_torch.device import resolve_device

    journal, segout, ck, redone = _open_job(job_dir, spec)
    done = journal.last("done")
    if done is not None:
        journal.close()
        return dict(done["result"], resumed=True, redone_bytes=0)

    try:
        dev = resolve_device(device)
        ccfg = config.columnar_config
        if spec.get("batch_rows"):
            ccfg = replace(ccfg, batch_rows=int(spec["batch_rows"]))
        columns = normalize_columns(spec.get("columns") or ccfg.columns)
        header = read_header(spec["path"])
    except BaseException:
        journal.close()
        raise
    contigs = [(str(name), int(length)) for name, length in
               zip(header.contig_names, header.contig_lengths)]
    meta = container_meta(
        columns, codec=ccfg.codec, level=ccfg.level, contigs=contigs
    )

    skip = int(ck["frames"]) if ck is not None else 0
    seg_next = int(ck["seq"]) + 1 if ck is not None else 0
    rows = int(ck["rows"]) if ck is not None else 0
    offset = int(ck["offset"]) if ck is not None else 0
    frames = 0
    checkpoints = sum(1 for r in journal.records if r.get("t") == "ckpt")

    stream = _export_frames(spec["path"], config, ccfg, columns, dev)
    try:
        segout.begin(seg_next)
        with obs.span("jobs.export", path=str(spec["path"]), resumed=skip):
            if ck is None:
                head = container_head(meta)
                segout.write(head)
                offset += len(head)
            for frame in stream:
                frames += 1
                if frames <= skip:
                    # Durable already (its rows are in the checkpoint):
                    # recomputed, not encoded.
                    continue
                encoded = batch_frame(frame, meta)
                segout.write(encoded)
                rows += frame.num_rows
                offset += len(encoded)
                if (frames - skip) % checkpoint == 0:
                    _, nbytes = segout.commit()
                    journal.append({
                        "t": "ckpt", "seq": seg_next, "frames": frames,
                        "rows": rows, "offset": offset, "seg_bytes": nbytes,
                    })
                    _note_checkpoint(nbytes)
                    checkpoints += 1
                    seg_next += 1
                    segout.begin(seg_next)
                if _cancelled(cancel):
                    raise JobCancelled(f"job cancelled at {frames} frames")
            tail = end_frame(rows, frames)
            segout.write(tail)
            offset += len(tail)
            segout.commit()
            total = segout.assemble(spec["out"])
    except BaseException:
        stream.close()
        segout.abort()
        journal.close()
        raise
    res = {
        "path": str(spec["path"]), "out": str(spec["out"]),
        "format": "native", "columns": list(columns), "rows": rows,
        "batches": frames, "bytes_out": total,
        "checkpoints": checkpoints, "redone_bytes": redone,
        "resumed": bool(ck is not None),
    }
    journal.append({"t": "done", "result": res})
    segout.remove()
    journal.close()
    return res


# --------------------------------------------------------------- transcode

def run_transcode_job(
    spec: dict,
    job_dir: str,
    config: Config = Config(),
    checkpoint: int = 5000,
    cancel=None,
    device=None,
) -> dict:
    """Fleet re-compression: a rewrite job with its sidecars forced on, so
    the output serves warm loads at once."""
    return run_rewrite_job(
        dict(spec, index=True), job_dir,
        config=config, checkpoint=checkpoint, cancel=cancel, device=device,
    )


RUNNERS = {
    "rewrite": run_rewrite_job,
    "export": run_export_job,
    "transcode": run_transcode_job,
}
