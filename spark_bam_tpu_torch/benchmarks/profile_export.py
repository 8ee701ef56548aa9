"""Where the time of a columnar export goes on the GPU.

    python -m spark_bam_tpu_torch.benchmarks.profile_export [--mib 1024]
        [--columns flag,pos,name,cigar] [--columnar codec=zlib]
        [--format native]

Writes a synthetic BAM (``--mib`` MiB uncompressed, seed 7) under the
package's ``_build/`` directory and exports it once on the card
(``load.api.export``) with the given projection, columnar spec and
format, timing on the host clock:

- the stream: the pieces out of ``stream_ordered_batches`` (the load's
  check and parse of every window, spills, the filter);
- the render (``from_parser.render_columns``);
- the dictionary pass (``native.dictionary``), the rest of the encoding
  (``sink.batch_frame`` less the dictionary pass) and the write
  (``NativeSink.write`` less the encoding; native format only);
- what is left: the merge into file order, the frames' concatenation
  and slicing, the commit.

Prints the card's name and power limit and, last, one JSON line.
``timed_export`` is the same measurement over any BAM, for the smoke.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import torch

from spark_bam_tpu_torch.benchmarks.profile_count import _card
from spark_bam_tpu_torch.benchmarks.synth import synth_bam
from spark_bam_tpu_torch.columnar import export as cex
from spark_bam_tpu_torch.columnar import native, sink
from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.load import api

SPLIT = ("stream", "render", "dictionary", "encode", "write", "hook")


def timed_export(path, out, on_piece=None, **kw) -> tuple[dict, dict]:
    """``api.export(path, out, **kw)`` with its wall split (seconds).
    ``on_piece(item)`` runs on every piece outside the timed parts; its
    time is ``hook``, and the export's ``wall`` leaves it out."""
    spent = dict.fromkeys(SPLIT, 0.0)
    real = {(api, "stream_ordered_batches"): api.stream_ordered_batches,
            (cex, "render_columns"): cex.render_columns,
            (native, "dictionary"): native.dictionary,
            (sink, "batch_frame"): sink.batch_frame,
            (sink.NativeSink, "write"): sink.NativeSink.write}

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    def stream(*a, **k):
        it = real[(api, "stream_ordered_batches")](*a, **k)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            spent["stream"] += time.perf_counter() - t0
            if item is None:
                return
            if on_piece is not None:
                t0 = time.perf_counter()
                on_piece(item)
                spent["hook"] += time.perf_counter() - t0
            yield item

    api.stream_ordered_batches = stream
    cex.render_columns = timed("render", cex.render_columns)
    native.dictionary = timed("dictionary", native.dictionary)
    sink.batch_frame = timed("encode", sink.batch_frame)
    sink.NativeSink.write = timed("write", sink.NativeSink.write)
    try:
        t0 = time.perf_counter()
        summary = api.export(path, out, **kw)
        wall = time.perf_counter() - t0 - spent["hook"]
    finally:
        for (owner, name), fn in real.items():
            setattr(owner, name, fn)
    # encode holds the dictionary pass, and write holds encode.
    split = {
        "wall": wall,
        "stream": spent["stream"],
        "render": spent["render"],
        "dictionary": spent["dictionary"],
        "encode": spent["encode"] - spent["dictionary"],
        "write": spent["write"] - spent["encode"],
        "order_and_rest": (wall - spent["stream"] - spent["render"]
                           - spent["write"]),
        "hook": spent["hook"],
    }
    return summary, split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=1024)
    ap.add_argument("--columns", default=None)
    ap.add_argument("--columnar", default="")
    ap.add_argument("--format", default="native",
                    choices=("native", "arrow", "parquet"))
    args = ap.parse_args(argv)
    card = _card()
    print(card, flush=True)
    work = Path(__file__).resolve().parent.parent / "_build" / "profile_export"
    work.mkdir(parents=True, exist_ok=True)
    bam = work / "export.bam"
    manifest = synth_bam(bam, args.mib << 20, seed=7)
    out = work / "export.out"
    torch.cuda.synchronize()
    summary, split = timed_export(
        bam, out, fmt=args.format, columns=args.columns,
        config=Config(columnar=args.columnar))
    size = os.path.getsize(out)
    out.unlink()
    print(f"export {summary['rows']} rows in {summary['batches']} batches, "
          f"{size} bytes ({args.format}, {args.columnar or 'defaults'}, "
          f"[{','.join(summary['columns'])}]): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
          + f"; {summary['rows'] / split['wall']:.0f} reads/s ({card})",
          flush=True)
    print(json.dumps({"card": card, "bam": manifest, "bytes": size,
                      "summary": {k: v for k, v in summary.items()
                                  if k != "path"}, "split_s": split}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
