"""The ``check-bam`` and ``check-blocks`` reports as TSV rows (reference
``spark_bam_tpu/benchmarks/harvest.py``; its source, the reference's
benchmarks module, BAM.scala:5-192 and TSV.scala:201-238): each report's
lines are matched against the report's fixed shapes and gathered into one
``BamInfo`` a file.

Usage:
    python -m spark_bam_tpu_torch.benchmarks.harvest OUT1 [OUT2 ...] > results.tsv
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass


@dataclass
class BamInfo:
    path: str = ""
    uncompressed_positions: int | None = None
    compressed_size: str | None = None
    compression_ratio: float | None = None
    num_reads: int | None = None
    false_positives: int = 0
    false_negatives: int = 0
    all_matched: bool = False
    # check-blocks
    num_blocks: int | None = None
    bad_blocks: int = 0
    bad_compressed_positions: int = 0
    total_compressed_positions: int | None = None

    FIELDS = (
        "path", "uncompressed_positions", "compressed_size",
        "compression_ratio", "num_reads", "false_positives",
        "false_negatives", "all_matched", "num_blocks", "bad_blocks",
        "bad_compressed_positions", "total_compressed_positions",
    )

    def tsv_row(self) -> str:
        return "\t".join("" if getattr(self, f) is None
                         else str(getattr(self, f)) for f in self.FIELDS)


_PATTERNS = [
    (re.compile(r"^(\d+) uncompressed positions"),
     lambda m, b: setattr(b, "uncompressed_positions", int(m.group(1)))),
    (re.compile(r"^(\S+) compressed$"),
     lambda m, b: setattr(b, "compressed_size", m.group(1))),
    (re.compile(r"^Compression ratio: ([\d.]+)"),
     lambda m, b: setattr(b, "compression_ratio", float(m.group(1)))),
    (re.compile(r"^(\d+) reads$"),
     lambda m, b: setattr(b, "num_reads", int(m.group(1)))),
    (re.compile(r"^(\d+) false positives, (\d+) false negatives"),
     lambda m, b: (setattr(b, "false_positives", int(m.group(1))),
                   setattr(b, "false_negatives", int(m.group(2))))),
    (re.compile(r"^All calls matched!"),
     lambda m, b: setattr(b, "all_matched", True)),
    (re.compile(r"^First read-position matched in (\d+) BGZF blocks"),
     lambda m, b: (setattr(b, "num_blocks", int(m.group(1))),
                   setattr(b, "all_matched", True))),
    (re.compile(r"^First read-position mismatched in (\d+) of (\d+) BGZF "
                r"blocks"),
     lambda m, b: (setattr(b, "bad_blocks", int(m.group(1))),
                   setattr(b, "num_blocks", int(m.group(2))))),
    (re.compile(r"^(\d+) of (\d+) \([\d.eE-]+\) compressed positions would "
                r"lead"),
     lambda m, b: (setattr(b, "bad_compressed_positions", int(m.group(1))),
                   setattr(b, "total_compressed_positions",
                           int(m.group(2))))),
]


def parse_output(path: str) -> BamInfo:
    """The ``BamInfo`` of one report file: the first shape each line
    matches sets its fields."""
    info = BamInfo(path=path)
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            for pattern, action in _PATTERNS:
                m = pattern.match(line)
                if m:
                    action(m, info)
                    break
    return info


def main(argv=None) -> int:
    paths = argv if argv is not None else sys.argv[1:]
    print("\t".join(BamInfo.FIELDS))
    for path in paths:
        print(parse_output(path).tsv_row())
    return 0


if __name__ == "__main__":
    sys.exit(main())
