"""Bridge from the reference package's state to the port's, so both run on
identical geometry and contig tables. It takes plain values (a field dict
and an array), never the reference package's objects."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spark_bam_tpu_torch.core.config import Config
from spark_bam_tpu_torch.tpu.stream_check import pad_contig_lengths


def from_reference(config_fields: dict, contig_lengths: np.ndarray):
    """``(Config, (1024,) int32 lengths tensor)`` from the reference
    ``Config``'s fields (``dataclasses.asdict``) and its contig lengths.
    Fields the port does not read are ignored; values it cannot serve raise
    ``ValueError`` as they would in ``Config``."""
    names = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in config_fields.items() if k in names})
    lens = pad_contig_lengths(np.asarray(contig_lengths, dtype=np.int32))
    return cfg, torch.from_numpy(lens)
