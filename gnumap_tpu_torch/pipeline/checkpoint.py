"""Streaming checkpoint/resume — gnumap_tpu/pipeline/checkpoint.py with the
port's BatchStats (the reference module imports its jax mapper).

Every N batches the stream state — batch count, partial coverage / SNP
tallies, stats, and the SAM byte offset — is written atomically (tmp +
rename).  On restart the mapper fast-forwards the read stream and truncates
the SAM file to the recorded offset, so an interrupted run merges to exactly
the same outputs as an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from gnumap_tpu_torch.pipeline.mapper import BatchStats


@dataclasses.dataclass
class StreamState:
    batches_done: int
    coverage: Optional[np.ndarray]
    tallies: Optional[np.ndarray]
    stats: BatchStats
    sam_offset: int


def save(path: str, state: StreamState) -> None:
    tmp = path + ".tmp"
    arrays = {}
    if state.coverage is not None:
        arrays["coverage"] = state.coverage
    if state.tallies is not None:
        arrays["tallies"] = state.tallies
    meta = {"batches_done": state.batches_done,
            "sam_offset": state.sam_offset,
            "stats": dataclasses.asdict(state.stats)}
    # large states write raw (compression stalls the stream at chr21-scale
    # coverage); small states stay compressed
    nbytes = sum(a.nbytes for a in arrays.values())
    savez = np.savez_compressed if nbytes < (64 << 20) else np.savez
    savez(tmp + ".npz", meta=json.dumps(meta), **arrays)
    os.replace(tmp + ".npz", path)


def load(path: str) -> Optional[StreamState]:
    if not os.path.exists(path):
        return None
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    stats = BatchStats(**meta["stats"])
    return StreamState(
        batches_done=int(meta["batches_done"]),
        coverage=z["coverage"] if "coverage" in z.files else None,
        tallies=z["tallies"] if "tallies" in z.files else None,
        stats=stats,
        sam_offset=int(meta["sam_offset"]))
