"""Genomes made from the seed: uniform random sequence at the configuration's
published length, optionally with repeat families stamped into it.  The
model is ``gnumap_tpu_torch/utils/sim.py``'s ``random_genome`` and
``random_genome_families``, returning codes instead of a string."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of one ``--seed``."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


@dataclasses.dataclass
class SimGenome:
    contig: str
    codes: np.ndarray                  # int8[G], A C G T = 0..3
    spots: Optional[List[np.ndarray]]  # per family, sorted copy starts
    unit_len: int = 0


def make_genome(config: dict, seed: int) -> SimGenome:
    """The configuration's genome: ``genome_len`` random bases; with a
    ``families`` group, ``n`` units of ``unit_len`` random bases, each
    stamped ``copies`` times at uniform spots, in family order."""
    rng = rng_for(seed, 0)
    n = int(config["genome_len"])
    codes = rng.integers(0, 4, size=n, dtype=np.int8)
    fam = config.get("families")
    spots = None
    if fam:
        ul = int(fam["unit_len"])
        spots = []
        for _ in range(int(fam["n"])):
            unit = rng.integers(0, 4, size=ul, dtype=np.int8)
            s = rng.integers(0, max(1, n - ul), size=int(fam["copies"]))
            for p in s:
                codes[p:p + ul] = unit
            spots.append(np.sort(s))
    return SimGenome(config["contig"], codes, spots,
                     int(fam["unit_len"]) if fam else 0)
