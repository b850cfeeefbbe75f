"""The read pool of a traffic mix, made from the seed, and its FASTQ file.

A vectorised copy of ``gnumap_tpu_torch/utils/sim.py``'s ``simulate_reads``
model: uniform start and strand, Phred qualities uniform in [qual_lo,
qual_hi], substitutions biased to low qualities, optionally one 1-2 bp
insertion or deletion, and reads planted inside repeat-family copies at
starts every ``repeat_start_step`` bases.  Exact counts replace the
simulator's per-read coin flips (indel and repeat reads), so that every seed
gives the same amount of each kind of work; a permutation spreads them over
the pool.  The truth rides in the read name as the simulator writes it,
``sim_<idx>_<contig>_<pos>_<strand>``, with the numbers zero-padded so that
every FASTQ record has one length.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from mapbench.genome import SimGenome, rng_for

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)
_ACGT = np.frombuffer(b"ACGTN", dtype=np.uint8)
POS_DIGITS = 9
CHUNK = 1 << 16


@dataclasses.dataclass
class Pool:
    codes: np.ndarray      # int8[n, L]
    quals: np.ndarray      # int8[n, L] Phred
    pos: np.ndarray        # int64[n] 0-based truth start in the contig
    minus: np.ndarray      # bool[n]
    repeat: np.ndarray     # bool[n] planted in a family copy
    indel: np.ndarray      # bool[n]

    @property
    def n(self) -> int:
        return len(self.pos)

    @property
    def read_len(self) -> int:
        return self.codes.shape[1]


def _spread(rng, n: int, k: int) -> np.ndarray:
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:k]] = True
    return mask


def make_pool(genome: SimGenome, mix: dict, seed: int,
              n_reads: int = None) -> Pool:
    """``mix['pool_reads']`` reads (or ``n_reads``) of ``mix['read_len']``
    bases from ``genome``."""
    rng = rng_for(seed, 1)
    n = int(n_reads or mix["pool_reads"])
    L = int(mix["read_len"])
    g = genome.codes
    G = len(g)
    minus = rng.random(n) < 0.5
    pos = rng.integers(0, G - L - 4 + 1, size=n).astype(np.int64)
    repeat = _spread(rng, n, int(n * float(mix.get("repeat_read_frac", 0))))
    if repeat.any():
        ul = genome.unit_len
        starts = (np.concatenate(genome.spots)[:, None] + np.arange(
            0, ul - L, int(mix["repeat_start_step"]))[None, :]).ravel()
        pick = starts[rng.integers(0, len(starts), size=int(repeat.sum()))]
        pos[repeat] = np.minimum(pick, G - L - 4)
    indel = _spread(rng, n, int(round(n * float(mix.get("indel_rate", 0)))))
    col = np.arange(L, dtype=np.int32)
    frag = g[pos.astype(np.int32)[:, None] + col[None, :]]
    rows = np.nonzero(indel)[0]
    if len(rows):
        at = rng.integers(4, L - 6, size=len(rows))[:, None]
        k = rng.integers(1, 3, size=len(rows))[:, None]
        deletion = (rng.random(len(rows)) < 0.5)[:, None]
        src = pos[rows][:, None] + col[None, :]
        after = col[None, :] >= at
        src = np.where(deletion & after, src + k, src)
        src = np.where(~deletion & (col[None, :] >= at + k), src - k, src)
        inserted = ~deletion & after & (col[None, :] < at + k)
        frag[rows] = np.where(inserted, rng.integers(
            0, 4, size=(len(rows), L), dtype=np.int8), g[src])
    frag[minus] = _COMP[frag[minus]][:, ::-1]
    qlo, qhi = int(mix["qual_lo"]), int(mix["qual_hi"])
    quals = rng.integers(qlo, qhi + 1, size=(n, L), dtype=np.int8)
    # substitution probability by quality, biased to low qualities
    p_err = np.zeros(qhi + 1, np.float32)
    q = np.arange(qlo, qhi + 1)
    p_err[qlo:] = float(mix["sub_rate"]) * (qhi + 1 - q) / (qhi + 1 - qlo)
    err = rng.random((n, L), dtype=np.float32) < p_err[quals]
    shift = rng.integers(1, 4, size=(n, L), dtype=np.int8)
    codes = np.where(err, (frag + shift) % 4, frag).astype(np.int8)
    return Pool(codes, quals, pos, minus, repeat, indel)


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    out = np.empty((len(values), width), np.uint8)
    v = values.astype(np.int64).copy()
    for i in range(width - 1, -1, -1):
        out[:, i] = 48 + v % 10
        v //= 10
    return out


def read_names(pool: Pool, contig: str, lo: int = 0, hi: int = None):
    """uint8[k, name_len]: the names of reads lo..hi."""
    hi = pool.n if hi is None else hi
    idx_w = max(7, len(str(pool.n - 1)))
    k = hi - lo
    parts = [np.frombuffer(b"sim_", np.uint8)[None].repeat(k, 0),
             _digits(np.arange(lo, hi), idx_w),
             np.frombuffer(f"_{contig}_".encode(), np.uint8)[None].repeat(
                 k, 0),
             _digits(pool.pos[lo:hi], POS_DIGITS),
             np.frombuffer(b"_", np.uint8)[None].repeat(k, 0),
             np.where(pool.minus[lo:hi], ord("-"), ord("+")).astype(
                 np.uint8)[:, None]]
    return np.concatenate(parts, 1)


def write_fastq(pool: Pool, contig: str, path: str, phred_offset: int = 33
                ) -> int:
    """The pool as FASTQ, in pool order; returns the bytes written."""
    L = pool.read_len
    nl = np.full((1, 1), 10, np.uint8)
    total = 0
    with open(path, "wb") as f:
        for lo in range(0, pool.n, CHUNK):
            hi = min(pool.n, lo + CHUNK)
            k = hi - lo
            rec = np.concatenate([
                np.full((k, 1), ord("@"), np.uint8),
                read_names(pool, contig, lo, hi), nl.repeat(k, 0),
                _ACGT[pool.codes[lo:hi].astype(np.int64)], nl.repeat(k, 0),
                np.full((k, 1), ord("+"), np.uint8), nl.repeat(k, 0),
                (pool.quals[lo:hi] + phred_offset).astype(np.uint8),
                nl.repeat(k, 0)], 1)
            f.write(rec.tobytes())
            total += rec.size
        # on disk before the window opens: no write-back during it
        f.flush()
        os.fsync(f.fileno())
    return total


def names_at(pool: Pool, contig: str, idx: np.ndarray) -> list:
    """The names of the reads at pool indices ``idx``."""
    return [read_names(pool, contig, int(i), int(i) + 1)[0].tobytes()
            .decode("ascii") for i in idx]
