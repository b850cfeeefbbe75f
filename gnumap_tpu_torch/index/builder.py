"""Genome model + seed index, TPU-native.

Re-design of the reference's ``Genome``/``GenomeMem`` hash index (SURVEY.md §1
L1, §3.2 [REPO?]): the pointer-chasing k-mer hash table becomes **two dense
arrays** (CSR layout) so lookup is a vectorized gather on device:

    bucket_start : int32[4^m + 1]   prefix offsets per k-mer code
    positions    : int32[n_valid]   genome offsets, grouped by k-mer code

The genome itself is a dense int8 code array (A=0..T=3, N=4) concatenated
over contigs with N spacers — gather-friendly, no bit unpacking on the
compute path.  A 2-bit packed copy is used only for on-disk storage
(index/store.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from gnumap_tpu_torch.config import BASE_N, MapperConfig
from gnumap_tpu_torch.core import packing

SPACER_N = 64  # must match oracle.SPACER_N


@dataclasses.dataclass
class Genome:
    """Concatenated contig codes + contig table (reference contig table,
    SURVEY.md §3.2)."""
    codes: np.ndarray              # int8[G] concatenated with N spacers
    names: List[str]
    starts: np.ndarray             # int64[n_contigs]
    lengths: np.ndarray            # int64[n_contigs]

    @classmethod
    def from_contigs(cls, contigs: List[Tuple[str, str]]) -> "Genome":
        names, starts, lengths, parts = [], [], [], []
        off = 0
        spacer = np.full(SPACER_N, BASE_N, dtype=np.int8)
        for name, seq in contigs:
            c = packing.encode(seq) if isinstance(seq, (str, bytes)) \
                else np.asarray(seq, dtype=np.int8)
            names.append(name)
            starts.append(off)
            lengths.append(len(c))
            parts.append(c)
            parts.append(spacer)
            off += len(c) + SPACER_N
        codes = (np.concatenate(parts) if parts else np.zeros(0, np.int8))
        return cls(codes, names, np.asarray(starts, np.int64),
                   np.asarray(lengths, np.int64))

    @classmethod
    def from_fasta(cls, path: str) -> "Genome":
        from gnumap_tpu_torch.io import fastq as io_fastq
        return cls.from_contigs(io_fastq.read_fasta(path))

    def locate(self, pos) -> Tuple[np.ndarray, np.ndarray]:
        """Global offsets -> (contig index, contig-local 0-based offset).
        Vectorized; accepts scalars or arrays."""
        pos = np.asarray(pos, dtype=np.int64)
        idx = np.searchsorted(self.starts, pos, side="right") - 1
        return idx, pos - self.starts[idx]


@dataclasses.dataclass
class CsrIndex:
    """Dense-array k-mer seed index (hash-table-as-two-arrays)."""
    mer_size: int
    bucket_start: np.ndarray       # int32[4^m + 1]
    positions: np.ndarray          # int32[n_valid], grouped by k-mer

    @property
    def n_buckets(self) -> int:
        # 4^m for the normal index, 3^m for bisulfite collapsed tables
        return len(self.bucket_start) - 1

    def lookup(self, kmer: int) -> np.ndarray:
        s, e = self.bucket_start[kmer], self.bucket_start[kmer + 1]
        return self.positions[s:e]


def collapse_codes(codes: np.ndarray, mode: str) -> np.ndarray:
    """Bisulfite seeding alphabet collapse [FROZEN]: 'ct' folds C into T
    (plus-strand converted reads), 'ga' folds G into A (minus-strand).
    N (4) is preserved.  GNUMAP-bs seeds on the collapsed alphabet so
    conversion never breaks a seed (SURVEY.md §2 "Bisulfite mode")."""
    codes = np.asarray(codes)
    if mode == "ct":
        return np.where(codes == 1, np.int8(3), codes).astype(codes.dtype)
    if mode == "ga":
        return np.where(codes == 2, np.int8(0), codes).astype(codes.dtype)
    raise ValueError(f"unknown collapse mode {mode!r}")


# base-3 digit per raw code for collapsed k-mers [FROZEN]: the collapsed
# alphabet has 3 letters, so k-mer codes are base-3 — a dense 3^m table
# instead of a 4x-wasteful 4^m one, letting bisulfite use longer seeds
# (the collapsed alphabet is more repetitive, so it needs them).
# 'ct': A->0 G->1 {C,T}->2 ; 'ga': {A,G}->0 C->1 T->2 ; N -> -1 (invalid).
BS_DIGITS = {"ct": np.array([0, 2, 1, 2, -1], np.int8),
             "ga": np.array([0, 1, 0, 2, -1], np.int8)}


def kmer_codes_b3(codes: np.ndarray, m: int, collapse: str):
    """Base-3 collapsed k-mer codes + validity mask (no N in window)."""
    d = BS_DIGITS[collapse][np.asarray(codes, np.int64)]
    n = len(codes) - m + 1
    if n <= 0:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool))
    isn = d < 0
    base = np.where(isn, 0, d).astype(np.int64)
    kmers = np.zeros(n, dtype=np.int64)
    bad = np.zeros(n, dtype=np.int64)
    p3 = 1
    for k in range(m - 1, -1, -1):
        kmers += base[k:k + n] * p3
        bad += isn[k:k + n]
        p3 *= 3
    return kmers, bad == 0


@dataclasses.dataclass
class BsIndexPair:
    """Per-strand collapsed seed indexes for bisulfite mode: ``plus`` is
    built over the C->T-collapsed genome (for plus-strand reads, collapsed
    the same way), ``minus`` over the G->A-collapsed genome (for the
    reverse-complemented minus-strand reads)."""
    plus: CsrIndex
    minus: CsrIndex

    @property
    def mer_size(self) -> int:
        return self.plus.mer_size


def build_bs_index(genome: Genome, cfg: MapperConfig) -> BsIndexPair:
    return BsIndexPair(build_index(genome, cfg, collapse="ct"),
                       build_index(genome, cfg, collapse="ga"))


def build_index(genome: Genome, cfg: MapperConfig,
                collapse: "str | None" = None) -> CsrIndex:
    """Single-pass vectorized build (reference loop in SURVEY.md §3.2 done
    with bincount + stable argsort instead of hash insertions).

    Positions within each bucket are in ascending genome order (stable sort
    over the position-ordered stream) — the frozen candidate ordering.
    """
    m = cfg.mer_size
    if len(genome.codes) > np.iinfo(np.int32).max:
        raise ValueError("genome too large for int32 CSR offsets; "
                         "use shard-wise builds (config 5)")
    if collapse is None:
        from gnumap_tpu_torch.native import lib as native_lib
        if native_lib.available():
            bucket_start, positions = native_lib.build_csr_index(
                genome.codes, m)
            return CsrIndex(m, bucket_start, positions)
        kmers, valid = packing.kmer_codes(genome.codes, m)
        nb = 4 ** m
    else:
        kmers, valid = kmer_codes_b3(genome.codes, m, collapse)
        nb = 3 ** m
    vk = kmers[valid].astype(np.int64)
    vpos = np.nonzero(valid)[0].astype(np.int32)
    counts = np.bincount(vk, minlength=nb)
    bucket_start = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=bucket_start[1:])
    order = np.argsort(vk, kind="stable")
    positions = vpos[order]
    return CsrIndex(m, bucket_start.astype(np.int32), positions)
