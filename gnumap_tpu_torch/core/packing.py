"""Sequence primitives: base encoding, 2-bit packing, reverse complement,
k-mer codes.

TPU-native re-design of the reference's packed-sequence layer (SURVEY.md §1 L0,
reference files ``bin_seq.{h,cpp}`` / ``SequenceOperations.*`` [REPO?,
unverified — mount empty]).  Instead of C++ bit tricks over words, sequences
live as dense ``int8`` code arrays (one base per byte, ideal for XLA gathers)
with an optional 2-bit packed form for compact on-disk index storage.
"""

from __future__ import annotations

import numpy as np

from gnumap_tpu_torch.config import BASE_N

# ASCII -> base code lookup (A=0 C=1 G=2 T=3, everything else = N=4).
_LUT = np.full(256, BASE_N, dtype=np.int8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3),
                   ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    _LUT[ord(_ch)] = _code

_CODE2CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement: A<->T, C<->G, N->N
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> int8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _LUT[np.frombuffer(seq, dtype=np.uint8)].copy()


def decode(codes: np.ndarray) -> str:
    return _CODE2CHAR[np.asarray(codes, dtype=np.int64)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of an int8 code array (N maps to N)."""
    return _COMP[np.asarray(codes, dtype=np.int64)][::-1].astype(np.int8)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes into 2 bits each (uint32 words, 16 bases/word).

    N bases pack as A; callers needing N-awareness must keep a validity mask.
    Used only for compact index storage, not on the compute path.
    """
    codes = np.asarray(codes, dtype=np.uint32) & 3
    n = len(codes)
    pad = (-n) % 16
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint32)])
    words = codes.reshape(-1, 16)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    return (words << shifts).sum(axis=1, dtype=np.uint32)


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    words = np.asarray(words, dtype=np.uint32)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    codes = ((words[:, None] >> shifts) & 3).reshape(-1)
    return codes[:n].astype(np.int8)


def kmer_codes(codes: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-mer integer codes of a sequence, plus a validity mask.

    Returns ``(kmers, valid)`` of length ``len(codes) - m + 1`` where
    ``kmers[p]`` is the base-4 big-endian code of ``codes[p:p+m]`` and
    ``valid[p]`` is False when the window contains an N.
    Vectorized equivalent of the reference's per-position hash loop
    (SURVEY.md §3.2).
    """
    codes = np.asarray(codes)
    n = len(codes) - m + 1
    if n <= 0:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool))
    base = np.where(codes == BASE_N, 0, codes).astype(np.int64)
    isn = (codes == BASE_N)
    # Sliding-window polynomial accumulate: kmers[p] = sum_k base[p+k]*4^(m-1-k)
    kmers = np.zeros(n, dtype=np.int64)
    valid = np.zeros(n, dtype=np.int64)
    for k in range(m):
        kmers += base[k:k + n] << (2 * (m - 1 - k))
        valid += isn[k:k + n]
    return kmers, valid == 0
