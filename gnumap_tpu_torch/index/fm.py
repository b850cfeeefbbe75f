"""FM-index (BWT) seed-lookup backend — the counterpart of
gnumap_tpu/index/fm.py: the numpy half (suffix array, BWT, rank checkpoints,
host search, save / load) is a copy, kept line for line; the device search
(``fm_ranges``, ``fm_hits``) is written in torch ops on the caller's device.

Layout, as the reference keeps it (no pointer chasing, every query step a
dense gather):

  * suffix array: full int32[n+1] on the device (positions resolve with ONE
    gather ``sa[lo:lo+cap]``, no sampled-SA LF-walk);
  * BWT: 4-bit packed int32 words, 8 symbols a word (code j in bits
    4j..4j+3, ``pack_4bit``);
  * Occ: rank checkpoints every 32 symbols, int32[nb, 8]; a rank query is a
    checkpoint gather plus a masked count over the 4 words of its block;
  * backward search: ``mer_size`` fixed steps.

Alphabet: $=0, A..T=1..4, N=5 ($ least — standard FM convention).

Candidate-set equivalence with the CSR index: a seed k-mer (never contains
N) matches exactly the genome positions whose next ``m`` codes equal it, so
the SA range holds the same position SET the CSR bucket holds and the same
occurrence COUNT (the max-hits cap skip decision).  The mapper sorts and
dedupes candidates (``pipeline/mapper.dedupe_cap``), so the order in which
FM returns them (suffix-array order) cannot change the output.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.index.builder import Genome, collapse_codes

OCC_BLOCK = 32          # symbols per rank checkpoint
N_SYMS = 8              # $, A, C, G, T, N (padded to 8 for gather alignment)
BASES_PER_WORD = 8


def pack_4bit(codes: np.ndarray) -> np.ndarray:
    """int8 symbols (0..15) -> int32 words, 8 symbols per word, little-end
    nibble order (symbol j in bits 4j..4j+3); the tail pads with 4."""
    codes = np.asarray(codes, dtype=np.uint32) & 0xF
    pad = (-len(codes)) % BASES_PER_WORD
    if pad:
        codes = np.concatenate([codes, np.full(pad, 4, np.uint32)])
    w = codes.reshape(-1, BASES_PER_WORD)
    shifts = (np.arange(BASES_PER_WORD, dtype=np.uint32) * 4)[None, :]
    return (w << shifts).sum(axis=1, dtype=np.uint32).view(np.int32)


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array of codes + terminal sentinel.  Returns int32[n + 1];
    sa[0] = n (the sentinel suffix).  Uses the native linear-time SA-IS
    (native/suffix.cpp) when available; the numpy prefix-doubling below
    (O(n log^2 n)) is the always-available fallback and the conformance
    reference for it."""
    from gnumap_tpu_torch.native import lib as native_lib
    if native_lib.available():
        return native_lib.suffix_array(codes)
    t = np.concatenate([np.asarray(codes, np.int64) + 1, [0]])
    n = len(t)
    rank = t.copy()
    k = 1
    while True:
        key2 = np.full(n, -1, np.int64)
        key2[:n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1, r2 = rank[order], key2[order]
        neq = np.ones(n, bool)
        neq[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        nr = np.cumsum(neq) - 1
        rank = np.empty(n, np.int64)
        rank[order] = nr
        if nr[-1] == n - 1:
            return order.astype(np.int32)
        k *= 2


@dataclasses.dataclass
class FmIndex:
    """BWT/FM seed index with the same lookup capability as CsrIndex."""
    mer_size: int
    sa: np.ndarray          # int32[n+1]
    bwt_words: np.ndarray   # int32[ceil((n+1)/8)] 4-bit packed symbols
    occ: np.ndarray         # int32[nb, 8] checkpoint ranks every OCC_BLOCK
    c_table: np.ndarray     # int32[8]  C[c] = # symbols < c

    @property
    def n(self) -> int:
        return len(self.sa)  # text length incl. sentinel

    # ---- host reference (oracle for tests) ----
    def rank(self, sym: int, i: int) -> int:
        b, r = divmod(int(i), OCC_BLOCK)
        cnt = int(self.occ[b, sym])
        for j in range(OCC_BLOCK * b, OCC_BLOCK * b + r):
            w = int(self.bwt_words[j // 8])
            if (w >> ((j % 8) * 4)) & 0xF == sym:
                cnt += 1
        return cnt

    def search_range(self, kmer_codes: np.ndarray):
        """Backward search of base codes (0..3) -> SA range [lo, hi)."""
        lo, hi = 0, self.n
        for c in kmer_codes[::-1]:
            sym = int(c) + 1
            lo = int(self.c_table[sym]) + self.rank(sym, lo)
            hi = int(self.c_table[sym]) + self.rank(sym, hi)
            if lo >= hi:
                return lo, lo
        return lo, hi

    def lookup(self, kmer: int) -> np.ndarray:
        """k-mer integer code -> sorted genome positions (CsrIndex.lookup
        parity)."""
        m = self.mer_size
        codes = [(kmer >> (2 * (m - 1 - j))) & 3 for j in range(m)]
        lo, hi = self.search_range(np.array(codes))
        return np.sort(self.sa[lo:hi])


@dataclasses.dataclass
class FmBsPair:
    """Per-strand collapsed FM indexes for bisulfite mode (the FM analog of
    builder.BsIndexPair): ``plus`` over the C->T-collapsed genome, ``minus``
    over G->A.  Reads collapse the same way before backward search, so a
    conversion never breaks a seed; candidate sets equal the CSR pair's.
    Unlike the dense CSR tables, FM needs no 3^m bucket array, so collapsed
    k-mers stay in plain base-4 codes."""
    plus: "FmIndex"
    minus: "FmIndex"

    @property
    def mer_size(self) -> int:
        return self.plus.mer_size


def build_bs_fm_index(genome: Genome, cfg: MapperConfig) -> FmBsPair:
    return FmBsPair(build_fm_index(genome, cfg, collapse="ct"),
                    build_fm_index(genome, cfg, collapse="ga"))


def build_fm_index(genome: Genome, cfg: MapperConfig,
                   collapse: "str | None" = None) -> FmIndex:
    codes = genome.codes
    if collapse is not None:
        codes = collapse_codes(codes, collapse)
    if len(codes) + 1 > np.iinfo(np.int32).max:
        raise ValueError("genome too large for int32 FM index; use "
                         "shard-wise builds (config 5)")
    sa = suffix_array(codes)
    n = len(sa)
    t = np.concatenate([codes.astype(np.int8) + 1,
                        np.zeros(1, np.int8)])            # symbols
    bwt = t[sa - 1]                                       # sa[i]=0 -> t[-1]=$
    bwt_words = pack_4bit(bwt)
    nb = (n + OCC_BLOCK - 1) // OCC_BLOCK + 1
    occ = np.zeros((nb, N_SYMS), np.int32)
    pad = np.full((-n) % OCC_BLOCK, 7, np.int8)           # 7: unused symbol
    blocks = np.concatenate([bwt, pad]).reshape(-1, OCC_BLOCK)
    per_block = (blocks[:, :, None]
                 == np.arange(N_SYMS, dtype=np.int8)).sum(axis=1)
    np.cumsum(per_block, axis=0, out=occ[1:1 + len(blocks)])
    occ[1 + len(blocks):] = occ[len(blocks)]
    counts = np.bincount(bwt, minlength=N_SYMS)
    c_table = np.zeros(N_SYMS, np.int32)
    np.cumsum(counts[:-1], out=c_table[1:])
    return FmIndex(cfg.mer_size, sa, bwt_words, occ.astype(np.int32),
                   c_table)


def save(path: str, idx: FmIndex) -> None:
    np.savez_compressed(path, kind="fm", mer_size=idx.mer_size, sa=idx.sa,
                        bwt_words=idx.bwt_words, occ=idx.occ,
                        c_table=idx.c_table)


def load(path: str) -> FmIndex:
    z = np.load(path)
    if str(z.get("kind", "fm")) != "fm":
        raise ValueError(f"{path} is not an FM index")
    return FmIndex(int(z["mer_size"]), z["sa"], z["bwt_words"], z["occ"],
                   z["c_table"])


# ---------------------------------------------------------------------------
# Device search (torch; every tensor on the caller's device, static shapes)
# ---------------------------------------------------------------------------

def fm_ranges(km, bad, sa_n: int, bwt_words, occ, c_table, m: int):
    """Backward search for every seed k-mer: (lo, hi) SA ranges.

    km:  int32[B2, S] k-mer integer codes; bad marks N-containing seeds.
    Returns (lo, hi) int32[B2, S]; bad seeds return an empty range.

    A rank query rank(sym, i) is the checkpoint occ[i // 32, sym] plus the
    count of sym among the i % 32 symbols of the block before i: the 4
    words of the block gathered, each word's 8 nibbles split by arithmetic
    shifts (int32, as the reference: the top nibble's sign bits are masked
    off by & 0xF).  Word indices past the end are clamped, as a jnp gather
    clamps them; a clamped word only ever feeds masked-off positions."""
    import torch
    dev = km.device
    i32 = torch.int32
    per = OCC_BLOCK // BASES_PER_WORD
    n_words = bwt_words.shape[0]
    ar_w = torch.arange(per, dtype=torch.int64, device=dev)
    sh = ((torch.arange(OCC_BLOCK, dtype=i32, device=dev) % BASES_PER_WORD)
          * 4).reshape(per, BASES_PER_WORD)
    lane = torch.arange(OCC_BLOCK, dtype=i32, device=dev).reshape(
        per, BASES_PER_WORD)
    occ_flat = occ.reshape(-1)

    def rank(sym, i):
        b = torch.div(i, OCC_BLOCK, rounding_mode="floor").long()
        base = occ_flat[b * N_SYMS + sym.long()]                  # (B2, S)
        widx = (b * per)[..., None] + ar_w                        # (B2, S, 4)
        words = bwt_words[widx.clamp_(0, n_words - 1)]
        syms = (words[..., None] >> sh) & 0xF                     # (.., 4, 8)
        in_pre = lane < (i % OCC_BLOCK)[..., None, None]
        hit = (syms == sym[..., None, None]) & in_pre
        return base + hit.sum(dim=(-2, -1), dtype=i32)

    lo = torch.zeros_like(km)
    hi = torch.full_like(km, sa_n)
    for j in range(m):                   # pattern right-to-left
        sym = ((km >> (2 * j)) & 3) + 1
        c = c_table[sym.long()]
        lo = c + rank(sym, lo)
        hi = c + rank(sym, hi)
    empty = bad | (hi <= lo)
    lo = torch.where(empty, 0, lo)
    hi = torch.where(empty, 0, hi)
    return lo, hi


def fm_hits(km, bad, sa, bwt_words, occ, c_table, offsets, cfg):
    """CSR-equivalent candidate anchors from the FM index: int32[B2, S,
    caph] with SENTINEL at invalid slots (drop-in for mapper.csr_hits)."""
    import torch
    from gnumap_tpu_torch.pipeline.mapper import SENTINEL
    n = sa.shape[0]
    lo, hi = fm_ranges(km, bad, n, bwt_words, occ, c_table, cfg.mer_size)
    count = hi - lo
    caph = cfg.max_hits_per_seed
    seed_ok = (~bad) & (count > 0) & (count <= caph)
    ar = torch.arange(caph, dtype=torch.int32, device=km.device)
    ok = seed_ok[:, :, None] & (ar < count[:, :, None])
    idx = (lo.long()[:, :, None] + ar).clamp(0, n - 1)
    cand = sa[idx] - offsets.to(torch.int32)[None, :, None]
    return torch.where(ok, cand, SENTINEL)
