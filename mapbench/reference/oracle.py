"""Frozen copy of the program's pure-NumPy oracle
(``gnumap_tpu_torch/oracle/oracle.py``, with the pieces of ``core/packing``,
``core/pwm`` and ``align/scoring`` it calls), in the normal (not
bisulfite) mode that the benchmark's configurations state.  One read at a
time, Python loops: the yardstick that ``batched.py`` is held to in
``mapbench/tests``.

FROZEN SEMANTICS (as the program's oracle states them):
  * DP: read global, genome-window ends free; integer fixed point; cells
    floored at NEG_INF; the [FROZEN v4] band.
  * Seeds at read offsets 0, j, 2j, ... <= L - m; seeds with an N or with
    more than max_hits_per_seed index hits are skipped; candidates are
    vote-counted and, over the cap, the max_candidates best by (votes desc,
    position asc) are kept, in ascending order [FROZEN v2].
  * Retention: score >= threshold_for(max attainable) and score > 0;
    traceback end = smallest j at the max, M > Ix > Iy; dedupe by
    (strand, pos) keeping the max score (first on ties); weights
    w_i = s_i / sum(s_j) in float64; output by (pos, '+' before '-').
  * Coverage: +w at every genome position the alignment consumes (M, D);
    SNP tallies: for M columns, tallies[p, b] += w * pwm[i, b] / PWM_SCALE.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from mapbench.reference.consts import (BASE_N, N_BASES, NEG_INF, PWM_SCALE,
                                       S_SCALE, SPACER_N, RefConfig)

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(codes, dtype=np.int64)][::-1].astype(np.int8)


def kmer_codes(codes: np.ndarray, m: int) -> Tuple[np.ndarray, np.ndarray]:
    codes = np.asarray(codes)
    n = len(codes) - m + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    base = np.where(codes == BASE_N, 0, codes).astype(np.int64)
    isn = codes == BASE_N
    kmers = np.zeros(n, dtype=np.int64)
    bad = np.zeros(n, dtype=np.int64)
    for k in range(m):
        kmers += base[k:k + n] << (2 * (m - 1 - k))
        bad += isn[k:k + n]
    return kmers, bad == 0


# ---------------------------------------------------------------------------
# PWM from Phred qualities (core/pwm.py)
# ---------------------------------------------------------------------------

def _quantize_rows(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    scaled = p * PWM_SCALE
    base = np.floor(scaled).astype(np.int64)
    rem = scaled - base
    deficit = PWM_SCALE - base.sum(axis=-1)
    order = np.argsort(-rem, axis=-1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.arange(N_BASES)[None, :] *
                      np.ones(order.shape[:-1] + (1,), dtype=np.int64),
                      axis=-1)
    bump = (ranks < deficit[..., None]).astype(np.int64)
    return (base + bump).astype(np.int32)


def pwm_from_calls(codes: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """(..., L) codes + Phred quals -> (..., L, 4) int32 PWM: the called
    base gets 1 - 10^(-Q/10), the other three share the rest, N uniform."""
    codes = np.asarray(codes)
    p = 1.0 - np.power(10.0, -np.asarray(quals, dtype=np.float64) / 10.0)
    pwm = np.empty(codes.shape + (N_BASES,), dtype=np.float64)
    pwm[...] = ((1.0 - p) / 3.0)[..., None]
    called = np.clip(codes, 0, 3).astype(np.int64)
    np.put_along_axis(pwm, called[..., None], p[..., None], axis=-1)
    pwm[codes == BASE_N] = 0.25
    return _quantize_rows(pwm)


def pwm_revcomp(pwm_q: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(pwm_q[..., ::-1, ::-1])


# ---------------------------------------------------------------------------
# Scoring (align/scoring.py, normal mode)
# ---------------------------------------------------------------------------

def normal_matrix(cfg: RefConfig) -> np.ndarray:
    S = np.full((4, 5), cfg.mismatch_score, dtype=np.float64)
    S4 = np.full((4, 4), cfg.mismatch_score, dtype=np.float64)
    np.fill_diagonal(S4, cfg.match_score)
    S[:, :4] = S4
    return np.round(S * S_SCALE).astype(np.int32)


def emission_int(pwm_q: np.ndarray, S_q: np.ndarray) -> np.ndarray:
    return np.matmul(pwm_q.astype(np.int64),
                     S_q.astype(np.int64)).astype(np.int32)


def max_read_score(emis: np.ndarray) -> np.ndarray:
    return emis[..., :4].max(axis=-1).sum(axis=-1).astype(np.int64)


# ---------------------------------------------------------------------------
# Genome + index (a dict of k-mer -> ascending positions)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OracleGenome:
    codes: np.ndarray
    names: List[str]
    starts: np.ndarray
    lengths: np.ndarray

    @classmethod
    def from_codes(cls, contigs: List[Tuple[str, np.ndarray]]
                   ) -> "OracleGenome":
        names, starts, lengths, parts = [], [], [], []
        off = 0
        spacer = np.full(SPACER_N, BASE_N, dtype=np.int8)
        for name, c in contigs:
            c = np.asarray(c, dtype=np.int8)
            names.append(name)
            starts.append(off)
            lengths.append(len(c))
            parts += [c, spacer]
            off += len(c) + SPACER_N
        return cls(np.concatenate(parts), names, np.array(starts),
                   np.array(lengths))

    def window(self, start: int, width: int) -> np.ndarray:
        out = np.full(width, BASE_N, dtype=np.int8)
        lo, hi = max(start, 0), min(start + width, len(self.codes))
        if hi > lo:
            out[lo - start:hi - start] = self.codes[lo:hi]
        return out


def build_oracle_index(gen: OracleGenome, cfg: RefConfig
                       ) -> Dict[int, List[int]]:
    kmers, valid = kmer_codes(gen.codes, cfg.mer_size)
    table: Dict[int, List[int]] = {}
    for p in np.nonzero(valid)[0]:
        table.setdefault(int(kmers[p]), []).append(int(p))
    return table


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------

def nw_align(emis: np.ndarray, window: np.ndarray, cfg: RefConfig,
             traceback: bool = False):
    """Score (or score, pos_in_window, cigar, ref_len) of one read's (L, 5)
    emission table against one genome window."""
    L = emis.shape[0]
    W = len(window)
    open_q, ext_q = cfg.gap_open_q(), cfg.gap_extend_q()
    band = cfg.band()
    M = np.full((L + 1, W + 1), NEG_INF, dtype=np.int64)
    Ix = np.full((L + 1, W + 1), NEG_INF, dtype=np.int64)
    Iy = np.full((L + 1, W + 1), NEG_INF, dtype=np.int64)
    M[0, :] = 0
    jj = np.arange(W + 1, dtype=np.int64)
    win = window.astype(np.int64)
    for i in range(1, L + 1):
        if band is not None:
            boff, bw = band
            off_band = (jj[1:] < i - boff) | (jj[1:] > i - boff + bw - 1)
        e = emis[i - 1].astype(np.int64)[win]
        prev_best = np.maximum(np.maximum(M[i - 1], Ix[i - 1]), Iy[i - 1])
        M[i, 1:] = np.maximum(e + prev_best[:-1], NEG_INF)
        if band is not None:
            M[i, 1:][off_band] = NEG_INF
        Ix[i, :] = np.maximum(
            np.maximum(M[i - 1] - open_q, Ix[i - 1] - ext_q), NEG_INF)
        pm = np.maximum.accumulate(M[i] + jj * ext_q)
        Iy[i, 1:] = np.maximum(pm[:-1] - open_q - (jj[1:] - 1) * ext_q,
                               NEG_INF)
        if band is not None:
            Ix[i, 1:][off_band] = NEG_INF
            Iy[i, 1:][off_band] = NEG_INF
    finals = np.maximum(M[L], Ix[L])
    score = int(finals.max())
    if not traceback:
        return score
    j = int(np.argmax(finals))
    state = 0 if M[L, j] >= Ix[L, j] else 1
    i = L
    ops: List[str] = []
    while i > 0:
        if state == 0:
            ops.append("M")
            prev = (M[i - 1, j - 1], Ix[i - 1, j - 1], Iy[i - 1, j - 1])
            state = prev.index(max(prev))
            i, j = i - 1, j - 1
        elif state == 1:
            ops.append("I")
            if j == 0:
                i -= 1
                continue
            if M[i - 1, j] - open_q >= Ix[i - 1, j] - ext_q:
                state = 0
            i -= 1
        else:
            ops.append("D")
            if M[i, j - 1] - open_q >= Iy[i, j - 1] - ext_q:
                state = 0
            j -= 1
    ops.reverse()
    return score, j, rle(ops), sum(1 for o in ops if o in "MD")


def rle(ops) -> str:
    out = []
    i = 0
    while i < len(ops):
        k = i
        while k < len(ops) and ops[k] == ops[i]:
            k += 1
        out.append(f"{k - i}{ops[i]}")
        i = k
    return "".join(out)


@dataclasses.dataclass
class Hit:
    strand: str
    gpos: int
    score: int
    weight: float = 0.0
    pos: int = -1
    cigar: str = ""
    ref_len: int = 0


def candidates_for(codes: np.ndarray, index: Dict[int, List[int]],
                   cfg: RefConfig) -> List[int]:
    L = len(codes)
    m = cfg.mer_size
    kmers, valid = kmer_codes(codes, m)
    votes: Dict[int, int] = {}
    for off in range(0, L - m + 1, cfg.seed_jump):
        if off >= len(kmers) or not valid[off]:
            continue
        hits = index.get(int(kmers[off]), [])
        if len(hits) > cfg.max_hits_per_seed:
            continue
        for p in hits:
            votes[p - off] = votes.get(p - off, 0) + 1
    ranked = sorted(votes, key=lambda c: (-votes[c], c))
    return sorted(ranked[:cfg.max_candidates])


def map_read(codes: np.ndarray, pwm_q: np.ndarray, gen: OracleGenome,
             index: Dict[int, List[int]], cfg: RefConfig) -> List[Hit]:
    """Retained hits of one read, with posterior weights."""
    S = normal_matrix(cfg)
    W = cfg.window_width()
    hits: List[Hit] = []
    for strand in ("+", "-"):
        if strand == "+":
            c_s, p_s = codes, pwm_q
        else:
            c_s, p_s = revcomp(codes), pwm_revcomp(pwm_q)
        emis = emission_int(p_s, S)
        thr = cfg.threshold_for(int(max_read_score(emis[None])[0]))
        for cand in candidates_for(c_s, index, cfg):
            score = nw_align(emis, gen.window(cfg.window_start(cand), W),
                             cfg)
            if score >= thr and score > 0:
                hits.append(Hit(strand=strand, gpos=cand, score=score))
    if not hits:
        return []
    for h in hits:
        p_s = pwm_q if h.strand == "+" else pwm_revcomp(pwm_q)
        ws = cfg.window_start(h.gpos)
        _, pw, cigar, ref_len = nw_align(emission_int(p_s, S),
                                         gen.window(ws, W), cfg,
                                         traceback=True)
        h.pos, h.cigar, h.ref_len = ws + pw, cigar, ref_len
    best: Dict[Tuple[str, int], Hit] = {}
    for h in hits:
        key = (h.strand, h.pos)
        if key not in best or h.score > best[key].score:
            best[key] = h
    hits = list(best.values())
    total = float(sum(h.score for h in hits))
    for h in hits:
        h.weight = h.score / total
    hits.sort(key=lambda h: (h.pos, 0 if h.strand == "+" else 1))
    return hits


def accumulate(hits: List[Hit], pwm_q: np.ndarray, coverage: np.ndarray,
               tallies: np.ndarray) -> None:
    """Scatter posterior weight into coverage and SNP tallies."""
    for h in hits:
        coverage[h.pos:h.pos + h.ref_len] += h.weight
        p_s = pwm_q if h.strand == "+" else pwm_revcomp(pwm_q)
        gp, i = h.pos, 0
        for num, op in iter_cigar(h.cigar):
            if op == "M":
                for k in range(num):
                    tallies[gp + k] += h.weight * (
                        p_s[i + k].astype(np.float64) / PWM_SCALE)
                gp += num
                i += num
            elif op == "D":
                gp += num
            elif op == "I":
                i += num


def iter_cigar(cigar: str):
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            yield num, ch
            num = 0
