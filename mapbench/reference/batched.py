"""The frozen oracle's ``map_read`` over many reads at once, in plain torch
on any device: the same seeds, votes, candidate cap, banded recurrence,
retention, traceback walk, dedupe and weights, with the pairs of every read
and strand side by side in one tensor.  ``mapbench/tests`` holds it to
``oracle.py`` read by read.  It builds its own seed lookup from the genome's
codes and takes nothing the program derived.

``shift`` > 0 is the control: emissions and gap penalties rounded to
``SCORE_ONE / 2**shift`` units, the scale a 16-bit DP cell would need to
hold a 100 bp read's score, and scores scaled back up afterwards.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from mapbench.reference import oracle
from mapbench.reference.consts import NEG_INF, RefConfig

OP_M, OP_I, OP_D, OP_PAD = 0, 1, 2, 3
# pairs a DP chunk holds: scores keep two rows, tracebacks every row
SCORE_CHUNK = 65536
TB_CHUNK = 8192


@dataclasses.dataclass
class RefHit:
    strand: str
    pos: int
    score: int
    weight: float
    ops: np.ndarray          # forward order, OP_M / OP_I / OP_D

    @property
    def ref_len(self) -> int:
        return int(np.count_nonzero(self.ops != OP_I))

    @property
    def cigar(self) -> str:
        return oracle.rle(["MID"[o] for o in self.ops])


class RefGenome:
    """The genome's codes on ``device`` and a seed lookup over them."""

    def __init__(self, codes: np.ndarray, names: Sequence[str],
                 starts: np.ndarray, device):
        self.codes = np.asarray(codes, np.int8)
        self.names = list(names)
        self.starts = np.asarray(starts, np.int64)
        self.device = torch.device(device)
        self.g = torch.from_numpy(self.codes).to(self.device)
        self._kmers = {}

    def locate(self, pos: np.ndarray):
        pos = np.asarray(pos, np.int64)
        idx = np.searchsorted(self.starts, pos, side="right") - 1
        return idx, pos - self.starts[idx]

    def _kmer_table(self, m: int):
        if m not in self._kmers:
            n = len(self.codes) - m + 1
            g = self.g.to(torch.int64)
            isn = g == 4
            base = torch.where(isn, 0, g)
            km = torch.zeros(n, dtype=torch.int64, device=self.device)
            bad = torch.zeros(n, dtype=torch.int32, device=self.device)
            for k in range(m):
                km += base[k:k + n] << (2 * (m - 1 - k))
                bad += isn[k:k + n].to(torch.int32)
            km[bad > 0] = -1
            self._kmers[m] = km
        return self._kmers[m]

    def lookup(self, queries: np.ndarray, m: int):
        """For sorted unique k-mer codes: (first, count) into an array of
        ascending genome positions grouped by k-mer, and that array."""
        km = self._kmer_table(m)
        q = torch.from_numpy(queries).to(self.device)
        pos = torch.isin(km, q).nonzero().squeeze(1)
        kv = km[pos]
        order = torch.sort(kv, stable=True).indices
        kv, pos = kv[order], pos[order]
        first = torch.searchsorted(kv, q)
        last = torch.searchsorted(kv, q, right=True)
        return (first.cpu().numpy(), (last - first).cpu().numpy(),
                pos.cpu().numpy())

    def windows(self, starts: torch.Tensor, W: int) -> torch.Tensor:
        idx = starts[:, None] + torch.arange(W, device=self.device)[None, :]
        ok = (idx >= 0) & (idx < self.g.numel())
        win = self.g[idx.clamp(0, self.g.numel() - 1)].to(torch.int64)
        return torch.where(ok, win, 4)


def _seed_kmers(codes: np.ndarray, m: int, jump: int):
    """(kmers, valid) at offsets 0, jump, ... <= L - m of every row."""
    L = codes.shape[1]
    offs = np.arange(0, L - m + 1, jump)
    base = np.where(codes == 4, 0, codes).astype(np.int64)
    isn = codes == 4
    km = np.zeros((codes.shape[0], len(offs)), np.int64)
    bad = np.zeros_like(km)
    for k in range(m):
        km += base[:, offs + k] << (2 * (m - 1 - k))
        bad += isn[:, offs + k]
    return offs, km, bad == 0


def candidates(codes2: np.ndarray, genome: RefGenome, cfg: RefConfig):
    """[FROZEN v2] candidate anchors of every read-strand row: (rows,
    cands) sorted by row then position."""
    R, L = codes2.shape
    offs, km, valid = _seed_kmers(codes2, cfg.mer_size, cfg.seed_jump)
    q = np.unique(km[valid])
    if len(q) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    first, count, positions = genome.lookup(q, cfg.mer_size)
    rs, si = np.nonzero(valid)
    qi = np.searchsorted(q, km[rs, si])
    n = count[qi]
    keep = (n > 0) & (n <= cfg.max_hits_per_seed)
    rs, si, qi, n = rs[keep], si[keep], qi[keep], n[keep]
    tot = int(n.sum())
    seg = np.repeat(np.arange(len(n)), n)
    ramp = np.arange(tot) - np.repeat(np.cumsum(n) - n, n)
    cand = positions[first[qi][seg] + ramp] - offs[si][seg]
    K = len(genome.codes) + 2 * L + 16
    keys, votes = np.unique(rs[seg].astype(np.int64) * K + cand + L,
                            return_counts=True)
    rows, cands = keys // K, keys % K - L
    order = np.lexsort((cands, -votes, rows))
    r_sorted = rows[order]
    rank = np.arange(len(order)) - np.searchsorted(r_sorted, r_sorted)
    kept = np.zeros(len(keys), bool)
    kept[order[rank < cfg.max_candidates]] = True
    return rows[kept], cands[kept]


class _Dp:
    """The banded recurrence of ``oracle.nw_align`` over pairs."""

    def __init__(self, cfg: RefConfig, L: int, device, shift: int):
        self.W = cfg.window_width()
        self.L = L
        self.open_q = cfg.gap_open_q() >> shift
        self.ext_q = cfg.gap_extend_q() >> shift
        self.device = device
        jj = torch.arange(self.W + 1, device=device, dtype=torch.int64)
        self.jj = jj
        band = cfg.band()
        self.off_band = None
        if band is not None:
            boff, bw = band
            i = torch.arange(L + 1, device=device)[:, None]
            j = jj[None, 1:]
            self.off_band = (j < i - boff) | (j > i - boff + bw - 1)

    def run(self, emis: torch.Tensor, win: torch.Tensor, keep_rows: bool):
        """emis int64[P, L, 5], win int64[P, W] -> finals int64[P, W+1]
        (max(M, Ix) of the last row) and, with keep_rows, (M, Ix, Iy) as
        int64[P, L+1, W+1]."""
        P = emis.shape[0]
        W, dev = self.W, self.device
        neg = torch.full((P, W + 1), NEG_INF, dtype=torch.int64, device=dev)
        M = torch.zeros((P, W + 1), dtype=torch.int64, device=dev)
        Ix, Iy = neg.clone(), neg.clone()
        rows = [(M, Ix, Iy)] if keep_rows else None
        jx = self.jj * self.ext_q
        iy_off = self.open_q + (self.jj[1:] - 1) * self.ext_q
        for i in range(1, self.L + 1):
            e = torch.gather(emis[:, i - 1, :], 1, win)
            best = torch.maximum(torch.maximum(M, Ix), Iy)
            Mn = neg.clone()
            Mn[:, 1:] = torch.clamp_min(e + best[:, :-1], NEG_INF)
            Ixn = torch.clamp_min(torch.maximum(M - self.open_q,
                                                Ix - self.ext_q), NEG_INF)
            if self.off_band is not None:
                ob = self.off_band[i]
                Mn[:, 1:][:, ob] = NEG_INF
            pm = torch.cummax(Mn + jx, dim=1).values
            Iyn = neg.clone()
            Iyn[:, 1:] = torch.clamp_min(pm[:, :-1] - iy_off, NEG_INF)
            if self.off_band is not None:
                Ixn[:, 1:][:, ob] = NEG_INF
                Iyn[:, 1:][:, ob] = NEG_INF
            M, Ix, Iy = Mn, Ixn, Iyn
            if keep_rows:
                rows.append((M, Ix, Iy))
        finals = torch.maximum(M, Ix)
        if not keep_rows:
            return finals, None
        return finals, tuple(torch.stack([r[k] for r in rows], 1)
                             for k in range(3))

    def traceback(self, finals, mats):
        """(pos_in_window int64[P], ops uint8[P, T] in reverse order, T
        per pair) by the oracle's walk, every pair a step at a time."""
        M, Ix, Iy = mats
        P, dev = finals.shape[0], self.device
        ar = torch.arange(P, device=dev)
        j = torch.argmax(finals, dim=1)
        i = torch.full((P,), self.L, dtype=torch.int64, device=dev)
        state = torch.where(M[ar, i, j] >= Ix[ar, i, j], 0, 1)
        steps = self.L + self.W + 2
        ops = torch.full((P, steps), OP_PAD, dtype=torch.uint8, device=dev)
        n_ops = torch.zeros(P, dtype=torch.int64, device=dev)
        for s in range(steps):
            act = i > 0
            if not bool(act.any()):
                break
            ops[:, s] = torch.where(act, state, OP_PAD).to(torch.uint8)
            n_ops += act.to(torch.int64)
            im, jm = (i - 1).clamp_min(0), (j - 1).clamp_min(0)
            # state M: the best of the three at (i-1, j-1), M > Ix > Iy
            pm, px, py = M[ar, im, jm], Ix[ar, im, jm], Iy[ar, im, jm]
            bst = torch.maximum(torch.maximum(pm, px), py)
            s_m = torch.where(pm == bst, 0, torch.where(px == bst, 1, 2))
            # state Ix: back to M when M[i-1, j] - open >= Ix[i-1, j] - ext
            s_x = torch.where(M[ar, im, j] - self.open_q
                              >= Ix[ar, im, j] - self.ext_q, 0, 1)
            s_x = torch.where(j == 0, 1, s_x)
            # state Iy: back to M when M[i, j-1] - open >= Iy[i, j-1] - ext
            s_y = torch.where(M[ar, i, jm] - self.open_q
                              >= Iy[ar, i, jm] - self.ext_q, 0, 2)
            in_m, in_x, in_y = act & (state == 0), act & (state == 1), \
                act & (state == 2)
            new_state = torch.where(in_m, s_m, torch.where(
                in_x, s_x, torch.where(in_y, s_y, state)))
            i = i - (in_m | in_x).to(torch.int64)
            j = j - (in_m | in_y).to(torch.int64)
            state = new_state
        return j, ops, n_ops


def map_reads(codes: np.ndarray, quals: np.ndarray, genome: RefGenome,
              cfg: RefConfig, shift: int = 0) -> List[List[RefHit]]:
    """Retained hits of every read (rows of ``codes`` / ``quals``, one
    length, no padding) with posterior weights: ``oracle.map_read`` for
    each row."""
    codes = np.asarray(codes, np.int8)
    n, L = codes.shape
    dev = genome.device
    pwm = oracle.pwm_from_calls(codes, quals)
    pwm2 = np.concatenate([pwm, oracle.pwm_revcomp(pwm)], 0)
    codes2 = np.concatenate(
        [codes, oracle._COMP[codes.astype(np.int64)][:, ::-1]], 0)
    S = oracle.normal_matrix(cfg).astype(np.int64)
    emis2 = np.matmul(pwm2.astype(np.int64), S)
    if shift:
        emis2 = (emis2 + (1 << (shift - 1))) >> shift
    thr = np.array([cfg.threshold_for(int(s))
                    for s in emis2[..., :4].max(-1).sum(-1)], np.int64)
    rows, cands = candidates(codes2, genome, cfg)
    out: List[List[RefHit]] = [[] for _ in range(n)]
    if len(rows) == 0:
        return out
    dp = _Dp(cfg, L, dev, shift)
    emis_t = torch.from_numpy(emis2).to(dev)
    ws = cfg.window_start(cands)
    scores = np.empty(len(rows), np.int64)
    for a in range(0, len(rows), SCORE_CHUNK):
        r = torch.from_numpy(rows[a:a + SCORE_CHUNK]).to(dev)
        w = torch.from_numpy(ws[a:a + SCORE_CHUNK]).to(dev)
        finals, _ = dp.run(emis_t[r], genome.windows(w, dp.W), False)
        scores[a:a + len(r)] = finals.max(1).values.cpu().numpy()
    kept = np.nonzero((scores >= thr[rows]) & (scores > 0))[0]
    pos = np.empty(len(kept), np.int64)
    ops_l: List[np.ndarray] = []
    for a in range(0, len(kept), TB_CHUNK):
        k = kept[a:a + TB_CHUNK]
        r = torch.from_numpy(rows[k]).to(dev)
        w = torch.from_numpy(ws[k]).to(dev)
        finals, mats = dp.run(emis_t[r], genome.windows(w, dp.W), True)
        j, ops, n_ops = dp.traceback(finals, mats)
        pos[a:a + len(k)] = ws[k] + j.cpu().numpy()
        ops_np, n_np = ops.cpu().numpy(), n_ops.cpu().numpy()
        ops_l += [ops_np[t, :n_np[t]][::-1].copy() for t in range(len(k))]
    # per read: '+' then '-' hits, each by ascending anchor, as the oracle
    # appends them; dedupe by (strand, pos), first on ties
    for t, h in enumerate(kept):
        r = int(rows[h])
        read, strand = (r, "+") if r < n else (r - n, "-")
        out[read].append(RefHit(strand, int(pos[t]),
                                int(scores[h]) << shift, 0.0, ops_l[t]))
    for read in range(n):
        hits = out[read]
        if not hits:
            continue
        best = {}
        for h in hits:
            key = (h.strand, h.pos)
            if key not in best or h.score > best[key].score:
                best[key] = h
        hits = list(best.values())
        total = float(sum(h.score for h in hits))
        for h in hits:
            h.weight = h.score / total
        hits.sort(key=lambda h: (h.pos, 0 if h.strand == "+" else 1))
        out[read] = hits
    return out


def contributions(hits_per_read: List[List[RefHit]], pwm: np.ndarray,
                  lookup: np.ndarray):
    """Coverage and SNP-tally terms of every hit that land on a checked
    position: (read, slot, coverage term) and (read, slot, tally terms
    float64[n, 4]), where ``lookup[g]`` is the slot of genome position g or
    -1.  The oracle's ``accumulate``, restricted to those positions."""
    flat = [(read, h) for read, hits in enumerate(hits_per_read)
            for h in hits]
    if not flat:
        z = np.zeros(0, np.int64)
        return (z, z, np.zeros(0)), (z, z, np.zeros((0, 4)))
    reads = np.array([r for r, _ in flat], np.int64)
    lens = np.array([len(h.ops) for _, h in flat], np.int64)
    hid = np.repeat(np.arange(len(flat)), lens)
    ops = np.concatenate([h.ops for _, h in flat])
    start = np.cumsum(lens) - lens
    on_g, on_r = ops != OP_I, ops != OP_D
    cg, cr = np.cumsum(on_g), np.cumsum(on_r)
    g0 = np.array([h.pos for _, h in flat], np.int64)
    g = g0[hid] + cg - (cg - on_g)[start][hid] - 1
    ri = cr - (cr - on_r)[start][hid] - 1
    ok = on_g & (g >= 0) & (g < len(lookup))
    slot = np.full(len(ops), -1, np.int64)
    slot[ok] = lookup[g[ok]]
    w = np.array([h.weight for _, h in flat])
    c = slot >= 0
    cov = (reads[hid[c]], slot[c], w[hid[c]])
    m = c & (ops == OP_M)
    minus = np.array([h.strand == "-" for _, h in flat])[hid[m]]
    L = pwm.shape[1]
    rr, ii = reads[hid[m]], ri[m]
    rows = np.where(minus[:, None], pwm[rr, L - 1 - ii][:, ::-1],
                    pwm[rr, ii]).astype(np.float64)
    tal = (rr, slot[m], w[hid[m]][:, None] * (rows / oracle.PWM_SCALE))
    return cov, tal


def sum_f64(terms, mult: np.ndarray, n_slots: int, width: Optional[int]):
    """Each read's terms times its multiplicity, summed in float64."""
    r, s, v = terms
    shape = (n_slots,) if width is None else (n_slots, width)
    acc = np.zeros(shape, np.float64)
    w = mult[r].astype(np.float64)
    np.add.at(acc, s, v * (w if width is None else w[:, None]))
    return acc


def sum_low(terms, feeds: List[np.ndarray], n_slots: int,
            width: Optional[int], dtype=torch.bfloat16):
    """The control's accumulation: every term added once per feed of its
    read, in feed order, each add rounded to ``dtype``.  ``feeds[k]`` is the
    feed rank (a pass and a position in the stream) of the reads' k-th
    feed, -1 where a read was fed fewer times."""
    r, s, v = terms
    v = v.reshape(len(r), -1)
    ev_s, ev_t, ev_v = [], [], []
    for f in feeds:
        on = f[r] >= 0
        ev_s.append(s[on])
        ev_t.append(f[r][on])
        ev_v.append(v[on])
    s_all = np.concatenate(ev_s)
    t_all = np.concatenate(ev_t)
    v_all = np.concatenate(ev_v)
    order = np.lexsort((t_all, s_all))
    s_all, v_all = s_all[order], v_all[order]
    k = np.arange(len(s_all)) - np.searchsorted(s_all, s_all)
    acc = torch.zeros((n_slots, v_all.shape[1]), dtype=dtype)
    vt = torch.from_numpy(v_all).to(dtype)
    for step in range(int(k.max()) + 1 if len(k) else 0):
        sel = np.nonzero(k == step)[0]
        acc[torch.from_numpy(s_all[sel])] += vt[torch.from_numpy(sel)]
    out = acc.to(torch.float64).numpy()
    return out[:, 0] if width is None else out
