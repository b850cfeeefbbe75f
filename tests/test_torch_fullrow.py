"""The algebra of the port's full-width DP row (gnumap_tpu_torch/csrc/
nw_full_row.cuh, run by the CUDA kernels nw_full.cu and nw_tb.cu), modelled
in numpy cell by cell and held to the plain versions the CPU runs
(``nw_scores_full_plain``, ``nw_traceback_plain``), which
tests/test_torch_unbanded.py and tests/test_torch_devtb.py hold to the Pallas
kernels in interpret mode and to the oracle.

The model does what the kernels do, in their order:
  * a group of G lanes owns a pair, lane g the NC = ceil(W / G) columns from
    g NC, as two arrays D = max(M, Ix, Iy) and T = max(M - open, Ix - ext,
    NEG_INF) of the lane's last row, columns past W on the poison code 5;
  * lane g works on row s - g at step s; the left strip's last-column D of
    the row above and its Iy chain q of this row cross a strip's edge one
    step later (the two shuffles); column 0 is a scalar of lane 0;
  * every value floors at NEG_INF where it is written; the band mask
    (traceback only) forces M, Ix and Iy of a masked cell to NEG_INF;
  * a cell stores four sign bits about its own values, four cells to a
    16-bit word, and the backwalk reads them at the shifted index; the
    group walks together: its lanes look at the next G steps of a run of
    matches (or of a deletion run) at once and a vote finds where it ends,
    and only rows that are not plain matches are written;
  * dead slots: scores NEG_INF (0 for a valid anchor of a length-0 read),
    ops 0 and jfin 0.
Every comparison is exact: the values are integers.  The kernels themselves
run only on a card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from gnumap_tpu.align import nw_pallas
from gnumap_tpu.config import NEG_INF, MapperConfig
from gnumap_tpu.oracle import oracle
from gnumap_tpu_torch.align import nw_band, nw_full, nw_tb

from test_devtb import _mk_hits
from test_torch_devtb import _tandem_hits, _window

torch.set_num_threads(1)

SENT = nw_pallas.SENTINEL
DEEP = -(1 << 30)
HARSH = dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5)
G_SCORE, G_TB = 8, 16       # lanes per pair: nw_full.cu, nw_tb.cu


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kw(cfg):
    return dict(L=cfg.max_read_len, W=cfg.window_width(),
                slack=cfg.gap_slack, open_q=cfg.gap_open_q(),
                ext_q=cfg.gap_extend_q())


def strip_cols(W, G):
    return (W + G - 1) // G


def strip_words(nc):
    return (nc + 3) // 4


def forward(emis, win, lens, *, G, open_q, ext_q, band, dirs):
    """The skewed column-space forward pass on H live pairs.

    emis int[H, L, 5], win int[H, W] window codes, lens int[H] in [1, L].
    Returns (D int64[H, G, NC] of each lane's last row, d0 int64[H] column
    0's Ix at row len, sdir uint16[H, L, NH, G] nibble words or None)."""
    H, L, _ = emis.shape
    W = win.shape[1]
    NC, NH = strip_cols(W, G), strip_words(strip_cols(W, G))
    e6 = np.concatenate([emis.astype(np.int64),
                         np.full((H, L, 1), DEEP, np.int64)], axis=2)
    codes = np.full((H, G * NC), 5, np.int64)
    codes[:, :W] = win
    codes = codes.reshape(H, G, NC)
    inwin = (np.arange(G * NC) < W).reshape(G, NC)
    D = np.broadcast_to(np.where(inwin, 0, NEG_INF), (H, G, NC)).astype(
        np.int64)
    T = np.broadcast_to(np.where(inwin, max(-open_q, NEG_INF), NEG_INF),
                        (H, G, NC)).astype(np.int64)
    pd = np.zeros((H, G), np.int64)
    pq = np.full((H, G), NEG_INF, np.int64)
    d0 = np.zeros(H, np.int64)
    sdir = np.zeros((H, L, NH, G), np.uint16) if dirs else None
    g = np.arange(G)
    c0 = g * NC
    hh = np.arange(H)[:, None]
    for s in range(1, int(lens.max()) + G):
        # the two shuffles: lane g takes what lane g - 1 held after step s - 1
        in_d = np.concatenate([pd[:, :1], pd[:, :-1]], axis=1)
        in_q = np.concatenate([pq[:, :1], pq[:, :-1]], axis=1)
        row = s - g                                       # [G]
        act = (row[None, :] >= 1) & (row[None, :] <= lens[:, None])
        dprev = np.where(g[None, :] > 0, in_d, d0[:, None])
        qq = np.where(g[None, :] > 0, in_q, NEG_INF)
        e_row = e6[hh, np.clip(row - 1, 0, L - 1)[None, :]]   # [H, G, 6]
        klo = row - (band[0] if band else 0) - c0 - 1
        khi = klo + (band[1] if band else 0) - 1
        Dn, Tn = D.copy(), T.copy()
        acc = np.zeros((H, G), np.int64)
        for k in range(NC):
            e = np.take_along_axis(e_row, codes[:, :, k, None], 2)[:, :, 0]
            mn = np.maximum(e + dprev, NEG_INF)
            dprev = D[:, :, k]
            ixn = T[:, :, k]
            iy = qq
            if band:
                off = ((k < klo) | (k > khi))[None, :]
                mn = np.where(off, NEG_INF, mn)
                ixn = np.where(off, NEG_INF, ixn)
                iy = np.where(off, NEG_INF, iy)
            dn = np.maximum(np.maximum(mn, ixn), iy)
            t1, ixe, qe = mn - open_q, ixn - ext_q, iy - ext_q
            qq = np.maximum(np.maximum(qe, t1), NEG_INF)
            Dn[:, :, k] = dn
            Tn[:, :, k] = np.maximum(np.maximum(ixe, t1), NEG_INF)
            if dirs:
                nib = ((t1 < qe) * 8 + (t1 < ixe) * 4 + (ixn < dn) * 2
                       + (mn < dn))
                acc = (acc << 4) | nib
                word = None
                if k & 3 == 3:
                    word = acc
                elif k == NC - 1:
                    word = acc << (4 * (3 - (k & 3)))
                if word is not None:
                    r_idx = np.clip(row - 1, 0, L - 1)
                    old = sdir[:, r_idx, k >> 2, g]
                    sdir[:, r_idx, k >> 2, g] = np.where(
                        act, (word & 0xffff).astype(np.uint16), old)
        a3 = act[:, :, None]
        D, T = np.where(a3, Dn, D), np.where(a3, Tn, T)
        pd, pq = np.where(act, dprev, pd), np.where(act, qq, pq)
        ramp = np.maximum(-open_q if s == 1 else d0 - ext_q, NEG_INF)
        d0 = np.where(act[:, 0], ramp, d0)
    return D, d0, sdir


def group_best(D, W):
    H, G, NC = D.shape
    inwin = (np.arange(G * NC) < W)[None, :]
    return np.where(inwin, D.reshape(H, -1), NEG_INF).max(axis=1)


def model_scores(emis_t, cands, lens, genome, *, L, W, slack, open_q, ext_q):
    """nw_full.cu: the live pairs of a block's list, dead slots at once."""
    emis = emis_t.transpose(0, 2, 1)
    ok = (lens > 0) & (lens <= L)
    out = np.where((cands != SENT) & (lens == 0)[:, None], 0,
                   NEG_INF).astype(np.int32)
    rows, cols = np.nonzero((cands != SENT) & ok[:, None])
    if len(rows):
        win = nw_band.gather_windows(_t(cands[rows, cols]), _t(genome), W,
                                     slack).numpy()
        D, d0, _ = forward(emis[rows], win, lens[rows], G=G_SCORE,
                           open_q=open_q, ext_q=ext_q, band=None, dirs=False)
        out[rows, cols] = np.maximum(group_best(D, W), d0)
    return out


def model_traceback(emis_t, cands, lens, genome, *, L, W, slack, open_q,
                    ext_q, band):
    """nw_tb.cu: forward with the producer-side direction bits, the end
    cell, and the group's backwalk."""
    G = G_TB
    H = len(cands)
    Lp = nw_tb.ops_width(L)
    ops = np.zeros((H, Lp), np.int16)
    jfin = np.zeros(H, np.int32)
    live = np.nonzero((cands != SENT) & (lens > 0) & (lens <= L))[0]
    if not len(live):
        return ops, jfin
    win = nw_band.gather_windows(_t(cands[live]), _t(genome), W,
                                 slack).numpy()
    D, d0s, sdir = forward(emis_t.transpose(0, 2, 1)[live], win, lens[live],
                           G=G, open_q=open_q, ext_q=ext_q, band=band,
                           dirs=True)
    NC = D.shape[2]
    best = group_best(D, W)
    for n, h in enumerate(live):
        ln = int(lens[h])

        def cell(r, c):
            gg, k = divmod(c, NC)
            x = int(sdir[n, r - 1, k >> 2, gg])
            return (x >> (4 * (3 - (k & 3)))) & 15

        def pred(rr, jj):
            """M's predecessor at (rr, jj): 0 M, 1 Ix, 2 Iy; 3 past row 1."""
            if rr < 1:
                return 3
            if rr == 1 or jj < 1:
                return 0
            if jj == 1:
                return 1 if -open_q - (rr - 2) * ext_q > NEG_INF else 0
            x = cell(rr - 1, jj - 2)
            return (2 if x & 2 else 1) if x & 1 else 0

        def stops(r, c):
            """A deletion run at row r ends at column c: column 0's rule, or
            the open bit that cell (r, c - 1) holds about itself."""
            return c < 0 or (open_q <= ext_q if c == 0
                             else not cell(r, c - 1) & 8)

        flat = D[n].reshape(-1)
        endc = min(c for c in range(W)
                   if flat[c] == best[n] and cell(ln, c) & 3 != 3)
        at0 = d0s[n] >= best[n]
        j = 0 if at0 else endc + 1
        st = 1 if at0 else cell(ln, endc) & 1
        r = ln
        while r >= 1:       # the group's walk: lane t looks t steps ahead
            dcnt = 0
            if st == 2:
                base = j - 1
                while not any(stops(r, base - t) for t in range(G)):
                    base -= G
                c = next(base - t for t in range(G) if stops(r, base - t))
                dcnt, j, st = j - c, c, 0
            if st == 0:
                d = [pred(r - t, j - t) for t in range(G)]
                if dcnt:
                    ops[h, r - 1] = dcnt << 1
                if not any(d):
                    r, j = r - G, j - G
                    continue
                t = next(t for t in range(G) if d[t])
                if d[t] == 3:
                    j -= t
                    break
                r, j, st = r - t - 1, j - t - 1, d[t]
            else:
                ops[h, r - 1] = 1
                from_m = j >= 1 and (-open_q >= NEG_INF - ext_q if r == 1
                                     else not cell(r - 1, j - 1) & 4)
                st = 0 if from_m else 1
                r -= 1
        jfin[h] = j
    return ops, jfin


def _edge_lengths(emis, cands, lens, L):
    """Lengths 0, 1, L and L + 1 on the first four live slots (rows at and
    past a read's length are zero, as the mapper leaves them)."""
    lens = lens.copy()
    for h, v in zip(np.nonzero(cands != SENT)[0][:4], (0, 1, L, L + 1)):
        lens[h] = v
        emis[h, min(v, L):] = 0
    return lens


def _hits(case, L, slack, extra, seed, H=40):
    """(cfg, genome, emis, cands, lens) for a traceback case: reads copied
    from the genome with substitutions and 1-2 bp indels, SENTINEL slots,
    lengths 0, 1, L, L + 1; or reads from a period-4 tandem repeat."""
    cfg = MapperConfig(max_read_len=L, gap_slack=slack, **extra)
    rng = np.random.default_rng(seed)
    if case == "tandem":
        genome, emis, cands, lens = _tandem_hits(rng, H, L)
        if extra:
            raise ValueError("tandem hits use the default scoring")
    else:
        genome, emis, cands, lens = _mk_hits(rng, H, L, 900, cfg,
                                             indel_rate=0.4)
        lens = _edge_lengths(emis, cands, lens, L)
    return cfg, genome, emis, cands, lens


# (case, L, gap_slack, scoring): W = L + 2 gap_slack + 8 is 136, 144, 172
# without a band and 128 with the band (9, 42); then small shapes
TB_CASES = [
    ("indel", 104, 14, {}),              # W 140
    ("indel", 100, 14, {}),              # W 136
    ("indel", 104, 16, {}),              # W 144
    ("indel", 104, 16, HARSH),
    ("indel", 104, 30, {}),              # W 172
    ("tandem", 104, 16, {}),
    ("indel", 104, 8, {}),               # W 128, band (9, 42)
    ("indel", 104, 8, HARSH),
    ("tandem", 104, 8, {}),
    ("indel", 24, 0, {}),                # band (1, 10)
    ("indel", 24, 13, HARSH),            # band (14, 62)
    ("indel", 20, 14, dict(gap_open=2.0)),
]


@pytest.mark.parametrize("case,L,slack,extra", TB_CASES)
def test_traceback_model_equals_plain(case, L, slack, extra):
    """The traceback kernel's algebra == nw_traceback_plain on ops and jfin,
    dead slots (SENTINEL, length 0 and L + 1) included."""
    cfg, genome, emis, cands, lens = _hits(case, L, slack, extra,
                                           seed=7 * L + slack)
    emis_t = np.ascontiguousarray(emis.transpose(0, 2, 1))
    kw = dict(band=cfg.band(), **_kw(cfg))
    want_o, want_j = nw_tb.nw_traceback_plain(
        _t(emis_t), _t(cands), _t(lens), _t(genome), **kw)
    got_o, got_j = model_traceback(emis_t, cands, lens, genome, **kw)
    assert np.array_equal(got_o, want_o.numpy())
    assert np.array_equal(got_j, want_j.numpy())
    dead = (cands == SENT) | (lens <= 0) | (lens > L)
    assert dead.sum() >= (0 if case == "tandem" else 6)
    assert not got_o[dead].any() and not got_j[dead].any()
    assert (got_o[~dead] != 0).any(axis=1).sum() >= (
        0 if case == "tandem" else 3)


@pytest.mark.parametrize("slack,L,extra", [
    (14, 100, {}), (16, 104, {}), (16, 104, HARSH), (30, 104, {}),
    (14, 20, {}), (24, 24, HARSH)])
def test_score_model_equals_plain(slack, L, extra):
    """The unbanded scoring kernel's algebra == nw_scores_full_plain on
    every slot: SENTINELs anywhere in a row, lengths 0, 1, L and L + 1."""
    cfg = MapperConfig(max_read_len=L, gap_slack=slack, **extra)
    assert cfg.band() is None
    rng = np.random.default_rng(slack + L)
    B2, C = 12, 6
    genome, emis, anchors, lens = _mk_hits(rng, B2, L, 900, cfg,
                                           indel_rate=0.4)
    lens = _edge_lengths(emis, anchors, lens, L)
    cands = rng.integers(-L, 900 + L, (B2, C)).astype(np.int32)
    cands[:, 0] = anchors
    cands[rng.random((B2, C)) < 0.3] = SENT
    emis_t = np.ascontiguousarray(emis.transpose(0, 2, 1))
    want = nw_full.nw_scores_full_plain(_t(emis_t), _t(cands), _t(lens),
                                        _t(genome), **_kw(cfg)).numpy()
    got = model_scores(emis_t, cands, lens, genome, **_kw(cfg))
    assert np.array_equal(got, want)
    assert (got[cands == SENT] == NEG_INF).all()
    assert (got[lens == 0][cands[lens == 0] != SENT] == 0).all()
    assert (got[lens == L + 1] == NEG_INF).all()
    assert (got > 0).sum() >= 4


def test_models_equal_pallas_and_oracle():
    """Both models against the Pallas kernels in interpret mode
    (nw_scores_pallas, nw_traceback_pallas with and without the band) and
    oracle.nw_align on every hit with a positive score."""
    for slack in (16, 8):
        L = 24
        cfg = MapperConfig(max_read_len=L, gap_slack=slack)
        W = cfg.window_width()
        genome, emis, cands, lens = _mk_hits(np.random.default_rng(slack),
                                             48, L, 900, cfg, indel_rate=0.4)
        emis_t = np.ascontiguousarray(emis.transpose(0, 2, 1))
        gw = nw_pallas.pad_genome_words(genome, W)
        jkw = dict(L=L, W=W, slack=slack, open_q=cfg.gap_open_q(),
                   ext_q=cfg.gap_extend_q(), interpret=True)
        want_o, want_j = nw_pallas.nw_traceback_pallas(
            emis_t, cands, lens, gw, band=cfg.band(), **jkw)
        got_o, got_j = model_traceback(emis_t, cands, lens, genome,
                                       band=cfg.band(), **_kw(cfg))
        assert np.array_equal(got_o, np.asarray(want_o))
        assert np.array_equal(got_j, np.asarray(want_j))
        if cfg.band() is not None:
            continue
        cands2 = np.full((len(cands), 16), SENT, np.int32)
        cands2[:, 0] = cands
        scores = model_scores(emis_t, cands2, lens, genome, **_kw(cfg))
        assert np.array_equal(scores, np.asarray(nw_pallas.nw_scores_pallas(
            emis_t, cands2, lens, gw, **jkw)))
        n = 0
        for h in np.nonzero((cands != SENT) & (scores[:, 0] > 0))[0]:
            lb = int(lens[h])
            sc, pos_w, cigar, ref_len = oracle.nw_align(
                emis[h, :lb], _window(cfg, genome, cands[h]), cfg,
                traceback=True)
            assert sc == scores[h, 0]
            assert nw_tb.decode_ops(got_o[h], lb) == (cigar, ref_len)
            assert got_j[h] == pos_w
            n += 1
        assert n >= 20


def test_floor_where_written_equals_floor_where_read():
    """The Iy chain floors at every write, q' = max(q - ext, M - open,
    NEG_INF); the frozen recurrence floors the unfloored prefix max once.
    Both give the same values when M dips to NEG_INF and far below
    -open (ext >= 0), also for ext = 0 and open = 0."""
    rng = np.random.default_rng(0)
    for open_q, ext_q in ((200, 50), (0, 0), (65536, 32768), (5, 0)):
        M = rng.integers(-3000, 3000, (64, 40)).astype(np.int64)
        M[rng.random(M.shape) < 0.3] = NEG_INF
        M[:, :3] = NEG_INF
        j = np.arange(1, 41)
        pm = np.maximum.accumulate(M + j * ext_q, axis=1)
        frozen = np.maximum(np.concatenate(
            [np.full((64, 1), NEG_INF), pm[:, :-1]], axis=1) - open_q
            - np.arange(40) * ext_q, NEG_INF)
        q = np.full(64, NEG_INF, np.int64)
        for c in range(40):
            assert np.array_equal(q, frozen[:, c])
            q = np.maximum(np.maximum(q - ext_q, M[:, c] - open_q), NEG_INF)
