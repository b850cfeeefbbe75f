"""The decompositions of the port's pure-diagonal kernel (gnumap_tpu_torch/
csrc/nw_pure.cu, B2) and ordered accumulator kernel (csrc/accum_rmw.cu, B5),
modelled in numpy step by step and held to the plain versions the CPU runs
(``nw_pure_banded_plain``, ``apply_deltas_plain``), to the Pallas kernels in
interpret mode and to the oracle.

B2's model does what the kernel does, in its order:
  * a group of G = 8 lanes owns a hit in band coordinates, lane g the S =
    ceil(bw / G) band lanes from g S, with D = max(M, Ix, Iy), T = max(M -
    open, Ix - ext, NEG_INF) and the gapless sum gl of the strip's last row;
    band lanes at and past bw are padding that runs on bounded values;
  * T crosses a strip's edge from the strip above (the lane after the
    group's last gets its own value back, as a shuffle does); the owner of
    band lane bw - 1 puts row 0's value (row 1) or NEG_INF (after) where
    lane bw's T would be read;
  * the Iy chain starts at NEG_INF inside each strip; the strips' carries
    are combined by a log-step max-plus scan in which a lane below the step
    gets its own value back, shifted up by one strip, and reach a cell as
    max(D, carry - j ext);
  * the window codes slide one lane down a row, across the strips, and the
    band's top lane takes the staged code of the row;
  * all groups run to the longest read; a group takes its end row at its
    own length: the smallest real band lane with max(M, Ix) == score, as a
    min over (lane << 1 | pure) keys;
  * dead slots (SENTINEL, length 0 or above L, score <= 0): (false, 0).

B5's model: the order check; in order, a work item per (delta, 128-float
row), owner rule by row, the run of covering deltas found 32 span starts at
a time from delta h - 1 on; in any other order, accumulator row a belongs to
warp a mod (the grid's warps) and every warp walks all span starts.  Rows past
the accumulator's end are skipped.  An accumulator row is written once in
the ordered path.  Bits are compared, not values.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from gnumap_tpu.align import nw_pallas
from gnumap_tpu.config import NEG_INF, MapperConfig
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.oracle import oracle
from gnumap_tpu_torch.pipeline import mapper as tm
from gnumap_tpu_torch.posterior import accum

from test_devtb import _mk_hits
from test_device_accum import _run as _run_jax, _workload
from test_torch_bridge import port_iter, to_port
from test_torch_devtb import (_port_pure, _port_scores, _tandem_hits,
                              _window)

torch.set_num_threads(1)

SENT = nw_pallas.SENTINEL
DEEP = -(1 << 30)
HARSH = dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5)
GROUP = 8            # lanes a hit: nw_pure.cu
NO_KEY = 0x7fffffff


def window_codes(genome, ws, lo, hi, W):
    """Codes at window indices lo .. hi - 1 of the window starting at ws: 5
    outside window columns [1, W], 4 outside the genome."""
    wi = np.arange(lo, hi)
    p = ws + wi
    inside = (p >= 0) & (p < len(genome))
    code = np.where(inside, genome[np.clip(p, 0, len(genome) - 1)], 4)
    return np.where((wi < 0) | (wi >= W), 5, code).astype(np.int64)


def pure_strips(emis, cands, lens, scores, genome, cfg, G=GROUP):
    """(pure bool[H], jfin int32[H]) by the kernel's decomposition."""
    H, L, _ = emis.shape
    W, slack = cfg.window_width(), cfg.gap_slack
    boff, bw = cfg.band()
    open_q, ext_q = cfg.gap_open_q(), cfg.gap_extend_q()
    S = (bw + G - 1) // G
    GS = G * S
    GL, JS = (bw - 1) // S, (bw - 1) % S
    pure = np.zeros(H, bool)
    jfin = np.zeros(H, np.int32)
    live = np.nonzero((cands != SENT) & (lens > 0) & (lens <= L)
                      & (scores > 0))[0]
    if len(live) == 0:
        return pure, jfin
    n = len(live)
    e6 = np.concatenate([emis[live].astype(np.int64),
                         np.full((n, L, 1), DEEP, np.int64)], axis=2)
    ln, sc = lens[live], scores[live].astype(np.int64)
    ws = (np.floor_divide(cands[live].astype(np.int64) - slack, 8) * 8)
    # every code a hit's band ever reads: window index -boff .. L + GS - boff
    codes = np.stack([window_codes(genome, int(w), -boff, L + GS - boff, W)
                      for w in ws])
    b = np.arange(GS)
    col0 = b - boff
    m0 = np.where((col0 >= 0) & (col0 <= W), 0, NEG_INF).astype(np.int64)
    D = np.tile(m0, (n, 1)).reshape(n, G, S)
    T = np.maximum(D - open_q, NEG_INF)
    gl = np.zeros((n, G, S), np.int64)
    P = codes[:, :GS].reshape(n, G, S).copy()
    m_tail = 0 if 0 <= bw - boff <= W else NEG_INF
    tail = max(m_tail - open_q, NEG_INF)
    key = np.full(n, NO_KEY, np.int64)
    for i in range(1, int(ln.max()) + 1):
        top = codes[:, i + GS - 1]            # index (i + GS - 1 - boff)
        # T of the strip above; the group's last lane gets its own back
        t_in = np.concatenate([T[:, 1:, 0], T[:, -1:, 0]], axis=1)
        if JS + 1 < S:
            T[:, GL, JS + 1] = tail
        else:
            t_in[:, GL] = tail
        e = np.take_along_axis(
            e6[:, i - 1][:, None, :].repeat(G, axis=1), P, axis=2)
        lq = np.full((n, G), NEG_INF, np.int64)
        mn = np.empty_like(D)
        ix = np.empty_like(D)
        for j in range(S):
            mn[:, :, j] = np.maximum(e[:, :, j] + D[:, :, j], NEG_INF)
            ix[:, :, j] = T[:, :, j + 1] if j + 1 < S else t_in
            D[:, :, j] = np.maximum(np.maximum(mn[:, :, j], ix[:, :, j]), lq)
            mo = np.maximum(mn[:, :, j] - open_q, NEG_INF)
            lq = np.maximum(lq - ext_q, mo)
            T[:, :, j] = np.maximum(ix[:, :, j] - ext_q, mo)
            gl[:, :, j] = np.maximum(gl[:, :, j] + e[:, :, j], NEG_INF)
        # the end row of the groups whose read ends here
        for h in np.nonzero(ln == i)[0]:
            for bb in range(bw):
                g, j = divmod(bb, S)
                if max(mn[h, g, j], ix[h, g, j]) == sc[h]:
                    key[h] = (bb << 1) | int(mn[h, g, j] >= ix[h, g, j]
                                             and gl[h, g, j] == sc[h])
                    break
        # the carry scan: a lane below the step gets its own value back
        x = lq
        d = 1
        while d < G:
            y = np.concatenate([x[:, :d], x[:, :-d]], axis=1)
            x = np.maximum(y - d * S * ext_q, x)
            d <<= 1
        c = np.concatenate([np.full((n, 1), NEG_INF, np.int64), x[:, :-1]],
                           axis=1)
        D = np.maximum(D, c[:, :, None] - np.arange(S) * ext_q)
        # slide the codes one lane down across the strips
        flat = P.reshape(n, GS)
        P = np.concatenate([flat[:, 1:], top[:, None]], axis=1).reshape(
            n, G, S)
        tail = NEG_INF
        assert np.abs(D).max() < (1 << 31) and np.abs(gl).max() < (1 << 31)
    ok = (key != NO_KEY) & ((key & 1) == 1)
    pure[live] = ok
    jfin[live] = np.where(ok, (key >> 1) - boff, 0)
    return pure, jfin


def _hits(rng, cfg, H, G, tandem=False):
    """Hit slots with every kind of dead slot and edge length among them:
    SENTINELs (every 8th), lengths 0, 1, L and L + 1, anchors at both ends
    of the genome, scores <= 0; the scores are B1's (plain version)."""
    L = cfg.max_read_len
    if tandem:
        genome, emis, cands, lens = _tandem_hits(rng, H, L)
    else:
        genome, emis, cands, lens = _mk_hits(rng, H, L, G, cfg,
                                             indel_rate=0.3)
        lens[:4] = (0, 1, L, L + 1)
        cands[:4] = (11, 12, 13, 14)
        cands[4], cands[5] = 0, len(genome) - 3
    scores = _port_scores(cfg, genome, emis, cands,
                          np.minimum(lens, L)).astype(np.int32)
    if not tandem:
        scores[8:12] = (0, -5, NEG_INF, 0)
    return genome, emis, cands, lens, scores


PURE_CASES = [(0, {}), (4, {}), (8, {}), (13, {}), (8, HARSH),
              (8, dict(gap_open=2.0))]


@pytest.mark.parametrize("slack,extra", PURE_CASES)
def test_pure_strips_equal_plain(slack, extra):
    """The strip decomposition == nw_pure_banded_plain on every slot, at
    band widths 10, 26, 42 and 62 and a harsh scoring."""
    cfg = MapperConfig(max_read_len=24, gap_slack=slack, **extra)
    rng = np.random.default_rng(70 + slack)
    genome, emis, cands, lens, scores = _hits(rng, cfg, 96, 700)
    got_p, got_j = pure_strips(emis, cands, lens, scores, genome, cfg)
    want_p, want_j = _port_pure(cfg, genome, emis, cands, lens, scores)
    assert np.array_equal(got_p, want_p)
    assert np.array_equal(got_j, want_j)
    dead = (cands == SENT) | (lens <= 0) | (lens > 24) | (scores <= 0)
    assert dead.sum() >= 16
    assert not got_p[dead].any() and not got_j[dead].any()
    if not extra:
        assert got_p.sum() >= 20


@pytest.mark.parametrize("lanes", [2, 4, 8, 16])
def test_pure_strips_any_group_size(lanes):
    """The decomposition does not depend on the lanes a hit: strips of 21,
    11, 6 and 3 band lanes at bw 42 give the plain version's result."""
    cfg = MapperConfig(max_read_len=24)
    rng = np.random.default_rng(lanes)
    genome, emis, cands, lens, scores = _hits(rng, cfg, 64, 700)
    got = pure_strips(emis, cands, lens, scores, genome, cfg, G=lanes)
    want = _port_pure(cfg, genome, emis, cands, lens, scores)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("slack", [4, 8])
def test_pure_strips_equal_pallas(slack):
    """The strip decomposition == nw_pallas.nw_pure_banded in interpret
    mode at default scoring (where the port's banded DP and the Pallas one
    agree), fed the Pallas scores."""
    cfg = MapperConfig(max_read_len=24, gap_slack=slack)
    rng = np.random.default_rng(80 + slack)
    genome, emis, cands, lens = _mk_hits(rng, 96, 24, 900, cfg,
                                         indel_rate=0.3)
    L, W = cfg.max_read_len, cfg.window_width()
    boff, bw = cfg.band()
    gw = nw_pallas.pad_genome_words(genome, W)
    emis_t = np.ascontiguousarray(emis.transpose(0, 2, 1))
    jkw = dict(L=L, W=W, slack=slack, boff=boff, bw=bw,
               open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q(),
               interpret=True)
    scores = np.asarray(nw_pallas.nw_scores_banded(
        emis_t, cands[:, None], lens, gw, **jkw))[:, 0]
    want_p, want_j = nw_pallas.nw_pure_banded(emis_t, cands, lens, scores,
                                              gw, **jkw)
    got_p, got_j = pure_strips(emis, cands, lens, scores, genome, cfg)
    assert np.array_equal(got_p, np.asarray(want_p))
    assert np.array_equal(got_j, np.asarray(want_j))
    assert got_p.sum() >= 20


@pytest.mark.parametrize("slack,extra", [(0, {}), (8, {}), (13, {}),
                                         (8, HARSH)])
def test_pure_strips_equal_oracle(slack, extra):
    """Every hit the model calls pure has the oracle's score, an all-M
    CIGAR and the oracle's first aligned column."""
    cfg = MapperConfig(max_read_len=24, gap_slack=slack, **extra)
    rng = np.random.default_rng(90 + slack)
    genome, emis, cands, lens, scores = _hits(rng, cfg, 64, 600)
    pure, jfin = pure_strips(emis, cands, lens, scores, genome, cfg)
    n_pure = 0
    for h in np.nonzero(pure)[0]:
        lb = int(lens[h])
        sc, pos_w, cigar, _ = oracle.nw_align(
            emis[h, :lb], _window(cfg, genome, cands[h]), cfg,
            traceback=True)
        assert (sc, cigar, pos_w) == (scores[h], f"{lb}M", jfin[h])
        n_pure += 1
    assert n_pure >= (1 if extra else 15)


def test_pure_strips_tandem_ties():
    """Reads from a period-4 tandem repeat: several band lanes reach the
    score at the end row, and the smallest one must win across strips."""
    cfg = MapperConfig(max_read_len=24)
    rng = np.random.default_rng(7)
    genome, emis, cands, lens, scores = _hits(rng, cfg, 32, 0, tandem=True)
    got = pure_strips(emis, cands, lens, scores, genome, cfg)
    want = _port_pure(cfg, genome, emis, cands, lens, scores)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[0].sum() >= 8
    for h in np.nonzero(got[0])[0][:8]:
        _, pos_w, cigar, _ = oracle.nw_align(
            emis[h], _window(cfg, genome, cands[h]), cfg, traceback=True)
        assert cigar == "24M" and pos_w == got[1][h]


# ---------------------------------------------------------------- B5

def rmw_model(arr, base, deltas, n_real, rowmul, grid_warps=24):
    """arr after the kernel's work, by its decomposition; arr f32[R, 128]
    is updated in place.  Returns how often each accumulator row was
    written (the ordered path writes a row once)."""
    R = arr.shape[0]
    H, nrows = deltas.shape[:2]
    n = max(0, min(int(n_real), H))
    writes = np.zeros(R, np.int64)
    FAR = 1 << 62
    ordered = not any(base[h] < base[h - 1] for h in range(1, n))
    if not ordered:
        # row a belongs to warp a mod grid_warps; a warp walks every start
        for w in range(grid_warps):
            for h0 in range(0, n, 32):
                for t in range(min(32, n - h0)):
                    a0 = int(base[h0 + t]) * rowmul
                    r = (w - a0 % grid_warps) % grid_warps
                    while r < nrows:
                        a = a0 + r
                        if 0 <= a < R:
                            arr[a] = arr[a] + deltas[h0 + t, r]
                            writes[a] += 1
                        r += grid_warps
        return writes
    for item in range(n * nrows):
        h, r = divmod(item, nrows)
        own = deltas[h, r]
        gs, skip = h - 1, 1
        bg = np.array([int(base[g]) * rowmul if 0 <= g < n else FAR
                       for g in range(gs, gs + 32)])
        a = bg[1] + r
        if a < 0 or a >= R:
            continue
        if h > 0 and bg[0] + nrows > a:
            continue                      # delta h - 1 covers the row
        acc = arr[a] + own
        skip += 1
        while True:
            covered = bg <= a             # the ballot
            cnt = 0
            while skip + cnt < 32 and covered[skip + cnt]:
                cnt += 1
            for t in range(cnt):
                g = gs + skip + t
                acc = acc + deltas[g, a - bg[skip + t]]
            if cnt < 32 - skip:
                break
            gs, skip = gs + 32, 0
            bg = np.array([int(base[g]) * rowmul if g < n else FAR
                           for g in range(gs, gs + 32)])
        arr[a] = acc
        writes[a] += 1
    return writes


def _deltas(rng, H, nrows):
    # magnitudes spread over 2^-20 .. 2^4, so the add order shows in the bits
    return (rng.standard_normal((H, nrows, 128))
            * 2.0 ** rng.integers(-20, 5, (H, nrows, 128))).astype(np.float32)


def _plain(arr, base, deltas, n_real, rowmul):
    """apply_deltas_plain on an accumulator padded by one span, so that a
    span past the end is cut and not refused; the pad is dropped."""
    R, nrows = arr.shape[0], deltas.shape[1]
    pad = np.concatenate([arr, np.zeros((nrows, 128), np.float32)])
    out = accum.apply_deltas_plain(
        torch.from_numpy(pad), torch.from_numpy(base),
        torch.from_numpy(deltas), torch.tensor(n_real, dtype=torch.int32),
        rowmul=rowmul).numpy()
    return out[:R]


@pytest.mark.parametrize("rowmul", [1, 4])
@pytest.mark.parametrize("case", ["pileups", "any_order", "n0", "n1", "nH",
                                  "clipped", "long_run"])
def test_rmw_partition_equals_plain(case, rowmul):
    """The work partition and the owner rule give the serial version's f32
    bits: span starts in order with pileups and overlapping neighbours, in
    any order, n_real 0, 1 and H, spans cut at the accumulator's end, and a
    pileup longer than the 32 span starts read at a time."""
    rng = np.random.default_rng(rowmul * 100 + len(case))
    H, nrows, R = 120, 2 * rowmul, 96 * rowmul
    base = rng.integers(0, R // rowmul - 2, H)
    base[20:30] = base[19]                              # a pileup
    base[40:52] = base[39] + np.arange(12) % 2          # two neighbours
    n_real = H - 9
    if case == "long_run":
        base[60:130] = base[59]                         # 61 and more on one
    if case != "any_order":
        base[:n_real] = np.sort(base[:n_real])
    if case == "clipped":
        base[n_real - 6:n_real] = R // rowmul - 1       # last unit: half out
    n_real = {"n0": 0, "n1": 1, "nH": H}.get(case, n_real)
    if case == "nH":
        base = np.sort(base)
    base = base.astype(np.int32)
    deltas = _deltas(rng, H, nrows)
    arr0 = rng.standard_normal((R, 128)).astype(np.float32)
    want = _plain(arr0.copy(), base, deltas, n_real, rowmul)
    got = arr0.copy()
    writes = rmw_model(got, base, deltas, n_real, rowmul)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if case == "n0":
        assert np.array_equal(got, arr0)
    else:
        assert not np.array_equal(got, arr0)
    if case != "any_order":
        assert writes.max() <= 1          # a row is read and written once
    if case == "clipped":
        assert writes[R - rowmul:].sum() > 0


@pytest.mark.parametrize("order", ["sorted", "any"])
def test_apply_deltas_pair_equals_two_calls(order):
    """The pair entry (coverage and tallies in one launch on a card) on the
    CPU == apply_deltas on each accumulator, coverage first, bit for bit,
    in place."""
    rng = np.random.default_rng(len(order))
    H, units = 64, 40
    base = rng.integers(0, units - 2, H)
    base[10:20] = base[9]
    if order == "sorted":
        base = np.sort(base)
    base = torch.from_numpy(base.astype(np.int32))
    cov_d, tal_d = (torch.from_numpy(_deltas(rng, H, k)) for k in (2, 8))
    cov0 = torch.from_numpy(rng.standard_normal((units, 128)).astype(
        np.float32))
    tal0 = torch.from_numpy(rng.standard_normal((4 * units, 128)).astype(
        np.float32))
    n_real = torch.tensor(H - 5, dtype=torch.int32)
    cov, tal = cov0.clone(), tal0.clone()
    out = accum.apply_deltas_pair(cov, tal, base, cov_d, tal_d, n_real)
    assert out[0] is cov and out[1] is tal
    want_c = accum.apply_deltas(cov0.clone(), base, cov_d, n_real, rowmul=1)
    want_t = accum.apply_deltas(tal0.clone(), base, tal_d, n_real, rowmul=4)
    assert torch.equal(cov.view(torch.int32), want_c.view(torch.int32))
    assert torch.equal(tal.view(torch.int32), want_t.view(torch.int32))
    assert not torch.equal(tal, tal0)
    n0 = accum.LAUNCHES
    accum.apply_deltas_pair(cov, tal, base, cov_d, tal_d, n_real)
    assert accum.LAUNCHES == n0           # the plain version does not count


@pytest.mark.parametrize("snp", [True, False])
def test_device_accumulate_uses_one_call_a_batch(snp, monkeypatch):
    """device_accumulate hands coverage and tallies to the pair entry, one
    call a batch (the single entry when there are no tallies), and the
    result equals the JAX device path's bit for bit."""
    cfg, gen, idx, recs = _workload(snp=snp)
    calls = {"pair": 0, "single": 0}
    real_pair, real_one = accum.apply_deltas_pair, accum.apply_deltas

    def pair(*a, **k):
        calls["pair"] += 1
        return real_pair(*a, **k)

    def one(*a, **k):
        calls["single"] += 1
        return real_one(*a, **k)

    monkeypatch.setattr(accum, "apply_deltas_pair", pair)
    monkeypatch.setattr(accum, "apply_deltas", one)
    m = tm.TorchMapper(*to_port((gen, idx, cfg)), device="cpu",
                       accumulate="device")
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    rd = tm.map_stream(m, port_iter(iter(batches)), collect_sam=False)
    want = ({"pair": len(batches), "single": 0} if snp
            else {"pair": 0, "single": len(batches)})
    assert calls == want and len(batches) >= 2
    rj = _run_jax(cfg, gen, idx, recs, "device")
    assert np.array_equal(rd.coverage, rj.coverage)
    if snp:
        assert np.array_equal(rd.tallies, rj.tallies)
        assert rd.tallies.sum() > 0
