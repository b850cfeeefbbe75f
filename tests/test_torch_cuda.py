"""Tests of the port that need a CUDA card (marker ``cuda``; each skips
without one).  This file imports no jax, so it runs on a machine that has
only torch and the port (nothing of the JAX package is imported):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each kernel (B1 nw_band, B2 nw_pure, B3 nw_tb banded and unbanded, B4
nw_full, B5 accum_rmw and its pair entry) is held to its plain torch version
on the same inputs (exact equality; B5 bit for bit, and again on a repeat
launch), and
the mapper on the card to the mapper on the CPU, with the device finish,
the host finish and device accumulation; the FM search (index/fm.fm_hits),
the bisulfite seeding (seed_kmers_b3) and the mapper on each index kind and
through GlobalSegmentedMapper, on the card and on the CPU; the reads x
index mesh (dist/collectives.DistMapper) on the card, in a world of one
rank on NCCL and of two ranks sharing the card over gloo, against
TorchMapper on the card; the staging ring (pipeline/staging.py) behind slow
device work; the device PWMs and reverse complements against the host
tables; the captured device programs
(pipeline/graphs.py): each replay's outputs equal the eager program's bit
for bit, launches counted through replays, the capacity-overflow fallback
through its own captured program, and a stream with the staging ring full
equal to the eager programs' on the card.
"""

import numpy as np
import pytest
import torch

from gnumap_tpu_torch.align import scoring
from gnumap_tpu_torch.config import NEG_INF, MapperConfig
from gnumap_tpu_torch.core import packing, pwm
from gnumap_tpu_torch.dist import segments
from gnumap_tpu_torch.index import builder, fm
from gnumap_tpu_torch.io import fastq as io_fastq
from gnumap_tpu_torch.utils import sim
from gnumap_tpu_torch.align import nw_band, nw_full, nw_pure, nw_tb
from gnumap_tpu_torch.pipeline import mapper as tm
from gnumap_tpu_torch.posterior import accum

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU form)")
    return torch.device("cuda")


def _inputs(rng, B2, C, L, G, cfg):
    genome = rng.integers(0, 5, G).astype(np.int8)
    lens = rng.integers(1, L + 1, B2).astype(np.int32)
    lens[0], lens[1] = 0, L
    codes = rng.integers(0, 5, (B2, L)).astype(np.int8)
    pq = pwm.pwm_rows_from_table(codes, rng.integers(2, 41, (B2, L)))
    pq = np.where((np.arange(L)[None, :] < lens[:, None])[:, :, None], pq, 0)
    emis = scoring.emission_int(pq, scoring.normal_matrix(cfg))
    cands = np.full((B2, C), nw_band.SENTINEL, np.int32)
    for b in range(2, B2):
        k = rng.integers(0, C + 1)
        cands[b, :k] = np.sort(rng.integers(-L, G + L, k))
    emis_t = np.ascontiguousarray(emis.transpose(0, 2, 1))
    return [torch.from_numpy(x) for x in (emis_t, cands, lens, genome)]


@pytest.mark.parametrize("slack,C,harsh,L", [
    (8, 32, False, 48), (8, 160, False, 48), (0, 8, False, 48),
    (13, 8, False, 48), (8, 32, True, 48), (8, 128, False, 160),
    (8, 8, False, 600)])
def test_kernel_matches_plain(slack, C, harsh, L):
    """Including C > 128, length 0 and L, anchors below 0 and past the
    genome's end, the narrowest and widest bands, a scoring whose emissions
    reach below -open, and read lengths whose emission tables need more
    than 48 KB of shared memory a block (L = 160 at 16 rows a block) or
    fewer rows a block (L = 600)."""
    dev = _card()
    extra = (dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5)
             if harsh else {})
    cfg = MapperConfig(max_read_len=L, gap_slack=slack, **extra)
    args = _inputs(np.random.default_rng(slack + C), 96, C, L, 3000, cfg)
    boff, bw = cfg.band()
    kw = dict(L=L, W=cfg.window_width(), slack=slack, boff=boff, bw=bw,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    n0 = nw_band.LAUNCHES
    got = nw_band.nw_scores_banded(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    assert nw_band.LAUNCHES == n0 + 1
    want = nw_band.nw_scores_banded(*args, **kw)
    assert torch.equal(got.cpu(), want)
    assert (want[0] == NEG_INF).all()


LIVE_SETS = ("all_live", "half_random", "prefix", "one_per_row", "none_live",
             "mixed_lengths")


def live_set(name, rng, B2, C, L, G):
    """(cands int32[B2, C], lens int32[B2]) with the live slots of ``name``:
    the small twins of chip_smoke.py's kernel_b1 sets.  SENTINELs sit
    anywhere in a row except in "all_live" and "prefix" (sorted, SENTINEL
    last, as the mapper's dedupe_cap leaves them); "mixed_lengths" holds
    reads of length 0, 1 and L among random ones."""
    full = rng.integers(-L // 2, G - 1, (B2, C))
    col = np.arange(C)[None, :]
    lens = np.full(B2, L - 2, np.int32)
    mask = {"all_live": np.ones((B2, C), bool),
            "half_random": rng.random((B2, C)) < 0.5,
            "prefix": col < rng.integers(1, 4, B2)[:, None],
            "one_per_row": col == rng.integers(0, C, B2)[:, None],
            "none_live": np.zeros((B2, C), bool),
            "mixed_lengths": rng.random((B2, C)) < 0.5}[name]
    cands = np.where(mask, full, nw_band.SENTINEL)
    if name in ("all_live", "prefix"):
        cands = np.sort(cands, axis=1)
    if name == "mixed_lengths":
        lens = rng.integers(1, L + 1, B2).astype(np.int32)
        lens[:3] = (0, 1, L)
    return cands.astype(np.int32), lens


@pytest.mark.parametrize("slack", [8, 4, 13])
@pytest.mark.parametrize("name", LIVE_SETS)
def test_kernel_matches_plain_on_live_sets(name, slack):
    """B1 on the card == its plain version on every slot, whatever the
    SENTINEL placement: every slot live, half at random, a sorted prefix,
    one per row, none, and mixed lengths with 0, 1, L and L + 1; 40 rows, so
    the last block of 16 rows is ragged; band widths 42, 26 and 62."""
    dev = _card()
    L, C, B2, G = 48, 32, 40, 3000
    cfg = MapperConfig(max_read_len=L, gap_slack=slack)
    rng = np.random.default_rng(slack)
    emis_t, _, _, genome = _inputs(rng, B2, C, L, G, cfg)
    cands, lens = live_set(name, rng, B2, C, L, G)
    if name == "mixed_lengths":
        lens[3] = L + 1
    lens = torch.from_numpy(lens)
    emis_t = emis_t * (torch.arange(L)[None, :] < lens[:, None])[:, None, :]
    args = [emis_t.contiguous(), torch.from_numpy(cands), lens, genome]
    boff, bw = cfg.band()
    kw = dict(L=L, W=cfg.window_width(), slack=slack, boff=boff, bw=bw,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    got = nw_band.nw_scores_banded(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    want = nw_band.nw_scores_banded(*args, **kw)
    assert torch.equal(got.cpu(), want)
    dead = (args[1] == nw_band.SENTINEL) | ((lens <= 0) | (lens > L))[:, None]
    assert (want[dead] == NEG_INF).all() and (want[~dead] > NEG_INF).all()


@pytest.mark.parametrize("slack", [16, 14, 30])
@pytest.mark.parametrize("name", LIVE_SETS)
def test_full_kernel_matches_plain_on_live_sets(name, slack):
    """B4 on the card == its plain version on every slot, whatever the
    SENTINEL placement and the lengths (0, 1, L, L + 1 among them): 40
    rows, so the last block of 16 rows is ragged and a round of 16 pairs is
    often not full; window widths 88, 84 and 116 (11, 11 and 15 columns a
    lane)."""
    dev = _card()
    L, C, B2, G = 48, 32, 40, 3000
    cfg = MapperConfig(max_read_len=L, gap_slack=slack)
    rng = np.random.default_rng(slack)
    emis_t, _, _, genome = _inputs(rng, B2, C, L, G, cfg)
    cands, lens = live_set(name, rng, B2, C, L, G)
    if name == "mixed_lengths":
        lens[3] = L + 1
    lens = torch.from_numpy(lens)
    emis_t = emis_t * (torch.arange(L)[None, :] < lens[:, None])[:, None, :]
    args = [emis_t.contiguous(), torch.from_numpy(cands), lens, genome]
    kw = dict(L=L, W=cfg.window_width(), slack=slack,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    got = nw_full.nw_scores_full(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    want = nw_full.nw_scores_full(*args, **kw)
    assert torch.equal(got.cpu(), want)
    valid = args[1] != nw_band.SENTINEL
    assert (want[~valid] == NEG_INF).all()
    assert (want[valid & (lens == 0)[:, None]] == 0).all()
    assert (want[valid & (lens > L)[:, None]] == NEG_INF).all()
    assert (want[valid & ((lens > 0) & (lens <= L))[:, None]] > NEG_INF).all()


TB_LIVE_SETS = ("all_live", "half_random", "prefix", "none_live",
                "mixed_lengths")


@pytest.mark.parametrize("slack", [8, 16])
@pytest.mark.parametrize("name", TB_LIVE_SETS)
def test_traceback_kernel_matches_plain_on_live_sets(name, slack):
    """B3 on the card == its plain version on ops and jfin, with the band
    mask (gap_slack 8) and without a band (gap_slack 16), whichever hit
    slots are live: all, half at random, a prefix (as the mapper's
    compaction leaves them), none, and mixed lengths with 0, 1, L and
    L + 1; 161 slots, so the last block is ragged."""
    dev = _card()
    L, H = 48, 161
    cfg = MapperConfig(max_read_len=L, gap_slack=slack)
    rng = np.random.default_rng(slack + len(name))
    args, _ = _hits(rng, H, L, 3000, cfg)
    cands, lens = args[1].numpy().copy(), args[2].numpy().copy()
    cands[cands == nw_band.SENTINEL] = 77
    mask = {"all_live": np.ones(H, bool),
            "half_random": rng.random(H) < 0.5,
            "prefix": np.arange(H) < 9,
            "none_live": np.zeros(H, bool),
            "mixed_lengths": rng.random(H) < 0.5}[name]
    cands = np.where(mask, cands, nw_band.SENTINEL).astype(np.int32)
    if name == "mixed_lengths":
        lens[:8] = (0, 1, L, L + 1, 1, L, 0, L + 1)
        cands[:8] = 100 + np.arange(8)
    elif name != "none_live":
        lens[lens == 0] = L
    args[1], args[2] = torch.from_numpy(cands), torch.from_numpy(lens)
    kw = dict(L=L, W=cfg.window_width(), slack=slack, band=cfg.band(),
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    ops, jf = nw_tb.nw_traceback(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    wops, wjf = nw_tb.nw_traceback(*args, **kw)
    assert torch.equal(ops.cpu(), wops) and torch.equal(jf.cpu(), wjf)
    dead = torch.from_numpy((cands == nw_band.SENTINEL) | (lens <= 0)
                            | (lens > L))
    assert not wops[dead].any() and not wjf[dead].any()
    if name in ("all_live", "half_random"):
        assert (wops != 0).any(dim=1).sum() > 0


def test_kernel_wrapper_checks_inputs():
    dev = _card()
    cfg = MapperConfig(max_read_len=16)
    emis_t, cands, lens, genome = (a.to(dev) for a in _inputs(
        np.random.default_rng(0), 4, 4, 16, 200, cfg))
    boff, bw = cfg.band()
    kw = dict(L=16, W=cfg.window_width(), slack=cfg.gap_slack, boff=boff,
              bw=bw, open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    with pytest.raises(TypeError):
        nw_band.nw_scores_banded(emis_t, cands.long(), lens, genome, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        nw_band.nw_scores_banded(emis_t, cands.t().contiguous().t(), lens,
                                 genome, **kw)
    with pytest.raises(ValueError, match="band width"):
        nw_band.nw_scores_banded(emis_t, cands, lens, genome,
                                 **{**kw, "bw": 12})


def _hits(rng, H, L, G, cfg):
    """Retained-hit slots: reads copied from a random genome with
    substitutions and, for a third of them, a 1-2 bp indel; every 8th slot
    SENTINEL, one of length 0, anchors below 0 and past the genome's end.
    Returns (emis_t, cands, lens, genome) and B1's scores, on the CPU."""
    genome = rng.integers(0, 4, G).astype(np.int8)
    lens = rng.integers(L // 2, L + 1, H).astype(np.int32)
    codes = np.zeros((H, L), np.int8)
    cands = rng.integers(0, G - L, H).astype(np.int32)
    cands[1], cands[2] = 2, G - L
    for h in range(H):
        lb, p = int(lens[h]), int(cands[h])
        seq = genome[p:p + lb].copy()
        k = int(rng.integers(0, 3))
        seq[rng.integers(0, lb, k)] = rng.integers(0, 4, k)
        if h % 3 == 0:
            q, d = int(rng.integers(2, lb - 4)), int(rng.integers(1, 3))
            seq = np.concatenate([seq[:q], seq[q + d:],
                                  rng.integers(0, 4, d).astype(np.int8)])
        codes[h, :lb] = seq[:lb]
    pq = pwm.pwm_rows_from_table(codes, rng.integers(15, 41, (H, L)))
    pq = np.where((np.arange(L)[None, :] < lens[:, None])[:, :, None], pq, 0)
    emis = scoring.emission_int(pq, scoring.normal_matrix(cfg))
    cands[7::8] = nw_band.SENTINEL
    cands[3] = -L
    lens[4] = 0
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (emis.transpose(0, 2, 1), cands, lens, genome)]
    kw = dict(L=L, W=cfg.window_width(), slack=cfg.gap_slack,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    cands2 = args[1][:, None].contiguous()
    if cfg.band() is None:
        scores = nw_full.nw_scores_full(args[0], cands2, *args[2:], **kw)
    else:
        boff, bw = cfg.band()
        scores = nw_band.nw_scores_banded(args[0], cands2, *args[2:],
                                          boff=boff, bw=bw, **kw)
    return args, scores[:, 0].contiguous()


@pytest.mark.parametrize("slack,harsh", [(8, False), (0, False),
                                         (13, False), (8, True)])
def test_pure_and_traceback_kernels_match_plain(slack, harsh):
    """B2 and B3 on the card == their plain versions on the CPU, exactly:
    sentinels, length 0, anchors outside the genome, indels, the narrowest
    and widest bands, and a scoring whose emissions reach below -open."""
    dev = _card()
    L = 48
    extra = (dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5)
             if harsh else {})
    cfg = MapperConfig(max_read_len=L, gap_slack=slack, **extra)
    args, scores = _hits(np.random.default_rng(slack), 160, L, 3000, cfg)
    boff, bw = cfg.band()
    kw = dict(L=L, W=cfg.window_width(), slack=slack,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    on = [a.to(dev) for a in args]
    n0, n1 = nw_pure.LAUNCHES, nw_tb.LAUNCHES
    p, j = nw_pure.nw_pure_banded(*on[:3], scores.to(dev), on[3], boff=boff,
                                  bw=bw, **kw)
    ops, jf = nw_tb.nw_traceback(*on, band=(boff, bw), **kw)
    torch.cuda.synchronize()
    assert (nw_pure.LAUNCHES, nw_tb.LAUNCHES) == (n0 + 1, n1 + 1)
    wp, wj = nw_pure.nw_pure_banded(*args[:3], scores, args[3], boff=boff,
                                    bw=bw, **kw)
    wops, wjf = nw_tb.nw_traceback(*args, band=(boff, bw), **kw)
    assert torch.equal(p.cpu(), wp) and torch.equal(j.cpu(), wj)
    assert torch.equal(ops.cpu(), wops) and torch.equal(jf.cpu(), wjf)
    assert (wops != 0).any(dim=1).sum() > 0
    if not harsh:
        assert wp.sum() > 40


@pytest.mark.parametrize("slack,L,harsh", [(16, 48, False), (14, 104, False),
                                           (30, 104, False), (71, 104, False),
                                           (16, 48, True)])
def test_full_kernel_matches_plain(slack, L, harsh):
    """B4 == its plain version, exactly: length 0 and L, anchors outside
    the genome, C > 32, window widths from 11 to 32 columns per lane
    (W = 254 at gap_slack 71, L = 104), and a harsh scoring."""
    dev = _card()
    extra = (dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5)
             if harsh else {})
    cfg = MapperConfig(max_read_len=L, gap_slack=slack, **extra)
    assert cfg.band() is None
    args = _inputs(np.random.default_rng(slack + L), 96, 40, L, 3000, cfg)
    kw = dict(L=L, W=cfg.window_width(), slack=slack,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    n0 = nw_full.LAUNCHES
    got = nw_full.nw_scores_full(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    assert nw_full.LAUNCHES == n0 + 1
    want = nw_full.nw_scores_full(*args, **kw)
    assert torch.equal(got.cpu(), want)
    assert (want[0][args[1][0] != nw_band.SENTINEL] == 0).all()


@pytest.mark.parametrize("slack,L", [(16, 48), (16, 104), (30, 104)])
def test_unbanded_traceback_kernel_matches_plain(slack, L):
    """B3 with band=None == its plain version on ops and jfin, exactly,
    from 6 to 11 columns per lane (W 88, 144 and 172)."""
    dev = _card()
    cfg = MapperConfig(max_read_len=L, gap_slack=slack)
    args, _ = _hits(np.random.default_rng(slack + L), 160, L, 3000, cfg)
    kw = dict(L=L, W=cfg.window_width(), slack=slack,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q(), band=None)
    n0 = nw_tb.LAUNCHES
    ops, jf = nw_tb.nw_traceback(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    assert nw_tb.LAUNCHES == n0 + 1
    wops, wjf = nw_tb.nw_traceback(*args, **kw)
    assert torch.equal(ops.cpu(), wops) and torch.equal(jf.cpu(), wjf)
    assert (wops != 0).any(dim=1).sum() > 0


@pytest.mark.parametrize("rowmul,order", [(1, "sorted"), (4, "sorted"),
                                          (1, "any"), (4, "any")])
def test_accum_kernel_matches_plain(rowmul, order):
    """B5 == its serial plain version bit for bit, and a repeat launch on
    the same inputs gives the same bits: pileups of up to 40 deltas on one
    block, overlapping neighbouring spans, n_real < H as a device tensor,
    and span starts in any order (the kernel's serial path)."""
    dev = _card()
    rng = np.random.default_rng(rowmul + len(order))
    H, nrows, R = 3000, 2 * rowmul, 512 * rowmul
    base = rng.integers(0, R // rowmul - 2, H)
    base[100:140] = base[99]
    base[200:240] = base[199] + np.arange(40) % 2
    if order == "sorted":
        base = np.sort(base)
    base = torch.from_numpy(base.astype(np.int32))
    deltas = torch.from_numpy(
        (rng.standard_normal((H, nrows, 128))
         * 2.0 ** rng.integers(-20, 5, (H, nrows, 128))).astype(np.float32))
    arr = torch.from_numpy(rng.standard_normal((R, 128)).astype(np.float32))
    n_real = torch.tensor(H - 11, dtype=torch.int32)
    want = accum.apply_deltas(arr.clone(), base, deltas, n_real,
                              rowmul=rowmul)
    on = [x.to(dev) for x in (base, deltas, n_real)]
    n0 = accum.LAUNCHES
    got = [accum.apply_deltas(arr.to(dev), *on, rowmul=rowmul).cpu()
           for _ in range(2)]
    assert accum.LAUNCHES == n0 + 2
    for g in got:
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))


PURE_LIVE_SETS = ("all_live", "half_random", "prefix_half", "prefix_few",
                  "none_live", "mixed_lengths", "scores_le_0")


@pytest.mark.parametrize("slack", [8, 4, 13])
@pytest.mark.parametrize("name", PURE_LIVE_SETS)
def test_pure_kernel_matches_plain_on_live_sets(name, slack):
    """B2 on the card == its plain version on pure and jfin, whichever hit
    slots are live: all, half at random, a live prefix of a half (the map
    path's shape) and of a few, none, mixed lengths with 0, 1, L and L + 1,
    and scores <= 0; 165 slots, so the last block of 16 is ragged and
    blocks hold from 0 to 16 live hits; band widths 42, 26 and 62."""
    dev = _card()
    L, H = 48, 165
    cfg = MapperConfig(max_read_len=L, gap_slack=slack)
    rng = np.random.default_rng(slack + len(name))
    args, _ = _hits(rng, H, L, 3000, cfg)
    cands, lens = args[1].numpy().copy(), args[2].numpy().copy()
    cands[cands == nw_band.SENTINEL] = 77
    lens[lens == 0] = L
    mask = {"all_live": np.ones(H, bool),
            "half_random": rng.random(H) < 0.5,
            "prefix_half": np.arange(H) < H // 2,
            "prefix_few": np.arange(H) < 9,
            "none_live": np.zeros(H, bool),
            "mixed_lengths": rng.random(H) < 0.5,
            "scores_le_0": np.ones(H, bool)}[name]
    cands = np.where(mask, cands, nw_band.SENTINEL).astype(np.int32)
    if name == "mixed_lengths":
        lens[:8] = (0, 1, L, L + 1, 1, L, 0, L + 1)
        cands[:8] = 100 + np.arange(8)
    args[1], args[2] = torch.from_numpy(cands), torch.from_numpy(lens)
    boff, bw = cfg.band()
    kw = dict(L=L, W=cfg.window_width(), slack=slack, boff=boff, bw=bw,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    scores = nw_band.nw_scores_banded(
        args[0], args[1][:, None].contiguous(), *args[2:],
        **kw)[:, 0].contiguous()
    if name == "scores_le_0":
        kill = torch.from_numpy(rng.integers(0, 6, H))
        scores = torch.where(kill == 0, 0, torch.where(
            kill == 1, -5, torch.where(kill == 2, NEG_INF, scores))).to(
                torch.int32)
    full = [*args[:3], scores, args[3]]
    n0 = nw_pure.LAUNCHES
    p, j = nw_pure.nw_pure_banded(*(a.to(dev) for a in full), **kw)
    torch.cuda.synchronize()
    assert nw_pure.LAUNCHES == n0 + 1
    wp, wj = nw_pure.nw_pure_banded(*full, **kw)
    assert torch.equal(p.cpu(), wp) and torch.equal(j.cpu(), wj)
    dead = (torch.from_numpy((cands == nw_band.SENTINEL) | (lens <= 0)
                             | (lens > L)) | (scores <= 0))
    assert not wp[dead].any() and not wj[dead].any()
    if name in ("all_live", "prefix_half"):
        assert wp.sum() > 20


def _accum_set(rng, H, rowmul, n_real, order, R):
    """Span starts with a pileup of 40 deltas on one block (longer than the
    32 starts the kernel reads at a time) and of 20 on two alternating
    neighbours inside [0, n_real); past n_real they are in no order."""
    nrows = 2 * rowmul
    base = rng.integers(0, R // rowmul - 2, H)
    if n_real > 200:
        base[100:140] = base[99]
        base[150:170] = base[149] + np.arange(20) % 2
    if order == "sorted":
        base[:n_real] = np.sort(base[:n_real])
    deltas = (rng.standard_normal((H, nrows, 128))
              * 2.0 ** rng.integers(-20, 5, (H, nrows, 128))).astype(
                  np.float32)
    arr = rng.standard_normal((R, 128)).astype(np.float32)
    return (torch.from_numpy(arr), torch.from_numpy(base.astype(np.int32)),
            torch.from_numpy(deltas),
            torch.tensor(n_real, dtype=torch.int32))


@pytest.mark.parametrize("rowmul", [1, 4])
@pytest.mark.parametrize("n_real,order", [(3000, "sorted"), (811, "sorted"),
                                          (1, "sorted"), (0, "sorted"),
                                          (811, "any")])
def test_accum_kernel_matches_plain_on_sets(n_real, order, rowmul):
    """B5 == its serial plain version bit for bit, and a repeat launch gives
    the same bits, with every slot live, a live part, one delta and none
    (the launch alone), span starts in order and in any order; the starts
    past n_real are in no order and must not be read."""
    dev = _card()
    rng = np.random.default_rng(rowmul + n_real)
    arr, base, deltas, n = _accum_set(rng, 3000, rowmul, n_real, order,
                                      512 * rowmul)
    want = accum.apply_deltas(arr.clone(), base, deltas, n, rowmul=rowmul)
    on = [x.to(dev) for x in (base, deltas, n)]
    n0 = accum.LAUNCHES
    got = [accum.apply_deltas(arr.to(dev), *on, rowmul=rowmul).cpu()
           for _ in range(2)]
    assert accum.LAUNCHES == n0 + 2
    for g in got:
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[0], arr) == (n_real == 0)


@pytest.mark.parametrize("n_real,order", [(2989, "sorted"), (0, "sorted"),
                                          (811, "any")])
def test_accum_pair_kernel_matches_two_plain_calls(n_real, order):
    """The pair entry: coverage (rowmul 1) and tallies (rowmul 4) in one
    launch == the two plain calls, bit for bit, twice."""
    dev = _card()
    rng = np.random.default_rng(n_real)
    cov, base, cov_d, n = _accum_set(rng, 3000, 1, n_real, order, 512)
    tal = torch.from_numpy(rng.standard_normal((2048, 128)).astype(
        np.float32))
    tal_d = torch.from_numpy(
        (rng.standard_normal((3000, 8, 128))
         * 2.0 ** rng.integers(-20, 5, (3000, 8, 128))).astype(np.float32))
    want = accum.apply_deltas_pair(cov.clone(), tal.clone(), base, cov_d,
                                   tal_d, n)
    on = [x.to(dev) for x in (base, cov_d, tal_d, n)]
    n0 = accum.LAUNCHES
    for _ in range(2):
        got = accum.apply_deltas_pair(cov.to(dev), tal.to(dev), *on)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32),
                               w.view(torch.int32))
    assert accum.LAUNCHES == n0 + 2


def test_device_accumulation_on_card_equals_cpu():
    """TorchMapper(accumulate="device") on the card: two runs bit-equal,
    and coverage and tallies bit-equal to the CPU's (the same f32 adds,
    maxes and divisions in the same order: elementwise IEEE operations)."""
    dev = _card()
    cfg = MapperConfig(mer_size=10, seed_jump=5, batch_size=256,
                       max_read_len=104, max_candidates=32, snp_mode=True,
                       hit_capacity=4)
    g, spots = sim.random_genome_families(200_000, seed=3, n_families=4,
                                          copies=6, unit_len=300)
    gen = builder.Genome.from_contigs([("ref_sim", g)])
    idx = builder.build_index(gen, cfg)
    starts = (np.concatenate(spots)[:, None]
              + np.arange(0, 180, 20)[None, :]).ravel()
    reads = (sim.simulate_reads(g, 450, 100, seed=4, sub_rate=0.01,
                                indel_rate=0.1, contig="ref_sim")
             + sim.simulate_reads(g, 150, 100, seed=5, sub_rate=0.01,
                                  contig="ref_sim", positions=starts))
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in reads]
    out = []
    for d in (dev, dev, "cpu"):
        m = tm.TorchMapper(gen, idx, cfg, device=d, accumulate="device")
        n0 = accum.LAUNCHES
        res = tm.map_stream(m, io_fastq.batch_reads(iter(recs), cfg),
                            collect_sam=False)
        if d == dev:
            assert accum.LAUNCHES > n0
        out.append(res)
    assert np.array_equal(out[0].coverage, out[1].coverage)
    assert np.array_equal(out[0].tallies, out[1].tallies)
    assert np.array_equal(out[0].coverage, out[2].coverage)
    assert np.array_equal(out[0].tallies, out[2].tallies)
    assert out[0].stats.n_multi == out[2].stats.n_multi > 100


@pytest.mark.parametrize("finish_impl", ["device", "host"])
def test_mapper_on_card_equals_cpu(finish_impl):
    """TorchMapper on the card and on the CPU: equal hits per read and
    equal SAM records through map_stream, quality-derived reads."""
    dev = _card()
    cfg = MapperConfig(mer_size=10, seed_jump=5, batch_size=256,
                       max_read_len=104, max_candidates=32)
    g = sim.random_genome(200_000, seed=3, repeat_frac=0.02)
    gen = builder.Genome.from_contigs([("ref_sim", g)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(g, 600, 100, seed=4, sub_rate=0.01,
                               indel_rate=0.2, contig="ref_sim")
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in reads]
    out = {}
    for d in (dev, "cpu"):
        m = tm.TorchMapper(gen, idx, cfg, device=d, finish_impl=finish_impl)
        res = tm.map_stream(m, io_fastq.batch_reads(iter(recs), cfg))
        out[str(d)] = ("".join(res.sam_lines), res.coverage, res.stats)
    (sam_c, cov_c, st_c), (sam_h, cov_h, st_h) = out["cuda"], out["cpu"]
    assert sam_c == sam_h
    assert np.array_equal(cov_c, cov_h)
    assert st_c.n_mapped == st_h.n_mapped and st_c.n_mapped > 590
    batch = next(io_fastq.batch_reads(iter(recs), cfg))
    a = tm.TorchMapper(gen, idx, cfg, device=dev,
                       finish_impl=finish_impl).map_batch(batch)
    b = tm.TorchMapper(gen, idx, cfg, device="cpu",
                       finish_impl=finish_impl).map_batch(batch)
    assert [[vars(h) for h in x] for x in a] == \
        [[vars(h) for h in x] for x in b]


def test_staging_ring_waits_for_copies_behind_slow_work():
    """Device work queued before each upload (a spin of about 20 ms) must
    not let the staging ring overwrite a buffer whose non_blocking copy has
    not run: (a) a ring of two slots, uploads whose results are dropped at
    once (so each slot is free by its references but not by its copy):
    every device tensor holds its own upload; (b) map_stream with the spin
    before each batch's submit gives the SAM records and coverage of a run
    with torch.cuda.synchronize() after every batch."""
    from gnumap_tpu_torch.pipeline.staging import StagingRing
    dev = _card()
    ring = StagingRing(dev, 2)
    outs = []
    for i in range(6):
        torch.cuda._sleep(40_000_000)
        slot = ring.acquire()
        outs.append(slot.upload("x", np.full(1 << 20, i, np.int32)))
    torch.cuda.synchronize()
    assert [int(o.min()) for o in outs] == [int(o.max()) for o in outs] \
        == list(range(6))
    assert ring.allocs == 2

    cfg = MapperConfig(mer_size=10, seed_jump=5, batch_size=64,
                       max_read_len=104, max_candidates=32)
    g = sim.random_genome(200_000, seed=3, repeat_frac=0.02)
    gen = builder.Genome.from_contigs([("ref_sim", g)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(g, 1024, 100, seed=4, sub_rate=0.01,
                               indel_rate=0.2, contig="ref_sim")
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in reads]
    out = {}
    for mode in ("slow", "sync"):
        m = tm.TorchMapper(gen, idx, cfg, device=dev)
        submit = m.submit

        def slow_submit(batch):
            torch.cuda._sleep(40_000_000)
            return submit(batch)

        def sync_submit(batch):
            r = submit(batch)
            torch.cuda.synchronize()
            return r

        m.submit = slow_submit if mode == "slow" else sync_submit
        res = tm.map_stream(m, io_fastq.batch_reads(iter(recs), cfg))
        out[mode] = ("".join(res.sam_lines), res.coverage,
                     res.stats.n_mapped)
        assert m._ring.allocs == 3 * (tm.STREAM_DEPTH + 1)
    assert out["slow"][0] == out["sync"][0]
    assert np.array_equal(out["slow"][1], out["sync"][1])
    assert out["slow"][2] == out["sync"][2] > 1000


def test_fm_hits_and_seed_kmers_b3_on_card_equal_cpu():
    """fm_hits (backward search + suffix-array gather) and seed_kmers_b3 on
    the card equal the CPU's element for element, on genome windows with
    substitutions and Ns, seeds of bench config 6 (-m 12 -j 5)."""
    dev = _card()
    cfg = MapperConfig(mer_size=12, seed_jump=5, max_read_len=104,
                       max_candidates=32, max_hits_per_seed=64)
    g = sim.random_genome(300_000, seed=5, repeat_frac=0.02)
    gen = builder.Genome.from_contigs([("g", g)])
    fmi = fm.build_fm_index(gen, cfg)
    rng = np.random.default_rng(6)
    starts = rng.integers(0, len(gen.codes) - 104, 512)
    codes2 = gen.codes[starts[:, None] + np.arange(104)].copy()
    sub = rng.random(codes2.shape) < 0.02
    codes2[sub] = rng.integers(0, 5, int(sub.sum()))
    offsets = np.arange(0, 104 - 12 + 1, 5, dtype=np.int64)
    out = {}
    for d in (dev, torch.device("cpu")):
        c = torch.from_numpy(codes2).to(d)
        off = torch.from_numpy(offsets).to(d)
        km, bad = tm.seed_kmers(c, off, 12)
        arrs = [torch.from_numpy(a).to(d) for a in (fmi.sa, fmi.bwt_words,
                                                    fmi.occ, fmi.c_table)]
        res = [km, bad, fm.fm_hits(km, bad, *arrs, off, cfg)]
        off16 = torch.from_numpy(offsets[offsets <= 104 - 16]).to(d)
        for col in ("ct", "ga"):
            res += list(tm.seed_kmers_b3(c, off16, 16, torch.from_numpy(
                builder.BS_DIGITS[col].astype(np.int32)).to(d)))
        out[d.type] = [r.cpu() for r in res]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int((out["cpu"][2] != tm.SENTINEL).sum()) > 2000


@pytest.mark.parametrize("kind", ["csr_bs", "fm", "fm_bs", "segments"])
def test_mapper_kinds_on_card_equal_cpu(kind):
    """TorchMapper on the bisulfite CSR pair, the FM index and the FM pair,
    and GlobalSegmentedMapper over two contigs: SAM records and coverage
    through map_stream equal on the card and on the CPU."""
    dev = _card()
    bs = kind.endswith("_bs")
    cfg = MapperConfig(mer_size=12, seed_jump=5, batch_size=256,
                       max_read_len=104, max_candidates=32, bisulfite=bs)
    g = sim.random_genome(200_000, seed=3, repeat_frac=0.02)
    gen = builder.Genome.from_contigs([("c1", g[:100_000]),
                                       ("c2", g[100_000:])])
    reads = (sim.simulate_reads(g[:100_000], 300, 100, seed=4,
                                sub_rate=0.01, indel_rate=0.02, contig="c1",
                                bisulfite=bs)
             + sim.simulate_reads(g[100_000:], 300, 100, seed=5,
                                  sub_rate=0.01, indel_rate=0.02,
                                  contig="c2", bisulfite=bs))
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in reads]
    idx = {"csr_bs": builder.build_bs_index, "fm": fm.build_fm_index,
           "fm_bs": fm.build_bs_fm_index,
           "segments": lambda *a: None}[kind](gen, cfg)
    out = {}
    for d in (dev, "cpu"):
        m = (segments.GlobalSegmentedMapper(gen, cfg, device=d,
                                            n_segments=2)
             if idx is None else tm.TorchMapper(gen, idx, cfg, device=d))
        res = tm.map_stream(m, io_fastq.batch_reads(iter(recs), cfg))
        out[str(d)] = ("".join(res.sam_lines), res.coverage, res.stats)
    (sam_c, cov_c, st_c), (sam_h, cov_h, st_h) = out["cuda"], out["cpu"]
    assert sam_c == sam_h
    assert np.array_equal(cov_c, cov_h)
    assert st_c.n_mapped == st_h.n_mapped and st_c.n_mapped > 580


@pytest.mark.parametrize("world,backend,R,S", [(1, "nccl", 1, 1),
                                              (2, "gloo", 2, 1),
                                              (2, "gloo", 1, 2)])
def test_dist_mapper_on_card_equals_torch_mapper(world, backend, R, S,
                                                 tmp_path):
    """DistMapper on an R x S mesh whose ranks run on the card (NCCL at
    world size 1; two ranks on one card over gloo, the tensors staged
    through host memory), with the device and the host finish: every rank's
    global hits equal TorchMapper's on the card, field for field."""
    from torch_dist_worker import run_world
    dev = _card()
    cfg = MapperConfig(mer_size=10, seed_jump=5, batch_size=256,
                       max_read_len=104, max_candidates=32)
    g = sim.random_genome(200_000, seed=3, repeat_frac=0.02)
    gen = builder.Genome.from_contigs([("ref_sim", g)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(g, 256, 100, seed=4, sub_rate=0.01,
                               indel_rate=0.2, contig="ref_sim")
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in reads]
    batch = next(io_fastq.batch_reads(iter(recs), cfg))
    want = [[(h.strand, h.pos, h.score, h.cigar, h.ref_len, h.weight)
             for h in hits]
            for hits in tm.TorchMapper(gen, idx, cfg,
                                       device=dev).map_batch(batch)]
    assert sum(1 for h in want if h) > 250
    tasks = [("dist", dict(R=R, S=S, genome=gen, index=idx, cfg=cfg,
                           batch=batch, finish_impl=f, device="cuda"))
             for f in ("device", "host")]
    for rank, runs in enumerate(run_world(world, tasks, tmp_path,
                                          backend=backend)):
        for run in runs:
            assert run["coords"] == (rank // S, rank % S)
            assert run["hits"] == want


def test_device_pwm_and_revcomp_on_card_equal_host_tables():
    """device_pwm and revcomp_batch on the card against the host tables
    (pwm_rows_from_table, pwm_revcomp): 64 reads of 18-37 bases, random
    calls with Ns and Phred qualities 0-63, code N and quality 0 past each
    read's length."""
    dev = _card()
    rng = np.random.default_rng(20260819)
    B, L = 64, 37
    codes = rng.integers(0, 5, size=(B, L)).astype(np.int8)
    quals = rng.integers(0, 64, size=(B, L)).astype(np.int16)
    lens = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    pad = np.arange(L)[None, :] >= lens[:, None]
    codes[pad] = 4
    quals[pad] = 0
    want = np.where(pad[:, :, None], 0,
                    pwm.pwm_rows_from_table(codes, quals)).astype(np.int32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    got = tm.device_pwm(t(codes), t(quals), t(lens), t(pwm.pwm_table()))
    assert np.array_equal(got.cpu().numpy(), want)
    rc, rc_pw = tm.revcomp_batch(t(codes), got, t(lens))
    rc, rc_pw = rc.cpu().numpy(), rc_pw.cpu().numpy()
    for b in range(B):
        n = int(lens[b])
        c = codes[b, :n][::-1]
        assert np.array_equal(rc[b, :n], np.where(c < 4, 3 - c, 4)), b
        assert np.array_equal(rc_pw[b, :n], pwm.pwm_revcomp(want[b, :n])), b
        assert not rc_pw[b, n:].any(), b


# ---------------------------------------------------------------------------
# Captured device programs (pipeline/graphs.py)
# ---------------------------------------------------------------------------

GRAPH_PROGRAMS = ("_device_map_tb_q", "_device_map_tb",
                  "_device_map_packed_q", "_device_map_packed",
                  "_device_map_acc_q", "_device_map_acc")


def _graph_workload(setup, n_reads=768, hit_capacity=1, seed=3):
    """A mapper's inputs for ``setup`` (an index kind, or "unbanded": CSR at
    gap_slack 16): config, genome, index and batches of 256 reads."""
    bs = setup.endswith("_bs")
    cfg = MapperConfig(mer_size=12, seed_jump=5, batch_size=256,
                       max_read_len=104, max_candidates=32, bisulfite=bs,
                       gap_slack=16 if setup == "unbanded" else 8,
                       hit_capacity=hit_capacity, sam_out=True,
                       sgr_out=True, snp_mode=True)
    g = sim.random_genome(200_000, seed=seed, repeat_frac=0.02)
    gen = builder.Genome.from_contigs([("ref_sim", g)])
    idx = {"csr": builder.build_index, "unbanded": builder.build_index,
           "csr_bs": builder.build_bs_index, "fm": fm.build_fm_index,
           "fm_bs": fm.build_bs_fm_index}[setup](gen, cfg)
    reads = sim.simulate_reads(g, n_reads, 100, seed=seed + 1,
                               sub_rate=0.01, indel_rate=0.05,
                               contig="ref_sim", bisulfite=bs)
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in reads]
    return cfg, gen, idx, list(io_fastq.batch_reads(iter(recs), cfg))


def _program_arrays(program, batch):
    lens = np.asarray(batch.lens, np.int32)
    if program.endswith("_q"):
        return dict(packed=tm.pack_reads(batch.codes, batch.quals),
                    lens=lens)
    return dict(codes=np.asarray(batch.codes, np.int8),
                pwm=np.asarray(batch.pwm_q, np.int32), lens=lens)


@pytest.mark.parametrize("setup", ["csr", "unbanded", "csr_bs", "fm",
                                   "fm_bs"])
@pytest.mark.parametrize("program", GRAPH_PROGRAMS)
def test_graph_outputs_equal_eager_program(program, setup):
    """Each program the mapper captures, on three batches of other reads
    at one shape, each twice: every output of the warm-up and of each
    replay equals the eager program's on the same inputs, bit for bit; one
    capture, five replays."""
    from torch.utils import _pytree as pytree
    from gnumap_tpu_torch.pipeline.staging import StagingRing
    dev = _card()
    cfg, gen, idx, batches = _graph_workload(setup)
    assert len(batches) == 3
    m = tm.TorchMapper(gen, idx, cfg, device=dev)
    fn = getattr(m, program)
    ring = StagingRing(dev, 2)
    for _ in range(2):
        for b in batches:
            arrays = _program_arrays(program, b)
            got = pytree.tree_leaves(m._programs(fn, ring.acquire(),
                                                 **arrays))
            want = pytree.tree_leaves(fn(*(
                torch.from_numpy(a).to(dev) for a in arrays.values())))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)
    (cap,) = m._programs.captured.values()
    assert cap.replays == 5 and m._programs.pool_bytes() > 0


@pytest.mark.parametrize("n_calls", [1, 3, 6])
def test_graph_launches_equal_eager_runs(n_calls):
    """LAUNCHES after a warm-up and n_calls - 1 replays equal n_calls times
    an eager run's, kernel by kernel."""
    from gnumap_tpu_torch.pipeline import graphs
    dev = _card()
    cfg, gen, idx, batches = _graph_workload("csr")
    m = tm.TorchMapper(gen, idx, cfg, device=dev)
    b = batches[0]
    t = {k: torch.from_numpy(a).to(dev)
         for k, a in _program_arrays("_device_map_tb_q", b).items()}
    n0 = graphs._counts()
    m._device_map_tb_q(*t.values())
    eager = [a - z for a, z in zip(graphs._counts(), n0)]
    assert eager[graphs.KERNEL_MODULES.index(nw_band)] == 1
    n0 = graphs._counts()
    for _ in range(n_calls):
        m.submit(b)
    torch.cuda.synchronize()
    assert [a - z for a, z in zip(graphs._counts(), n0)] == \
        [n_calls * e for e in eager]


def test_graph_capacity_overflow_mid_stream_remaps():
    """Batches whose hits overflow the device finish's capacity (hit
    capacity 1 on reads planted in repeat copies) are re-mapped by
    _remap_packed, through the packed program captured beside the tb
    program: the stream's SAM records and coverage equal the CPU's."""
    dev = _card()
    cfg = MapperConfig(mer_size=12, seed_jump=5, batch_size=128,
                       max_read_len=104, max_candidates=32, hit_capacity=1,
                       sam_out=True, sgr_out=True)
    g, spots = sim.random_genome_families(200_000, seed=9, n_families=8,
                                          copies=12, unit_len=300)
    gen = builder.Genome.from_contigs([("ref_sim", g)])
    idx = builder.build_index(gen, cfg)
    starts = np.concatenate(spots)[:, None] + np.arange(0, 200, 40)
    # batches 1 and 3 plain reads, 2 and 4 reads inside the copies
    parts = []
    for k in range(4):
        parts += (sim.simulate_reads(g, 128, 100, seed=20 + k,
                                     sub_rate=0.01, contig="ref_sim")
                  if k % 2 == 0 else
                  sim.simulate_reads(g, 128, 100, seed=20 + k,
                                     sub_rate=0.01, contig="ref_sim",
                                     positions=starts.ravel()))
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in parts]
    out = {}
    for d in (dev, "cpu"):
        m = tm.TorchMapper(gen, idx, cfg, device=d)
        res = tm.map_stream(m, io_fastq.batch_reads(iter(recs), cfg))
        out[str(d)] = ("".join(res.sam_lines), res.coverage,
                       res.stats.n_mapped)
        if d == dev:
            names = sorted(k[0] for k in m._programs.captured)
            assert names == ["_device_map_packed", "_device_map_tb_q"]
    assert out["cuda"][0] == out["cpu"][0]
    assert np.array_equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2] == out["cpu"][2] > 400


@pytest.mark.parametrize("path", ["device", "host", "acc"])
def test_graph_stream_with_the_ring_full_equals_eager(path):
    """map_stream at depth 3 through the graphs, with a spin of about 20 ms
    queued before each submit so that every slot of the ring is in flight:
    the hits, SAM records, coverage and tallies of the eager programs on
    the card."""
    dev = _card()
    cfg, gen, idx, batches = _graph_workload("csr", n_reads=2048,
                                             hit_capacity=4)
    kw = dict(finish_impl="host") if path == "host" else (
        dict(accumulate="device") if path == "acc" else {})
    out = {}
    for graphed in (True, False):
        m = tm.TorchMapper(gen, idx, cfg, device=dev, **kw)
        m._programs.graphed = m._acc_programs.graphed = graphed
        submit = m.submit

        def slow_submit(batch, _submit=submit):
            torch.cuda._sleep(40_000_000)
            return _submit(batch)

        m.submit = slow_submit
        res = tm.map_stream(m, iter(batches), collect_sam=True)
        out[graphed] = (res.sam_lines, res.coverage, res.tallies,
                        res.stats.n_mapped)
        assert len(m._programs.captured) == (1 if graphed else 0)
    assert out[True][0] == out[False][0]
    assert np.array_equal(out[True][1], out[False][1])
    assert np.array_equal(out[True][2], out[False][2])
    assert out[True][3] == out[False][3] > 1900


@pytest.mark.parametrize("variant", ["snp", "coverage", "sam"])
def test_accumulate_graphs_equal_eager_over_tiers_and_slots(variant):
    """The accumulate program through its captured graphs
    (pipeline/graphs.py AccPrograms, one a staging slot and tier of
    n_keep), in each of its variants: SNP mode (coverage and tallies, B5's
    pair entry), coverage only (B5's single job) and SNP mode with SAM
    written (finish_acc decodes the blob).  Twelve batches of 256 reads
    (H = 1,024 slots), every third inside the copies of 3-copy repeat
    families, so that n_keep falls in two or more tiers on all four
    staging slots, then a batch of indel reads that overflows the indel
    capacity.  Coverage, tallies and SAM records equal the eager
    program's on the card bit for bit; one capture a (slot, tier), a
    replay for every other batch; the overflow batch, after the replays,
    goes through the host path, and the stream's accumulators stay within
    f32 tolerance of host accumulation's."""
    from gnumap_tpu_torch.utils import profiling
    dev = _card()
    cfg = MapperConfig(mer_size=12, seed_jump=5, batch_size=256,
                       max_read_len=104, max_candidates=32, hit_capacity=2,
                       sgr_out=True, snp_mode=variant != "coverage",
                       sam_out=variant == "sam")
    g, spots = sim.random_genome_families(200_000, seed=9, n_families=4,
                                          copies=3, unit_len=300)
    gen = builder.Genome.from_contigs([("ref_sim", g)])
    idx = builder.build_index(gen, cfg)
    inside = (np.concatenate(spots)[:, None] + np.arange(0, 200, 20)).ravel()
    reads = []
    for k in range(12):
        reads += sim.simulate_reads(
            g, 256, 100, seed=60 + k, sub_rate=0.01, contig="ref_sim",
            positions=inside if k % 3 == 2 else None)
    reads += sim.simulate_reads(g, 256, 100, seed=72, sub_rate=0.01,
                                indel_rate=0.6, contig="ref_sim")
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in reads]
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    assert len(batches) == 13
    out = {}
    for mode in ("graph", "eager", "host"):
        m = tm.TorchMapper(gen, idx, cfg, device=dev,
                           accumulate="host" if mode == "host" else "device")
        m._acc_programs.graphed = mode == "graph"
        c0 = profiling.counters()
        t0 = profiling._now()
        res = tm.map_stream(m, iter(batches), collect_sam=cfg.sam_out)
        c1 = profiling.counters()
        out[mode] = res
        if mode == "host":
            continue
        assert c1["finish.overflow"] - c0["finish.overflow"] == 1
        tiers = profiling.values("accumulate.tier", t0, profiling._now())
        assert len(tiers) == 12 and len(set(tiers.tolist())) >= 2
        captures = c1["accumulate.captures"] - c0["accumulate.captures"]
        replays = c1["accumulate.replays"] - c0["accumulate.replays"]
        if mode == "eager":
            assert captures == replays == 0
            continue
        # a key is (name, the 9 rows, pwm2, tier, cov, tal)
        keys = list(m._acc_programs.captured)
        ptrs = {s.kept["pwm2"].data_ptr(): i
                for i, s in enumerate(m._ring.slots)}
        assert len(ptrs) == 4
        assert {(ptrs[k[10][0]], k[11]) for k in keys} == \
            {(b % 4, int(t)) for b, t in enumerate(tiers)}
        assert captures == len(keys) and replays == 12 - captures > 0
    g_, e_, h_ = out["graph"], out["eager"], out["host"]
    assert np.array_equal(g_.coverage, e_.coverage)
    assert g_.stats.n_mapped == e_.stats.n_mapped == h_.stats.n_mapped
    assert g_.stats.n_multi == h_.stats.n_multi > 300
    np.testing.assert_allclose(g_.coverage, h_.coverage, rtol=1e-5,
                               atol=1e-5)
    if cfg.snp_mode:
        assert np.array_equal(g_.tallies, e_.tallies)
        np.testing.assert_allclose(g_.tallies, h_.tallies, rtol=1e-5,
                                   atol=1e-5)
    else:
        assert g_.tallies is e_.tallies is None
    if cfg.sam_out:
        assert g_.sam_lines == e_.sam_lines == h_.sam_lines
        assert "".join(g_.sam_lines).count("\n") > 3000


def test_captured_accum_launch_replays_equal_eager():
    """B5's cooperative launch inside a CUDA graph: the pair entry,
    captured once, replayed on three delta sets copied into its inputs,
    gives the eager launches' accumulators bit for bit, with the span
    starts in order and out of order (the graph zeroes its own order flag
    before each replay's launch)."""
    dev = _card()
    rng = np.random.default_rng(11)
    sets = [_accum_set(rng, 3000, 1, n, order, 512) for n, order in
            [(2989, "sorted"), (811, "shuffled"), (2000, "sorted")]]
    tal0 = torch.from_numpy(rng.random((2048, 128)).astype(np.float32))
    cov0 = sets[0][0]
    base = torch.empty(3000, dtype=torch.int32, device=dev)
    n_real = torch.empty((), dtype=torch.int32, device=dev)
    cd = torch.empty(sets[0][2].shape, device=dev)
    td = torch.empty((3000, cd.shape[1] * 4, 128), device=dev)
    eager = [cov0.to(dev), tal0.to(dev)]
    graphed = [cov0.to(dev), tal0.to(dev)]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    n0 = accum.LAUNCHES
    for k, (_, b, d, n) in enumerate(sets):
        t = torch.from_numpy(rng.random((3000, d.shape[1] * 4, 128))
                             .astype(np.float32))
        accum.apply_deltas_pair(*eager, b.to(dev), d.to(dev), t.to(dev),
                                n.to(dev))
        base.copy_(b)
        n_real.copy_(n)
        cd.copy_(d)
        td.copy_(t)
        if k == 0:
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                accum.apply_deltas_pair(*graphed, base, cd, td, n_real)
                graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(graphed[0], eager[0])
        assert torch.equal(graphed[1], eager[1])
    assert accum.LAUNCHES == n0 + 4
