"""Tests of the port that need a CUDA card (marker ``cuda``; each skips
without one).  This file imports no jax, so it runs on a machine that has
only torch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Each kernel (B1 nw_band, B2 nw_pure, B3 nw_tb) is held to its plain torch
version on the same inputs (exact equality), and the mapper on the card to
the mapper on the CPU, with the device finish and with the host finish
(equal hits, equal SAM records).
"""

import numpy as np
import pytest
import torch

from gnumap_tpu.align import scoring
from gnumap_tpu.config import NEG_INF, MapperConfig
from gnumap_tpu.core import packing, pwm
from gnumap_tpu.index import builder
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.utils import sim
from gnumap_tpu_torch.align import nw_band, nw_pure, nw_tb
from gnumap_tpu_torch.pipeline import mapper as tm

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


@pytest.mark.parametrize("slack,C,harsh", [(8, 32, False), (8, 160, False),
                                           (0, 8, False), (13, 8, False),
                                           (8, 32, True)])
def test_kernel_matches_plain(slack, C, harsh):
    """Including C > 128 (a second block per row), length 0 and L, anchors
    below 0 and past the genome's end, the narrowest and widest bands, and
    a scoring whose emissions reach below -open."""
    dev = _card()
    L = 48
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
    boff, bw = cfg.band()
    scores = nw_band.nw_scores_banded(
        args[0], args[1][:, None].contiguous(), args[2], args[3], L=L,
        W=cfg.window_width(), slack=cfg.gap_slack, boff=boff, bw=bw,
        open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())[:, 0]
    return args, scores.contiguous()


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
