"""The port's NW scoring (gnumap_tpu_torch.align) held to the JAX package.

Every comparison is exact (int32 equality): scoring is integer fixed point.
The plain version of the banded kernel (nw_band on CPU tensors) equals the
Pallas kernel in interpret mode, the jnp reference and the oracle; the
torch nw_ref equals the jnp nw_ref, banded and unbanded.  The CUDA kernel
itself runs only on a card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from gnumap_tpu.align import nw_pallas, nw_ref as jnw_ref, scoring
from gnumap_tpu.config import NEG_INF, MapperConfig
from gnumap_tpu.core import pwm
from gnumap_tpu.oracle import oracle
from gnumap_tpu_torch import _build
from gnumap_tpu_torch.align import nw_band, nw_ref

from test_torch_cuda import LIVE_SETS, live_set

torch.set_num_threads(1)

SENT = nw_pallas.SENTINEL


def _setup(rng, B2, C, L, G, cfg):
    """As tests/test_pallas.py::_setup: real-PWM emissions, random genome
    with N codes, sorted SENTINEL-padded candidates (some below 0)."""
    genome = rng.integers(0, 5, G).astype(np.int8)
    emis = np.zeros((B2, L, 5), np.int32)
    lens = rng.integers(L // 2, L + 1, B2).astype(np.int32)
    for b in range(B2):
        lb = lens[b]
        codes = rng.integers(0, 4, lb).astype(np.int8)
        pq = pwm.pwm_from_calls(codes, rng.integers(5, 41, lb))
        emis[b, :lb] = scoring.emission_int(pq, scoring.normal_matrix(cfg))
    cands = np.full((B2, C), SENT, np.int32)
    for b in range(B2):
        k = rng.integers(0, C + 1)
        cands[b, :k] = np.sort(rng.integers(-L // 2, G - 1, k))
    return genome, emis, cands, lens, cfg.window_width()


def _windows(genome, cands, cfg):
    W = cfg.window_width()
    B2, C = cands.shape
    wins = np.zeros((B2, C, W), np.int32)
    for b in range(B2):
        for c in range(C):
            cd = 0 if cands[b, c] == SENT else int(cands[b, c])
            ws = int(cfg.window_start(cd))
            window = np.full(W, 4, np.int8)
            lo, hi = max(ws, 0), min(ws + W, len(genome))
            if hi > lo:
                window[lo - ws:hi - ws] = genome[lo:hi]
            wins[b, c] = window
    return wins


def _plain_banded(emis, cands, lens, genome, cfg):
    boff, bw = cfg.band()
    return nw_band.nw_scores_banded(
        torch.from_numpy(np.ascontiguousarray(emis.transpose(0, 2, 1))),
        torch.from_numpy(cands), torch.from_numpy(lens),
        torch.from_numpy(genome), L=emis.shape[1], W=cfg.window_width(),
        slack=cfg.gap_slack, boff=boff, bw=bw, open_q=cfg.gap_open_q(),
        ext_q=cfg.gap_extend_q()).numpy()


@pytest.mark.parametrize("L,C,B2,G,seed", [(16, 8, 4, 200, 3),
                                           (48, 8, 6, 900, 9),
                                           (104, 4, 6, 2500, 11)])
def test_plain_banded_matches_pallas_jnp_oracle(L, C, B2, G, seed):
    cfg = MapperConfig(max_read_len=L)
    rng = np.random.default_rng(seed)
    genome, emis, cands, lens, W = _setup(rng, B2, C, L, G, cfg)
    boff, bw = cfg.band()
    got = _plain_banded(emis, cands, lens, genome, cfg)
    pallas = np.asarray(nw_pallas.nw_scores_banded(
        np.ascontiguousarray(emis.transpose(0, 2, 1)), cands, lens,
        nw_pallas.pad_genome_words(genome, W), L=L, W=W,
        slack=cfg.gap_slack, boff=boff, bw=bw, open_q=cfg.gap_open_q(),
        ext_q=cfg.gap_extend_q(), interpret=True, rpt=8))
    assert np.array_equal(got, pallas)
    valid = cands != SENT
    assert (got[~valid] == NEG_INF).all()
    ref = np.asarray(jnw_ref.nw_scores_multi(
        emis, _windows(genome, cands, cfg), lens, cfg.gap_open_q(),
        cfg.gap_extend_q(), band=cfg.band()))
    assert np.array_equal(got[valid], ref[valid])
    wins = _windows(genome, cands, cfg)
    for b, c in zip(*np.nonzero(valid)):
        expect = oracle.nw_align(emis[b, :lens[b]], wins[b, c].astype(np.int8),
                                 cfg)
        assert got[b, c] == expect, (b, c)


@pytest.mark.parametrize("name", LIVE_SETS)
def test_plain_banded_live_sets_match_pallas_and_oracle(name):
    """Scattered SENTINELs and mixed lengths (0, 1, L): the plain version
    equals the Pallas kernel in interpret mode on every slot and the oracle
    on every live pair, and gives NEG_INF at every dead slot."""
    L, C, B2, G = 24, 8, 8, 600
    cfg = MapperConfig(max_read_len=L)
    rng = np.random.default_rng(41)
    genome, emis, _, _, W = _setup(rng, B2, C, L, G, cfg)
    cands, lens = live_set(name, rng, B2, C, L, G)
    emis = np.where((np.arange(L)[None, :] < lens[:, None])[:, :, None],
                    emis, 0).astype(np.int32)
    boff, bw = cfg.band()
    got = _plain_banded(emis, cands, lens, genome, cfg)
    pallas = np.asarray(nw_pallas.nw_scores_banded(
        np.ascontiguousarray(emis.transpose(0, 2, 1)), cands, lens,
        nw_pallas.pad_genome_words(genome, W), L=L, W=W,
        slack=cfg.gap_slack, boff=boff, bw=bw, open_q=cfg.gap_open_q(),
        ext_q=cfg.gap_extend_q(), interpret=True, rpt=8))
    assert np.array_equal(got, pallas)
    live = (cands != SENT) & (lens > 0)[:, None]
    assert (got[~live] == NEG_INF).all()
    assert live.sum() == {"all_live": B2 * C, "one_per_row": B2,
                          "none_live": 0}.get(name, live.sum())
    wins = _windows(genome, cands, cfg)
    for b, c in zip(*np.nonzero(live)):
        expect = oracle.nw_align(emis[b, :lens[b]], wins[b, c].astype(np.int8),
                                 cfg)
        assert got[b, c] == expect, (b, c)


@pytest.mark.parametrize("slack", [0, 1, 13])
def test_plain_banded_narrow_and_wide_bands_match_oracle(slack):
    """Bands other than the default are held to the oracle, not to the
    Pallas kernel: its packed window plane overflows at gap_slack <= 1
    (ROADMAP C1), and in interpret mode it disagrees with the oracle at
    several other gap_slack values too (ROADMAP C5)."""
    cfg = MapperConfig(max_read_len=24, gap_slack=slack)
    rng = np.random.default_rng(20 + slack)
    genome, emis, cands, lens, W = _setup(rng, 6, 6, 24, 400, cfg)
    got = _plain_banded(emis, cands, lens, genome, cfg)
    wins = _windows(genome, cands, cfg)
    for b, c in zip(*np.nonzero(cands != SENT)):
        expect = oracle.nw_align(emis[b, :lens[b]], wins[b, c].astype(np.int8),
                                 cfg)
        assert got[b, c] == expect, (b, c)


def test_plain_banded_harsh_scoring_matches_oracle():
    """Emissions below -open (mismatch -8, open 1, extend 0.5): the
    plain version follows the oracle, whose row 0 is not banded."""
    cfg = MapperConfig(max_read_len=16, gap_slack=2, mismatch_score=-8.0,
                       gap_open=1.0, gap_extend=0.5)
    rng = np.random.default_rng(31)
    genome, emis, cands, lens, W = _setup(rng, 8, 6, 16, 300, cfg)
    got = _plain_banded(emis, cands, lens, genome, cfg)
    wins = _windows(genome, cands, cfg)
    for b, c in zip(*np.nonzero(cands != SENT)):
        expect = oracle.nw_align(emis[b, :lens[b]], wins[b, c].astype(np.int8),
                                 cfg)
        assert got[b, c] == expect, (b, c)


@pytest.mark.parametrize("band", [True, False])
def test_nw_ref_multi_matches_jax(band):
    """Banded (gap_slack 8) and unbanded (gap_slack 16) nw_scores_multi,
    plus the single-pair nw_scores, equal the jnp reference."""
    cfg = MapperConfig(max_read_len=24, gap_slack=8 if band else 16)
    assert (cfg.band() is not None) == band
    rng = np.random.default_rng(5)
    genome, emis, cands, lens, W = _setup(rng, 5, 4, 24, 500, cfg)
    lens[0] = 0
    wins = _windows(genome, cands, cfg)
    kw = dict(band=cfg.band())
    got = nw_ref.nw_scores_multi(torch.from_numpy(emis),
                                 torch.from_numpy(wins),
                                 torch.from_numpy(lens), cfg.gap_open_q(),
                                 cfg.gap_extend_q(), **kw).numpy()
    ref = np.asarray(jnw_ref.nw_scores_multi(
        emis, wins, lens, cfg.gap_open_q(), cfg.gap_extend_q(), **kw))
    assert got.dtype == np.int32
    assert np.array_equal(got, ref)
    one = nw_ref.nw_scores(torch.from_numpy(emis), torch.from_numpy(wins[:, 0]),
                           torch.from_numpy(lens), open_q=cfg.gap_open_q(),
                           ext_q=cfg.gap_extend_q(), **kw).numpy()
    ref1 = np.asarray(jnw_ref.nw_scores(
        emis, wins[:, 0], lens, open_q=cfg.gap_open_q(),
        ext_q=cfg.gap_extend_q(), **kw))
    assert np.array_equal(one, ref1)
    mx = nw_ref.max_read_scores(torch.from_numpy(emis)).numpy()
    assert mx.dtype == np.int32
    assert np.array_equal(mx, np.asarray(jnw_ref.max_read_scores(emis)))


def test_length_zero_rule():
    """nw_ref (torch and jnp) scores a length-0 read 0; the banded kernel
    and its plain version give NEG_INF, as the Pallas kernel does.  Neither
    is ever retained (retention needs a score > 0)."""
    cfg = MapperConfig(max_read_len=16)
    rng = np.random.default_rng(7)
    genome, emis, cands, lens, W = _setup(rng, 3, 4, 16, 200, cfg)
    cands[:, 0] = 40
    lens[1] = 0
    emis[1] = 0
    wins = _windows(genome, cands, cfg)
    t = nw_ref.nw_scores_multi(torch.from_numpy(emis), torch.from_numpy(wins),
                               torch.from_numpy(lens), cfg.gap_open_q(),
                               cfg.gap_extend_q(), band=cfg.band()).numpy()
    j = np.asarray(jnw_ref.nw_scores_multi(
        emis, wins, lens, cfg.gap_open_q(), cfg.gap_extend_q(),
        band=cfg.band()))
    assert (t[1] == 0).all() and (j[1] == 0).all()
    got = _plain_banded(emis, cands, lens, genome, cfg)
    assert (got[1] == NEG_INF).all()
    boff, bw = cfg.band()
    pallas = np.asarray(nw_pallas.nw_scores_banded(
        np.ascontiguousarray(emis.transpose(0, 2, 1)), cands, lens,
        nw_pallas.pad_genome_words(genome, W), L=16, W=W,
        slack=cfg.gap_slack, boff=boff, bw=bw, open_q=cfg.gap_open_q(),
        ext_q=cfg.gap_extend_q(), interpret=True, rpt=8))
    assert np.array_equal(got, pallas)


def test_gather_windows_matches_window_rule():
    cfg = MapperConfig(max_read_len=16)
    rng = np.random.default_rng(2)
    genome = rng.integers(0, 5, 300).astype(np.int8)
    cands = np.array([[-40, -3, 0, 7], [150, 280, 299, 330]], np.int32)
    got = nw_band.gather_windows(torch.from_numpy(cands),
                                 torch.from_numpy(genome),
                                 cfg.window_width(), cfg.gap_slack).numpy()
    assert np.array_equal(got, _windows(genome, cands, cfg))


def test_wrapper_rejects_other_devices():
    """A tensor on neither the CPU nor a card is refused, not computed."""
    cfg = MapperConfig(max_read_len=16)
    boff, bw = cfg.band()
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nw_band.nw_scores_banded(
            torch.empty((2, 5, 16), dtype=torch.int32, **meta),
            torch.empty((2, 4), dtype=torch.int32, **meta),
            torch.empty((2,), dtype=torch.int32, **meta),
            torch.empty((100,), dtype=torch.int8, **meta), L=16,
            W=cfg.window_width(), slack=cfg.gap_slack, boff=boff, bw=bw,
            open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["nw_band"])
    assert "nw_band" in _build.sources()

