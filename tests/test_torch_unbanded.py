"""The port's unbanded scoring path (MapperConfig.band() is None, gap_slack
>= 14) held to the JAX package: align/nw_full.py (B4), align/nw_tb.py with
band=None (B3) and the mapper through them.

Every comparison is exact (the scoring is integer fixed point): the plain
versions equal the Pallas kernels in interpret mode (``nw_scores_pallas``,
``nw_traceback_pallas(band=None)``) and oracle.nw_align; the device blob is
int32-equal to TpuMapper(align_impl="pallas")'s; SAM records and SGR bytes
equal the JAX device finish's and the port's own host finish's.  The CUDA
kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import io

import numpy as np
import pytest
import torch

from gnumap_tpu.align import nw_pallas, scoring
from gnumap_tpu.config import NEG_INF, MapperConfig
from gnumap_tpu.core import pwm
from gnumap_tpu.index import builder
from gnumap_tpu.io import fastq as io_fastq, sgr as sgr_io
from gnumap_tpu.oracle import oracle
from gnumap_tpu.pipeline import mapper as jm
from gnumap_tpu.utils import sim
from gnumap_tpu_torch.align import nw_full, nw_tb
from gnumap_tpu_torch.pipeline import mapper as tm

from conftest import records_from_sim
from test_devtb import _mk_hits
from test_torch_bridge import port_iter, to_port

torch.set_num_threads(1)

SENT = nw_pallas.SENTINEL


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _kw(cfg):
    return dict(L=cfg.max_read_len, W=cfg.window_width(),
                slack=cfg.gap_slack, open_q=cfg.gap_open_q(),
                ext_q=cfg.gap_extend_q())


def _window(cfg, genome, cand):
    W = cfg.window_width()
    ws = int(cfg.window_start(int(cand)))
    window = np.full(W, 4, np.int8)
    lo, hi = max(ws, 0), min(ws + W, len(genome))
    if hi > lo:
        window[lo - ws:hi - ws] = genome[lo:hi]
    return window


def _score_inputs(rng, B2, C, L, G, cfg):
    """Read-strand rows with random calls and qualities, half of them
    copied from the genome; lengths from 1 to L (row 0 length 0, row 1
    length L); anchors below 0, past the genome's end, planted and random;
    SENTINEL padding."""
    genome = rng.integers(0, 5, G).astype(np.int8)
    lens = rng.integers(1, L + 1, B2).astype(np.int32)
    lens[0], lens[1] = 0, L
    emis = np.zeros((B2, L, 5), np.int32)
    cands = np.full((B2, C), SENT, np.int32)
    S = scoring.normal_matrix(cfg)
    for b in range(B2):
        lb = int(lens[b])
        start = int(rng.integers(0, G - L))
        codes = (genome[start:start + lb].copy() if b % 2
                 else rng.integers(0, 4, lb).astype(np.int8))
        codes[codes == 4] = 0
        if lb:
            emis[b, :lb] = scoring.emission_int(
                pwm.pwm_from_calls(codes, rng.integers(5, 41, lb)), S)
        k = int(rng.integers(1, C + 1))
        c = rng.integers(-L, G + L, k)
        c[0] = start
        if k > 1:
            c[1] = int(rng.integers(-L, 0)) if b % 3 else G - lb // 2
        cands[b, :k] = np.sort(c)
    return genome, emis, cands, lens


# (gap_slack, L): the Pallas kernels need W = L + 2 gap_slack + 8 to be a
# multiple of 8
@pytest.mark.parametrize("slack,L", [(14, 20), (16, 24), (24, 24)])
def test_plain_full_scores_equal_pallas_and_oracle(slack, L):
    """B4 plain == nw_scores_pallas(interpret=True) on every slot, and ==
    oracle.nw_align on every live pair of positive length."""
    cfg = MapperConfig(max_read_len=L, gap_slack=slack)
    assert cfg.band() is None
    W = cfg.window_width()
    rng = np.random.default_rng(100 + slack)
    genome, emis, cands, lens = _score_inputs(rng, 10, 16, L, 700, cfg)
    emis_t = np.ascontiguousarray(emis.transpose(0, 2, 1))
    want = np.asarray(nw_pallas.nw_scores_pallas(
        emis_t, cands, lens, nw_pallas.pad_genome_words(genome, W), L=L,
        W=W, slack=slack, open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q(),
        interpret=True))
    got = nw_full.nw_scores_full(_t(emis_t), _t(cands), _t(lens),
                                 _t(genome), **_kw(cfg)).numpy()
    assert np.array_equal(got, want)
    assert (got[cands == SENT] == NEG_INF).all()
    assert (got[0][cands[0] != SENT] == 0).all()       # length 0
    n_oracle = 0
    for b, c in zip(*np.nonzero((cands != SENT) & (lens[:, None] > 0))):
        lb = int(lens[b])
        assert got[b, c] == oracle.nw_align(
            emis[b, :lb], _window(cfg, genome, cands[b, c]), cfg), (b, c)
        n_oracle += 1
    assert n_oracle >= 40 and (got > 0).sum() >= 5


@pytest.mark.parametrize("slack,L,extra,seed", [
    (16, 24, {}, 5), (14, 20, dict(gap_open=2.0), 9), (24, 24, {}, 13)])
def test_plain_traceback_unbanded_equals_pallas_and_oracle(slack, L, extra,
                                                           seed):
    """B3 plain with band=None == nw_traceback_pallas(band=None,
    interpret=True) on ops and jfin (sentinel slots included), and ==
    oracle.nw_align(traceback=True) on every hit with a positive score."""
    cfg = MapperConfig(max_read_len=L, gap_slack=slack, **extra)
    W = cfg.window_width()
    rng = np.random.default_rng(seed)
    genome, emis, cands, lens = _mk_hits(rng, 96, L, 900, cfg,
                                         indel_rate=0.3)
    emis_t = np.ascontiguousarray(emis.transpose(0, 2, 1))
    want_o, want_j = nw_pallas.nw_traceback_pallas(
        emis_t, cands, lens, nw_pallas.pad_genome_words(genome, W), L=L,
        W=W, slack=slack, open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q(),
        interpret=True, band=None)
    ops, jfin = nw_tb.nw_traceback(_t(emis_t), _t(cands), _t(lens),
                                   _t(genome), band=None, **_kw(cfg))
    ops, jfin = ops.numpy(), jfin.numpy()
    assert np.array_equal(ops, np.asarray(want_o))
    assert np.array_equal(jfin, np.asarray(want_j))
    scores = nw_full.nw_scores_full(_t(emis_t), _t(cands[:, None]),
                                    _t(lens), _t(genome),
                                    **_kw(cfg))[:, 0].numpy()
    n_checked = n_gapped = 0
    for h in np.nonzero((cands != SENT) & (scores > 0))[0]:
        lb = int(lens[h])
        sc, pos_w, cigar, ref_len = oracle.nw_align(
            emis[h, :lb], _window(cfg, genome, cands[h]), cfg,
            traceback=True)
        assert sc == scores[h]
        assert nw_tb.decode_ops(ops[h], lb) == (cigar, ref_len), h
        assert jfin[h] == pos_w, h
        n_checked += 1
        n_gapped += cigar != f"{lb}M"
    assert n_checked >= 40 and n_gapped >= 5


def _unbanded_workload():
    cfg = MapperConfig(mer_size=8, seed_jump=4, batch_size=32,
                       max_read_len=40, max_candidates=16,
                       max_hits_per_seed=16, align_score_ratio=0.8,
                       gap_slack=16)
    genome = sim.random_genome(3000, seed=61, repeat_frac=0.05,
                               repeat_unit=60)
    gen = builder.Genome.from_contigs([("g", genome)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(genome, 64, 36, seed=62, sub_rate=0.02,
                               indel_rate=0.3, contig="g")
    return cfg, gen, idx, records_from_sim(reads, cfg)


def _sgr(gen, cov):
    f = io.StringIO()
    sgr_io.write_sgr(f, gen, cov)
    return f.getvalue()


def test_unbanded_device_blob_equals_pallas():
    """The port's device-finish blob at gap_slack 16 is int32-equal to
    TpuMapper(align_impl="pallas", finish_impl="device")'s, with the PWM
    shipped and rebuilt on the device."""
    import dataclasses
    cfg, gen, idx, recs = _unbanded_workload()
    ref = jm.TpuMapper(gen, idx, cfg, align_impl="pallas",
                       finish_impl="device")
    port = tm.TorchMapper(*to_port((gen, idx, cfg)), device="cpu")
    n_indel = n_keep = 0
    for b in io_fastq.batch_reads(iter(recs), cfg):
        for bb in (b, dataclasses.replace(b, pwm_arr=None)):
            want = np.asarray(ref.submit(bb).result())
            got, _ = port.submit(to_port(bb))
            assert np.array_equal(got.numpy(), want)
        n_keep += int(want[-3])
        n_indel += int(want[-1])
    assert n_keep > 60 and n_indel > 5


def test_unbanded_map_stream_equals_jax_and_host_finish():
    """map_stream at gap_slack 16: the port's device finish, the port's host
    finish and the JAX device finish give the same SAM records and SGR
    bytes."""
    cfg, gen, idx, recs = _unbanded_workload()
    targs = to_port((gen, idx, cfg))
    out = {}
    for name, m in (
            ("jax", jm.TpuMapper(gen, idx, cfg, align_impl="pallas",
                                 finish_impl="device")),
            ("device", tm.TorchMapper(*targs, device="cpu")),
            ("host", tm.TorchMapper(*targs, device="cpu",
                                    finish_impl="host"))):
        batches = io_fastq.batch_reads(iter(recs), cfg)
        res = (jm.map_stream(m, batches) if name == "jax"
               else tm.map_stream(m, port_iter(batches)))
        out[name] = ("".join(res.sam_lines), _sgr(gen, res.coverage),
                     res.stats.n_mapped)
    assert out["device"] == out["jax"] == out["host"]
    sam = out["device"][0]
    assert out["device"][2] >= 60
    assert sum(1 for x in sam.splitlines()
               if any(op in x.split("\t")[5] for op in "ID")) >= 5
