"""The port's device finish (gnumap_tpu_torch: align/nw_pure.py,
align/nw_tb.py, pipeline/mapper.py device tail) held to the JAX package.

Every comparison is exact (the scoring is integer fixed point): the plain
versions of the pure-detection (B2) and traceback (B3) kernels equal the
Pallas kernels in interpret mode, or oracle.nw_align where the Pallas
kernels are not the reference (gap_slack 0, 1, 13 and harsh scoring,
ROADMAP C1 / C5); the device blob is int32-equal to
TpuMapper(align_impl="pallas", finish_impl="device")'s; the device finish
gives the same hits as the host finish and as the JAX device finish.  The
CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnumap_tpu.align import nw_pallas, scoring
from gnumap_tpu.config import MapperConfig
from gnumap_tpu.core import pwm
from gnumap_tpu.oracle import oracle
from gnumap_tpu.pipeline import mapper as jm
from gnumap_tpu_torch.align import nw_band, nw_pure, nw_tb
from gnumap_tpu_torch.pipeline import mapper as tm

from test_devtb import _mk_hits, _pipeline_workload
from test_torch_bridge import to_port

torch.set_num_threads(1)

SENT = nw_pallas.SENTINEL
HARSH = dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tandem_hits(rng, H, L):
    """As tests/test_devtb.py::test_pure_detection_tandem_tie: reads copied
    from a period-4 tandem repeat, so a window holds several perfect
    placements and the smallest-column tie rule decides the end cell."""
    cfg = MapperConfig(max_read_len=L)
    unit = np.array([0, 1, 2, 3], np.int8)
    genome = np.concatenate([rng.integers(0, 4, 300).astype(np.int8),
                             np.tile(unit, 100),
                             rng.integers(0, 4, 300).astype(np.int8)])
    S = scoring.normal_matrix(cfg)
    emis = np.zeros((H, L, 5), np.int32)
    cands = np.full(H, SENT, np.int32)
    lens = np.full(H, L, np.int32)
    for h in range(H):
        pos = 300 + 4 * int(rng.integers(3, 90))
        seq = genome[pos:pos + L].copy()
        if h % 3 == 0:
            seq[int(rng.integers(0, L))] = int(rng.integers(0, 4))
        pq = pwm.pwm_from_calls(seq, rng.integers(20, 41, L))
        emis[h] = scoring.emission_int(pq, S)
        cands[h] = pos
    return genome, emis, cands, lens


def _kw(cfg):
    return dict(L=cfg.max_read_len, W=cfg.window_width(),
                slack=cfg.gap_slack, open_q=cfg.gap_open_q(),
                ext_q=cfg.gap_extend_q())


def _port_scores(cfg, genome, emis, cands, lens):
    boff, bw = cfg.band()
    return nw_band.nw_scores_banded(
        _t(emis.transpose(0, 2, 1)), _t(cands[:, None]), _t(lens),
        _t(genome), boff=boff, bw=bw, **_kw(cfg))[:, 0].numpy()


def _port_pure(cfg, genome, emis, cands, lens, scores):
    boff, bw = cfg.band()
    p, j = nw_pure.nw_pure_banded(
        _t(emis.transpose(0, 2, 1)), _t(cands), _t(lens), _t(scores),
        _t(genome), boff=boff, bw=bw, **_kw(cfg))
    return p.numpy(), j.numpy()


def _port_tb(cfg, genome, emis, cands, lens):
    o, j = nw_tb.nw_traceback(_t(emis.transpose(0, 2, 1)), _t(cands),
                              _t(lens), _t(genome), band=cfg.band(),
                              **_kw(cfg))
    return o.numpy(), j.numpy()


def _window(cfg, genome, cand):
    W = cfg.window_width()
    ws = int(cfg.window_start(int(cand)))
    window = np.full(W, 4, np.int8)
    lo, hi = max(ws, 0), min(ws + W, len(genome))
    if hi > lo:
        window[lo - ws:hi - ws] = genome[lo:hi]
    return window


@pytest.mark.parametrize("case", ["default", "gap_open_2", "tandem"])
def test_plain_pure_equals_pallas(case):
    """(a) plain B2 == nw_pallas.nw_pure_banded on (pure, jfin) at
    gap_slack 8, fed the Pallas scores (equal to the port's here)."""
    rng = np.random.default_rng(31)
    if case == "tandem":
        cfg = MapperConfig(max_read_len=24)
        genome, emis, cands, lens = _tandem_hits(rng, 32, 24)
    else:
        cfg = MapperConfig(max_read_len=24, **(
            dict(gap_open=2.0) if case == "gap_open_2" else {}))
        genome, emis, cands, lens = _mk_hits(rng, 96, 24, 900, cfg,
                                             indel_rate=0.3)
    L, W = cfg.max_read_len, cfg.window_width()
    boff, bw = cfg.band()
    gw = nw_pallas.pad_genome_words(genome, W)
    emis_t = np.ascontiguousarray(emis.transpose(0, 2, 1))
    jkw = dict(L=L, W=W, slack=cfg.gap_slack, boff=boff, bw=bw,
               open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q(),
               interpret=True)
    scores = np.asarray(nw_pallas.nw_scores_banded(
        emis_t, cands[:, None], lens, gw, **jkw))[:, 0]
    assert np.array_equal(scores, _port_scores(cfg, genome, emis, cands,
                                               lens))
    want_p, want_j = nw_pallas.nw_pure_banded(emis_t, cands, lens, scores,
                                              gw, **jkw)
    got_p, got_j = _port_pure(cfg, genome, emis, cands, lens, scores)
    assert np.array_equal(got_p, np.asarray(want_p))
    assert np.array_equal(got_j, np.asarray(want_j))
    assert got_p.sum() >= (8 if case == "tandem" else 20)


@pytest.mark.parametrize("cfg,H,L,G,seed", [
    (MapperConfig(max_read_len=16, gap_slack=4), 64, 16, 300, 5),
    (MapperConfig(max_read_len=24, gap_open=2.0), 128, 24, 900, 9)])
def test_plain_traceback_equals_pallas(cfg, H, L, G, seed):
    """(b) plain B3 == nw_pallas.nw_traceback_pallas(band=cfg.band()) on
    ops and jfin, sentinel slots included."""
    rng = np.random.default_rng(seed)
    genome, emis, cands, lens = _mk_hits(rng, H, L, G, cfg)
    W = cfg.window_width()
    want_o, want_j = nw_pallas.nw_traceback_pallas(
        np.ascontiguousarray(emis.transpose(0, 2, 1)), cands, lens,
        nw_pallas.pad_genome_words(genome, W), L=L, W=W,
        slack=cfg.gap_slack, open_q=cfg.gap_open_q(),
        ext_q=cfg.gap_extend_q(), interpret=True, band=cfg.band())
    got_o, got_j = _port_tb(cfg, genome, emis, cands, lens)
    assert np.array_equal(got_o, np.asarray(want_o))
    assert np.array_equal(got_j, np.asarray(want_j))
    assert (got_o != 0).any(axis=1).sum() >= 1


@pytest.mark.parametrize("slack,extra", [(0, {}), (1, {}), (13, {}),
                                         (8, HARSH)])
def test_plain_pure_and_traceback_equal_oracle(slack, extra):
    """(c) where the Pallas kernels are not the reference (ROADMAP C1, C5;
    harsh scoring reaches below -open) both plain versions are held to
    oracle.nw_align(traceback=True) on every hit with a positive score."""
    cfg = MapperConfig(max_read_len=24, gap_slack=slack, **extra)
    rng = np.random.default_rng(40 + slack)
    genome, emis, cands, lens = _mk_hits(rng, 64, 24, 600, cfg,
                                         indel_rate=0.3)
    scores = _port_scores(cfg, genome, emis, cands, lens)
    pure, jp = _port_pure(cfg, genome, emis, cands, lens, scores)
    ops, jt = _port_tb(cfg, genome, emis, cands, lens)
    n_checked = n_pure = 0
    for h in range(len(cands)):
        if cands[h] == SENT:
            assert not pure[h] and not ops[h].any() and jt[h] == 0
            continue
        lb = int(lens[h])
        sc, pos_w, cigar, ref_len = oracle.nw_align(
            emis[h, :lb], _window(cfg, genome, cands[h]), cfg,
            traceback=True)
        assert sc == scores[h]
        if sc <= 0:
            assert not pure[h]
            continue
        assert nw_tb.decode_ops(ops[h], lb) == (cigar, ref_len), h
        assert jt[h] == pos_w, h
        if pure[h]:
            assert (cigar, jp[h]) == (f"{lb}M", pos_w), h
            n_pure += 1
        n_checked += 1
    assert n_checked >= 16
    if not extra:
        assert n_pure >= 8


def test_device_threshold_exact():
    """(d) the int64 device_threshold == MapperConfig.threshold_for, on
    the cases of tests/test_devtb.py::test_device_threshold_exact."""
    rng = np.random.default_rng(2)
    ms = np.concatenate([
        rng.integers(0, 1 << 28, 500).astype(np.int32),
        np.array([0, 1, 2, (1 << 28) - 1, 1 << 20], np.int32)])
    for ratio in [0.9, 1.0, 0.5, 0.123456789, 0.999999, 1e-9, 0.93]:
        cfg = MapperConfig(align_score_ratio=ratio)
        got = tm.device_threshold(_t(ms), cfg.ratio_q()).numpy()
        want = np.array([cfg.threshold_for(int(m)) for m in ms], np.int64)
        assert (got.astype(np.int64) == want).all(), ratio


# The workloads of tests/test_devtb.py:284, :296 and :315.
WORKLOADS = {
    "no_indels": dict(seed=21, indel=0.0),
    "indels": dict(seed=22, indel=0.05),
    "indel_heavy": dict(seed=55, n_reads=60, indel=1.0, ratio=0.6),
    "overflow": dict(seed=33, n_reads=24, glen=2000, repeats=True),
}


@pytest.fixture(scope="module")
def workloads():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _pipeline_workload(**WORKLOADS[name])
        return cache[name]
    return get


@pytest.mark.parametrize("split", ["1", "0"])
def test_device_blob_equals_pallas(split, workloads, monkeypatch):
    """(e) _device_map_tb and _device_map_tb_q blobs are int32-equal to
    TpuMapper(pallas, finish_impl='device')'s, with GNUMAP_TB_SPLIT on and
    off (the JAX program reads it when it is traced, so the mapper is made
    after setting it)."""
    monkeypatch.setenv("GNUMAP_TB_SPLIT", split)
    cfg, gen, idx, batches = workloads("indel_heavy")
    ref = jm.TpuMapper(gen, idx, cfg, align_impl="pallas",
                       finish_impl="device")
    targs = to_port((gen, idx, cfg))
    port = tm.TorchMapper(*targs, device="cpu")
    n_indel = 0
    for b in batches:
        for bb in (b, dataclasses.replace(b, pwm_arr=None)):
            want = np.asarray(ref.submit(bb).result())
            got, _ = port.submit(to_port(bb))
            assert len(got) == tm.tb_blob_len(targs[2], b.codes.shape[0])
            assert np.array_equal(got.numpy(), want)
        n_indel += int(want[-1])
    assert n_indel > 0


def _hits(out):
    return [[(h.strand, h.pos, h.score, h.cigar, h.ref_len, h.weight,
              h.primary) for h in hits] for hits in out]


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_device_finish_equals_host_finish_and_jax(name, workloads):
    """(f) port device finish == port host finish == JAX device finish,
    weights included; the overflow workload takes the host-path fallback
    (n_keep > H) and must stay exact."""
    cfg, gen, idx, batches = workloads(name)
    targs = to_port((gen, idx, cfg))
    dev = tm.TorchMapper(*targs, device="cpu")
    host = tm.TorchMapper(*targs, device="cpu", finish_impl="host")
    ref = jm.TpuMapper(gen, idx, cfg, align_impl="pallas",
                       finish_impl="device")
    n_overflow = n_indel_cigars = 0
    for b in batches:
        tb = to_port(b)
        got = dev.map_batch(tb)
        assert _hits(got) == _hits(host.map_batch(tb))
        assert _hits(got) == _hits(ref.map_batch(b))
        blob = dev.submit(tb)[0].numpy()
        n_overflow += tm.decode_tb_blob(targs[2], b.codes.shape[0], b.n,
                                        b.lens, blob) is None
        n_indel_cigars += sum(1 for hl in got for h in hl
                              if "I" in h.cigar or "D" in h.cigar)
    if name == "overflow":
        assert n_overflow > 0
    if name == "indel_heavy":
        assert n_indel_cigars > 20


def test_device_hit_rows_stages_equal_the_reference_probes(monkeypatch):
    """device_hit_rows split into device_retain, device_pure (B2) and
    device_traceback (B3): each stage's rows equal the reference's
    device_hit_rows at the GNUMAP_TB_MODE probe that stops there ("retain",
    "pure", "full"), hit for hit, and the blob built from the stages equals
    the mapper's and the reference's device blob."""
    import jax.numpy as jnp
    cfg, gen, idx, batches = _pipeline_workload(seed=55, n_reads=60,
                                                indel=1.0, ratio=0.6)
    tcfg, tgen, tidx = to_port((cfg, gen, idx))
    m = tm.TorchMapper(tgen, tidx, tcfg, device="cpu")
    ref = jm.TpuMapper(gen, idx, cfg, align_impl="pallas",
                       finish_impl="device")
    g = m.state["g_codes"]
    g_words = jnp.asarray(nw_pallas.pad_genome_words(
        np.asarray(gen.codes), cfg.window_width()))
    n_indel = n_pure = 0
    for b in batches:
        tb = to_port(b)
        out = m._device_map(torch.from_numpy(tb.codes),
                            torch.from_numpy(tb.pwm_arr),
                            torch.from_numpy(tb.lens))
        rows = tm.device_retain(tcfg, *out)
        pj = tm.device_pure(tcfg, rows, g)
        full = tm.device_traceback(tcfg, rows, pj, out[4], g)
        cands, valid, scores, max_sc, emis2_t, lens2 = (
            jnp.asarray(x.numpy()) for x in out)
        jargs = (cfg, cands, valid, scores, max_sc,
                 jnp.transpose(emis2_t, (0, 2, 1)), lens2, g_words, True)
        for mode in ("retain", "pure", "full"):
            monkeypatch.setenv("GNUMAP_TB_MODE", mode)
            want = {k: np.asarray(v) for k, v in
                    jm.device_hit_rows(*jargs).items()}
            if mode == "retain":
                for k in ("valid_h", "hit_flat", "row_h", "cand_h",
                          "score_h", "len_h", "n_keep", "n_valid"):
                    assert np.array_equal(rows[k].numpy(), want[k]), k
            elif mode == "pure":
                pure, jf = pj
                assert np.array_equal(
                    torch.where(pure, jf, 0).numpy(), want["jfin"])
                n_pure += int(pure.sum())
            else:
                assert np.array_equal(full["ops"].numpy(), want["ops"])
                assert np.array_equal(full["jfin"].numpy(), want["jfin"])
        blob = tm.device_tb_tail(tcfg, *out, g, rows=full).numpy()
        monkeypatch.setenv("GNUMAP_TB_MODE", "full")
        assert np.array_equal(blob, m.submit(tb)[0].numpy())
        assert np.array_equal(blob, np.asarray(ref.submit(b).result()))
        n_indel += int(blob[-1])
    assert n_indel > 0 and n_pure > 0


def test_decode_ops_equals_reference():
    """(g) decode_ops == nw_pallas.decode_ops on random ops rows."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        n = int(rng.integers(1, 40))
        row = np.zeros(48, np.int16)
        row[:n] = (rng.integers(0, 3, n) * (rng.random(n) < 0.2)) << 1
        row[:n] |= (rng.random(n) < 0.15).astype(np.int16)
        assert nw_tb.decode_ops(row, n) == nw_pallas.decode_ops(row, n)
    assert nw_tb.decode_ops(np.array([0, 0, 4, 0, 0, 1, 0], np.int16),
                            7) == ("3M2D2M1I1M", 8)


def test_unported_and_invalid_options_raise(phix_genome):
    # band=None (unbanded, gap_slack >= 14) is ported: the traceback of a
    # one-base read equals the oracle's
    cfg = MapperConfig(max_read_len=16, gap_slack=16)
    rng = np.random.default_rng(8)
    genome, emis, cands, lens = _mk_hits(rng, 8, 16, 200, cfg)
    ops, jf = _port_tb(cfg, genome, emis, cands, lens)
    assert ops.shape == (8, 16)
    for h in range(7):
        sc, pos_w, cigar, ref_len = oracle.nw_align(
            emis[h, :lens[h]], _window(cfg, genome, cands[h]), cfg,
            traceback=True)
        assert (nw_tb.decode_ops(ops[h], int(lens[h])), jf[h]) == \
            ((cigar, ref_len), pos_w)
    from gnumap_tpu.index import builder
    cfg = MapperConfig(mer_size=8, max_read_len=40)
    gen = builder.Genome.from_contigs([("phiX_sim", phix_genome)])
    with pytest.raises(ValueError, match="finish_impl"):
        tm.TorchMapper(*to_port((gen, builder.build_index(gen, cfg), cfg)),
                       device="cpu", finish_impl="devices")


def test_wrappers_reject_other_devices():
    """A tensor on neither the CPU nor a card is refused, not computed."""
    cfg = MapperConfig(max_read_len=16)
    boff, bw = cfg.band()
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    args = (torch.empty((2, 5, 16), **i32), torch.empty(2, **i32),
            torch.empty(2, **i32))
    g = torch.empty(100, dtype=torch.int8, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        nw_pure.nw_pure_banded(*args, torch.empty(2, **i32), g, boff=boff,
                               bw=bw, **_kw(cfg))
    with pytest.raises(ValueError, match="unsupported device"):
        nw_tb.nw_traceback(*args, g, band=cfg.band(), **_kw(cfg))
