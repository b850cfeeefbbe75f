"""The plain reference: its batched torch form equals the frozen oracle read
by read, the frozen oracle equals the port's CPU path, and the comparison
that decides ``correct`` notices a corrupted weight and the control."""

import numpy as np
import pytest

from mapbench import check
from mapbench.genome import make_genome
from mapbench.reference import batched, oracle
from mapbench.reference.consts import RefConfig
from mapbench.tests import tiny
from mapbench.traffic import make_pool

CFG = RefConfig(mer_size=10, seed_jump=5, max_hits_per_seed=24,
                max_candidates=32, max_read_len=104)


def _case(seed, n=40, **mix):
    s = tiny.spec("snp-repeat25", genome_len=30000, **mix)
    g = make_genome(s.config, seed)
    return g, make_pool(g, dict(s.mix, **mix), seed, n)


def _rows(hits):
    return [[(h.strand, h.pos, h.score, h.weight, h.cigar, h.ref_len)
             for h in hh] for hh in hits]


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_batched_equals_frozen_oracle(seed):
    g, p = _case(seed, indel_rate=0.3, sub_rate=0.03)
    og = oracle.OracleGenome.from_codes([(g.contig, g.codes)])
    idx = oracle.build_oracle_index(og, CFG)
    want = [oracle.map_read(p.codes[r], oracle.pwm_from_calls(
        p.codes[r], p.quals[r]), og, idx, CFG) for r in range(p.n)]
    rg = batched.RefGenome(og.codes, og.names, og.starts, "cpu")
    got = batched.map_reads(p.codes, p.quals, rg, CFG)
    assert _rows(got) == _rows(want)
    assert any(len(h) > 1 for h in want)
    assert any("I" in h.cigar or "D" in h.cigar for hh in want for h in hh)
    # the pileup terms equal oracle.accumulate at the checked positions
    G = len(og.codes)
    cov, tal = np.zeros(G), np.zeros((G, 4))
    for r in range(p.n):
        pw = oracle.pwm_from_calls(p.codes[r], p.quals[r])
        oracle.accumulate(want[r], pw, cov, tal)
    pos = np.arange(0, G, 7)
    lookup = np.full(G, -1, np.int64)
    lookup[pos] = np.arange(len(pos))
    c_t, t_t = batched.contributions(
        got, oracle.pwm_from_calls(p.codes, p.quals), lookup)
    ones = np.ones(p.n, np.int64)
    assert np.allclose(batched.sum_f64(c_t, ones, len(pos), None), cov[pos],
                       rtol=1e-12, atol=1e-12)
    assert np.allclose(batched.sum_f64(t_t, ones, len(pos), 4), tal[pos],
                       rtol=1e-12, atol=1e-12)


def test_frozen_oracle_equals_the_port_on_the_cpu():
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.index import builder
    from gnumap_tpu_torch.io.fastq import ReadRecord, batch_reads
    from gnumap_tpu_torch.pipeline.mapper import TorchMapper
    g, p = _case(11, n=64, indel_rate=0.2)
    cfg = MapperConfig(mer_size=10, seed_jump=5, max_hits_per_seed=24,
                       max_candidates=32, max_read_len=104, batch_size=64,
                       hit_capacity=8)
    gen = builder.Genome.from_contigs([(g.contig, g.codes)])
    m = TorchMapper(gen, builder.build_index(gen, cfg), cfg, device="cpu")
    recs = [ReadRecord(f"r{i}", p.codes[i], None, p.quals[i].astype(
        np.int16)) for i in range(p.n)]
    batch = next(batch_reads(iter(recs), cfg))
    port = m.map_batch(batch)
    og = oracle.OracleGenome.from_codes([(g.contig, g.codes)])
    idx = oracle.build_oracle_index(og, CFG)
    want = [oracle.map_read(p.codes[r], oracle.pwm_from_calls(
        p.codes[r], p.quals[r]), og, idx, CFG) for r in range(p.n)]
    assert _rows(port) == _rows(want)


def test_the_comparison_notices_a_corrupted_weight_and_the_control():
    g, p = _case(5, n=24)
    og = oracle.OracleGenome.from_codes([(g.contig, g.codes)])
    rg = batched.RefGenome(og.codes, og.names, og.starts, "cpu")
    ctx = check.Context(g, p, CFG, 24, 0, "cpu", 5, {})
    hits = batched.map_reads(p.codes, p.quals, rg, CFG)
    r = next(i for i, h in enumerate(hits) if len(h) > 1)
    want = check.sam_records(ctx, rg, r, "x", hits[r])
    bad = [batched.RefHit(h.strand, h.pos, h.score, h.weight, h.ops)
           for h in hits[r]]
    bad[0].weight = np.nextafter(bad[0].weight, 2.0) + 1e-6
    assert check.sam_records(ctx, rg, r, "x", bad) != want
    ctl = batched.map_reads(p.codes, p.quals, rg, CFG,
                            shift=check.CONTROL_SHIFT)
    assert sum(check.sam_records(ctx, rg, i, "x", ctl[i])
               != check.sam_records(ctx, rg, i, "x", hits[i])
               for i in range(p.n)) > p.n // 2
