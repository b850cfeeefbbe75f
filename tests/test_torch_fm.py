"""The port's FM index (gnumap_tpu_torch/index/fm.py: the device search
fm_ranges / fm_hits in torch) and its seeding in TorchMapper held to the JAX
package, each test of tests/test_fm.py mirrored, on the CPU.

Every comparison is exact: the SA ranges and the candidate arrays element
for element (both read the same suffix array), the mapped hits (strand, pos,
score, CIGAR, ref_len, weight) against TpuMapper's, and the FM backend's
hits against the CSR backend's, with the dedupe-cap's vote cap exercised.
Device accumulation on each index kind agrees with host accumulation within
rtol = atol = 1e-5 (its f32 add order, as tests/test_torch_accum.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnumap_tpu.config import MapperConfig
from gnumap_tpu.core import packing
from gnumap_tpu.index import builder, fm, store
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.pipeline import mapper as jm
from gnumap_tpu.utils import sim
from gnumap_tpu_torch.index import fm as tfm, store as tstore
from gnumap_tpu_torch.pipeline import mapper as tm

from conftest import records_from_sim
from test_torch_bridge import port_iter, to_port

torch.set_num_threads(1)


def _hits(out):
    return [[(h.strand, h.pos, h.score, h.cigar, h.ref_len, h.weight)
             for h in hits] for hits in out]


def _mk(seed=1, glen=3000, m=6):
    """tests/test_fm.py's small workload."""
    cfg = MapperConfig(mer_size=m, seed_jump=3, batch_size=16,
                       max_read_len=24, max_candidates=16,
                       max_hits_per_seed=8)
    genome = sim.random_genome(glen, seed=seed)
    gen = builder.Genome.from_contigs([("g", genome)])
    return cfg, gen


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_fm_ranges_and_hits_equal_jax():
    """tests/test_fm.py:85's inputs: fm_ranges' (lo, hi) and fm_hits'
    candidates equal the JAX functions' element for element; as sets per
    seed they equal the port's csr_hits."""
    cfg, gen = _mk(seed=5)
    fmi = fm.build_fm_index(gen, cfg)
    csr = builder.build_index(gen, cfg)
    rng = np.random.default_rng(7)
    B2, L = 8, cfg.max_read_len
    codes2 = rng.integers(0, 4, (B2, L)).astype(np.int8)
    codes2[0, 3] = 4  # an N in a seed
    offsets = np.arange(0, L - cfg.mer_size + 1, cfg.seed_jump,
                        dtype=np.int32)
    km, bad = jm.seed_kmers(jnp.asarray(codes2), offsets, cfg.mer_size)
    jargs = [jnp.asarray(a) for a in (fmi.sa, fmi.bwt_words, fmi.occ,
                                      fmi.c_table)]
    want_lo, want_hi = (np.asarray(x) for x in fm.fm_ranges(
        km, bad, fmi.sa.shape[0], *jargs[1:], cfg.mer_size))
    want = np.asarray(fm.fm_hits(km, bad, *jargs, offsets, cfg))
    tcfg = to_port(cfg)
    tkm, tbad = tm.seed_kmers(_t(codes2), _t(offsets.astype(np.int64)),
                              cfg.mer_size)
    assert np.array_equal(tkm.numpy(), np.asarray(km))
    targs = [_t(a) for a in (fmi.sa, fmi.bwt_words, fmi.occ, fmi.c_table)]
    lo, hi = tfm.fm_ranges(tkm, tbad, fmi.sa.shape[0], *targs[1:],
                           cfg.mer_size)
    assert lo.dtype == hi.dtype == torch.int32
    assert np.array_equal(lo.numpy(), want_lo)
    assert np.array_equal(hi.numpy(), want_hi)
    got = tfm.fm_hits(tkm, tbad, *targs, _t(offsets), tcfg)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert (want != jm.SENTINEL).sum() > 20 and (want_hi > want_lo).any()
    c = tm.csr_hits(tkm, tbad, _t(csr.bucket_start), _t(csr.positions),
                    _t(offsets), tcfg).numpy()
    assert np.array_equal(np.sort(c, axis=-1), np.sort(want, axis=-1))


def test_fm_lookup_matches_csr():
    """tests/test_fm.py:68 on the port's classes: FM lookup == CSR lookup
    for 200 present k-mers and an absent one, and == the JAX FM lookup."""
    cfg, gen = _mk()
    tcfg, tgen = to_port((cfg, gen))
    jfmi = fm.build_fm_index(gen, cfg)
    from gnumap_tpu_torch.index import builder as tbuilder
    csr = tbuilder.build_index(tgen, tcfg)
    fmi = tfm.build_fm_index(tgen, tcfg)
    kmers, valid = packing.kmer_codes(gen.codes, cfg.mer_size)
    seen = sorted(set(int(k) for k, v in zip(kmers, valid) if v))
    rng = np.random.default_rng(3)
    for k in rng.choice(seen, size=min(200, len(seen)), replace=False):
        got = fmi.lookup(int(k))
        assert np.array_equal(got, np.sort(csr.lookup(int(k)))), int(k)
        assert np.array_equal(got, jfmi.lookup(int(k))), int(k)
    absent = next(k for k in range(4 ** cfg.mer_size)
                  if k not in set(seen))
    assert len(fmi.lookup(absent)) == 0


def _fm_reads(gen, n=40, seed=2):
    reads = sim.simulate_reads(packing.decode(gen.codes[:3900]), n, 20,
                               seed=seed, sub_rate=0.03, indel_rate=0.05,
                               contig="g")
    return reads


@pytest.mark.parametrize("finish_impl", ["device", "host"])
def test_fm_pipeline_matches_csr(finish_impl):
    """tests/test_fm.py:109: TorchMapper on the FM index gives TpuMapper's
    hits on it (jnp), and the port's own CSR hits."""
    cfg, gen = _mk(seed=9, glen=4000, m=7)
    fmi = fm.build_fm_index(gen, cfg)
    csr = builder.build_index(gen, cfg)
    recs = records_from_sim(_fm_reads(gen), cfg)
    ref = jm.TpuMapper(gen, fmi, cfg)
    t_fm = tm.TorchMapper(*to_port((gen, fmi, cfg)), device="cpu",
                          finish_impl=finish_impl)
    t_csr = tm.TorchMapper(*to_port((gen, csr, cfg)), device="cpu",
                           finish_impl=finish_impl)
    assert t_fm.index_kind == "fm" and t_csr.index_kind == "csr"
    n_mapped = 0
    for b in io_fastq.batch_reads(iter(recs), cfg):
        want = _hits(ref.map_batch(b))
        got = _hits(t_fm.map_batch(to_port(b)))
        assert got == want
        assert _hits(t_csr.map_batch(to_port(b))) == want
        n_mapped += sum(1 for h in got if h)
    assert n_mapped >= 30


def test_fm_bisulfite_matches_csr_pair():
    """tests/test_fm.py:137: the FM bisulfite pair maps exactly like the
    collapsed CSR pair, in the port and in the JAX package."""
    cfg = MapperConfig(mer_size=8, seed_jump=3, batch_size=16,
                       max_read_len=40, max_candidates=32,
                       max_hits_per_seed=16, align_score_ratio=0.7,
                       sam_out=False, sgr_out=False, bisulfite=True)
    genome = sim.random_genome(6000, seed=19)
    gen = builder.Genome.from_contigs([("g", genome)])
    csr_pair = builder.build_bs_index(gen, cfg)
    fm_pair = fm.build_bs_fm_index(gen, cfg)
    reads = sim.simulate_reads(genome, 32, 36, seed=6, sub_rate=0.02,
                               contig="g", bisulfite=True)
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8).astype(np.int32)
         - 33).astype(np.int16)) for r in reads]
    ref = jm.TpuMapper(gen, fm_pair, cfg)
    t_fm = tm.TorchMapper(*to_port((gen, fm_pair, cfg)), device="cpu")
    t_csr = tm.TorchMapper(*to_port((gen, csr_pair, cfg)), device="cpu")
    assert (t_fm.index_kind, t_csr.index_kind) == ("fm_bs", "csr_bs")
    n_mapped = 0
    for b in io_fastq.batch_reads(iter(recs), cfg):
        want = _hits(ref.map_batch(b))
        got = _hits(t_fm.map_batch(to_port(b)))
        assert got == want
        assert _hits(t_csr.map_batch(to_port(b))) == want
        n_mapped += sum(1 for h in got if h)
    assert n_mapped >= 28


@pytest.mark.parametrize("kind", ["fm", "fm_bs", "csr_bs"])
def test_saved_index_kinds_map_as_jax(kind, tmp_path):
    """tests/test_fm.py:172 with every non-default kind: an index saved by
    the JAX package loads through the port's store, equal to what was
    saved, and maps to TpuMapper's hits on the same file."""
    bs = kind.endswith("_bs")
    cfg = MapperConfig(mer_size=8, seed_jump=3, batch_size=16,
                       max_read_len=40, max_candidates=16,
                       align_score_ratio=0.7, bisulfite=bs)
    genome = sim.random_genome(5000, seed=11)
    gen = builder.Genome.from_contigs([("g1", genome[:2600]),
                                       ("g2", genome[2600:])])
    idx = {"fm": lambda: fm.build_fm_index(gen, cfg),
           "fm_bs": lambda: fm.build_bs_fm_index(gen, cfg),
           "csr_bs": lambda: builder.build_bs_index(gen, cfg)}[kind]()
    p = str(tmp_path / "idx.npz")
    store.save_index(p, gen, idx)
    jgen, jidx = store.load_index(p)
    tgen, tidx = tstore.load_index(p)
    assert type(tidx).__name__ == type(idx).__name__
    assert dataclasses.asdict(to_port(jidx)).keys() == \
        dataclasses.asdict(tidx).keys()
    for name, a in _arrays(jidx):
        assert np.array_equal(a, dict(_arrays(tidx))[name]), name
    assert np.array_equal(tgen.codes, gen.codes)
    reads = sim.simulate_reads(genome, 24, 36, seed=4, sub_rate=0.02,
                               contig="g", bisulfite=bs)
    batch = next(io_fastq.batch_reads(iter(records_from_sim(reads, cfg)),
                                      cfg))
    want = _hits(jm.TpuMapper(jgen, jidx, cfg).map_batch(batch))
    m = tm.TorchMapper(tgen, tidx, to_port(cfg), device="cpu")
    assert m.index_kind == kind
    got = _hits(m.map_batch(to_port(batch)))
    assert got == want and sum(1 for h in got if h) >= 16


def _arrays(idx):
    out = []
    for f in dataclasses.fields(idx):
        v = getattr(idx, f.name)
        if dataclasses.is_dataclass(v):
            out += [(f"{f.name}.{n}", a) for n, a in _arrays(v)]
        elif isinstance(v, np.ndarray):
            out.append((f.name, v))
    return out


def test_fm_order_and_vote_cap_match_csr():
    """FM returns candidates in suffix-array order, CSR ascending; with more
    unique candidates than max_candidates (the [FROZEN v2] vote cap cuts)
    the capped candidate sets and the hits still agree with CSR and with
    TpuMapper."""
    cfg = MapperConfig(mer_size=8, seed_jump=2, batch_size=32,
                       max_read_len=40, max_candidates=4,
                       max_hits_per_seed=32, align_score_ratio=0.6)
    g, _ = sim.random_genome_families(20_000, seed=13, n_families=3,
                                      copies=10, unit_len=200)
    gen = builder.Genome.from_contigs([("r", g)])
    fmi, csr = fm.build_fm_index(gen, cfg), builder.build_index(gen, cfg)
    reads = sim.simulate_reads(g, 32, 36, seed=14, sub_rate=0.03,
                               contig="r")
    batch = next(io_fastq.batch_reads(iter(records_from_sim(reads, cfg)),
                                      cfg))
    tb = to_port(batch)
    t_fm = tm.TorchMapper(*to_port((gen, fmi, cfg)), device="cpu")
    t_csr = tm.TorchMapper(*to_port((gen, csr, cfg)), device="cpu")
    codes = _t(np.asarray(tb.codes, np.int8))
    pw = _t(np.asarray(tb.pwm_q, np.int32))
    lens = _t(np.asarray(tb.lens, np.int32))
    codes2, _ = tm.strand_expand(codes, pw, lens, t_fm.state["S_plus"],
                                 t_fm.state["S_minus"])
    st = t_fm.state
    km, bad = tm.seed_kmers(codes2, st["offsets"], cfg.mer_size)
    raw = tfm.fm_hits(km, bad, st["sa"], st["bwt_words"], st["occ"],
                      st["c_table"], st["offsets"], t_fm.cfg).reshape(
                          codes2.shape[0], -1)
    n_unique = [len(set(r.tolist()) - {tm.SENTINEL}) for r in raw]
    assert sum(n > cfg.max_candidates for n in n_unique) >= 8
    # the raw FM rows are not ascending (suffix-array order), CSR's are
    flat = raw.numpy()
    assert any((np.diff(r[r != tm.SENTINEL]) < 0).any() for r in flat)
    cf, vf = t_fm._seed(codes2)
    cc, vc = t_csr._seed(codes2)
    assert torch.equal(cf, cc) and torch.equal(vf, vc)
    want = _hits(jm.TpuMapper(gen, fmi, cfg).map_batch(batch))
    assert _hits(t_fm.map_batch(tb)) == want == _hits(t_csr.map_batch(tb))
    assert sum(len(h) > 1 for h in want) >= 4


def test_mapper_checks_index_kind_as_jax(phix_genome):
    """The reference's refusals, with its messages: a bisulfite config on a
    plain index, a plain config on a bisulfite index, an FM pair past
    mer_size 15."""
    gen = builder.Genome.from_contigs([("phiX_sim", phix_genome)])
    cfg = MapperConfig(mer_size=8, max_read_len=40)
    cfg_bs = dataclasses.replace(cfg, bisulfite=True)
    pair = fm.build_bs_fm_index(gen, cfg_bs)
    pair16 = fm.FmBsPair(dataclasses.replace(pair.plus, mer_size=16),
                         dataclasses.replace(pair.minus, mer_size=16))
    cases = [(cfg_bs, builder.build_index(gen, cfg)),
             (cfg, builder.build_bs_index(gen, cfg_bs)),
             (cfg, pair),
             (cfg_bs, fm.build_fm_index(gen, cfg)),
             (dataclasses.replace(cfg_bs, mer_size=16), pair16)]
    for c, idx in cases:
        with pytest.raises(ValueError) as want:
            jm.TpuMapper(gen, idx, c)
        with pytest.raises(ValueError) as got:
            tm.TorchMapper(*to_port((gen, idx, c)), device="cpu")
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["csr_bs", "fm", "fm_bs"])
def test_device_accumulation_on_each_kind(kind):
    """TorchMapper(accumulate="device") on each ported index kind: counts
    and SAM records equal to host accumulation, coverage and tallies within
    1e-5 (the documented f32 difference)."""
    bs = kind.endswith("_bs")
    cfg = MapperConfig(mer_size=8, seed_jump=3, batch_size=32,
                       max_read_len=40, max_candidates=16,
                       align_score_ratio=0.7, bisulfite=bs, snp_mode=True,
                       sam_out=True, hit_capacity=4)
    g = sim.random_genome(8000, seed=23, repeat_frac=0.05, repeat_unit=80)
    gen = builder.Genome.from_contigs([("a", g)])
    idx = {"fm": lambda: fm.build_fm_index(gen, cfg),
           "fm_bs": lambda: fm.build_bs_fm_index(gen, cfg),
           "csr_bs": lambda: builder.build_bs_index(gen, cfg)}[kind]()
    reads = sim.simulate_reads(g, 80, 36, seed=24, sub_rate=0.02,
                               indel_rate=0.05, contig="a", bisulfite=bs)
    recs = records_from_sim(reads, cfg)
    out = {}
    for acc in ("device", "host"):
        m = tm.TorchMapper(*to_port((gen, idx, cfg)), device="cpu",
                           accumulate=acc)
        out[acc] = tm.map_stream(m, port_iter(io_fastq.batch_reads(
            iter(recs), cfg)))
    d, h = out["device"], out["host"]
    for f in ("n_reads", "n_mapped", "n_multi", "n_candidates"):
        assert getattr(d.stats, f) == getattr(h.stats, f), f
    assert d.sam_lines == h.sam_lines
    np.testing.assert_allclose(d.coverage, h.coverage, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.tallies, h.tallies, rtol=1e-5, atol=1e-5)
    assert h.stats.n_mapped >= 70 and h.coverage.sum() > 1000
