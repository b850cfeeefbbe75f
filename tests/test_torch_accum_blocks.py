"""B5's live work counted, and the GNUMAP-SNP device pileup against the
benchmark's plain reference, on the CPU.

  * device_accumulate returns, beside its stats, the number of unique
    128-blocks it hands the ordered RMW (csrc/accum_rmw.cu): on seeded hit
    rows with multi-mapped reads it equals an independent count, the
    distinct clamped 128-blocks of the valid hits' starts;
  * utils/profiling.py's value ring sums the values recorded in a range,
    and reads None once the ring has overwritten one that may lie there;
  * the port's SNP device pileup (TorchMapper(accumulate="device") through
    map_stream, as ``gnumap --snp --accumulate device`` runs it) on a 40 kb
    genome with one 7-copy repeat family, the benchmark configuration
    ``ecoli-k12-100bp-snp`` cut to the CPU, lies within the
    configuration's ``cov_gap`` and ``tally_gap`` limits of
    ``mapbench/reference``'s float64 sums; finish_acc counts each batch's
    blocks and records them, and the tier of slots its accumulate program
    ran on, once a batch.
"""

import os
import sys

import numpy as np
import pytest
import torch

from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.index import builder
from gnumap_tpu_torch.io import fastq as io_fastq
from gnumap_tpu_torch.pipeline import mapper as tm
from gnumap_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mapbench import cell as cells  # noqa: E402
from mapbench.genome import make_genome  # noqa: E402
from mapbench.reference import batched, oracle  # noqa: E402
from mapbench.reference.consts import RefConfig  # noqa: E402
from mapbench.traffic import make_pool, write_fastq  # noqa: E402

torch.set_num_threads(1)

CONFIG = "ecoli-k12-100bp-snp"
TRAFFIC = "pileup-wgsim"


def _multi_rows(seed, B, H, L, G, n_live):
    """device_hit_rows-shaped rows for B reads: each read holds 1 to 7 hits
    (a repeat family's copies) at spread starts, some at the genome's two
    ends, where the block is clamped; the first n_live of H slots are
    filled, one in eleven of them invalid."""
    rng = np.random.default_rng(seed)
    per_read = rng.integers(1, 8, B)
    row = np.repeat(np.arange(B), per_read)[:H]
    row = np.where(rng.random(len(row)) < 0.5, row, row + B)
    k = len(row)
    cand = rng.integers(-40, G + 40, k)
    cand[::13] = rng.integers(-24, 24, len(cand[::13]))
    cand[5::17] = G - rng.integers(0, 140, len(cand[5::17]))
    cand = (cand // 8 * 8).astype(np.int32)
    rows = dict(
        row_h=np.zeros(H, np.int32), cand_h=np.zeros(H, np.int32),
        jfin=np.zeros(H, np.int32), score_h=np.zeros(H, np.int32),
        len_h=np.zeros(H, np.int32),
        ops=np.zeros((H, (L + 7) // 8 * 8), np.int16))
    rows["row_h"][:k] = row
    rows["cand_h"][:k] = cand
    rows["jfin"][:k] = rng.integers(0, 30, k)
    rows["score_h"][:k] = rng.integers(1 << 20, 1 << 22, k)
    rows["len_h"][:k] = 100
    valid = np.arange(H) < min(k, n_live)
    valid[::11] = False
    rows.update(valid_h=valid, n_valid=np.int32(valid.sum()),
                n_keep=np.int32(n_live))
    pwm2 = rng.integers(0, 1 << 10, (2 * B, L, 4)).astype(np.int32)
    return rows, pwm2


def _independent_blocks(cfg, rows, n_live, Gpad):
    """Distinct 128-blocks of the valid hits' starts in the first n_live
    slots, clamped so that a delta window fits the padded accumulator."""
    n = min(n_live, len(rows["valid_h"]))
    valid = np.asarray(rows["valid_h"])[:n]
    cand = np.asarray(rows["cand_h"], np.int64)[:n]
    pos = (cand - cfg.gap_slack) // 8 * 8 + np.asarray(rows["jfin"])[:n]
    top = (Gpad - tm.acc_span(cfg)) // 128
    return len(np.unique(np.clip(pos[valid] // 128, 0, top)))


@pytest.mark.parametrize("H", [100, 128, 512, 8192])
@pytest.mark.parametrize("n_keep", [0, 1, 127, 128, 129, "H"])
def test_tier_holds_every_hit_within_the_slots(n_keep, H):
    """acc_tier: at least n_keep, at most H, a multiple of 128 below H,
    and under 128 slots above n_keep (at least one slot)."""
    n = H if n_keep == "H" else min(n_keep, H)
    t = tm.acc_tier(n, H)
    assert max(n, 1) <= t <= H
    assert t == H or (t % 128 == 0 and t - max(n, 1) < 128)


@pytest.mark.parametrize("snp", [True, False])
def test_accumulators_keep_their_storage(snp):
    """reset_accumulators and load_accumulators write into the tensors
    they found (the addresses the accumulate program's graphs hold)."""
    cfg = MapperConfig(mer_size=8, batch_size=16, max_read_len=40,
                       snp_mode=snp)
    rng = np.random.default_rng(7)
    gen = builder.Genome.from_contigs([("a", rng.integers(0, 4, 3000)
                                        .astype(np.int8))])
    m = tm.TorchMapper(gen, builder.build_index(gen, cfg), cfg,
                       device="cpu", accumulate="device")
    accs = [t for t in (m._cov_dev, m._tal_dev) if t is not None]
    ptrs = [t.data_ptr() for t in accs]
    G = len(gen.codes)
    cov = rng.random(G)
    tal = rng.random((G, 4)) if snp else None
    m.load_accumulators(cov, tal)
    got_cov, got_tal = m.fetch_accumulators()
    assert np.array_equal(got_cov, cov.astype(np.float32))
    if snp:
        assert np.array_equal(got_tal, tal.astype(np.float32))
    m.reset_accumulators()
    assert not any(bool(t.any()) for t in accs)
    now = [t for t in (m._cov_dev, m._tal_dev) if t is not None]
    assert [t.data_ptr() for t in now] == ptrs and len(now) == 1 + snp


@pytest.mark.parametrize("n_live", [400, 1000])
@pytest.mark.parametrize("snp", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unique_blocks_equal_an_independent_count(seed, snp, n_live):
    B, H, L, G = 128, 1024, 104, 30_000
    cfg = MapperConfig(mer_size=10, batch_size=B, max_read_len=L,
                       snp_mode=snp)
    rows, pwm2 = _multi_rows(seed, B, H, L, G, n_live)
    Gpad = tm.acc_padded_len(cfg, G)
    cov = torch.zeros((Gpad // 128, 128))
    tal = torch.zeros((Gpad * 4 // 128, 128)) if snp else None
    stats, n_uniq = tm.device_accumulate(
        cfg, B, torch.from_numpy(pwm2),
        {k: torch.as_tensor(v) for k, v in rows.items()}, cov, tal,
        n_live=n_live)
    want = _independent_blocks(cfg, rows, n_live, Gpad)
    assert int(n_uniq) == want
    assert n_uniq.dtype == torch.int32 and stats.shape == (4,)
    # multi-mapped reads and blocks shared by several hits
    assert int(stats[1]) > 0 and want < int(np.asarray(
        rows["valid_h"])[:n_live].sum())
    # the rows B5 touched: each unique block's own coverage row at least
    assert int((cov.sum(1) != 0).sum()) >= want


def test_value_ring_sums_a_range_and_reads_none_once_overwritten(
        monkeypatch):
    ring = profiling.Ring(8, 4)
    monkeypatch.setattr(profiling, "VALS", ring)
    clock = iter(range(100, 10_000, 100))
    monkeypatch.setattr(profiling, "_now", lambda: next(clock))
    for v in (3, 5, 7, 11, 13):                     # stamped 100 .. 500
        profiling.record("accumulate.blocks", v)
    assert profiling.value_sum("accumulate.blocks", 100, 500) == 39
    assert profiling.value_sum("accumulate.blocks", 200, 400) == 23
    assert profiling.value_sum("accumulate.blocks", 450, 900) == 13
    assert profiling.value_sum("accumulate.blocks", 600, 900) == 0
    for v in range(6):                              # stamped 600 .. 1100
        profiling.record("accumulate.blocks", v)
    assert ring.lost == 3
    # the three oldest (100 .. 300) are gone, and the ring knows only that
    # they were stamped at 400 or before: a range from there reads None,
    # never a part; a later range still reads its sum
    assert profiling.value_sum("accumulate.blocks", 100, 500) is None
    assert profiling.value_sum("accumulate.blocks", 350, 1100) is None
    assert profiling.value_sum("accumulate.blocks", 400, 1100) is None
    assert profiling.value_sum("accumulate.blocks", 450, 1100) == \
        13 + sum(range(6))
    assert profiling.value_sum("accumulate.blocks", 700, 800) == 1 + 2


def _pileup_setup(tmp_path, seed):
    """The SNP configuration and its traffic cut to the CPU: 40 kb, one
    family of 7 copies of 500 bp, 512 reads in batches of 128."""
    config = cells.load_json(cells.config_file(CONFIG))
    mix = cells.load_json(cells.traffic_file(TRAFFIC))
    config = dict(config, genome_len=40_000,
                  families=dict(config["families"], unit_len=500))
    mapper_kw = dict(config["mapper"], batch_size=128, mer_size=10)
    genome = make_genome(config, seed)
    pool = make_pool(genome, mix, seed, n_reads=512)
    cfg = MapperConfig(**mapper_kw)
    path = str(tmp_path / "reads.fastq")
    write_fastq(pool, genome.contig, path, cfg.phred_offset)
    return config, mapper_kw, genome, pool, cfg, path


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_snp_device_pileup_within_the_configuration_limits(tmp_path, seed,
                                                           monkeypatch):
    config, mapper_kw, genome, pool, cfg, path = _pileup_setup(tmp_path,
                                                               seed)
    assert config["accumulate"] == "device" and cfg.snp_mode
    assert not cfg.sam_out and config["families"]["copies"] == 7
    gen = builder.Genome.from_contigs([(genome.contig, genome.codes)])
    m = tm.TorchMapper(gen, builder.build_index(gen, cfg), cfg,
                       device="cpu", accumulate="device")
    counted, lives = [], []
    real = tm.device_accumulate

    def spy(cfg_, B, pwm2, rows, cov, tal, n_live):
        counted.append(_independent_blocks(cfg_, rows, n_live,
                                           cov.shape[0] * 128))
        lives.append(n_live)
        return real(cfg_, B, pwm2, rows, cov, tal, n_live=n_live)

    monkeypatch.setattr(tm, "device_accumulate", spy)
    c0 = profiling.counters()
    t0 = profiling._now()
    res = tm.map_stream(m, io_fastq.batch_reads(
        io_fastq.iter_fastq(path, cfg), cfg), collect_sam=False)
    t1 = profiling._now()
    c1 = profiling.counters()
    assert profiling.COUNTS["finish.overflow"] == c0["finish.overflow"]
    assert len(counted) == pool.n // cfg.batch_size
    assert c1["accumulate.blocks"] - c0["accumulate.blocks"] == \
        sum(counted) > 0
    assert profiling.value_sum("accumulate.blocks", t0, t1) == sum(counted)
    rec = profiling.VALS.rows(t0, t1)
    assert len(rec) == 2 * len(counted)
    assert len(profiling.values("accumulate.blocks", t0, t1)) == \
        len(counted)
    assert profiling.values("accumulate.tier", t0, t1).tolist() == lives
    assert c1["accumulate.hits"] - c0["accumulate.hits"] >= sum(counted)

    og = oracle.OracleGenome.from_codes([(genome.contig, genome.codes)])
    rg = batched.RefGenome(og.codes, og.names, og.starts, "cpu")
    hits = batched.map_reads(pool.codes, pool.quals, rg,
                             RefConfig.from_mapper(mapper_kw))
    G = len(genome.codes)
    pwm = oracle.pwm_from_calls(pool.codes, pool.quals)
    cov_t, tal_t = batched.contributions(hits, pwm, np.arange(G))
    once = np.ones(pool.n, np.int64)
    ref_cov = batched.sum_f64(cov_t, once, G, None)
    ref_tal = batched.sum_f64(tal_t, once, G, 4)

    def gap(got, want):
        return float(np.max(np.abs(got - want)
                            / np.maximum(np.abs(want), 1.0)))

    limits = config["limits"]
    # the port's accumulators run on over the genome's padding
    assert gap(res.coverage[:G], ref_cov) <= limits["cov_gap"]
    assert gap(res.tallies[:G], ref_tal) <= limits["tally_gap"]
    # reads in the family split their weight over its copies
    multi = [h for h in hits if len(h) > 1]
    assert len(multi) >= 10
    assert all(abs(sum(x.weight for x in h) - 1.0) < 1e-9 for h in multi)
    spots = genome.spots[0]
    inside = np.concatenate([np.arange(s, s + 500) for s in spots])
    frac = res.coverage[inside] % 1.0
    assert ((frac > 1e-3) & (frac < 1 - 1e-3)).any()
