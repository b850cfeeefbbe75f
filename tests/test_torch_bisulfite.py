"""The port's bisulfite mode (gnumap_tpu_torch/pipeline/mapper.py:
seed_kmers_b3 and the "csr_bs" branch of TorchMapper._seed on the per-strand
collapsed CSR pair) held to the JAX package, each bisulfite test of
tests/test_modes.py mirrored, on the CPU.

Every comparison is exact: base-3 k-mer codes and their N masks equal the
JAX function's; TorchMapper's hits (strand, pos, score, CIGAR, ref_len,
weight) equal TpuMapper's on the same batch, and the oracle's where the
JAX test holds the pipeline to the oracle."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gnumap_tpu.config import MapperConfig
from gnumap_tpu.core import packing
from gnumap_tpu.index import builder
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.oracle import oracle
from gnumap_tpu.pipeline import mapper as jm
from gnumap_tpu.utils import sim
from gnumap_tpu_torch.index import builder as tbuilder
from gnumap_tpu_torch.pipeline import mapper as tm

from conftest import records_from_sim
from test_modes import _bisulfite_convert
from test_torch_bridge import to_port

torch.set_num_threads(1)


def _hits(out):
    return [[(h.strand, h.pos, h.score, h.cigar, h.ref_len, h.weight)
             for h in hits] for hits in out]


@pytest.mark.parametrize("collapse", ["ct", "ga"])
def test_seed_kmers_b3_equals_jax(collapse):
    """Base-3 collapsed k-mer codes on random codes with Ns (1 in 12), at
    mer_size 16 (the largest codes of bench config 4) and 5."""
    rng = np.random.default_rng(3 if collapse == "ct" else 4)
    codes2 = rng.integers(0, 4, (24, 104)).astype(np.int8)
    codes2[rng.random(codes2.shape) < 1 / 12] = 4
    for m in (16, 5):
        offsets = np.arange(0, 104 - m + 1, 5, dtype=np.int32)
        km, bad = jm.seed_kmers_b3(
            jnp.asarray(codes2), offsets, m,
            jnp.asarray(builder.BS_DIGITS[collapse], jnp.int32))
        tkm, tbad = tm.seed_kmers_b3(
            torch.from_numpy(codes2), torch.from_numpy(offsets.astype(
                np.int64)), m, torch.from_numpy(
                    tbuilder.BS_DIGITS[collapse].astype(np.int32)))
        assert tkm.dtype == torch.int32
        assert np.array_equal(tkm.numpy(), np.asarray(km))
        assert np.array_equal(tbad.numpy(), np.asarray(bad))
        assert 0 < int(tbad.sum()) < tbad.numel()
        assert int(tkm.max()) < 3 ** m


@pytest.fixture(scope="module")
def bs_setup():
    """tests/test_modes.py's bisulfite workload, with both mappers."""
    cfg = MapperConfig(mer_size=8, seed_jump=2, batch_size=32,
                       max_read_len=40, align_score_ratio=0.75,
                       bisulfite=True)
    genome = sim.random_genome(4000, seed=21)
    gen = builder.Genome.from_contigs([("bs", genome)])
    idx = builder.build_bs_index(gen, cfg)
    ref = jm.TpuMapper(gen, idx, cfg)
    port = tm.TorchMapper(*to_port((gen, idx, cfg)), device="cpu")
    assert port.index_kind == "csr_bs"
    return cfg, genome, gen, idx, ref, port


def _map_both(ref, port, reads, cfg):
    batch = next(io_fastq.batch_reads(iter(records_from_sim(reads, cfg)),
                                      cfg))
    want = ref.map_batch(batch)
    got = port.map_batch(to_port(batch))
    assert _hits(got) == _hits(want)
    return batch, got


def test_bisulfite_reads_map(bs_setup):
    """tests/test_modes.py:45: 60% C->T converted reads map at their true
    loci in bisulfite mode, as TpuMapper maps them, and fail in normal
    mode."""
    cfg, genome, gen, idx, ref, port = bs_setup
    rng = np.random.default_rng(5)
    g = packing.encode(genome)
    reads, truths = [], []
    for i in range(24):
        pos = int(rng.integers(0, 4000 - 36))
        conv = _bisulfite_convert(packing.decode(g[pos:pos + 36]), "+", 0.6,
                                  rng)
        reads.append(sim.SimRead(f"bs_{i}_bs_{pos}_+", conv, "I" * 36,
                                 pos, "+"))
        truths.append(pos)
    batch, hits_bs = _map_both(ref, port, reads, cfg)
    cfg_norm = dataclasses.replace(cfg, bisulfite=False)
    m_norm = tm.TorchMapper(*to_port((gen, builder.build_index(gen, cfg_norm),
                                      cfg_norm)), device="cpu")
    hits_norm = m_norm.map_batch(to_port(batch))
    mapped_bs = sum(1 for h in hits_bs if h)
    assert mapped_bs >= 20
    assert sum(1 for h in hits_norm if h) < mapped_bs / 2
    for b, hits in enumerate(hits_bs):
        if hits:
            assert abs(max(hits, key=lambda h: h.weight).pos
                       - truths[b]) <= 2


def test_bisulfite_minus_strand(bs_setup):
    """tests/test_modes.py:78: minus-strand converted reads map through the
    asymmetric minus matrix and the G->A table, as TpuMapper maps them."""
    cfg, genome, gen, idx, ref, port = bs_setup
    rng = np.random.default_rng(6)
    g = packing.encode(genome)
    reads = []
    for i in range(12):
        pos = int(rng.integers(0, 4000 - 36))
        conv = _bisulfite_convert(packing.decode(g[pos:pos + 36]), "-", 0.6,
                                  rng)
        read_seq = packing.decode(packing.revcomp(packing.encode(conv)))
        reads.append(sim.SimRead(f"bsm_{i}_bs_{pos}_-", read_seq, "I" * 36,
                                 pos, "-"))
    _, hits = _map_both(ref, port, reads, cfg)
    n_ok = 0
    for b, hh in enumerate(hits):
        if hh:
            best = max(hh, key=lambda h: h.weight)
            n_ok += (best.strand == "-"
                     and abs(best.pos - reads[b].true_pos) <= 2)
    assert n_ok >= 9


def test_bisulfite_collapsed_seeding_sparse_seeds():
    """tests/test_modes.py:106: at mer 12, jump 5 heavily converted 100 bp
    reads still map (62 of 64 at the truth), hit for hit as TpuMapper."""
    cfg = MapperConfig(mer_size=12, seed_jump=5, batch_size=64,
                       max_read_len=104, align_score_ratio=0.75,
                       bisulfite=True)
    genome = sim.random_genome(200_000, seed=77)
    gen = builder.Genome.from_contigs([("bsl", genome)])
    idx = builder.build_bs_index(gen, cfg)
    reads = sim.simulate_reads(genome, 64, 100, seed=3, sub_rate=0.005,
                               contig="bsl", bisulfite=True,
                               methylation_rate=0.1)
    _, hits = _map_both(jm.TpuMapper(gen, idx, cfg),
                        tm.TorchMapper(*to_port((gen, idx, cfg)),
                                       device="cpu"), reads, cfg)
    n_ok = 0
    for b, hh in enumerate(hits):
        if hh:
            best = max(hh, key=lambda h: h.weight)
            n_ok += (abs(best.pos - reads[b].true_pos) <= 2
                     and best.strand == reads[b].true_strand)
    assert n_ok >= 62


def test_bisulfite_pipeline_matches_oracle(bs_setup):
    """tests/test_modes.py:131: the port's hits equal the oracle's, read
    for read (and TpuMapper's)."""
    cfg, genome, gen, idx, ref, port = bs_setup
    ogen = oracle.OracleGenome.from_contigs([("bs", genome)])
    oidx = oracle.build_oracle_bs_indexes(ogen, cfg)
    rng = np.random.default_rng(7)
    g = packing.encode(genome)
    reads = []
    for i in range(16):
        pos = int(rng.integers(0, 4000 - 36))
        conv = _bisulfite_convert(packing.decode(g[pos:pos + 36]), "+", 0.4,
                                  rng)
        reads.append(sim.SimRead(f"bso_{i}_bs_{pos}_+", conv, "I" * 36,
                                 pos, "+"))
    batch, hits = _map_both(ref, port, reads, cfg)
    for b, phits in enumerate(hits):
        L = int(batch.lens[b])
        ohits = oracle.map_read(batch.codes[b, :L], batch.pwm_q[b, :L],
                                ogen, oidx, cfg)
        assert [(h.strand, h.pos, h.score, h.cigar) for h in ohits] == \
            [(h.strand, h.pos, h.score, h.cigar) for h in phits]
    assert sum(1 for h in hits if h) >= 12
