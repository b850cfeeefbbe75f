"""The port's device front end (gnumap_tpu_torch.pipeline.mapper) held to
the JAX package's stages, exactly (equal integers, equal booleans):
revcomp_batch, device_pwm, strand_expand, seed_kmers, csr_hits, dedupe_cap,
windows_for, pack_reads / device_unpack.  Inputs carry N bases, short and
empty reads, and a max_candidates small enough that the [FROZEN v2] vote
cap and its ties decide."""

import numpy as np
import pytest
import torch

from gnumap_tpu.align import scoring
from gnumap_tpu.config import MapperConfig
from gnumap_tpu.core import packing, pwm
from gnumap_tpu.index import builder
from gnumap_tpu.pipeline import mapper as jm
from gnumap_tpu.utils import sim
from gnumap_tpu_torch.pipeline import mapper as tm

from test_torch_bridge import to_port

torch.set_num_threads(1)

T = torch.from_numpy


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def batch():
    """A batch of 12 reads over a repeat-rich genome: reads from the genome
    with substitutions and N bases, short reads, an empty pad read."""
    cfg = MapperConfig(mer_size=6, seed_jump=3, max_read_len=32,
                       max_candidates=4, max_hits_per_seed=16)
    g = sim.random_genome(3000, seed=4, repeat_frac=0.3, repeat_unit=60)
    gen = builder.Genome.from_contigs([("r", g)])
    idx = builder.build_index(gen, cfg)
    rng = np.random.default_rng(3)
    B, L = 12, cfg.max_read_len
    codes = np.full((B, L), 4, np.int8)
    quals = np.zeros((B, L), np.int16)
    lens = np.array([32, 32, 30, 17, 8, 32, 25, 32, 1, 32, 32, 0], np.int32)
    for b in range(B):
        n = lens[b]
        p = rng.integers(0, len(gen.codes) - n)
        c = gen.codes[p:p + n].copy()
        sub = rng.random(n) < 0.05
        c[sub] = rng.integers(0, 4, int(sub.sum()))
        c[rng.random(n) < 0.04] = 4
        codes[b, :n] = c
        quals[b, :n] = rng.integers(0, 45, n)
    codes[5, :] = packing.revcomp(codes[0])     # same locus, other strand
    quals[5, :] = quals[0, ::-1]
    pw = pwm.pwm_rows_from_table(codes, quals)
    pw = np.where((np.arange(L)[None, :] < lens[:, None])[:, :, None],
                  pw, 0).astype(np.int32)
    return cfg, gen, idx, codes, quals, lens, pw


def test_pack_reads_and_device_unpack(batch):
    cfg, gen, idx, codes, quals, lens, pw = batch
    packed = tm.pack_reads(codes, quals)
    _eq(packed, jm.pack_reads(codes, quals))
    c, q = tm.device_unpack(T(packed), cfg.max_read_len)
    jc, jq = jm.device_unpack(packed, cfg.max_read_len)
    _eq(c, jc)
    _eq(q, jq)


def test_device_pwm_and_revcomp(batch):
    cfg, gen, idx, codes, quals, lens, pw = batch
    table = pwm.pwm_table()
    got = tm.device_pwm(T(codes), T(quals.astype(np.int32)), T(lens),
                        T(table))
    _eq(got, jm.device_pwm(codes, quals.astype(np.int32), lens, table))
    _eq(got, pw)
    rc, rp = tm.revcomp_batch(T(codes), T(pw), T(lens))
    jrc, jrp = jm.revcomp_batch(codes, pw, lens)
    _eq(rc, jrc)
    _eq(rp, jrp)


def test_strand_expand(batch):
    cfg, gen, idx, codes, quals, lens, pw = batch
    Sp, Sm = scoring.matrices_for_mode(cfg)
    c2, e2 = tm.strand_expand(T(codes), T(pw), T(lens), T(Sp), T(Sm))
    jc2, je2 = jm.strand_expand(codes, pw, lens, Sp, Sm)
    _eq(c2, jc2)
    _eq(e2, je2)
    assert e2.dtype == torch.int32


@pytest.mark.parametrize("max_candidates", [4, 8, 64])
def test_seed_csr_dedupe(batch, max_candidates):
    cfg, gen, idx, codes, quals, lens, pw = batch
    Sp, Sm = scoring.matrices_for_mode(cfg)
    jc2, _ = jm.strand_expand(codes, pw, lens, Sp, Sm)
    c2 = np.array(jc2)
    offsets = np.arange(0, cfg.max_read_len - cfg.mer_size + 1,
                        cfg.seed_jump, dtype=np.int32)
    km, bad = tm.seed_kmers(T(c2), T(offsets.astype(np.int64)),
                            cfg.mer_size)
    jkm, jbad = jm.seed_kmers(c2, offsets, cfg.mer_size)
    _eq(km, jkm)
    _eq(bad, jbad)
    cand = tm.csr_hits(km, bad, T(idx.bucket_start), T(idx.positions),
                       T(offsets.astype(np.int64)), to_port(cfg))
    jcand = jm.csr_hits(np.asarray(jkm), np.asarray(jbad), idx.bucket_start,
                        idx.positions, offsets, cfg)
    _eq(cand, jcand)
    got = tm.dedupe_cap(cand, max_candidates)
    ref = jm.dedupe_cap(np.asarray(jcand), max_candidates)
    _eq(got, ref)
    n_unique = [len(set(r[r != tm.SENTINEL].tolist()))
                for r in np.asarray(jcand).reshape(len(c2), -1)]
    if max_candidates == 4:
        assert max(n_unique) > 4          # the vote cap decides


def test_dedupe_cap_ties_and_negative_anchors():
    """Vote ties resolve by position ascending; negative anchors (seed
    offset past the genome start) sort below every positive one."""
    S = tm.SENTINEL
    cand = np.array([
        [5, 5, 9, 9, -3, -3, 7, 2, S, S, S, S],
        [4, -8, 4, -8, 11, 11, 11, 0, 0, 3, 3, 3],
        [S] * 12,
        [-1, -1, -2, -2, -2, 6, 6, 6, 1, 1, 1, 1]], np.int32)
    for C in (1, 2, 3, 5, 16):
        _eq(tm.dedupe_cap(T(cand), C), jm.dedupe_cap(cand, C))


def test_windows_for(batch):
    cfg, gen, idx, codes, quals, lens, pw = batch
    G = len(gen.codes)
    cands = np.array([[-40, -1, 0, 13], [G - 30, G - 1, G, G + 50]], np.int32)
    got = tm.windows_for(T(cands), T(gen.codes), to_port(cfg))
    _eq(got, jm.windows_for(cands, gen.codes, cfg))
