"""The genome and read pool repeat by seed, differ between seeds, and reach
the port's FASTQ parser as they were made."""

import numpy as np
import pytest

from mapbench.genome import make_genome
from mapbench.tests import tiny
from mapbench.traffic import make_pool, read_names, write_fastq

BIG = 2 ** 31 + 12345


def _make(seed, name="snp-repeat25", n=512, **mix):
    s = tiny.spec(name, **mix)
    g = make_genome(s.config, seed)
    return g, make_pool(g, s.mix, seed, n)


@pytest.mark.parametrize("name", tiny.RUNS)
def test_same_seed_same_inputs(name):
    g1, p1 = _make(BIG, name)
    g2, p2 = _make(BIG, name)
    assert np.array_equal(g1.codes, g2.codes)
    for f in ("codes", "quals", "pos", "minus", "repeat", "indel"):
        assert np.array_equal(getattr(p1, f), getattr(p2, f))


def test_two_seeds_differ_with_the_same_amounts():
    g1, p1 = _make(BIG)
    g2, p2 = _make(BIG + 1)
    assert not np.array_equal(g1.codes, g2.codes)
    assert not np.array_equal(p1.codes, p2.codes)
    assert p1.repeat.sum() == p2.repeat.sum() == 128
    _, q1 = _make(5, "sam-indel")
    _, q2 = _make(6, "sam-indel")
    assert q1.indel.sum() == q2.indel.sum() == round(512 * 0.1)


def test_reads_copy_their_truth():
    g, p = _make(BIG, "ecoli-k12-100bp.sam-unique", n=256, sub_rate=0.0)
    comp = np.array([3, 2, 1, 0], np.int8)
    for i in range(p.n):
        frag = g.codes[p.pos[i]:p.pos[i] + p.read_len]
        want = comp[frag][::-1] if p.minus[i] else frag
        assert np.array_equal(p.codes[i], want)


def test_repeat_reads_lie_inside_a_family_copy():
    g, p = _make(BIG)
    starts = np.concatenate(g.spots)
    for pos in p.pos[p.repeat]:
        off = pos - starts
        assert ((off >= 0) & (off + p.read_len <= g.unit_len)).any()


def test_fastq_reaches_the_port_as_made(tmp_path):
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.io.fastq import batch_reads_native
    from gnumap_tpu_torch.utils.sim import parse_truth
    g, p = _make(BIG, "sam-indel", n=300)
    path = str(tmp_path / "pool.fastq")
    nbytes = write_fastq(p, g.contig, path)
    assert nbytes == (tmp_path / "pool.fastq").stat().st_size
    cfg = MapperConfig(mer_size=10, batch_size=128, max_read_len=104)
    batches = list(batch_reads_native(path, cfg))
    assert [b.n for b in batches] == [128, 128, 44]
    names = [n for b in batches for n in b.names]
    assert names == [r.tobytes().decode() for r in read_names(p, g.contig)]
    codes = np.concatenate([b.codes[:b.n, :100] for b in batches])
    quals = np.concatenate([b.quals[:b.n, :100] for b in batches])
    assert np.array_equal(codes, p.codes)
    assert np.array_equal(quals, p.quals)
    for i, n in enumerate(names):
        contig, pos, strand = parse_truth(n)
        assert (contig, pos, strand == "-") == (g.contig, p.pos[i],
                                                p.minus[i])
