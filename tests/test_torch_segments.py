"""The port's genome segments (gnumap_tpu_torch/dist/segments.py, built on
TorchMapper) held to the JAX package's (gnumap_tpu/dist/segments.py) and to
the unsegmented port, each test of tests/test_segments.py mirrored, plus the
metadata-only split past int32 of tests/test_config5.py, on the CPU.

Every comparison is exact: hits in global int64 coordinates with
union-renormalised weights (strand, pos, score, CIGAR, ref_len, weight),
SAM bodies and SGR bytes."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from gnumap_tpu.cli import main as jcli
from gnumap_tpu.dist import segments
from gnumap_tpu.index import builder
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.pipeline import mapper as jm
from gnumap_tpu.utils import sim
from gnumap_tpu_torch.cli import main as tcli
from gnumap_tpu_torch.dist import segments as tseg
from gnumap_tpu_torch.pipeline import mapper as tm

from conftest import records_from_sim
from test_torch_bridge import port_iter, to_port

torch.set_num_threads(1)


def _hits(out):
    return [[(h.strand, h.pos, h.score, h.cigar, h.ref_len, h.weight)
             for h in hits] for hits in out]


@pytest.fixture(scope="module")
def two_contigs(small_cfg):
    """tests/test_segments.py's genome: two contigs sharing a repeat, so
    some reads multi-map across the segments, and one batch of reads."""
    gA = sim.random_genome(2500, seed=41)
    gB = sim.random_genome(2500, seed=42)
    gB = gB[:800] + gA[300:420] + gB[920:]
    contigs = [("cA", gA), ("cB", gB)]
    reads = (sim.simulate_reads(gA, 20, 36, seed=43, sub_rate=0.0,
                                contig="cA")
             + sim.simulate_reads(gB, 20, 36, seed=44, sub_rate=0.0,
                                  contig="cB"))
    batch = next(io_fastq.batch_reads(
        iter(records_from_sim(reads, small_cfg)), small_cfg))
    return contigs, batch


def test_segmented_equals_whole(small_cfg, two_contigs):
    """tests/test_segments.py:14: SegmentedMapper's union hits equal the
    JAX SegmentedMapper's, and, as (contig, offset) sets, the unsegmented
    port's; some reads multi-map across segments."""
    contigs, batch = two_contigs
    tcfg = to_port(small_cfg)
    whole_gen = builder.Genome.from_contigs(contigs)
    whole = tm.TorchMapper(*to_port((whole_gen, builder.build_index(
        whole_gen, small_cfg))), tcfg, device="cpu")
    groups = [[c] for c in contigs]
    seg = tseg.SegmentedMapper(groups, tcfg, device="cpu")
    assert seg.n_segments == 2
    jseg = segments.SegmentedMapper(groups, small_cfg)
    tb = to_port(batch)
    seg_hits = seg.map_batch(tb)
    assert [[(h.segment, h.strand, h.pos, h.score, h.weight, h.cigar,
              h.ref_len) for h in hh] for hh in seg_hits] == \
        [[(h.segment, h.strand, h.pos, h.score, h.weight, h.cigar,
           h.ref_len) for h in hh] for hh in jseg.map_batch(batch)]
    whole_hits = whole.map_batch(tb)
    saw_cross = False
    for b in range(batch.n):
        wset = sorted((whole_gen.names[int(whole_gen.locate(h.pos)[0])],
                       int(whole_gen.locate(h.pos)[1]), h.strand, h.score,
                       round(h.weight, 10), h.cigar) for h in whole_hits[b])
        sset = sorted(seg.locate(h) + (h.strand, h.score,
                                       round(h.weight, 10), h.cigar)
                      for h in seg_hits[b])
        assert wset == sset, batch.names[b]
        saw_cross |= len({h.segment for h in seg_hits[b]}) > 1
    assert saw_cross
    cov = seg.accumulate_coverage(seg_hits)
    assert [len(c) for c in cov] == [len(m.genome.codes)
                                     for m in seg.mappers]
    assert sum(c.sum() for c in cov) > 0


def test_split_contigs():
    """tests/test_segments.py:50, and the port's split equals the JAX
    package's on other limits."""
    contigs = [("a", "A" * 100), ("b", "C" * 100), ("c", "G" * 100)]
    assert [len(g) for g in tseg.split_contigs(contigs, max_bases=150)] == \
        [1, 1, 1]
    assert [[n for n, _ in g] for g in tseg.split_contigs(
        contigs, max_bases=250)] == [["a", "b"], ["c"]]
    for mb in (100, 199, 200, 300, 1000):
        assert tseg.split_contigs(contigs, mb) == \
            segments.split_contigs(contigs, mb)
    with pytest.raises(ValueError, match="alone exceeds"):
        tseg.split_contigs(contigs, max_bases=99)


@pytest.mark.parametrize("finish_impl", ["device", "host"])
def test_global_segmented_equals_whole(small_cfg, two_contigs, finish_impl):
    """tests/test_segments.py:58: GlobalSegmentedMapper's global-coordinate
    hits equal the unsegmented port's and the JAX GlobalSegmentedMapper's
    exactly; stats add up across segments."""
    contigs, batch = two_contigs
    tcfg = to_port(small_cfg)
    whole_gen = builder.Genome.from_contigs(contigs)
    tgen = to_port(whole_gen)
    whole = tm.TorchMapper(tgen, to_port(builder.build_index(
        whole_gen, small_cfg)), tcfg, device="cpu", finish_impl=finish_impl)
    seg = tseg.GlobalSegmentedMapper(tgen, tcfg, device="cpu", n_segments=2,
                                     finish_impl=finish_impl)
    assert seg.n_segments == 2 and seg.bases[0] == 0
    assert seg.mappers[1].genome.codes.base is not None   # a view
    assert (seg.accumulate, str(seg.device)) == ("host", "cpu")
    jseg = segments.GlobalSegmentedMapper(whole_gen, small_cfg,
                                          n_segments=2)
    tb = to_port(batch)
    stats, wstats = tm.BatchStats(), tm.BatchStats()
    got = seg.finish(tb, seg.submit(tb), stats)
    want = whole.map_batch(tb, wstats)
    assert _hits(got) == _hits(want) == _hits(jseg.map_batch(batch))
    assert stats.n_reads == batch.n
    for f in ("n_mapped", "n_multi", "n_candidates", "dp_cells"):
        assert getattr(stats, f) == getattr(wstats, f), f
    assert any(len({h.pos < seg.bases[1] for h in hh}) > 1 for hh in got)
    assert all(isinstance(h.pos, int) for hh in got for h in hh)


def test_global_segmented_map_stream_bisulfite():
    """map_stream through GlobalSegmentedMapper in bisulfite mode (each
    segment builds its own collapsed CSR pair): SAM records and coverage
    equal the unsegmented port's and the JAX package's segmented run."""
    from gnumap_tpu.config import MapperConfig
    cfg = MapperConfig(mer_size=8, seed_jump=3, batch_size=32,
                       max_read_len=40, align_score_ratio=0.7,
                       bisulfite=True)
    gA, gB = (sim.random_genome(3000, seed=s) for s in (61, 62))
    gen = builder.Genome.from_contigs([("cA", gA), ("cB", gB)])
    reads = (sim.simulate_reads(gA, 40, 36, seed=63, contig="cA",
                                bisulfite=True)
             + sim.simulate_reads(gB, 40, 36, seed=64, contig="cB",
                                  bisulfite=True))
    recs = records_from_sim(reads, cfg)
    tcfg, tgen = to_port((cfg, gen))

    def run(m, mod, port):
        bs = io_fastq.batch_reads(iter(recs), cfg)
        return mod.map_stream(m, port_iter(bs) if port else bs)

    seg = run(tseg.GlobalSegmentedMapper(tgen, tcfg, device="cpu",
                                         n_segments=2), tm, True)
    whole = run(tm.TorchMapper(tgen, to_port(builder.build_bs_index(
        gen, cfg)), tcfg, device="cpu"), tm, True)
    ref = run(segments.GlobalSegmentedMapper(gen, cfg, n_segments=2), jm,
              False)
    assert seg.sam_lines == whole.sam_lines == ref.sam_lines
    assert np.array_equal(seg.coverage, whole.coverage)
    assert np.array_equal(seg.coverage, ref.coverage)
    assert seg.stats.n_mapped == ref.stats.n_mapped >= 70


def test_segmented_cli_matches_unsegmented(tmp_path):
    """tests/test_segments.py:99: the port's CLI with --segments 2 writes
    the SAM body and SGR bytes of its unsegmented run and of the JAX CLI's
    --segments 2 run; the done line counts 2 segments."""
    gA = sim.random_genome(6000, seed=51)
    gB = sim.random_genome(6000, seed=52)
    sim.write_fasta(str(tmp_path / "g.fa"), [("cA", gA), ("cB", gB)])
    reads = (sim.simulate_reads(gA, 40, 36, seed=53, contig="cA")
             + sim.simulate_reads(gB, 40, 36, seed=54, contig="cB"))
    sim.write_fastq(str(tmp_path / "r.fq"), reads)
    common = ["-g", str(tmp_path / "g.fa"), str(tmp_path / "r.fq"),
              "-m", "8", "-j", "4", "-L", "40", "-B", "32"]
    runs = {}
    for name, main, extra in (
            ("whole", tcli.main, ["--device", "cpu"]),
            ("segd", tcli.main, ["--device", "cpu", "--segments", "2"]),
            ("jax", jcli.main, ["--segments", "2"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["-o", str(tmp_path / name)] + common + extra) == 0
        done = json.loads(buf.getvalue().splitlines()[-1])
        runs[name] = ([x for x in open(tmp_path / f"{name}.sam")
                       if not x.startswith("@PG")],
                      (tmp_path / f"{name}.sgr").read_bytes(),
                      done["segments"])
    assert runs["whole"][:2] == runs["segd"][:2] == runs["jax"][:2]
    assert [r[2] for r in runs.values()] == [1, 2, 2]
    assert len(runs["segd"][0]) > 80


def test_segment_bounds_past_int32():
    """tests/test_config5.py:107: the metadata-only auto split of a
    2.5 G-base genome (no giant arrays) equals the JAX package's, each
    segment under SEG_LIMIT."""
    class _G:
        codes = range(2_500_000_192)         # len() only
        names = ["c1", "c2", "c3"]
        starts = np.array([0, 1_100_000_064, 2_000_000_128], np.int64)
        lengths = np.array([1_100_000_000, 899_999_936, 500_000_000],
                           np.int64)
    bounds = tseg.segment_bounds(_G)
    assert bounds == segments.segment_bounds(_G)
    assert tseg.SEG_LIMIT == segments.SEG_LIMIT
    ends = list(_G.starts[1:]) + [len(_G.codes)]
    sizes = [ends[hi - 1] - _G.starts[lo] for lo, hi in bounds]
    assert len(bounds) >= 2
    assert all(s <= tseg.SEG_LIMIT for s in sizes)
    assert bounds[0][0] == 0 and bounds[-1][1] == 3
    for n in (1, 2, 3, 5):
        assert tseg.segment_bounds(_G, n_segments=n) == \
            segments.segment_bounds(_G, n_segments=n)


def test_global_segmented_refuses_unported_modes(small_cfg, two_contigs):
    """mesh= and num_hosts= are taken.  A mesh (here a world of one rank)
    maps every segment through a DistMapper, equal to the segments on
    TorchMapper; the mesh's refusals reach through (max_candidates must
    divide by 8 * index_shards).  num_hosts > 1 needs a process group of
    that many ranks, and host_id a rank in it (the two-process runs are in
    tests/test_torch_multihost.py)."""
    import dataclasses
    from gnumap_tpu_torch.dist import collectives, mesh as tmesh
    contigs, batch = two_contigs
    tgen = to_port(builder.Genome.from_contigs(contigs))
    tcfg = to_port(small_cfg)
    mesh = tmesh.make_mesh(device="cpu")
    on_mesh = tseg.GlobalSegmentedMapper(tgen, tcfg, n_segments=2, mesh=mesh)
    assert on_mesh.n_segments == 2 and on_mesh.device == mesh.device
    assert all(isinstance(m, collectives.DistMapper)
               for m in on_mesh.mappers)
    plain = tseg.GlobalSegmentedMapper(tgen, tcfg, device="cpu",
                                       n_segments=2)
    stats = tm.BatchStats()
    got = on_mesh.map_batch(to_port(batch), stats)
    assert _hits(got) == _hits(plain.map_batch(to_port(batch)))
    assert stats.n_mapped == sum(1 for h in got if h) > 0
    three = dataclasses.replace(mesh, shape={"reads": 1, "index": 3})
    with pytest.raises(ValueError, match="8\\*index_shards"):
        tseg.GlobalSegmentedMapper(tgen, tcfg, n_segments=2, mesh=three)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        tseg.GlobalSegmentedMapper(tgen, tcfg, device="cpu", num_hosts=2)
    with pytest.raises(ValueError, match="host_id 2 not in"):
        tseg.GlobalSegmentedMapper(tgen, tcfg, device="cpu", num_hosts=2,
                                   host_id=2)
