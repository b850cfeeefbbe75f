"""The port's scale tools (tools/torch_scale_run.py, tools/torch_scale3g.py)
held to the reference's (tools/scale_run.py, tools/scale3g.py); the segment
split of a genome past int32 addressing; chip_smoke.build_workload held to
bench.build_workload at config 3; and the one read that bench configs 3 and 5
map wrongly, mapped by both packages on a genome cut down to its loci."""

import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from gnumap_tpu.cli import main as jcli
from gnumap_tpu.config import MapperConfig
from gnumap_tpu.dist import segments
from gnumap_tpu.index import builder
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.pipeline import mapper as jm
from gnumap_tpu.utils import sim
from gnumap_tpu_torch.cli import main as tcli
from gnumap_tpu_torch.dist import segments as tseg
from gnumap_tpu_torch.oracle import oracle
from gnumap_tpu_torch.pipeline import mapper as tm

from conftest import records_from_sim
from test_torch_bridge import to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from tools import scale3g, scale_run  # noqa: E402
from tools import torch_scale3g, torch_scale_run  # noqa: E402

torch.set_num_threads(2)


def _files(paths):
    return [open(p, "rb").read() for p in paths]


def test_scale_run_workload_equals_reference(tmp_path):
    """torch_scale_run.gen_workload writes scale_run.gen_workload's FASTA
    and FASTQ bytes: 2,000 reads on a 50 kbp genome."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = scale_run.gen_workload(str(tmp_path / "ref"), 2000, 50_000, 100)
    port = torch_scale_run.gen_workload(str(tmp_path / "port"), 2000,
                                        50_000, 100)
    assert _files(port) == _files(ref)
    assert _files(ref)[1].count(b"\n") == 4 * 2000


def test_scale_run_e2e3748_workload(tmp_path):
    """torch_scale_run.gen_workload(generator="e2e3748") writes what
    tools/scale_run.py's generator wrote at commit e2e3748, whose output
    SCALE_1M.json records (233,649,696 FASTQ bytes at 1M reads): the sha256
    of that generator's FASTQ at 2,000 reads on a 50 kbp genome, and the
    same genome as the current generator."""
    import hashlib
    fa, fq = torch_scale_run.gen_workload(str(tmp_path), 2000, 50_000, 100,
                                          "e2e3748")
    with open(fq, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == (
            "4b7269f5f757662cc350e106420d3533868b5e35250d45d61908633487193c64")
    (tmp_path / "ref").mkdir()
    ref = scale_run.gen_workload(str(tmp_path / "ref"), 10, 50_000, 100)
    assert _files([fa]) == _files(ref[:1])
    assert torch_scale_run.count_fastq(fq) == 2000
    assert torch_scale_run.count_fasta(fa) == (50_000, 1)


def test_scale_run_reuses_only_the_requested_workload(tmp_path):
    """reuse_or_generate keeps the files in the work directory only for the
    request its manifest records: a smaller request after a larger one, or
    another generator, generates anew."""
    td = str(tmp_path)
    files = (os.path.join(td, "genome.fa"), os.path.join(td, "reads.fq"))
    calls = []

    def run(reads, genome_len, generator="current"):
        req = dict(reads=reads, genome_len=genome_len, read_len=100,
                   generator=generator)

        def gen():
            calls.append(req)
            torch_scale_run.gen_workload(td, reads, genome_len, 100,
                                         generator)
        reused = torch_scale_run.reuse_or_generate(td, req, files, gen)
        return (reused, torch_scale_run.count_fastq(files[1]),
                torch_scale_run.count_fasta(files[0])[0])

    assert run(3000, 60_000) == (False, 3000, 60_000)
    assert run(1000, 50_000) == (False, 1000, 50_000)
    assert run(1000, 50_000) == (True, 1000, 50_000)
    assert run(1000, 50_000, "e2e3748") == (False, 1000, 50_000)
    with open(files[1], "ab") as f:
        f.write(b"@x\nA\n+\nI\n")
    assert run(1000, 50_000, "e2e3748") == (False, 1000, 50_000)
    assert len(calls) == 4


def test_sam_accuracy_of_unmapped_reads_is_zero(tmp_path):
    """chip_smoke.sam_accuracy: a SAM in which every read is unmapped reads
    accuracy 0 (and mapped 0), so the phases' accuracy gates fail on it;
    one right and one wrong mapped read read 0.5."""
    sam = tmp_path / "u.sam"
    names = ["sim_0_ref_sim_100_+", "sim_1_ref_sim_200_-"]
    sam.write_text("@HD\tVN:1.6\n" + "".join(
        f"{n}\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n" for n in names))
    assert chip_smoke.sam_accuracy(str(sam)) == (2, 0, 0.0)
    sam.write_text(
        f"{names[0]}\t0\tref_sim\t101\t60\t4M\t*\t0\t0\tACGT\tIIII"
        "\tXP:f:1.0\n"
        f"{names[1]}\t0\tref_sim\t201\t60\t4M\t*\t0\t0\tACGT\tIIII"
        "\tXP:f:1.0\n")
    assert chip_smoke.sam_accuracy(str(sam)) == (2, 2, 0.5)
    assert chip_smoke.sam_truth(str(sam))[2] == [names[1]]


@pytest.fixture(scope="module")
def four_contigs(tmp_path_factory):
    """tools/torch_scale3g.py's genome and reads at a small size: 4
    contigs of 50 kbp, 2,000 reads."""
    td = tmp_path_factory.mktemp("scale3g")
    fa, fq = str(td / "g.fa"), str(td / "r.fq")
    lens = torch_scale3g.gen_genome(fa, 200_000, 4)
    torch_scale3g.gen_reads(fa, fq, lens, 2000, 100)
    return td, fa, fq, lens


def test_scale3g_workload_equals_reference(four_contigs, tmp_path):
    """torch_scale3g's gen_genome and gen_reads write scale3g's FASTA and
    FASTQ bytes and contig lengths."""
    _, fa, fq, lens = four_contigs
    ra, rq = str(tmp_path / "g.fa"), str(tmp_path / "r.fq")
    assert scale3g.gen_genome(ra, 200_000, 4) == lens == [50_000] * 4
    scale3g.gen_reads(ra, rq, lens, 2000, 100)
    assert _files([fa, fq]) == _files([ra, rq])


def test_scale3g_cli_equals_jax(four_contigs):
    """The port's CLI on the CPU with torch_scale3g's flags (-m 13 -k 64
    --segments 2 --no-sgr) on every fourth read of the 4-contig set writes
    the JAX CLI's SAM body, and every primary record is right by the tool's
    count."""
    td, fa, fq, _ = four_contigs
    with open(fq) as f:
        lines = f.readlines()
    fq = str(td / "r500.fq")
    with open(fq, "w") as f:
        f.writelines(x for i, x in enumerate(lines) if i // 4 % 4 == 0)
    flags = ["-m", "13", "-j", "5", "-L", "104", "-B", "256", "-q", "32",
             "-k", "64", "--segments", "2", "--no-sgr"]
    runs = {}
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["-g", fa, fq, "-o", str(td / name)] + flags
                        + extra) == 0
        done = json.loads(buf.getvalue().splitlines()[-1])
        runs[name] = ([x for x in open(td / f"{name}.sam")
                       if not x.startswith("@PG")], done["segments"],
                      done["mapped"])
    assert runs["port"] == runs["jax"]
    assert runs["port"][1] == 2 and runs["port"][2] > 480
    ok, tot = torch_scale3g.primary_accuracy(str(td / "port.sam"))
    assert ok == tot == runs["port"][2]


def test_segment_split_of_26_contigs_under_seg_limit():
    """torch_scale3g's default genome, 26 contigs of 100 Mbp (2.6e9 bases
    and their N spacers, past 2^31), built from its lengths alone: the
    --segments 2 split and the automatic one keep every segment, and so
    every segment-local position the mapper packs into its int64 keys,
    under SEG_LIMIT < 2^31, and equal the JAX package's splits."""
    lens = [100_000_000] * 26
    starts = np.cumsum([0] + [n + builder.SPACER_N for n in lens[:-1]])
    total = int(starts[-1]) + lens[-1] + builder.SPACER_N
    gen = builder.Genome(np.broadcast_to(np.int8(4), (total,)),
                         [f"ctg{i:02d}" for i in range(26)],
                         starts.astype(np.int64), np.asarray(lens, np.int64))
    assert total > 1 << 31
    assert tseg.SEG_LIMIT == segments.SEG_LIMIT < 1 << 31
    ends = np.append(gen.starts[1:], total)
    for n in (2, 0):
        bounds = tseg.segment_bounds(to_port(gen), n_segments=n)
        assert bounds == segments.segment_bounds(gen, n_segments=n)
        sizes = [int(ends[hi - 1] - gen.starts[lo]) for lo, hi in bounds]
        assert sum(sizes) == total and len(bounds) == 2
        assert max(sizes) <= tseg.SEG_LIMIT
    assert tseg.segment_bounds(to_port(gen), n_segments=2) == [(0, 13),
                                                              (13, 26)]


def test_build_config3_equals_bench_workload():
    """chip_smoke.build_workload(config=3), as map_cfg3 calls it, builds
    bench.build_workload(config=3)'s config, genome, index and reads (a 300
    kbp genome, 300 reads)."""
    cfg, gen, idx, recs = bench.build_workload(300, 300_000, 8192, config=3)
    tcfg, tgen, tidx, trecs = chip_smoke.build_workload(300, 300_000, 0,
                                                        config=3)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert np.array_equal(tgen.codes, gen.codes)
    assert (tgen.names, list(tgen.starts)) == (gen.names, list(gen.starts))
    assert np.array_equal(tidx.bucket_start, idx.bucket_start)
    assert np.array_equal(tidx.positions, idx.positions)
    assert [r.name for r in trecs] == [r.name for r in recs]
    for a, b in zip(trecs, recs):
        assert np.array_equal(a.codes, b.codes)
        assert np.array_equal(a.quals, b.quals)
        assert a.pwm_q is None and b.pwm_q is None


# ROADMAP C.4: the read of bench configs 3 and 5 whose truth is never a
# candidate.  It covers bases 406-505 of a copy of the 500 bp repeat unit
# (1,868 copies); the anchors of its seeds: the truth, the seven loci that
# its last seed (read bases 85-97, a sequencing error at 97) hits, and the
# unrelated hits of the seeds that hold its error at base 25.
C4_READ = 3473
C4_TRUTH = 13_817_925
C4_SEED85 = (540_533, 15_039_246, 20_210_440, 24_105_983, 30_357_810,
             39_438_021, 43_399_877)
C4_OTHER = (39_214_239, 4_669_357, 43_828_879)
C4_WINNERS = (540_533, 15_039_246, 24_105_983, 30_357_810, 39_438_021,
              43_399_877)


def test_config3_wrong_read_is_the_reference_record():
    """The read sim_3473 of bench config 3 on a genome of 300-base windows
    cut from config 3's genome around each anchor its seeds reach, plus
    three more copies of the unit, so that its unit seeds still hit more
    than max_hits (8) loci: the JAX mapper and the port give the same
    record, exactly: the six 100M hits of the config-3 run (scores
    24,536,064 and 24,536,192), not the truth, which no seed anchors,
    though the oracle scores it above every hit (25,060,864)."""
    genome = sim.random_genome(bench.CONFIGS[3]["genome_len"], seed=0,
                               repeat_frac=0.02)
    read = sim.simulate_reads(genome, C4_READ + 1, 100, seed=7,
                              sub_rate=0.01, contig="ref_sim")[-1]
    assert read.name == f"sim_{C4_READ}_ref_sim_{C4_TRUTH}_-"
    unit = genome[C4_TRUTH + 10:C4_TRUTH + 60]    # inside the unit
    extra, at = [], 0
    while len(extra) < 3:
        at = genome.index(unit, at + 1)
        if all(abs(at - 10 - a) > 500 for a in (C4_TRUTH,) + C4_SEED85):
            extra.append(at - 10)
    anchors = (C4_TRUTH,) + C4_SEED85 + C4_OTHER + tuple(extra)
    # window starts on a multiple of 4 and contigs of 300 bases after
    # 64-base spacers keep each anchor's window alignment
    contigs = [(f"w{a}", genome[a // 4 * 4 - 100:a // 4 * 4 + 200])
               for a in anchors]
    cfg = MapperConfig(mer_size=13, seed_jump=5, batch_size=8,
                       max_read_len=104, max_candidates=32,
                       max_hits_per_seed=8, hit_capacity=1)
    gen = builder.Genome.from_contigs(contigs)
    idx = builder.build_index(gen, cfg)
    batch = next(io_fastq.batch_reads(iter(records_from_sim([read], cfg)),
                                      cfg))

    def fields(hits):
        return [(h.strand, gen.names[int(gen.locate(h.pos)[0])],
                 int(gen.locate(h.pos)[1]), h.score, h.cigar, h.ref_len,
                 h.weight) for h in hits[0]]

    want = fields(jm.TpuMapper(gen, idx, cfg).map_batch(batch))
    for finish in ("device", "host"):
        hits = tm.TorchMapper(*to_port((gen, idx, cfg)), device="cpu",
                              finish_impl=finish).map_batch(to_port(batch))
        assert fields(hits) == want
    # chip_smoke's copy of bench.py's rule counts it wrong, with two hits
    # of the largest weight
    assert chip_smoke.bench_account(to_port(gen), [batch], [hits]) == (
        1, 0.0, [read.name])
    assert [(c, p, s) for _, c, p, s, *_ in want] == [
        (f"w{a}", a - a // 4 * 4 + 100, s) for a, s in zip(
            C4_WINNERS, (24_536_064,) * 4 + (24_536_192,) * 2)]
    assert all(h[0] == "-" and h[4] == "100M" for h in want)
    # the truth would win: the oracle's scores at the anchors
    from gnumap_tpu_torch.align import scoring
    from gnumap_tpu_torch.core import packing, pwm
    tcfg = to_port(cfg)
    codes = packing.encode(read.seq)
    q = np.frombuffer(read.qual.encode(), np.uint8).astype(np.int32) - 33
    emis = scoring.emission_int(
        pwm.pwm_revcomp(pwm.pwm_from_calls(codes, q)),
        scoring.matrices_for_mode(tcfg)[1])
    g = packing.encode(genome)

    def score(a):
        ws = tcfg.window_start(a)
        return oracle.nw_align(emis, g[ws:ws + tcfg.window_width()], tcfg)
    assert score(C4_TRUTH) == 25_060_864
    assert [score(a) for a in C4_WINNERS] == [h[3] for h in want]
