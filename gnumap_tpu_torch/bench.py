"""Benchmark driver of the PyTorch port: the counterpart of the reference's
``bench.py``.  Prints one JSON line per config of the workload ladder and,
last, one headline line with the reference's keys.

    python -m gnumap_tpu_torch.bench                 # the whole ladder, card
    python -m gnumap_tpu_torch.bench --config 2      # the headline config
    python -m gnumap_tpu_torch.bench --device cpu --config 2 --reads 256 \\
        --no-baseline                                # the plain versions

Metric (BASELINE.json:2): reads aligned per second on one device, 100 bp
reads against an E.coli-scale reference, plus DP cell updates per second.
Each config is mapped after a warm-up (the first batch, then re-timed until
two timings agree within 5%, at most 8 times) with ``--depth`` batches in
flight; the headline config runs 3 repeats and reports the best, with every
repeat's wall time beside it (``wall_s_repeats``).  Truth accuracy is
counted outside the timed section.

Besides the ladder the headline line carries
  * ``vs_baseline``: the headline rate over the same workload (at most 512
    reads) on the port's plain torch versions on the host CPU, measured by
    this module in a subprocess (``--cpu-baseline``) and cached in the
    temporary directory;
  * ``kernel_bitcheck``: B1 scores and B3 tracebacks (ops, j_final) of 64
    reads, half with 1-2 bp indels, held to ``oracle.nw_align``; B2's pure
    verdicts held to the oracle's all-M alignments; device PWMs and reverse
    complements held to the host tables.  On the card it runs the CUDA
    kernels, on the CPU their plain versions;
  * ``profile``: per-stage device times of one headline batch (on the card:
    CUDA events behind a spin kernel, median of ``PROFILE_REPS``), each
    stage the difference of two cumulative prefixes of the device program,
    with ``sum_of_stages_ms`` beside the time of the mapper's own submit.

No fallback hides a fault: a config, the bit check or the profile that
fails is recorded on its line and makes the exit code 1.  ``--device cuda``
(the default) raises without a card; a kernel that does not build or
launch is an error.  ``--reference BENCH_r05.json`` holds every config's
mapped, multi-mapped and accuracy to the reference's recorded ladder.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import deque

import numpy as np
import torch

BENCH_READS_CPU = 512
PROFILE_REPS = 10

# BASELINE.json:7-11 workload ladder, the reference's bench.py:35-102
CONFIGS = {
    1: dict(name="phiX 10k x 36bp exact-seed",
            genome_len=5_386, n_reads=10_000, read_len=36, mer=8, jump=4,
            max_read_len=40, repeat_frac=0.0, bisulfite=False),
    # batch 16384 = the whole headline workload in ONE device batch
    2: dict(name="E.coli-scale 100bp probabilistic NW",
            genome_len=4_641_652, n_reads=16_384, read_len=100, mer=12,
            jump=5, max_read_len=104, repeat_frac=0.0, bisulfite=False,
            batch=16_384),
    3: dict(name="chr21-scale multi-map posterior",
            genome_len=46_709_983, n_reads=16_384, read_len=100, mer=13,
            jump=5, max_read_len=104, repeat_frac=0.02, bisulfite=False),
    4: dict(name="chr21-scale bisulfite",
            genome_len=46_709_983, n_reads=16_384, read_len=100, mer=16,
            jump=5, max_read_len=104, repeat_frac=0.0, bisulfite=True),
    # config 3 through the full map_stream (coverage + per-base tallies)
    5: dict(name="chr21-scale SNP mode (map_stream incl. tallies)",
            genome_len=46_709_983, n_reads=16_384, read_len=100, mer=13,
            jump=5, max_read_len=104, repeat_frac=0.02, bisulfite=False,
            snp=True),
    6: dict(name="E.coli-scale FM-index backend",
            genome_len=4_641_652, n_reads=16_384, read_len=100, mer=12,
            jump=5, max_read_len=104, repeat_frac=0.0, bisulfite=False,
            index="fm"),
    7: dict(name="chr21-scale segmented genome (2 segments)",
            genome_len=46_709_983, n_reads=16_384, read_len=100, mer=13,
            jump=5, max_read_len=104, repeat_frac=0.02, bisulfite=False,
            segments=2),
    # 40 repeat families x 20 copies, 25% of the reads inside a copy
    8: dict(name="chr21-scale multi-map stress (40 families x 20 copies)",
            genome_len=46_709_983, n_reads=16_384, read_len=100, mer=13,
            jump=5, max_read_len=104, repeat_frac=0.0, bisulfite=False,
            families=(40, 20, 300), repeat_read_frac=0.25,
            max_hits=24, hit_capacity=8),
    # config 2 through the full map_stream with SAM written to disk, plus a
    # timed --sort-sam pass
    9: dict(name="E.coli-scale end-to-end SAM stream (outputs on)",
            genome_len=4_641_652, n_reads=16_384, read_len=100, mer=12,
            jump=5, max_read_len=104, repeat_frac=0.0, bisulfite=False,
            sam_stream=True),
    # config 8 in SNP mode with both accumulation paths; the recorded value
    # is the host path's
    10: dict(name="SNP clustered-pileup accumulate A/B (host vs device)",
             genome_len=46_709_983, n_reads=16_384, read_len=100, mer=13,
             jump=5, max_read_len=104, repeat_frac=0.0, bisulfite=False,
             families=(40, 20, 300), repeat_read_frac=0.25,
             max_hits=24, hit_capacity=8, snp=True, accum_ab=True),
}


def build_workload(n_reads, genome_len, batch_size, config=2):
    """(cfg, genome, index, read records) of a ladder config, equal to the
    reference's build_workload: the same genome, contigs, reads and
    records.  The segmented config returns index None (each segment's
    index is built by GlobalSegmentedMapper)."""
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.core import packing
    from gnumap_tpu_torch.index import builder
    from gnumap_tpu_torch.io import fastq as io_fastq
    from gnumap_tpu_torch.utils import sim

    c = CONFIGS[config]
    genome_len = genome_len or c["genome_len"]
    n_reads = n_reads or c["n_reads"]
    batch_size = batch_size or c.get("batch", 8192)
    cfg = MapperConfig(mer_size=c["mer"], seed_jump=c["jump"],
                       batch_size=batch_size,
                       max_read_len=c["max_read_len"], max_candidates=32,
                       max_hits_per_seed=c.get("max_hits", 8),
                       sam_out=c.get("sam_stream", False), sgr_out=False,
                       bisulfite=c["bisulfite"],
                       snp_mode=c.get("snp", False),
                       hit_capacity=c.get("hit_capacity", 1))
    spots = None
    if c.get("families"):
        nf, cp, ul = c["families"]
        genome, spots = sim.random_genome_families(
            genome_len, seed=0, n_families=nf, copies=cp, unit_len=ul)
    else:
        genome = sim.random_genome(genome_len, seed=0,
                                   repeat_frac=c["repeat_frac"])
    if c.get("segments"):
        # two contigs, so that the segment boundary is contig-aligned; reads
        # are simulated per contig, so that their names carry contig-local
        # truth
        half = genome_len // 2
        gen = builder.Genome.from_contigs(
            [("ref_sim", genome[:half]), ("ref_sim2", genome[half:])])
        idx = None
        reads = (sim.simulate_reads(genome[:half], n_reads // 2,
                                    c["read_len"], seed=7, sub_rate=0.01,
                                    contig="ref_sim",
                                    bisulfite=c["bisulfite"])
                 + sim.simulate_reads(genome[half:], n_reads - n_reads // 2,
                                      c["read_len"], seed=8, sub_rate=0.01,
                                      contig="ref_sim2",
                                      bisulfite=c["bisulfite"]))
    else:
        gen = builder.Genome.from_contigs([("ref_sim", genome)])
        if c.get("index") == "fm":
            from gnumap_tpu_torch.index import fm
            idx = fm.build_fm_index(gen, cfg)
        elif c["bisulfite"]:
            idx = builder.build_bs_index(gen, cfg)
        else:
            idx = builder.build_index(gen, cfg)
        if spots is not None and c.get("repeat_read_frac"):
            # repeat_read_frac of the reads lie wholly inside a family
            # copy, so that every copy is a co-best locus
            n_rep = int(n_reads * c["repeat_read_frac"])
            ul = c["families"][2]
            allspots = np.concatenate(spots)
            starts = (allspots[:, None] + np.arange(
                0, ul - c["read_len"], 25)[None, :]).ravel()
            reads = (sim.simulate_reads(genome, n_reads - n_rep,
                                        c["read_len"], seed=7,
                                        sub_rate=0.01, contig="ref_sim")
                     + sim.simulate_reads(genome, n_rep, c["read_len"],
                                          seed=9, sub_rate=0.01,
                                          contig="ref_sim",
                                          positions=starts))
        else:
            reads = sim.simulate_reads(genome, n_reads, c["read_len"],
                                       seed=7, sub_rate=0.01,
                                       contig="ref_sim",
                                       bisulfite=c["bisulfite"])
    recs = []
    for r in reads:
        codes = packing.encode(r.seq)
        q = np.frombuffer(r.qual.encode(), np.uint8).astype(np.int32) - 33
        # the PWM stays lazy: rebuilt on the device from (qual, code), as
        # on the FASTQ path
        recs.append(io_fastq.ReadRecord(r.name, codes, None,
                                        q.astype(np.int16)))
    return cfg, gen, idx, recs


def make_mapper(cfg, gen, idx, device, n_segments=0, accumulate="host"):
    """TorchMapper on ``device``, or GlobalSegmentedMapper with
    ``n_segments`` segments."""
    from gnumap_tpu_torch.pipeline import mapper as pl
    if n_segments:
        from gnumap_tpu_torch.dist.segments import GlobalSegmentedMapper
        return GlobalSegmentedMapper(gen, cfg, device=device,
                                     n_segments=n_segments)
    return pl.TorchMapper(gen, idx, cfg, device=device,
                          accumulate=accumulate)


def warm_up(m, batch):
    """Map ``batch`` once, then re-time it until two consecutive timings
    agree within 5% (at most 8 times), so that a timed run starts from
    steady state: kernels built and loaded, buffers allocated."""
    m.map_batch(batch)
    prev = None
    for _ in range(8):
        t = time.perf_counter()
        m.map_batch(batch)
        cur = time.perf_counter() - t
        if prev is not None and abs(cur - prev) <= 0.05 * max(prev, 1e-9):
            break
        prev = cur


class Truth:
    """The reference's accuracy rule (bench.py run_pipeline's account):
    reads carry (contig, pos, strand) in their names; a mapped read is
    correct when its truth locus is among its co-best weighted hits,
    within 3 bases on the right strand.  Global hit offsets resolve through
    genome.locate, so contig spacers never skew the comparison."""

    def __init__(self, genome):
        self.genome = genome
        self.n_hits = self.n_correct = self.n_primary = 0

    def account(self, batch, hits_per_read):
        from gnumap_tpu_torch.utils.sim import parse_truth
        pos_l, str_l, rid_l, truths = [], [], [], []
        for i, hits in enumerate(hits_per_read):
            self.n_hits += len(hits)
            if not hits:
                continue
            self.n_primary += 1
            truths.append(parse_truth(batch.names[i]))
            best_w = max(h.weight for h in hits)
            for h in hits:
                if h.weight == best_w:
                    pos_l.append(h.pos)
                    str_l.append(h.strand)
                    rid_l.append(len(truths) - 1)
        if not pos_l:
            return
        ci, off = self.genome.locate(np.asarray(pos_l, np.int64))
        ci, off = np.atleast_1d(ci), np.atleast_1d(off)
        ok = np.zeros(len(truths), bool)
        for k in range(len(pos_l)):
            tc, tp, ts = truths[rid_l[k]]
            if (self.genome.names[int(ci[k])] == tc
                    and abs(int(off[k]) - tp) <= 3 and str_l[k] == ts):
                ok[rid_l[k]] = True
        self.n_correct += int(ok.sum())

    @property
    def accuracy(self) -> float:
        return self.n_correct / max(self.n_primary, 1)


@dataclasses.dataclass
class Run:
    """One timed pass: wall seconds, stats, hits and truth accuracy."""
    wall_s: float
    stats: object
    n_hits: int
    accuracy: float


def run_pipeline(cfg, gen, idx, recs, device, depth=3, n_segments=0,
                 repeats=1):
    """submit / finish with ``depth`` batches in flight behind the one
    finished, after the warm-up; truth accounting outside the timed
    section.  Returns (best Run by wall time, every repeat's wall time)."""
    from gnumap_tpu_torch.io import fastq as io_fastq
    from gnumap_tpu_torch.pipeline import mapper as pl

    m = make_mapper(cfg, gen, idx, device, n_segments)
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    warm_up(m, batches[0])

    def run_once():
        stats = pl.BatchStats()
        q = deque()
        collected = []
        t0 = time.perf_counter()
        for b in batches:
            q.append((b, m.submit(b)))
            if len(q) > depth:
                pb, pf = q.popleft()
                collected.append((pb, m.finish(pb, pf, stats)))
        while q:
            pb, pf = q.popleft()
            collected.append((pb, m.finish(pb, pf, stats)))
        dt = time.perf_counter() - t0
        truth = Truth(m.genome)
        for pb, hits in collected:
            truth.account(pb, hits)
        return Run(dt, stats, truth.n_hits, truth.accuracy)

    runs = [run_once() for _ in range(repeats)]
    return min(runs, key=lambda r: r.wall_s), [r.wall_s for r in runs]


def run_stream_snp(cfg, gen, idx, recs, device, acc_impl="host"):
    """SNP mode through the full map_stream (posterior -> coverage + per-base
    tallies), accumulated on the host (native ordered scatter) or on the
    device (``acc_impl`` "device": B5, csrc/accum_rmw.cu).  Returns
    (wall seconds, stats)."""
    from gnumap_tpu_torch.io import fastq as io_fastq
    from gnumap_tpu_torch.pipeline import mapper as pl

    m = make_mapper(cfg, gen, idx, device, accumulate=acc_impl)
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    warm_up(m, batches[0])
    if acc_impl == "device":
        m.reset_accumulators()        # drop the warm-up batches' mass
    t0 = time.perf_counter()
    res = pl.map_stream(m, iter(batches), collect_sam=False)
    dt = time.perf_counter() - t0
    if res.tallies is None or not res.tallies.sum() > 0:
        raise RuntimeError(f"SNP stream ({acc_impl} accumulation) "
                           "accumulated no tallies")
    return dt, res.stats


def run_stream_sam(cfg, gen, idx, recs, device):
    """Outputs on: the full map_stream writing SAM records to disk (header,
    records of every hit, unmapped records), then a timed coordinate sort
    (--sort-sam).  Returns (wall seconds, stats, extra keys)."""
    from gnumap_tpu_torch.io import fastq as io_fastq, sam as sam_io
    from gnumap_tpu_torch.pipeline import mapper as pl

    m = make_mapper(cfg, gen, idx, device)
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    warm_up(m, batches[0])
    with tempfile.TemporaryDirectory() as td:
        sam_path = os.path.join(td, "bench.sam")
        with open(sam_path, "w", encoding="utf-8") as f:
            sam_io.write_header(f, gen.names, gen.lengths, cmd="bench")
            t0 = time.perf_counter()
            res = pl.map_stream(m, iter(batches), collect_sam=False,
                                sam_file=f)
            dt = time.perf_counter() - t0
        sam_bytes = os.path.getsize(sam_path)
        t1 = time.perf_counter()
        sam_io.sort_sam_file(sam_path, gen.names)
        sort_s = time.perf_counter() - t1
    return dt, res.stats, {"sam_bytes": sam_bytes,
                           "sam_sort_s": round(sort_s, 3)}


def _cache_path(config, n_reads, genome_len):
    return os.path.join(
        tempfile.gettempdir(),
        f"gnumap_torch_bench_cpu_baseline.{config}.{n_reads}."
        f"{genome_len}.json")


def cpu_baseline(n_reads, genome_len, config=2):
    """The config's rate on the port's plain torch versions on the host CPU
    (at most BENCH_READS_CPU reads), measured by this module in a
    subprocess so that the measuring process stays clean, and cached in the
    temporary directory.  None (and the subprocess's stderr) if it
    failed."""
    n = min(n_reads or BENCH_READS_CPU, BENCH_READS_CPU)
    cache = _cache_path(config, n, genome_len)
    if not os.path.exists(cache):
        code = subprocess.run(
            [sys.executable, "-m", "gnumap_tpu_torch.bench",
             "--cpu-baseline", "--device", "cpu", "--reads", str(n),
             "--genome-len", str(genome_len), "--config", str(config)],
            capture_output=True, text=True, timeout=3000,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        if code.returncode != 0:
            sys.stderr.write(code.stderr[-2000:])
            return None
    with open(cache) as f:
        return json.load(f)


def _window_of(cfg, g, cand):
    """The genome window of a candidate, N outside the genome."""
    W, G = cfg.window_width(), len(g)
    ws = int(cfg.window_start(int(cand)))
    window = np.full(W, 4, np.int8)
    lo, hi = max(ws, 0), min(ws + W, G)
    if hi > lo:
        window[lo - ws:hi - ws] = g[lo:hi]
    return window


def kernel_bitcheck(device):
    """Kernel-vs-oracle bit equality on ``device`` (the reference's
    kernel_bitcheck): 64 reads from seed 20260819, half with a 1-2 bp indel
    mid-read, three candidates each (the true locus, a random one and one
    17 bases off).  B1 (or B4 without a band) scores every pair, B3 traces
    back every retained pair (ops, j_final), B2 proves the pure ones; each
    is held to oracle.nw_align.  Then the device PWM and the reverse
    complement are held to the host tables.  On a card the CUDA kernels
    run, on the CPU their plain versions.  Returns (ok, n_checked,
    detail)."""
    from gnumap_tpu_torch.align import nw_band, nw_full, nw_pure, nw_tb
    from gnumap_tpu_torch.align import scoring
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.core import packing, pwm as pwm_mod
    from gnumap_tpu_torch.oracle import oracle
    from gnumap_tpu_torch.pipeline import mapper as pl
    from gnumap_tpu_torch.utils import sim

    dev = torch.device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    cfg = MapperConfig(max_read_len=48)
    L, W = cfg.max_read_len, cfg.window_width()
    rng = np.random.default_rng(20260819)
    g = packing.encode(sim.random_genome(6000, seed=5))
    G = len(g)
    S = scoring.normal_matrix(cfg)
    B, C = 64, 8
    emis = np.zeros((B, L, 5), np.int32)
    cands = np.full((B, C), 2**31 - 1, np.int32)
    lens = np.full(B, L, np.int32)
    for b in range(B):
        pos = int(rng.integers(0, G - L - 4))
        frag = g[pos:pos + L].copy()
        if b % 2 == 0:      # 1-2 bp indel mid-read
            p = int(rng.integers(6, L - 8))
            k = int(rng.integers(1, 3))
            if b % 4 == 0:
                frag = np.concatenate([frag[:p], frag[p + k:],
                                       g[pos + L:pos + L + k]])
            else:
                ins = rng.integers(0, 4, size=k).astype(np.int8)
                frag = np.concatenate([frag[:p], ins, frag[p:]])[:L]
        err = rng.random(L) < 0.03
        frag = np.where(err, (frag + 1) % 4, frag).astype(np.int8)
        pq = pwm_mod.pwm_from_calls(frag, rng.integers(10, 41, L))
        emis[b] = scoring.emission_int(pq, S)
        cands[b, 0] = pos                           # the true locus
        cands[b, 1] = int(rng.integers(0, G - L))   # a random locus
        cands[b, 2] = max(-4, pos - 17)             # a locus a bit off
    cands = np.sort(cands, axis=1)
    gt = t(g)
    emis_t = np.ascontiguousarray(emis.transpose(0, 2, 1))
    kw = dict(L=L, W=W, slack=cfg.gap_slack, open_q=cfg.gap_open_q(),
              ext_q=cfg.gap_extend_q())
    band = cfg.band()
    if band is not None:
        got = nw_band.nw_scores_banded(t(emis_t), t(cands), t(lens), gt,
                                       boff=band[0], bw=band[1], **kw)
    else:
        got = nw_full.nw_scores_full(t(emis_t), t(cands), t(lens), gt, **kw)
    got = got.cpu().numpy()
    n_checked = 0
    for b in range(B):
        for c in range(C):
            if cands[b, c] == 2**31 - 1:
                continue
            expect = oracle.nw_align(emis[b], _window_of(cfg, g, cands[b, c]),
                                     cfg)
            n_checked += 1
            if int(got[b, c]) != expect:
                return False, n_checked, (
                    f"score mismatch read {b} cand {c}: "
                    f"{int(got[b, c])} != {expect}")
    # traceback equality on the retained (score > 0) pairs
    keep = [(b, c) for b in range(B) for c in range(C)
            if cands[b, c] != 2**31 - 1 and got[b, c] > 0]
    tb_cands = np.array([cands[b, c] for b, c in keep], np.int32)
    tb_emis = np.ascontiguousarray(
        np.stack([emis[b] for b, _ in keep]).transpose(0, 2, 1))
    tb_lens = np.full(len(keep), L, np.int32)
    ops, jfin = nw_tb.nw_traceback(t(tb_emis), t(tb_cands), t(tb_lens), gt,
                                   band=band, **kw)
    ops, jfin = ops.cpu().numpy(), jfin.cpu().numpy()
    for h, (b, c) in enumerate(keep):
        _, pos_w, cigar, ref_len = oracle.nw_align(
            emis[b], _window_of(cfg, g, cands[b, c]), cfg, traceback=True)
        got_cigar, got_rl = nw_tb.decode_ops(ops[h], L)
        n_checked += 1
        if (int(jfin[h]), got_cigar, got_rl) != (pos_w, cigar, ref_len):
            return False, n_checked, (
                f"traceback mismatch hit {h}: "
                f"({int(jfin[h])},{got_cigar},{got_rl}) != "
                f"({pos_w},{cigar},{ref_len})")
    # [FROZEN v6] pure-diagonal detection on the same retained pairs: every
    # pair it declares pure is an oracle all-M with the oracle's j_final,
    # and it skips at least a quarter of them
    if band is not None:
        tb_scores = np.array([got[b, c] for b, c in keep], np.int32)
        pure, pjf = nw_pure.nw_pure_banded(
            t(tb_emis), t(tb_cands), t(tb_lens), t(tb_scores), gt,
            boff=band[0], bw=band[1], **kw)
        pure, pjf = pure.cpu().numpy(), pjf.cpu().numpy()
        n_pure = 0
        for h, (b, c) in enumerate(keep):
            if not pure[h]:
                continue
            n_pure += 1
            _, pos_w, cigar, _ = oracle.nw_align(
                emis[b], _window_of(cfg, g, cands[b, c]), cfg,
                traceback=True)
            n_checked += 1
            if cigar != f"{L}M" or int(pjf[h]) != pos_w:
                return False, n_checked, (
                    f"pure-detect mismatch hit {h}: jfin {int(pjf[h])} "
                    f"vs oracle ({pos_w}, {cigar})")
        if n_pure < len(keep) // 4:
            return False, n_checked, (
                f"pure-detect skipped too little: {n_pure}/{len(keep)}")
    # the device PWM and reverse complement against the host tables
    Bc, Lc = 64, 37
    codes_c = rng.integers(0, 5, size=(Bc, Lc)).astype(np.int8)
    quals_c = rng.integers(0, 64, size=(Bc, Lc)).astype(np.int16)
    lens_c = rng.integers(Lc // 2, Lc + 1, size=Bc).astype(np.int32)
    pad = np.arange(Lc)[None, :] >= lens_c[:, None]
    codes_c[pad] = 4
    quals_c[pad] = 0
    want_pw = pwm_mod.pwm_rows_from_table(codes_c, quals_c)
    want_pw = np.where(pad[:, :, None], 0, want_pw).astype(np.int32)
    got_pw_t = pl.device_pwm(t(codes_c), t(quals_c), t(lens_c),
                             t(pwm_mod.pwm_table()))
    n_checked += 1
    if not np.array_equal(got_pw_t.cpu().numpy(), want_pw):
        return False, n_checked, "device_pwm != host table lookup"
    rc_c, rc_pw = pl.revcomp_batch(t(codes_c), got_pw_t, t(lens_c))
    rc_c, rc_pw = rc_c.cpu().numpy(), rc_pw.cpu().numpy()
    n_checked += 1
    for b in range(Bc):
        Lr = int(lens_c[b])
        cc = codes_c[b, :Lr]
        want_c = np.where(cc[::-1] < 4, 3 - cc[::-1], 4).astype(np.int8)
        want_p = pwm_mod.pwm_revcomp(want_pw[b, :Lr])
        if not (np.array_equal(rc_c[b, :Lr], want_c)
                and np.array_equal(rc_pw[b, :Lr], want_p)
                and not rc_pw[b, Lr:].any()):
            return False, n_checked, f"revcomp_batch mismatch read {b}"
    return True, n_checked, "ok"


def device_ms(fn, reps, device):
    """Median time of fn() in ms over ``reps`` calls after one warm-up.  On
    a card: CUDA events around fn(), queued behind a spin kernel that
    outlasts twice fn()'s host enqueue time, so that the events time the
    device's work and not the host's launches.  On the CPU: the host
    clock."""
    fn()
    ts = []
    if torch.device(device).type != "cuda":
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return float(np.median(ts))
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t
    torch.cuda.synchronize()
    spin = int(2e6 + 2 * enqueue_s * 2e9)      # cycles, at up to ~2 GHz
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return float(np.median(ts))


PROFILE_KEYS = ("h2d_ms", "strand_ms", "seed_gather_ms", "seed_dedupe_ms",
                "seed_ms", "dp_ms", "tb_retain_ms", "tb_pure_kernel_ms",
                "tb_backwalk_ms", "traceback_ms", "blob_fetch_ms")


def profile_stages(cfg, gen, idx, recs, device, reps=PROFILE_REPS):
    """Per-stage device times of one batch (the reference's
    profile_stages).  Each stage is the difference of two cumulative
    prefixes of the device program, each prefix timed alone (device_ms):

      h2d         the batch's packed reads and lengths uploaded from pinned
                  host memory
      strand      + unpack, PWMs (device_unpack, device_pwm), both strands'
                  codes and emission tables (strand_expand)
      seed_gather + k-mer codes and every seed's index hits
                  (TorchMapper._seed_hits: seed_kmers and csr_hits, or the
                  FM search)
      seed_dedupe + dedupe and cap (TorchMapper._seed, dedupe_cap)
      dp          + the scores of every pair (score_pairs: B1, or B4
                  without a band)
      tb_retain   + threshold and winner compaction (device_retain)
      tb_pure_kernel + B2 (device_pure; 0 when the traceback is not split)
      tb_backwalk + remainder compaction, B3 and the scatter
                  (device_traceback), and the blob (device_tb_tail)
      blob_fetch  + the blob's copy into pinned host memory

    ``seed_ms`` and ``traceback_ms`` are the sums of their two and three
    stages.  ``sum_of_stages_ms`` (h2d through blob_fetch) stands beside
    ``submit_ms``, the mapper's own submit of the same batch (pack, staged
    upload, program, fetch; on a card the program is its captured graph,
    pipeline/graphs.py), and ``submit_eager_ms``, the same submit with the
    program run eagerly, which the eager prefixes telescope to, all timed
    the same way."""
    from gnumap_tpu_torch.io import fastq as io_fastq
    from gnumap_tpu_torch.pipeline import mapper as pl

    m = make_mapper(cfg, gen, idx, device)
    dev = m.device
    st = m.state
    batch = next(io_fastq.batch_reads(iter(recs), cfg))
    pin = dev.type == "cuda"
    packed_h = torch.from_numpy(pl.pack_reads(batch.codes, batch.quals))
    lens_h = torch.from_numpy(np.asarray(batch.lens, np.int32))
    if pin:
        packed_h, lens_h = packed_h.pin_memory(), lens_h.pin_memory()

    def upload():
        return (packed_h.to(dev, non_blocking=pin),
                lens_h.to(dev, non_blocking=pin))

    def h2d():
        p, ln = upload()
        return p.sum() + ln.sum()

    def strand():
        p, ln = upload()
        codes, pwm_q = m._unpack_pwm(p, ln)
        return pl.strand_expand(codes, pwm_q, ln, st["S_plus"],
                                st["S_minus"])

    def gather():
        return m._seed_hits(strand()[0])

    def seed():
        return m._seed(strand()[0])

    def dp():
        p, ln = upload()
        return m._device_map(*m._unpack_pwm(p, ln), ln)

    def retain():
        return pl.device_retain(cfg, *dp())

    def pure():
        rows = retain()
        return rows, pl.device_pure(cfg, rows, st["g_codes"])

    def traceback():
        return m._device_map_tb_q(*upload())

    blob_len = pl.tb_blob_len(cfg, batch.codes.shape[0])
    blob_h = torch.empty(blob_len, dtype=torch.int32, pin_memory=pin)

    def full():
        return blob_h.copy_(traceback(), non_blocking=pin)

    def submit():
        return m.submit(batch)

    # a mapper without captured programs (an earlier checkout of the port)
    # submits eagerly
    programs = getattr(m, "_programs", None)

    def submit_eager():
        graphed = programs is not None and programs.graphed
        if graphed:
            programs.graphed = False
        try:
            return m.submit(batch)
        finally:
            if graphed:
                programs.graphed = True

    t = {name: device_ms(fn, reps, dev) for name, fn in (
        ("h2d", h2d), ("strand", strand), ("gather", gather), ("seed", seed),
        ("dp", dp), ("retain", retain), ("pure", pure),
        ("traceback", traceback), ("full", full), ("submit", submit),
        ("submit_eager", submit_eager))}
    out = {"batch": int(batch.codes.shape[0]),
           "h2d_ms": t["h2d"],
           "strand_ms": t["strand"] - t["h2d"],
           "seed_gather_ms": t["gather"] - t["strand"],
           "seed_dedupe_ms": t["seed"] - t["gather"],
           "seed_ms": t["seed"] - t["strand"],
           "dp_ms": t["dp"] - t["seed"],
           "tb_retain_ms": t["retain"] - t["dp"],
           "tb_pure_kernel_ms": t["pure"] - t["retain"],
           "tb_backwalk_ms": t["traceback"] - t["pure"],
           "traceback_ms": t["traceback"] - t["dp"],
           "blob_fetch_ms": t["full"] - t["traceback"]}
    out["sum_of_stages_ms"] = sum(out[k] for k in (
        "h2d_ms", "strand_ms", "seed_ms", "dp_ms", "traceback_ms",
        "blob_fetch_ms"))
    out["submit_ms"] = t["submit"]
    out["submit_eager_ms"] = t["submit_eager"]
    out["prefix_ms"] = t
    out["clock"] = ("cuda events behind a spin kernel" if pin
                    else "host perf_counter")
    out["reps"] = reps
    out.update(submit_split(m, batch, reps))
    return out


def host_ms(fn, reps, device):
    """Median host time of fn() in ms over ``reps`` calls after one warm-up,
    the device idle before each call (what the caller's thread spends, not
    the device)."""
    on_card = torch.device(device).type == "cuda"
    ts = []
    for k in range(reps + 1):
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        if k:
            ts.append((time.perf_counter() - t) * 1e3)
        del res
    if on_card:
        torch.cuda.synchronize()
    return float(np.median(ts))


def cuda_events(fn):
    """fn() once under torch.profiler: the device's kernel and copy / set
    events and their device time in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = {"kernels": 0, "copies": 0, "device_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = "copies" if e.key.startswith(("Memcpy", "Memset")) \
            else "kernels"
        n[kind] += e.count
        n["device_ms"] += getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0)) / 1e3
    return n


def submit_split(m, batch, reps):
    """Where the host time of the mapper's submit goes, each part timed
    alone on the host clock (host_ms): ``pack_ms`` (pack_reads),
    ``upload_ms`` (the packed reads and lengths staged through a ring of
    pinned buffers of its own), ``program_enqueue_ms`` (the eager device
    program on inputs already on the device, TorchMapper._device_map_tb_q
    or _device_map_packed_q), ``fetch_ms`` (the blob's copy into a pinned
    buffer), beside ``submit_enqueue_ms``, the whole submit.  On a card
    ``submit_cuda`` counts the kernel and copy events of one submit
    (torch.profiler)."""
    from gnumap_tpu_torch.pipeline import mapper as pl
    from gnumap_tpu_torch.pipeline.staging import StagingRing
    dev = m.device
    ring = StagingRing(dev, 2)
    packed = pl.pack_reads(batch.codes, batch.quals)
    lens = np.asarray(batch.lens, np.int32)

    def upload():
        s = ring.acquire()
        return s.upload("packed", packed), s.upload("lens", lens)

    p, ln = upload()
    prog = (m._device_map_tb_q if m.finish_impl == "device"
            else m._device_map_packed_q)
    blob = prog(p, ln)
    out = dict(
        pack_ms=host_ms(lambda: pl.pack_reads(batch.codes, batch.quals),
                        reps, dev),
        upload_ms=host_ms(upload, reps, dev),
        program_enqueue_ms=host_ms(lambda: prog(p, ln), reps, dev),
        fetch_ms=host_ms(lambda: ring.acquire().fetch("blob", blob), reps,
                         dev),
        submit_enqueue_ms=host_ms(lambda: m.submit(batch), reps, dev))
    if dev.type == "cuda":
        out["submit_cuda"] = cuda_events(lambda: m.submit(batch))
    return out


def _kernel_modules():
    """{kernel name: the module whose wrapper counts its launches}."""
    from gnumap_tpu_torch.align import nw_band, nw_full, nw_pure, nw_tb
    from gnumap_tpu_torch.posterior import accum
    return {"nw_band": nw_band, "nw_pure": nw_pure, "nw_tb": nw_tb,
            "nw_full": nw_full, "accum": accum}


def bench_config(cfgnum, args, device, with_baseline, repeats=1,
                 workload=None):
    """Run one ladder config; return its line (the reference's
    bench_config keys, plus wall_s_repeats, dp_cells and the kernel
    launches of the whole config)."""
    cfg, gen, idx, recs = workload or build_workload(
        args.reads, args.genome_len, args.batch_size, config=cfgnum)
    c = CONFIGS[cfgnum]
    extra = {}
    kernels = _kernel_modules()
    for mod in kernels.values():
        mod.LAUNCHES = 0
    if c.get("sam_stream"):
        dt, stats, extra = run_stream_sam(cfg, gen, idx, recs, device)
        walls = [dt]
        # truth accuracy from an untimed hit-returning pass, so that
        # accuracy means the same thing on every line
        best, _ = run_pipeline(dataclasses.replace(cfg, sam_out=False), gen,
                               idx, recs, device, depth=args.depth)
        acc = best.accuracy
    elif c.get("snp"):
        dt, stats = run_stream_snp(cfg, gen, idx, recs, device)
        walls = [dt]
        if c.get("accum_ab"):
            extra = {"reads_per_s_host_accum": round(stats.n_reads / dt, 1)}
            try:
                dt_d, stats_d = run_stream_snp(cfg, gen, idx, recs, device,
                                               acc_impl="device")
                extra["reads_per_s_device_accum"] = round(
                    stats_d.n_reads / dt_d, 1)
            except Exception as e:    # the device leg must not lose the
                import traceback      # host leg's line; main fails on it
                traceback.print_exc()
                extra["device_accum_error"] = (
                    f"{type(e).__name__}: {e}")[:200]
        # hits never reach the host on the device-accumulation path: the
        # hit-returning pipeline once more, untimed
        best, _ = run_pipeline(cfg, gen, idx, recs, device, depth=args.depth)
        acc = best.accuracy
    else:
        best, walls = run_pipeline(
            cfg, gen, idx, recs, device, depth=args.depth,
            n_segments=c.get("segments", 0), repeats=repeats)
        dt, stats, acc = best.wall_s, best.stats, best.accuracy
    launches = {n: mod.LAUNCHES for n, mod in kernels.items()}
    reads_per_s = stats.n_reads / dt
    # rates by the stream's wait on the device (the reference's device_s);
    # none on the CPU, where no device ran
    on_card = torch.device(device).type == "cuda"

    def per_device_s(x, scale=1.0):
        return (round(x / max(stats.device_s, 1e-9) / scale, 3)
                if on_card else None)
    vs_baseline = None
    if with_baseline:
        base = cpu_baseline(args.reads, args.genome_len, config=cfgnum)
        if base:
            vs_baseline = reads_per_s / base["cpu_reads_per_s"]
            extra["cpu_reads_per_s"] = round(base["cpu_reads_per_s"], 1)
            extra["cpu_reads"] = base["reads"]
        else:
            extra["baseline_error"] = "the CPU baseline subprocess failed"
    return {
        "config": cfgnum, "name": c["name"],
        "value": round(reads_per_s, 1), "unit": "reads/s",
        "vs_baseline": round(vs_baseline, 2) if vs_baseline else None,
        "reads": stats.n_reads, "mapped": stats.n_mapped,
        "accuracy": round(acc, 4),
        "mapped_rate": round(stats.n_mapped / max(stats.n_reads, 1), 4),
        "multi_mapped": stats.n_multi,
        "dp_cells": stats.dp_cells,
        "dp_cells_per_s_device": per_device_s(stats.dp_cells, 1e9),
        "dp_cells_banded_per_s_device": per_device_s(stats.dp_cells_banded,
                                                     1e9),
        "dp_unit": "Gcells/s",
        "device_s": round(stats.device_s, 3),
        "host_s": round(stats.host_s, 3),
        "wall_s": round(dt, 3),
        "wall_s_repeats": [round(w, 4) for w in walls],
        "reads_per_s_device_time": per_device_s(stats.n_reads),
        "launches": launches,
        **extra,
    }


def reference_ladder(path):
    """{config: line} of a reference BENCH_r0*.json: the ladder entries of
    the headline line kept in its ``tail`` (the end of the recorded run's
    output).  The tail may begin inside the first entry: its fields from ``"value"`` on
    are kept, as the config before the first whole entry's, with
    ``"partial": true``."""
    with open(path) as f:
        tail = json.load(f)["tail"]
    dec = json.JSONDecoder()
    out = {}
    i = first = tail.find('{"config": ')
    while i >= 0:
        entry, end = dec.raw_decode(tail, i)
        out[entry["config"]] = entry
        i = tail.find('{"config": ', end)
    j = tail.find('"value": ')
    if first > 0 and 0 <= j < first:
        entry, _ = dec.raw_decode("{" + tail[j:first].rstrip(", "))
        cfgnum = min(out) - 1
        out[cfgnum] = {"config": cfgnum, "name": CONFIGS[cfgnum]["name"],
                       **entry, "partial": True}
    return out


def device_identity(device):
    """(torch's device name, nvidia-smi's "name, power.limit" line or
    None) of the measuring device."""
    if torch.device(device).type != "cuda":
        return "cpu", None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return torch.cuda.get_device_name(0), (smi[0] if smi else None)


def _error_line(n, e):
    return {"config": n, "name": CONFIGS[n]["name"], "value": 0.0,
            "unit": "reads/s", "vs_baseline": None, "reads": 0,
            "mapped": 0, "accuracy": 0.0, "mapped_rate": 0.0,
            "multi_mapped": 0, "dp_cells": 0, "dp_cells_per_s_device": None,
            "dp_unit": "Gcells/s", "device_s": 0.0, "host_s": 0.0,
            "wall_s": 0.0, "wall_s_repeats": [],
            "error": f"{type(e).__name__}: {e}"[:300]}


def build_arg_parser():
    ap = argparse.ArgumentParser(
        prog="python -m gnumap_tpu_torch.bench",
        description="Benchmark driver of the PyTorch port (the reference's "
                    "bench.py): one JSON line per ladder config, the "
                    "headline line last.")
    ap.add_argument("--config", type=int, default=0,
                    choices=[0] + sorted(CONFIGS),
                    help="BASELINE.json workload ladder entry "
                         "(0 = full ladder, headline = config 2)")
    ap.add_argument("--reads", type=int, default=0,
                    help="override the config's read count")
    ap.add_argument("--genome-len", type=int, default=0,
                    help="override the config's genome length")
    ap.add_argument("--batch-size", type=int, default=0,
                    help="0 = per-config default (16384 for the headline "
                         "config, 8192 otherwise)")
    ap.add_argument("--depth", type=int, default=3,
                    help="batches kept in flight (pipeline depth, at most "
                         "the mapper's STREAM_DEPTH)")
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--cpu-baseline", action="store_true",
                    help="measure the CPU baseline (run by the bench itself "
                         "in a subprocess, with --device cpu)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) runs the CUDA kernels and "
                         "fails without a card; cpu runs their plain "
                         "versions")
    ap.add_argument("--reference", default=None, metavar="BENCH_JSON",
                    help="hold every config's mapped, multi_mapped and "
                         "accuracy to this reference record's ladder "
                         "(e.g. BENCH_r05.json)")
    return ap


def main(argv=None) -> int:
    from gnumap_tpu_torch.pipeline.mapper import STREAM_DEPTH
    args = build_arg_parser().parse_args(argv)
    if not 1 <= args.depth <= STREAM_DEPTH:
        raise SystemExit(f"--depth {args.depth}: 1 to {STREAM_DEPTH} (the "
                         "mapper's staging ring holds STREAM_DEPTH + 1 "
                         "batches)")
    if args.cpu_baseline:
        if args.device != "cpu":
            raise SystemExit("--cpu-baseline measures the host CPU: give "
                             "--device cpu")
        n = min(args.reads or BENCH_READS_CPU, BENCH_READS_CPU)
        cfg, gen, idx, recs = build_workload(
            n, args.genome_len, min(args.batch_size or 256, 256),
            config=args.config or 2)
        best, _ = run_pipeline(cfg, gen, idx, recs, "cpu")
        out = {"cpu_reads_per_s": best.stats.n_reads / best.wall_s,
               "reads": best.stats.n_reads, "seconds": best.wall_s,
               "provenance": "the port's plain torch versions on the host "
                             "CPU"}
        with open(_cache_path(args.config or 2, n, args.genome_len),
                  "w") as f:
            json.dump(out, f)
        sys.stderr.write(f"cpu baseline: {json.dumps(out)}\n")
        return 0

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda (the default) but torch finds no "
                         "CUDA card; --device cpu runs the plain versions")
    kind, smi = device_identity(device)
    impl = "cuda" if device == "cuda" else "plain"
    ref = reference_ladder(args.reference) if args.reference else None
    failed = []

    bit_ok, bit_n, bit_detail = kernel_bitcheck(device)
    sys.stderr.write(f"kernel_bitcheck: ok={bit_ok} checked={bit_n} "
                     f"{bit_detail}\n")
    if not bit_ok:
        failed.append(f"kernel_bitcheck: {bit_detail}")

    headline_cfg = args.config or 2
    run_list = sorted(CONFIGS) if args.config == 0 else [args.config]
    head_work = None
    ladder = []
    for n in run_list:
        try:
            work = None
            if n == headline_cfg and not CONFIGS[n].get("segments"):
                work = head_work = build_workload(
                    args.reads, args.genome_len, args.batch_size, config=n)
            entry = bench_config(n, args, device,
                                 with_baseline=(not args.no_baseline
                                                and n == headline_cfg),
                                 repeats=3 if n == headline_cfg else 1,
                                 workload=work)
        except Exception as e:      # one broken config must not lose the
            import traceback        # rest of the ladder; main fails on it
            traceback.print_exc()
            entry = _error_line(n, e)
        for key in ("error", "device_accum_error", "baseline_error"):
            if key in entry:
                failed.append(f"config {n}: {entry[key]}")
        if ref is not None:
            r = ref.get(n)
            want = (None if r is None else
                    {k: r[k] for k in ("mapped", "multi_mapped", "accuracy")})
            entry["reference"] = want
            entry["counts_equal_reference"] = want is not None and all(
                entry[k] == v for k, v in want.items())
            if not entry["counts_equal_reference"]:
                failed.append(f"config {n}: {want} in {args.reference}")
        ladder.append(entry)
        if n != headline_cfg or len(run_list) > 1:
            print(json.dumps(entry), flush=True)
    head = [e for e in ladder if e["config"] == headline_cfg][0]

    prof = None
    if device == "cuda" and head_work is not None and "error" not in head:
        # per-stage device times of the headline config's first batch
        try:
            prof = profile_stages(*head_work, device)
            sys.stderr.write(f"profile: {json.dumps(prof)}\n")
            bad = [k for k in PROFILE_KEYS + ("sum_of_stages_ms",
                                              "submit_ms", "submit_eager_ms")
                   if not np.isfinite(prof[k])]
            if bad:
                failed.append(f"profile: not finite {bad}")
        except Exception as e:       # keep the headline line; main fails
            import traceback
            traceback.print_exc()
            prof = {"error": f"{type(e).__name__}: {e}"[:200]}
            failed.append(f"profile: {prof['error']}")

    sustained = next((e["value"] for e in ladder
                      if e["config"] == 9 and e["value"] > 0), None)
    print(json.dumps({
        "metric": f"reads aligned/sec/chip "
                  f"({CONFIGS[headline_cfg]['name']})",
        "value": head["value"],
        "unit": "reads/s",
        # wall-clock reads/s (value), reads/s by the stream's wait on the
        # device (device_s), the sustained outputs-on map_stream rate
        # (config 9), and reads/s by the device time of the mapper's
        # submit in the profile
        "reads_per_s_device_time": head.get("reads_per_s_device_time"),
        "reads_per_s_device_program": (
            round(prof["batch"] / prof["submit_ms"] * 1e3, 1)
            if prof and "submit_ms" in prof else None),
        "reads_per_s_sustained_outputs_on": sustained,
        "vs_baseline": head["vs_baseline"],
        "backend": device, "align_impl": impl,
        "device": kind, "nvidia_smi": smi,
        "kernel_bitcheck": bit_ok,
        "kernel_bitcheck_n": bit_n,
        "kernel_bitcheck_detail": bit_detail,
        "reads": head["reads"], "mapped": head["mapped"],
        "accuracy": head["accuracy"],
        "mapped_rate": head["mapped_rate"],
        "multi_mapped": head["multi_mapped"],
        "dp_cells": head["dp_cells"],
        "dp_cells_per_s_device": head["dp_cells_per_s_device"],
        "dp_unit": "Gcells/s",
        "device_s": head["device_s"],
        "host_s": head["host_s"],
        "wall_s": head["wall_s"],
        "wall_s_repeats": head["wall_s_repeats"],
        "launches": head.get("launches"),
        "profile": prof,
        "ladder": [{k: e[k] for k in
                    ("config", "name", "value", "accuracy", "mapped",
                     "multi_mapped", "dp_cells_per_s_device", "wall_s",
                     "wall_s_repeats", "reads_per_s_device_time",
                     "reads_per_s_host_accum", "reads_per_s_device_accum",
                     "device_accum_error", "counts_equal_reference",
                     "error") if k in e}
                   for e in ladder],
        "baseline_provenance": "the port's plain torch versions on the "
                               "host CPU (C++ reference unavailable)",
        "failed": failed,
        **{k: head[k] for k in ("sam_bytes", "sam_sort_s",
                                "reads_per_s_host_accum",
                                "reads_per_s_device_accum",
                                "device_accum_error", "cpu_reads_per_s",
                                "cpu_reads", "reference",
                                "counts_equal_reference") if k in head},
    }), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
