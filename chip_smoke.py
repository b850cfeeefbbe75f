#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: drive its main path once on one CUDA
card, hold every kernel of that path against its plain torch version, and
check the output.

    python3 chip_smoke.py                    # all phases, one card
    python3 chip_smoke.py --only device,build,kernel_b2,kernel_b3

Phases, one JSON line each; any failure raises and the exit code is not 0:
  device     card name and power limit; the native host library built from
             gnumap_tpu_torch/native/*.cpp and loaded (fails if it is not)
  build      nvcc of every csrc/*.cu kernel, in parallel; ptxas registers
             and spills; resident warps per multiprocessor of B1 and B4 and
             resident hits of B3, resident warps of B2 and resident blocks
             of B5 (the occupancy API); opcode counts in the SASS of B1 and
             B2 (bw 42), B4 and B3 (W 144) and banded B3 (W 128)
  kernel_b1  csrc/nw_band.cu vs its plain torch version on the card at the
             map path's shapes (B2 = 16384 read-strands, C = 32, L = 104,
             band (9, 42)) plus edge rows; a sample vs oracle.nw_align;
             other band widths; CUDA-event timings; then six sets of live
             slots (all, half at random, a sorted prefix of 5-6 per row, one
             per row, none, mixed lengths with 0, 1, L and L + 1) at band
             widths 42, 26 and 62: vs plain and the oracle, time, bound
  kernel_b2  csrc/nw_pure.cu vs its plain version on H = 16384 retained-hit
             slots (L = 104, band (9, 42)): reads copied from the genome
             with substitutions and 1-2 bp indels, SENTINEL slots, anchors
             at the genome's ends, tandem-repeat ties; a sample vs
             oracle.nw_align(traceback=True); gap_slack 0, 1, 13 and a
             harsh scoring; CUDA-event timings; then seven sets of hit slots
             (all live, half at random, a live prefix of 50% as on the map
             path, a prefix of 5%, none, mixed lengths with 0, 1, L and
             L + 1, scores <= 0) at band widths 42, 26 and 62: vs plain,
             dead slots (false, 0), time, bound
  kernel_b3  csrc/nw_tb.cu on the same slots, the same way; then unbanded
             (band=None) on such slots at gap_slack 16 (and 14, 30); then
             five sets of live hit slots (all, half at random, a live prefix
             of 5%, none, mixed lengths with 0, 1, L and L + 1), with the
             band mask (W 128, band (9, 42)) and without (W 144): vs plain,
             dead slots ops 0 and jfin 0, time, bound
  kernel_b4  csrc/nw_full.cu (unbanded scoring) as kernel_b1, at gap_slack
             16 (16,384 x 32), then 14, 30 and the harsh scoring; then
             kernel_b1's six live-slot sets at W 144, 140 and 172
  kernel_b5  csrc/accum_rmw.cu vs its serial plain version, bit for bit,
             on synthetic deltas with pileups and overlapping spans, both
             rowmuls, span starts sorted and in any order; a repeat launch
             gives the same bits; CUDA-event timings, beside index_add_ and
             its deterministic form (whose bits are held to the plain
             version's and to a repeat call's); then delta sets at the
             map_acc shapes (131,072 slots; coverage rowmul 1 x 2 rows and
             tallies rowmul 4 x 8 rows): n_real = 131,072, 8,794, 1 and 0
             (the launch floor) in order with pileups, 8,794 in any order,
             8,572 distinct starts in order in 8,794 slots (the shape the
             same-block pre-coalescing gives B5 on map_acc's first batch),
             and the pair entry (coverage and tallies in one launch) against
             the two plain calls: bits, repeat launch, time, bound
  host_mem   tools/torch_host_mem.py on the map phase's genome and reads
             (written 5 times: 10 batches of 8,192) with CLI_ARGS: the CLI's
             start-up and map in a fresh process, steps S0-S9 (RSS, peak
             RSS, /proc/self/smaps by class, the caching host allocator),
             beside F0, a process that only initialises CUDA; fails if RSS
             at S7 (after the first batch) exceeds F0 + 1,024 MiB or the
             named classes hold under 90% of it
  map        16,384 simulated 100 bp reads against a 4,641,652-base genome
             through the port's CLI (main(argv), --device cuda, device
             finish), SAM and SGR on; reads/s, mapped rate, accuracy from
             the read names, kernel launches during the run; each kernel
             timed on the inputs of the run's first batch
  map_host   the same reads through TorchMapper(..., finish_impl="host")
             and map_stream, then once more with the device finish, warm:
             equal SAM bodies and SGR bytes; reads/s of both finishes
  map_indel  1,024 reads at indel_rate 0.02, mapped with the device finish
             on the card and on the CPU and with the host finish on the
             card: equal SAM bodies and SGR bytes, n_indel > 0; banded B3
             on the inputs of the card run's first call (the one map path
             where it has live hits): vs plain, time, bound
  parity     the first 1,024 reads mapped with --device cuda and
             --device cpu (device finish): equal SAM bodies and SGR bytes
  golden     the golden command of tests/golden/README through the CLI on
             the card: phix.sam equal to the golden file but for its @PG
             line, .sgr and .sgrex to tests/golden/SHA256SUMS; then the reference's bench config 1 (5,386 bases,
             10,000 reads of 36 bp) through the CLI on the card and the
             CPU: equal SAM bodies and SGR bytes, its mapped count 9,843
  map_ckpt   the map phase's data: the CLI with --sort-sam (bench config 9)
             on the card and the CPU, equal SAM files holding the map run's
             records; the CLI at -B 1024 without and with --checkpoint
             (every 4 batches): the checkpoint's cost; then the checkpointed
             command as a process of its own, killed (SIGKILL) once its
             checkpoint file has been written twice, and run again: SAM
             body and SGR bytes equal the uninterrupted run's
  map_unbanded  the map phase's reads through TorchMapper(MapperConfig(
             gap_slack=16, ...)) and map_stream: unbanded scoring (B4) and
             the traceback on every retained hit (B3, band=None); device
             and host finish byte-equal, accuracy; B1 and B2 not launched
  map_acc    the reference's bench config 10 (build_workload): a
             46,709,983-base genome with 40 x 20 repeat families, 16,384
             reads, SNP mode, SAM on, accumulated on the device twice (bit-
             equal) and on the host once (counts and SAM equal, coverage
             and tallies within 1e-5), and on the CPU once (device
             accumulation: coverage and tallies equal the card's bit for
             bit); each batch's live hits and the unique blocks (deltas)
             B5 gets after the same-block pre-coalescing; B5 on the first
             batch's inputs: the pair launch, the coverage and the tallies
             call alone, the n_real = 0 floor, and device_accumulate with
             and without B5 (the work around the kernel) and its transient
             device memory; then the CLI with --accumulate device --snp on
             1,024 config-2 reads against --accumulate host
  map_multi  the reference's bench config 8: config 10's data (built
             once for map_acc) without SNP mode, TorchMapper and map_stream,
             SAM on: its mapped and multi-mapped counts 16,383 and 4,132,
             accuracy by sam_accuracy and by bench.py's rule (bench_account:
             the truth among the hits of the largest weight), reads with
             more than one co-best record; card against CPU on 1,024 reads
             planted in repeat copies: SAM and SGR bytes
  map_cfg3   the reference's bench configs 3 and 5 (build_workload): a
             46,709,983-base genome, 2% in copies of one 500 bp unit, 16,384
             reads, -m 13 -j 5, max_hits 8; config 3 through TorchMapper and
             map_stream, config 5 the same in SNP mode with host coverage
             and tallies, SAM on: counts 16,110 and 6, accuracy by both
             rules, the one read both count wrong (CONFIG3_WRONG, whose
             truth no seed reaches), its records; card against CPU in SNP
             mode on 1,024 reads that hold it: SAM, SGR and SGREX bytes
  graph      the captured device programs (pipeline/graphs.py) against
             the same programs run eagerly, on bench config 2 (three
             batches of 16,384 reads), bench config 6 (FM, three batches of
             8,192) and the accumulate path's map program on config 10
             (its two batches), every batch twice: the outputs of each
             replay equal the eager program's bit for bit (0 mismatches,
             every output of the program); the launches a replay adds
             equal an eager call's; then, eager against graph, the host
             time of the mapper's submit (median of 20), its time on the
             card's clock (cuda_ms, median of 20: its spin of about a
             millisecond is shorter than the submit's host work, so the
             reading holds that work) and its kernel and copy events and
             their device time under torch.profiler (device_profile); the
             bytes the graphs' private pools reserved, the host seconds of
             the warm-up and of the capture, and the first two batches of
             a fresh mapper (submit and finish), eager against graph; then
             bench config 2 at its own size (16,384 reads in one batch)
             through TorchMapper and map_stream, SAM on: mapped and
             multi-mapped equal the reference's (CONFIG2_MAPPED,
             CONFIG2_MULTI, BENCH_r05.json), accuracy by sam_accuracy and
             by bench.py's rule (bench_account) at least 0.999
  map_bs     the reference's bench config 4 (build_workload): 16,384
             bisulfite-converted reads against a 46,709,983-base genome on
             the per-strand collapsed CSR pair (-m 16, base-3 seeds),
             TorchMapper and map_stream, SAM on; then the CLI's -b on 1,024
             bisulfite reads against the map phase's genome three ways
             (--device cuda, --device cpu, -b --index-type fm): equal SAM
             bodies and SGR bytes
  map_fm     the reference's bench config 6: the map phase's CLI command
             with --index-type fm; SAM body and SGR bytes equal the map
             phase's; the FM search (index/fm.fm_hits) and the CSR gather
             (csr_hits) timed on the same seeds of the first batch, and the
             whole seeding stage of each
  map_seg    the reference's bench config 7 (build_workload): a
             46,709,983-base genome (2% repeats) as two contigs, 8,192 reads
             from each, GlobalSegmentedMapper(n_segments=2) against
             TorchMapper on the whole genome, SAM on: equal SAM and coverage;
             then the CLI's --segments 2 against no segments on the map
             phase's genome split in two contigs
  map_dist   the reads x index mesh and the multi-host CLI on the card, at
             the map phase's data: (a) a world of one rank on NCCL, mesh
             (1, 1): DistMapper with the device finish through map_stream,
             SAM and SGR equal TorchMapper's; (b) two ranks sharing the card
             over gloo (tensors staged through host memory), meshes (2, 1)
             and (1, 2) with the device finish and (1, 2) with the host
             finish: every rank's hits equal TorchMapper's, B1, B2 and B3
             launched on every rank, B1 at C = 16 (rank 0's first call on
             (1, 2)) vs plain, time, bound; (c) the CLI on two ranks:
             --num-hosts 2 --snp, --segments 2 --num-hosts 2 (the genome in
             two contigs) and -c 2 --num-hosts 2, each byte-equal to its
             single-process run.  Each rank is a process of its own with a
             deadline (python3 chip_smoke.py --dist-worker SPEC for (a) and
             (b), the CLI for (c)); each mesh runs cold, then warm (NCCL
             sets a group up at its first collective); per world: reads/s,
             seconds and bytes a batch in the collectives and staged, peak
             device memory per rank.  Two ranks on one card are not a
             scaling figure.
map_bs, map_fm and map_seg print reads/s, the card's kernel and copy time of a warm
repeat under torch.profiler (its wall, and so the idle share beside it,
includes the profiler's own cost) and the peak device memory of their main
run beside what earlier phases still held when it started; map_multi and
map_cfg3 print reads/s and the peak device memory the same way.
Each map phase sets every launch count to 0 before its run and fails unless
the kernels of its path launched.  Each kernel is timed on the inputs of its
path's first call beside its bound: the least time the card could take for
what those inputs need, the larger of its integer (or float) operations over
the card's peak rate and its bytes over the memory rate.  Then a line with
the kernels' JSON, a line with nvidia-smi's name and power limit, and as the
last line {"ok": true, "device": {...}}.  The "total" line before them gives
the seconds the whole run took, the builds included.

Without a CUDA card it exits 2 and prints no result.  It reads and writes
only the repository checkout and a temporary directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernel_b1", "kernel_b2", "kernel_b3",
          "kernel_b4", "kernel_b5", "host_mem", "map", "map_host",
          "map_indel", "parity", "golden", "map_ckpt", "map_unbanded",
          "map_acc", "map_multi", "map_cfg3", "graph", "map_bs", "map_fm",
          "map_seg", "map_dist")
GENOME_LEN = 4_641_652
N_READS = 16_384
READ_LEN = 100
CLI_ARGS = ["-m", "12", "-j", "5", "-L", "104", "-q", "32", "-B", "8192"]
# the narrowest and widest bands, and a scoring whose emissions reach below
# -open (mismatch -8, open 1, extend 0.5): (gap_slack, MapperConfig extras)
BANDS = ((0, {}), (1, {}), (13, {}),
         (8, dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5)))
TANDEM_AT = 1_000_000    # a period-4 tandem repeat in the B2 / B3 genome
KERNELS = {   # name -> (source, the Pallas kernel it replaces)
    "nw_band": ("gnumap_tpu_torch/csrc/nw_band.cu",
                "gnumap_tpu/align/nw_pallas.py:265"),
    "nw_pure": ("gnumap_tpu_torch/csrc/nw_pure.cu",
                "gnumap_tpu/align/nw_pallas.py:586"),
    "nw_tb": ("gnumap_tpu_torch/csrc/nw_tb.cu",
              "gnumap_tpu/align/nw_pallas.py:865"),
    "nw_full": ("gnumap_tpu_torch/csrc/nw_full.cu",
                "gnumap_tpu/align/nw_pallas.py:120"),
    "accum": ("gnumap_tpu_torch/csrc/accum_rmw.cu",
              "gnumap_tpu/posterior/accum_pallas.py:47"),
}
# the kernels each map path must launch, and those it must not
PATHS = {"map": (("nw_band", "nw_pure", "nw_tb"), ("nw_full", "accum")),
         "map_unbanded": (("nw_full", "nw_tb"),
                          ("nw_band", "nw_pure", "accum")),
         "map_acc": (("nw_band", "nw_pure", "nw_tb", "accum"), ("nw_full",)),
         "map_bs": (("nw_band", "nw_pure", "nw_tb"), ("nw_full", "accum")),
         "map_fm": (("nw_band", "nw_pure", "nw_tb"), ("nw_full", "accum")),
         "map_seg": (("nw_band", "nw_pure", "nw_tb"), ("nw_full", "accum")),
         **{p: (("nw_band", "nw_pure", "nw_tb"), ("nw_full", "accum"))
            for p in ("golden", "map_ckpt", "map_multi", "map_cfg3")}}
# launches a path makes exactly: B2 once a batch on map (2 batches); B5 once
# a batch on map_acc, coverage and tallies in one launch
# the kernels every rank of a map_dist world must launch (the host finish
# launches B1 only)
DIST_KERNELS = ("nw_band", "nw_pure", "nw_tb")
PATH_LAUNCHES = {"map": {"nw_pure": 2}, "map_acc": {"accum": 2},
                 "map_bs": {"nw_pure": 2}, "map_fm": {"nw_pure": 2},
                 "map_seg": {"nw_pure": 4}}
# the path whose launch counts a kernel reports
OWN_PATH = {"nw_band": "map", "nw_pure": "map", "nw_tb": "map",
            "nw_full": "map_unbanded", "accum": "map_acc"}
# unbanded configurations of kernel_b4: (gap_slack, MapperConfig extras)
FULL = ((14, {}), (30, {}),
        (16, dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5)))
# gap_slack of the live-slot sets of kernel_b1: band widths 42, 26 and 62
LIVE_SET_SLACKS = (8, 4, 13)
# host_mem's limit: RSS after the CLI's first batch on the map phase's data
# may exceed F0 (torch imported, CUDA initialised) by this much; the port's
# own arrays there are under 100 MB
HOST_MEM_OVER_F0_MIB = 1024
# slot capacity and live deltas of the first map_acc batch: the shapes of
# kernel_b5's sets
ACC_SLOTS = 131_072
ACC_LIVE = 8_794
# the unique 128-blocks of those live hits after the same-block
# pre-coalescing: what B5 gets on that batch, in ACC_LIVE slots
ACC_UNIQ = 8_572
# gap_slack of the live-slot sets of kernel_b4: window widths 144, 140, 172
FULL_SET_SLACKS = (16, 14, 30)
# The card's published peaks (NVIDIA H100 SXM data sheet): int32 is 64 lanes
# per multiprocessor per clock, half the 67 TFLOP/s float32 rate.
INT32_OPS = 16.7e12
F32_OPS = 67e12
HBM_BYTES = 3.35e12
# The fewest integer instructions the function needs for a DP cell, whatever
# the kernel spends (derived in the source notes of the kernels): the
# recurrence's 5 DPX instructions plus 1 for the emission's address; B2 adds
# 1 for the gapless sum; B3 adds 4 compares, one per direction bit.
CELL_OPS = {"nw_band": 6, "nw_pure": 7, "nw_full": 6, "nw_tb": 10}
# opcodes the build phase counts in a kernel's SASS
SASS_OPS = ("VIADDMNMX", "VIMNMX3", "VIMNMX", "IDP", "LDS", "STS", "IADD3",
            "IMAD", "LOP3", "SHF", "SEL", "ISETP", "SHFL", "PRMT", "LDG",
            "STL", "LDL")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of fn() in ms, after one warm-up call: CUDA events
    around fn(), queued behind a spin kernel of about a millisecond, so that
    the host has enqueued all of fn()'s launches before the first of them
    starts.  Without the spin an idle card waits for the host between the
    two events, and a kernel shorter than its wrapper's host time (30-60 us)
    reads as that host time."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    ts.sort()
    return ts[len(ts) // 2]


def b1_inputs(rng, genome, B2, C, cfg):
    """Read-strand rows for the banded kernel: emission tables from real
    PWMs (random calls and Phred qualities), half the rows planted on the
    genome with 2% substitutions; candidates random, planted, below 0 and
    past the genome's end; edge rows of length 0, 1 and L, N bases, and
    all-SENTINEL rows."""
    import numpy as np
    from gnumap_tpu_torch.align import scoring
    from gnumap_tpu_torch.core import pwm as pwm_mod
    from gnumap_tpu_torch.align.nw_band import SENTINEL
    L = cfg.max_read_len
    G = len(genome)
    lens = np.full(B2, L, np.int32)
    short = rng.random(B2) < 0.25
    lens[short] = rng.integers(1, L + 1, int(short.sum()))
    lens[0], lens[1], lens[2] = 1, L, 0
    p0 = rng.integers(0, G - L, B2)
    planted = rng.random(B2) < 0.5
    codes = rng.integers(0, 4, (B2, L)).astype(np.int8)
    gsl = genome[p0[:, None] + np.arange(L)]
    codes = np.where(planted[:, None], np.where(gsl == 4, 0, gsl), codes)
    sub = rng.random((B2, L)) < 0.02
    codes = np.where(sub, rng.integers(0, 4, (B2, L)), codes).astype(np.int8)
    codes[rng.random((B2, L)) < 0.01] = 4                      # N bases
    quals = rng.integers(2, 41, (B2, L))
    pw = pwm_mod.pwm_rows_from_table(codes, quals)
    pw = np.where((np.arange(L)[None, :] < lens[:, None])[:, :, None], pw, 0)
    emis = scoring.emission_int(pw, scoring.normal_matrix(cfg))
    cands = np.full((B2, C), SENTINEL, np.int64)
    k = rng.integers(0, C + 1, B2)
    for b in range(B2):
        kb = int(k[b])
        if kb == 0:
            continue
        r = b % 8
        if r == 0:
            c = rng.integers(-L, 0, kb)                         # below 0
        elif r == 1:
            c = rng.integers(G - L, G + L, kb)                  # past end
        else:
            c = rng.integers(-L, G + L, kb)
        if planted[b]:
            c[0] = p0[b]
        cands[b, :kb] = np.sort(c)
    cands[3:8] = SENTINEL                                      # all-sentinel
    return (np.ascontiguousarray(emis.transpose(0, 2, 1)),
            cands.astype(np.int32), lens, emis)


def score_fns(cfg):
    """(kernel wrapper, plain version, band-or-None keywords) of the scoring
    kernel cfg runs: B1 banded, B4 when cfg.band() is None."""
    from gnumap_tpu_torch.align import nw_band, nw_full
    kw = dict(L=cfg.max_read_len, W=cfg.window_width(), slack=cfg.gap_slack,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    if cfg.band() is None:
        return nw_full.nw_scores_full, nw_full.nw_scores_full_plain, kw
    boff, bw = cfg.band()
    return (nw_band.nw_scores_banded, nw_band.nw_scores_banded_plain,
            dict(kw, boff=boff, bw=bw))


def check_b1(rng, genome_np, genome_t, B2, C, cfg, n_oracle, reps):
    """Scoring kernel (B1, or B4 without a band) vs plain (int32 equality)
    and vs the oracle on a sample."""
    import numpy as np
    import torch
    from gnumap_tpu_torch.align import nw_band
    from gnumap_tpu_torch.oracle import oracle
    emis_t, cands, lens, emis = b1_inputs(rng, genome_np, B2, C, cfg)
    kern, plain, kw = score_fns(cfg)
    dev = torch.device("cuda")
    args = (torch.from_numpy(emis_t).to(dev), torch.from_numpy(cands).to(dev),
            torch.from_numpy(lens).to(dev), genome_t)
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    mism = int((got != ref).sum())
    err = int((got.long() - ref.long()).abs().max())
    got_np = got.cpu().numpy()
    live = np.argwhere((cands != nw_band.SENTINEL) & (lens[:, None] > 0))
    pick = live[rng.choice(len(live), min(n_oracle, len(live)),
                           replace=False)]
    pick = np.concatenate([live[np.isin(live[:, 0], [0, 1])][:4], pick])
    W = cfg.window_width()
    ogen = oracle.OracleGenome(genome_np, [], np.zeros(1), np.zeros(1))
    o_mism = 0
    for b, c in pick:
        window = ogen.window(cfg.window_start(int(cands[b, c])), W)
        exp = oracle.nw_align(emis[b, :lens[b]], window, cfg)
        o_mism += int(got_np[b, c] != exp)
    out = dict(gap_slack=cfg.gap_slack, band=cfg.band(), W=W, B2=B2, C=C,
               L=cfg.max_read_len, live_pairs=int(len(live)),
               mismatches=mism, max_abs_err=err, oracle_pairs=len(pick),
               oracle_mismatches=o_mism)
    if reps:
        out["ms"] = cuda_ms(lambda: kern(*args, **kw), reps)
        out["plain_ms"] = cuda_ms(lambda: plain(*args, **kw), 3)
        name = "nw_full" if cfg.band() is None else "nw_band"
        out.update(kernel_bound(name, args, kw), library_ms=None)
        out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def kernel_bound(name, a, kw):
    """The least time the card could take for what these inputs need: the
    live work (pairs, hits or deltas that are not SENTINEL or padding), its
    DP cells (len x bw with a band, B3's banded call included, len x W
    without) times CELL_OPS over the int32 rate (B5: one float add per
    element), and the bytes it must move (each live input read once, each
    output written once) over the memory rate; bound_ms is the larger."""
    import torch
    from gnumap_tpu_torch.align.nw_band import SENTINEL
    if name == "accum" and len(a) == 6:     # the pair: both jobs' needs
        cov, tal, base, cov_d, tal_d, n_real = a
        parts = [kernel_bound("accum", (arr, base, d, n_real),
                              dict(rowmul=rm))
                 for arr, d, rm in ((cov, cov_d, 1), (tal, tal_d, 4))]
        ops, nbytes = (sum(p[k] for p in parts) for k in ("ops", "bytes"))
        ops_ms = ops / F32_OPS * 1e3
        out = dict(live=parts[0]["live"], touched_rows=sum(
            p["touched_rows"] for p in parts))
    elif name == "accum":
        arr, base, deltas, n_real = a
        n = max(0, min(int(n_real), base.shape[0]))
        nrows = deltas.shape[1]
        rows = (base[:n].long()[:, None] * kw["rowmul"]
                + torch.arange(nrows, device=base.device)).flatten()
        touched = int(torch.unique(rows[rows < arr.shape[0]]).numel())
        ops = n * nrows * 128
        nbytes = n * nrows * 128 * 4 + 4 * n + 2 * touched * 128 * 4
        ops_ms = ops / F32_OPS * 1e3
        out = dict(live=n, touched_rows=touched)
    else:
        L, W = kw["L"], kw["W"]
        if name in ("nw_band", "nw_full"):
            emis_t, cands, lens, _ = a
            ok = (lens >= (1 if name == "nw_band" else 0)) & (lens <= L)
            live = (cands != SENTINEL) & ok[:, None]
            per_row = live.sum(1)
            n = int(per_row.sum())
            rows = int((per_row > 0).sum())
            cells = int((per_row * lens.long()).sum())
            nbytes = (rows * 5 * L * 4 + 2 * cands.numel() * 4
                      + lens.numel() * 4 + n * W)
        else:
            emis_t, cands, lens = a[:3]
            live = (cands != SENTINEL) & (lens >= 1) & (lens <= L)
            if name == "nw_pure":
                live &= a[3] > 0
            n = rows = int(live.sum())
            cells = int(lens[live].long().sum())
            H = cands.numel()
            nbytes = rows * 5 * L * 4 + n * W + (
                H * 17 if name == "nw_pure" else H * (12 + 2 * L))
        if name in ("nw_band", "nw_pure"):
            width = kw["bw"]
        elif name == "nw_tb" and kw["band"] is not None:
            width = min(W, kw["band"][1])     # the band mask leaves bw a row
        else:
            width = W
        cells *= width
        if name == "nw_tb":
            nbytes += cells // 2              # 4 direction bits per cell
        ops = cells * CELL_OPS[name]
        ops_ms = ops / INT32_OPS * 1e3
        out = dict(live=n, cells=cells)
    bytes_ms = nbytes / HBM_BYTES * 1e3
    return dict(out, ops=ops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def b1_live_sets(rng, genome_np, B2, C, L):
    """Inputs of the banded kernel that differ in which slots are live and
    where the SENTINELs sit: (emis int32[B2, L, 5] of full-length reads,
    {set name: (cands int32[B2, C], lens int32[B2])}).  Every second row is
    planted: its read copies the genome at p0 = 50 b with 2% substitutions,
    and column 0 of its candidates is p0."""
    import numpy as np
    from gnumap_tpu_torch.align import scoring
    from gnumap_tpu_torch.align.nw_band import SENTINEL
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.core import pwm as pwm_mod
    G = len(genome_np)
    codes = rng.integers(0, 4, (B2, L)).astype(np.int8)
    p0 = 50 * np.arange(0, B2, 2)
    gsl = genome_np[p0[:, None] + np.arange(L)]
    codes[::2] = np.where(gsl == 4, 0, gsl)
    sub = rng.random((B2, L)) < 0.02
    codes = np.where(sub, rng.integers(0, 4, (B2, L)), codes).astype(np.int8)
    pw = pwm_mod.pwm_rows_from_table(codes, rng.integers(2, 41, (B2, L)))
    emis = scoring.emission_int(pw, scoring.normal_matrix(
        MapperConfig(max_read_len=L, max_candidates=C)))
    full = rng.integers(-L, G + L, (B2, C))
    full[::2, 0] = 50 * np.arange(0, B2, 2)
    col = np.arange(C)[None, :]
    read_len = np.full(B2, L - 4, np.int32)

    def keep(mask, sort):
        c = np.where(mask, full, SENTINEL)
        return (np.sort(c, axis=1) if sort else c).astype(np.int32)

    one = rng.integers(0, C, B2)
    one_c = np.full((B2, C), SENTINEL, np.int64)
    one_c[np.arange(B2), one] = full[:, 0]
    mixed = rng.integers(1, L + 1, B2).astype(np.int32)
    mixed[rng.random(B2) < 0.3] = L - 4
    edge = rng.random(B2)
    for k, v in enumerate((0, 1, L, L + 1)):
        mixed[(edge >= 0.05 * k) & (edge < 0.05 * (k + 1))] = v
    mixed[:4] = (0, 1, L, L + 1)
    return emis, {
        "all_live": (keep(np.ones((B2, C), bool), True), read_len),
        "half_random": (keep(rng.random((B2, C)) < 0.5, False), read_len),
        "prefix_5_6": (keep(col < rng.integers(5, 7, B2)[:, None], True),
                       read_len),
        "one_per_row": (one_c.astype(np.int32), read_len),
        "none_live": (keep(np.zeros((B2, C), bool), False), read_len),
        "mixed_lengths": (keep(rng.random((B2, C)) < 0.5, False), mixed),
    }


def check_b1_live_sets(rng, genome_np, genome_t, B2, C, n_oracle, reps,
                       slacks=LIVE_SET_SLACKS):
    """The scoring kernel (B1; B4 where gap_slack leaves no band) on the
    live-slot sets at each gap_slack of ``slacks``: 0 mismatches against the
    plain version and an oracle sample; time, bound and share of the bound
    for each.  One list of results."""
    import numpy as np
    import torch
    from gnumap_tpu_torch.align import nw_band
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.oracle import oracle
    L = 104
    dev = torch.device("cuda")
    emis_full, sets = b1_live_sets(rng, genome_np, B2, C, L)
    emis_full_t = torch.from_numpy(np.ascontiguousarray(
        emis_full.transpose(0, 2, 1))).to(dev)
    ogen = oracle.OracleGenome(genome_np, [], np.zeros(1), np.zeros(1))
    results = []
    for slack in slacks:
        cfg = MapperConfig(max_read_len=L, max_candidates=C, gap_slack=slack)
        kern, plain, kw = score_fns(cfg)
        W = cfg.window_width()
        for name, (cands, lens) in sets.items():
            lens_t = torch.from_numpy(lens).to(dev)
            # pad rows (at and past a read's length) are zero
            pad = torch.arange(L, device=dev)[None, :] < lens_t[:, None]
            args = ((emis_full_t * pad[:, None, :]).contiguous(),
                    torch.from_numpy(cands).to(dev), lens_t, genome_t)
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            ref = plain(*args, **kw)
            got_np = got.cpu().numpy()
            live = np.argwhere((cands != nw_band.SENTINEL)
                               & ((lens > 0) & (lens <= L))[:, None])
            dead = (cands == nw_band.SENTINEL) | ~((lens > 0)
                                                   & (lens <= L))[:, None]
            # a dead slot is NEG_INF; without a band a valid anchor of a
            # length-0 read scores 0 (row 0 of the unbanded DP)
            dead_value = np.where(
                (cands != nw_band.SENTINEL) & (lens == 0)[:, None]
                & (cfg.band() is None), 0, -(1 << 29))
            pick = (live[rng.choice(len(live), min(n_oracle, len(live)),
                                    replace=False)] if len(live) else [])
            o_mism = 0
            for b, c in pick:
                window = ogen.window(cfg.window_start(int(cands[b, c])), W)
                exp = oracle.nw_align(emis_full[b, :lens[b]], window, cfg)
                o_mism += int(got_np[b, c] != exp)
            r = dict(set=name, gap_slack=slack, band=cfg.band(), B2=B2, C=C,
                     L=L, mismatches=int((got != ref).sum()),
                     max_abs_err=int((got.long() - ref.long()).abs().max()),
                     W=W, dead_not_neg_inf=int(
                         (got_np[dead] != dead_value[dead]).sum()),
                     positive_scores=int((got_np > 0).sum()),
                     oracle_pairs=len(pick), oracle_mismatches=o_mism,
                     ms=cuda_ms(lambda: kern(*args, **kw), reps))
            r.update(kernel_bound(
                "nw_full" if cfg.band() is None else "nw_band", args, kw))
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            results.append(r)
    return results


def sass_summary(so_path, entry):
    """(opcode counts, SASS text) of the one kernel in a built library whose
    mangled name holds ``entry``, from cuobjdump -sass; (None, "") when the
    toolkit has no cuobjdump."""
    import collections
    import re
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None, ""
    text = subprocess.run([exe, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    counts, inside, lines = collections.Counter(), False, []
    for line in text.splitlines():
        if "Function :" in line:
            inside = entry in line
        if inside:
            lines.append(line)
            m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)",
                         line)
            if m:
                counts[m.group(1)] += 1
    return dict(counts), "\n".join(lines) + "\n"


def ptxas_summary(log: str) -> dict:
    """nvcc -Xptxas -v output -> {template argument (band width or columns
    per lane; "b" appended for nw_tb's banded instantiation): [registers,
    spill store bytes]} per kernel instantiation."""
    import re
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?ILi(\d+)E(Lb1E)?",
                      line)
        if m is None and "Compiling entry function" in line:
            key = "-"                    # a kernel that is not a template
            out[key] = [None, 0]
        elif m:
            key = m.group(1) + ("b" if m.group(2) else "")
            out[key] = [None, 0]
        elif key and "spill stores" in line:
            out[key][1] = int(re.search(r"(\d+) bytes spill stores",
                                        line).group(1))
        elif key and "Used" in line and "registers" in line:
            out[key][0] = int(re.search(r"Used (\d+) registers",
                                        line).group(1))
    return out


def tb_inputs(rng, genome, H, cfg, sentinels=True):
    """Retained-hit slots for B2 and B3, built as
    tests/test_devtb.py::_mk_hits builds them: reads copied from the genome
    with 0-2 substitutions and, for 15% of them, a 1-2 bp insertion or
    deletion; every 8th slot SENTINEL (unless sentinels is False); 1/16 of
    the hits copied from the period-4 tandem repeat at TANDEM_AT (several
    perfect placements in one window, so the smallest-column tie rule
    decides); 1/16 anchored at each end of the genome (windows partly
    outside it); a quarter of the
    lengths in [L/2, L].  Returns (emis int32[H, L, 5], cands, lens)."""
    import numpy as np
    from gnumap_tpu_torch.align import scoring
    from gnumap_tpu_torch.core import pwm as pwm_mod
    from gnumap_tpu_torch.align.nw_band import SENTINEL
    L = cfg.max_read_len
    G = len(genome)
    lens = np.full(H, L, np.int32)
    short = rng.random(H) < 0.25
    lens[short] = rng.integers(L // 2, L + 1, int(short.sum()))
    kind = rng.integers(0, 16, H)
    start = rng.integers(0, G - L, H)
    start[kind == 0] = TANDEM_AT + 4 * rng.integers(3, 70,
                                                    int((kind == 0).sum()))
    start[kind == 1] = rng.integers(0, 6, int((kind == 1).sum()))
    start[kind == 2] = G - lens[kind == 2] - rng.integers(
        0, 6, int((kind == 2).sum()))
    codes = np.zeros((H, L), np.int8)
    for h in range(H):
        lb, p = int(lens[h]), int(start[h])
        seq = genome[p:p + lb].copy()
        seq[seq == 4] = 0
        nsub = int(rng.integers(0, 3)) if kind[h] else int(h % 3 == 0)
        seq[rng.integers(0, lb, nsub)] = rng.integers(0, 4, nsub)
        if kind[h] and rng.random() < 0.15:
            q, k = int(rng.integers(2, lb - 4)), int(rng.integers(1, 3))
            ins = rng.integers(0, 4, k).astype(np.int8)
            if rng.random() < 0.5:
                seq = np.concatenate([seq[:q], seq[q + k:], ins])
            else:
                seq = np.concatenate([ins, seq[:q], seq[q:lb - k]])
        codes[h, :lb] = seq[:lb]
    pw = pwm_mod.pwm_rows_from_table(codes, rng.integers(15, 41, (H, L)))
    pw = np.where((np.arange(L)[None, :] < lens[:, None])[:, :, None], pw, 0)
    emis = scoring.emission_int(pw, scoring.normal_matrix(cfg))
    cands = start.astype(np.int32)
    if sentinels:
        cands[7::8] = SENTINEL
    return emis.astype(np.int32), cands, lens


def tb_live_sets(rng, cands, lens, L):
    """Hit slots of the traceback kernel that differ in which are live:
    {set name: (cands, lens)} from the anchors and lengths of tb_inputs(...,
    sentinels=False).  The mapper's compaction leaves the live hits first:
    "prefix_5pct"."""
    import numpy as np
    from gnumap_tpu_torch.align.nw_band import SENTINEL
    H = len(cands)
    mixed = lens.copy()
    edge = rng.random(H)
    for k, v in enumerate((0, 1, L, L + 1)):
        mixed[(edge >= 0.05 * k) & (edge < 0.05 * (k + 1))] = v
    mixed[:4] = (0, 1, L, L + 1)

    def keep(mask):
        return np.where(mask, cands, SENTINEL).astype(np.int32)

    return {
        "all_live": (keep(np.ones(H, bool)), lens),
        "half_random": (keep(rng.random(H) < 0.5), lens),
        "prefix_5pct": (keep(np.arange(H) < H // 20), lens),
        "none_live": (keep(np.zeros(H, bool)), lens),
        "mixed_lengths": (keep(rng.random(H) < 0.5), mixed),
    }


def check_tb_live_sets(rng, genome_np, genome_t, H, reps):
    """B3 on the live-slot sets, with the band mask (gap_slack 8, W 128,
    band (9, 42)) and without a band (gap_slack 16, W 144): 0 mismatches
    against the plain version, dead slots ops 0 and jfin 0; time, bound and
    share of the bound for each.  One list of results."""
    import numpy as np
    import torch
    from gnumap_tpu_torch.align import nw_band, nw_tb
    from gnumap_tpu_torch.config import MapperConfig
    L = 104
    dev = torch.device("cuda")
    results = []
    for slack in (8, 16):
        cfg = MapperConfig(max_read_len=L, max_candidates=32, gap_slack=slack)
        emis, cands0, lens0 = tb_inputs(rng, genome_np, H, cfg,
                                        sentinels=False)
        emis_t = torch.from_numpy(np.ascontiguousarray(
            emis.transpose(0, 2, 1))).to(dev)
        kw = dict(L=L, W=cfg.window_width(), slack=slack, band=cfg.band(),
                  open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
        for name, (cands, lens) in tb_live_sets(rng, cands0, lens0,
                                                L).items():
            args = (emis_t, torch.from_numpy(cands).to(dev),
                    torch.from_numpy(lens).to(dev), genome_t)
            ops, jfin = nw_tb.nw_traceback(*args, **kw)
            torch.cuda.synchronize()
            o_ref, j_ref = nw_tb.nw_traceback_plain(*args, **kw)
            dead = torch.from_numpy(
                (cands == nw_band.SENTINEL) | (lens <= 0) | (lens > L)).to(dev)
            r = dict(set=name, gap_slack=slack, band=cfg.band(), H=H, L=L,
                     W=kw["W"], mismatches=int(
                         (ops != o_ref).sum() + (jfin != j_ref).sum()),
                     max_abs_err=max(
                         int((ops.long() - o_ref.long()).abs().max()),
                         int((jfin.long() - j_ref.long()).abs().max())),
                     dead_not_zero=int((ops[dead] != 0).sum()
                                       + (jfin[dead] != 0).sum()),
                     gapped=int((ops != 0).any(dim=1).sum()),
                     ms=cuda_ms(lambda: nw_tb.nw_traceback(*args, **kw),
                                reps))
            r.update(kernel_bound("nw_tb", args, kw))
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            results.append(r)
    return results


def b2_sets(rng, genome_np, genome_t, H, slacks=LIVE_SET_SLACKS):
    """Hit-slot sets of the pure-diagonal kernel (L 104): (emis_t int32[H,
    5, L], {gap_slack: ({set: (cands, lens, scores)}, keyword arguments)}),
    numpy.  Anchors and reads are tb_inputs', the same at every gap_slack;
    the scores are B1's for the set's own anchors and lengths at that band,
    as on the map path; "scores_le_0" forces a third of them to 0, -5 or
    NEG_INF."""
    import numpy as np
    import torch
    from gnumap_tpu_torch.align.nw_band import SENTINEL
    from gnumap_tpu_torch.config import MapperConfig
    L = 104
    emis, cands0, lens0 = tb_inputs(
        rng, genome_np, H, MapperConfig(max_read_len=L, max_candidates=32),
        sentinels=False)
    emis_t = np.ascontiguousarray(emis.transpose(0, 2, 1))
    dev = genome_t.device
    emis_d = torch.from_numpy(emis_t).to(dev)
    mixed = lens0.copy()
    edge = rng.random(H)
    for k, v in enumerate((0, 1, L, L + 1)):
        mixed[(edge >= 0.05 * k) & (edge < 0.05 * (k + 1))] = v
    mixed[:4] = (0, 1, L, L + 1)
    masks = {"all_live": (np.ones(H, bool), lens0),
             "half_random": (rng.random(H) < 0.5, lens0),
             "prefix_50pct": (np.arange(H) < H // 2, lens0),
             "prefix_5pct": (np.arange(H) < H // 20, lens0),
             "none_live": (np.zeros(H, bool), lens0),
             "mixed_lengths": (rng.random(H) < 0.5, mixed),
             "scores_le_0": (np.ones(H, bool), lens0)}
    kill = rng.integers(0, 9, H)
    out = {}
    for slack in slacks:
        cfg = MapperConfig(max_read_len=L, max_candidates=32, gap_slack=slack)
        kern, _, skw = score_fns(cfg)
        sets = {}
        for name, (mask, lens) in masks.items():
            cands = np.where(mask, cands0, SENTINEL).astype(np.int32)
            scores = kern(emis_d,
                          torch.from_numpy(cands[:, None].copy()).to(dev),
                          torch.from_numpy(lens).to(dev), genome_t,
                          **skw)[:, 0].cpu().numpy()
            if name == "scores_le_0":
                scores = np.where(kill == 0, 0, np.where(
                    kill == 1, -5, np.where(kill == 2, -(1 << 29), scores)))
            sets[name] = (cands, lens.astype(np.int32),
                          scores.astype(np.int32))
        out[slack] = (sets, dict(skw))
    return emis_t, out


def check_b2_sets(rng, genome_np, genome_t, H, reps, slacks=LIVE_SET_SLACKS):
    """B2 on its hit-slot sets at each gap_slack of ``slacks``: 0 mismatches
    against the plain version, dead slots (false, 0); time, bound and share
    of the bound for each.  One list of results."""
    import torch
    from gnumap_tpu_torch.align import nw_band, nw_pure
    dev = genome_t.device
    results = []
    emis_t, by_slack = b2_sets(rng, genome_np, genome_t, H, slacks)
    emis_d = torch.from_numpy(emis_t).to(dev)
    for slack, (sets, kw) in by_slack.items():
        for name, (cands, lens, scores) in sets.items():
            args = (emis_d, torch.from_numpy(cands).to(dev),
                    torch.from_numpy(lens).to(dev),
                    torch.from_numpy(scores).to(dev), genome_t)
            pure, jfin = nw_pure.nw_pure_banded(*args, **kw)
            torch.cuda.synchronize()
            p_ref, j_ref = nw_pure.nw_pure_banded_plain(*args, **kw)
            dead = torch.from_numpy(
                (cands == nw_band.SENTINEL) | (lens <= 0) | (lens > kw["L"])
                | (scores <= 0)).to(dev)
            r = dict(set=name, gap_slack=slack, band=[kw["boff"], kw["bw"]],
                     H=H, L=kw["L"], W=kw["W"],
                     mismatches=int((pure != p_ref).sum()
                                    + (jfin != j_ref).sum()),
                     max_abs_err=int((jfin.long() - j_ref.long()).abs().max()),
                     dead_not_zero=int(pure[dead].sum()
                                       + (jfin[dead] != 0).sum()),
                     pure=int(pure.sum()),
                     ms=cuda_ms(lambda: nw_pure.nw_pure_banded(*args, **kw),
                                reps))
            r.update(kernel_bound("nw_pure", args, kw))
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            results.append(r)
    return results


def check_tb_kernels(rng, genome_np, genome_t, H, cfg, n_oracle, reps,
                     which):
    """B2 (nw_pure) and B3 (nw_tb) kernels vs their plain versions on the
    card (exact equality of pure, jfin and ops), and a sample of hits with
    a positive score vs oracle.nw_align(traceback=True).  Scores come from
    the B1 kernel (B4 without a band), as on the map path; without a band
    only B3 runs, with band=None.  Returns {name: result}."""
    import numpy as np
    import torch
    from gnumap_tpu_torch.align import nw_band, nw_pure, nw_tb
    from gnumap_tpu_torch.oracle import oracle
    emis, cands, lens = tb_inputs(rng, genome_np, H, cfg)
    band = cfg.band()
    boff, bw = band if band is not None else (None, None)
    kw = dict(L=cfg.max_read_len, W=cfg.window_width(), slack=cfg.gap_slack,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    dev = torch.device("cuda")
    emis_t = torch.from_numpy(np.ascontiguousarray(
        emis.transpose(0, 2, 1))).to(dev)
    cands_t = torch.from_numpy(cands).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    kern, _, skw = score_fns(cfg)
    scores_t = kern(emis_t, cands_t[:, None].contiguous(), lens_t, genome_t,
                    **skw)[:, 0].contiguous()
    scores = scores_t.cpu().numpy()
    live = cands != nw_band.SENTINEL
    pos = np.nonzero(live & (scores > 0))[0]
    W = cfg.window_width()
    ogen = oracle.OracleGenome(genome_np, [], np.zeros(1), np.zeros(1))

    def expect(h):
        window = ogen.window(cfg.window_start(int(cands[h])), W)
        return oracle.nw_align(emis[h, :lens[h]], window, cfg,
                               traceback=True)

    common = dict(gap_slack=cfg.gap_slack, band=band, H=H,
                  L=cfg.max_read_len, W=W, live_hits=int(live.sum()),
                  positive_scores=int(len(pos)))
    out = {}
    if "kernel_b2" in which and band is not None:
        args = (emis_t, cands_t, lens_t, scores_t, genome_t)
        bkw = dict(boff=boff, bw=bw, **kw)
        pure, jfin = nw_pure.nw_pure_banded(*args, **bkw)
        torch.cuda.synchronize()
        p_ref, j_ref = nw_pure.nw_pure_banded_plain(*args, **bkw)
        mism = int((pure != p_ref).sum() + (jfin != j_ref).sum())
        err = int((jfin.long() - j_ref.long()).abs().max())
        pure_np, jfin_np = pure.cpu().numpy(), jfin.cpu().numpy()
        tandem = pos[(cands[pos] >= TANDEM_AT)
                     & (cands[pos] < TANDEM_AT + 400) & pure_np[pos]]
        pick = np.concatenate([tandem[:16], rng.choice(
            pos, min(n_oracle, len(pos)), replace=False)])
        o_mism = 0
        for h in pick:
            sc, pos_w, cigar, _ = expect(h)
            o_mism += int(sc != scores[h] or (bool(pure_np[h]) and (
                cigar != f"{lens[h]}M" or jfin_np[h] != pos_w)))
        r = dict(common, pure=int(pure_np.sum()),
                 tandem_pure=int(len(tandem)), mismatches=mism,
                 max_abs_err=err, oracle_hits=len(pick),
                 oracle_mismatches=o_mism)
        if reps:
            r["ms"] = cuda_ms(lambda: nw_pure.nw_pure_banded(*args, **bkw),
                              reps)
            r["plain_ms"] = cuda_ms(
                lambda: nw_pure.nw_pure_banded_plain(*args, **bkw), 3)
            r.update(kernel_bound("nw_pure", args, bkw), library_ms=None)
        out["kernel_b2"] = r
    if "kernel_b3" in which:
        args = (emis_t, cands_t, lens_t, genome_t)
        bkw = dict(band=band, **kw)
        ops, jfin = nw_tb.nw_traceback(*args, **bkw)
        torch.cuda.synchronize()
        o_ref, j_ref = nw_tb.nw_traceback_plain(*args, **bkw)
        mism = int((ops != o_ref).sum() + (jfin != j_ref).sum())
        err = max(int((ops.long() - o_ref.long()).abs().max()),
                  int((jfin.long() - j_ref.long()).abs().max()))
        ops_np, jfin_np = ops.cpu().numpy(), jfin.cpu().numpy()
        gapped = pos[(ops_np[pos] != 0).any(axis=1)]
        pick = np.concatenate([
            rng.choice(gapped, min(n_oracle // 2, len(gapped)),
                       replace=False),
            rng.choice(pos, min(n_oracle, len(pos)), replace=False)])
        o_mism = 0
        for h in pick:
            sc, pos_w, cigar, ref_len = expect(h)
            got = nw_tb.decode_ops(ops_np[h], int(lens[h]))
            o_mism += int(got != (cigar, ref_len) or jfin_np[h] != pos_w)
        r = dict(common, gapped=int(len(gapped)), mismatches=mism,
                 max_abs_err=err, oracle_hits=len(pick),
                 oracle_mismatches=o_mism)
        if reps:
            r["ms"] = cuda_ms(lambda: nw_tb.nw_traceback(*args, **bkw), reps)
            r["plain_ms"] = cuda_ms(
                lambda: nw_tb.nw_traceback_plain(*args, **bkw), 3)
            r.update(kernel_bound("nw_tb", args, bkw), library_ms=None)
        out["kernel_b3"] = r
    return out


class Spy:
    """Wraps a kernel wrapper in its module: keeps the inputs of its first
    call, to time the kernel at exactly the shapes the main path gives it.
    A mapper's first call of a device program is the eager warm-up before
    its capture (pipeline/graphs.py), so under ``drive`` that first call
    carries the main path's own inputs; the capture calls the wrapper
    again, after ``first`` is set, and a replay calls no Python."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.first = None

    def __call__(self, *a, **kw):
        if self.first is None:
            self.first = ([x.clone() for x in a], kw)
        return self.real(*a, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def sam_accuracy(sam_path: str):
    """(n_reads, n_mapped, accuracy): a mapped read is correct when its
    truth locus (read name sim_<i>_<contig>_<pos>_<strand>) is among its
    co-best weighted records, within 3 bases, on the right strand."""
    n, n_mapped, wrong = sam_truth(sam_path)
    return n, n_mapped, (n_mapped - len(wrong)) / max(n_mapped, 1)


def sam_truth(sam_path: str):
    """(n_reads, n_mapped, names of the mapped reads sam_accuracy counts
    wrong)."""
    from gnumap_tpu_torch.utils.sim import parse_truth
    recs = {}
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.rstrip("\n").split("\t")
            flag = int(t[1])
            lst = recs.setdefault(t[0], [])
            if flag & 4:
                continue
            w = float(next(x for x in t[11:] if x.startswith("XP:f:"))[5:])
            lst.append((w, t[2], int(t[3]) - 1, "-" if flag & 16 else "+"))
    n_mapped, wrong = 0, []
    for name, lst in recs.items():
        if not lst:
            continue
        n_mapped += 1
        tc, tp, ts = parse_truth(name)
        best = max(w for w, *_ in lst)
        if not any(w == best and c == tc and abs(p - tp) <= 3 and s == ts
                   for w, c, p, s in lst):
            wrong.append(name)
    return len(recs), n_mapped, wrong


def run_cli(argv):
    """The port's CLI in process; returns its 'done' JSON."""
    from gnumap_tpu_torch.cli import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli rc {rc}")
    done = [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith("{")]
    return done[-1]


def sam_body(path: str) -> str:
    with open(path) as f:
        return "".join(x for x in f if not x.startswith("@PG"))


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def map_indel(tmp, fa, genome_str, pl, wrappers):
    """1,024 reads at indel_rate 0.02 mapped three ways: device finish on
    the card, device finish on the CPU, host finish on the card.  n_indel
    sums the indel-bearing hits of the card's device-finish blobs.  Returns
    (result, B3's Spy on the card's device-finish run): the one map path
    where the banded traceback has live hits."""
    from gnumap_tpu_torch.utils import sim
    reads = sim.simulate_reads(genome_str, 1024, READ_LEN, seed=11,
                               sub_rate=0.01, indel_rate=0.02,
                               contig="ref_sim")
    fq = os.path.join(tmp, "indel.fastq")
    sim.write_fastq(fq, reads)
    real_decode, real_mapper = pl.decode_tb_blob, pl.TorchMapper
    n_indel = []

    def decode(cfg, B, n, lens, blob):
        n_indel.append(int(blob[-1]))
        return real_decode(cfg, B, n, lens, blob)

    outs, res, spies = {}, {}, {}
    for run, dev, fin in (("cuda_device", "cuda", "device"),
                          ("cpu_device", "cpu", "device"),
                          ("cuda_host", "cuda", "host")):
        o = os.path.join(tmp, run)
        pl.TorchMapper = functools.partial(real_mapper, finish_impl=fin)
        pl.decode_tb_blob = decode if run == "cuda_device" else real_decode
        argv = ["-g", fa, "-o", o, *CLI_ARGS, "--device", dev, fq]
        try:
            if run == "cuda_device":
                d, launches, spies = drive(lambda: run_cli(argv), ("nw_tb",),
                                           wrappers)
                res["launches"] = launches
            else:
                d = run_cli(argv)
        finally:
            pl.TorchMapper, pl.decode_tb_blob = real_mapper, real_decode
        outs[run] = (sam_body(o + ".sam"), file_bytes(o + ".sgr"))
        res[run + "_map_s"] = d["map_s"]
    sams = {v[0] for v in outs.values()}
    sgrs = {v[1] for v in outs.values()}
    gapped = sum(1 for x in outs["cuda_device"][0].splitlines()
                 if not x.startswith("@") and any(
                     c in x.split("\t")[5] for c in "ID"))
    return dict(reads=1024, sam_equal=len(sams) == 1,
                sgr_equal=len(sgrs) == 1, n_indel=sum(n_indel),
                gapped_records=gapped, **res), spies["nw_tb"]


GOLDEN_ARGS = ["-m", "8", "-j", "4", "-B", "128", "-L", "40", "--snp"]
# bench config 1 (bench.py CONFIGS[1]) as CLI flags: 32 candidates, max_hits 8
CONFIG1_ARGS = ["-m", "8", "-j", "4", "-L", "40", "-q", "32", "-k", "8",
                "-B", "8192"]
CONFIG1_MAPPED = 9_843     # the reference's mapped count (BENCH_r05.json)


def golden(tmp, wrappers):
    """The golden command of tests/golden/README through the port's CLI on
    the card (its default device): its SAM equal to the golden file but for
    the @PG line (the command line), its SGR and SGREX to
    tests/golden/SHA256SUMS; then bench config 1 (5,386 bases, 10,000 reads
    of 36 bp, seeds 0 and 7) through the CLI on the card and on the CPU.
    Returns (result, failures, launches of both card runs, spies)."""
    import hashlib
    from gnumap_tpu_torch.utils import sim
    want = {}
    with open(os.path.join(ROOT, "tests", "golden", "SHA256SUMS")) as f:
        for line in f:
            h, p = line.split()
            want[os.path.basename(p)] = h
    o = os.path.join(tmp, "phix")
    argv = ["-g", os.path.join(ROOT, "testdata", "phix_sim.fa"), "-o", o,
            *GOLDEN_ARGS, os.path.join(ROOT, "testdata", "phix_sim_200.fastq")]
    genome = sim.random_genome(5_386, seed=0)
    fa1 = os.path.join(tmp, "config1.fa")
    fq1 = os.path.join(tmp, "config1.fastq")
    sim.write_fasta(fa1, [("ref_sim", genome)])
    sim.write_fastq(fq1, sim.simulate_reads(genome, 10_000, 36, seed=7,
                                            sub_rate=0.01, contig="ref_sim"))

    def config1(dev):
        o1 = os.path.join(tmp, "config1_" + dev)
        d = run_cli(["-g", fa1, "-o", o1, *CONFIG1_ARGS, "--device", dev,
                     fq1])
        return d, sam_body(o1 + ".sam"), file_bytes(o1 + ".sgr"), o1

    def card():
        return run_cli(argv), config1("cuda")

    (d, c1), launches, spies = drive(card, PATHS["golden"][0], wrappers)
    # the SAM is held to the golden file but for its @PG line (the command
    # line), and the golden file to SHA256SUMS; SGR and SGREX by sha256
    gold = os.path.join(ROOT, "tests", "golden", "phix.sam")
    sam_equal = (sam_body(o + ".sam") == sam_body(gold) and hashlib.sha256(
        file_bytes(gold)).hexdigest() == want["phix.sam"])
    got = {f"phix.{x}": hashlib.sha256(file_bytes(f"{o}.{x}")).hexdigest()
           for x in ("sgr", "sgrex")}
    golden_equal = sam_equal and all(got[k] == want[k] for k in got)
    c1_cpu = config1("cpu")
    n, n_mapped, acc = sam_accuracy(c1[3] + ".sam")
    c1_equal = c1[1:3] == c1_cpu[1:3]
    failures = []
    if not golden_equal:
        failures.append(f"golden: SAM body equal {sam_equal}, sha256 {got} "
                        f"against {want}")
    if not c1_equal or n_mapped != CONFIG1_MAPPED or acc < 0.999:
        failures.append(f"golden config 1: cuda == cpu {c1_equal}, mapped "
                        f"{n_mapped}, accuracy {acc}")
    return dict(golden_equal=golden_equal, golden_sam_body_equal=sam_equal,
                golden_reads=d["reads"], golden_mapped=d["mapped"],
                config1=dict(
                    reads=n, mapped=n_mapped,
                    mapped_reference_bench=CONFIG1_MAPPED,
                    mapped_rate=n_mapped / max(n, 1), accuracy=acc,
                    cuda_equal_cpu=c1_equal, map_s=c1[0]["map_s"],
                    reads_per_s=c1[0]["reads_per_s"],
                    cpu_map_s=c1_cpu[0]["map_s"],
                    peak_device_bytes=c1[0]["peak_device_bytes"]),
                launches=launches), failures, launches, spies


def map_ckpt(tmp, fa, fq, map_out, wrappers):
    """Bench config 9's --sort-sam and checkpoint / resume on the map
    phase's data.  (1) The CLI with --sort-sam on the card and on the CPU:
    equal SAM files, the records those of the unsorted map run.  (2) The
    CLI at -B 1024 without and with --checkpoint (every 4 batches), in
    process, on the card: the checkpoint's cost; (3) the checkpointed
    command as a process of its own, killed (SIGKILL) once its checkpoint
    file has been written twice, then the same command again: SAM body and
    SGR bytes equal the uninterrupted run's, and the second run mapped only
    the batches after the checkpoint's.  Returns (result, failures,
    launches of the in-process card runs)."""
    import signal
    from gnumap_tpu_torch.pipeline import checkpoint as ckpt
    small = [a if a != "8192" else "1024" for a in CLI_ARGS]
    out = {k: os.path.join(tmp, "ckpt_" + k)
           for k in ("sort_cuda", "sort_cpu", "plain", "ref", "killed")}
    ck_ref, ck = out["ref"] + ".npz", out["killed"] + ".npz"
    every = ["--checkpoint-every", "4"]

    def card():
        d_sort = run_cli(["-g", fa, "-o", out["sort_cuda"], *CLI_ARGS,
                          "--device", "cuda", "--sort-sam", fq])
        d_plain = run_cli(["-g", fa, "-o", out["plain"], *small, "--device",
                           "cuda", fq])
        d_ref = run_cli(["-g", fa, "-o", out["ref"], *small, "--device",
                         "cuda", "--checkpoint", ck_ref, *every, fq])
        return d_sort, d_plain, d_ref

    (d_sort, d_plain, d_ref), launches, _ = drive(card, (), wrappers)
    run_cli(["-g", fa, "-o", out["sort_cpu"], *CLI_ARGS, "--device", "cpu",
             "--sort-sam", fq])
    sorted_sam = file_bytes(out["sort_cuda"] + ".sam")
    sort_equal = sorted_sam == file_bytes(out["sort_cpu"] + ".sam")
    lines = sorted_sam.decode().splitlines()
    body = [x for x in lines if not x.startswith("@")]
    same_records = None
    if os.path.exists(map_out + ".sam"):
        same_records = sorted(body) == sorted(
            x for x in sam_body(map_out + ".sam").splitlines()
            if not x.startswith("@"))
    # the checkpointed command in a process of its own, killed after its
    # second checkpoint, then run again to its end
    cmd = [sys.executable, "-m", "gnumap_tpu_torch.cli.main", "-g", fa, "-o",
           out["killed"], *small, "--device", "cuda", "--checkpoint", ck,
           *every, "-v", fq]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with open(out["killed"] + ".log", "w") as log:
        p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                             stderr=subprocess.STDOUT)
    writes, last, deadline = 0, None, time.monotonic() + 600
    try:
        while p.poll() is None and time.monotonic() < deadline:
            try:
                st = os.stat(ck)
                key = (st.st_ino, st.st_mtime_ns)
            except FileNotFoundError:
                key = None
            if key is not None and key != last:
                writes, last = writes + 1, key
                if writes == 2:
                    p.send_signal(signal.SIGKILL)
                    break
            time.sleep(0.002)
    finally:
        if p.poll() is None and writes < 2:
            p.kill()
        rc_killed = p.wait(timeout=60)
    failures = []
    done_at = ckpt.load(ck).batches_done if os.path.exists(ck) else None
    if rc_killed != -signal.SIGKILL or writes < 2:
        failures.append(f"map_ckpt: the run was not killed after its second "
                        f"checkpoint (rc {rc_killed}, writes {writes})")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    resume_s = time.perf_counter() - t0
    if r.returncode != 0:
        failures.append(f"map_ckpt: the resumed run failed: "
                        f"{r.stderr[-2000:]}")
    resumed = ([json.loads(x) for x in r.stdout.splitlines()
                if x.startswith("{")] or [{}])[-1]
    # -v prints each batch the run maps (numbered from 1) to stderr: the
    # resumed run must map exactly the batches after the checkpoint's
    n_batches = -(-d_plain["reads"] // 1024)
    resumed_batches = [json.loads(x)["batch"] for x in r.stderr.splitlines()
                       if x.startswith('{"event": "batch"')]
    resumed_ok = (done_at is not None and 4 <= done_at < n_batches
                  and resumed_batches == list(range(done_at + 1,
                                                    n_batches + 1)))
    if not resumed_ok:
        failures.append(f"map_ckpt: the rerun did not resume after batch "
                        f"{done_at} of {n_batches}: it mapped batches "
                        f"{resumed_batches}")
    outs = {k: (sam_body(out[k] + ".sam"), file_bytes(out[k] + ".sgr"))
            for k in ("plain", "ref", "killed")
            if os.path.exists(out[k] + ".sgr")}
    resume_equal = outs.get("killed") == outs["ref"]
    if not (sort_equal and same_records is not False and resume_equal
            and outs["plain"] == outs["ref"]):
        failures.append(f"map_ckpt: sort-sam cuda == cpu {sort_equal}, "
                        f"records {same_records}, resumed == uninterrupted "
                        f"{resume_equal}, checkpointed == plain "
                        f"{outs['plain'] == outs['ref']}")
    return dict(sort_sam=dict(
        cuda_equal_cpu=sort_equal, records_equal_unsorted=same_records,
        header_so=next((x for x in lines if x.startswith("@HD")), None),
        map_s=d_sort["map_s"], reads_per_s=d_sort["reads_per_s"]),
        checkpoint=dict(
            batch=1024, every=4, plain_map_s=d_plain["map_s"],
            checkpointed_map_s=d_ref["map_s"],
            cost_share_of_map_s=(d_ref["map_s"] - d_plain["map_s"])
            / d_plain["map_s"], checkpointed_equal_plain=outs["plain"]
            == outs["ref"], killed_rc=rc_killed, checkpoint_writes_seen=writes,
            batches_done_at_kill=done_at, batches=n_batches,
            resumed_batches_mapped=len(resumed_batches),
            resumed_reads=resumed.get("reads"),
            resume_process_s=resume_s, resumed_equal_uninterrupted=
            resume_equal), launches=launches), failures, launches


def check_b5(rng, rowmul, order, R, H, reps):
    """B5 (accum_rmw) vs its serial plain version on the card, bit for bit,
    and a repeat launch on the same inputs: H deltas of nrows = 2 rowmul
    rows (the map path's 256-position span) with pileups of 64 deltas on
    one block and of 32 on two alternating neighbours, n_real = H - 17."""
    import numpy as np
    import torch
    from gnumap_tpu_torch.posterior import accum
    dev = torch.device("cuda")
    nrows = 2 * rowmul
    base = rng.integers(0, R // rowmul - 2, H)
    p, q = H // 8, H // 4
    base[p:p + 64] = base[p - 1]
    base[q:q + 32] = base[q - 1] + np.arange(32) % 2
    if order == "sorted":
        base = np.sort(base)
    base = torch.from_numpy(base.astype(np.int32)).to(dev)
    deltas = torch.from_numpy(
        (rng.random((H, nrows, 128), np.float32)
         * 2.0 ** rng.integers(-12, 1, (H, nrows, 128))).astype(
             np.float32)).to(dev)
    arr0 = torch.from_numpy(rng.random((R, 128), np.float32)).to(dev)
    n_real = torch.tensor(H - 17, dtype=torch.int32, device=dev)
    args = (base, deltas, n_real)
    got = [accum.apply_deltas(arr0.clone(), *args, rowmul=rowmul)
           for _ in range(2)]
    ref = accum.apply_deltas_plain(arr0.clone(), *args, rowmul=rowmul)
    torch.cuda.synchronize()
    bits = [g.view(torch.int32) for g in got]
    mism = int((bits[0] != ref.view(torch.int32)).sum())
    out = dict(rowmul=rowmul, order=order, R=R, H=H, n_real=H - 17,
               nrows=nrows, mismatches=mism,
               repeat_equal=bool(torch.equal(bits[0], bits[1])),
               max_abs_err=float((got[0] - ref).abs().max()),
               touched=int((got[0] != arr0).sum()))
    if reps:
        buf, pbuf = arr0.clone(), arr0.clone()
        out["ms"] = cuda_ms(lambda: accum.apply_deltas(buf, *args,
                                                       rowmul=rowmul), reps)
        out["plain_ms"] = cuda_ms(lambda: accum.apply_deltas_plain(
            pbuf, *args, rowmul=rowmul), 1)
        out.update(kernel_bound("accum", (arr0, *args), dict(rowmul=rowmul)),
                   library_ms=index_add_ms((arr0, *args), rowmul, reps),
                   library_ordered=ordered_index_add((arr0, *args), rowmul,
                                                     reps, ref))
    return out


def b5_sets(rng, H=ACC_SLOTS, live=ACC_LIVE, uniq=ACC_UNIQ):
    """Delta sets of the ordered accumulator at the map_acc shapes: {set:
    (base_units int32[H], n_real, rowmul, nrows, R)} for coverage (rowmul 1,
    2 rows of 128 a delta) and tallies (rowmul 4, 8 rows), R rows of 128
    floats in the accumulator.  Span starts in order with a pileup of 64
    deltas on one block and of 32 on two alternating neighbours, n_real = H,
    ``live``, 1 and 0; past n_real the starts are in no order (the kernel
    must not read them).  "any_order": the first ``live`` starts shuffled.
    "uniq": the coalesced shape the map path gives B5 now, ``uniq``
    distinct starts in order in ``live`` slots, 0 past them."""
    import numpy as np
    units = 1 << 18                     # 128-position units of the genome
    base = rng.integers(0, units - 2, H)
    for n in (live, H):
        p, q = n // 8, n // 4
        base[p:p + 64] = base[p - 1]
        base[q:q + 32] = base[q - 1] + np.arange(32) % 2
    sets = {}
    for job, rowmul, nrows in (("cov", 1, 2), ("tal", 4, 8)):
        for n in (H, live, 1, 0):
            b = base.copy()
            b[:n] = np.sort(b[:n])
            sets[f"{job}_n{n}"] = (b.astype(np.int32), n, rowmul, nrows,
                                   units * rowmul)
        sets[f"{job}_any_order"] = (base.astype(np.int32), live, rowmul,
                                    nrows, units * rowmul)
    distinct = np.zeros(live, np.int32)
    distinct[:uniq] = np.sort(rng.choice(units - 2, uniq, replace=False))
    for job, rowmul, nrows in (("cov", 1, 2), ("tal", 4, 8)):
        sets[f"{job}_uniq{uniq}"] = (distinct, uniq, rowmul, nrows,
                                     units * rowmul)
    return sets


def b5_tensors(base, n_real, nrows, R, seed, dev):
    """(arr, base_units, deltas, n_real) on the card for one set of b5_sets:
    the deltas and the accumulator are drawn on the card from ``seed``
    (magnitudes 2^-12 .. 1, so that the add order shows in the bits)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    H = base.shape[0]
    deltas = (torch.rand((H, nrows, 128), generator=gen, device=dev)
              * torch.exp2(-torch.randint(0, 13, (H, nrows, 128),
                                          generator=gen, device=dev).float()))
    arr = torch.rand((R, 128), generator=gen, device=dev)
    return (arr, torch.from_numpy(base).to(dev), deltas,
            torch.tensor(n_real, dtype=torch.int32, device=dev))


def check_b5_sets(rng, reps):
    """B5 on its delta sets: bits equal to the serial plain version's and to
    a repeat launch's; time, bound and share, index_add_ and its
    deterministic form beside it; then the pair entry (coverage and tallies
    in one launch) against the two plain calls at n_real = ACC_LIVE and
    ACC_SLOTS, and at the coalesced shape (ACC_UNIQ deltas in ACC_LIVE
    slots).  One list of results."""
    import torch
    from gnumap_tpu_torch.posterior import accum
    dev = torch.device("cuda")
    sets = b5_sets(rng)
    pairs = (f"n{ACC_LIVE}", f"n{ACC_SLOTS}", f"uniq{ACC_UNIQ}")
    results, keep = [], {}
    for k, (name, (base, n, rowmul, nrows, R)) in enumerate(sets.items()):
        arr0, base_t, deltas, n_real = b5_tensors(base, n, nrows, R, 50 + k,
                                                  dev)
        args = (base_t, deltas, n_real)
        got = [accum.apply_deltas(arr0.clone(), *args, rowmul=rowmul)
               for _ in range(2)]
        ref = accum.apply_deltas_plain(arr0.clone(), *args, rowmul=rowmul)
        torch.cuda.synchronize()
        bits = [g.view(torch.int32) for g in got]
        buf = arr0.clone()
        any_order = name.endswith("any_order")
        r = dict(set=name, rowmul=rowmul, nrows=nrows, R=R, H=len(base),
                 n_real=n, mismatches=int(
                     (bits[0] != ref.view(torch.int32)).sum()),
                 repeat_equal=bool(torch.equal(bits[0], bits[1])),
                 max_abs_err=float((got[0] - ref).abs().max()),
                 touched=int((got[0] != arr0).sum()),
                 ms=cuda_ms(lambda: accum.apply_deltas(
                     buf, *args, rowmul=rowmul), reps))
        r.update(kernel_bound("accum", (arr0, *args), dict(rowmul=rowmul)))
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        if n > 1 and not any_order:
            r["library_ms"] = index_add_ms((arr0, *args), rowmul, reps)
            r["library_ordered"] = ordered_index_add((arr0, *args), rowmul,
                                                     reps, ref)
        results.append(r)
        if name[4:] in pairs:
            keep[name] = (arr0, base_t, deltas, n_real, ref)
        del got, bits, buf
    for tag in pairs:
        cov0, base_t, cov_d, n_real, cov_ref = keep[f"cov_{tag}"]
        tal0, base_2, tal_d, _, tal_ref = keep[f"tal_{tag}"]
        n = int(n_real)
        assert torch.equal(base_t, base_2)
        got = [accum.apply_deltas_pair(cov0.clone(), tal0.clone(), base_t,
                                       cov_d, tal_d, n_real)
               for _ in range(2)]
        torch.cuda.synchronize()
        mism = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                   for g, w in zip(got[0], (cov_ref, tal_ref)))
        bufs = (cov0.clone(), tal0.clone())
        pair_args = (cov0, tal0, base_t, cov_d, tal_d, n_real)
        r = dict(set=f"pair_{tag}", H=len(base_t), n_real=n, mismatches=mism,
                 repeat_equal=all(torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))
                                  for a, b in zip(*got)),
                 max_abs_err=max(float((g - w).abs().max()) for g, w in
                                 zip(got[0], (cov_ref, tal_ref))),
                 ms=cuda_ms(lambda: accum.apply_deltas_pair(
                     *bufs, base_t, cov_d, tal_d, n_real), reps))
        r.update(kernel_bound("accum", pair_args, {}))
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        results.append(r)
        del got, bufs
    return results


def index_add_rows(a, rowmul):
    """(row numbers, delta rows) of B5's inputs, for one library call."""
    import torch
    arr, base, deltas, n_real = a
    n, nrows = int(n_real), deltas.shape[1]
    rows = (base[:n].long()[:, None] * rowmul
            + torch.arange(nrows, device=base.device)).flatten()
    ok = rows < arr.shape[0]
    return rows[ok], deltas[:n].reshape(-1, 128)[ok]


def index_add_ms(a, rowmul, reps):
    """Time of one Tensor.index_add_ that adds the same delta rows into a
    copy of the accumulator.  It sums in no fixed order, so its bits differ
    from B5's from run to run: a time to set beside B5's, not a function the
    port could call."""
    rows, src = index_add_rows(a, rowmul)
    buf = a[0].clone()
    return cuda_ms(lambda: buf.index_add_(0, rows, src), reps)


def ordered_index_add(a, rowmul, reps, plain_out):
    """The same library call in its deterministic form
    (torch.use_deterministic_algorithms(True) around index_add_): its time,
    whether its f32 bits equal the serial plain version's (plain_out) and
    whether a repeat call gives the same bits.  A like-for-like yardstick
    for B5's ordered add; the port never calls it."""
    import torch
    rows, src = index_add_rows(a, rowmul)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = [a[0].clone().index_add_(0, rows, src) for _ in range(2)]
        buf = a[0].clone()
        ms = cuda_ms(lambda: buf.index_add_(0, rows, src), reps)
    finally:
        torch.use_deterministic_algorithms(was)
    bits = [g.view(torch.int32) for g in got]
    return dict(ms=ms, bits_equal_plain=bool(torch.equal(
        bits[0], plain_out.view(torch.int32))),
        repeat_equal=bool(torch.equal(bits[0], bits[1])))


def host_mem(fa, fq):
    """tools/torch_host_mem.py (the probe, and F0) on the map phase's data,
    each step's classes in MiB.  Returns (result, failures)."""
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_host_mem.py"),
         "--genome", fa, "--reads", fq, "--repeat", "5", "--", *CLI_ARGS],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"host_mem: probe failed (rc {p.returncode}): "
                           + p.stderr[-3000:])
    r = json.loads(p.stdout.splitlines()[-1])

    def mib(kb):
        return round(kb / 1024, 1)

    def step(s):
        c = s["classes"]
        return dict(
            step=s["step"], t_s=round(s["t_s"], 2), rss_mib=mib(s["rss_kb"]),
            hwm_mib=mib(s["hwm_kb"]), threads=s["threads"],
            attributed=round(s["attributed"], 4),
            cuda_allocated=s.get("cuda_allocated"),
            host_alloc=s.get("host_alloc"),
            libs={os.path.basename(k): mib(v) for k, v in c["libs"].items()},
            **{k: mib(c[k]) for k in ("libs_rest", "heap", "anon", "nvidia",
                                      "other")},
            other_largest={k: mib(v) for k, v in c["other_largest"].items()})

    s7 = r["steps"][7]
    limit = r["f0_rss_mib"] + HOST_MEM_OVER_F0_MIB
    res = dict(card=r["card"], cli_args=r["cli_args"], repeat=r["repeat"],
               f0_rss_mib=r["f0_rss_mib"], s7_rss_mib=mib(s7["rss_kb"]),
               s7_limit_mib=limit, s7_over_f0_mib=r["s7_over_f0_mib"],
               s7_attributed=r["s7_attributed"],
               cuda_module_loading=s7["cuda_module_loading"],
               floor=[step(x) for x in r["floor"]],
               steps=[step(x) for x in r["steps"]])
    fails = []
    if res["s7_rss_mib"] > limit:
        fails.append(f"host_mem: RSS at S7 {res['s7_rss_mib']} MiB over "
                     f"F0 + {HOST_MEM_OVER_F0_MIB} = {limit} MiB")
    if r["s7_attributed"] < 0.9:
        fails.append(f"host_mem: named classes hold {r['s7_attributed']} "
                     "of RSS at S7 (< 0.9)")
    return res, fails


def drive(fn, names, wrappers):
    """fn() with every launch count set to 0 just before it and a Spy on
    each wrapper in names; returns (fn's result, counts read just after,
    {name: Spy})."""
    spies = {n: Spy(*wrappers[n]) for n in names}
    with contextlib.ExitStack() as stack:
        for sp in spies.values():
            stack.enter_context(sp)
        for mod, _ in wrappers.values():
            mod.LAUNCHES = 0
        res = fn()
        launches = {n: m.LAUNCHES for n, (m, _) in wrappers.items()}
    return res, launches, spies


def main_path_check(name, spy, plain):
    """The kernel and its plain version on the inputs of the main path's
    first call: mismatches, max |err| and CUDA-event times.  B5 updates
    its accumulators in place, so each of its runs gets copies; its path
    calls the pair entry, so each job is also timed by itself, and the
    launch floor with n_real = 0."""
    import torch
    a, kw = spy.first
    if name == "accum":
        from gnumap_tpu_torch.posterior import accum
        cov, tal, base, cov_d, tal_d, n_real = a
        rest = (base, cov_d, tal_d, n_real)
        got = spy.real(cov.clone(), tal.clone(), *rest, **kw)
        ref = plain(cov.clone(), tal.clone(), *rest, **kw)
        mism = sum(int((g.view(torch.int32) != r.view(torch.int32)).sum())
                   for g, r in zip(got, ref))
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        bufs = (cov.clone(), tal.clone())
        ms = cuda_ms(lambda: spy.real(*bufs, *rest, **kw), 20)
        pms = cuda_ms(lambda: plain(*bufs, *rest, **kw), 1)
        none = torch.zeros_like(n_real)
        extra = dict(n_real_0_ms=cuda_ms(
            lambda: spy.real(*bufs, base, cov_d, tal_d, none, **kw), 20))
        lib = 0.0
        # each job by itself: the single-accumulator entry, its bound, and
        # the library call in both forms (library_ms is their sum)
        for job, k, deltas, rowmul in (("coverage", 0, cov_d, 1),
                                       ("tallies", 1, tal_d, 4)):
            one = (a[k], base, deltas, n_real)
            t = cuda_ms(lambda: accum.apply_deltas(
                bufs[k], base, deltas, n_real, rowmul=rowmul), 20)
            t0 = cuda_ms(lambda: accum.apply_deltas(
                bufs[k], base, deltas, none, rowmul=rowmul), 20)
            bnd = kernel_bound("accum", one, dict(rowmul=rowmul))
            lib_k = index_add_ms(one, rowmul, 20)
            lib += lib_k
            extra[job] = dict(
                ms=t, n_real_0_ms=t0, bound_ms=bnd["bound_ms"],
                touched_rows=bnd["touched_rows"],
                share_of_bound=bnd["bound_ms"] / t, library_ms=lib_k,
                library_ordered=ordered_index_add(one, rowmul, 20, ref[k]))
        bound = kernel_bound(name, spy.first[0], kw)
        return dict(shape=list(base.shape), ms=ms, plain_ms=pms,
                    library_ms=lib, mismatches=mism, max_abs_err=err,
                    **bound, **extra, share_of_bound=bound["bound_ms"] / ms)
    got, ref = spy.real(*a, **kw), plain(*a, **kw)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    mism = sum(int((g != r).sum()) for g, r in zip(got, ref))
    err = max(int((g.long() - r.long()).abs().max())
              for g, r in zip(got, ref))
    ms = cuda_ms(lambda: spy.real(*a, **kw), 20)
    pms = cuda_ms(lambda: plain(*a, **kw), 3)
    bound = kernel_bound(name, a, kw)
    return dict(shape=list(a[1].shape), ms=ms, plain_ms=pms, library_ms=None,
                mismatches=mism, max_abs_err=err, **bound,
                share_of_bound=bound["bound_ms"] / ms)


def map_unbanded(tmp, fq, fa, pl, wrappers):
    """The map phase's reads at gap_slack 16 (no band): TorchMapper and
    map_stream with the device finish (counted, then warm) and the host
    finish.  Returns (result, launches of the counted run, spies)."""
    import numpy as np
    import torch
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.index import builder
    from gnumap_tpu_torch.io import fastq as io_fastq, sgr as sgr_io
    cfg = MapperConfig(mer_size=12, seed_jump=5, max_read_len=104,
                       max_candidates=32, batch_size=8192, gap_slack=16,
                       sam_out=True, sgr_out=True)
    gen = builder.Genome.from_fasta(fa)
    idx = builder.build_index(gen, cfg)
    batches = list(io_fastq.batch_reads_native(fq, cfg))

    def run(finish):
        m = pl.TorchMapper(gen, idx, cfg, device="cuda", finish_impl=finish)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pl.map_stream(m, iter(batches), collect_sam=True)
        wall = time.perf_counter() - t0
        sgr = io.StringIO()
        sgr_io.write_sgr(sgr, gen, res.coverage)
        return "".join(res.sam_lines), sgr.getvalue(), wall, res.stats

    dev, launches, spies = drive(lambda: run("device"), ("nw_full", "nw_tb"),
                                 wrappers)
    host = run("host")
    warm = run("device")
    sam_path = os.path.join(tmp, "unbanded.sam")
    with open(sam_path, "w") as f:
        f.write(dev[0])
    n, n_mapped, acc = sam_accuracy(sam_path)
    cov = np.loadtxt(io.StringIO(dev[1]), usecols=2, ndmin=1)
    res = dict(gap_slack=16, W=cfg.window_width(), band=cfg.band(),
               reads=n, mapped_rate=n_mapped / max(n, 1), accuracy=acc,
               launches=launches, candidates=dev[3].n_candidates,
               device_finish_map_s=dev[2],
               device_finish_reads_per_s=n / dev[2],
               device_finish_warm_reads_per_s=n / warm[2],
               host_finish_reads_per_s=n / host[2],
               equal_to_host_finish=dev[:2] == host[:2] == warm[:2],
               sgr_rows=int(cov.size), sgr_finite=bool(np.isfinite(
                   cov).all()))
    return res, launches, spies


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
    records.  A size of 0 takes the config's own.  The segmented config
    returns index None (each segment's index is built by
    GlobalSegmentedMapper)."""
    import numpy as np
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


def bench_account(gen, batches, hits):
    """bench.py's own accuracy rule (run_pipeline's account): over the reads
    with at least one hit, the share whose truth locus (contig, position
    within 3 bases, strand) is among the hits of the largest weight.
    Returns (reads with more than one hit of that weight, accuracy, the
    names of the reads it counts wrong)."""
    import numpy as np
    from gnumap_tpu_torch.utils.sim import parse_truth
    n_primary = n_cobest = 0
    wrong = []
    for batch, per_read in zip(batches, hits):
        for name, hs in zip(batch.names, per_read):
            if not hs:
                continue
            n_primary += 1
            best = max(h.weight for h in hs)
            top = [h for h in hs if h.weight == best]
            n_cobest += len(top) > 1
            ci, off = gen.locate(np.asarray([h.pos for h in top], np.int64))
            tc, tp, ts = parse_truth(name)
            if not any(gen.names[int(c)] == tc and abs(int(o) - tp) <= 3
                       and h.strand == ts
                       for c, o, h in zip(np.atleast_1d(ci),
                                          np.atleast_1d(off), top)):
                wrong.append(name)
    return n_cobest, 1 - len(wrong) / max(n_primary, 1), wrong


@functools.lru_cache(maxsize=1)
def config10():
    """Bench config 10's workload once for map_acc, map_multi and graph
    (config 8 is config 10's data without SNP mode)."""
    return build_workload(0, 0, 0, config=10)


# the reference's counts (BENCH_r05.json) and the one read that bench
# configs 3 and 5 map wrongly (ROADMAP C.4: its truth is never a candidate)
CONFIG2_MAPPED, CONFIG2_MULTI = 16_383, 0
CONFIG3_MAPPED, CONFIG3_MULTI = 16_110, 6
CONFIG3_WRONG = ("sim_3473_ref_sim_13817925_-",)
CONFIG8_MAPPED, CONFIG8_MULTI = 16_383, 4_132


def mapped_on_card(pl, gen, idx, cfg, batches, tmp, name, wrappers=None):
    """TorchMapper on the card through map_stream, SAM in memory (counted,
    with spies on B1-B3, when wrappers are given); then an untimed map_batch
    pass for bench.py's accuracy rule.  Returns (result, MapResult,
    launches, spies)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    m = pl.TorchMapper(gen, idx, cfg, device="cuda")
    launches, spies = None, {}
    if wrappers is None:
        res, wall = run_stream(pl, m, batches)
    else:
        (res, wall), launches, spies = drive(
            lambda: run_stream(pl, m, batches), PATHS[name][0], wrappers)
    peak = torch.cuda.max_memory_allocated()
    hits = [m.map_batch(b) for b in batches]
    del m
    torch.cuda.empty_cache()
    path = os.path.join(tmp, name + ".sam")
    with open(path, "w") as f:
        f.writelines(res.sam_lines)
    n, n_mapped, wrong = sam_truth(path)
    acc = (n_mapped - len(wrong)) / max(n_mapped, 1)
    n_cobest, acc_bench, wrong_bench = bench_account(gen, batches, hits)
    return dict(reads=n, mapped=res.stats.n_mapped,
                multi_mapped=res.stats.n_multi, sam_mapped=n_mapped,
                candidates=res.stats.n_candidates, map_s=wall,
                reads_per_s=n / wall, accuracy=acc, wrong=wrong,
                accuracy_bench_rule=acc_bench, wrong_bench_rule=wrong_bench,
                reads_with_cobest_records=n_cobest, peak_device_bytes=peak,
                held_before_bytes=held), res, launches, spies


def card_equals_cpu(pl, gen, idx, cfg, recs):
    """The records mapped on the card and on the CPU (the kernels' plain
    versions) through map_stream: SAM, SGR and, in SNP mode, SGREX bytes.
    Returns (equal, SAM records)."""
    import dataclasses
    from gnumap_tpu_torch.io import fastq as io_fastq, sgr as sgr_io
    from gnumap_tpu_torch.posterior import snp
    cfg = dataclasses.replace(cfg, sam_out=True, sgr_out=True,
                              sgrex_out=cfg.snp_mode)
    outs = {}
    for dev in ("cuda", "cpu"):
        m = pl.TorchMapper(gen, idx, cfg, device=dev)
        res = pl.map_stream(m, io_fastq.batch_reads(iter(recs), cfg),
                            collect_sam=True)
        sgr, sgrex = io.StringIO(), io.StringIO()
        sgr_io.write_sgr(sgr, gen, res.coverage, cfg.min_coverage_emit)
        if res.tallies is not None:
            sgr_io.write_sgrex(sgrex, gen, res.coverage, res.tallies,
                               snp.snp_pvalues(gen.codes, res.coverage,
                                               res.tallies),
                               cfg.min_coverage_emit)
        outs[dev] = ("".join(res.sam_lines), sgr.getvalue(), sgrex.getvalue())
        del m
    return outs["cuda"] == outs["cpu"], outs["cuda"][0].count("\n")


def map_cfg3(tmp, pl, wrappers):
    """Bench configs 3 and 5 on one genome (build_workload): config 3 through
    TorchMapper and map_stream with SAM on (counted), config 5 the same
    reads in SNP mode with host accumulation; each with accuracy by
    sam_accuracy and by bench.py's rule; then the card against the CPU in
    SNP mode on 1,024 reads that hold every read either rule counts wrong.
    Returns (result, failures, launches, spies)."""
    import dataclasses
    from gnumap_tpu_torch.io import fastq as io_fastq
    t0 = time.perf_counter()
    cfg, gen, idx, recs = build_workload(0, 0, 0, config=3)
    cfg = dataclasses.replace(cfg, sam_out=True)
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    setup_s = time.perf_counter() - t0
    r3, res3, launches, spies = mapped_on_card(pl, gen, idx, cfg, batches,
                                               tmp, "map_cfg3", wrappers)
    cfg5 = dataclasses.replace(cfg, snp_mode=True)
    r5, res5, _, _ = mapped_on_card(pl, gen, idx, cfg5, batches, tmp,
                                    "map_cfg5")
    wrong = set(r3["wrong"] + r3["wrong_bench_rule"] + r5["wrong"]
                + r5["wrong_bench_rule"])
    names = [r.name for r in recs]
    keep = [names.index(w) for w in wrong]
    rest = [i for i in range(len(recs)) if i not in keep]
    sub = [recs[i] for i in sorted(keep + rest[:1024 - len(keep)])]
    equal, records = card_equals_cpu(pl, gen, idx, cfg5, sub)
    wrong_records = [x for x in "".join(res3.sam_lines).splitlines()
                     if x.split("\t", 1)[0] in wrong]
    failures = []
    for name, r in (("config 3", r3), ("config 5", r5)):
        if (r["mapped"], r["multi_mapped"]) != (CONFIG3_MAPPED,
                                                CONFIG3_MULTI) \
                or tuple(r["wrong_bench_rule"]) != CONFIG3_WRONG \
                or r["accuracy"] < 0.999:
            failures.append(f"map_cfg3 {name}: mapped {r['mapped']} multi "
                            f"{r['multi_mapped']} wrong (bench rule) "
                            f"{r['wrong_bench_rule']} accuracy "
                            f"{r['accuracy']}")
    sam_equal = res3.sam_lines == res5.sam_lines
    if not (equal and sam_equal and len(sub) == 1024):
        failures.append(f"map_cfg3: cuda == cpu on the subset {equal}, "
                        f"config 3 SAM == config 5 SAM {sam_equal}")
    return dict(genome_len=len(gen.codes), setup_s=setup_s,
                mapped_reference_bench=CONFIG3_MAPPED,
                multi_mapped_reference_bench=CONFIG3_MULTI,
                config3=r3, config5=r5, config3_sam_equal_config5=sam_equal,
                wrong_reads=sorted(wrong), wrong_read_records=wrong_records,
                subset=dict(reads=len(sub), sam_records=records,
                            cuda_equal_cpu=equal),
                launches=launches), failures, launches, spies


def map_multi(tmp, pl, wrappers):
    """Bench config 8: config 10's genome and reads (config10(), built once
    for map_acc) without SNP mode, max_hits 24, hit_capacity 8, through
    TorchMapper and map_stream with SAM on (counted); accuracy by both
    rules, reads with more than one co-best record; then the card against
    the CPU on 1,024 reads planted in repeat copies.  Returns (result,
    failures, launches, spies)."""
    import dataclasses
    from gnumap_tpu_torch.io import fastq as io_fastq
    t0 = time.perf_counter()
    cfg, gen, idx, recs = config10()
    cfg = dataclasses.replace(cfg, snp_mode=False, sam_out=True)
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    setup_s = time.perf_counter() - t0
    r, _, launches, spies = mapped_on_card(pl, gen, idx, cfg, batches, tmp,
                                           "map_multi", wrappers)
    n_rep = len(recs) // 4         # the last quarter is planted in copies
    equal, records = card_equals_cpu(pl, gen, idx, cfg,
                                     recs[-n_rep:][:1024])
    failures = []
    if ((r["mapped"], r["multi_mapped"]) != (CONFIG8_MAPPED, CONFIG8_MULTI)
            or r["accuracy"] < 0.999 or r["accuracy_bench_rule"] < 0.999
            or not equal):
        failures.append(f"map_multi: mapped {r['mapped']} multi "
                        f"{r['multi_mapped']} accuracy {r['accuracy']} / "
                        f"{r['accuracy_bench_rule']} cuda == cpu {equal}")
    return dict(genome_len=len(gen.codes), setup_s=setup_s,
                max_hits=cfg.max_hits_per_seed, hit_capacity=cfg.hit_capacity,
                mapped_reference_bench=CONFIG8_MAPPED,
                multi_mapped_reference_bench=CONFIG8_MULTI, **r,
                subset=dict(reads=min(n_rep, 1024), sam_records=records,
                            cuda_equal_cpu=equal),
                launches=launches), failures, launches, spies


def map_acc(tmp, fa, reads, pl, wrappers):
    """Bench config 10 accumulated on the device twice and on the host
    once, then the CLI's --accumulate device --snp against --accumulate
    host on 1,024 config-2 reads.  Returns (result, failures, launches of
    the first device run, spies)."""
    import dataclasses
    import numpy as np
    import torch
    from gnumap_tpu_torch.io import fastq as io_fastq
    from gnumap_tpu_torch.utils import profiling, sim
    t0 = time.perf_counter()
    cfg, gen, idx, recs = config10()
    cfg = dataclasses.replace(cfg, sam_out=True)
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    setup_s = time.perf_counter() - t0

    def run(acc):
        m = pl.TorchMapper(gen, idx, cfg, device="cuda", accumulate=acc)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = pl.map_stream(m, iter(batches), collect_sam=True)
        wall = time.perf_counter() - t1
        del m
        torch.cuda.empty_cache()
        return res, wall

    # the first device_accumulate call's arguments, to time the work around
    # B5 (sorts, weights, the dense delta windows) afterwards: copies of the
    # hit rows and PWMs, which live in staging buffers that later batches
    # overwrite (pipeline/staging.py Slot.keep); and, for each eager call,
    # its live hits and the deltas it hands B5 (device tensors, read after
    # the run).  The calls are eager only at a captured graph's first batch
    # (pipeline/graphs.py AccPrograms): a capture runs nothing and is not
    # counted, a replay calls no Python; the value ring has every batch's
    # tier (accumulate.tier)
    real_acc, first_acc, per_call = pl.device_accumulate, [], []
    accum_mod, pair = wrappers["accum"]

    def acc_spy(*a, **kw):
        if not first_acc:
            first_acc.append((a[:2] + (a[2].clone(), {
                k: v.clone() for k, v in a[3].items()}) + a[4:], kw))
        inner = getattr(accum_mod, pair)

        def b5(*x, **k):
            if not torch.cuda.is_current_stream_capturing():
                per_call.append((a[3]["valid_h"].sum(), x[-1].clone()))
            return inner(*x, **k)

        setattr(accum_mod, pair, b5)
        try:
            return real_acc(*a, **kw)
        finally:
            setattr(accum_mod, pair, inner)

    pl.device_accumulate = acc_spy
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    c0, p0 = profiling.counters(), profiling._now()
    try:
        (d1, w1), launches, spies = drive(lambda: run("device"), ("accum",),
                                          wrappers)
    finally:
        pl.device_accumulate = real_acc
    c1 = profiling.counters()
    acc_graphs = dict(tiers=profiling.values(
        "accumulate.tier", p0, profiling._now()).tolist(), **{
            k: c1[f"accumulate.{k}"] - c0[f"accumulate.{k}"]
            for k in ("captures", "replays")})
    run_peak = torch.cuda.max_memory_allocated() - held
    around = None
    if first_acc:
        (acfg, aB, apwm2, arows, acov, atal), akw = first_acc[0]
        bufs = (acov.clone(), atal.clone() if atal is not None else None)
        real_pair = getattr(accum_mod, pair)
        n0 = accum_mod.LAUNCHES
        # the transient device memory of one call, above what it is given
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        real_acc(acfg, aB, apwm2, arows, *bufs, **akw)
        torch.cuda.synchronize()
        call_peak = torch.cuda.max_memory_allocated() - held
        total_ms = cuda_ms(
            lambda: real_acc(acfg, aB, apwm2, arows, *bufs, **akw), 5)
        # the host's enqueue of one call (cuda_ms reads it where it outlasts
        # the spin kernel) and the card's kernel time under torch.profiler
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        real_acc(acfg, aB, apwm2, arows, *bufs, **akw)
        enqueue_ms = (time.perf_counter() - t1) * 1e3
        _, prof = device_profile(
            lambda: real_acc(acfg, aB, apwm2, arows, *bufs, **akw))
        setattr(accum_mod, pair, lambda cov, tal, *a, **k: (cov, tal))
        try:
            rest_ms = cuda_ms(
                lambda: real_acc(acfg, aB, apwm2, arows, *bufs, **akw), 5)
        finally:
            setattr(accum_mod, pair, real_pair)
        accum_mod.LAUNCHES = n0
        H = arows["valid_h"].shape[0]
        span = pl.acc_span(acfg)
        around = dict(device_accumulate_ms=total_ms,
                      device_accumulate_without_b5_ms=rest_ms,
                      host_enqueue_ms=enqueue_ms,
                      kernel_ms=prof["device_ms"],
                      kernel_events=prof["device_events"],
                      top_kernels=prof["top"],
                      slots=H, cov_delta_bytes=H * span * 4,
                      tal_delta_bytes=H * span * 16,
                      eager_live_hits=[int(h) for h, _ in per_call],
                      eager_b5_deltas=[int(n) for _, n in per_call],
                      graphs=acc_graphs,
                      peak_bytes_over_inputs=call_peak)
        del bufs, first_acc[:]
        torch.cuda.empty_cache()
    d2, w2 = run("device")
    h, wh = run("host")
    # the same batches accumulated on the device program's CPU form: the
    # card's f32 bits must be the port's on the CPU (which
    # tests/test_torch_accum_parity.py holds to the JAX package's)
    t1 = time.perf_counter()
    c = pl.map_stream(pl.TorchMapper(gen, idx, cfg, device="cpu",
                                     accumulate="device"),
                      iter(batches), collect_sam=False)
    cpu_s = time.perf_counter() - t1
    cpu_equal = (c.stats.n_mapped == d1.stats.n_mapped
                 and c.stats.n_multi == d1.stats.n_multi
                 and all(np.array_equal(
                     getattr(c, k).astype(np.float32).view(np.int32),
                     getattr(d1, k).astype(np.float32).view(np.int32))
                         for k in ("coverage", "tallies")))
    failures = []
    if not cpu_equal:
        failures.append("map_acc: the card's device accumulation differs "
                        "from the CPU's")
    counts = {f: [getattr(r.stats, f) for r in (d1, d2, h)]
              for f in ("n_reads", "n_mapped", "n_multi", "n_candidates")}
    if any(len(set(v)) != 1 for v in counts.values()):
        failures.append(f"map_acc: counts {counts}")
    bit_equal = (np.array_equal(d1.coverage, d2.coverage)
                 and np.array_equal(d1.tallies, d2.tallies))
    err = {k: float(np.abs(getattr(d1, k) - getattr(h, k)).max())
           for k in ("coverage", "tallies")}
    close = all(np.allclose(getattr(d1, k), getattr(h, k), rtol=1e-5,
                            atol=1e-5) for k in err)
    sam_equal = ("".join(d1.sam_lines) == "".join(d2.sam_lines)
                 == "".join(h.sam_lines))
    if not (bit_equal and close and sam_equal):
        failures.append(f"map_acc: bit_equal {bit_equal} within_1e-5 "
                        f"{close} sam_equal {sam_equal}")
    # the CLI, --accumulate device vs host, 1,024 config-2 reads, --snp
    sub = os.path.join(tmp, "acc.fastq")
    sim.write_fastq(sub, reads[:1024])
    cli = {}
    for acc in ("device", "host"):
        o = os.path.join(tmp, f"acc_{acc}")
        accum_mod.LAUNCHES = 0
        d = run_cli(["-g", fa, "-o", o, *CLI_ARGS, "--device", "cuda",
                     "--snp", "--accumulate", acc, sub])
        cli[acc] = (sam_body(o + ".sam"),
                    np.loadtxt(o + ".sgr", usecols=2, ndmin=1),
                    accum_mod.LAUNCHES, d["reads_per_s"])
    sgr_err = (float(np.abs(cli["device"][1] - cli["host"][1]).max())
               if cli["device"][1].shape == cli["host"][1].shape else None)
    # values within 1e-5 before printing; the 4-decimal SGR print turns that
    # into at most one unit of the last place
    cli_ok = (cli["device"][0] == cli["host"][0] and sgr_err is not None
              and sgr_err <= 1e-4 + 1e-9 and cli["device"][2] > 0
              and cli["device"][1].size > 1000)
    if not cli_ok:
        failures.append(f"map_acc cli: sgr max err {sgr_err}, launches "
                        f"{cli['device'][2]}")
    n = d1.stats.n_reads
    res = dict(genome_len=len(gen.codes), reads=n, batch=cfg.batch_size,
               hit_capacity=cfg.hit_capacity, setup_s=setup_s,
               launches=launches, counts=counts,
               device_reads_per_s=[n / w1, n / w2], host_reads_per_s=n / wh,
               device_map_s=[w1, w2], host_map_s=wh,
               device_accumulate=around, device_run_peak_bytes=run_peak,
               device_runs_bit_equal=bit_equal,
               cuda_bits_equal_cpu=dict(batches=len(batches), equal=cpu_equal,
                                        cpu_map_s=cpu_s),
               max_abs_err_vs_host=err,
               within_1e_5=close, sam_equal=sam_equal,
               sam_records="".join(h.sam_lines).count("\n"),
               cli=dict(sam_equal=cli["device"][0] == cli["host"][0],
                        sgr_rows=int(cli["device"][1].size),
                        sgr_max_abs_err=sgr_err,
                        accum_launches=cli["device"][2],
                        device_reads_per_s=cli["device"][3],
                        host_reads_per_s=cli["host"][3]))
    return res, failures, launches, spies


def graph_programs(tmp, pl):
    """The graph phase (see the module docstring).  Returns (result by
    workload, failures)."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree
    from gnumap_tpu_torch.io import fastq as io_fastq
    from gnumap_tpu_torch.pipeline import graphs
    from gnumap_tpu_torch.pipeline.staging import StagingRing
    dev = torch.device("cuda")
    res, failures = {}, []
    for name, cfgnum in (("config2", 2), ("config6", 6), ("config10_acc",
                                                          10)):
        if cfgnum == 10:
            cfg, gen, idx, recs = config10()
        else:
            B = CONFIGS[cfgnum].get("batch", 8192)
            cfg, gen, idx, recs = build_workload(3 * B, 0, 0, config=cfgnum)
        acc = "device" if cfgnum == 10 else "host"
        batches = list(io_fastq.batch_reads(iter(recs), cfg))
        m = pl.TorchMapper(gen, idx, cfg, device="cuda", accumulate=acc)
        fn = m._device_map_acc_q if acc == "device" else m._device_map_tb_q
        ring = StagingRing(dev, 2)
        mism, n0 = [], graphs._counts()
        for _ in range(2):
            for b in batches:
                arrays = dict(packed=pl.pack_reads(b.codes, b.quals),
                              lens=np.asarray(b.lens, np.int32))
                got = pytree.tree_leaves(m._programs(fn, ring.acquire(),
                                                     **arrays))
                want = pytree.tree_leaves(fn(*(
                    torch.from_numpy(a).to(dev) for a in arrays.values())))
                mism.append(sum(int((g != w).sum())
                                for g, w in zip(got, want)))
        torch.cuda.synchronize()
        (cap,) = m._programs.captured.values()
        calls = 2 * len(batches)
        # one warm-up and (calls - 1) replays through the graph, calls
        # eager runs beside them: 2 * calls runs in all
        runs = [(a - b) / (2 * calls)
                for a, b in zip(graphs._counts(), n0)]
        per_replay = {mod.__name__.rsplit(".", 1)[1]: n
                      for mod, n in cap.launches}
        eager_run = {mod.__name__.rsplit(".", 1)[1]: r
                     for mod, r in zip(graphs.KERNEL_MODULES, runs) if r}
        if any(mism) or cap.replays != calls - 1 or per_replay != eager_run:
            failures.append(f"graph {name}: mismatches {mism}, replays "
                            f"{cap.replays}, launches a replay {per_replay} "
                            f"against an eager run's {eager_run}")
        b = batches[0]
        t = {}
        for mode in ("eager", "graph"):
            m._programs.graphed = mode == "graph"
            host = []
            for _ in range(21):         # the first call is a warm-up
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                m.submit(b)
                host.append((time.perf_counter() - t1) * 1e3)
            torch.cuda.synchronize()
            t[mode] = dict(
                submit_enqueue_ms=float(np.median(host[1:])),
                device_ms=cuda_ms(lambda: m.submit(b), 20),
                submit_cuda=device_profile(lambda: m.submit(b))[1])
        m._programs.graphed = True
        # what a capture costs a short run: the first two batches of a
        # fresh mapper, eager and graph in turns (eager, graph, graph,
        # eager, ...), the host seconds of each batch's submit and finish
        first = {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager", "eager", "graph"):
            m2 = pl.TorchMapper(gen, idx, cfg, device="cuda",
                                accumulate=acc)
            m2._programs.graphed = mode == "graph"
            run = []
            for bb in batches[:2]:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = m2.submit(bb)
                t2 = time.perf_counter()
                m2.finish(bb, out)
                torch.cuda.synchronize()
                run.append(dict(submit_s=t2 - t1,
                                finish_s=time.perf_counter() - t2))
            first[mode].append(run)
            del m2, out
        res[name] = dict(
            batch=int(b.codes.shape[0]), batches=len(batches),
            program=fn.__name__, blob_mismatches=mism,
            launches_a_replay=per_replay, eager=t["eager"],
            graph=t["graph"], pool_bytes=m._programs.pool_bytes(),
            warm_up_s=cap.warm_up_s, capture_s=cap.capture_s,
            first_two_batches_s=first,
            captured=len(m._programs.captured))
        del m, fn, cap, ring, got, want
        torch.cuda.empty_cache()
        if cfgnum == 2:
            # bench config 2 at its own size (16,384 reads in one batch):
            # the reference's counts; SAM on for the accuracy
            cfg, gen, idx, recs = build_workload(0, 0, 0, config=2)
            cfg = dataclasses.replace(cfg, sam_out=True)
            r, _, _, _ = mapped_on_card(
                pl, gen, idx, cfg, list(io_fastq.batch_reads(iter(recs), cfg)),
                tmp, "graph_config2")
            res["config2_counts"] = r
            if ((r["mapped"], r["multi_mapped"]) != (CONFIG2_MAPPED,
                                                     CONFIG2_MULTI)
                    or r["accuracy"] < 0.999
                    or r["accuracy_bench_rule"] < 0.999):
                failures.append(f"graph config 2: mapped {r['mapped']} multi "
                                f"{r['multi_mapped']} accuracy "
                                f"{r['accuracy']} / "
                                f"{r['accuracy_bench_rule']}")
    return res, failures


def device_profile(fn):
    """fn() once more under torch.profiler: (fn's result, the card's kernel
    and copy time in ms, the number of such events, the five costliest by
    name).  A card with no traced device time reads 0."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        rows.append((us / 1e3, e.count, e.key[:60]))
    rows.sort(reverse=True)
    return res, dict(device_ms=sum(r[0] for r in rows),
                     device_events=sum(r[1] for r in rows),
                     top=[dict(name=k, ms=ms, count=c)
                          for ms, c, k in rows[:5]])


def run_stream(pl, mapper, batches):
    """map_stream over pre-parsed batches with SAM in memory; returns
    (MapResult, wall seconds of the stream alone)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pl.map_stream(mapper, iter(batches), collect_sam=True)
    return res, time.perf_counter() - t0


def sam_lines_accuracy(tmp, name, lines):
    path = os.path.join(tmp, name + ".sam")
    with open(path, "w") as f:
        f.writelines(lines)
    return sam_accuracy(path)


def map_bs(tmp, fa, genome_str, pl, wrappers):
    """Bench config 4 through TorchMapper and map_stream on the card
    (counted), then a warm profiled repeat; then the CLI's -b on 1,024
    bisulfite reads against the map phase's genome: --device cuda, --device
    cpu and -b --index-type fm.  Returns (result, failures, launches,
    spies)."""
    import torch
    from gnumap_tpu_torch.io import fastq as io_fastq
    from gnumap_tpu_torch.utils import sim
    t0 = time.perf_counter()
    cfg, gen, idx, recs = build_workload(0, 0, 0, config=4)
    cfg = dataclasses.replace(cfg, sam_out=True)    # for the accuracy
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    m = pl.TorchMapper(gen, idx, cfg, device="cuda")
    (res, wall), launches, spies = drive(
        lambda: run_stream(pl, m, batches), PATHS["map_bs"][0], wrappers)
    peak = torch.cuda.max_memory_allocated()
    (res2, wall2), prof = device_profile(lambda: run_stream(pl, m, batches))
    del m
    torch.cuda.empty_cache()
    n, n_mapped, acc = sam_lines_accuracy(tmp, "bs", res.sam_lines)
    failures = []
    if n != N_READS or acc < 0.999 or res2.sam_lines != res.sam_lines:
        failures.append(f"map_bs: reads {n} accuracy {acc}")
    # the CLI's -b three ways on 1,024 bisulfite reads of the map genome
    reads = sim.simulate_reads(genome_str, 1024, READ_LEN, seed=12,
                               sub_rate=0.01, contig="ref_sim",
                               bisulfite=True)
    fq = os.path.join(tmp, "bs.fastq")
    sim.write_fastq(fq, reads)
    cli = {}
    for run, extra in (("cuda", ["--device", "cuda"]),
                       ("cpu", ["--device", "cpu"]),
                       ("fm_cuda", ["--index-type", "fm", "--device",
                                    "cuda"])):
        o = os.path.join(tmp, "bs_" + run)
        d = run_cli(["-g", fa, "-o", o, *CLI_ARGS, "-b", *extra, fq])
        cli[run] = (sam_body(o + ".sam"), file_bytes(o + ".sgr"),
                    d["map_s"], sam_accuracy(o + ".sam"))
    cli_equal = len({v[:2] for v in cli.values()}) == 1
    if not cli_equal or cli["cuda"][3][2] < 0.999:
        failures.append(f"map_bs cli: equal {cli_equal} accuracy "
                        f"{cli['cuda'][3][2]}")
    out = dict(genome_len=len(gen.codes), reads=n, batch=cfg.batch_size,
               mer_size=cfg.mer_size, buckets_per_strand=3 ** cfg.mer_size
               + 1, setup_s=setup_s, mapped=n_mapped,
               mapped_reference_bench=16_380,
               mapped_rate=n_mapped / max(n, 1), accuracy=acc,
               launches=launches, candidates=res.stats.n_candidates,
               map_s=wall, reads_per_s=n / wall, warm_map_s=wall2,
               warm_reads_per_s=n / wall2, **prof,
               profiled_idle_share=1 - prof["device_ms"] / 1e3 / wall2,
               peak_device_bytes=peak, held_before_bytes=held,
               cli=dict(reads=1024, equal=cli_equal,
                        accuracy=cli["cuda"][3][2],
                        mapped=cli["cuda"][3][1],
                        map_s={k: v[2] for k, v in cli.items()}))
    return out, failures, launches, spies


def map_fm(tmp, fa, fq, csr_out, pl, wrappers):
    """Bench config 6: the map phase's CLI command with --index-type fm
    (counted), byte-equal to the CSR run's SAM body and SGR, and a warm
    profiled repeat (its device time includes the index upload); then the
    FM search and the CSR gather, and the whole seeding stage on each
    index, timed on the first batch's seeds.  Returns (result, failures, launches,
    spies)."""
    import numpy as np
    import torch
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.index import builder, fm
    from gnumap_tpu_torch.io import fastq as io_fastq
    o = os.path.join(tmp, "fm")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    done, launches, spies = drive(
        lambda: run_cli(["-g", fa, "-o", o, *CLI_ARGS, "--index-type", "fm",
                         "--device", "cuda", fq]), PATHS["map_fm"][0],
        wrappers)
    peak = torch.cuda.max_memory_allocated()
    warm, prof = device_profile(lambda: run_cli(
        ["-g", fa, "-o", o + "_warm", *CLI_ARGS, "--index-type", "fm",
         "--device", "cuda", fq]))
    if not os.path.exists(csr_out + ".sam"):
        run_cli(["-g", fa, "-o", csr_out, *CLI_ARGS, "--device", "cuda", fq])
    equal = (sam_body(o + ".sam") == sam_body(csr_out + ".sam")
             and file_bytes(o + ".sgr") == file_bytes(csr_out + ".sgr"))
    n, n_mapped, acc = sam_accuracy(o + ".sam")
    failures = []
    if not equal or n != N_READS or acc < 0.999:
        failures.append(f"map_fm: equal to csr {equal} accuracy {acc}")
    # seeds of the first batch, both strands, on both indexes
    cfg = MapperConfig(mer_size=12, seed_jump=5, max_read_len=104,
                       max_candidates=32, batch_size=8192)
    gen = builder.Genome.from_fasta(fa)
    t0 = time.perf_counter()
    fmi = fm.build_fm_index(gen, cfg)
    fm_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = builder.build_index(gen, cfg)
    csr_build_s = time.perf_counter() - t0
    batch = next(io_fastq.batch_reads_native(fq, cfg))
    m_fm = pl.TorchMapper(gen, fmi, cfg, device="cuda")
    m_csr = pl.TorchMapper(gen, csr, cfg, device="cuda")
    dev = torch.device("cuda")
    codes = torch.from_numpy(np.asarray(batch.codes, np.int8)).to(dev)
    lens = torch.from_numpy(np.asarray(batch.lens, np.int32)).to(dev)
    rc, _ = pl.revcomp_batch(codes, torch.zeros(
        codes.shape + (4,), dtype=torch.int32, device=dev), lens)
    codes2 = torch.cat([codes, rc], dim=0)
    st = m_fm.state
    off = st["offsets"]
    km, bad = pl.seed_kmers(codes2, off, cfg.mer_size)
    fm_args = [st[k] for k in ("sa", "bwt_words", "occ", "c_table")]
    cs = m_csr.state
    a = fm.fm_hits(km, bad, *fm_args, off, cfg)
    b = pl.csr_hits(km, bad, cs["bucket_start"], cs["positions"], off, cfg)
    same_sets = bool(torch.equal(torch.sort(a, dim=-1).values,
                                 torch.sort(b, dim=-1).values))
    seed_equal = all(torch.equal(x, y) for x, y in zip(m_fm._seed(codes2),
                                                       m_csr._seed(codes2)))
    if not (same_sets and seed_equal):
        failures.append(f"map_fm: FM and CSR candidates differ (sets "
                        f"{same_sets}, seed stage {seed_equal})")
    res = dict(reads=n, mapped=n_mapped, mapped_rate=n_mapped / max(n, 1),
               accuracy=acc, equal_to_csr=equal, launches=launches,
               map_s=done["map_s"], reads_per_s=done["reads_per_s"],
               device_s=done["device_s"], host_s=done["host_s"],
               index_s=done["index_s"], peak_device_bytes=peak,
               held_before_bytes=held,
               warm_map_s=warm["map_s"], warm_reads_per_s=warm[
                   "reads_per_s"], **prof, fm_build_s=fm_build_s, csr_build_s=csr_build_s,
               sa_entries=int(fmi.sa.shape[0]),
               seed_rows=int(codes2.shape[0]), seeds_per_row=int(
                   off.shape[0]), live_seeds=int((~bad).sum()),
               candidates=int((a != pl.SENTINEL).sum()),
               same_candidate_sets=same_sets, seed_stage_equal=seed_equal,
               fm_hits_ms=cuda_ms(lambda: fm.fm_hits(
                   km, bad, *fm_args, off, cfg), 20),
               csr_hits_ms=cuda_ms(lambda: pl.csr_hits(
                   km, bad, cs["bucket_start"], cs["positions"], off, cfg),
                   20),
               seed_stage_fm_ms=cuda_ms(lambda: m_fm._seed(codes2), 10),
               seed_stage_csr_ms=cuda_ms(lambda: m_csr._seed(codes2), 10))
    del m_fm, m_csr
    torch.cuda.empty_cache()
    return res, failures, launches, spies


def map_seg(tmp, fq, genome_str, pl, wrappers):
    """Bench config 7 through GlobalSegmentedMapper(n_segments=2) on the
    card (counted), a warm profiled repeat, and TorchMapper on the whole
    genome: equal SAM and coverage; then the CLI's --segments 2 against no
    segments on the map genome split in two contigs.  Returns (result,
    failures, launches, spies)."""
    import numpy as np
    import torch
    from gnumap_tpu_torch.dist import segments
    from gnumap_tpu_torch.index import builder
    from gnumap_tpu_torch.io import fastq as io_fastq
    from gnumap_tpu_torch.utils import sim
    t0 = time.perf_counter()
    cfg, gen, _, recs = build_workload(0, 0, 0, config=7)
    cfg = dataclasses.replace(cfg, sam_out=True, sgr_out=True)
    batches = list(io_fastq.batch_reads(iter(recs), cfg))
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    seg = segments.GlobalSegmentedMapper(gen, cfg, device="cuda",
                                         n_segments=2)
    seg_index_s = time.perf_counter() - t0
    (res, wall), launches, spies = drive(
        lambda: run_stream(pl, seg, batches), PATHS["map_seg"][0], wrappers)
    peak = torch.cuda.max_memory_allocated()
    (res2, wall2), prof = device_profile(lambda: run_stream(pl, seg,
                                                            batches))
    n_seg, bases = seg.n_segments, list(seg.bases)
    del seg
    torch.cuda.empty_cache()
    whole = pl.TorchMapper(gen, builder.build_index(gen, cfg), cfg,
                           device="cuda")
    resw, wallw = run_stream(pl, whole, batches)
    del whole
    torch.cuda.empty_cache()
    equal = (res.sam_lines == resw.sam_lines == res2.sam_lines
             and np.array_equal(res.coverage, resw.coverage))
    n, n_mapped, acc = sam_lines_accuracy(tmp, "seg", res.sam_lines)
    failures = []
    if not equal or n != N_READS or acc < 0.999 or n_seg != 2:
        failures.append(f"map_seg: equal to whole {equal} accuracy {acc} "
                        f"segments {n_seg}")
    # the CLI: --segments 2 against none, the map genome in two contigs
    half = len(genome_str) // 2
    fa2 = os.path.join(tmp, "genome2.fa")
    sim.write_fasta(fa2, [("ref_a", genome_str[:half]),
                          ("ref_b", genome_str[half:])])
    cli = {}
    for run, extra in (("segments_2", ["--segments", "2"]), ("whole", [])):
        o = os.path.join(tmp, "seg_" + run)
        d = run_cli(["-g", fa2, "-o", o, *CLI_ARGS, "--device", "cuda",
                     *extra, fq])
        cli[run] = (sam_body(o + ".sam"), file_bytes(o + ".sgr"),
                    d["segments"], d["reads_per_s"])
    cli_equal = cli["segments_2"][:2] == cli["whole"][:2]
    if not cli_equal or (cli["segments_2"][2], cli["whole"][2]) != (2, 1):
        failures.append(f"map_seg cli: equal {cli_equal}")
    out = dict(genome_len=len(gen.codes), segments=n_seg,
               segment_bases=bases, reads=n, setup_s=setup_s,
               segment_index_s=seg_index_s, mapped=n_mapped,
               mapped_reference_bench=16_120,
               mapped_rate=n_mapped / max(n, 1), accuracy=acc,
               launches=launches, candidates=res.stats.n_candidates,
               map_s=wall, reads_per_s=n / wall, warm_map_s=wall2,
               warm_reads_per_s=n / wall2, whole_map_s=wallw,
               whole_reads_per_s=n / wallw, equal_to_whole=equal, **prof,
               profiled_idle_share=1 - prof["device_ms"] / 1e3 / wall2,
               peak_device_bytes=peak, held_before_bytes=held,
               cli=dict(equal=cli_equal,
                        reads_per_s={k: v[3] for k, v in cli.items()}))
    return out, failures, launches, spies


def cli_config(fa, fq):
    """The map phase's MapperConfig, as the CLI builds it from CLI_ARGS."""
    from gnumap_tpu_torch.cli import main as cli
    return cli.config_from_args(cli.build_arg_parser().parse_args(
        ["-g", fa, "-o", "unused", *CLI_ARGS, fq]))


def _hit_fields(out):
    return [[(h.strand, h.pos, h.score, h.cigar, h.ref_len, h.weight)
             for h in hits] for hits in out]


def dist_worker(spec_path: str) -> int:
    """One rank of a map_dist world (python3 chip_smoke.py --dist-worker
    SPEC): joins the world through multihost.initialize (NCCL when each rank
    has a card of its own, else gloo), maps the map phase's reads through
    DistMapper on the meshes the spec names and TorchMapper on the same
    card, twice each (cold, then warm), and writes what it saw to the
    spec's "out" file."""
    import torch
    from gnumap_tpu_torch.align import nw_band, nw_pure, nw_tb
    from gnumap_tpu_torch.cli import main as cli
    from gnumap_tpu_torch.dist import collectives, mesh as mesh_mod
    from gnumap_tpu_torch.dist import multihost
    from gnumap_tpu_torch.index import builder
    from gnumap_tpu_torch.io import sgr as sgr_io
    from gnumap_tpu_torch.pipeline import mapper as pl
    with open(spec_path) as f:
        spec = json.load(f)
    rank = spec["rank"]
    backend = multihost.initialize(spec["coordinator"], spec["world"], rank,
                                   device="cuda")
    cfg = cli_config(spec["fa"], spec["fq"])
    gen = builder.Genome.from_fasta(spec["fa"])
    idx = builder.build_index(gen, cfg)
    batches = list(cli.batch_stream([spec["fq"]], cfg))
    mods = {"nw_band": nw_band, "nw_pure": nw_pure, "nw_tb": nw_tb}

    def sgr(res):
        buf = io.StringIO()
        sgr_io.write_sgr(buf, gen, res.coverage, cfg.min_coverage_emit)
        return buf.getvalue()

    ref = pl.TorchMapper(gen, idx, cfg, device="cuda")
    ref_res = pl.map_stream(ref, iter(batches))
    want = [_hit_fields(ref.map_batch(b)) for b in batches]
    del ref
    torch.cuda.empty_cache()
    out = dict(rank=rank, backend=backend, device=str(torch.cuda.current_device()),
               runs=[])
    # (run, spy): B1 is held to its plain version once every mesh has run,
    # so that no rank waits for the check inside a timed pass
    checks = []
    for R, S, finish in spec["meshes"]:
        mesh = mesh_mod.make_mesh(R, S, device="cuda")
        dm = collectives.DistMapper(gen, idx, cfg, mesh, finish_impl=finish)
        run = dict(mesh=[R, S], finish=finish, coords=list(mesh.coords),
                   batches=len(batches))
        # the cold pass pays for lazy set-up (NCCL creates a communicator
        # at a group's first collective); the warm pass repeats it as is
        for phase in ("cold", "warm"):
            spy = (Spy(nw_band, "nw_scores_banded")
                   if phase == "cold" and rank == 0 and S == 2
                   and finish == "device" else None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            for m in mods.values():
                m.LAUNCHES = 0
            mesh_mod.COMM.reset()
            with spy or contextlib.nullcontext():
                t0 = time.perf_counter()
                if spec["stream"]:
                    res = pl.map_stream(dm, iter(batches))
                    got = None
                else:
                    got = [_hit_fields(dm.map_batch(b)) for b in batches]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = {n: m.LAUNCHES for n, m in mods.items()}
            comm = dataclasses.asdict(mesh_mod.COMM)
            nb = len(batches)
            rec = dict(wall_s=wall, reads_per_s=N_READS / wall,
                       launches=launches,
                       collective_s_per_batch=comm["seconds"] / nb,
                       collective_bytes_per_batch=comm["bytes"] / nb,
                       staged_bytes_per_batch=comm["staged_bytes"] / nb,
                       collective_calls=comm["calls"],
                       peak_device_bytes=torch.cuda.max_memory_allocated(),
                       held_before_bytes=held)
            if spec["stream"]:
                rec["sam_equal"] = res.sam_lines == ref_res.sam_lines
                rec["sgr_equal"] = sgr(res) == sgr(ref_res)
                rec["equal"] = rec["sam_equal"] and rec["sgr_equal"]
            else:
                rec["equal"] = got == want
            run[phase] = rec
            if spy is not None:
                checks.append((run, spy))
        out["runs"].append(run)
        del dm
        torch.cuda.empty_cache()
    for run, spy in checks:
        run["nw_band_c16"] = main_path_check(
            "nw_band", spy, nw_band.nw_scores_banded_plain)
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    multihost.barrier("map_dist_done")
    multihost.shutdown()
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp, name, cmds, timeout):
    """Start one process a rank (cmds[r] the argv of rank r), each with
    stdout and stderr in files, and wait for all until the deadline; past
    it, or when a rank fails, every rank still running is killed.  Returns
    (ok, [stdout text of each rank]); a failed rank's stderr is printed."""
    procs, logs = [], []
    for r, cmd in enumerate(cmds):
        o = open(os.path.join(tmp, f"{name}.r{r}.out"), "w+")
        e = open(os.path.join(tmp, f"{name}.r{r}.err"), "w+")
        logs.append((o, e))
        procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=o, stderr=e))
    deadline = time.monotonic() + timeout
    ok = True
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                ok = False
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for r, (p, (o, e)) in enumerate(zip(procs, logs)):
        o.seek(0)
        e.seek(0)
        outs.append(o.read())
        err = e.read()
        o.close()
        e.close()
        if p.returncode != 0:
            ok = False
            print(f"map_dist {name} rank {r}: exit {p.returncode}\n"
                  f"{err[-4000:]}", file=sys.stderr)
    return ok, outs


def map_dist(tmp, fa, fq, genome_str):
    """The reads x index mesh and the multi-host CLI on the card (see the
    module docstring).  Returns (result, failures, the B1 check at C = 16
    or None)."""
    import torch
    from gnumap_tpu_torch.utils import sim
    failures = []
    held = torch.cuda.memory_allocated()
    worlds = {}
    b1 = None
    for name, world, meshes, stream in (
            ("world1_nccl", 1, [[1, 1, "device"]], True),
            ("world2_gloo", 2, [[2, 1, "device"], [1, 2, "device"],
                                [1, 2, "host"]], False)):
        coord = f"localhost:{_free_port()}"
        cmds = []
        for r in range(world):
            spec = dict(rank=r, world=world, coordinator=coord, fa=fa,
                        fq=fq, meshes=meshes, stream=stream,
                        out=os.path.join(tmp, f"{name}.r{r}.json"))
            sp = os.path.join(tmp, f"{name}.r{r}.spec")
            with open(sp, "w") as f:
                json.dump(spec, f)
            cmds.append([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                         "--dist-worker", sp])
        t0 = time.perf_counter()
        ok, _ = run_ranks(tmp, name, cmds, 300)
        if not ok:
            failures.append(f"map_dist {name}: a rank failed or timed out")
            continue
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"{name}.r{r}.json")) as f:
                ranks.append(json.load(f))
        worlds[name] = dict(seconds=time.perf_counter() - t0, ranks=ranks)
        want_backend = "nccl" if world == 1 else "gloo"
        for rk in ranks:
            if rk["backend"] != want_backend:
                failures.append(f"map_dist {name} rank {rk['rank']}: "
                                f"backend {rk['backend']}")
            for run in rk["runs"]:
                need = (DIST_KERNELS if run["finish"] == "device"
                        else ("nw_band",))
                for phase in ("cold", "warm"):
                    what = (f"map_dist {name} rank {rk['rank']} mesh "
                            f"{run['mesh']} {run['finish']} {phase}")
                    if not run[phase]["equal"]:
                        failures.append(f"{what}: differs from TorchMapper")
                    for k in need:
                        if run[phase]["launches"][k] <= 0:
                            failures.append(f"{what}: {k} never launched")
                if "nw_band_c16" in run:
                    b1 = run["nw_band_c16"]
    if b1 is None:
        failures.append("map_dist: no B1 check at C = 16")
    # (c) the CLI on two ranks against the single-process CLI
    half = len(genome_str) // 2
    fa2 = os.path.join(tmp, "genome2.fa")
    sim.write_fasta(fa2, [("ref_a", genome_str[:half]),
                          ("ref_b", genome_str[half:])])
    cli = {}
    # (name, genome, flags of both runs, flags of the two-rank run only,
    # files compared beside the SAM body)
    for run, g, both, extra, exts in (
            ("hosts2_snp", fa, ["--snp"], [], ("sgr", "sgrex")),
            ("segments2_hosts2", fa2, ["--segments", "2"], [], ("sgr",)),
            ("c2_hosts2", fa, [], ["-c", "2"], ("sgr",))):
        single = os.path.join(tmp, f"dist_{run}_single")
        multi = os.path.join(tmp, f"dist_{run}_multi")
        base = ["-g", g, *CLI_ARGS, "--device", "cuda", *both, fq]
        d1 = run_cli(base + ["-o", single])
        coord = f"localhost:{_free_port()}"
        cmds = [[sys.executable, "-m", "gnumap_tpu_torch.cli.main", *base,
                 "-o", multi, *extra, "--num-hosts", "2", "--host-id",
                 str(h), "--coordinator", coord] for h in range(2)]
        t0 = time.perf_counter()
        ok, outs = run_ranks(tmp, f"cli_{run}", cmds, 300)
        secs = time.perf_counter() - t0
        if not ok:
            failures.append(f"map_dist cli {run}: a rank failed or timed "
                            "out")
            continue
        done = [json.loads([x for x in o.splitlines()
                            if x.startswith("{")][-1]) for o in outs]
        equal = sam_body(single + ".sam") == sam_body(multi + ".sam")
        for ext in exts:
            equal &= (file_bytes(f"{single}.{ext}")
                      == file_bytes(f"{multi}.{ext}"))
        shards_left = [f for f in os.listdir(tmp)
                       if f.startswith(os.path.basename(multi) + ".sam.host")]
        if not equal or shards_left:
            failures.append(f"map_dist cli {run}: equal {equal} shards left "
                            f"{shards_left}")
        cli[run] = dict(
            equal=equal, seconds=secs, single_reads_per_s=d1["reads_per_s"],
            reads_per_s=[d["reads_per_s"] for d in done],
            reads=[d["reads"] for d in done], segments=done[0]["segments"],
            collectives=[d.get("collectives") for d in done])
    res = dict(held_before_bytes=held, worlds=worlds, cli=cli,
               note="two ranks on one card share it: not a scaling figure")
    return res, failures, b1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run")
    ap.add_argument("--dist-worker", default=None, metavar="SPEC",
                    help="run one rank of a map_dist world (the phase starts "
                         "these itself)")
    ap.add_argument("--sass-out", default=None,
                    help="write cuobjdump -sass of the kernels the build "
                         "phase counts (B1 and B2 at bw 42, B4 and B3 at W 144, "
                         "banded B3 at W 128) to this file")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.dist_worker:
        return dist_worker(args.dist_worker)
    import numpy as np
    from gnumap_tpu_torch import _build
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.core import packing
    from gnumap_tpu_torch.native import lib as native_lib
    from gnumap_tpu_torch.utils import sim
    from gnumap_tpu_torch.align import nw_band, nw_full, nw_pure, nw_tb
    from gnumap_tpu_torch.pipeline import mapper as pl
    from gnumap_tpu_torch.posterior import accum

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # always from the sources: drop any library an earlier run left
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    if not native_lib.available():
        raise RuntimeError(
            "native host library did not build or load (host_finish would "
            "drop to the pure-Python oracle and the host times would mean "
            "nothing): " + _build.BUILD_LOG.get("gnumap_host", ""))
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         native_host_lib=True, native_host_lib_path=os.path.relpath(
             _build.HOST_SO, ROOT), native_build_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    _build.build(_build.sources())
    for name in _build.sources():
        _build.load(name)
    ptxas = {n: ptxas_summary(_build.BUILD_LOG[n]) for n in _build.sources()}
    build_s = time.perf_counter() - t0
    # B1 at the map path's shape: resident warps per multiprocessor for each
    # band width, and the opcodes of the bw = 42 kernel
    # (the library's occupancy query: blocks of 128 threads, C 32, L 104)
    blocks = _build.load("nw_band").nw_band_resident_blocks
    resident = {str(bw): 4 * blocks(bw, 32, 104) for bw in range(10, 63, 4)}
    if min(resident.values()) <= 0:
        raise RuntimeError(f"nw_band: no occupancy at some width: {resident}")
    sass, sass_text = sass_summary(
        os.path.join(_build.BUILD_DIR, "libnw_band.so"), "ILi42E")
    # B4 and B3 at the widths of the smoke sets (C 32, L 104): resident warps
    # (B4: blocks of 4 warps; B3: hits, 32 / 16 lanes each, a warp a block)
    # and the opcodes of the W 144 kernels, whose row is unrolled once
    full_blocks = _build.load("nw_full").nw_full_resident_blocks
    tb_hits = _build.load("nw_tb").nw_tb_resident_hits
    full_resident = {str(W): 4 * full_blocks(W, 32, 104)
                     for W in (136, 140, 144, 172, 256)}
    tb_resident = {f"{W}{'b' if b else ''}": tb_hits(W, 104, b)
                   for W, b in ((128, 1), (136, 0), (140, 0), (144, 0),
                                (172, 0), (256, 0))}
    if min(full_resident.values()) <= 0 or min(tb_resident.values()) <= 0:
        raise RuntimeError(f"nw_full / nw_tb: no occupancy at some width: "
                           f"{full_resident} {tb_resident}")
    # B2 (8 lanes a hit, L 104) for each band width, and B5's blocks of 256
    pure_warps = _build.load("nw_pure").nw_pure_resident_warps
    pure_resident = {str(bw): pure_warps(bw, 104) for bw in range(10, 63, 4)}
    accum_blocks = _build.load("accum_rmw").accum_rmw_resident_blocks()
    if min(pure_resident.values()) <= 0 or accum_blocks <= 0:
        raise RuntimeError(f"nw_pure / accum_rmw: no occupancy: "
                           f"{pure_resident} {accum_blocks}")
    row_sass = {}
    for lib, entry in (("nw_pure", "nw_pure_kernelILi42E"),
                       ("nw_full", "nw_full_kernelILi18E"),
                       ("nw_tb", "nw_tb_kernelILi9ELb0E"),
                       ("nw_tb", "nw_tb_kernelILi8ELb1E")):
        counts, text = sass_summary(
            os.path.join(_build.BUILD_DIR, f"lib{lib}.so"), entry)
        sass_text += text
        row_sass[entry] = None if counts is None else dict(
            {k: counts.get(k, 0) for k in SASS_OPS}, total=sum(
                counts.values()))
    if args.sass_out and sass_text:
        os.makedirs(os.path.dirname(os.path.abspath(args.sass_out)),
                    exist_ok=True)
        with open(args.sass_out, "w") as f:
            f.write(sass_text)
    emit("build", seconds=build_s, sources=_build.sources(), ptxas=ptxas,
         nw_band_resident_warps_per_sm=resident,
         nw_band_bw42_sass=None if sass is None else {
             k: sass.get(k, 0) for k in SASS_OPS},
         nw_band_bw42_sass_total=None if sass is None else sum(
             sass.values()),
         nw_full_resident_warps_per_sm=full_resident,
         nw_tb_resident_hits_per_sm=tb_resident,
         nw_pure_resident_warps_per_sm=pure_resident,
         accum_rmw_resident_blocks_per_sm=accum_blocks, row_sass=row_sass)
    spills = {n: {k: v[1] for k, v in ptxas[n].items() if v[1]}
              for n in ("nw_pure", "accum_rmw")}
    if any(spills.values()):
        raise RuntimeError(f"register spills: {spills}")

    genome_str = sim.random_genome(GENOME_LEN, seed=0)
    genome_np = packing.encode(genome_str)
    genome_t = torch.from_numpy(genome_np).cuda()
    wrappers = {"nw_band": (nw_band, "nw_scores_banded"),
                "nw_pure": (nw_pure, "nw_pure_banded"),
                "nw_tb": (nw_tb, "nw_traceback"),
                "nw_full": (nw_full, "nw_scores_full"),
                "accum": (accum, "apply_deltas_pair")}
    plains = {"nw_band": nw_band.nw_scores_banded_plain,
              "nw_pure": nw_pure.nw_pure_banded_plain,
              "nw_tb": nw_tb.nw_traceback_plain,
              "nw_full": nw_full.nw_scores_full_plain,
              "accum": accum.apply_deltas_pair_plain}
    kernels = {n: dict(name=n, route="cuda", source=src, replaces=rep,
                       launches=None, path=OWN_PATH[n], mismatches=0,
                       max_abs_err=0, ms=None, plain_ms=None, bound_ms=None,
                       bound_by=None, library_ms=None, live=None)
               for n, (src, rep) in KERNELS.items()}
    failures = []

    def record(name, res, what):
        k = kernels[name]
        k["mismatches"] += res["mismatches"]
        k["max_abs_err"] = max(k["max_abs_err"], res["max_abs_err"])
        if res["mismatches"] or res.get("oracle_mismatches"):
            failures.append(f"{what} gap_slack {res.get('gap_slack')}")

    def timed(name, res):
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "live"):
            kernels[name][key] = res[key]

    def path_done(path, launches, spies):
        """Per-path launch check; then each spied kernel on the inputs of
        its first call in the run."""
        on, off = PATHS[path]
        for name in on:
            if launches[name] <= 0:
                failures.append(f"{path}: {name} kernel never launched")
        for name in off:
            if launches[name] != 0:
                failures.append(f"{path}: {name} launched {launches[name]} "
                                "times off its path")
        for name, want in PATH_LAUNCHES.get(path, {}).items():
            if launches[name] != want:
                failures.append(f"{path}: {name} launched {launches[name]} "
                                f"times, expected {want}")
        for name, cnt in launches.items():
            if OWN_PATH[name] == path:
                kernels[name]["launches"] = cnt
        for name, sp in spies.items():
            if sp.first is None:
                if launches[name] > 0:
                    failures.append(f"{path}: {name} launched but no eager "
                                    "call under drive gave its inputs")
                continue
            r = main_path_check(name, sp, plains[name])
            emit(f"{path}_{name}", **r)
            record(name, r, f"{name} on the {path} path's inputs")
            if OWN_PATH[name] == path:
                timed(name, r)

    if "kernel_b1" in only:
        rng = np.random.default_rng(1)
        cfg = MapperConfig(max_read_len=104, max_candidates=32)
        res = check_b1(rng, genome_np, genome_t, 16_384, 32, cfg, 64, 20)
        emit("kernel_b1", **res)
        checks = [res]
        for slack, extra in BANDS:
            r = check_b1(rng, genome_np, genome_t, 512, 32,
                         MapperConfig(max_read_len=104, max_candidates=32,
                                      gap_slack=slack, **extra), 24, 0)
            emit("kernel_b1_band", scoring=extra or "default", **r)
            checks.append(r)
        for r in checks:
            record("nw_band", r, "kernel_b1")
        timed("nw_band", res)
        for r in check_b1_live_sets(rng, genome_np, genome_t, 16_384, 32,
                                    24, 20):
            emit("kernel_b1_set", **r)
            record("nw_band", r, f"kernel_b1 set {r['set']}")
            if r["dead_not_neg_inf"]:
                failures.append(f"kernel_b1 set {r['set']} gap_slack "
                                f"{r['gap_slack']}: a dead slot is not "
                                "NEG_INF")

    if "kernel_b4" in only:
        rng = np.random.default_rng(4)
        cfg = MapperConfig(max_read_len=104, max_candidates=32, gap_slack=16)
        res = check_b1(rng, genome_np, genome_t, 16_384, 32, cfg, 64, 20)
        emit("kernel_b4", **res)
        record("nw_full", res, "kernel_b4")
        timed("nw_full", res)
        for slack, extra in FULL:
            r = check_b1(rng, genome_np, genome_t, 512, 32,
                         MapperConfig(max_read_len=104, max_candidates=32,
                                      gap_slack=slack, **extra), 24, 0)
            emit("kernel_b4_width", scoring=extra or "default", **r)
            record("nw_full", r, "kernel_b4")
        for r in check_b1_live_sets(rng, genome_np, genome_t, 16_384, 32,
                                    24, 10, FULL_SET_SLACKS):
            emit("kernel_b4_set", **r)
            record("nw_full", r, f"kernel_b4 set {r['set']}")
            if r["dead_not_neg_inf"]:
                failures.append(f"kernel_b4 set {r['set']} gap_slack "
                                f"{r['gap_slack']}: a dead slot is not "
                                "NEG_INF (0 at length 0)")

    tb_phases = only & {"kernel_b2", "kernel_b3"}
    if tb_phases:
        rng = np.random.default_rng(2)
        genome_k = genome_np.copy()
        genome_k[TANDEM_AT:TANDEM_AT + 400] = np.tile(
            np.array([0, 1, 2, 3], np.int8), 100)
        genome_kt = torch.from_numpy(genome_k).cuda()
        cfg = MapperConfig(max_read_len=104, max_candidates=32)
        res = check_tb_kernels(rng, genome_k, genome_kt, 16_384, cfg, 64,
                               20, tb_phases)
        for phase, r in res.items():
            emit(phase, **r)
            name = "nw_pure" if phase == "kernel_b2" else "nw_tb"
            record(name, r, phase)
            timed(name, r)
        for slack, extra in BANDS:
            more = check_tb_kernels(
                rng, genome_k, genome_kt, 512,
                MapperConfig(max_read_len=104, max_candidates=32,
                             gap_slack=slack, **extra), 24, 0, tb_phases)
            for phase, r in more.items():
                emit(phase + "_band", scoring=extra or "default", **r)
                record("nw_pure" if phase == "kernel_b2" else "nw_tb", r,
                       phase)
        if "kernel_b2" in only:
            for r in check_b2_sets(rng, genome_k, genome_kt, 16_384, 10):
                emit("kernel_b2_set", **r)
                record("nw_pure", r, f"kernel_b2 set {r['set']}")
                if r["dead_not_zero"]:
                    failures.append(f"kernel_b2 set {r['set']} gap_slack "
                                    f"{r['gap_slack']}: a dead slot is not "
                                    "(false, 0)")
        if "kernel_b3" in only:   # unbanded: band=None, B4's scores
            for slack, H, reps in ((16, 16_384, 20), (14, 512, 0),
                                   (30, 512, 0)):
                r = check_tb_kernels(
                    rng, genome_k, genome_kt, H,
                    MapperConfig(max_read_len=104, max_candidates=32,
                                 gap_slack=slack), 64 if reps else 24, reps,
                    {"kernel_b3"})["kernel_b3"]
                emit("kernel_b3_unbanded", **r)
                record("nw_tb", r, "kernel_b3 unbanded")
            for r in check_tb_live_sets(rng, genome_k, genome_kt, 16_384,
                                        10):
                emit("kernel_b3_set", **r)
                record("nw_tb", r, f"kernel_b3 set {r['set']}")
                if r["dead_not_zero"]:
                    failures.append(f"kernel_b3 set {r['set']} gap_slack "
                                    f"{r['gap_slack']}: a dead slot has ops "
                                    "or jfin other than 0")

    if "kernel_b5" in only:
        rng = np.random.default_rng(5)
        for rowmul, order, H, reps in ((1, "sorted", 16_384, 20),
                                       (4, "sorted", 16_384, 20),
                                       (4, "any", 4_096, 0)):
            r = check_b5(rng, rowmul, order, 1 << 18, H, reps)
            emit("kernel_b5", **r)
            record("accum", r, f"kernel_b5 rowmul {rowmul} {order}")
            if not r["repeat_equal"]:
                failures.append(f"kernel_b5 rowmul {rowmul}: a repeat "
                                "launch gave other bits")
            if rowmul == 4 and reps:
                timed("accum", r)
        for r in check_b5_sets(rng, 10):
            emit("kernel_b5_set", **r)
            record("accum", r, f"kernel_b5 set {r['set']}")
            if not r["repeat_equal"]:
                failures.append(f"kernel_b5 set {r['set']}: a repeat launch "
                                "gave other bits")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fa = os.path.join(tmp, "genome.fa")
        sim.write_fasta(fa, [("ref_sim", genome_str)])
        reads = sim.simulate_reads(genome_str, N_READS, READ_LEN, seed=7,
                                   sub_rate=0.01, contig="ref_sim")
        fq = os.path.join(tmp, "reads.fastq")
        sim.write_fastq(fq, reads)
        out = os.path.join(tmp, "map")
        if "host_mem" in only:
            t0 = time.perf_counter()
            res, fails = host_mem(fa, fq)
            emit("host_mem", seconds=time.perf_counter() - t0, **res)
            failures.extend(fails)
        if "map" in only:
            t0 = time.perf_counter()
            done, launches, spies = drive(
                lambda: run_cli(["-g", fa, "-o", out, *CLI_ARGS, "--device",
                                 "cuda", fq]), PATHS["map"][0], wrappers)
            wall = time.perf_counter() - t0
            n, n_mapped, acc = sam_accuracy(out + ".sam")
            sgr = np.loadtxt(out + ".sgr", usecols=2, ndmin=1)
            emit("map", reads=n, wall_s=wall, map_s=done["map_s"],
                 reads_per_s=done["reads_per_s"],
                 peak_device_bytes=done.get("peak_device_bytes"),
                 mapped_rate=n_mapped / max(n, 1), accuracy=acc,
                 launches=launches, device_s=done["device_s"],
                 host_s=done["host_s"], index_s=done["index_s"],
                 candidates=done["candidates"], sgr_rows=int(sgr.size),
                 sgr_finite=bool(np.isfinite(sgr).all()))
            if n != N_READS or acc < 0.999 or not np.isfinite(sgr).all():
                failures.append(f"map: reads {n} accuracy {acc}")
            path_done("map", launches, spies)
        if "map_host" in only:
            real = pl.TorchMapper
            host = os.path.join(tmp, "host")
            pl.TorchMapper = functools.partial(real, finish_impl="host")
            try:
                done_h = run_cli(["-g", fa, "-o", host, *CLI_ARGS,
                                  "--device", "cuda", fq])
            finally:
                pl.TorchMapper = real
            # the device finish once more, now that its kernels are warm
            warm = os.path.join(tmp, "warm")
            done_w = run_cli(["-g", fa, "-o", warm, *CLI_ARGS, "--device",
                              "cuda", fq])
            same = (sam_body(warm + ".sam") == sam_body(host + ".sam")
                    and file_bytes(warm + ".sgr") == file_bytes(host + ".sgr"))
            emit("map_host", reads_per_s=done_h["reads_per_s"],
                 map_s=done_h["map_s"], device_s=done_h["device_s"],
                 host_s=done_h["host_s"], equal_to_device_finish=same,
                 device_finish_warm=dict(
                     reads_per_s=done_w["reads_per_s"], map_s=done_w["map_s"],
                     device_s=done_w["device_s"], host_s=done_w["host_s"]))
            if not same:
                failures.append("map_host: host and device finish outputs "
                                "differ")
        if "map_indel" in only:
            res, spy = map_indel(tmp, fa, genome_str, pl, wrappers)
            emit("map_indel", **res)
            if not (res["sam_equal"] and res["sgr_equal"]
                    and res["n_indel"] > 0):
                failures.append("map_indel")
            # banded B3 with live hits: the inputs of the run's first call
            r = main_path_check("nw_tb", spy, plains["nw_tb"])
            emit("map_indel_nw_tb", **r)
            record("nw_tb", r, "nw_tb on the map_indel path's inputs")
            if r["live"] <= 0:
                failures.append("map_indel: B3 saw no live hit")
        if "parity" in only:
            sub = os.path.join(tmp, "sub.fastq")
            sim.write_fastq(sub, reads[:1024])
            outs = {}
            for dev in ("cuda", "cpu"):
                o = os.path.join(tmp, f"par_{dev}")
                d = run_cli(["-g", fa, "-o", o, *CLI_ARGS, "--device", dev,
                             sub])
                outs[dev] = (sam_body(o + ".sam"), file_bytes(o + ".sgr"), d)
            same_sam = outs["cuda"][0] == outs["cpu"][0]
            same_sgr = outs["cuda"][1] == outs["cpu"][1]
            emit("parity", reads=1024, sam_equal=same_sam,
                 sgr_equal=same_sgr,
                 sam_records=outs["cuda"][0].count("\n"),
                 cpu_map_s=outs["cpu"][2]["map_s"],
                 cuda_map_s=outs["cuda"][2]["map_s"])
            if not (same_sam and same_sgr):
                failures.append("parity: cuda and cpu outputs differ")
        if "golden" in only:
            res, fails, launches, spies = golden(tmp, wrappers)
            emit("golden", **res)
            failures.extend(fails)
            path_done("golden", launches, spies)
        if "map_ckpt" in only:
            res, fails, launches = map_ckpt(tmp, fa, fq, out, wrappers)
            emit("map_ckpt", **res)
            failures.extend(fails)
            path_done("map_ckpt", launches, {})
        if "map_unbanded" in only:
            res, launches, spies = map_unbanded(tmp, fq, fa, pl, wrappers)
            emit("map_unbanded", **res)
            if not (res["reads"] == N_READS and res["accuracy"] >= 0.999
                    and res["equal_to_host_finish"] and res["sgr_finite"]):
                failures.append(f"map_unbanded: reads {res['reads']} "
                                f"accuracy {res['accuracy']} equal "
                                f"{res['equal_to_host_finish']}")
            path_done("map_unbanded", launches, spies)
        if "map_acc" in only:
            res, fails, launches, spies = map_acc(tmp, fa, reads, pl,
                                                  wrappers)
            emit("map_acc", **res)
            failures.extend(fails)
            path_done("map_acc", launches, spies)
        for phase, fn in (("map_multi", map_multi), ("map_cfg3", map_cfg3)):
            if phase in only:
                res, fails, launches, spies = fn(tmp, pl, wrappers)
                emit(phase, **res)
                failures.extend(fails)
                path_done(phase, launches, spies)
        if "graph" in only:
            t0 = time.perf_counter()
            res, fails = graph_programs(tmp, pl)
            emit("graph", seconds=time.perf_counter() - t0, **res)
            failures.extend(fails)
        config10.cache_clear()
        if "map_bs" in only:
            res, fails, launches, spies = map_bs(tmp, fa, genome_str, pl,
                                                 wrappers)
            emit("map_bs", **res)
            failures.extend(fails)
            path_done("map_bs", launches, spies)
        if "map_fm" in only:
            res, fails, launches, spies = map_fm(tmp, fa, fq, out, pl,
                                                 wrappers)
            emit("map_fm", **res)
            failures.extend(fails)
            path_done("map_fm", launches, spies)
        if "map_seg" in only:
            res, fails, launches, spies = map_seg(tmp, fq, genome_str, pl,
                                                  wrappers)
            emit("map_seg", **res)
            failures.extend(fails)
            path_done("map_seg", launches, spies)
        if "map_dist" in only:
            t0 = time.perf_counter()
            res, fails, b1 = map_dist(tmp, fa, fq, genome_str)
            emit("map_dist", seconds=time.perf_counter() - t0, **res)
            failures.extend(fails)
            if b1 is not None:
                emit("map_dist_nw_band", **b1)
                record("nw_band", b1, "nw_band at C = 16 on map_dist")

    if failures:
        raise RuntimeError("; ".join(failures))
    if only != set(PHASES):
        print(json.dumps({"partial": sorted(only)}))
        return 0
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
