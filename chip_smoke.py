#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: drive its main path once on one CUDA
card, hold every kernel of that path against its plain torch version, and
check the output.

    python3 chip_smoke.py                    # all phases, one card
    python3 chip_smoke.py --only device,build,kernel_b2,kernel_b3

Phases, one JSON line each; any failure raises and the exit code is not 0:
  device     card name and power limit, native host library present
  build      nvcc of every csrc/*.cu kernel, in parallel; ptxas registers
             and spills
  kernel_b1  csrc/nw_band.cu vs its plain torch version on the card at the
             map path's shapes (B2 = 16384 read-strands, C = 32, L = 104,
             band (9, 42)) plus edge rows; a sample vs oracle.nw_align;
             other band widths; CUDA-event timings
  kernel_b2  csrc/nw_pure.cu vs its plain version on H = 16384 retained-hit
             slots (L = 104, band (9, 42)): reads copied from the genome
             with substitutions and 1-2 bp indels, SENTINEL slots, anchors
             at the genome's ends, tandem-repeat ties; a sample vs
             oracle.nw_align(traceback=True); gap_slack 0, 1, 13 and a
             harsh scoring; CUDA-event timings
  kernel_b3  csrc/nw_tb.cu on the same slots, the same way; then unbanded
             (band=None) on such slots at gap_slack 16 (and 14, 30)
  kernel_b4  csrc/nw_full.cu (unbanded scoring) as kernel_b1, at gap_slack
             16 (16,384 x 32), then 14, 30 and the harsh scoring
  kernel_b5  csrc/accum_rmw.cu vs its serial plain version, bit for bit,
             on synthetic deltas with pileups and overlapping spans, both
             rowmuls, span starts sorted and in any order; a repeat launch
             gives the same bits; CUDA-event timings
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
             card: equal SAM bodies and SGR bytes, n_indel > 0
  parity     the first 1,024 reads mapped with --device cuda and
             --device cpu (device finish): equal SAM bodies and SGR bytes
  map_unbanded  the map phase's reads through TorchMapper(MapperConfig(
             gap_slack=16, ...)) and map_stream: unbanded scoring (B4) and
             the traceback on every retained hit (B3, band=None); device
             and host finish byte-equal, accuracy; B1 and B2 not launched
  map_acc    the reference's bench config 10 (bench.build_workload): a
             46,709,983-base genome with 40 x 20 repeat families, 16,384
             reads, SNP mode, SAM on, accumulated on the device twice (bit-
             equal) and on the host once (counts and SAM equal, coverage
             and tallies within 1e-5); then the CLI with --accumulate
             device --snp on 1,024 config-2 reads against --accumulate host
Each map phase sets every launch count to 0 before its run and fails unless
the kernels of its path launched.  Then a line with the kernels' JSON, a
line with nvidia-smi's name and power limit, and as the last line
{"ok": true, "device": {...}}.

Without a CUDA card it exits 2 and prints no result.  It reads and writes
only the repository checkout and a temporary directory.
"""

from __future__ import annotations

import argparse
import contextlib
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
          "kernel_b4", "kernel_b5", "map", "map_host", "map_indel", "parity",
          "map_unbanded", "map_acc")
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
         "map_acc": (("nw_band", "nw_pure", "nw_tb", "accum"), ("nw_full",))}
# the path whose launch counts a kernel reports
OWN_PATH = {"nw_band": "map", "nw_pure": "map", "nw_tb": "map",
            "nw_full": "map_unbanded", "accum": "map_acc"}
# unbanded configurations of kernel_b4: (gap_slack, MapperConfig extras)
FULL = ((14, {}), (30, {}),
        (16, dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5)))


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
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
    from gnumap_tpu.align import scoring
    from gnumap_tpu.core import pwm as pwm_mod
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
    from gnumap_tpu.oracle import oracle
    from gnumap_tpu_torch.align import nw_band
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
    return out


def ptxas_summary(log: str) -> dict:
    """nvcc -Xptxas -v output -> {template argument (band width or columns
    per lane): [registers, spill store bytes]} per kernel instantiation."""
    import re
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?ILi(\d+)E", line)
        if m:
            key = m.group(1)
            out[key] = [None, 0]
        elif key and "spill stores" in line:
            out[key][1] = int(re.search(r"(\d+) bytes spill stores",
                                        line).group(1))
        elif key and "Used" in line and "registers" in line:
            out[key][0] = int(re.search(r"Used (\d+) registers",
                                        line).group(1))
    return out


def tb_inputs(rng, genome, H, cfg):
    """Retained-hit slots for B2 and B3, built as
    tests/test_devtb.py::_mk_hits builds them: reads copied from the genome
    with 0-2 substitutions and, for 15% of them, a 1-2 bp insertion or
    deletion; every 8th slot SENTINEL; 1/16 of the hits copied from the
    period-4 tandem repeat at TANDEM_AT (several perfect placements in one
    window, so the smallest-column tie rule decides); 1/16 anchored at
    each end of the genome (windows partly outside it); a quarter of the
    lengths in [L/2, L].  Returns (emis int32[H, L, 5], cands, lens)."""
    import numpy as np
    from gnumap_tpu.align import scoring
    from gnumap_tpu.core import pwm as pwm_mod
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
    cands[7::8] = SENTINEL
    return emis.astype(np.int32), cands, lens


def check_tb_kernels(rng, genome_np, genome_t, H, cfg, n_oracle, reps,
                     which):
    """B2 (nw_pure) and B3 (nw_tb) kernels vs their plain versions on the
    card (exact equality of pure, jfin and ops), and a sample of hits with
    a positive score vs oracle.nw_align(traceback=True).  Scores come from
    the B1 kernel (B4 without a band), as on the map path; without a band
    only B3 runs, with band=None.  Returns {name: result}."""
    import numpy as np
    import torch
    from gnumap_tpu.oracle import oracle
    from gnumap_tpu_torch.align import nw_band, nw_pure, nw_tb
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
        out["kernel_b3"] = r
    return out


class Spy:
    """Wraps a kernel wrapper in its module: keeps the inputs of its first
    call, to time the kernel at exactly the shapes the main path gives it."""

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
    from gnumap_tpu.utils.sim import parse_truth
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
    n_mapped = n_ok = 0
    for name, lst in recs.items():
        if not lst:
            continue
        n_mapped += 1
        tc, tp, ts = parse_truth(name)
        best = max(w for w, *_ in lst)
        n_ok += any(w == best and c == tc and abs(p - tp) <= 3 and s == ts
                    for w, c, p, s in lst)
    return len(recs), n_mapped, n_ok / max(n_mapped, 1)


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


def map_indel(tmp, fa, genome_str, pl):
    """1,024 reads at indel_rate 0.02 mapped three ways: device finish on
    the card, device finish on the CPU, host finish on the card.  n_indel
    sums the indel-bearing hits of the card's device-finish blobs."""
    from gnumap_tpu.utils import sim
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

    outs, res = {}, {}
    for run, dev, fin in (("cuda_device", "cuda", "device"),
                          ("cpu_device", "cpu", "device"),
                          ("cuda_host", "cuda", "host")):
        o = os.path.join(tmp, run)
        pl.TorchMapper = functools.partial(real_mapper, finish_impl=fin)
        pl.decode_tb_blob = decode if run == "cuda_device" else real_decode
        try:
            d = run_cli(["-g", fa, "-o", o, *CLI_ARGS, "--device", dev, fq])
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
                gapped_records=gapped, **res)


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
    return out


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
    its accumulator in place, so each of its runs gets a copy."""
    import torch
    a, kw = spy.first
    if name == "accum":
        got = (spy.real(a[0].clone(), *a[1:], **kw),)
        ref = (plain(a[0].clone(), *a[1:], **kw),)
        mism = int((got[0].view(torch.int32)
                    != ref[0].view(torch.int32)).sum())
        err = float((got[0] - ref[0]).abs().max())
        buf, pbuf = a[0].clone(), a[0].clone()
        ms = cuda_ms(lambda: spy.real(buf, *a[1:], **kw), 20)
        pms = cuda_ms(lambda: plain(pbuf, *a[1:], **kw), 1)
    else:
        got, ref = spy.real(*a, **kw), plain(*a, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        mism = sum(int((g != r).sum()) for g, r in zip(got, ref))
        err = max(int((g.long() - r.long()).abs().max())
                  for g, r in zip(got, ref))
        ms = cuda_ms(lambda: spy.real(*a, **kw), 20)
        pms = cuda_ms(lambda: plain(*a, **kw), 3)
    return dict(shape=list(a[1].shape), ms=ms, plain_ms=pms,
                mismatches=mism, max_abs_err=err)


def map_unbanded(tmp, fq, fa, pl, wrappers):
    """The map phase's reads at gap_slack 16 (no band): TorchMapper and
    map_stream with the device finish (counted, then warm) and the host
    finish.  Returns (result, launches of the counted run, spies)."""
    import numpy as np
    import torch
    from gnumap_tpu.config import MapperConfig
    from gnumap_tpu.index import builder
    from gnumap_tpu.io import fastq as io_fastq, sgr as sgr_io
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


def map_acc(tmp, fa, reads, pl, wrappers):
    """Bench config 10 accumulated on the device twice and on the host
    once, then the CLI's --accumulate device --snp against --accumulate
    host on 1,024 config-2 reads.  Returns (result, failures, launches of
    the first device run, spies)."""
    import dataclasses
    import numpy as np
    import torch
    import bench
    from gnumap_tpu.io import fastq as io_fastq
    from gnumap_tpu.utils import sim
    t0 = time.perf_counter()
    cfg, gen, idx, recs = bench.build_workload(None, None, None, config=10)
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

    (d1, w1), launches, spies = drive(lambda: run("device"), ("accum",),
                                      wrappers)
    d2, w2 = run("device")
    h, wh = run("host")
    failures = []
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
        accum_mod = wrappers["accum"][0]
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
               device_runs_bit_equal=bit_equal, max_abs_err_vs_host=err,
               within_1e_5=close, sam_equal=sam_equal,
               sam_records="".join(h.sam_lines).count("\n"),
               cli=dict(sam_equal=cli["device"][0] == cli["host"][0],
                        sgr_rows=int(cli["device"][1].size),
                        sgr_max_abs_err=sgr_err,
                        accum_launches=cli["device"][2],
                        device_reads_per_s=cli["device"][3],
                        host_reads_per_s=cli["host"][3]))
    return res, failures, launches, spies


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from gnumap_tpu.config import MapperConfig
    from gnumap_tpu.core import packing
    from gnumap_tpu.native import lib as native_lib
    from gnumap_tpu.utils import sim
    from gnumap_tpu_torch import _build
    from gnumap_tpu_torch.align import nw_band, nw_full, nw_pure, nw_tb
    from gnumap_tpu_torch.pipeline import mapper as pl
    from gnumap_tpu_torch.posterior import accum

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if not native_lib.available():
        raise RuntimeError("native host library unavailable: host_finish "
                           "would drop to the pure-Python oracle")
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         native_host_lib=True)

    # always from the sources: drop any library an earlier run left
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    _build.build(_build.sources())
    for name in _build.sources():
        _build.load(name)
    ptxas = {n: ptxas_summary(log) for n, log in _build.BUILD_LOG.items()}
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
         ptxas=ptxas)

    genome_str = sim.random_genome(GENOME_LEN, seed=0)
    genome_np = packing.encode(genome_str)
    genome_t = torch.from_numpy(genome_np).cuda()
    wrappers = {"nw_band": (nw_band, "nw_scores_banded"),
                "nw_pure": (nw_pure, "nw_pure_banded"),
                "nw_tb": (nw_tb, "nw_traceback"),
                "nw_full": (nw_full, "nw_scores_full"),
                "accum": (accum, "apply_deltas")}
    plains = {"nw_band": nw_band.nw_scores_banded_plain,
              "nw_pure": nw_pure.nw_pure_banded_plain,
              "nw_tb": nw_tb.nw_traceback_plain,
              "nw_full": nw_full.nw_scores_full_plain,
              "accum": accum.apply_deltas_plain}
    kernels = {n: dict(name=n, route="cuda", source=src, replaces=rep,
                       launches=None, path=OWN_PATH[n], mismatches=0,
                       max_abs_err=0, ms=None, plain_ms=None)
               for n, (src, rep) in KERNELS.items()}
    failures = []

    def record(name, res, what):
        k = kernels[name]
        k["mismatches"] += res["mismatches"]
        k["max_abs_err"] = max(k["max_abs_err"], res["max_abs_err"])
        if res["mismatches"] or res.get("oracle_mismatches"):
            failures.append(f"{what} gap_slack {res.get('gap_slack')}")

    def timed(name, res):
        kernels[name]["ms"], kernels[name]["plain_ms"] = (res["ms"],
                                                          res["plain_ms"])

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
        for name, cnt in launches.items():
            if OWN_PATH[name] == path:
                kernels[name]["launches"] = cnt
        for name, sp in spies.items():
            if sp.first is None:
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

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fa = os.path.join(tmp, "genome.fa")
        sim.write_fasta(fa, [("ref_sim", genome_str)])
        reads = sim.simulate_reads(genome_str, N_READS, READ_LEN, seed=7,
                                   sub_rate=0.01, contig="ref_sim")
        fq = os.path.join(tmp, "reads.fastq")
        sim.write_fastq(fq, reads)
        out = os.path.join(tmp, "map")
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
            res = map_indel(tmp, fa, genome_str, pl)
            emit("map_indel", **res)
            if not (res["sam_equal"] and res["sgr_equal"]
                    and res["n_indel"] > 0):
                failures.append("map_indel")
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

    if failures:
        raise RuntimeError("; ".join(failures))
    if only != set(PHASES):
        print(json.dumps({"partial": sorted(only)}))
        return 0
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
