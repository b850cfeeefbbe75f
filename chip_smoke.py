#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: drive its main path once on one CUDA
card, hold every kernel of that path against its plain torch version, and
check the output.

    python3 chip_smoke.py                    # all phases, one card
    python3 chip_smoke.py --only device,build,kernel_b1

Phases, one JSON line each; any failure raises and the exit code is not 0:
  device     card name and power limit, native host library present
  build      nvcc of every csrc/*.cu kernel, in parallel
  kernel_b1  csrc/nw_band.cu vs its plain torch version on the card at the
             map path's shapes (B2 = 16384 read-strands, C = 32, L = 104,
             band (9, 42)) plus edge rows; a sample vs oracle.nw_align;
             other band widths; CUDA-event timings
  map        16,384 simulated 100 bp reads against a 4,641,652-base genome
             through the port's CLI (main(argv), --device cuda), SAM and
             SGR on; reads/s, mapped rate, accuracy from the read names,
             kernel launches during the run
  parity     the first 1,024 reads mapped with --device cuda and
             --device cpu: equal SAM bodies and equal SGR bytes
Then a line with the kernels' JSON, a line with nvidia-smi's name and power
limit, and as the last line {"ok": true, "device": {...}}.

Without a CUDA card it exits 2 and prints no result.  It reads and writes
only the repository checkout and a temporary directory.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernel_b1", "map", "parity")
GENOME_LEN = 4_641_652
N_READS = 16_384
READ_LEN = 100
CLI_ARGS = ["-m", "12", "-j", "5", "-L", "104", "-q", "32", "-B", "8192"]


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


def check_b1(rng, genome_np, genome_t, B2, C, cfg, n_oracle, reps):
    """Kernel vs plain (int32 equality) and vs the oracle on a sample."""
    import numpy as np
    import torch
    from gnumap_tpu.oracle import oracle
    from gnumap_tpu_torch.align import nw_band
    emis_t, cands, lens, emis = b1_inputs(rng, genome_np, B2, C, cfg)
    boff, bw = cfg.band()
    kw = dict(L=cfg.max_read_len, W=cfg.window_width(), slack=cfg.gap_slack,
              boff=boff, bw=bw, open_q=cfg.gap_open_q(),
              ext_q=cfg.gap_extend_q())
    dev = torch.device("cuda")
    args = (torch.from_numpy(emis_t).to(dev), torch.from_numpy(cands).to(dev),
            torch.from_numpy(lens).to(dev), genome_t)
    got = nw_band.nw_scores_banded(*args, **kw)
    torch.cuda.synchronize()
    ref = nw_band.nw_scores_banded_plain(*args, **kw)
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
    out = dict(gap_slack=cfg.gap_slack, band=[boff, bw], B2=B2, C=C,
               L=cfg.max_read_len, live_pairs=int(len(live)),
               mismatches=mism, max_abs_err=err, oracle_pairs=len(pick),
               oracle_mismatches=o_mism)
    if reps:
        out["ms"] = cuda_ms(lambda: nw_band.nw_scores_banded(*args, **kw),
                            reps)
        out["plain_ms"] = cuda_ms(
            lambda: nw_band.nw_scores_banded_plain(*args, **kw), 3)
    return out


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
    from gnumap_tpu_torch.align import nw_band

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
    ptxas = {n: [x.strip() for x in log.splitlines()
                 if "registers" in x or "spill" in x][:4]
             for n, log in _build.BUILD_LOG.items()}
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
         ptxas=ptxas)

    genome_str = sim.random_genome(GENOME_LEN, seed=0)
    genome_np = packing.encode(genome_str)
    genome_t = torch.from_numpy(genome_np).cuda()
    kernel = dict(name="nw_band", route="cuda",
                  source="gnumap_tpu_torch/csrc/nw_band.cu",
                  replaces="gnumap_tpu/align/nw_pallas.py:265",
                  launches=None, max_abs_err=0, ms=None, plain_ms=None)
    failures = []
    if "kernel_b1" in only:
        rng = np.random.default_rng(1)
        cfg = MapperConfig(max_read_len=104, max_candidates=32)
        res = check_b1(rng, genome_np, genome_t, 16_384, 32, cfg, 64, 20)
        emit("kernel_b1", **res)
        checks = [res]
        # the narrowest and widest bands, and a scoring whose emissions
        # reach below -open (mismatch -8, open 1, extend 0.5)
        harsh = dict(mismatch_score=-8.0, gap_open=1.0, gap_extend=0.5)
        for slack, extra in ((0, {}), (1, {}), (13, {}), (8, harsh)):
            r = check_b1(rng, genome_np, genome_t, 512, 32,
                         MapperConfig(max_read_len=104, max_candidates=32,
                                      gap_slack=slack, **extra), 24, 0)
            emit("kernel_b1_band", scoring=extra or "default", **r)
            checks.append(r)
        for r in checks:
            kernel["max_abs_err"] = max(kernel["max_abs_err"],
                                        r["max_abs_err"])
            if r["mismatches"] or r["oracle_mismatches"]:
                failures.append(f"kernel_b1 gap_slack {r['gap_slack']}")
        kernel["ms"], kernel["plain_ms"] = res["ms"], res["plain_ms"]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fa = os.path.join(tmp, "genome.fa")
        sim.write_fasta(fa, [("ref_sim", genome_str)])
        reads = sim.simulate_reads(genome_str, N_READS, READ_LEN, seed=7,
                                   sub_rate=0.01, contig="ref_sim")
        fq = os.path.join(tmp, "reads.fastq")
        sim.write_fastq(fq, reads)
        if "map" in only:
            # keep the main path's kernel inputs of its first batch, to time
            # the kernel at exactly the shapes and occupancy the path gives
            seen = []
            real = nw_band.nw_scores_banded

            def spy(*a, **kw):
                if not seen:
                    seen.append(([x.clone() for x in a], kw))
                return real(*a, **kw)

            out = os.path.join(tmp, "map")
            nw_band.nw_scores_banded = spy
            nw_band.LAUNCHES = 0
            t0 = time.perf_counter()
            try:
                done = run_cli(["-g", fa, "-o", out, *CLI_ARGS,
                                "--device", "cuda", fq])
            finally:
                nw_band.nw_scores_banded = real
            wall = time.perf_counter() - t0
            kernel["launches"] = nw_band.LAUNCHES
            n, n_mapped, acc = sam_accuracy(out + ".sam")
            sgr = np.loadtxt(out + ".sgr", usecols=2, ndmin=1)
            emit("map", reads=n, wall_s=wall, map_s=done["map_s"],
                 reads_per_s=done["reads_per_s"],
                 mapped_rate=n_mapped / max(n, 1), accuracy=acc,
                 nw_band_launches=kernel["launches"],
                 device_s=done["device_s"], host_s=done["host_s"],
                 index_s=done["index_s"], candidates=done["candidates"],
                 sgr_rows=int(sgr.size),
                 sgr_finite=bool(np.isfinite(sgr).all()))
            if kernel["launches"] <= 0:
                failures.append("map: nw_band kernel never launched")
            if n != N_READS or acc < 0.999 or not np.isfinite(sgr).all():
                failures.append(f"map: reads {n} accuracy {acc}")
            a, kw = seen[0]
            live = int((a[1] != nw_band.SENTINEL).sum())
            ms = cuda_ms(lambda: real(*a, **kw), 20)
            pms = cuda_ms(lambda: nw_band.nw_scores_banded_plain(*a, **kw),
                          3)
            diff = (real(*a, **kw).long()
                    - nw_band.nw_scores_banded_plain(*a, **kw).long())
            err = int(diff.abs().max())
            emit("kernel_b1_main_path", B2=int(a[1].shape[0]),
                 C=int(a[1].shape[1]), live_pairs=live, ms=ms, plain_ms=pms,
                 max_abs_err=err)
            kernel["ms"], kernel["plain_ms"] = ms, pms
            kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
            if err:
                failures.append("kernel_b1 on the main path's inputs")
        if "parity" in only:
            sub = os.path.join(tmp, "sub.fastq")
            sim.write_fastq(sub, reads[:1024])
            outs = {}
            for dev in ("cuda", "cpu"):
                o = os.path.join(tmp, f"par_{dev}")
                d = run_cli(["-g", fa, "-o", o, *CLI_ARGS, "--device", dev,
                             sub])
                with open(o + ".sgr", "rb") as f:
                    outs[dev] = (sam_body(o + ".sam"), f.read(), d)
            same_sam = outs["cuda"][0] == outs["cpu"][0]
            same_sgr = outs["cuda"][1] == outs["cpu"][1]
            emit("parity", reads=1024, sam_equal=same_sam,
                 sgr_equal=same_sgr,
                 sam_records=outs["cuda"][0].count("\n"),
                 cpu_map_s=outs["cpu"][2]["map_s"],
                 cuda_map_s=outs["cuda"][2]["map_s"])
            if not (same_sam and same_sgr):
                failures.append("parity: cuda and cpu outputs differ")

    if failures:
        raise RuntimeError("; ".join(failures))
    if only != set(PHASES):
        print(json.dumps({"partial": sorted(only)}))
        return 0
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
