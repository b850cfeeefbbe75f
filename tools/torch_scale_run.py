#!/usr/bin/env python
"""Sustained-scale run of the PyTorch / CUDA port: N reads (default 1M, at
bench config 2's scale) through the port's real CLI (``python -m
gnumap_tpu_torch.cli.main``, on the card) with SAM output, once plain and
once with checkpoints, recording reads/s, peak host RSS, peak device memory
and the checkpoint's cost to a JSON file.  The counterpart of
tools/scale_run.py: the same arguments and defaults, and a workload
generator that writes the same FASTA and FASTQ bytes from the same seeds.

Usage:
    python tools/torch_scale_run.py [--reads 1000000] [--out FILE]
    python tools/torch_scale_run.py --reads 10000000 --genome-len 46709983 \\
        --mer 13 --sgr --out torch_scale_10m.json

The workload is generated streaming to disk (FASTA + FASTQ) in --workdir
(default: a directory under the temporary directory), and kept there for a
later run of the same request (reads, genome length, read length,
--generator: a manifest beside the files records them); the reads and bases
reported are counted in the files.  Then the CLI runs as
a subprocess whose /proc RSS is sampled.  A warm-up run on the first 16,384
reads builds the kernels before the timed runs.  reads/s is the CLI's own
(reads / map_s, index build excluded); the checkpoint's cost is the
checkpointed run's map_s over the plain run's.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


GENERATORS = ("current", "e2e3748")


def gen_workload(td: str, n_reads: int, genome_len: int, read_len: int,
                 generator: str = "current"):
    """Random genome (seed 0) and reads (seed 7, 1% substitutions, both
    strands, truth in the names).  generator "current" writes what
    tools/scale_run.py writes now; "e2e3748" what it wrote at commit e2e3748,
    the reads SCALE_1M.json was recorded on (other draws from the same
    seed: 65,536 reads a chunk, qualities drawn before the errors, "+" for
    a draw below 0.5)."""
    from gnumap_tpu_torch.core import packing
    from gnumap_tpu_torch.utils import sim

    if generator not in GENERATORS:
        raise ValueError(f"generator {generator!r} not in {GENERATORS}")
    old = generator == "e2e3748"
    genome = sim.random_genome(genome_len, seed=0)
    fa = os.path.join(td, "genome.fa")
    fq = os.path.join(td, "reads.fq")
    sim.write_fasta(fa, [("ref_sim", genome)])
    g = packing.encode(genome)
    G = len(g)
    rng = np.random.default_rng(7)
    chunk = 65536 if old else 131072
    lut = np.frombuffer(b"ACGTN", np.uint8)
    rl = read_len
    with open(fq, "wb") as f:
        done = 0
        while done < n_reads:
            n = min(chunk, n_reads - done)
            pos = rng.integers(0, G - rl - 4, size=n)
            if old:
                minus = ~(rng.random(n) < 0.5)
                quals = rng.integers(20, 41, size=(n, rl))
                err = rng.random((n, rl)) < 0.01
                shift = rng.integers(1, 4, size=(n, rl))
            else:
                minus = rng.random(n) < 0.5
                err = rng.random((n, rl)) < 0.01
                shift = rng.integers(1, 4, size=(n, rl))
                quals = rng.integers(20, 41, size=(n, rl))
            frag = g[pos[:, None] + np.arange(rl)[None, :]]
            rc = 3 - frag[:, ::-1]
            frag = np.where(minus[:, None], rc, frag)
            frag = np.where(err, (frag + shift) % 4, frag)
            sv = lut[frag].view("S%d" % rl)[:, 0]
            qv = (33 + quals).astype(np.uint8).view("S%d" % rl)[:, 0]
            f.write(b"".join(
                b"@sim_%d_ref_sim_%d_%s\n%s\n+\n%s\n"
                % (done + i, pos[i], b"-" if minus[i] else b"+", sv[i], qv[i])
                for i in range(n)))
            done += n
    return fa, fq


def reuse_or_generate(workdir: str, request: dict, files, generate) -> bool:
    """Keep the workload files in workdir when its manifest (workload.json,
    written after each generation) records this request and the files'
    sizes; else run generate() and write the manifest.  Returns whether the
    files were reused."""
    man = os.path.join(workdir, "workload.json")
    try:
        with open(man) as f:
            had = json.load(f)
        if had["request"] == request and all(
                os.path.getsize(p) == had["bytes"][os.path.basename(p)]
                for p in files):
            return True
        os.remove(man)
    except (OSError, ValueError, KeyError):
        pass
    generate()
    with open(man, "w") as f:
        json.dump({"request": request, "bytes": {
            os.path.basename(p): os.path.getsize(p) for p in files}}, f)
    return False


def count_fastq(path: str) -> int:
    """Records in a FASTQ file of four-line records."""
    n = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 26), b""):
            n += block.count(b"\n")
    return n // 4


def count_fasta(path: str):
    """(bases, contigs) of a FASTA file."""
    bases = contigs = 0
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                contigs += 1
            else:
                bases += len(line.rstrip(b"\r\n"))
    return bases, contigs


def run_cli(argv):
    """The port's CLI as a subprocess, its VmRSS sampled from /proc every
    0.5 s.  Returns (its 'done' JSON line, peak RSS in MiB, the RSS in MiB
    every 5 s as [seconds, MiB] pairs)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen([sys.executable, "-m", "gnumap_tpu_torch.cli.main"]
                         + argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    peak, trace = [0], []

    def sample():
        t0 = time.perf_counter()
        while p.poll() is None:
            try:
                with open(f"/proc/{p.pid}/status") as f:
                    kib = next((int(x.split()[1]) for x in f
                                if x.startswith("VmRSS:")), 0)
            except OSError:
                break
            peak[0] = max(peak[0], kib)
            t = time.perf_counter() - t0
            if not trace or t - trace[-1][0] >= 5:
                trace.append([round(t, 1), kib // 1024])
            time.sleep(0.5)

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    out, err = p.communicate()
    th.join(timeout=5)
    if p.returncode != 0:
        sys.stderr.write(err[-3000:])
        raise SystemExit(f"CLI failed rc={p.returncode}")
    done = [json.loads(x) for x in out.splitlines() if x.startswith("{")][-1]
    return done, peak[0] // 1024, trace


def sam_bodies_equal(a: str, b: str) -> bool:
    """Two SAM files hold the same bytes but for their @PG lines (the
    command lines)."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return all(x == y for x, y in itertools.zip_longest(
            (x for x in fa if not x.startswith(b"@PG")),
            (x for x in fb if not x.startswith(b"@PG"))))


def require_native() -> None:
    """The port's native host library (C++, built at first use) must load:
    without it the CLI would build the CSR index and write the SAM in
    Python, and the run would measure those."""
    from gnumap_tpu_torch import _build
    from gnumap_tpu_torch.native import lib
    if not lib.available():
        raise SystemExit("native host library did not build or load: "
                         + _build.BUILD_LOG.get("gnumap_host", ""))


def card() -> str:
    """nvidia-smi's name and power limit of the card the runs used."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True)
    except OSError:
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--genome-len", type=int, default=4_641_652)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "torch_scale_run.json"))
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "gnumap_torch_scale"))
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--mer", type=int, default=12)
    ap.add_argument("--sgr", action="store_true",
                    help="emit the SGR coverage track")
    ap.add_argument("--checkpoint-every", type=int, default=16)
    ap.add_argument("--generator", choices=GENERATORS, default="current",
                    help="the reads of tools/scale_run.py now, or as of "
                    "commit e2e3748 (those SCALE_1M.json was recorded on)")
    args = ap.parse_args()

    require_native()
    os.makedirs(args.workdir, exist_ok=True)
    t0 = time.perf_counter()
    fa = os.path.join(args.workdir, "genome.fa")
    fq = os.path.join(args.workdir, "reads.fq")
    request = dict(reads=args.reads, genome_len=args.genome_len,
                   read_len=args.read_len, generator=args.generator)
    reused = reuse_or_generate(
        args.workdir, request, (fa, fq), lambda: gen_workload(
            args.workdir, args.reads, args.genome_len, args.read_len,
            args.generator))
    gen_s = time.perf_counter() - t0
    n_reads, (genome_len, _) = count_fastq(fq), count_fasta(fa)
    if (n_reads, genome_len) != (args.reads, args.genome_len):
        raise SystemExit(f"workload files hold {n_reads} reads on "
                         f"{genome_len} bases, not the {args.reads} on "
                         f"{args.genome_len} asked for")

    common_opts = ["-m", str(args.mer), "-j", "5", "-L", "104",
                   "-B", str(args.batch_size), "-q", "32", "-k", "8"]
    if not args.sgr:
        common_opts.append("--no-sgr")
    common = ["-g", fa, fq] + common_opts

    # warm-up: the first 16,384 reads, so the kernels are built before the
    # timed runs
    warm_fq = os.path.join(args.workdir, "warm.fq")
    with open(fq) as src, open(warm_fq, "w") as dst:
        for i, line in enumerate(src):
            if i >= 4 * 16384:
                break
            dst.write(line)
    warm = run_cli(["-g", fa, warm_fq, "-o",
                    os.path.join(args.workdir, "warm")] + common_opts)

    # run 1: SAM on, no checkpoints (the end-to-end number)
    t1 = time.perf_counter()
    plain = run_cli(["-o", os.path.join(args.workdir, "plain")] + common)
    wall1 = time.perf_counter() - t1

    # run 2: SAM and a checkpoint every --checkpoint-every batches
    ck = os.path.join(args.workdir, "ck.npz")
    if os.path.exists(ck):
        os.remove(ck)
    t2 = time.perf_counter()
    ckpt = run_cli(["-o", os.path.join(args.workdir, "ckpt"),
                    "--checkpoint", ck,
                    "--checkpoint-every", str(args.checkpoint_every)]
                   + common)
    wall2 = time.perf_counter() - t2

    plain_sam = os.path.join(args.workdir, "plain.sam")
    same = sam_bodies_equal(plain_sam,
                            os.path.join(args.workdir, "ckpt.sam"))
    done1, done2 = plain[0], ckpt[0]
    result = {
        "workload": {"reads": n_reads, "read_len": args.read_len,
                     "genome_len": genome_len, "generator": args.generator,
                     "mer": args.mer, "sgr": args.sgr,
                     "fastq_bytes": os.path.getsize(fq),
                     "reused_files": reused, "gen_s": round(gen_s, 1)},
        "card": card(),
        "warm": {**warm[0], "peak_rss_mb": warm[1]},
        "plain": {**done1, "wall_s": round(wall1, 1),
                  "peak_rss_mb": plain[1], "rss_mb_trace": plain[2],
                  "sam_bytes": os.path.getsize(plain_sam)},
        "checkpointed": {**done2, "wall_s": round(wall2, 1),
                         "peak_rss_mb": ckpt[1], "rss_mb_trace": ckpt[2]},
        "checkpointed_sam_equal_plain": same,
        "sustained_reads_per_s": done1["reads_per_s"],
        "checkpoint_overhead_pct": round(
            100.0 * (done2["map_s"] - done1["map_s"])
            / max(done1["map_s"], 1e-9), 1),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
