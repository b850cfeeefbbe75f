#!/usr/bin/env python
"""A genome past int32 addressing on the PyTorch / CUDA port: a ~2.6 Gbp
synthetic genome in 26 contigs, mapped through the port's CLI with
``--segments 2`` on the card (dist/segments.py GlobalSegmentedMapper:
contig-aligned segments, each with its own int32 CSR index and TorchMapper,
global int64 coordinates), recording the index build, map time, reads/s,
peak host RSS, peak device memory (the CLI's done line, which also gives
what each segment holds on the card) and the accuracy to a JSON file.  The
counterpart of tools/scale3g.py: the same arguments and defaults and a
generator that writes the same FASTA and FASTQ bytes; it runs the CLI
through torch_scale_run's runner.

Usage:
    python tools/torch_scale3g.py [--gbases 2.6] [--reads 200000]

Below 2^31 bases it refuses unless SCALE3G_SMOKE is set (small runs that
check the tool itself).  The generated files stay in --workdir for a later
run of the same request (torch_scale_run.reuse_or_generate); the bases,
contigs and reads reported are counted in the files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LUT = np.frombuffer(b"ACGT", np.uint8)


def gen_genome(fa_path: str, total: int, n_contigs: int, seed: int = 0):
    """Chunked FASTA generation: n_contigs equal contigs (the last takes
    the remainder) of uniform random bases, 70 to a line."""
    rng = np.random.default_rng(seed)
    clen = total // n_contigs
    lens = [clen] * (n_contigs - 1) + [total - clen * (n_contigs - 1)]
    with open(fa_path, "wb") as f:
        for ci, L in enumerate(lens):
            f.write(b">ctg%02d\n" % ci)
            done = 0
            while done < L:
                n = min(70 * 1_000_000, L - done)
                block = LUT[rng.integers(0, 4, size=n, dtype=np.int8)]
                # 70-column lines through a padded reshape
                pad = (-len(block)) % 70
                if pad:
                    block = np.concatenate(
                        [block, np.full(pad, ord(" "), np.uint8)])
                wrapped = np.concatenate(
                    [block.reshape(-1, 70),
                     np.full((len(block) // 70, 1), ord("\n"), np.uint8)],
                    axis=1).tobytes().replace(b" ", b"")
                f.write(wrapped)
                done += n
    return lens


def gen_reads(fa_path: str, fq_path: str, lens, n_reads: int,
              read_len: int, seed: int = 9):
    """Reads (1% substitutions, both strands) from each contig in
    proportion to its length, contig-local truth in the names; each
    contig's bases are drawn again from gen_genome's stream (seed 0)."""
    rng = np.random.default_rng(seed)
    tot = sum(lens)
    counts = [int(n_reads * L / tot) for L in lens]
    counts[-1] += n_reads - sum(counts)
    grng = np.random.default_rng(0)
    idx = 0
    with open(fq_path, "wb") as f:
        for ci, (L, cnt) in enumerate(zip(lens, counts)):
            parts = []
            done = 0
            while done < L:
                n = min(70 * 1_000_000, L - done)
                parts.append(grng.integers(0, 4, size=n, dtype=np.int8))
                done += n
            g = np.concatenate(parts) if len(parts) > 1 else parts[0]
            pos = rng.integers(0, L - read_len - 4, size=cnt)
            minus = rng.random(cnt) < 0.5
            frag = g[pos[:, None] + np.arange(read_len)[None, :]]
            rc = 3 - frag[:, ::-1]
            frag = np.where(minus[:, None], rc, frag)
            err = rng.random((cnt, read_len)) < 0.01
            shift = rng.integers(1, 4, size=(cnt, read_len))
            frag = np.where(err, (frag + shift) % 4, frag)
            quals = (33 + rng.integers(20, 41,
                                       size=(cnt, read_len))).astype(np.uint8)
            sv = LUT[frag].view("S%d" % read_len)[:, 0]
            qv = quals.view("S%d" % read_len)[:, 0]
            f.write(b"".join(
                b"@sim_%d_ctg%02d_%d_%s\n%s\n+\n%s\n"
                % (idx + i, ci, pos[i], b"-" if minus[i] else b"+", sv[i],
                   qv[i]) for i in range(cnt)))
            idx += cnt
            del g


def primary_accuracy(sam_path: str):
    """(correct, primaries): a primary record is correct on the truth
    contig, within 3 bases of the truth position, on the truth strand."""
    ok = tot = 0
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fld = line.split("\t", 6)
            flag = int(fld[1])
            if flag & 4 or flag & 256:
                continue
            tot += 1
            name = fld[0].split("_")
            tc, tp, ts = "_".join(name[2:-2]), int(name[-2]), name[-1]
            strand = "-" if flag & 16 else "+"
            if (fld[2] == tc and abs(int(fld[3]) - 1 - tp) <= 3
                    and strand == ts):
                ok += 1
    return ok, tot


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbases", type=float, default=2.6)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--contigs", type=int, default=26)
    ap.add_argument("--segments", type=int, default=2)
    ap.add_argument("--mer", type=int, default=13)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "gnumap_torch_3g"))
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "torch_scale3g.json"))
    args = ap.parse_args()

    from tools.torch_scale_run import (card, count_fasta, count_fastq,
                                       require_native, reuse_or_generate,
                                       run_cli)

    require_native()
    os.makedirs(args.workdir, exist_ok=True)
    total = int(args.gbases * 1e9)
    if total <= (1 << 31) and not os.environ.get("SCALE3G_SMOKE"):
        raise SystemExit("the point is to exceed int32 addressing "
                         "(set SCALE3G_SMOKE=1 for small smoke runs)")
    fa = os.path.join(args.workdir, "genome3g.fa")
    fq = os.path.join(args.workdir, "reads3g.fq")
    t0 = time.perf_counter()
    request = dict(bases=total, contigs=args.contigs, reads=args.reads,
                   read_len=args.read_len)

    def generate():
        gen_reads(fa, fq, gen_genome(fa, total, args.contigs), args.reads,
                  args.read_len)
    reused = reuse_or_generate(args.workdir, request, (fa, fq), generate)
    gen_s = time.perf_counter() - t0
    (bases, contigs), n_reads = count_fasta(fa), count_fastq(fq)
    if (bases, contigs, n_reads) != (total, args.contigs, args.reads):
        raise SystemExit(f"workload files hold {n_reads} reads on {bases} "
                         f"bases in {contigs} contigs, not what was asked")

    t1 = time.perf_counter()
    done, peak_rss, trace = run_cli(
        ["-g", fa, fq, "-o", os.path.join(args.workdir, "out"),
         "-m", str(args.mer), "-j", "5", "-L", "104",
         "-B", str(args.batch_size), "-q", "32", "-k", "64",
         "--segments", str(args.segments), "--no-sgr", "-v"])
    wall = time.perf_counter() - t1
    ok, tot = primary_accuracy(os.path.join(args.workdir, "out.sam"))

    result = {
        "workload": {"genome_bases": bases, "contigs": contigs,
                     "segments": args.segments, "reads": n_reads,
                     "read_len": args.read_len, "reused_files": reused,
                     "gen_s": round(gen_s, 1),
                     "fastq_bytes": os.path.getsize(fq),
                     "fasta_bytes": os.path.getsize(fa)},
        "card": card(),
        "cli": done,
        "wall_s": round(wall, 1),
        "index_s": done.get("index_s"),
        "peak_rss_mb": peak_rss,
        "rss_mb_trace": trace,
        "accuracy_primary": round(ok / max(tot, 1), 4),
        "primaries": tot,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
