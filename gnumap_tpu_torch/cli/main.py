"""Command line of the PyTorch port — the single-device branch of
gnumap_tpu/cli/main.py, on the device that ``--device`` names.

Usage:
    python -m gnumap_tpu_torch.cli.main -g genome.fa -o out reads.fastq \
        [--device cuda|cpu]

``--device cuda`` (the default) needs a CUDA card and raises without one;
``--device cpu`` runs the plain torch versions of the kernels.  The map
runs the device finish (retention, pure-diagonal detection and traceback
on the device), as the JAX CLI does on its accelerator; the host finish
is reached through the API, ``TorchMapper(..., finish_impl="host")``.
``--accumulate device`` keeps coverage and SNP tallies on the device.
``-b`` maps bisulfite reads (the per-strand collapsed index pair),
``--index-type fm`` seeds from the FM index, and ``--segments N`` (or a
genome past SEG_LIMIT) splits the genome into contig-aligned segments, one
index and one device state each (dist/segments.py).  Flags of paths not yet
ported (multi-host, read / index shards) raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.dist.segments import SEG_LIMIT, GlobalSegmentedMapper
from gnumap_tpu_torch.index import builder, fm, store
from gnumap_tpu_torch.io import fastq as io_fastq, sam as sam_io, sgr as sgr_io
from gnumap_tpu_torch.pipeline import mapper as pl


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gnumap-tpu-torch",
        description="probabilistic short-read mapper (GNUMAP-capability), "
                    "PyTorch / CUDA port")
    p.add_argument("reads", nargs="*",
                   help="FASTQ/FASTA/_prb.txt read files")
    p.add_argument("-g", "--genome", required=True,
                   help="reference genome FASTA (or prebuilt .npz index)")
    p.add_argument("-o", "--output", help="output prefix")
    p.add_argument("-a", "--align-score", type=float, default=0.9,
                   help="retain loci scoring >= a * max score (ref -a)")
    p.add_argument("-m", "--mer-size", type=int, default=10,
                   help="seed k-mer length (ref -m)")
    p.add_argument("-j", "--jump", type=int, default=5,
                   help="seed stride along the read (ref -j)")
    p.add_argument("-k", "--max-hits", type=int, default=64,
                   help="skip seeds with more index hits than this")
    p.add_argument("-q", "--max-candidates", type=int, default=128,
                   help="candidate loci cap per read+strand")
    p.add_argument("--sort-sam", action="store_true",
                   help="coordinate-sort the SAM output (samtools order)")
    p.add_argument("--index-type", choices=["csr", "fm"], default="csr",
                   help="seed index backend: csr (dense k-mer table) "
                        "or fm (BWT / FM index)")
    p.add_argument("--gap-open", type=float, default=4.0)
    p.add_argument("--gap-extend", type=float, default=1.0)
    p.add_argument("--match", type=float, default=1.0)
    p.add_argument("--mismatch", type=float, default=-1.0)
    p.add_argument("-S", "--subst-file", default=None,
                   help="4x4 whitespace substitution matrix file (ref -S)")
    p.add_argument("--adaptor", default=None,
                   help="3' adaptor sequence to trim (ref adaptor flag)")
    p.add_argument("-b", "--bisulfite", action="store_true",
                   help="bisulfite C->T asymmetric scoring (GNUMAP-bs)")
    p.add_argument("--snp", action="store_true",
                   help="per-base tallies + SNP p-values (GNUMAP-SNP)")
    p.add_argument("-B", "--batch-size", type=int, default=4096)
    p.add_argument("-L", "--max-read-len", type=int, default=128)
    p.add_argument("--no-sam", action="store_true")
    p.add_argument("--no-sgr", action="store_true")
    p.add_argument("--save-index", default=None,
                   help="write the built index to this .npz and exit")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the map program runs: 'cuda' (default) the "
                        "hand-written kernels on the card, 'cpu' their "
                        "plain torch versions")
    p.add_argument("--accumulate", choices=["host", "device"],
                   default="host",
                   help="coverage/SNP-tally accumulation: 'host' = exact "
                        "hit-ordered float64 (default, the golden "
                        "semantics); 'device' = [FROZEN v5.2] on-device f32 "
                        "accumulation, fetched only at checkpoints and at "
                        "the end; capacity-overflow batches fall back to "
                        "the exact host path automatically")
    p.add_argument("--checkpoint", default=None,
                   help="stream-state checkpoint file; resumes if present")
    p.add_argument("--checkpoint-every", type=int, default=16,
                   help="checkpoint every N batches")
    p.add_argument("--fail-after", type=int, default=0,
                   help="fault injection: crash after N batches")
    p.add_argument("-c", "--read-shards", type=int, default=0,
                   help="data-parallel read shards (not yet ported)")
    p.add_argument("--index-shards", type=int, default=1,
                   help="shard the k-mer index (not yet ported)")
    p.add_argument("--segments", default="auto",
                   help="position-partition the genome into N contig-"
                        "aligned segments ('auto': segments only past the "
                        "int32 limit)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-batch JSONL stats on stderr (ref -v)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="multi-host run (not yet ported)")
    return p


def load_subst(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                rows.append(tuple(float(x) for x in line.split()))
    if len(rows) != 4 or any(len(r) != 4 for r in rows):
        raise SystemExit("substitution file must be a 4x4 matrix")
    return tuple(rows)


def config_from_args(args) -> MapperConfig:
    return MapperConfig(
        mer_size=args.mer_size, seed_jump=args.jump,
        max_hits_per_seed=args.max_hits, max_candidates=args.max_candidates,
        match_score=args.match, mismatch_score=args.mismatch,
        gap_open=args.gap_open, gap_extend=args.gap_extend,
        align_score_ratio=args.align_score,
        bisulfite=args.bisulfite, snp_mode=args.snp,
        subst_matrix=load_subst(args.subst_file) if args.subst_file else None,
        max_read_len=args.max_read_len, batch_size=args.batch_size,
        sam_out=not args.no_sam, sgr_out=not args.no_sgr,
        sgrex_out=args.snp)


def read_stream(paths, cfg, adaptor=None):
    its = []
    for path in paths:
        if path.endswith(("_prb.txt", ".prb")):
            its.append(io_fastq.iter_prb(path, cfg))
        elif path.endswith(("_int.txt", ".int")):
            its.append(io_fastq.iter_int(path, cfg))
        elif path.endswith((".fa", ".fasta")):
            its.append(io_fastq.iter_fasta_reads(path, cfg))
        else:
            its.append(io_fastq.iter_fastq(path, cfg))
    stream = itertools.chain(*its)
    if adaptor:
        stream = io_fastq.apply_adaptor_trim(stream, cfg, adaptor)
    return stream


def batch_stream(paths, cfg, adaptor=None):
    """Batches, using the native C++ FASTQ fast path where possible;
    adaptor trimming runs vectorized on the whole batch on that path."""
    fastqs = [p for p in paths
              if not p.endswith(("_prb.txt", ".prb", "_int.txt", ".int",
                                 ".fa", ".fasta"))]
    if len(fastqs) == len(paths):
        from gnumap_tpu_torch.core import packing
        ad = packing.encode(adaptor) if adaptor else None
        for path in paths:
            for b in io_fastq.batch_reads_native(path, cfg):
                yield (io_fastq.trim_adaptor_batch(b, ad)
                       if ad is not None else b)
    else:
        yield from io_fastq.batch_reads(read_stream(paths, cfg, adaptor),
                                        cfg)


_ACC_REFUSAL = ("--accumulate device is the single-device TpuMapper path; "
                "segmented and sharded runs use host accumulation")


def _not_yet_ported(args) -> None:
    """Raise for every flag whose path the port does not have yet, after
    the refusals the JAX CLI makes for the same flags."""
    sharded = args.read_shards or args.index_shards > 1
    if args.accumulate == "device" and sharded:
        raise SystemExit(_ACC_REFUSAL)
    flags = []
    if args.num_hosts > 1:
        flags.append("--num-hosts > 1")
    if sharded:
        flags.append("--read-shards / --index-shards")
    if flags:
        raise NotImplementedError(
            f"{', '.join(flags)}: not yet ported to gnumap_tpu_torch (use "
            "gnumap_tpu.cli.main)")


def main(argv=None) -> int:
    import logging
    logging.basicConfig(
        level=logging.WARNING, stream=sys.stderr,
        format="%(levelname)s %(name)s: %(message)s")
    args = build_arg_parser().parse_args(argv)
    if not args.save_index and (not args.reads or not args.output):
        raise SystemExit("reads and -o/--output are required unless "
                         "--save-index is given")
    _not_yet_ported(args)
    cfg = config_from_args(args)
    n_segments = 0 if args.segments == "auto" else int(args.segments)
    t0 = time.perf_counter()
    index = None
    if args.genome.endswith(".npz"):
        genome, index = store.load_index(args.genome)
        if index.mer_size != cfg.mer_size:
            raise SystemExit(
                f"index mer_size {index.mer_size} != -m {cfg.mer_size}")
        if n_segments > 1:
            raise SystemExit("--segments needs a FASTA genome (per-segment "
                             "indexes are built contig-aligned)")
    else:
        genome = builder.Genome.from_fasta(args.genome)
        segmented = n_segments > 1 or len(genome.codes) > SEG_LIMIT
        if segmented and args.index_type == "fm":
            raise SystemExit("--segments requires --index-type csr")
        if not segmented:
            if cfg.bisulfite:
                index = (fm.build_bs_fm_index(genome, cfg)
                         if args.index_type == "fm"
                         else builder.build_bs_index(genome, cfg))
            elif args.index_type == "fm":
                index = fm.build_fm_index(genome, cfg)
            else:
                index = builder.build_index(genome, cfg)
    t_index = time.perf_counter() - t0
    if args.save_index:
        if index is None:
            raise SystemExit("--save-index is per-genome; segmented "
                             "genomes rebuild per-segment indexes at "
                             "map time")
        store.save_index(args.save_index, genome, index)
        print(json.dumps({"event": "index_saved", "path": args.save_index,
                          "seconds": round(t_index, 3)}))
        return 0
    if args.accumulate == "device" and index is None:
        raise SystemExit(_ACC_REFUSAL)

    t0 = time.perf_counter()
    if index is None:
        # segmented path (genome > int32 or --segments N): per-segment
        # int32 indexes, global int64 coordinates, union posteriors
        m = GlobalSegmentedMapper(genome, cfg, device=args.device,
                                  n_segments=n_segments)
    else:
        m = pl.TorchMapper(genome, index, cfg, device=args.device,
                           accumulate=args.accumulate)
    t_index += time.perf_counter() - t0
    sam_path = args.output + ".sam"
    sam_f = None
    if cfg.sam_out:
        resuming = bool(args.checkpoint and os.path.exists(args.checkpoint))
        sam_f = open(sam_path, "r+" if resuming and
                     os.path.exists(sam_path) else "w+")
        if not resuming or sam_f.seek(0, 2) == 0:
            sam_f.seek(0)
            sam_io.write_header(sam_f, genome.names, genome.lengths,
                                cmd=" ".join(sys.argv))
    callbacks = []
    if args.verbose:
        def _vcb(idx, s):
            print(json.dumps({
                "event": "batch", "batch": idx, "reads": s.n_reads,
                "mapped": s.n_mapped, "multi": s.n_multi,
                "candidates_per_read": round(
                    s.n_candidates / max(1, s.n_reads), 2),
                "dp_cells": s.dp_cells,
                "device_s": round(s.device_s, 3),
                "host_s": round(s.host_s, 3)}), file=sys.stderr)
        callbacks.append(_vcb)
    if args.fail_after:
        def _fail_cb(idx, s):
            if idx >= args.fail_after:
                print(json.dumps({"event": "fault_injected",
                                  "batch": idx}), file=sys.stderr)
                os._exit(3)
        callbacks.append(_fail_cb)
    cb = None
    if callbacks:
        def cb(idx, s):
            for c in callbacks:
                c(idx, s)
    batches = batch_stream(args.reads, cfg, args.adaptor)
    t1 = time.perf_counter()
    res = pl.map_stream(
        m, batches,
        collect_sam=False, sam_file=sam_f,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        batch_callback=cb)
    t_map = time.perf_counter() - t1
    if sam_f:
        sam_f.close()
        if args.sort_sam:
            sam_io.sort_sam_file(sam_path, genome.names)
    if cfg.sgr_out:
        with open(args.output + ".sgr", "w") as f:
            sgr_io.write_sgr(f, genome, res.coverage, cfg.min_coverage_emit)
    if cfg.sgrex_out and res.tallies is not None:
        from gnumap_tpu_torch.posterior import snp
        pvals = snp.snp_pvalues(genome.codes, res.coverage, res.tallies)
        with open(args.output + ".sgrex", "w") as f:
            sgr_io.write_sgrex(f, genome, res.coverage, res.tallies, pvals,
                               cfg.min_coverage_emit)
    s = res.stats
    print(json.dumps({
        "event": "done", "device": str(m.device), "reads": s.n_reads,
        "mapped": s.n_mapped, "segments": getattr(m, "n_segments", 1),
        "multi_mapped": s.n_multi, "candidates": s.n_candidates,
        "dp_cells": s.dp_cells, "index_s": round(t_index, 3),
        "map_s": round(t_map, 3),
        "reads_per_s": round(s.n_reads / max(t_map, 1e-9), 1),
        "dp_cells_per_s": round(s.dp_cells / max(t_map, 1e-9), 1),
        "device_s": round(s.device_s, 3), "host_s": round(s.host_s, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
