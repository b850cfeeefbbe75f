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
index and one device state each (dist/segments.py).

Multi-host runs start one process per rank with ``--num-hosts N --host-id h
--coordinator host:port`` (rank 0's address; torch.distributed, NCCL when
each rank has a card of its own, gloo otherwise):
  * ``--num-hosts N`` alone: the JAX CLI's multi-host data-parallel mode
    (host h maps its byte range of one FASTQ or every N-th batch, SAM
    shards merged at host 0, coverage merged exactly), or with segments
    the genome-partitioned mode (host h maps every batch against the
    segments it owns);
  * ``-c R --index-shards S``: the reads x index mesh (dist/collectives.py
    DistMapper).  One difference from the JAX CLI, where one process drives
    every device: a rank owns one device, so the mesh runs as R * S
    processes started with ``--num-hosts R*S``; every rank reads every
    batch and maps its mesh block, and host 0 alone writes the outputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time

from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.dist import collectives, mesh as mesh_mod, multihost
from gnumap_tpu_torch.dist.segments import SEG_LIMIT, GlobalSegmentedMapper
from gnumap_tpu_torch.index import builder, fm, store
from gnumap_tpu_torch.io import fastq as io_fastq, sam as sam_io, sgr as sgr_io
from gnumap_tpu_torch.pipeline import checkpoint as ckpt, mapper as pl


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
                   help="data-parallel read shards of the reads x index "
                        "mesh (0 = no mesh; ref -c threads / mpirun -np); "
                        "a rank owns one device, so -c R --index-shards S "
                        "runs as R*S processes started with --num-hosts "
                        "R*S, and host 0 writes the outputs")
    p.add_argument("--index-shards", type=int, default=1,
                   help="shard the k-mer index over this many ranks "
                        "(genome-partitioned mode; with -c 0 the read "
                        "shards are num-hosts / index-shards)")
    p.add_argument("--segments", default="auto",
                   help="position-partition the genome into N contig-"
                        "aligned segments ('auto': segments only past the "
                        "int32 limit)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-batch JSONL stats on stderr (ref -v)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="multi-host run: total torch.distributed processes "
                        "(the reference's mpirun -np R); one device each")
    p.add_argument("--host-id", type=int, default=0,
                   help="this process's rank in [0, num-hosts)")
    p.add_argument("--coordinator", default="localhost:29500",
                   help="rendezvous address host:port (rank 0's)")
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
_FM_REFUSAL = ("--index-type fm is single-device; the sharded path shards "
               "the CSR table (use --index-type csr)")


def _check_sharding(args) -> bool:
    """The refusals of the sharded flags, before any process group or
    output exists; True when the run is sharded (a reads x index mesh)."""
    sharded = bool(args.read_shards or args.index_shards > 1)
    if not sharded:
        return False
    if args.accumulate == "device":
        raise SystemExit(_ACC_REFUSAL)
    if args.index_type == "fm":
        raise SystemExit(_FM_REFUSAL)
    R, S = args.read_shards, args.index_shards
    if (R and R * S != args.num_hosts) or (not R and args.num_hosts % S):
        raise SystemExit(
            f"-c {R} --index-shards {S}: a rank owns one device, so the "
            f"mesh runs as R*S processes started with --num-hosts R*S "
            f"(got --num-hosts {args.num_hosts})")
    return True


def main(argv=None) -> int:
    import logging
    logging.basicConfig(
        level=logging.WARNING, stream=sys.stderr,
        format="%(levelname)s %(name)s: %(message)s")
    args = build_arg_parser().parse_args(argv)
    if not args.save_index and (not args.reads or not args.output):
        raise SystemExit("reads and -o/--output are required unless "
                         "--save-index is given")
    sharded = _check_sharding(args)
    multi = args.num_hosts > 1
    if multi:
        multihost.initialize(args.coordinator, args.num_hosts, args.host_id,
                             device=args.device)
        if args.checkpoint:
            # per-host stream state; every host resumes its own partition
            args.checkpoint = f"{args.checkpoint}.h{args.host_id}"
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
        if sharded and pl.index_kind(index).startswith("fm"):
            raise SystemExit(_FM_REFUSAL)
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
    mesh = None
    if sharded:
        mesh = mesh_mod.make_mesh(args.read_shards or None,
                                  args.index_shards, device=args.device)
    if index is None:
        # segmented path (genome > int32 or --segments N): per-segment
        # int32 indexes, global int64 coordinates, union posteriors.
        # With --num-hosts R (and no mesh) this becomes the
        # GENOME-PARTITIONED mode (the reference's RAM-bound MPI layout):
        # host h owns segments h, h+R, ... and maps EVERY read batch
        # against them; posterior denominators reduce across hosts per
        # batch and the coverage tracks merge bit-exactly
        # (dist/segments.py docstring).  On a mesh every rank maps every
        # segment through its DistMapper.
        gp_hosts = 1 if sharded else args.num_hosts
        m = GlobalSegmentedMapper(genome, cfg, device=args.device,
                                  n_segments=n_segments, mesh=mesh,
                                  num_hosts=gp_hosts,
                                  host_id=args.host_id if gp_hosts > 1
                                  else 0)
    elif sharded:
        m = collectives.DistMapper(genome, index, cfg, mesh)
    else:
        m = pl.TorchMapper(genome, index, cfg, device=args.device,
                           accumulate=args.accumulate)
    t_index += time.perf_counter() - t0
    # the index is on the device now; no later step reads its host arrays
    segmented = index is None
    index = None
    # who writes what: on a mesh every rank maps every batch and host 0
    # alone writes the outputs; otherwise a multi-host run writes per-host
    # SAM shards that host 0 merges
    shards = multi and not sharded
    writer = args.host_id == 0 or shards
    sam_path = args.output + ".sam"
    sam_f = sam_bin = None
    spans: list = []
    if cfg.sam_out and shards:
        # per-host headerless SAM shard + per-batch byte spans (merged by
        # global batch index at host 0 — the reference's rank-0 gather)
        import io as _io
        body_path, _ = multihost.shard_paths(args.output, args.host_id)
        resuming = bool(args.checkpoint and os.path.exists(args.checkpoint)
                        and os.path.exists(body_path))
        sam_bin = open(body_path, "r+b" if resuming else "wb")
        sam_f = _io.TextIOWrapper(sam_bin, encoding="utf-8", newline="")
    elif cfg.sam_out and writer:
        resuming = bool(args.checkpoint and os.path.exists(args.checkpoint))
        sam_f = open(sam_path, "r+" if resuming and
                     os.path.exists(sam_path) else "w+")
        if not resuming or sam_f.seek(0, 2) == 0:
            sam_f.seek(0)
            sam_io.write_header(sam_f, genome.names, genome.lengths,
                                cmd=" ".join(sys.argv))
    genome_partitioned = shards and segmented
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
    if sam_bin is not None and genome_partitioned:
        # per-RECORD index rows (batch, read, key) aligned with the shard
        # lines; host 0 interleaves them (multihost.merge_sam_shards_gp).
        # Each batch's rows are appended as the batch completes, so no
        # host holds its rows for the run; a resume keeps the rows of the
        # checkpointed batches
        _, idx_path = multihost.shard_paths(args.output, args.host_id)
        st = (ckpt.load(args.checkpoint)
              if args.checkpoint and os.path.exists(args.checkpoint)
              else None)
        if st is not None and os.path.exists(idx_path):
            with open(idx_path) as f, open(idx_path + ".tmp", "w") as g:
                for line in f:
                    if json.loads(line)[0] < st.batches_done:
                        g.write(line)
            os.replace(idx_path + ".tmp", idx_path)
        else:
            multihost.write_shard_index(idx_path, [])

        def _gp_cb(idx, s):
            gp = getattr(m, "gp_sam", None)
            sam_f.flush()
            with open(idx_path, "a") as f:
                for rd, key in (gp["records"] if gp else []):
                    f.write(json.dumps((idx - 1, rd, key)) + "\n")
                if args.checkpoint:
                    f.flush()
                    os.fsync(f.fileno())
        callbacks.append(_gp_cb)
    elif sam_bin is not None:
        _prev = [0]
        _k = [0]
        _, idx_path = multihost.shard_paths(args.output, args.host_id)
        if args.checkpoint and os.path.exists(args.checkpoint):
            # resume: keep the spans of already-checkpointed batches
            st = ckpt.load(args.checkpoint)
            if st is not None and os.path.exists(idx_path):
                with open(idx_path) as f:
                    kept = f.read().splitlines()[:st.batches_done]
                for line in kept:
                    spans.append(tuple(json.loads(line)))
                _k[0] = len(kept)
                _prev[0] = st.sam_offset

        def _span_cb(idx, s):
            sam_f.flush()
            end = sam_bin.tell()
            if byte_range_mode:
                key = (args.host_id, _k[0])      # host-contiguous reads
            else:
                key = (_k[0] * args.num_hosts + args.host_id, 0)  # strided
            spans.append((key[0], key[1], _prev[0], end))
            _prev[0] = end
            _k[0] += 1
            if args.checkpoint:
                multihost.write_shard_index(idx_path, spans)
        callbacks.append(_span_cb)
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
    # multi-host read partition: byte ranges for a plain single FASTQ
    # (each host parses only ~1/R of the file); batch stride otherwise.
    # Genome-partitioned mode and the mesh BROADCAST reads instead (every
    # host maps every batch).
    byte_range_mode = (
        shards and not genome_partitioned and len(args.reads) == 1
        and not args.reads[0].endswith(("_prb.txt", ".prb", "_int.txt",
                                        ".int", ".fa", ".fasta", ".gz")))
    if byte_range_mode:
        lo, hi = multihost.fastq_ranges(args.reads[0],
                                        args.num_hosts)[args.host_id]
        from gnumap_tpu_torch.core import packing
        ad = packing.encode(args.adaptor) if args.adaptor else None

        def _range_batches():
            for bb in io_fastq.batch_reads_native(args.reads[0], cfg,
                                                  start=lo, stop=hi):
                yield (io_fastq.trim_adaptor_batch(bb, ad)
                       if ad is not None else bb)
        batches = _range_batches()
    else:
        batches = batch_stream(args.reads, cfg, args.adaptor)
        if shards and not genome_partitioned:
            batches = multihost.strided(batches, args.num_hosts,
                                        args.host_id)
    t1 = time.perf_counter()
    res = pl.map_stream(
        m, batches,
        collect_sam=False, sam_file=sam_f,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        batch_callback=cb)
    t_map = time.perf_counter() - t1
    if shards:
        # cross-host merge: coverage/tallies by deterministic bit-exact
        # all-gather + host-ordered sum (the MPI_Reduce analog); SAM by
        # rank-0 interleave of per-batch shard chunks
        if res.coverage is not None:
            res.coverage = multihost.allreduce_f64(res.coverage)
        if res.tallies is not None:
            res.tallies = multihost.allreduce_f64(res.tallies)
        if sam_f:
            sam_f.close()
            if not genome_partitioned:
                _, idx_path = multihost.shard_paths(args.output,
                                                    args.host_id)
                multihost.write_shard_index(idx_path, spans)
        multihost.barrier("gnumap_sam_shards")
        if sam_f and args.host_id == 0:
            import io as _io
            hdr = _io.StringIO()
            sam_io.write_header(hdr, genome.names, genome.lengths,
                                cmd=" ".join(sys.argv))
            if genome_partitioned:
                multihost.merge_sam_shards_gp(args.output, args.num_hosts,
                                              hdr.getvalue())
            else:
                multihost.merge_sam_shards(args.output, args.num_hosts,
                                           hdr.getvalue())
            if args.sort_sam:
                sam_io.sort_sam_file(sam_path, genome.names)
    elif sam_f:
        sam_f.close()
        if args.sort_sam:
            sam_io.sort_sam_file(sam_path, genome.names)
    if cfg.sgr_out and args.host_id == 0:
        with open(args.output + ".sgr", "w") as f:
            sgr_io.write_sgr(f, genome, res.coverage, cfg.min_coverage_emit)
    if cfg.sgrex_out and res.tallies is not None and args.host_id == 0:
        from gnumap_tpu_torch.posterior import snp
        pvals = snp.snp_pvalues(genome.codes, res.coverage, res.tallies)
        with open(args.output + ".sgrex", "w") as f:
            sgr_io.write_sgrex(f, genome, res.coverage, res.tallies, pvals,
                               cfg.min_coverage_emit)
    if multi:
        multihost.barrier("gnumap_outputs")
    s = res.stats
    done = {
        "event": "done", "device": str(m.device), "reads": s.n_reads,
        "mapped": s.n_mapped, "segments": getattr(m, "n_segments", 1),
        "multi_mapped": s.n_multi, "candidates": s.n_candidates,
        "dp_cells": s.dp_cells, "index_s": round(t_index, 3),
        "map_s": round(t_map, 3),
        "reads_per_s": round(s.n_reads / max(t_map, 1e-9), 1),
        "dp_cells_per_s": round(s.dp_cells / max(t_map, 1e-9), 1),
        "device_s": round(s.device_s, 3), "host_s": round(s.host_s, 3)}
    if multi or sharded:
        done["collectives"] = dataclasses.asdict(mesh_mod.COMM)
    if m.device.type == "cuda":
        import torch
        done["peak_device_bytes"] = torch.cuda.max_memory_allocated(m.device)
        if segmented and not sharded:
            # what each segment's genome codes and index hold on the card
            done["segment_device_bytes"] = [
                sum(t.nbytes for t in s.state.values()
                    if isinstance(t, torch.Tensor)) for s in m.mappers]
    print(json.dumps(done))
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
