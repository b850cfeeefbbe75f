"""Position-partitioned genome segments — the counterpart of
gnumap_tpu/dist/segments.py, built on TorchMapper: the reference's
genome-partitioned MPI mode at the segment level (SURVEY.md §3.5), and the
path to genomes beyond the int32 position limit.

Each segment is an independent (genome, index) pair small enough for int32
positions, with its own TorchMapper and its own device state.  A read batch
maps against every segment; the retained hits are then merged per read and
the posterior weights renormalized over the union: w_i = s_i / sum over ALL
segments' retained loci — the same frozen semantics as a single unsegmented
genome, because retention thresholds depend only on the read, never on the
genome.

Not yet ported (raise): the genome-partitioned multi-host mode
(``num_hosts`` > 1) and a device mesh per segment (``mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.index import builder
from gnumap_tpu_torch.io.fastq import ReadBatch
from gnumap_tpu_torch.pipeline import mapper as pl


@dataclasses.dataclass
class SegmentHit:
    segment: int
    strand: str
    pos: int            # segment-local global offset
    score: int
    weight: float
    cigar: str
    ref_len: int


def merge_segment_hits(per_segment: Sequence[List[List[pl.ReadHit]]]
                       ) -> List[List[SegmentHit]]:
    """Union per-read hits from S segments and renormalize weights over the
    union (scores are comparable across segments — same read, same scoring).
    Output order: (segment, pos, strand) ascending [FROZEN]."""
    n_reads = len(per_segment[0])
    out: List[List[SegmentHit]] = []
    for b in range(n_reads):
        hits: List[SegmentHit] = []
        for s, seg_hits in enumerate(per_segment):
            for h in seg_hits[b]:
                hits.append(SegmentHit(s, h.strand, h.pos, h.score, 0.0,
                                       h.cigar, h.ref_len))
        total = float(sum(h.score for h in hits))
        for h in hits:
            h.weight = h.score / total if total else 0.0
        hits.sort(key=lambda h: (h.segment, h.pos,
                                 0 if h.strand == "+" else 1))
        out.append(hits)
    return out


def _segment_index(genome: builder.Genome, cfg: MapperConfig):
    return (builder.build_bs_index(genome, cfg) if cfg.bisulfite
            else builder.build_index(genome, cfg))


class SegmentedMapper:
    """Map against a genome split into contig groups (each < 2^31 bases)."""

    def __init__(self, contig_groups: Sequence[Sequence[Tuple[str, str]]],
                 cfg: MapperConfig, device="cuda", finish_impl=None):
        self.cfg = cfg
        self.mappers: List[pl.TorchMapper] = []
        for group in contig_groups:
            genome = builder.Genome.from_contigs(list(group))
            self.mappers.append(pl.TorchMapper(
                genome, _segment_index(genome, cfg), cfg, device=device,
                finish_impl=finish_impl))

    @property
    def n_segments(self) -> int:
        return len(self.mappers)

    def map_batch(self, batch: ReadBatch,
                  stats: pl.BatchStats | None = None
                  ) -> List[List[SegmentHit]]:
        per_segment = [m.map_batch(batch, stats) for m in self.mappers]
        return merge_segment_hits(per_segment)

    def locate(self, hit: SegmentHit) -> Tuple[str, int]:
        """Segment-local offset -> (contig name, contig-local offset)."""
        gen = self.mappers[hit.segment].genome
        ci, off = gen.locate(hit.pos)
        return gen.names[int(ci)], int(off)

    def accumulate_coverage(self, hits_per_read, coverages=None):
        """Per-segment coverage arrays (create on first use)."""
        if coverages is None:
            coverages = [np.zeros(len(m.genome.codes)) for m in self.mappers]
        for hits in hits_per_read:
            for h in hits:
                coverages[h.segment][h.pos:h.pos + h.ref_len] += h.weight
        return coverages


def split_contigs(contigs: Sequence[Tuple[str, str]],
                  max_bases: int = (1 << 31) - (1 << 20)
                  ) -> List[List[Tuple[str, str]]]:
    """Greedy partition of contigs into segments under the int32 limit."""
    groups: List[List[Tuple[str, str]]] = [[]]
    size = 0
    for name, seq in contigs:
        if len(seq) > max_bases:
            raise ValueError(f"contig {name} alone exceeds the segment "
                             f"limit ({len(seq)} > {max_bases})")
        if size + len(seq) > max_bases and groups[-1]:
            groups.append([])
            size = 0
        groups[-1].append((name, seq))
        size += len(seq)
    return groups


# default per-segment size: int32-safe with headroom for the window padding
# and index offsets
SEG_LIMIT = (1 << 31) - (1 << 24)


def segment_bounds(genome: builder.Genome,
                   max_bases: int = SEG_LIMIT,
                   n_segments: int = 0) -> List[Tuple[int, int]]:
    """Greedy CONTIG-ALIGNED partition of a global genome: returns
    [(ci_lo, ci_hi), ...) contig-index ranges whose concatenated codes
    (incl. trailing N spacers) each stay under ``max_bases``.  With
    ``n_segments`` > 0, targets that many segments instead (still
    contig-aligned, still capped at max_bases)."""
    n = len(genome.names)
    total = len(genome.codes)
    if n_segments > 0:
        max_bases = min(max_bases, max(-(-total // n_segments), 1))
    ends = np.concatenate([genome.starts[1:], [total]]).astype(np.int64)
    groups: List[Tuple[int, int]] = []
    lo = 0
    for ci in range(n):
        seg_len = int(ends[ci] - genome.starts[lo])
        if seg_len > max_bases and ci > lo:
            groups.append((lo, ci))
            lo = ci
        if int(ends[ci] - genome.starts[lo]) > SEG_LIMIT:
            raise ValueError(
                f"contig {genome.names[ci]} alone exceeds the int32 "
                f"segment limit")
    groups.append((lo, n))
    return groups


class GlobalSegmentedMapper:
    """Genome-of-any-size mapper: the global genome is split into
    contig-aligned segments, each with its own int32 index and its own
    TorchMapper on ``device`` (the reference's genome-partitioned MPI mode,
    SURVEY.md §3.5), and per-segment hits merge back into GLOBAL int64
    coordinates with union-renormalized posterior weights — the same frozen
    semantics as one unsegmented genome, because the retention threshold
    depends only on the read.

    Presents the TorchMapper ``submit``/``finish``/``map_batch``/``genome``
    surface (and ``cfg``, ``device``, ``accumulate`` = "host"), so
    ``pipeline.map_stream`` (SAM/SGR/SNP/checkpoints) and the CLI drive it
    unchanged.  ``submit`` enqueues every segment's device program before
    any ``finish`` waits, so map_stream's depth-3 pipeline still overlaps
    the device with the host.  Segment codes are VIEWS of the global codes
    array (no copies)."""

    accumulate = "host"

    def __init__(self, genome: builder.Genome, cfg: MapperConfig,
                 device="cuda", max_bases: int = SEG_LIMIT,
                 n_segments: int = 0, mesh=None, finish_impl=None,
                 num_hosts: int = 1, host_id: int = 0):
        if num_hosts > 1:
            raise NotImplementedError(
                "genome-partitioned multi-host segments (num_hosts > 1): "
                "not yet ported to gnumap_tpu_torch")
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh per segment (mesh=): not yet ported to "
                "gnumap_tpu_torch")
        self.genome = genome
        self.cfg = cfg
        self.device = pl._require_device(device)
        self.bounds = segment_bounds(genome, max_bases, n_segments)
        total = len(genome.codes)
        ends = np.concatenate([genome.starts[1:], [total]]).astype(np.int64)
        self.mappers: List[pl.TorchMapper] = []
        self.bases: List[int] = []
        for ci_lo, ci_hi in self.bounds:
            lo = int(genome.starts[ci_lo])
            hi = int(ends[ci_hi - 1])
            sub = builder.Genome(
                codes=genome.codes[lo:hi],
                names=list(genome.names[ci_lo:ci_hi]),
                starts=genome.starts[ci_lo:ci_hi] - lo,
                lengths=genome.lengths[ci_lo:ci_hi])
            self.mappers.append(pl.TorchMapper(
                sub, _segment_index(sub, cfg), cfg, device=self.device,
                finish_impl=finish_impl))
            self.bases.append(lo)

    @property
    def n_segments(self) -> int:
        """Total segments in the partition."""
        return len(self.bounds)

    # -- TorchMapper-compatible surface (map_stream pipelines through it) --
    def submit(self, batch: ReadBatch):
        return [m.submit(batch) for m in self.mappers]

    def finish(self, batch: ReadBatch, futs,
               stats: "pl.BatchStats | None" = None):
        seg_stats = pl.BatchStats()
        per = [m.finish(batch, f, seg_stats)
               for m, f in zip(self.mappers, futs)]
        out = self._merge_global(per, n=batch.n)
        if stats is not None:
            stats.n_reads += batch.n
            stats.n_mapped += sum(1 for hh in out if hh)
            stats.n_multi += sum(1 for hh in out if len(hh) > 1)
            stats.n_candidates += seg_stats.n_candidates
            stats.dp_cells += seg_stats.dp_cells
            stats.dp_cells_banded += seg_stats.dp_cells_banded
            stats.device_s += seg_stats.device_s
            stats.host_s += seg_stats.host_s
        return out

    def map_batch(self, batch: ReadBatch,
                  stats: "pl.BatchStats | None" = None):
        return self.finish(batch, self.submit(batch), stats)

    def _merge_global(self, per_segment,
                      n: "int | None" = None) -> List[List[pl.ReadHit]]:
        """Union per-read hits across segments in GLOBAL coordinates and
        renormalize weights over the union (frozen posterior semantics:
        w_i = s_i / sum over ALL retained loci)."""
        if n is None:
            n = len(per_segment[0])
        out: List[List[pl.ReadHit]] = []
        for b in range(n):
            hits: List[pl.ReadHit] = []
            for base, seg_hits in zip(self.bases, per_segment):
                for h in seg_hits[b]:
                    hits.append(pl.ReadHit(h.strand, base + h.pos, h.score,
                                           0.0, h.cigar, h.ref_len))
            total = float(sum(h.score for h in hits))
            for h in hits:
                h.weight = h.score / total if total else 0.0
            hits.sort(key=lambda h: (h.pos, 0 if h.strand == "+" else 1))
            out.append(hits)
        return out
