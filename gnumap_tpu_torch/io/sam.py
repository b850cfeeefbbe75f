"""SAM emission (reference output layer, SURVEY.md §1 L5).

One record per retained locus, carrying the GNUMAP posterior weight: MAPQ is
derived from the posterior (frozen formula below) and the exact values ride
in tags ``AS:i`` (integer fixed-point alignment score) and ``XP:f``
(posterior weight), so downstream conformance checks don't depend on MAPQ
rounding.
"""

from __future__ import annotations

import heapq
import math
import os
import tempfile
from typing import IO, Sequence

from gnumap_tpu_torch.config import SCORE_ONE


def mapq_from_weight(w: float) -> int:
    """FROZEN: phred of posterior error, capped at 60; 60 for unique hits."""
    if w >= 1.0 - 1e-12:
        return 60
    return max(0, min(60, int(round(-10.0 * math.log10(max(1e-12, 1.0 - w))))))


def write_header(f: IO[str], names: Sequence[str], lengths: Sequence[int],
                 cmd: str = "gnumap-tpu") -> None:
    f.write("@HD\tVN:1.6\tSO:unsorted\n")
    for n, l in zip(names, lengths):
        f.write(f"@SQ\tSN:{n}\tLN:{int(l)}\n")
    f.write(f"@PG\tID:gnumap-tpu\tPN:gnumap-tpu\tCL:{cmd}\n")


def record(qname: str, flag: int, rname: str, pos0: int, mapq: int,
           cigar: str, seq: str, qual: str, score_q: int, weight: float
           ) -> str:
    """pos0 is 0-based; SAM POS is 1-based."""
    return (f"{qname}\t{flag}\t{rname}\t{pos0 + 1}\t{mapq}\t{cigar}\t*\t0\t0"
            f"\t{seq}\t{qual}\tAS:i:{score_q}\tXS:f:{score_q / SCORE_ONE:.4f}"
            f"\tXP:f:{weight:.6f}\n")


def unmapped_record(qname: str, seq: str, qual: str) -> str:
    return f"{qname}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual}\n"


def sort_sam_file(path: str, ref_names: Sequence[str],
                  mem_records: int = 2_000_000) -> None:
    """Coordinate-sort a SAM file in place (samtools-sort order: reference
    sequence in @SQ header order, then 1-based POS ascending; unmapped
    records last; ties keep input order).  External merge sort: records are
    keyed with a fixed-width sortable prefix, spilled to temp-file runs of
    ``mem_records`` lines, and heapq-merged — so files far larger than RAM
    sort fine (reference wrote per-thread buffers merged to final files;
    this is the single-file analog).  The header's SO tag flips to
    coordinate."""
    order = {n: i for i, n in enumerate(ref_names)}
    unmapped_rank = len(order)
    dirn = os.path.dirname(os.path.abspath(path))
    headers: list = []
    runs: list = []
    buf: list = []
    seq_no = 0

    def spill() -> None:
        buf.sort()
        tf = tempfile.TemporaryFile("w+", dir=dirn, suffix=".samrun")
        tf.writelines(buf)
        tf.seek(0)
        runs.append(tf)
        buf.clear()

    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                headers.append(line.replace("SO:unsorted", "SO:coordinate")
                               if line.startswith("@HD") else line)
            else:
                t = line.split("\t", 4)
                # zero-padded fixed-width prefix: lexicographic == numeric;
                # the sequence number makes the sort stable (input order
                # breaks coordinate ties, matching the in-memory semantics)
                buf.append(f"{order.get(t[2], unmapped_rank):010d}\t"
                           f"{int(t[3]):012d}\t{seq_no:014d}\t{line}")
                seq_no += 1
                if len(buf) >= mem_records:
                    spill()
    with open(path, "w") as out:
        out.writelines(headers)
        if runs:
            if buf:
                spill()
            for keyed in heapq.merge(*runs):
                out.write(keyed.split("\t", 3)[3])
            for tf in runs:
                tf.close()
        else:
            buf.sort()
            for keyed in buf:
                out.write(keyed.split("\t", 3)[3])
