"""B1, ``gnumap_tpu_torch/csrc/nw_band.cu``: the least work the banded
scoring of a batch needs, as ``chip_smoke.kernel_bound`` counts it for the
kernel's live inputs.  Cells are the live (read-strand, candidate) pairs
times the read's length times the band width; each needs 6 integer
instructions (the recurrence's 5 DPX instructions and the emission's
address).  Bytes: the live rows' emission tables, the candidate and length
arrays, and one genome window byte a column for each live pair.

The stream counts live pairs (``BatchStats.n_candidates``) but not the
read-strand rows that hold them, so rows are taken at their fewest,
ceil(pairs / max_candidates): a bound that never exceeds the kernel's."""

from __future__ import annotations

SYMBOL = "nw_band_kernel"
CELL_OPS = 6


def needs_of(n_live: int, rows: int, len_sum: int, B2: int, C: int, L: int,
             W: int, bw: int):
    """(operations, bytes) for ``n_live`` live pairs in ``rows`` rows whose
    live pairs' read lengths sum to ``len_sum``; B2 x C slots."""
    cells = len_sum * bw
    nbytes = rows * 5 * L * 4 + 2 * B2 * C * 4 + B2 * 4 + n_live * W
    return cells * CELL_OPS, nbytes


def needs(batches, records):
    """(operations, bytes) of the batches' B1 launches, one each."""
    cfg = records.cfg
    C, L, W = cfg.max_candidates, cfg.max_read_len, cfg.window_width()
    bw = cfg.band()[1]
    ops = nbytes = 0
    for b in batches:
        n = b.n_candidates
        o, y = needs_of(n, -(-n // C), n * records.read_len,
                        2 * cfg.batch_size, C, L, W, bw)
        ops += o
        nbytes += y
    return ops, nbytes
