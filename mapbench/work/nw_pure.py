"""B2, ``gnumap_tpu_torch/csrc/nw_pure.cu``: the least work the banded
pure-match proof of a batch's retained hits needs, as
``chip_smoke.kernel_bound`` counts it for the kernel's live inputs.  A live
hit is a hit slot with a candidate, a read length in 1..L and a score above
0: a hit the retention kept.  Cells are the live hits times the read's
length times the band width; each needs 7 integer instructions.  Bytes:
each live hit's emission table (5 x L int32) and one genome window byte a
column, and for each of the H hit slots its candidate, length and score
read and its flag and j_final written (17 bytes).

The program records each batch's retained hits (the value ``finish.kept``,
the blob's n_keep, in ``utils/profiling.py``'s value ring; an overflowing
batch's B2 ran on H of them) but not the rows that hold their tables, so
rows are taken at their fewest, one a live hit: B2 stages each hit's own
table (``emis_h``), which is what kernel_bound counts, and the bound never
exceeds the kernel's.  Every read of a pool has the traffic's length."""

from __future__ import annotations

SYMBOL = "nw_pure_kernel"
CELL_OPS = 7
# H x (candidate, length and score read, j_final written) int32, and the
# pure flag byte
SLOT_BYTES = 17


def needs_of(n_live: int, len_sum: int, H: int, L: int, W: int, bw: int):
    """(operations, bytes) of one launch over ``H`` hit slots, ``n_live``
    of them live, whose read lengths sum to ``len_sum``."""
    cells = len_sum * bw
    nbytes = n_live * 5 * L * 4 + n_live * W + H * SLOT_BYTES
    return cells * CELL_OPS, nbytes


def needs(batches, records):
    """(operations, bytes) of the batches' B2 launches, one each; None
    where the program records no ``finish.kept``.

    B2 runs in a batch's map program, at its submit, and the batch's
    finish records its retained hits a stream depth of submits later.  The
    finishes run in submit order, one record each, so the window's k-th
    record is the window's k-th batch's."""
    from mapbench.spans import _reader, window_ns
    values = _reader("values")
    if values is None or "finish.kept" not in (_reader("VALUES") or {}) \
            or not batches:
        return None
    got = values("finish.kept", *window_ns(records))
    if got is None or len(got) != len(records.window.rec.batches):
        return None
    cfg = records.cfg
    L, W, bw = cfg.max_read_len, cfg.window_width(), cfg.band()[1]
    H = cfg.hit_capacity * 2 * cfg.batch_size
    ops = nbytes = 0
    for b in batches:
        n = min(int(got[b.index]), H)
        o, y = needs_of(n, n * records.read_len, H, L, W, bw)
        ops += o
        nbytes += y
    return ops, nbytes
