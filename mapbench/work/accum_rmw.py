"""B5, ``gnumap_tpu_torch/csrc/accum_rmw.cu``: the least work the ordered
read-modify-write of a batch's pileup needs, as ``chip_smoke.kernel_bound``
counts it for the kernel's live inputs.  A launch adds one delta a unique
128-block: each delta is ``span / 128`` coverage rows (and, in SNP mode,
four times as many tally rows) of 128 floats, read once, one float add an
element; each delta's block index is read once; each accumulator row it
touches is read once and written once.

The program counts the unique blocks (``utils/profiling.py``: the counter
``accumulate.blocks`` and a per-batch record on the benchmark's clock) but
not the rows their windows touch, so rows are taken at their fewest: the
block's own coverage row and its four tally rows, which no other unique
block shares.  That bound never exceeds the kernel's."""

from __future__ import annotations

SYMBOL = "::rmw("
# float32 adds a second outside the tensor cores (NVIDIA H100 SXM data
# sheet, at the full 700 W power limit), as chip_smoke.py states it
F32_OPS = 67e12


def delta_rows(cfg) -> int:
    """Coverage rows of one delta: the widest alignment span rounded up to
    128 positions, plus one 128-block for the start's residue."""
    return -(-cfg.window_width() // 128) + 1


def needs_of(n: int, cw: int, snp: bool, touched_cov: int = None,
             touched_tal: int = None):
    """(operations, bytes) of ``n`` unique-block deltas of ``cw`` coverage
    rows (and ``4 cw`` tally rows with ``snp``) that touch ``touched_cov``
    coverage and ``touched_tal`` tally rows (at their fewest, n and 4 n,
    when not given)."""
    jobs = [(cw, n if touched_cov is None else touched_cov)]
    if snp:
        jobs.append((4 * cw, 4 * n if touched_tal is None else touched_tal))
    ops = nbytes = 0
    for nrows, touched in jobs:
        ops += n * nrows * 128
        nbytes += n * nrows * 128 * 4 + 4 * n + 2 * touched * 128 * 4
    return ops, nbytes


def needs(batches, records):
    """(operations, bytes) of the traced B5 launches; None where the
    program recorded no blocks.

    ``batches`` are the stretch's first batches, one a B5 launch.  A
    batch's accumulation runs in its finish, which comes a stream depth of
    submits after its own, and records the batch's blocks there (a batch
    that overflowed to the host runs no B5 and records nothing).  So the
    launches in the stretch are those of the first block records after the
    first batch's submit."""
    from mapbench.spans import _reader
    values = _reader("values")
    if values is None or not batches:
        return None
    got = values("accumulate.blocks", int(batches[0].submit_start * 1e9),
                 int(records.window.rec.t_end * 1e9))
    if got is None or len(got) < len(batches):
        return None
    blocks = int(got[:len(batches)].sum())
    if not blocks:
        return None
    return needs_of(blocks, delta_rows(records.cfg), records.cfg.snp_mode)
