"""B5's share of its roofline in the traced stretch: the least time its
launches' live work needs (``mapbench/work/accum_rmw.py``: the larger of
the float adds over the card's float32 rate and the bytes over its memory
rate) over the kernel time the trace gives them.  None where the program
records no block counts (a checkout without them, or SAM on)."""

NAME = "b5_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "reads_per_s"
BETTER = "higher"
KERNEL = "accum_rmw"


def read(records):
    from mapbench.cell import work_module
    t = records.trace
    if t is None:
        return None
    k = t["kernels"][KERNEL]
    if not k["n"] or k["seconds"] <= 0:
        return None
    work = work_module(KERNEL)
    got = work.needs(records.stretch_batches(KERNEL), records)
    if got is None:
        return None
    ops, nbytes = got
    bound = max(ops / work.F32_OPS, nbytes / records.peaks.HBM_BYTES)
    if bound <= 0:
        return None
    return 100.0 * bound / k["seconds"]
