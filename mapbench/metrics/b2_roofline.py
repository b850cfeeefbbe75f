"""B2's share of its roofline in the traced stretch: the least time its
launches' live work needs (``mapbench/work/nw_pure.py``: the larger of the
operations over the card's int32 rate and the bytes over its memory rate)
over the kernel time the trace gives them.  None where the program records
no retained hits a batch (a checkout without ``finish.kept``)."""

NAME = "b2_roofline"
UNIT = "%"
LAYER = "kernels"
MOVES = "reads_per_s"
BETTER = "higher"
KERNEL = "nw_pure"


def read(records):
    from mapbench.cell import work_module
    t = records.trace
    if t is None:
        return None
    k = t["kernels"][KERNEL]
    if not k["n"] or k["seconds"] <= 0:
        return None
    got = work_module(KERNEL).needs(records.stretch_batches(KERNEL),
                                    records)
    if got is None:
        return None
    ops, nbytes = got
    bound = max(ops / records.peaks.INT32_OPS,
                nbytes / records.peaks.HBM_BYTES)
    if bound <= 0:
        return None
    return 100.0 * bound / k["seconds"]
